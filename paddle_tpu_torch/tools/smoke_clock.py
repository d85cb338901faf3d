"""The wall time of each phase of a `chip_smoke.py` run.

`chip_smoke.py` prints one JSON line as each phase ends
(`{"phase": ...}`); this script runs a command, passes its output
through, stamps each line with the seconds since the start, and gives
each phase the seconds from the line before its own to its own (the
build logs and other lines in between count to the phase that follows).
It imports nothing of the package, so it can clock another checkout's
`chip_smoke.py`:

    python3 paddle_tpu_torch/tools/smoke_clock.py run OUT.json -- \\
        python3 chip_smoke.py
    python3 paddle_tpu_torch/tools/smoke_clock.py table A.json B.json ...

`run` writes {"cmd", "rc", "wall_s", "phases": [[name, seconds], ...]}
(a phase that prints several lines, as `serve_tp` does, has one entry
a line) and exits with the command's code; `table` prints the phases'
seconds of several runs side by side, summed by name, in the first
run's order, with each run's total.
"""
import json
import os
import subprocess
import sys
import time


def run(out_path, cmd):
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    last, phases = 0.0, []
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=env, text=True,
                            bufsize=1)
    try:
        for line in proc.stdout:
            sys.stdout.write(line)
            sys.stdout.flush()
            now = time.perf_counter() - t0
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and "phase" in obj:
                phases.append([obj["phase"], now - last])
                last = now
        rc = proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    phases.append(["(after the last phase)", wall - last])
    with open(out_path, "w") as f:
        json.dump({"cmd": cmd, "rc": rc, "wall_s": wall, "phases": phases},
                  f, indent=1)
    return rc


def table(paths):
    runs = [json.load(open(p)) for p in paths]
    order, sums = [], []
    for r in runs:
        s = {}
        for name, sec in r["phases"]:
            if name not in s and name not in order:
                order.append(name)
            s[name] = s.get(name, 0.0) + sec
        sums.append(s)
    print("| phase | " + " | ".join(paths) + " |")
    print("| --- |" + " --- |" * len(paths))
    for name in order:
        print(f"| {name} | " + " | ".join(
            f"{s[name]:.1f}" if name in s else "-" for s in sums) + " |")
    print("| wall | " + " | ".join(f"{r['wall_s']:.1f}" for r in runs)
          + " |")
    print("| rc | " + " | ".join(str(r["rc"]) for r in runs) + " |")


def main(argv):
    if len(argv) >= 4 and argv[0] == "run" and argv[2] == "--":
        return run(argv[1], argv[3:])
    if len(argv) >= 2 and argv[0] == "table":
        table(argv[1:])
        return 0
    raise SystemExit(__doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
