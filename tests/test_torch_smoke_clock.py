"""`tools/smoke_clock.py`: each phase line of a command's output gets
the seconds since the line before it, the output passes through, and
the command's exit code is kept."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCK = os.path.join(REPO, "paddle_tpu_torch", "tools", "smoke_clock.py")

CHILD = ("import json, sys, time\n"
         "print(json.dumps({'phase': 'a'}))\n"
         "time.sleep(0.2)\n"
         "print('a build log line')\n"
         "print(json.dumps({'phase': 'b'}))\n"
         "print(json.dumps({'phase': 'b'}))\n"
         "sys.exit(3)\n")


def test_phases_get_their_seconds_and_the_exit_code(tmp_path):
    out = tmp_path / "run.json"
    r = subprocess.run([sys.executable, CLOCK, "run", str(out), "--",
                        sys.executable, "-c", CHILD],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 3
    assert r.stdout.splitlines()[1] == "a build log line"
    rec = json.loads(out.read_text())
    assert rec["rc"] == 3
    names = [n for n, _ in rec["phases"]]
    assert names == ["a", "b", "b", "(after the last phase)"]
    secs = [s for _, s in rec["phases"]]
    assert secs[1] >= 0.2 and all(s >= 0 for s in secs)
    assert abs(sum(secs) - rec["wall_s"]) < 1e-6
    t = subprocess.run([sys.executable, CLOCK, "table", str(out), str(out)],
                       capture_output=True, text=True, timeout=60)
    rows = {line.split(" | ")[0].strip("| "): line
            for line in t.stdout.splitlines()}
    assert rows["rc"] == "| rc | 3 | 3 |"
    b = float(rows["b"].split(" | ")[1])
    assert abs(b - secs[1] - secs[2]) < 0.06
