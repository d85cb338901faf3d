"""Rules the port keeps: it imports neither jax nor the JAX package (and
looks neither up by name), its entry points run on the CUDA card unless
asked for the CPU, and its block cache manager touches nothing of the JAX
package even when both packages are loaded."""
import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = re.compile(r"^(jax|jaxlib|paddle_tpu)(\.|$)")
# the one module name a port file may spell: the global the JAX package
# pickles its tensor payload under, which `framework/io.py` writes and
# maps onto its own class without importing it
_PICKLE_GLOBAL = ("framework/io.py", "paddle_tpu.framework.io")


def _port_files():
    root = os.path.join(REPO, "paddle_tpu_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _dirs, files in os.walk(root):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _violations(path):
    tree = ast.parse(open(path).read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _FORBIDDEN.match(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and _FORBIDDEN.match(node.module or ""):
            bad.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _FORBIDDEN.match(node.value) \
                and (path.endswith(_PICKLE_GLOBAL[0]), node.value) \
                != (True, _PICKLE_GLOBAL[1]):
            # a module name in a string: sys.modules lookups,
            # importlib.import_module, __import__
            bad.append(repr(node.value))
    return bad


def test_port_files_exist():
    files = _port_files()
    assert os.path.join(REPO, "chip_smoke.py") in files
    assert len(files) > 15
    # the fleet's subpackages, which keep their own copies of JAX-free
    # JAX-package modules, and the eager core, are checked like every
    # other port file
    rel = {os.path.relpath(f, REPO) for f in files}
    for name in ("distributed/elastic/__init__.py",
                 "distributed/elastic/store.py",
                 "distributed/elastic/manager.py",
                 "observability/__init__.py", "observability/timeline.py",
                 "serving/fleet.py", "serving/disagg.py",
                 "core/__init__.py", "core/tensor.py", "core/dispatch.py",
                 "core/autograd.py", "autograd/__init__.py",
                 "autograd/py_layer.py", "autograd/functional.py",
                 "framework/dtype.py", "framework/place.py",
                 "framework/random.py", "framework/monitor.py",
                 "ops/__init__.py", "ops/_helpers.py", "ops/creation.py",
                 "ops/math.py", "ops/manipulation.py", "ops/comparison.py",
                 "ops/reduction.py", "ops/linalg.py", "ops/activation.py",
                 "nn/initializer/__init__.py", "nn/parameter.py",
                 "nn/layer/layers.py", "nn/layer/container.py",
                 "nn/layer/common.py", "nn/layer/activation.py",
                 "nn/layer/norm.py", "nn/functional/common.py",
                 "framework/io.py", "framework/safetensors.py",
                 "jit/functional.py", "jit/to_static.py",
                 "jit/save_load.py", "inference/predictor.py",
                 "tools/jit_workload.py", "core/lazy.py",
                 "amp/__init__.py", "amp/amp_lists.py", "amp/auto_cast.py",
                 "amp/grad_scaler.py", "amp/debugging.py",
                 "models/llama_layers.py", "tools/lazy_workload.py",
                 "tensor_method_names.py", "testing/__init__.py",
                 "testing/op_harness.py", "nn/functional/loss.py",
                 "nn/functional/attention.py", "nn/layer/loss.py",
                 "nn/clip.py", "regularizer.py", "optimizer/lr.py",
                 "optimizer/optimizer.py", "tools/loop_workload.py",
                 "ops/extended.py", "fft.py", "signal.py",
                 "tools/fnet_workload.py", "tools/smoke_clock.py",
                 "core/selected_rows.py", "quantization/__init__.py",
                 "distributed/checkpoint/save_state_dict.py",
                 "distributed/checkpoint/load_state_dict.py",
                 "resilience/checkpoint_manager.py", "resilience/guard.py",
                 "tools/resilience_workload.py", "tools/quant_workload.py",
                 "distributed/__init__.py", "distributed/placement.py",
                 "distributed/process_mesh.py", "distributed/parallel.py",
                 "distributed/auto_parallel/__init__.py",
                 "distributed/auto_parallel/api.py",
                 "distributed/auto_parallel/sharding_bridge.py",
                 "distributed/auto_parallel/strategy.py",
                 "distributed/communication/__init__.py",
                 "distributed/communication/group.py",
                 "distributed/communication/collective.py",
                 "distributed/communication/stream.py",
                 "distributed/communication/watchdog.py",
                 "resilience/elastic_train.py",
                 "tools/elastic_workload.py", "tools/draw_timing.py"):
        assert f"paddle_tpu_torch/{name}" in rel, name


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_paddle_tpu_reference(path):
    assert _violations(path) == []


def test_rule_catches_the_lookups_it_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import sys\nimport jax.numpy as jnp\n"
                 "from paddle_tpu.ops import sampling\n"
                 "m = sys.modules.get('paddle_tpu.framework.monitor')\n")
    assert len(_violations(str(f))) == 3


def test_import_loads_neither_package():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.ops.sampling, paddle_tpu_torch.optimizer, "
            "paddle_tpu_torch.serving.spec, "
            "paddle_tpu_torch.nn.functional, "
            "paddle_tpu_torch.incubate.nn.functional, "
            "paddle_tpu_torch.ops.kernels.rope, "
            "paddle_tpu_torch.ops.kernels.bias_act, "
            "paddle_tpu_torch.tools.train_workload, "
            "paddle_tpu_torch.tools.train_profile, "
            "paddle_tpu_torch.tools.layer_profile, "
            "paddle_tpu_torch.framework.flags, "
            "paddle_tpu_torch.ops.kernels.fused_moe, "
            "paddle_tpu_torch.incubate.distributed.models.moe, "
            "paddle_tpu_torch.tools.moe_workload, "
            "paddle_tpu_torch.tools.moe_profile, "
            "paddle_tpu_torch.framework.retry, "
            "paddle_tpu_torch.resilience.faults, "
            "paddle_tpu_torch.resilience, paddle_tpu_torch.quantization, "
            "paddle_tpu_torch.distributed.checkpoint, "
            "paddle_tpu_torch.tools.resilience_workload, "
            "paddle_tpu_torch.tools.quant_workload, "
            "paddle_tpu_torch.inference.prefix_cache, "
            "paddle_tpu_torch.serving.slo, "
            "paddle_tpu_torch.serving.fault_tolerance, "
            "paddle_tpu_torch.serving.engine, "
            "paddle_tpu_torch.serving.lora, "
            "paddle_tpu_torch.inference.kv_migrate, "
            "paddle_tpu_torch.tools.serve_workload, "
            "paddle_tpu_torch.distributed, "
            "paddle_tpu_torch.distributed.process_mesh, "
            "paddle_tpu_torch.distributed.tp_overlap, "
            "paddle_tpu_torch.serving.tp, "
            "paddle_tpu_torch.serving.fleet, "
            "paddle_tpu_torch.serving.disagg, "
            "paddle_tpu_torch.distributed.elastic, "
            "paddle_tpu_torch.distributed.elastic.store, "
            "paddle_tpu_torch.distributed.elastic.manager, "
            "paddle_tpu_torch.observability, "
            "paddle_tpu_torch.observability.timeline, "
            "paddle_tpu_torch.core, paddle_tpu_torch.core.tensor, "
            "paddle_tpu_torch.core.dispatch, "
            "paddle_tpu_torch.core.autograd, paddle_tpu_torch.autograd, "
            "paddle_tpu_torch.autograd.py_layer, "
            "paddle_tpu_torch.autograd.functional, "
            "paddle_tpu_torch.framework.dtype, "
            "paddle_tpu_torch.framework.place, "
            "paddle_tpu_torch.framework.random, "
            "paddle_tpu_torch.framework.monitor, paddle_tpu_torch.ops, "
            "paddle_tpu_torch.ops.creation, paddle_tpu_torch.ops.math, "
            "paddle_tpu_torch.ops.manipulation, "
            "paddle_tpu_torch.ops.comparison, "
            "paddle_tpu_torch.ops.reduction, paddle_tpu_torch.ops.linalg, "
            "paddle_tpu_torch.nn, paddle_tpu_torch.nn.layer, "
            "paddle_tpu_torch.nn.initializer, paddle_tpu_torch.jit, "
            "paddle_tpu_torch.framework.io, "
            "paddle_tpu_torch.framework.safetensors, "
            "paddle_tpu_torch.inference.predictor, "
            "paddle_tpu_torch.tools.jit_workload, "
            "paddle_tpu_torch.core.lazy, paddle_tpu_torch.amp, "
            "paddle_tpu_torch.amp.auto_cast, "
            "paddle_tpu_torch.amp.grad_scaler, "
            "paddle_tpu_torch.amp.debugging, "
            "paddle_tpu_torch.models.llama_layers, "
            "paddle_tpu_torch.tools.lazy_workload, "
            "paddle_tpu_torch.tensor_method_names, "
            "paddle_tpu_torch.testing, paddle_tpu_torch.testing.op_harness, "
            "paddle_tpu_torch.nn.functional.loss, "
            "paddle_tpu_torch.nn.functional.attention, "
            "paddle_tpu_torch.nn.layer.loss, paddle_tpu_torch.nn.clip, "
            "paddle_tpu_torch.regularizer, paddle_tpu_torch.optimizer.lr, "
            "paddle_tpu_torch.tools.loop_workload, "
            "paddle_tpu_torch.ops.extended, paddle_tpu_torch.fft, "
            "paddle_tpu_torch.signal, paddle_tpu_torch.tools.fnet_workload, "
            "paddle_tpu_torch.distributed.placement, "
            "paddle_tpu_torch.distributed.parallel, "
            "paddle_tpu_torch.distributed.auto_parallel, "
            "paddle_tpu_torch.distributed.auto_parallel.api, "
            "paddle_tpu_torch.distributed.auto_parallel.sharding_bridge, "
            "paddle_tpu_torch.distributed.auto_parallel.strategy, "
            "paddle_tpu_torch.distributed.communication, "
            "paddle_tpu_torch.distributed.communication.group, "
            "paddle_tpu_torch.distributed.communication.collective, "
            "paddle_tpu_torch.distributed.communication.stream, "
            "paddle_tpu_torch.distributed.communication.watchdog, "
            "paddle_tpu_torch.resilience.elastic_train, "
            "paddle_tpu_torch.tools.elastic_workload\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_tensor_op_slice_entry_points_need_the_card():
    """`paddle.fft`, `paddle.signal`, the extended draws and the FNet
    workload make their tensors on the default place: the card, or a
    raise naming `set_device`."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default place is the card")
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import fnet_workload

    calls = [lambda: paddle.fft.fftfreq(8), lambda: paddle.fft.rfftfreq(8),
             lambda: paddle.logspace(0, 2, 5),
             lambda: paddle.standard_normal([3]),
             lambda: paddle.tril_indices(3),
             lambda: fnet_workload.fnet_workload(paddle),
             lambda: fnet_workload.tiny_steps(paddle)]
    with place.device_scope(None):
        for call in calls:
            with pytest.raises(RuntimeError, match="set_device"):
                call()


def _tiny_model():
    from paddle_tpu_torch import llama_tiny

    return llama_tiny(vocab=64, layers=1, hidden=32, heads=2, seq=64,
                      device="cpu", generator=torch.Generator().manual_seed(0))


def test_entry_points_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    from paddle_tpu_torch import (LlamaInferenceEngine, ServingFrontend,
                                  llama_tiny)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaInferenceEngine(_tiny_model(), max_blocks_per_seq=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingFrontend(LlamaInferenceEngine(_tiny_model(),
                                             max_blocks_per_seq=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama_tiny()
    from paddle_tpu_torch.serving import MLPLMEngine

    with pytest.raises(RuntimeError, match="device='cpu'"):
        MLPLMEngine()
    assert MLPLMEngine(device="cpu").cache.device.type == "cpu"
    from paddle_tpu_torch.serving import attach_adapters

    lora = attach_adapters(MLPLMEngine(device="cpu"), pool_slots=2)
    assert {t.device.type for pl in lora._pools.values()
            for t in pl.values()} == {"cpu"}
    assert lora.cache.device.type == "cpu"
    from paddle_tpu_torch.tools.serve_workload import (lora_workload,
                                                       migrate_workload,
                                                       serve_engine)

    for workload in (lora_workload, migrate_workload, serve_engine):
        with pytest.raises(RuntimeError, match="device='cpu'|CUDA"):
            workload(device=None)
    from paddle_tpu_torch.tools.train_workload import train_workload

    with pytest.raises(RuntimeError, match="device='cpu'|CUDA"):
        train_workload(device=None)
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import lazy_workload

    # lazy_llama's workload on the default place: the card, or a raise
    with place.device_scope(None):
        with pytest.raises(RuntimeError, match="set_device"):
            lazy_workload.llama_workload(paddle)
    # train_loop's workload likewise, and the harness sweep's default
    from paddle_tpu_torch.tools import loop_workload

    with place.device_scope(None):
        with pytest.raises(RuntimeError, match="set_device"):
            loop_workload.loop_workload(paddle)
        with pytest.raises(RuntimeError, match="set_device"):
            loop_workload.tiny_loop(paddle)
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        MoELayer(d_model=8, num_experts=4)
    assert MoELayer(d_model=8, num_experts=4, device="cpu") \
        .experts.w1.device.type == "cpu"
    eng = LlamaInferenceEngine(_tiny_model(), max_blocks_per_seq=4,
                               device="cpu")
    assert eng.k_cache.device.type == "cpu"
    ServingFrontend(eng)
    # a shard lives on its base engine's device
    from paddle_tpu_torch.serving import shard_engine

    shard = shard_engine(eng, tp=1)
    assert shard.k_cache.device.type == shard.device.type == "cpu"
    assert shard_engine(MLPLMEngine(device="cpu"), tp=1) \
        .cache.device.type == "cpu"


def test_block_cache_copy_is_isolated_from_the_jax_package():
    """The JAX package's manager reaches its fault sites through
    `sys.modules`; the port's copy must not, even when both packages are
    loaded in one process."""
    from paddle_tpu.resilience import faults
    from paddle_tpu_torch.inference.cache import BlockCacheManager

    mgr = BlockCacheManager(8, 4, 4)
    faults.inject("serve.cache", times=None)
    try:
        # the JAX manager raises at this armed site in allocate and
        # append_tokens
        mgr.allocate(0, 3)
        mgr.allocate(1, 0)
        mgr.append_tokens(1, 6)
        mgr.trim(1, 2)
        assert faults.state().get("serve.cache", {}).get("calls", 0) == 0
    finally:
        faults.clear("serve.cache")
    assert (mgr.seq_blocks(0), mgr.seq_blocks(1), mgr.free_blocks) == (1, 1, 6)
    tables = mgr.block_table_array([0, 1], pad=-1)
    assert tables.shape == (2, 4) and (tables[:, 1:] == -1).all()
    mgr.free(0)
    mgr.free(1)
    assert mgr.free_blocks == 8


def test_block_cache_fires_the_ports_own_fault_site():
    """The port's manager arms the `serve.cache` site of the port's own
    registry (`paddle_tpu_torch.resilience.faults`), never the JAX
    package's, in allocate, adopt and append_tokens."""
    from paddle_tpu.resilience import faults as jax_faults
    from paddle_tpu_torch.inference.cache import BlockCacheManager
    from paddle_tpu_torch.resilience import faults

    mgr = BlockCacheManager(8, 4, 4)
    faults.inject("serve.cache", after_n=2, times=None)
    try:
        blocks = mgr.allocate(0, 3)
        mgr.adopt(1, blocks, 3)
        for call in (lambda: mgr.append_tokens(1, 1),
                     lambda: mgr.allocate(2, 1)):
            with pytest.raises(faults.InjectedFault):
                call()
        assert faults.state()["serve.cache"]["calls"] == 4
        assert "serve.cache" not in jax_faults.state()
    finally:
        faults.clear()
    mgr.check_consistency()
    assert (mgr.seq_len(1), mgr.ref_count(blocks[0])) == (3, 2)


def test_jax_written_pdparams_loads_without_either_package(tmp_path):
    """A `.pdparams` the JAX package wrote (its payload class pickled under
    `paddle_tpu.framework.io`), loaded by a process that imports only the
    port: the values arrive (bf16 included) and neither `paddle_tpu` nor
    `jax` is imported."""
    import numpy as np

    import paddle_tpu as jpaddle

    jpaddle.seed(1)
    lin = jpaddle.nn.Linear(3, 2)
    lin.astype("bfloat16")
    path = str(tmp_path / "m.pdparams")
    jpaddle.save(lin.state_dict(), path)
    want = lin.weight.astype("float32").numpy().tolist()
    code = ("import sys, paddle_tpu_torch as paddle\n"
            "paddle.set_device('cpu')\n"
            f"sd = paddle.load({path!r})\n"
            "w = sd['weight']\n"
            "assert w.dtype == paddle.bfloat16, w.dtype\n"
            f"assert w.astype('float32').numpy().tolist() == {want!r}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert np.asarray(want).shape == (3, 2)


def test_layer_path_entry_points_need_the_card_unless_asked_for_cpu(
        tmp_path):
    """Building a Layer, `paddle.load` and `create_predictor` put their
    tensors on the card unless asked for the CPU (`set_device("cpu")`,
    `Config.disable_gpu()`): without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default place is it")
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place

    with place.device_scope("cpu"):
        lin = paddle.nn.Linear(4, 2)
        assert lin.weight.place == paddle.CPUPlace()
        paddle.save(lin.state_dict(), str(tmp_path / "m.pdparams"))
        lin.eval()
        paddle.jit.save(lin, str(tmp_path / "m"), input_spec=[
            paddle.jit.InputSpec([None, 4], "float32")])
        assert paddle.load(str(tmp_path / "m.pdparams"))["weight"].place \
            == paddle.CPUPlace()
    with place.device_scope(None):
        with pytest.raises(RuntimeError, match="set_device"):
            paddle.nn.Linear(4, 2)
        with pytest.raises(RuntimeError, match="set_device"):
            paddle.load(str(tmp_path / "m.pdparams"))
        cfg = paddle.inference.Config(str(tmp_path / "m.pdmodel"),
                                      str(tmp_path / "m.pdiparams"))
        with pytest.raises(RuntimeError, match="set_device"):
            paddle.inference.create_predictor(cfg)
        with pytest.raises(RuntimeError, match="set_device"):
            paddle.jit.load(str(tmp_path / "m"))
        cfg.disable_gpu()
        p = paddle.inference.create_predictor(cfg)
        assert p.run([np.ones((3, 4), np.float32)])[0].shape == (3, 2)
