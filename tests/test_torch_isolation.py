"""The PyTorch port stands alone: it loads neither JAX nor the JAX package,
and its entry points refuse to fall back to the CPU quietly."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "determined_tpu_torch",
    "determined_tpu_torch._device",
    "determined_tpu_torch._info",
    "determined_tpu_torch.analysis",
    "determined_tpu_torch.analysis.__main__",
    "determined_tpu_torch.analysis._preflight",
    "determined_tpu_torch.analysis.abstract",
    "determined_tpu_torch.analysis.astlint",
    "determined_tpu_torch.analysis.config_rules",
    "determined_tpu_torch.analysis.diagnostics",
    "determined_tpu_torch.analysis.metric_lint",
    "determined_tpu_torch.analysis.native_lint",
    "determined_tpu_torch.analysis.rules",
    "determined_tpu_torch.autotune",
    "determined_tpu_torch.autotune._batch_size",
    "determined_tpu_torch.cli",
    "determined_tpu_torch.common.api",
    "determined_tpu_torch.common.bindings",
    "determined_tpu_torch.common.faultpoint",
    "determined_tpu_torch.common.metric_names",
    "determined_tpu_torch.common.streams",
    "determined_tpu_torch.common.trace",
    "determined_tpu_torch.compile",
    "determined_tpu_torch.compile.bucketing",
    "determined_tpu_torch.core",
    "determined_tpu_torch.core._checkpoint",
    "determined_tpu_torch.core._context",
    "determined_tpu_torch.core._distributed",
    "determined_tpu_torch.core._integrity",
    "determined_tpu_torch.core._preempt",
    "determined_tpu_torch.core._profiler",
    "determined_tpu_torch.core._searcher",
    "determined_tpu_torch.core._train",
    "determined_tpu_torch.data",
    "determined_tpu_torch.data.bench",
    "determined_tpu_torch.data.prefetch",
    "determined_tpu_torch.exec",
    "determined_tpu_torch.exec.launch",
    "determined_tpu_torch.exec.prep",
    "determined_tpu_torch.expconf",
    "determined_tpu_torch.experimental",
    "determined_tpu_torch.experimental.client",
    "determined_tpu_torch.experimental.core_v2",
    "determined_tpu_torch.experimental.core_v2._core_v2",
    "determined_tpu_torch.launch",
    "determined_tpu_torch.launch.torch_distributed",
    "determined_tpu_torch.models._conv",
    "determined_tpu_torch.models.diffusion",
    "determined_tpu_torch.models.gpt2",
    "determined_tpu_torch.models.mnist",
    "determined_tpu_torch.models.resnet",
    "determined_tpu_torch.ops._build",
    "determined_tpu_torch.ops._softmax_common",
    "determined_tpu_torch.ops.flash_attention",
    "determined_tpu_torch.ops.moe",
    "determined_tpu_torch.ops.paged_attention",
    "determined_tpu_torch.ops.ring_attention",
    "determined_tpu_torch.ops.ulysses",
    "determined_tpu_torch.parallel",
    "determined_tpu_torch.parallel.collectives",
    "determined_tpu_torch.parallel.mesh",
    "determined_tpu_torch.parallel.pipeline",
    "determined_tpu_torch.parallel.sharding",
    "determined_tpu_torch.pytorch",
    "determined_tpu_torch.pytorch._trial",
    "determined_tpu_torch.pytorch.deepspeed",
    "determined_tpu_torch.pytorch.zero",
    "determined_tpu_torch.searcher",
    "determined_tpu_torch.searcher._remote_search_runner",
    "determined_tpu_torch.searcher._search_method",
    "determined_tpu_torch.serve",
    "determined_tpu_torch.serve.engine",
    "determined_tpu_torch.serve.http",
    "determined_tpu_torch.serve.kv_cache",
    "determined_tpu_torch.serve.model",
    "determined_tpu_torch.serve.scheduler",
    "determined_tpu_torch.serve.task",
    "determined_tpu_torch.serve.tracing",
    "determined_tpu_torch.storage",
    "determined_tpu_torch.storage.azure",
    "determined_tpu_torch.storage.base",
    "determined_tpu_torch.storage.cloud",
    "determined_tpu_torch.tensorboard",
    "determined_tpu_torch.train",
    "determined_tpu_torch.train.health",
    "determined_tpu_torch.train.optim",
    "determined_tpu_torch.train.state",
    "determined_tpu_torch.train.step",
    "determined_tpu_torch.train.trainer",
    "determined_tpu_torch.train.trial",
    "determined_tpu_torch.train.watchdog",
]
# Files of the port outside the package, imported by path.
PORT_FILES = ["examples/gpt2_cuda/model_def.py",
              "examples/mnist_cuda/model_def.py",
              "examples/diffusion_cuda/model_def.py",
              "examples/diffusion_cuda/pretrain.py",
              "examples/gpt2_torch_cuda/model_def.py",
              "tests/fixtures/preflight_torch/bad/model_def.py",
              "tests/fixtures/preflight_torch/clean/model_def.py",
              "tests/fixtures/platform_torch/autotune_train.py",
              "tests/fixtures/platform_torch/autotune_gpt2.py"]


def _cuda_hidden(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_port_imports_neither_jax_nor_the_jax_package():
    probe = (
        "import importlib, importlib.util, json, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"for i, path in enumerate({PORT_FILES!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'f{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0].startswith("
        "'jax') or m.split('.')[0] == 'determined_tpu')\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_import_statement_names_jax():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|determined_tpu)\b")
    offenders = []
    paths = [os.path.join(REPO, p) for p in ["chip_smoke.py", *PORT_FILES]]
    for root, _, files in os.walk(os.path.join(REPO, "determined_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if pat.match(line):
                    offenders.append(f"{path}:{n}: {line.strip()}")
    assert offenders == []


def test_resolve_device_requires_cuda_unless_cpu_is_asked(monkeypatch):
    from determined_tpu_torch import resolve_device

    _cuda_hidden(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.serve.engine import ServingEngine
    from determined_tpu_torch.serve.task import build_replica

    _cuda_hidden(monkeypatch)
    cfg = gpt2.Config(vocab_size=64, n_positions=32, d_model=16, n_layer=1,
                      n_head=2, dtype=torch.float32)
    params = gpt2.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(params, cfg, slots=1, max_seq_len=16)
    path = str(tmp_path / "p.npz")
    gpt2.save_params_npz(path, params)
    config = {"serving": {"checkpoint": path, "max_batch_size": 1,
                          "max_seq_len": 16, "kv_block_size": 8,
                          "model_config": {
                              "vocab_size": 64, "n_positions": 32,
                              "d_model": 16, "n_layer": 1, "n_head": 2,
                              "dtype": "float32"}}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_replica(config)
    engine, _ = build_replica(config, device="cpu")  # asked for by name
    assert engine.device.type == "cpu"


def test_kernel_impl_on_cpu_raises_instead_of_falling_back():
    from determined_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 2, 16)).astype(np.float32))
    pool = torch.from_numpy(rng.normal(size=(3, 4, 2, 16)).astype(np.float32))
    tables = torch.tensor([[0, 1], [2, 2]], dtype=torch.int32)
    pos = torch.tensor([5, 0], dtype=torch.int32)
    calls = pa.paged_attention_reference.calls
    for fn in (pa.paged_attention_cuda,
               lambda *a: pa.paged_decode_attention(*a, impl="kernel")):
        with pytest.raises(ValueError, match="not cuda"):
            fn(q, pool, pool, tables, pos)
    assert pa.paged_attention_reference.calls == calls  # no fallback ran
    # "auto" picks by the tensors' device: the plain version for CPU ones.
    out = pa.paged_decode_attention(q, pool, pool, tables, pos, impl="auto")
    assert out.shape == q.shape
    assert pa.paged_attention_reference.calls == calls + 1


def test_engine_kernel_impl_on_cpu_raises_at_decode():
    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.serve.engine import ServingEngine

    cfg = gpt2.Config(vocab_size=64, n_positions=32, d_model=16, n_layer=1,
                      n_head=2, dtype=torch.float32)
    params = gpt2.init(torch.Generator().manual_seed(0), cfg)
    for spelling in ("kernel", "pallas"):
        eng = ServingEngine(params, cfg, slots=1, max_seq_len=16,
                            kv_block_size=8, attention_impl=spelling,
                            device="cpu")
        assert eng.attention_impl == "kernel"
        with pytest.raises(ValueError, match="not cuda"):
            eng.compile()  # the warm decode reaches the kernel wrapper


@pytest.mark.parametrize("bad, match", [
    ({"q": ((2, 2, 48), torch.float32), "k": ((3, 16, 2, 48), torch.float32)},
     "head_dim 48"),
    ({"q": ((2, 2, 64), torch.float16), "k": ((3, 16, 2, 64), torch.float16)},
     "dtype"),
    ({"k": ((3, 16, 2, 64), torch.bfloat16)}, "dtypes differ"),
    ({"k": ((3, 12, 2, 64), torch.float32)}, "block_size 12"),
    ({"k": ((3, 16, 4, 64), torch.float32)}, "do not match q"),
    ({"tb": ((2, 4), torch.int64)}, "int32"),
    ({"pos": ((3,), torch.int32)}, "slot count"),
    ({"transpose_q": True}, "not contiguous"),
])
def test_kernel_wrapper_layout_checks(bad, match):
    """The wrapper's dtype/shape/layout checks, which run right after the
    device check and before any build or launch."""
    from determined_tpu_torch.ops.paged_attention import _check_layout

    spec = {"q": ((2, 2, 64), torch.float32),
            "k": ((3, 16, 2, 64), torch.float32),
            "tb": ((2, 4), torch.int32), "pos": ((2,), torch.int32)}
    spec.update({k: v for k, v in bad.items() if k != "transpose_q"})
    q, k, tb, pos = (torch.zeros(*spec[n][0], dtype=spec[n][1])
                     for n in ("q", "k", "tb", "pos"))
    if bad.get("transpose_q"):
        q = torch.zeros(2, 64, 2).transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        _check_layout(q, k, k, tb, pos)
    # The well-formed case passes the same checks.
    _check_layout(*(torch.zeros(*shape, dtype=dtype) for shape, dtype in (
        ((2, 2, 64), torch.float32), ((3, 16, 2, 64), torch.float32),
        ((3, 16, 2, 64), torch.float32), ((2, 4), torch.int32),
        ((2,), torch.int32))))


def _flash_cpu_inputs():
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, 128, 2, 64))
                                    .astype(np.float32)) for _ in range(4))
    lse = torch.zeros(2, 128)
    return q, k, v, do, lse


def test_flash_wrappers_on_cpu_raise_instead_of_falling_back():
    from determined_tpu_torch.ops import flash_attention as fa

    q, k, v, do, lse = _flash_cpu_inputs()
    calls = (fa.reference_attention.calls, fa.flash_fwd_reference.calls,
             fa.flash_dq_reference.calls, fa.flash_dkv_reference.calls)
    for fn in (lambda: fa.flash_fwd_cuda(q, k, v),
               lambda: fa.flash_dq_cuda(q, k, v, do, lse, lse),
               lambda: fa.flash_dkv_cuda(q, k, v, do, lse, lse),
               lambda: fa.cuda_flash_attention(q, k, v),
               lambda: fa.flash_attention(q, k, v, impl="kernel"),
               lambda: fa.flash_attention(q, k, v, impl="pallas")):
        with pytest.raises(ValueError, match="not cuda"):
            fn()
    assert (fa.reference_attention.calls, fa.flash_fwd_reference.calls,
            fa.flash_dq_reference.calls,
            fa.flash_dkv_reference.calls) == calls  # no fallback ran
    # "auto" picks by the tensors' device: the plain version for CPU ones.
    assert fa.flash_attention(q, k, v, impl="auto").shape == q.shape
    assert fa.reference_attention.calls == calls[0] + 1


@pytest.mark.parametrize("bad, match", [
    ({"d": 48}, "head_dim 48"),
    ({"dtype": torch.float16}, "dtype"),
    ({"k_dtype": torch.bfloat16}, "does not match"),
    ({"transpose": True}, "last dim is not contiguous"),
])
def test_flash_wrapper_layout_checks(bad, match):
    """The flash wrappers' dtype/shape/layout checks, which run right after
    the device check and before any build or launch."""
    from determined_tpu_torch.ops.flash_attention import _check_layout

    d = bad.get("d", 64)
    q = torch.zeros(1, 128, 2, d, dtype=bad.get("dtype", torch.float32))
    k = q.to(bad.get("k_dtype", q.dtype))
    if bad.get("transpose"):
        q = torch.zeros(1, 128, d, 2).transpose(2, 3)
    with pytest.raises(ValueError, match=match):
        _check_layout("flash", (("q", q), ("k", k), ("v", k)))
    ok = torch.zeros(1, 128, 2, 64)
    _check_layout("flash", (("q", ok), ("k", ok), ("v", ok)))


def test_trainer_raises_without_cuda(monkeypatch, tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "gpt2_cuda_model_def", os.path.join(REPO, PORT_FILES[0]))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    from determined_tpu_torch import core
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    _cuda_hidden(monkeypatch)
    ctx = core.init(max_length=1, checkpoint_dir=str(tmp_path))
    trial = example.GPT2Trial(TrialContext(hparams={"model_size": "tiny",
                                                    "seq_len": 16}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(trial, core_context=ctx)
    assert Trainer(trial, core_context=ctx, device="cpu").device.type == \
        "cpu"


def test_the_conv_examples_and_harnesses_raise_without_cuda(monkeypatch,
                                                             tmp_path):
    import importlib.util

    from determined_tpu_torch import core
    from determined_tpu_torch.data.bench import ab_compare
    from determined_tpu_torch.models import diffusion
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    def load(path, name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, path))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    mnist_ex = load(PORT_FILES[1], "mnist_cuda_model_def")
    pretrain = load(PORT_FILES[3], "diffusion_cuda_pretrain")
    _cuda_hidden(monkeypatch)
    ctx = core.init(max_length=1, checkpoint_dir=str(tmp_path))
    trial = mnist_ex.MNistTrial(TrialContext(hparams={"hidden": 8}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(trial, core_context=ctx)
    ctx.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain.main(["--steps", "1", "--model-size", "tiny",
                       "--out", str(tmp_path / "p.pkl")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_compare(lambda: iter(()), lambda b: None)
    cfg = diffusion.Config.tiny()
    params = diffusion.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="captures a CUDA graph"):
        diffusion.sample(params, torch.Generator(), 1, cfg, graph=True)
