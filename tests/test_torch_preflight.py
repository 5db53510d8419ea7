"""The port's preflight (determined_tpu_torch/analysis) against the JAX
package's, on the CPU.

  - config rules: every DTL2xx config tests/test_preflight.py builds, and
    a positive and a negative of each rule, through both packages'
    `check_config`: the same codes, levels and messages, exactly.
  - AST lint: a torch positive and negative of each of DTL101-DTL107, the
    port's step roots (step factories, a CUDA graph capture), `noqa` as
    the JAX lint has it, and DTL106 on the same Thread sources in both.
  - rules DTL002-DTL005 on small port trials, as tests/test_preflight.py
    has them for the JAX engine.
  - the flash kernels' meta route: shapes only, no launch counted; CPU
    tensors still run the plain version (dispatcher) or raise (wrappers).
  - the port's fixture pair through `python -m determined_tpu_torch.analysis
    preflight` in a subprocess with `jax` blocked.
  - the dogfood gate, the metric-name and native lints, and the rule table
    in docs/preflight-torch.md.

The abstract engine's byte counts against the JAX engine's are in
tests/test_torch_preflight_engine.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

from determined_tpu.analysis import check_config as jax_check_config
from determined_tpu.analysis.astlint import lint_source as jax_lint_source
from determined_tpu_torch.analysis import RULES, check_config
from determined_tpu_torch.analysis.abstract import analyze_trial
from determined_tpu_torch.analysis.astlint import lint_source
from determined_tpu_torch.train import TorchTrial
from determined_tpu_torch.train.trial import TrialContext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "preflight_torch")


def codes(diags):
    return sorted({d.code for d in diags if not d.suppressed})


def triples(diags):
    return [(d.code, d.level, d.message) for d in diags]


# ---------------------------------------------------------------------------
# config rules (DTL201-DTL208): the same dict through both packages
# ---------------------------------------------------------------------------


def _config(**over):
    c = {
        "entrypoint": "python3 train.py",
        "searcher": {"name": "single", "metric": "loss",
                     "max_length": {"batches": 64}},
        "resources": {"slots_per_trial": 8},
        "hyperparameters": {},
    }
    c.update(over)
    return c


def _asha(max_length):
    return {"name": "async_halving", "metric": "loss",
            "max_length": {"batches": max_length}, "num_rungs": 5,
            "divisor": 4}


def _elastic(gbs, mesh):
    return _config(resources={"slots_per_trial": 8,
                              "elastic": {"min_slots": 1, "max_slots": 8}},
                   hyperparameters={"global_batch_size": gbs, "mesh": mesh})


def _sweep(compile_block=None, **hp):
    c = _config(searcher={"name": "random", "metric": "loss",
                          "max_length": {"batches": 64}, "max_trials": 20},
                hyperparameters=hp)
    if compile_block is not None:
        c["compile"] = compile_block
    return c


def _serving(**kw):
    return {"serving": {"checkpoint": "latest", **kw}}


# (case id, config, the codes it must give)
CONFIG_CASES = [
    # tests/test_preflight.py's configs, rebuilt.
    ("dtl201", _config(hyperparameters={"global_batch_size": 30}),
     ["DTL201"]),
    ("dtl201-neg", _config(hyperparameters={"global_batch_size": 32}), []),
    ("dtl202", _config(searcher=_asha(100)), ["DTL202"]),
    ("dtl202-neg", _config(searcher=_asha(256)), []),
    ("dtl203-restarts", _config(min_checkpoint_period={"batches": 0},
                                max_restarts=3), ["DTL203"]),
    ("dtl203-default-restarts",
     _config(min_checkpoint_period={"batches": 0}), ["DTL203"]),
    ("dtl203-neg-absent", _config(max_restarts=3), []),
    ("dtl203-neg-periodic", _config(min_checkpoint_period={"batches": 50},
                                    max_restarts=3), []),
    ("dtl203-neg-no-restarts", _config(min_checkpoint_period={"batches": 0},
                                       max_restarts=0), []),
    ("dtl206-block", _serving(kv_block_size=24, max_seq_len=256),
     ["DTL206"]),
    ("dtl206-neg-block", _serving(kv_block_size=16, max_seq_len=256), []),
    ("dtl206-pool", _serving(kv_block_size=16, max_seq_len=256,
                             kv_num_blocks=8), ["DTL206"]),
    ("dtl206-neg-pool", _serving(kv_block_size=16, max_seq_len=256,
                                 kv_num_blocks=16), []),
    ("dtl206-neg-defaults", _serving(), []),
    ("dtl206-neg-dense", _serving(kv_block_size=24, max_seq_len=256,
                                  attention_impl="dense"), []),
    # The other rules, a positive and a negative each.
    ("dtl204", _elastic(32, {"fsdp": 4}), ["DTL204"]),
    ("dtl204-batch", _elastic(32, {}), ["DTL204"]),
    ("dtl204-neg", _elastic(840, {}), []),
    ("dtl205", _sweep(global_batch_size={"type": "int", "minval": 8,
                                         "maxval": 64}), ["DTL205"]),
    ("dtl205-neg-bucketed",
     _sweep({"bucket_batch_sizes": True},
            global_batch_size={"type": "int", "minval": 8, "maxval": 64}),
     []),
    ("dtl207-min", _serving(replicas={"min": -1, "max": 2}), ["DTL207"]),
    ("dtl207-floor", _serving(replicas={"min": 1, "max": 2,
                                        "on_demand_floor": 5}), ["DTL207"]),
    ("dtl207-budget", _serving(replicas={"min": 0, "max": 2,
                                         "cold_start_budget_s": 0}),
     ["DTL207"]),
    ("dtl207-neg", _serving(replicas={"min": 0, "max": 2,
                                      "cold_start_budget_s": 30}), []),
    ("dtl208", _serving(canary={"fraction": 1}), ["DTL208"]),
    ("dtl208-zero", _serving(canary={"fraction": 0}), ["DTL208"]),
    ("dtl208-neg", _serving(canary={"fraction": 0.1}), []),
]


@pytest.mark.parametrize("config,want", [(c, w) for _, c, w in CONFIG_CASES],
                         ids=[i for i, _, _ in CONFIG_CASES])
def test_config_rules_match_jax(config, want):
    """Exact: the same codes, levels and messages, in the same order."""
    ours = check_config(config)
    assert codes(ours) == want
    assert triples(ours) == triples(jax_check_config(config))


# ---------------------------------------------------------------------------
# AST lint (DTL101-DTL107)
# ---------------------------------------------------------------------------


def _trial_src(body, loader="        yield {}\n"):
    return (
        "import time, random\n"
        "import numpy as np\n"
        "import torch\n"
        "import torch.nn.functional as F\n"
        "from determined_tpu_torch.train import TorchTrial\n"
        "class T(TorchTrial):\n"
        "    def init_params(self, rng):\n"
        "        return {}\n"
        "    def loss(self, params, batch, rng):\n"
        f"{body}"
        "        return batch\n"
        "    def build_training_data(self):\n"
        f"{loader}"
    )


def _lint(body, **kw):
    return lint_source(_trial_src(body, **kw), "t.py")


# (case id, loss body, the codes it must give)
AST_CASES = [
    ("dtl101-item", "        x = batch.sum().item()\n", ["DTL101"]),
    ("dtl101-cpu", "        x = batch.cpu()\n", ["DTL101"]),
    ("dtl101-tolist", "        x = batch.tolist()\n", ["DTL101"]),
    ("dtl101-numpy", "        x = batch.detach().numpy()\n", ["DTL101"]),
    ("dtl101-float", "        x = float(batch.mean())\n", ["DTL101"]),
    ("dtl101-int-torch", "        x = int(torch.argmax(batch))\n",
     ["DTL101"]),
    ("dtl101-sync", "        torch.cuda.synchronize()\n", ["DTL101"]),
    ("dtl101-np-asarray", "        x = np.asarray(batch)\n", ["DTL101"]),
    ("dtl101-neg-np-constant", "        x = np.asarray([1.0, 2.0])\n", []),
    ("dtl101-neg-float-hparam",
     "        x = float(self.context.hparams.get('lr', 1.0))\n", []),
    ("dtl102-random", "        x = random.random()\n", ["DTL102"]),
    ("dtl102-np-random", "        x = np.random.normal()\n", ["DTL102"]),
    ("dtl102-neg-torch",
     "        x = torch.randn(2, generator=rng, device=batch.device)\n", []),
    ("dtl103", "        t = time.time()\n", ["DTL103"]),
    ("dtl104-shape", "        if batch.shape[0] > 2:\n            pass\n",
     ["DTL104"]),
    ("dtl104-len", "        while len(batch) > 2:\n            pass\n",
     ["DTL104"]),
    ("dtl104-size", "        y = 1 if batch.size(0) > 2 else 2\n",
     ["DTL104"]),
    ("dtl104-neg-reshape",
     "        x = batch.reshape(batch.shape[0], -1)\n", []),
    ("dtl107-softmax", "        p = torch.softmax(batch @ batch.T, -1)\n",
     ["DTL107"]),
    ("dtl107-method", "        p = (batch @ batch.T).softmax(-1) @ batch\n",
     ["DTL107"]),
    ("dtl107-sdpa",
     "        o = F.scaled_dot_product_attention(batch, batch, batch)\n",
     ["DTL107"]),
    ("dtl107-neg-log-softmax", "        p = F.log_softmax(batch, -1)\n", []),
]


@pytest.mark.parametrize("body,want", [(b, w) for _, b, w in AST_CASES],
                         ids=[i for i, _, _ in AST_CASES])
def test_ast_rule_in_loss(body, want):
    out = _lint(body)
    assert codes(out) == want
    for d in out:
        assert d.level == RULES[d.code].level and d.engine == "ast"


LOADER_CASES = [
    ("dtl105-cuda", "        yield {'x': torch.zeros(4).cuda()}\n",
     ["DTL105"]),
    ("dtl105-to", "        yield {'x': torch.zeros(4).to('cuda')}\n",
     ["DTL105"]),
    ("dtl105-to-device",
     "        yield {'x': torch.zeros(4).to(device=torch.device('cuda:0'))}\n",
     ["DTL105"]),
    ("dtl105-factory", "        yield {'x': torch.zeros(4, device='cuda')}\n",
     ["DTL105"]),
    ("dtl105-neg-numpy",
     "        yield {'x': np.zeros((8, 4), np.float32)}\n", []),
    ("dtl105-neg-cpu", "        yield {'x': torch.zeros(4).to('cpu')}\n", []),
]


@pytest.mark.parametrize("loader,want", [(b, w) for _, b, w in LOADER_CASES],
                         ids=[i for i, _, _ in LOADER_CASES])
def test_dtl105_loader(loader, want):
    out = _lint("", loader=loader)
    assert codes(out) == want
    assert all(d.level == "warning" for d in out)


@pytest.mark.parametrize("src,want", [
    # A nested def handed to a step factory is a step; its factory is not.
    ("import time\n"
     "from determined_tpu_torch.train.step import make_train_step\n"
     "def build(tx):\n"
     "    t0 = time.time()\n"
     "    def step_loss(params, batch, rng):\n"
     "        return batch.sum() * time.time()\n"
     "    return make_train_step(step_loss, tx)\n", ["DTL103"]),
    # A module-level function handed over, and the helper it calls.
    ("import random\n"
     "from determined_tpu_torch.train import step\n"
     "def _noise():\n"
     "    return random.random()\n"
     "def my_loss(params, batch, rng):\n"
     "    return batch * _noise()\n"
     "multi = step.make_multi_step(my_loss, None, 4)\n", ["DTL102"]),
    # A lambda handed over.
    ("from determined_tpu_torch.train.step import make_eval_step\n"
     "def build(trial):\n"
     "    return make_eval_step(lambda p, b: {'l': b.sum().item()})\n",
     ["DTL101"]),
    # The body of a CUDA graph capture.
    ("import torch\n"
     "def capture(g, x):\n"
     "    y = x.sum().item()\n"
     "    with torch.cuda.graph(g):\n"
     "        z = x.sum().item()\n"
     "    return y, z\n", ["DTL101"]),
    # Host code outside any step is free to read values.
    ("def report(metrics):\n"
     "    return {k: v.item() for k, v in metrics.items()}\n", []),
    # JaxTrial and PyTorchTrial methods are not the port's step code.
    ("class A(JaxTrial):\n"
     "    def loss(self, params, batch, rng):\n"
     "        return batch.sum().item()\n"
     "class B(PyTorchTrial):\n"
     "    def evaluate_batch(self, batch):\n"
     "        return {'loss': batch.sum().item()}\n", []),
], ids=["factory-nested", "factory-module", "factory-lambda",
        "graph-capture", "host-code", "other-trial-kinds"])
def test_step_roots(src, want):
    assert codes(lint_source(src, "t.py")) == want


def test_dtl107_helper_closure_and_library():
    src = (
        "import torch\n"
        "from determined_tpu_torch.train import TorchTrial\n"
        "def apply_attention(q, k, v):\n"
        "    return torch.softmax(q @ k.T, -1) @ v\n"
        "class T(TorchTrial):\n"
        "    def _attn(self, q, k, v):\n"
        "        return torch.softmax(q @ k.T, -1) @ v\n"
        "    def loss(self, params, batch, rng):\n"
        "        return self._attn(batch, batch, batch)\n"
    )
    out = lint_source(src, "t.py")
    # The trial's helper is flagged; the model library's apply* is not.
    assert [(d.code, d.line) for d in out] == [("DTL107", 7)]


# Each noqa form on a JAX trial and its torch twin: both lints suppress (or
# keep) the same finding.
NOQA_CASES = [("line", "  # det: noqa[DTL101]", ["DTL101"], []),
              ("bare", "  # det: noqa", ["DTL101"], []),
              ("wrong-code", "  # det: noqa[DTL104]", [], ["DTL101"])]


@pytest.mark.parametrize("comment,suppressed,active",
                         [c[1:] for c in NOQA_CASES],
                         ids=[c[0] for c in NOQA_CASES])
def test_noqa_matches_jax(comment, suppressed, active):
    line = f"        x = batch.sum().item(){comment}\n"
    jax_src = ("from determined_tpu.train import JaxTrial\n"
               "class T(JaxTrial):\n"
               "    def loss(self, params, batch, rng):\n"
               f"{line}"
               "        return batch\n")
    ours = lint_source(jax_src.replace("JaxTrial", "TorchTrial"), "t.py")
    theirs = jax_lint_source(jax_src, "t.py")
    for out in (ours, theirs):
        assert codes(out) == active
        assert [d.code for d in out if d.suppressed] == suppressed
        assert [d.suppressed_by for d in out if d.suppressed] == \
            ["noqa"] * len(suppressed)


THREAD_SOURCES = [
    ("import threading\n"
     "class Worker(threading.Thread):\n"
     "    def __init__(self):\n"
     "        super().__init__()\n"
     "        self._stop = threading.Event()\n"),
    ("from threading import Thread\n"
     "class Worker(Thread):\n"
     "    _stop = None\n"),
    ("import threading\n"
     "class Worker(threading.Thread):\n"
     "    def _stop(self):\n"
     "        pass\n"),
    ("import threading\n"
     "class Base(threading.Thread):\n"
     "    pass\n"
     "class Worker(Base):\n"
     "    def run(self):\n"
     "        self._stop = threading.Event()\n"),
    ("import threading\n"
     "class Worker(threading.Thread):\n"
     "    def __init__(self):\n"
     "        self._stop_evt = threading.Event()\n"),
    ("import threading\n"
     "class Manager:\n"
     "    def __init__(self):\n"
     "        self._stop = threading.Event()\n"),
    ("import threading\n"
     "class Worker(threading.Thread):\n"
     "    def __init__(self):\n"
     "        self._stop = threading.Event()  # det: noqa[DTL106]\n"),
]


@pytest.mark.parametrize("src", THREAD_SOURCES,
                         ids=["instance", "class-attr", "method",
                              "subclass", "neg-stop-evt", "neg-not-thread",
                              "noqa"])
def test_dtl106_matches_jax(src):
    ours = lint_source(src, "t.py")
    theirs = jax_lint_source(src, "t.py")
    assert [(d.code, d.line, d.level, d.message, d.suppressed)
            for d in ours] == \
        [(d.code, d.line, d.level, d.message, d.suppressed) for d in theirs]


# ---------------------------------------------------------------------------
# abstract rules DTL002-DTL005 (tests/test_preflight.py:96-153's cases)
# ---------------------------------------------------------------------------


class SmallTrial(TorchTrial):
    """Clean baseline: small params, divisible batch."""

    def __init__(self, context, batch=32):
        super().__init__(context)
        self._batch = batch

    def init_params(self, rng):
        return {"w": torch.randn(16, 8, generator=rng, device=rng.device)
                * 0.1}

    def loss(self, params, batch, rng):
        logits = batch["x"] @ params["w"]
        return torch.mean((logits - batch["y"]) ** 2)

    def build_training_data(self):
        while True:
            yield {"x": np.zeros((self._batch, 16), np.float32),
                   "y": np.zeros((self._batch, 8), np.float32)}


class BigReplicatedTrial(SmallTrial):
    """One 32 MiB leaf, no logical axes -> replicated on every device."""

    def init_params(self, rng):
        return {"emb": torch.randn(32768, 256, generator=rng,
                                   device=rng.device)}

    def loss(self, params, batch, rng):
        return params["emb"].mean() * batch["x"].mean()


class BigShardedTrial(BigReplicatedTrial):
    """Same leaf, annotated; under mesh fsdp=4 it shards -> no DTL002."""

    def param_logical_axes(self):
        return {"emb": ("embed", None)}  # embed -> fsdp

    def mesh_config(self):
        from determined_tpu_torch.parallel.mesh import MeshConfig

        return MeshConfig(data=2, fsdp=4)


class BrokenLossTrial(SmallTrial):
    def loss(self, params, batch, rng):
        return batch["x"] @ params["w"] @ batch["x"]  # shape error


class HostSyncTrial(SmallTrial):
    def loss(self, params, batch, rng):
        return (batch["x"] @ params["w"]).sum().item()


def _ctx(**hp):
    return TrialContext(hparams=hp, n_devices=8)


class TestAbstractRules:
    def test_clean_trial_no_diagnostics(self):
        diags, hbm, _ = analyze_trial(SmallTrial(_ctx()), 8)
        assert codes(diags) == []
        assert hbm["total_bytes"] > 0
        assert hbm["donated"] is True and hbm["donation_extra_bytes"] == 0

    def test_dtl001_never_raised(self):
        """The port updates its state in place: nothing to donate."""
        for trial in (SmallTrial(_ctx()), BigReplicatedTrial(_ctx())):
            diags, _, _ = analyze_trial(trial, 8)
            assert "DTL001" not in codes(diags)

    def test_dtl002_replicated_large_leaf(self):
        diags, _, _ = analyze_trial(BigReplicatedTrial(_ctx()), 8)
        assert codes(diags) == ["DTL002"]
        assert "emb" in diags[0].message

    def test_dtl002_negative_when_sharded(self):
        diags, hbm, _ = analyze_trial(BigShardedTrial(_ctx()), 8)
        assert codes(diags) == []
        assert hbm["params_bytes"] == 32 * 2**20 // 4

    def test_dtl002_negative_single_device(self):
        diags, _, _ = analyze_trial(BigReplicatedTrial(
            TrialContext(hparams={}, n_devices=1)), 1)
        assert codes(diags) == []

    def test_dtl003_batch_not_divisible(self):
        diags, _, _ = analyze_trial(SmallTrial(_ctx(), batch=30), 8)
        assert codes(diags) == ["DTL003"]
        assert diags[0].level == "error"

    def test_dtl003_negative_divisible(self):
        diags, _, _ = analyze_trial(SmallTrial(_ctx(), batch=32), 8)
        assert codes(diags) == []

    def test_dtl004_over_budget(self):
        diags, _, _ = analyze_trial(
            BigReplicatedTrial(_ctx()), 8, hbm_budget_bytes=16 * 2**20)
        assert "DTL004" in codes(diags)

    def test_dtl004_negative_under_budget(self):
        diags, _, _ = analyze_trial(
            SmallTrial(_ctx()), 8, hbm_budget_bytes=2**30)
        assert "DTL004" not in codes(diags)

    def test_dtl005_trace_failure(self):
        diags, _, _ = analyze_trial(BrokenLossTrial(_ctx()), 8)
        assert codes(diags) == ["DTL005"]

    def test_dtl005_host_read_on_meta(self):
        """`.item()` cannot run on the meta device: DTL005, or a note when
        DTL101 already explains it."""
        diags, _, _ = analyze_trial(HostSyncTrial(_ctx()), 8)
        assert codes(diags) == ["DTL005"]
        diags, _, notes = analyze_trial(HostSyncTrial(_ctx()), 8,
                                        trace_failure_excused=True)
        assert codes(diags) == []
        assert any("does not trace" in n for n in notes)

    def test_footprint_scales_with_mesh(self):
        _, hbm8, _ = analyze_trial(BigShardedTrial(_ctx()), 8)
        _, hbm1, _ = analyze_trial(
            BigReplicatedTrial(TrialContext(hparams={}, n_devices=1)), 1)
        assert hbm8["params_bytes"] * 4 == hbm1["params_bytes"]


# ---------------------------------------------------------------------------
# the flash kernels' meta route
# ---------------------------------------------------------------------------


def test_flash_meta_route_computes_and_launches_nothing():
    from determined_tpu_torch.ops import flash_attention as fa

    counts = (fa.flash_fwd_cuda.launches, fa.flash_dq_cuda.launches,
              fa.flash_dkv_cuda.launches, fa.reference_attention.calls)
    q = torch.empty(2, 256, 4, 64, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    o = fa.flash_attention(q, q, q, impl="auto")  # auto: the card's route
    o.sum().backward()
    assert o.shape == q.shape and o.device.type == "meta"
    assert q.grad.shape == q.shape and q.grad.device.type == "meta"
    o, lse = fa.flash_fwd_cuda(q, q, q)
    assert lse.shape == (8, 256) and lse.dtype == torch.float32
    assert (fa.flash_fwd_cuda.launches, fa.flash_dq_cuda.launches,
            fa.flash_dkv_cuda.launches,
            fa.reference_attention.calls) == counts
    # The kernels' layout rules hold on meta too: D 32 is refused.
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd_cuda(*[torch.empty(1, 128, 2, 32, device="meta")] * 3)
    # No fallback: a CPU tensor still raises in the wrapper, and the
    # dispatcher still sends it to the plain version.
    x = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="not cuda"):
        fa.flash_fwd_cuda(x, x, x)
    fa.flash_attention(x, x, x, impl="auto")
    assert fa.reference_attention.calls == counts[3] + 1


def test_yaml_config_names_pyyaml_when_missing(tmp_path, monkeypatch):
    from determined_tpu_torch.analysis import _preflight

    path = tmp_path / "c.yaml"
    path.write_text("hyperparameters: {global_batch_size: 8}\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="PyYAML"):
        _preflight.load_config(str(path))


# ---------------------------------------------------------------------------
# the dogfood gate, the registries, the rule table
# ---------------------------------------------------------------------------


def test_metric_and_native_lints_are_clean():
    from determined_tpu_torch.analysis import metric_lint, native_lint

    assert metric_lint.lint_registry() == []
    assert native_lint.lint_native() == []


def _copy_emitters(tmp_path):
    """A root holding the metric lint's sources, to plant drift in."""
    import shutil

    from determined_tpu_torch.analysis import metric_lint

    for rel in metric_lint.METRIC_SOURCES + metric_lint.SPAN_SOURCES:
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), dst)
    return tmp_path


def test_metric_lint_sees_the_harness_compile_drift(tmp_path):
    """The drift this port had: its Trainer emitted no `harness.compile`.
    With that emission taken out of a copy, the lint reports the stale
    row again."""
    from determined_tpu_torch.analysis import metric_lint

    root = _copy_emitters(tmp_path)
    trainer = root / "determined_tpu_torch/train/trainer.py"
    text = trainer.read_text()
    assert '"harness.compile"' in text
    trainer.write_text(text.replace('"harness.compile"', '"harness.other"'))
    problems = metric_lint.lint_registry(str(root))
    assert any("'harness.compile' registered but emitted nowhere" in p
               for p in problems)


def test_metric_lint_unported_spans_cannot_go_stale(tmp_path):
    """The resize spans (Queue 1 item 8) were the port's last unported
    ones: its Trainer now emits both, with the JAX Trainer's attributes,
    the lint finds no drift, and with the reshard's emission taken out
    of a copy it reports the stale row again."""
    import re

    from determined_tpu_torch.analysis import metric_lint

    def span_attrs(text, name):
        m = re.search(r'span\(\s*"' + re.escape(name) + r'",(.*?)\)', text,
                      re.S)
        assert m, name
        return set(re.findall(r"(\w+)=", m.group(1)))

    port = open(os.path.join(REPO, "determined_tpu_torch", "train",
                             "trainer.py")).read()
    jax_trainer = open(os.path.join(REPO, "determined_tpu", "train",
                                    "trainer.py")).read()
    for name, attrs in (("harness.resize.downtime", {"from_slots", "target"}),
                        ("harness.reshard", {"target"})):
        assert span_attrs(port, name) == span_attrs(jax_trainer, name) == \
            attrs
    assert not hasattr(metric_lint, "UNPORTED_SPANS")
    root = _copy_emitters(tmp_path)
    assert not [p for p in metric_lint.lint_registry(str(root))
                if "resize" in p or "reshard" in p]
    trainer = root / "determined_tpu_torch/train/trainer.py"
    trainer.write_text(trainer.read_text().replace('"harness.reshard"',
                                                   '"harness.other"'))
    problems = metric_lint.lint_registry(str(root))
    assert any("'harness.reshard' registered but emitted nowhere" in p
               for p in problems)


def test_every_rule_is_documented():
    doc = open(os.path.join(REPO, "docs", "preflight-torch.md")).read()
    for code, rule in RULES.items():
        assert f"| {code} |" in doc, f"{code} missing from the table"
        assert rule.name in doc
