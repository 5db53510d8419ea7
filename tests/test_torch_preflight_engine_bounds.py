"""The preflight's memory estimate against what runs: a gloo world 2's real
fsdp shards, the autograd saves the activation bound must cover, MoE
traced with static shapes, and the kernel route's bytes.

These are test_torch_preflight_engine.py's checks that run models; its
helpers are imported from there."""

import json
import os
import subprocess
import sys

import pytest

from determined_tpu.analysis.abstract import analyze_trial as jax_analyze
from determined_tpu_torch.analysis import abstract
from determined_tpu_torch.train.trial import TrialContext
from test_torch_preflight_engine import (  # noqa: F401 (fixtures)
    REPO,
    GPT2_HP,
    trials,
    _count_bytes,
    _saved_bytes,
    KernelShapeGPT2,
    _LAYOUT_WORKER,
)


@pytest.mark.parametrize("model", ["gpt2", "mnist", "resnet"])
def test_activation_bound_covers_autograd_saves(trials, model):
    """At mesh 1, on the route the CPU takes (GPT-2's plain attention, no
    remat, so autograd keeps the most), the estimate is at least what
    autograd saves for the backward."""
    hp = {"attention_impl": "reference", "remat": False} \
        if model == "gpt2" else {}
    trial = trials[model][1](hp, 1)
    _, hbm, _ = abstract.analyze_trial(trial, 1)
    saved = _saved_bytes(trial, next(iter(trial.build_training_data())))
    print(f"{model}: activations {hbm['activations_upper_bound_bytes']}, "
          f"autograd saves {saved}")
    assert saved > 0
    assert hbm["activations_upper_bound_bytes"] >= saved


def test_kernel_route_counts_no_score_matrix():
    """S 256, D 64: with the kernel route (`auto`, as on a CUDA device) no
    op output is [.., S, S]; the plain route makes the scores."""
    shapes = {}
    for impl in ("auto", "reference"):
        trial = KernelShapeGPT2(TrialContext(
            hparams={"attention_impl": impl}))
        params, _, _ = abstract.abstract_state(trial)
        batch = next(iter(trial.build_training_data()))
        counter = abstract.forward_output_bytes(trial, params, None, batch)
        shapes[impl] = [s for _, s in counter.outputs
                        if s[-2:] == (256, 256)]
    assert shapes["auto"] == []
    assert shapes["reference"]


def test_estimate_equals_real_fsdp_shards(trials, tmp_path):
    """TINY GPT-2 (d_model 64: every "embed" dim splits evenly in two)."""
    hp = {**GPT2_HP, "mesh": {"fsdp": 2}}
    _, hbm, _ = abstract.analyze_trial(trials["gpt2"][1](hp, 2), 2)
    script = tmp_path / "worker.py"
    script.write_text(_LAYOUT_WORKER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp_path), json.dumps(hp),
         os.path.join(REPO, "examples/gpt2_cuda/model_def.py")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["sharded"] > 0
        assert got["params"] == hbm["params_bytes"]
        assert got["moments"] == hbm["opt_state_bytes"]


@pytest.mark.parametrize("mesh,n", [({}, 1), ({"expert": 2}, 2)],
                         ids=["data", "expert"])
def test_moe_traces_with_static_shapes(trials, mesh, n):
    """MoE GPT-2 (4 experts, top-2): the port routes by index, and every
    shape in the routing is static, so the loss runs on meta (no DTL005)
    and the bytes match the JAX engine's as the dense model's do."""
    make_jax, make_port = trials["gpt2"]
    hp = {"num_experts": 4, "moe_top_k": 2, "mesh": mesh}
    jtrial = make_jax(hp, n)
    _, jhbm, _ = jax_analyze(jtrial, n)
    d, hbm, notes = abstract.analyze_trial(make_port(hp, n), n)
    assert d == [] and notes == []
    assert hbm["activations_upper_bound_bytes"] > 0
    for key in ("params_bytes", "grads_bytes", "batch_bytes"):
        assert hbm[key] == jhbm[key], key
    assert hbm["opt_state_bytes"] == \
        jhbm["opt_state_bytes"] - _count_bytes(jtrial)
