"""Batch-size bucketing in the port's Trainer against the JAX Trainer.

A tiny fp32 GPT-2 trial whose loaders yield batches of 6 rows runs through
`determined_tpu.train.Trainer` (one CPU device) and
`determined_tpu_torch.train.Trainer` (`device="cpu"`), with
`compile = {"bucket_batch_sizes": True}` (every batch padded to 8 rows by
wrapping: rows 6 and 7 repeat rows 0 and 1) and with bucketing off. The
losses and grad norms of every step, the validation loss and the final
params must agree. Then the port alone: the step and the eval step see 8
rows, a tensor leaf stays a tensor, and a stream rebuilt past consumed
batches (as at a resize) pads as the first one did.

Tolerances: losses and grad norms atol 1e-4 / rtol 1e-5 over 4 steps (the
tolerance of test_torch_trainer.py: fp32, the same arithmetic in another
summation order, through the optimizer's updates); validation loss atol
1e-4; params atol 1e-5 (4 AdamW steps of lr <= 1e-3 on leaves of ~0.2).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from determined_tpu import core as jcore
from determined_tpu.compile import bucketing as jbucketing
from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.train import JaxTrial
from determined_tpu.train import Trainer as JTrainer
from determined_tpu.train.trial import TrialContext as JTrialContext
from determined_tpu_torch import core as tcore
from determined_tpu_torch.compile import bucketing as tbucketing
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.train import TorchTrial
from determined_tpu_torch.train import Trainer as TTrainer
from determined_tpu_torch.train import optim
from determined_tpu_torch.train.trial import TrialContext as TTrialContext

DIMS = dict(vocab_size=64, n_positions=32, d_model=32, n_layer=2, n_head=2)
ROWS, BUCKET, STEPS = 6, 8, 4
BUCKETED = {"bucket_batch_sizes": True}


def numpy_params(seed=0, std=0.2):
    rng = np.random.default_rng(seed)
    cfg = tgpt2.Config(**DIMS, dtype=torch.float32)
    flat = tgpt2._flatten(tgpt2.init(torch.Generator().manual_seed(0), cfg))
    return tgpt2._unflatten({
        k: ((1.0 if k.endswith("scale") else 0.0)
            + std * rng.normal(size=tuple(v.shape))).astype(np.float32)
        for k, v in flat.items()})


def batches(seed, n, b=ROWS, s=17):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, DIMS["vocab_size"], size=(b, s))
             .astype(np.int32)} for _ in range(n)]


class JaxGPT2(JaxTrial):
    def __init__(self, context, params, compile_block):
        super().__init__(context)
        self.cfg = jgpt2.Config(**DIMS, dtype=jnp.float32)
        self.params = params
        self.compile = compile_block

    def init_params(self, rng):
        return jax.tree_util.tree_map(jnp.asarray, self.params)

    def loss(self, params, batch, rng):
        return jgpt2.loss_fn(params, batch, self.cfg)

    def optimizer(self):
        sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 100)
        return optax.chain(optax.clip_by_global_norm(1.0),
                           optax.adamw(sched, b2=0.95, weight_decay=0.1))

    def build_training_data(self):
        return batches(1, 8)

    def build_validation_data(self):
        return batches(2, 2)

    def evaluate(self, params, batch):
        return {"validation_loss": jgpt2.loss_fn(params, batch, self.cfg)}


class TorchGPT2(TorchTrial):
    def __init__(self, context, params, compile_block, tensors=False):
        super().__init__(context)
        self.cfg = tgpt2.Config(**DIMS, dtype=torch.float32)
        self.params = params
        self.compile = compile_block
        self.tensors = tensors
        self.seen = []  # (step or eval, rows of the batch)

    def _yield(self, data):
        for b in data:
            yield ({k: torch.from_numpy(v) for k, v in b.items()}
                   if self.tensors else b)

    def init_params(self, rng):
        return tgpt2.params_from_numpy(self.params, rng.device)

    def loss(self, params, batch, rng):
        self.seen.append(("train", int(batch["tokens"].shape[0])))
        assert isinstance(batch["tokens"], torch.Tensor)
        return tgpt2.loss_fn(params, batch, self.cfg)

    def optimizer(self):
        sched = optim.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 100)
        return optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(sched, b2=0.95, weight_decay=0.1))

    def build_training_data(self):
        return self._yield(batches(1, 8))

    def build_validation_data(self):
        return self._yield(batches(2, 2))

    def evaluate(self, params, batch):
        self.seen.append(("eval", int(batch["tokens"].shape[0])))
        return {"validation_loss": tgpt2.loss_fn(params, batch, self.cfg)}


def _jax_fit(tmp_path, params, compile_block):
    ctx = jcore.init(max_length=STEPS, checkpoint_dir=str(tmp_path))
    state = JTrainer(JaxGPT2(JTrialContext(core_context=ctx), params,
                             compile_block),
                     core_context=ctx, devices=jax.devices()[:1]).fit(
        report_period=1)
    ctx.close()
    return ctx, jax.device_get(state.params)


def _port_fit(tmp_path, params, compile_block, tensors=False, **kw):
    ctx = tcore.init(max_length=STEPS, checkpoint_dir=str(tmp_path))
    trial = TorchGPT2(TTrialContext(core_context=ctx), params, compile_block,
                      tensors=tensors)
    trial.prefetch = kw.pop("prefetch", None)
    state = TTrainer(trial, core_context=ctx, device="cpu").fit(
        report_period=1)
    ctx.close()
    return ctx, trial, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both Trainers with bucketing on and off: {"bucketed"|"off": (the
    JAX core context, its params, the port's core context, trial, state)}.
    The port's bucketed run yields tensors through its prefetcher; its
    other run yields numpy arrays."""
    params = numpy_params()
    cases = {name: (block, tmp_path_factory.mktemp(name))
             for name, block in (("bucketed", BUCKETED), ("off", None))}
    # The JAX fits (mostly XLA compiles, which release the GIL) run on a
    # thread while the port's run here.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_runs = {name: pool.submit(_jax_fit, tmp / "jax", params, block)
                    for name, (block, tmp) in cases.items()}
        port_runs = {name: _port_fit(tmp / "pt", params, block,
                                     tensors=block is not None)
                     for name, (block, tmp) in cases.items()}
        return {name: (*jax_runs[name].result(), *port_runs[name])
                for name in cases}


# The attention's key bias has a zero gradient in exact arithmetic: Adam
# turns either side's rounding noise there into steps of up to lr, so that
# slice is held to 4 steps of the peak lr instead.
KEY_BIAS_ATOL = STEPS * 1e-3


@pytest.mark.parametrize("name", ["bucketed", "off"])
def test_fit_matches_the_jax_trainer(runs, name):
    jctx, jparams, tctx, trial, state = runs[name]
    rows = BUCKET if name == "bucketed" else ROWS
    assert {r for _, r in trial.seen} == {rows}
    jrep = jctx.train.local_training_metrics
    trep = tctx.train.local_training_metrics
    assert [r["steps_completed"] for r in trep] == \
        [r["steps_completed"] for r in jrep] == list(range(1, STEPS + 1))
    for j, t in zip(jrep, trep):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(t["metrics"][k], j["metrics"][k],
                                       atol=1e-4, rtol=1e-5, err_msg=k)
    jval = jctx.train.local_validation_metrics[-1]["metrics"]
    tval = tctx.train.local_validation_metrics[-1]["metrics"]
    np.testing.assert_allclose(tval["validation_loss"],
                               jval["validation_loss"], atol=1e-4)
    want = tgpt2._flatten(jparams)
    d = DIMS["d_model"]
    for k, v in tgpt2._flatten(state.params).items():
        got, ref = v.detach().numpy(), np.asarray(want[k])
        if k == "blocks/qkv/bias":
            np.testing.assert_allclose(got[..., d:2 * d], ref[..., d:2 * d],
                                       atol=KEY_BIAS_ATOL, err_msg=k)
            got = np.concatenate([got[..., :d], got[..., 2 * d:]], -1)
            ref = np.concatenate([ref[..., :d], ref[..., 2 * d:]], -1)
        np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=k)


def test_bucketing_changes_the_loss_it_pads_for(runs):
    """Padding is not a no-op: the bucketed run's first loss is the mean
    over 8 rows (rows 0 and 1 twice), not over the 6 rows."""
    cfg = tgpt2.Config(**DIMS, dtype=torch.float32)
    first = batches(1, 1)[0]["tokens"]
    padded = np.concatenate([first, first[:BUCKET - ROWS]])
    tparams = tgpt2.params_from_numpy(numpy_params(), torch.device("cpu"))
    with torch.no_grad():
        want = [float(tgpt2.loss_fn(tparams, {"tokens": torch.from_numpy(t)},
                                    cfg)) for t in (padded, first)]
    got = [runs[n][2].train.local_training_metrics[0]["metrics"]["loss"]
           for n in ("bucketed", "off")]
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(got[0] - got[1]) > 1e-4


@pytest.mark.parametrize("prefetch", [None, False], ids=["prefetch",
                                                        "no-prefetch"])
def test_tensor_leaves_stay_tensors_and_reach_both_steps_padded(
        runs, tmp_path, prefetch):
    if prefetch is None:
        _, _, _, trial, state = runs["bucketed"]
    else:
        _, trial, state = _port_fit(tmp_path, numpy_params(), BUCKETED,
                                    tensors=True, prefetch=prefetch)
    assert state.step == STEPS
    assert trial.seen.count(("train", BUCKET)) == STEPS
    assert trial.seen.count(("eval", BUCKET)) == 2
    assert {r for _, r in trial.seen} == {BUCKET}


@pytest.mark.parametrize("leaf", ["numpy", "tensor"])
def test_pad_batch_is_the_jax_package_s(leaf):
    batch = batches(3, 1, b=5)[0]
    want = jbucketing.bucketed_batch(batch, jbucketing.CompileConfig(
        bucket_batch_sizes=True))
    if leaf == "tensor":
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tbucketing.bucketed_batch(batch, tbucketing.CompileConfig(
        bucket_batch_sizes=True))
    assert isinstance(got["tokens"], type(batch["tokens"]))
    np.testing.assert_array_equal(np.asarray(got["tokens"]),
                                  np.asarray(want["tokens"]))
    assert got["tokens"].shape[0] == 8


def test_a_rebuilt_stream_pads_as_the_first(tmp_path):
    """A resize rebuilds the training stream and skips what was consumed:
    the rebuilt stream's batches are the first stream's, padded alike."""
    ctx = tcore.init(max_length=STEPS, checkpoint_dir=str(tmp_path / "pt"))
    trial = TorchGPT2(TTrialContext(core_context=ctx), numpy_params(),
                      BUCKETED, tensors=True)
    trainer = TTrainer(trial, core_context=ctx, device="cpu")
    trainer._compile_cfg = tbucketing.CompileConfig.resolve(trial)
    trainer._pf_cfg = type("Off", (), {"enabled": False})()
    trainer._consumed = 0
    first, _ = trainer._stream()
    want = [next(first)["tokens"] for _ in range(5)]
    trainer._consumed = 3
    rebuilt, _ = trainer._stream()
    got = [next(rebuilt)["tokens"] for _ in range(2)]
    ctx.close()
    for g, w in zip(got, want[3:]):
        assert g.shape[0] == BUCKET
        assert torch.equal(g, w)
        assert torch.equal(g[ROWS:], g[:BUCKET - ROWS])
