"""`make_multi_step` as CUDA-graph replay on the card (marked `cuda`;
skipped without one: a CUDA graph has no CPU mode).

A small GPT-2 (2 layers, d 64, S 128 so the flash kernels run) trains 6
steps as two windows of 3 through `make_multi_step` and through 6
`make_train_step` calls from the same state and batches: the replay holds
the eager step's kernels fed the same optimizer floats, so params, Adam
moments and window means must agree to the bit (held to atol 0). Also:
the state's step and counts advance as eagerly, the replays launch the
flash kernels, and a state whose tensors were replaced is refused. The
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_multi_step.py
"""

import numpy as np
import pytest
import torch

from determined_tpu_torch.models import gpt2
from determined_tpu_torch.train import optim
from determined_tpu_torch.train.state import create_train_state
from determined_tpu_torch.train.step import make_multi_step, make_train_step

pytestmark = pytest.mark.cuda

N, CALLS = 3, 2


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replays_equal_train_step_calls(cuda, dtype):
    cfg = gpt2.Config(vocab_size=256, n_positions=128, d_model=64,
                      n_layer=2, n_head=1, dtype=dtype)

    def tx():
        return optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(
            optim.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 100),
            b2=0.95, weight_decay=0.1))

    def state(t):
        gen = torch.Generator(device="cuda").manual_seed(0)
        return create_train_state(lambda g: gpt2.init(g, cfg), t, gen,
                                  device="cuda")

    def loss(p, b, r):
        return gpt2.loss_fn(p, b, cfg)

    rng = np.random.default_rng(1)
    windows = [torch.from_numpy(rng.integers(0, 256, (N, 2, 129)).astype(
        np.int32)).cuda() for _ in range(CALLS)]
    ta, tb = tx(), tx()
    multi = make_multi_step(loss, ta, N)
    step = make_train_step(loss, tb)
    a, b = state(ta), state(tb)
    for w in windows:
        a, ma = multi(a, {"tokens": w}, None)
        ms = []
        for i in range(N):
            b, m = step(b, {"tokens": w[i]}, None)
            ms.append(m)
        for k in ma:
            total = ms[0][k].float()
            for m in ms[1:]:
                total = total + m[k].float()
            assert torch.equal(ma[k], total / N), k
    torch.cuda.synchronize()
    assert multi.replays == N * CALLS - 1
    assert multi.replayed_launches == {
        "flash_fwd": 4 * multi.replays, "flash_dq": 2 * multi.replays,
        "flash_dkv": 2 * multi.replays}
    assert a.step == b.step == N * CALLS
    assert a.opt_state[1]["count"] == b.opt_state[1]["count"]
    for x, y in zip(a.leaves() + a.opt_state[1]["mu"] + a.opt_state[1]["nu"],
                    b.leaves() + b.opt_state[1]["mu"] + b.opt_state[1]["nu"]):
        assert torch.equal(x, y)
    a.params = gpt2.map_params(lambda t: t.detach().clone(), a.params)
    with pytest.raises(RuntimeError, match="captured"):
        multi(a, {"tokens": windows[0]}, None)
