"""The port's serve steps as the engine captures them: lengths, slots and
indices as device tensors, and no host read of a device value.

The engine captures each step once as a CUDA graph and replays it with new
inputs in the same buffers, so a step may take no length as a Python int
(a graph would freeze it) and may read nothing back to the host (`.item()`
cannot run inside a capture). Held here on the CPU, f32, TINY size:

  - `paged_prefill` with `suffix_len` / `prefix_len` as 0-d int32 tensors
    gives bitwise the results of the same call with ints, and the JAX
    function's (logits atol=rtol=1e-4, pools 1e-5), for several lengths in
    one bucket over a pool that already holds a prefix;
  - every step function runs on the meta device, where any read of a
    device value on the host raises ("Tensor.item() cannot be called on
    meta tensors").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.models import gpt2 as jgpt2
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.serve import model as tsm

JCFG = jgpt2.Config(vocab_size=128, n_positions=64, d_model=32, n_layer=2,
                    n_head=2, dtype=jnp.float32, remat=False,
                    attention_impl="dot")
TCFG = tgpt2.Config(vocab_size=128, n_positions=64, d_model=32, n_layer=2,
                    n_head=2, dtype=torch.float32, remat=False,
                    attention_impl="dot")
BS, MB, POOL, BUCKET = 8, 4, 9, 16
TABLE = np.array([0, 1, 2, 3], np.int32)


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jgpt2.init(jax.random.PRNGKey(0), JCFG))

    def draw(path, sd):
        if "scale" in jax.tree_util.keystr(path):
            return (1 + 0.1 * rng.normal(size=sd.shape)).astype(np.float32)
        return (0.3 * rng.normal(size=sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _meta(shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.fixture(scope="module")
def meta_params(params):
    return tgpt2.map_params(lambda a: torch.from_numpy(np.array(a)).to(
        "meta"), params)


@pytest.mark.parametrize("step", ["paged_prefill", "paged_decode_step",
                                  "prefill", "decode_step",
                                  "copy_paged_block"])
@pytest.mark.parametrize("with_adapters", [False, True])
def test_steps_never_read_the_device_on_the_host(meta_params, step,
                                                 with_adapters):
    slots, scalar = 3, _meta(())
    adapters = (_meta((3, 128, 32), torch.float32) if with_adapters
                else None)
    paged = tsm.init_paged_cache(TCFG, POOL, BS, device="meta")
    dense = tsm.init_cache(TCFG, slots, 32, device="meta")
    idx = {"slot_adapter": scalar} if with_adapters else {}
    idxs = {"slot_adapters": _meta((slots,))} if with_adapters else {}
    if step == "paged_prefill":
        _, out = tsm.paged_prefill(meta_params, paged, _meta((BUCKET,)),
                                   scalar, scalar, _meta((MB,)), TCFG,
                                   adapters=adapters, **idx)
        assert out.shape == (128,)
    elif step == "paged_decode_step":
        _, out = tsm.paged_decode_step(
            meta_params, paged, _meta((slots,)), _meta((slots,)),
            _meta((slots, MB)), TCFG, attention_impl="reference",
            adapters=adapters, **idxs)
        assert out.shape == (slots, 128)
    elif step == "prefill":
        _, out = tsm.prefill(meta_params, dense, _meta((BUCKET,)), scalar,
                             scalar, TCFG, adapters=adapters, **idx)
        assert out.shape == (128,)
    elif step == "decode_step":
        _, out = tsm.decode_step(meta_params, dense, _meta((slots,)),
                                 _meta((slots,)), TCFG, adapters=adapters,
                                 **idxs)
        assert out.shape == (slots, 128)
    else:
        tsm.copy_paged_block(paged, scalar, scalar)
