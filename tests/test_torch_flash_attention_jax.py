"""The port's plain flash-attention versions against the JAX package's
reference attention and its Pallas kernels in interpret mode.

These are test_torch_flash_attention.py's checks that run the JAX side;
its helpers are imported from there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu_torch.ops import flash_attention as tfa
from test_torch_flash_attention import (  # noqa: F401 (fixtures)
    jfa,
    SHAPES,
    _qkv,
    _tols,
    _torch_fwd_bwd,
    _jax_fwd_bwd,
    twin_fwd,
)


@pytest.mark.parametrize("b,s,h,d,causal", SHAPES)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_reference_matches_jax_reference(b, s, h, d, causal, bf16):
    arrs = _qkv(7, b, s, h, d)
    tout, tgrads = _torch_fwd_bwd(arrs, causal, bf16)
    jout, jgrads = _jax_fwd_bwd(
        lambda q, k, v: jfa.reference_attention(q, k, v, causal=causal,
                                                bf16=bf16), arrs)
    fwd, bwd = _tols(bf16)
    np.testing.assert_allclose(tout, jout, **fwd)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t, j, **bwd)


@pytest.mark.parametrize("b,s,h,d,causal", SHAPES)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_reference_matches_pallas_kernels_interpret(b, s, h, d, causal,
                                                    bf16):
    from jax.experimental.pallas import tpu as pltpu

    arrs = _qkv(11, b, s, h, d)
    tout, tgrads = _torch_fwd_bwd(arrs, causal, bf16)
    with pltpu.force_tpu_interpret_mode():
        jout, jgrads = _jax_fwd_bwd(
            lambda q, k, v: jfa.pallas_flash_attention(q, k, v, causal,
                                                       bf16), arrs)
    fwd, bwd = _tols(bf16)
    np.testing.assert_allclose(tout, jout, **fwd)
    for t, j in zip(tgrads, jgrads):
        np.testing.assert_allclose(t, j, **bwd)


def test_plain_backward_bf16_option_rounds_like_the_pallas_kernels():
    """With bf16=True the plain dQ/dK/dV versions round P, dS and their
    other operands as the Pallas backward does: held to the interpret-mode
    kernels' gradients of a linear loss (so dO is exact in both)."""
    from jax.experimental.pallas import tpu as pltpu

    b, s, h, d = 1, 128, 1, 64
    arrs = _qkv(5, b, s, h, d)
    w = np.random.default_rng(6).normal(size=(b, s, h, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jgrads = jax.grad(
            lambda *t: jnp.sum(jfa.pallas_flash_attention(*t, True, True)
                               * w), argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in arrs))
    q, k, v = (torch.from_numpy(a) for a in arrs)
    dout = torch.from_numpy(w)
    o, lse = twin_fwd(q, k, v, True)
    delta = tfa.flash_delta(dout, o)
    got = (tfa.flash_dq_reference(q, k, v, dout, lse, delta, True, True),
           *tfa.flash_dkv_reference(q, k, v, dout, lse, delta, True, True))
    for t, j in zip(got, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=5e-2,
                                   rtol=5e-2)
