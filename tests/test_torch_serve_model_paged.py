"""The port's paged prefill and decode steps against the JAX package's.

These are test_torch_serve_model.py's paged-step checks; its helpers are
imported from there."""

import numpy as np
import pytest

from test_torch_serve_model import (  # noqa: F401 (fixtures)
    pools_close,
    paged_run,
)


@pytest.mark.parametrize("step", ["prefill_a", "prefill_b", "decode"])
def test_paged_steps_match_jax(paged_run, step):
    jl, tl, jc, tc = paged_run[step]
    assert tl.dtype == np.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    pools_close(jc, tc)
