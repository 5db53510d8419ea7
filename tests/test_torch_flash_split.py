"""The exact three-way bf16 split of the tensor-core flash kernels, and the
wrappers' alignment rule for that route. CPU only, no JAX needed.

`split_bf16` is the plain version of the kernels' `split_pair`
(ops/csrc/flash_attention.cu): an fp32 x is x1 + x2 + x3 with each term a
bf16 value, so for a bf16 y the fp32 product x.y is the sum of three bf16
products, each exact in fp32.
"""

import numpy as np
import pytest
import torch

from determined_tpu_torch.ops import flash_attention as fa


def _values(kind, n=4096):
    rng = np.random.default_rng(0)
    if kind == "probabilities":  # P in [0, 1], as exp(s - m)
        x = rng.random(n)
    else:  # dS: signed, over the range a training step produces, with 0
        x = rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-30, 2, n)
        x[::97] = 0.0
        x[1::97] = 1e-30
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind", ["probabilities", "signed"])
def test_three_terms_reconstruct_fp32_exactly(kind):
    x = _values(kind)
    terms = fa.split_bf16(x)
    assert all(t.dtype == torch.bfloat16 for t in terms)
    total = sum(t.double() for t in terms)
    assert torch.equal(total, x.double())
    # The fp32 sum in the kernels' order is exact too.
    assert torch.equal(terms[0].float() + terms[1].float() + terms[2].float(),
                       x)


def test_one_term_is_the_bf16_rounding():
    x = _values("signed")
    (only,) = fa.split_bf16(x, terms=1)
    assert torch.equal(only, x.to(torch.bfloat16))


@pytest.mark.parametrize("kind", ["probabilities", "signed"])
def test_split_product_is_the_fp32_product(kind):
    """sum_t x_t . y over bf16 y equals the fp32 product up to the order of
    its sums: each bf16 x bf16 product is exact, so both sides are fp32 sums
    of the same exact terms (rtol 1e-6, a few fp32 ulps)."""
    x = _values(kind, 64 * 64).reshape(64, 64)
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)).to(
        torch.bfloat16)
    exact = x.double() @ y.double()
    split = sum(t.float() @ y.float() for t in fa.split_bf16(x))
    fp32 = x @ y.float()
    scale = (x.double().abs() @ y.double().abs()).float()
    for got in (split, fp32):
        assert ((got.double() - exact).abs().float()
                <= 1e-6 * scale + 1e-37).all()
    # One term is the rounding of x: wrong by up to 2^-9 of each product.
    one = x.to(torch.bfloat16).float() @ y.float()
    assert ((one.double() - exact).abs() > 1e-6 * scale.double()).any()


def _layout(t, name="flash"):
    fa._check_layout(name, (("q", t[0]), ("k", t[1]), ("v", t[2])))


def test_check_layout_refuses_a_misaligned_bf16_pointer():
    flat = torch.zeros(3 * 128 * 2 * 64 + 8, dtype=torch.bfloat16)
    ok = flat[:128 * 2 * 64].view(1, 128, 2, 64)
    bad = flat[4:4 + 128 * 2 * 64].view(1, 128, 2, 64)  # 8 bytes off
    assert bad.data_ptr() % 16 == 8
    _layout((ok, ok, ok))
    with pytest.raises(ValueError, match="k's data pointer.*16-byte"):
        _layout((ok, bad, ok))


def test_check_layout_refuses_misaligned_bf16_strides():
    # head stride 68 elements = 136 bytes: rows do not start on 16 bytes.
    wide = torch.zeros(1, 128, 2, 68, dtype=torch.bfloat16)
    bad = wide[..., :64]
    ok = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="v's data pointer or .* strides"):
        _layout((ok, ok, bad))
    # The fused qkv views of the model: offsets H*D, row stride 3*H*D.
    qkv = torch.zeros(2, 128, 3 * 12 * 64, dtype=torch.bfloat16)
    _layout(tuple(t.view(2, 128, 12, 64) for t in qkv.split(12 * 64, -1)))


def test_check_layout_takes_misaligned_fp32():
    """fp32 runs on the FFMA route, which loads element by element."""
    wide = torch.zeros(1, 128, 2, 65)
    t = wide[..., 1:]
    _layout((t, t, t))
