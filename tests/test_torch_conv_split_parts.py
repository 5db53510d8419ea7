"""The conv models' split layers as their tensor ranks' parts, in one
process on the CPU: chip_smoke.py's phase 18a at a small batch.

Each layer (the UNet's conv_in, a down and an up conv, a resblock with a
skip conv and the mid attention at the base width; ResNet-50's head and
loss; MNIST's fc pair) is computed from the models' own per-rank parts
(`diffusion._res_part1`, `mnist._fc_part`, ...) on each rank's pieces of
the params as the state cuts them (`sharding.tensor_piece`), combined as
the collectives combine them, and held against the unsplit layer: the
output and every gradient within 1e-5 of the largest element (fp32, the
sums in other orders), at tensor 2 and 4. Both of 18a's planted faults (a
gather whose backward sums, fc2's bias added on every rank) must break
that limit. The batch is cut to 2 rows (the card runs 64 and 256).
"""

import pytest
import torch

import chip_smoke

ROWS = 2
TOL = 1e-5
LAYERS = ("unet conv_in", "unet down", "unet up", "unet resblock",
          "unet attention", "resnet50 head+loss", "mnist fc pair")


def cat(pieces):
    return torch.cat(pieces, dim=1)


def once(x, bias, t):
    return x + bias


def every(x, bias, t):
    return x + t * bias


class SummingCat(torch.autograd.Function):
    # A gather whose backward sums every rank's (equal) gradient.
    @staticmethod
    def forward(ctx, *pieces):
        ctx.n = [p.shape[1] for p in pieces]
        return torch.cat(pieces, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return tuple(len(ctx.n) * g for g in grad.split(ctx.n, dim=1))


@pytest.fixture(scope="module")
def layers():
    return chip_smoke.conv_split_layers(torch.float32, 7, device="cpu",
                                        rows=ROWS)


@pytest.mark.parametrize("name", LAYERS)
def test_the_ranks_parts_make_the_whole_layer(layers, name):
    layer = layers[name]
    for t in chip_smoke.CONV_SPLITS:
        err = chip_smoke.split_errors(layer, t, cat, once)
        assert max(err.values()) <= TOL, (name, t, err)
        # Rank 0's part alone has the shape of its share.
        whole = layer[2](*layer[:2])
        with torch.no_grad():
            part = layer[4](layer[0], layer[1], t)
        if name.startswith("unet") and name != "unet attention":
            assert part.shape[1] * t == whole.shape[1], (name, t)


@pytest.mark.parametrize("name,fault", [
    ("unet resblock", "gather"), ("mnist fc pair", "bias")])
def test_the_planted_faults_are_refused(layers, name, fault):
    fcat = (lambda ps: SummingCat.apply(*ps)) if fault == "gather" else cat
    err = chip_smoke.split_errors(layers[name], 2, fcat,
                                  every if fault == "bias" else once)
    assert max(err.values()) > 0.5, (name, err)
