"""ResNet (CIFAR and ImageNet variants) in PyTorch:
determined_tpu/models/resnet.py's functions.

Images come in NHWC as in the JAX model; the convolutions run in NCHW on
OIHW kernels (channels_last in memory), with XLA's SAME padding, which
is asymmetric at stride 2 (models/_conv.py). Activations are bf16 and
the params fp32, as in the JAX model.

BatchNorm is the JAX model's formula, not `nn.BatchNorm2d`'s:

  - the mean and the mean of squares are fp32-accumulated reductions over
    the activation, and `var = max(E[x^2] - E[x]^2, 0)`, the biased
    variance (torch's running variance is the unbiased one);
  - the running stats update as `m * old + (1 - m) * new`, m = 0.9
    (torch's `momentum` weights the other side);
  - the normalisation is one affine `x * a + b` in the activation's dtype,
    with `a` and `b` computed in fp32 and cast, rounded once
    (`torch.addcmul`, as XLA fuses it);
  - the backward (`_BatchNorm`) keeps the activation in its own dtype and
    the fp32 per-channel stats, never an fp32 copy of the activation: at
    ResNet-50's batch that decides what fits on the card.

Over a mesh whose `data` or `fsdp` axis is above 1, the statistics are
those of the global batch, as the JAX function's `jnp.mean` over a
batch-sharded array is under GSPMD: the fp32 sum and sum of squares are
all-reduced over the batch axes, and in the backward the per-channel sums
of the gradient that reach the statistics are too. Never over `tensor`
or `context`: the ranks of those groups hold the same rows.

Over a `tensor` axis only the head is split, by its class columns (its
kernel over ("embed", "mlp"), as in the JAX model): each rank computes
its columns of the logits from the pooled features (Megatron's f before
the product), the logits are gathered whole (`collectives.gather_from`:
the loss on them is replicated, so each rank keeps its columns' slice of
the gradient) and the replicated bias is added once, to the whole. The
convolutions and BatchNorm are replicated over `tensor` and `context`,
as in the JAX model.

The batch statistics are a separate tree (`init` returns `(params,
batch_stats)`), the Trainer's `extra` for a stateful trial; `loss_fn`
returns the new statistics, which the train step copies into the state's
buffers in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from determined_tpu_torch.models import _conv
from determined_tpu_torch.models.gpt2 import map_params
from determined_tpu_torch.parallel import collectives, sharding


@dataclasses.dataclass(frozen=True)
class Config:
    stage_sizes: Sequence[int] = (2, 2, 2, 2)  # resnet18
    num_filters: int = 64
    n_classes: int = 10
    bottleneck: bool = False
    cifar_stem: bool = True  # 3x3 stem, no maxpool (CIFAR); else 7x7/2 + pool
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5

    @staticmethod
    def resnet18_cifar(n_classes: int = 10) -> "Config":
        return Config()

    @staticmethod
    def resnet50(n_classes: int = 1000) -> "Config":
        return Config(stage_sizes=(3, 4, 6, 3), bottleneck=True,
                      cifar_stem=False, n_classes=n_classes)


def _block_channels(cfg: Config, stage: int) -> Tuple[int, int]:
    width = cfg.num_filters * (2 ** stage)
    return width, width * (4 if cfg.bottleneck else 1)


def _blocks(cfg: Config):
    """(name, stride, [(k, cin, cout) of each conv], has a projection, in
    channels, out channels) of every residual block, in order."""
    in_c = cfg.num_filters
    for s, n_blocks in enumerate(cfg.stage_sizes):
        width, out_c = _block_channels(cfg, s)
        for b in range(n_blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            if cfg.bottleneck:
                convs = [(1, in_c, width), (3, width, width), (1, width, out_c)]
            else:
                convs = [(3, in_c, width), (3, width, out_c)]
            yield (f"stage{s}_block{b}", stride, convs,
                   stride != 1 or in_c != out_c, in_c, out_c)
            in_c = out_c


def _stats(c: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {"mean": torch.zeros(c, dtype=dtype, device=device),
            "var": torch.ones(c, dtype=dtype, device=device)}


def init_stats(cfg: Config = Config(), device=None) -> Dict[str, Any]:
    """The batch_stats `init` returns: running means 0, variances 1."""
    pd = cfg.param_dtype
    stats: Dict[str, Any] = {"stem_bn": _stats(cfg.num_filters, pd, device)}
    for name, _, convs, proj, _, out_c in _blocks(cfg):
        bs = {f"bn{i}": _stats(cout, pd, device)
              for i, (_, _, cout) in enumerate(convs)}
        if proj:
            bs["proj_bn"] = _stats(out_c, pd, device)
        stats[name] = bs
    return stats


def init(gen: torch.Generator, cfg: Config = Config()
         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """-> (params, batch_stats) on `gen`'s device: he-normal OIHW kernels,
    BatchNorm scale 1 and bias 0, a zero head; running means 0, variances
    1."""
    pd, dev = cfg.param_dtype, gen.device

    def bn(c):
        return {"scale": torch.ones(c, dtype=pd, device=dev),
                "bias": torch.zeros(c, dtype=pd, device=dev)}

    def conv(k, cin, cout):
        return {"kernel": _conv.he_normal((cout, cin, k, k), k * k * cin,
                                          gen, pd)}

    stem_k = 3 if cfg.cifar_stem else 7
    params: Dict[str, Any] = {"stem": conv(stem_k, 3, cfg.num_filters),
                              "stem_bn": bn(cfg.num_filters)}
    for name, _, convs, proj, in_c, out_c in _blocks(cfg):
        bp: Dict[str, Any] = {}
        for i, (k, cin, cout) in enumerate(convs):
            bp[f"conv{i}"] = conv(k, cin, cout)
            bp[f"bn{i}"] = bn(cout)
        if proj:
            bp["proj"] = conv(1, in_c, out_c)
            bp["proj_bn"] = bn(out_c)
        params[name] = bp
    width = _block_channels(cfg, len(cfg.stage_sizes) - 1)[1]
    params["head"] = {
        "kernel": torch.zeros(width, cfg.n_classes, dtype=pd, device=dev),
        "bias": torch.zeros(cfg.n_classes, dtype=pd, device=dev)}
    return params, init_stats(cfg, dev)


def param_logical_axes(cfg: Config = Config()) -> Dict[str, Any]:
    """Every leaf replicated but the head kernel, over ("embed", "mlp"),
    as in the JAX model."""
    conv = {"kernel": (None,) * 4}
    bn = {"scale": (None,), "bias": (None,)}
    axes: Dict[str, Any] = {"stem": conv, "stem_bn": bn}
    for name, _, convs, proj, _, _ in _blocks(cfg):
        block = {}
        for i in range(len(convs)):
            block[f"conv{i}"], block[f"bn{i}"] = conv, bn
        if proj:
            block["proj"], block["proj_bn"] = conv, bn
        axes[name] = block
    axes["head"] = {"kernel": ("embed", "mlp"), "bias": (None,)}
    return axes


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX params or batch_stats (numpy arrays, HWIO kernels) as the
    port's."""
    return _conv.tree_from_numpy(tree, device)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params or batch_stats in the JAX layout, as numpy."""
    return _conv.tree_to_numpy(tree)


# ---------------------------------------------------------------- BatchNorm


def _channel_view(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype).view(1, -1, 1, 1)


class _BatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm over [B, C, H, W]: -> (y, batch mean, batch
    variance); the statistics are not differentiable outputs. `groups`:
    the batch axes' process groups (the global batch's statistics), of
    `ranks` ranks in all."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, groups, ranks: int):
        dims = (0, 2, 3)
        n = x.numel() // x.shape[1] * ranks
        xf = _conv.wide(x)
        sums = torch.stack([xf.sum(dims), xf.square().sum(dims)])
        del xf
        if groups:
            sums = collectives.all_reduce(sums, groups)
        mean, mean2 = (sums / n).unbind(0)
        var_raw = mean2 - mean * mean
        var = torch.clamp(var_raw, min=0.0)
        inv = torch.rsqrt(var + eps)
        a = _conv.wide(scale) * inv
        b = _conv.wide(bias) - mean * a
        y = torch.addcmul(_channel_view(b, x.dtype), x,
                          _channel_view(a, x.dtype))
        ctx.save_for_backward(x, scale, mean, inv, a, var_raw > 0)
        ctx.n, ctx.groups = n, groups
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, scale, mean, inv, a, positive = ctx.saved_tensors
        dims = (0, 2, 3)
        gf, xf = _conv.wide(gy), _conv.wide(x)
        local = torch.stack([gf.sum(dims), (gf * xf).sum(dims)])
        sums = collectives.all_reduce(local, ctx.groups) if ctx.groups \
            else local
        g_b, g_a = local.unbind(0)
        s_b, s_a = sums.unbind(0)
        # y = x * a + b, b = bias - mean * a, a = scale * inv,
        # inv = rsqrt(var + eps), var = max(mean2 - mean^2, 0).
        d_inv = (s_a - s_b * mean) * _conv.wide(scale)
        d_var = torch.where(positive, -0.5 * d_inv * inv * inv * inv,
                            torch.zeros_like(d_inv))
        d_mean = -s_b * a - 2.0 * mean * d_var
        c1 = (d_mean / ctx.n).view(1, -1, 1, 1)
        c2 = (2.0 * d_var / ctx.n).view(1, -1, 1, 1)
        # dx = g * a + c1 + c2 * x, in two passes over fp32 temporaries.
        dx = torch.addcmul(c1, gf, a.view(1, -1, 1, 1))
        dx = dx.addcmul_(xf, c2).to(x.dtype)
        d_scale = ((g_a - g_b * mean) * inv).to(scale.dtype)
        return dx, d_scale, g_b.to(scale.dtype), None, None, None


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor],
               st: Dict[str, torch.Tensor], cfg: Config, train: bool,
               groups: List[Any], ranks: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (normalised x, the new running stats: `st` itself in eval)."""
    if not train:
        inv = torch.rsqrt(_conv.wide(st["var"]) + cfg.bn_eps)
        a = _conv.wide(p["scale"]) * inv
        b = _conv.wide(p["bias"]) - _conv.wide(st["mean"]) * a
        return torch.addcmul(_channel_view(b, x.dtype), x,
                             _channel_view(a, x.dtype)), st
    y, mean, var = _BatchNorm.apply(x, p["scale"], p["bias"], cfg.bn_eps,
                                    groups, ranks)
    m = cfg.bn_momentum
    return y, {"mean": m * st["mean"] + (1 - m) * mean,
               "var": m * st["var"] + (1 - m) * var}


# ------------------------------------------------------------------ forward


def apply(params: Dict[str, Any], stats: Dict[str, Any],
          images: torch.Tensor, cfg: Config = Config(), train: bool = False
          ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """images [B, H, W, 3] -> (logits [B, n_classes] fp32, updated
    batch_stats)."""
    import torch.distributed as dist

    groups, tensor = _conv.mesh_groups(params["stem"]["kernel"], "ResNet")
    ranks = 1
    for g in groups:
        ranks *= dist.get_world_size(g)
    p = map_params(lambda t: sharding.gather_for_use(t, keep=("tensor",)),
                   params)

    def bn(x, bp, bst):
        return batch_norm(x, bp, bst, cfg, train, groups, ranks)

    def conv(x, kernel, stride=1):
        return _conv.conv2d_same(x, kernel.to(x.dtype), stride)

    new_stats: Dict[str, Any] = {}
    x = _conv.nchw(images, cfg.dtype)
    x = conv(x, p["stem"]["kernel"], 1 if cfg.cifar_stem else 2)
    x, new_stats["stem_bn"] = bn(x, p["stem_bn"], stats["stem_bn"])
    x = F.relu(x)
    if not cfg.cifar_stem:
        x = _conv.max_pool_same(x, 3, 2)
    for name, stride, convs, proj, _, _ in _blocks(cfg):
        bp, bst = p[name], stats[name]
        ns: Dict[str, Any] = {}
        y = x
        last = len(convs) - 1
        for i in range(len(convs)):
            s = stride if i == (1 if cfg.bottleneck else 0) else 1
            y, ns[f"bn{i}"] = bn(conv(y, bp[f"conv{i}"]["kernel"], s),
                                 bp[f"bn{i}"], bst[f"bn{i}"])
            if i < last:
                y = F.relu(y)
        residual = x
        if proj:
            residual, ns["proj_bn"] = bn(conv(x, bp["proj"]["kernel"], stride),
                                         bp["proj_bn"], bst["proj_bn"])
        x = F.relu(y + residual)
        new_stats[name] = ns
    logits = _head_part(_conv.wide(x).mean(dim=(2, 3)), p, tensor)
    if tensor is not None:
        logits = collectives.gather_from(logits, tensor.group, 1)
    return logits + _conv.wide(p["head"]["bias"]), new_stats


def _head_part(x, p, tensor=None):
    """The head's logits over the class columns that `p` (the rank's
    pieces) holds, its bias left out: x [B, width] the pooled features,
    whole. With `tensor=None` one process runs any rank's part
    (chip_smoke.py's phase 18a)."""
    return _conv.copy_to(x, tensor) @ _conv.wide(p["head"]["kernel"])


def _nll(logits, labels):
    """(mean cross entropy, accuracy) of fp32 logits [B, classes]."""
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0].mean()
    return nll, (logits.argmax(-1) == labels).float().mean()


def loss_fn(params, stats, batch: Dict[str, torch.Tensor], rng=None,
            cfg: Config = Config(), train: bool = True):
    """The stateful protocol (train.step.make_train_step(stateful=True)):
    -> (loss, {"accuracy"}, new batch_stats)."""
    logits, new_stats = apply(params, stats, batch["images"], cfg,
                              train=train)
    nll, acc = _nll(logits, batch["labels"])
    return nll, {"accuracy": acc}, new_stats

