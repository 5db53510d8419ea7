"""The DDPM denoising UNet in PyTorch: determined_tpu/models/diffusion.py's
functions.

Epsilon-prediction with the cosine alpha-bar schedule, a UNet of one
residual block a level (GroupNorm, SiLU, 3x3 SAME convolutions, a time
embedding added after the first convolution), a stride-2 SAME
convolution down (padding (0, 1), models/_conv.py), nearest x2 up with
the skip concatenated after the activation (`[h, skip]` on channels), and
single-headed self-attention over the lowest level's C channels, scaled by
1/sqrt(C), its fp32 softmax cast to v's dtype. Activations are bf16 (the
base config) and params fp32. Images come in and predictions go out NHWC,
as in the JAX model; inside, NCHW with OIHW kernels.

The JAX params hold the levels as lists (`down`, `up`); the port keys
them "0", "1", ... (a dict is what the train state flattens):
`params_from_numpy` and `params_to_numpy` convert, kernels included.

`loss_fn` draws the timesteps and the noise from an explicit
`torch.Generator`; its core, `loss_from_noise`, takes them as arguments.
`sample` is the JAX model's ancestral sampler: every noise tensor is
drawn before the loop, and on CUDA one denoising step is captured as a
CUDA graph and replayed `timesteps` times (the JAX package's `lax.scan`
in one program); on the CPU, or with `graph=False`, the same step runs
eagerly.

Over a `tensor` axis each rank does the work the JAX model's logical axes
give it (the default rules map "mlp" and "heads" to `tensor`):

  - every conv whose kernel has "mlp" on its output channels (`conv_in`,
    each resblock's `conv1`, `conv2` and `skip`, `down` and `up`)
    computes this rank's output channels from the whole input, Megatron's
    f (`collectives.copy_to`) before it; the time projection `temb` is
    split as `conv1` is. `conv_out` (3 output channels) and the time MLP
    are replicated, as in the JAX model.
  - A split activation is gathered whole (`_conv.gather_channels`, whose
    backward keeps the rank's slice) after each split conv: so every
    GroupNorm (a resblock's `norm2` too), the down and up convs, the
    concat of the up path and the next block take whole activations.
  - The mid attention has one head, so "heads" splits its channels: the
    `qkv` kernel's 3c columns are `Fused("heads", 3)`, so a rank's
    contiguous slice holds c/t columns each of q, k and v (the state's
    tensor layout, `parallel/sharding.py`); the partial logits q_r k_r^T
    are computed and summed in fp32 over the axis (Megatron's g) before
    the softmax, each rank multiplies the probabilities by its v_r, and
    `out` is split by rows, summed over the axis, its bias added once.

Each rank's part of a split layer is one function (`_conv_part`,
`_res_part1`, `_res_part2`, `_attn_part1`, `_attn_part2`), from the
whole input to the rank's output channels or its share of a sum, with f
at its start; the layer gathers or sums the parts. With `tensor=None`
and a rank's pieces of the params, the same function is that rank's part
in one process, which is how `chip_smoke.py` (phase 18a) holds the parts
against the whole layer on a card.

`context` computes replicated (no leaf or activation is named "seq"), so
a context group's ranks compute the same values. `sample` takes the
params whole (`sharding.full_value`) and runs unsplit on every rank: a
captured CUDA graph cannot hold the collectives.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from determined_tpu_torch.models import _conv
from determined_tpu_torch.models.gpt2 import map_params
from determined_tpu_torch.parallel import collectives, sharding
from determined_tpu_torch.parallel.mesh import AxisGroup


@dataclasses.dataclass(frozen=True)
class Config:
    image_size: int = 32
    channels: int = 3
    base_width: int = 64          # channel width at full resolution
    width_mults: Tuple[int, ...] = (1, 2, 4)  # per resolution level
    time_dim: int = 256
    groups: int = 8               # GroupNorm groups
    timesteps: int = 1000
    attn_at_lowest: bool = True
    dtype: Any = torch.bfloat16   # activation dtype (params stay fp32)
    remat: bool = False

    @staticmethod
    def tiny() -> "Config":
        """CI/e2e size: 16px, thin widths, short schedule."""
        return Config(image_size=16, base_width=16, width_mults=(1, 2),
                      time_dim=32, groups=4, timesteps=64,
                      dtype=torch.float32)


# ------------------------------------------------------------------ schedule


def alpha_bars(cfg: Config, device=None) -> torch.Tensor:
    """Cosine cumulative noise schedule, fp32 [T]."""
    t = torch.arange(cfg.timesteps + 1, dtype=torch.float32,
                     device=device) / cfg.timesteps
    f = torch.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    ab = f / f[0]
    return torch.clamp(ab[1:], 1e-5, 1.0)


def schedule_tables(cfg: Config, device=None) -> Dict[str, torch.Tensor]:
    """The reverse process's per-timestep fp32 coefficients: `alphas`,
    `coef` = beta / sqrt(1 - alpha_bar) and `sigma` = sqrt(beta), 0 at
    t = 0."""
    ab = alpha_bars(cfg, device)
    ab_prev = torch.cat([torch.ones(1, device=ab.device), ab[:-1]])
    alphas = ab / ab_prev
    betas = 1.0 - alphas
    sigma = torch.sqrt(betas)
    sigma[0] = 0.0
    return {"alphas": alphas, "coef": betas / torch.sqrt(1.0 - ab),
            "sigma": sigma}


# -------------------------------------------------------------------- params


def _conv_p(gen, kh, kw, cin, cout):
    w = torch.randn(cout, cin, kh, kw, generator=gen, device=gen.device)
    return {"kernel": w * math.sqrt(2.0 / (kh * kw * cin)),
            "bias": torch.zeros(cout, device=gen.device)}


def _dense_p(gen, din, dout, scale=None):
    w = torch.randn(din, dout, generator=gen, device=gen.device)
    return {"kernel": w * math.sqrt((2.0 if scale is None else scale) / din),
            "bias": torch.zeros(dout, device=gen.device)}


def _norm_p(c, device):
    return {"scale": torch.ones(c, device=device),
            "bias": torch.zeros(c, device=device)}


def _resblock_p(gen, cin, cout, tdim):
    p = {"norm1": _norm_p(cin, gen.device),
         "conv1": _conv_p(gen, 3, 3, cin, cout),
         "temb": _dense_p(gen, tdim, cout),
         "norm2": _norm_p(cout, gen.device),
         "conv2": _conv_p(gen, 3, 3, cout, cout)}
    if cin != cout:
        p["skip"] = _conv_p(gen, 1, 1, cin, cout)
    return p


def _widths(cfg: Config):
    return [cfg.base_width * m for m in cfg.width_mults]


def init(gen: torch.Generator, cfg: Config = Config()) -> Dict[str, Any]:
    """fp32 params on `gen`'s device, in the JAX model's structure (the
    levels keyed "0", "1", ...); the output convolution is zero."""
    widths = _widths(cfg)
    n = len(widths)
    dev = gen.device
    p: Dict[str, Any] = {
        "time_mlp": {"fc1": _dense_p(gen, cfg.time_dim, cfg.time_dim),
                     "fc2": _dense_p(gen, cfg.time_dim, cfg.time_dim)},
        "conv_in": _conv_p(gen, 3, 3, cfg.channels, widths[0]),
    }
    down: Dict[str, Any] = {}
    cin = widths[0]
    for i, w in enumerate(widths):
        lvl = {"res": _resblock_p(gen, cin, w, cfg.time_dim)}
        if i < n - 1:
            lvl["down"] = _conv_p(gen, 3, 3, w, w)
        down[str(i)] = lvl
        cin = w
    p["down"] = down
    mid = {"res1": _resblock_p(gen, cin, cin, cfg.time_dim),
           "res2": _resblock_p(gen, cin, cin, cfg.time_dim)}
    if cfg.attn_at_lowest:
        mid["attn"] = {"norm": _norm_p(cin, dev),
                       "qkv": _dense_p(gen, cin, 3 * cin, scale=1.0),
                       "out": _dense_p(gen, cin, cin, scale=1.0)}
    p["mid"] = mid
    up: Dict[str, Any] = {}
    for j, i in enumerate(reversed(range(n))):
        w = widths[i]
        lvl = {"res": _resblock_p(gen, cin + w, w, cfg.time_dim)}
        if i > 0:
            lvl["up"] = _conv_p(gen, 3, 3, w, w)
        up[str(j)] = lvl
        cin = w
    p["up"] = up
    p["norm_out"] = _norm_p(widths[0], dev)
    out = _conv_p(gen, 3, 3, widths[0], cfg.channels)
    out["kernel"] = torch.zeros_like(out["kernel"])
    p["conv_out"] = out
    return p


def _conv_axes():
    return {"kernel": (None, None, "embed", "mlp"), "bias": ("mlp",)}


def _res_axes(has_skip: bool):
    a = {"norm1": {"scale": (None,), "bias": (None,)},
         "conv1": _conv_axes(),
         "temb": {"kernel": (None, "mlp"), "bias": ("mlp",)},
         "norm2": {"scale": (None,), "bias": (None,)},
         "conv2": _conv_axes()}
    if has_skip:
        a["skip"] = _conv_axes()
    return a


def param_logical_axes(cfg: Config = Config()) -> Dict[str, Any]:
    """The JAX model's logical axes (conv kernels over (embed, mlp) on
    their in and out channels), each conv kernel's tuple permuted to OIHW
    and the levels keyed as the params are."""
    widths = _widths(cfg)
    n = len(widths)
    down = []
    cin = widths[0]
    for i, w in enumerate(widths):
        lvl = {"res": _res_axes(cin != w)}
        if i < n - 1:
            lvl["down"] = _conv_axes()
        down.append(lvl)
        cin = w
    mid = {"res1": _res_axes(False), "res2": _res_axes(False)}
    if cfg.attn_at_lowest:
        # q, k and v side by side: a tensor rank's slice holds c/t
        # columns of each (sharding.Fused).
        heads = sharding.Fused("heads", 3)
        mid["attn"] = {"norm": {"scale": (None,), "bias": (None,)},
                       "qkv": {"kernel": ("embed", heads),
                               "bias": (heads,)},
                       "out": {"kernel": ("heads", "embed"),
                               "bias": ("embed",)}}
    up = []
    for i in reversed(range(n)):
        lvl = {"res": _res_axes(True)}
        if i > 0:
            lvl["up"] = _conv_axes()
        up.append(lvl)
    return _conv.axes_from_jax({
        "time_mlp": {"fc1": {"kernel": (None, None), "bias": (None,)},
                     "fc2": {"kernel": (None, None), "bias": (None,)}},
        "conv_in": {"kernel": (None, None, None, "mlp"), "bias": ("mlp",)},
        "down": down,
        "mid": mid,
        "up": up,
        "norm_out": {"scale": (None,), "bias": (None,)},
        "conv_out": {"kernel": (None, None, "embed", None), "bias": (None,)},
    })


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX params (numpy arrays, HWIO kernels, levels as lists) as the
    port's."""
    return _conv.tree_from_numpy(tree, device)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params in the JAX layout, as numpy arrays."""
    return _conv.tree_to_numpy(params)


# ------------------------------------------------------------------ forward


def _timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal [B, dim] fp32 embedding of integer timesteps."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _group_norm(x, p, groups: int):
    # fp32 statistics over contiguous channel groups and the fp32 affine,
    # whatever the activation dtype.
    xf = _conv.wide(x)
    return F.group_norm(xf, groups, p["scale"].to(xf.dtype),
                        p["bias"].to(xf.dtype), 1e-5).to(x.dtype)


def _conv2d(x, p, stride=1):
    return _conv.conv2d_same(x, p["kernel"].to(x.dtype), stride,
                             bias=p["bias"].to(x.dtype))


def _conv_part(x, p, tensor: Optional[AxisGroup] = None, stride=1):
    """A conv's output channels that `p` (the rank's pieces) holds, from
    the whole `x`."""
    return _conv2d(_conv.copy_to(x, tensor), p, stride)


def _res_part1(x, temb, p, cfg: Config,
               tensor: Optional[AxisGroup] = None):
    """A resblock's conv1 output plus its time projection, over the
    channels that `p` holds: x and temb whole."""
    h = F.silu(_group_norm(x, p["norm1"], cfg.groups))
    h = _conv2d(_conv.copy_to(h, tensor), p["conv1"])
    t = _conv.copy_to(F.silu(temb), tensor) @ \
        p["temb"]["kernel"].to(temb.dtype) + p["temb"]["bias"].to(temb.dtype)
    return h + t[:, :, None, None].to(h.dtype)


def _res_part2(h, x, p, cfg: Config, tensor: Optional[AxisGroup] = None):
    """A resblock's conv2 output, plus its skip conv's, over the channels
    that `p` holds: h (`_res_part1`'s, gathered) and x whole."""
    h = F.silu(_group_norm(h, p["norm2"], cfg.groups))
    h = _conv2d(_conv.copy_to(h, tensor), p["conv2"])
    if "skip" in p:
        h = h + _conv2d(_conv.copy_to(x, tensor), p["skip"])
    return h


def _resblock(x, temb, p, cfg: Config, tensor: Optional[AxisGroup] = None):
    """x and the result whole (on every rank of `tensor`)."""
    h = _conv.gather_channels(_res_part1(x, temb, p, cfg, tensor), tensor)
    h = _conv.gather_channels(_res_part2(h, x, p, cfg, tensor), tensor)
    return h if "skip" in p else h + x


def _attn_part1(x, p, cfg: Config, tensor: Optional[AxisGroup] = None):
    """The attention's q k^T over the columns of q, k and v that `p`
    holds, formed in fp32 (a part rounded to bf16 before the sum would
    round once a part), and those columns of v: x whole."""
    h = _group_norm(x, p["norm"], cfg.groups)
    flat = _conv.copy_to(h.flatten(2).transpose(1, 2), tensor)  # [B, HW, C]
    qkv = flat @ p["qkv"]["kernel"].to(flat.dtype) + \
        p["qkv"]["bias"].to(flat.dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    return torch.matmul(_conv.wide(q), _conv.wide(k).transpose(1, 2)), v


def _attn_part2(logits, v, p, tensor: Optional[AxisGroup] = None):
    """The attention's output before `out`'s bias, over the rows of `out`
    that `p` holds: logits (the sum of `_attn_part1`'s) whole, v that
    part's."""
    c = p["out"]["kernel"].shape[1]
    probs = torch.softmax(logits / math.sqrt(c), dim=-1).to(v.dtype)
    return torch.matmul(_conv.copy_to(probs, tensor), v) @ \
        p["out"]["kernel"].to(v.dtype)


def _attn_out(x, o, p):
    """x plus the attention's output o [B, HW, C] and `out`'s bias."""
    b, c, hh, ww = x.shape
    o = o + p["out"]["bias"].to(o.dtype)
    return x + o.transpose(1, 2).reshape(b, c, hh, ww)


def _self_attention(x, p, cfg: Config, tensor: Optional[AxisGroup] = None):
    """x whole; over `tensor` this rank's c/t columns of q, k and v and
    rows of `out` (the module docstring)."""
    if tensor is not None:
        logits, v = _attn_part1(x, p, cfg, tensor)
        o = _attn_part2(collectives.reduce_from(logits, tensor.group), v, p,
                        tensor)
        return _attn_out(x, collectives.reduce_from(o, tensor.group), p)
    h = _group_norm(x, p["norm"], cfg.groups)
    flat = h.flatten(2).transpose(1, 2)                   # [B, HW, C]
    qkv = flat @ p["qkv"]["kernel"].to(flat.dtype) + \
        p["qkv"]["bias"].to(flat.dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    logits = _conv.wide(torch.matmul(q, k.transpose(1, 2)))
    probs = torch.softmax(logits / math.sqrt(x.shape[1]), dim=-1).to(v.dtype)
    return _attn_out(x, torch.matmul(probs, v) @ p["out"]["kernel"].to(
        v.dtype), p)


def _upsample(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def apply(params: Dict[str, Any], x: torch.Tensor, t: torch.Tensor,
          cfg: Config = Config()) -> torch.Tensor:
    """Predict the noise in x_t. x: [B, H, W, C] in [-1, 1]; t: [B] ints.
    Returns eps_hat with x's shape (cfg.dtype activations, fp32 out)."""
    tensor = _conv.mesh_groups(params["conv_in"]["kernel"],
                               "diffusion").tensor
    params = map_params(
        lambda t: sharding.gather_for_use(t, keep=("tensor",)), params)
    h = _conv.nchw(x, cfg.dtype)
    tm = params["time_mlp"]
    temb = _timestep_embedding(t, cfg.time_dim).to(tm["fc1"]["kernel"].dtype)
    temb = F.silu(temb @ tm["fc1"]["kernel"] + tm["fc1"]["bias"])
    temb = temb @ tm["fc2"]["kernel"] + tm["fc2"]["bias"]

    def block(h, p):
        if not cfg.remat:
            return _resblock(h, temb, p, cfg, tensor)
        from torch.utils.checkpoint import checkpoint

        return checkpoint(_resblock, h, temb, p, cfg, tensor,
                          use_reentrant=False, preserve_rng_state=False)

    def split_conv(h, p, stride=1):
        return _conv.gather_channels(_conv_part(h, p, tensor, stride), tensor)

    h = split_conv(h, params["conv_in"])
    skips = []
    n = len(params["down"])
    for i in range(n):
        lvl = params["down"][str(i)]
        h = block(h, lvl["res"])
        skips.append(h)
        if i < n - 1:
            h = split_conv(h, lvl["down"], stride=2)
    h = block(h, params["mid"]["res1"])
    if "attn" in params["mid"]:
        h = _self_attention(h, params["mid"]["attn"], cfg, tensor)
    h = block(h, params["mid"]["res2"])
    for j in range(n):
        lvl = params["up"][str(j)]
        i = n - 1 - j
        h = torch.cat([h, skips[i]], dim=1)
        h = block(h, lvl["res"])
        if i > 0:
            h = split_conv(_upsample(h), lvl["up"])
    h = _group_norm(h, params["norm_out"], cfg.groups)
    h = _conv2d(F.silu(h), params["conv_out"])
    return _conv.wide(_conv.nhwc(h))


# ------------------------------------------------ training objective + sampling


def loss_from_noise(params: Dict[str, Any], x0: torch.Tensor,
                    t: torch.Tensor, eps: torch.Tensor,
                    cfg: Config = Config()):
    """Epsilon-prediction MSE at timesteps `t` [B] with noise `eps` (x0's
    shape). x0: [B, H, W, C] in [-1, 1]."""
    x0 = _conv.wide(x0)
    ab = alpha_bars(cfg, x0.device)[t][:, None, None, None].to(x0.dtype)
    xt = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps
    eps_hat = apply(params, xt, t, cfg)
    loss = torch.mean((eps_hat - eps) ** 2)
    return loss, {"loss": loss}


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            cfg: Config = Config(),
            generator: Optional[torch.Generator] = None):
    """`loss_from_noise` at timesteps and noise drawn from `generator`
    (a fixed seed, 0, when None). batch["images"]: [B, H, W, C]."""
    x0 = batch["images"]
    if generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    t = torch.randint(0, cfg.timesteps, (x0.shape[0],), generator=generator,
                      device=x0.device)
    eps = torch.randn(x0.shape, generator=generator, device=x0.device)
    return loss_from_noise(params, x0, t, eps, cfg)


def reverse_step(params: Dict[str, Any], x: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor, cfg: Config = Config(),
                 tables: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """One ancestral step x_t -> x_{t-1}. `t`: a [1] int64 tensor on x's
    device (read on the device only, so the step can be captured).
    `params` whole: plain tensors (`sample` gathers a state's)."""
    tables = tables or schedule_tables(cfg, x.device)
    eps_hat = apply(params, x, t.expand(x.shape[0]), cfg)
    coef = tables["coef"].index_select(0, t)
    mean = (x - coef * eps_hat) / torch.sqrt(
        tables["alphas"].index_select(0, t))
    return mean + tables["sigma"].index_select(0, t) * noise


def sample(params: Dict[str, Any], generator: torch.Generator, n: int,
           cfg: Config = Config(), graph: Optional[bool] = None
           ) -> torch.Tensor:
    """Ancestral DDPM sampling over every timestep -> [n, H, W, C] in
    [-1, 1]. x_T and the T noise tensors are drawn from `generator` (on
    the params' device) before the loop. `graph` (default: on CUDA)
    captures one step as a CUDA graph and replays it; otherwise the same
    step runs eagerly. Params laid over a mesh are gathered whole first
    (every rank then samples alone)."""
    params = map_params(sharding.full_value, params)
    dev = generator.device
    shape = (n, cfg.image_size, cfg.image_size, cfg.channels)
    T = cfg.timesteps
    with torch.no_grad():
        x = torch.randn(shape, generator=generator, device=dev)
        noise = torch.randn((T,) + shape, generator=generator, device=dev)
        tables = schedule_tables(cfg, dev)
        i = torch.zeros(1, dtype=torch.long, device=dev)

        def step():
            t = (T - 1) - i
            x.copy_(reverse_step(params, x, t, noise.index_select(0, i)[0],
                                 cfg, tables))
            i.add_(1)

        if graph is None:
            graph = dev.type == "cuda"
        if graph and dev.type != "cuda":
            raise ValueError(f"sample(graph=True) captures a CUDA graph; "
                             f"the generator is on {dev}")
        if not graph:
            for _ in range(T):
                step()
            return torch.clamp(x, -1.0, 1.0)
        # Step 0 runs eagerly on a side stream, the warm-up a capture
        # needs; the captured step replays the other T - 1.
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(dev).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            step()
        for _ in range(T - 1):
            g.replay()
        return torch.clamp(x, -1.0, 1.0)
