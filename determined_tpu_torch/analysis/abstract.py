"""Engine 1 — abstract trace, on the meta device.

Counterpart of determined_tpu/analysis/abstract.py: the same inputs, the
same outputs (diagnostics, the `hbm` breakdown under the same keys, notes)
and the same rules, DTL002-DTL005. Where the JAX package runs
`jax.eval_shape` and `jax.make_jaxpr`, this runs the trial's own functions
on the `meta` device: shapes and dtypes only, no values, no device memory,
no kernel launch.

  - State: `trial.init_params`, `trial.optimizer().init` and, for a
    stateful trial, `init_extra`, under `_MetaDevice`, which sends every
    tensor a factory makes or `.to()` moves to `meta` (the port's inits
    draw from a CPU `torch.Generator` with `device=generator.device`;
    meta takes the generator and draws nothing). A tensor the init builds
    another way (`torch.from_numpy`) is moved to meta after it.
  - Per-device split: each param leaf's bytes divided by the product of
    the mesh axes its spec shards over (`_spec_factor`), the spec from
    the trial's logical axes and rules (`train.state.aligned_param_specs`,
    `parallel.sharding.PartitionSpec`). Optimizer tensors that mirror a
    leaf (`train.state._mirrors`: Adam's mu and nu, the momentum trace)
    take that leaf's factor; the counts are host ints and hold no device
    memory. Gradients shard like params.
  - Activations, the JAX definition in torch terms: the forward loss runs
    once on the global batch, one process and no process group, under
    `_OutputBytes`, which sums the output bytes of every aten op. Views
    and in-place ops allocate nothing and do not count, as a jaxpr has
    none. The sum is divided by the product of the batch axes. Flash
    attention takes the kernel route a CUDA device would
    (ops/flash_attention.py's meta route), so the [S, S] scores of the
    plain version are not counted where the card never makes them.
  - The port updates its state in place (train/state.py
    `apply_gradients`), so DTL001 is never raised and
    `donation_extra_bytes` is 0.

A loss that reads a device value on the host (`.item()`), or whose shapes
depend on the data, cannot run on meta: that is DTL005, unless an AST
finding already explains it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._device as _torch_device
import torch.utils._pytree as pytree
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from determined_tpu_torch.analysis.diagnostics import Diagnostic
from determined_tpu_torch.analysis.rules import RULES
from determined_tpu_torch.models.gpt2 import _flatten
from determined_tpu_torch.parallel.mesh import AXIS_ORDER
from determined_tpu_torch.parallel.sharding import PartitionSpec
from determined_tpu_torch.train.state import _mirrors, aligned_param_specs, \
    param_leaves

# Leaves at or above this size with no sharded dimension trigger DTL002.
LARGE_LEAF_BYTES = 16 * 1024 * 1024

_META = torch.device("meta")
_MOVES = {torch.Tensor.to, torch.Tensor.cuda, torch.Tensor.cpu,
          torch.Tensor.pin_memory}


class _MetaDevice(TorchFunctionMode):
    """Every tensor made or moved inside lands on `meta`: the factories
    (`torch.randn`, `torch.zeros`, ...) whatever `device` they name, any
    call's `device=` keyword, and `.to()` / `.cuda()` / `.cpu()`, which
    keep only their dtype. A generator passed along is taken and unused."""

    def __init__(self):
        super().__init__()
        self._factories = _torch_device._device_constructors()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _MOVES:
            t = args[0]
            dtype = None
            if func is torch.Tensor.to:
                _, dtype, _, _ = torch._C._nn._parse_to(*args[1:], **kwargs)
            t = t if t.is_meta else t.detach().to(_META)
            return t if dtype is None else t.to(dtype)
        if func in self._factories or "device" in kwargs:
            kwargs["device"] = _META
        return func(*args, **kwargs)


def _returns_alias(func) -> bool:
    """True for an op whose outputs alias an input (a view, an in-place or
    an `out=` op): it allocates nothing."""
    schema = getattr(func, "_schema", None)
    return schema is not None and any(
        r.alias_info is not None for r in schema.returns)


class _OutputBytes(TorchDispatchMode):
    """Sums the bytes of every aten op's fresh outputs (`total`) and keeps
    each one's (op, shape) in `outputs`."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.outputs: List[Tuple[str, Tuple[int, ...]]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _returns_alias(func):
            for t in pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.total += t.numel() * t.element_size()
                    self.outputs.append((str(func), tuple(t.shape)))
        return out


def _to_meta(tree: Any) -> Any:
    """Each tensor of `tree` on `meta` (shape, dtype and requires_grad
    kept)."""
    def one(v):
        if isinstance(v, torch.Tensor) and not v.is_meta:
            return v.detach().to(_META).requires_grad_(v.requires_grad)
        return v

    return pytree.tree_map(one, tree)


def _leaf_shape_dtype(v: Any) -> Optional[Tuple[Tuple[int, ...], Any]]:
    """(shape, dtype) of a batch leaf: a tensor's, or numpy's reading of
    anything else. None for what holds no array (a string)."""
    if isinstance(v, torch.Tensor):
        return tuple(v.shape), v.dtype
    arr = np.asarray(v)
    if arr.dtype.kind not in "biufc":
        return None
    return arr.shape, arr.dtype


def _nbytes(shape, dtype) -> int:
    itemsize = dtype.itemsize if isinstance(dtype, torch.dtype) \
        else np.dtype(dtype).itemsize
    return int(math.prod(shape)) * itemsize


def _meta_batch(batch: Any) -> Any:
    """The batch as meta tensors of its leaves' shapes and dtypes."""
    def one(v):
        sd = _leaf_shape_dtype(v)
        if sd is None:
            return v
        shape, dtype = sd
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.zeros((), dtype)).dtype
        return torch.empty(shape, dtype=dtype, device=_META)

    return pytree.tree_map(one, batch)


def _spec_factor(spec: Optional[PartitionSpec], sizes: Dict[str, int]) -> int:
    """How many ways a leaf with this PartitionSpec is split."""
    if spec is None:
        return 1
    factor = 1
    for entry in spec:
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            factor *= sizes.get(a, 1)
    return factor


def _path_str(path) -> str:
    parts = []
    for p in path:
        key = getattr(p, "key", None)
        if key is None:
            key = getattr(p, "idx", None)
        if key is None:
            key = getattr(p, "name", str(p))
        parts.append(str(key))
    return "/".join(parts) or "<root>"


def _named_leaves(params: Any) -> List[Tuple[str, torch.Tensor]]:
    """(`/`-joined key path, leaf) in `param_leaves` order."""
    if isinstance(params, dict):
        return list(_flatten(params).items())
    return [(str(i), p) for i, p in enumerate(param_leaves(params))]


def abstract_state(trial: Any) -> Tuple[Any, Any, Any]:
    """(params, opt_state, extra) of `trial` on the meta device: what
    `create_train_state` builds on the card, without a value."""
    with _MetaDevice():
        params = _to_meta(trial.init_params(torch.Generator().manual_seed(0)))
        leaves = param_leaves(params)
        for p in leaves:
            if p.is_floating_point():
                p.requires_grad_(True)
        opt_state = _to_meta(trial.optimizer().init(leaves))
        extra = _to_meta(trial.init_extra()) \
            if getattr(trial, "stateful", False) else None
    return params, opt_state, extra


def forward_output_bytes(trial: Any, params: Any, extra: Any, batch: Any
                         ) -> _OutputBytes:
    """Run the trial's loss once on meta tensors (`batch` as meta tensors
    of its shapes) and count what every op allocates."""
    rng = torch.Generator().manual_seed(0)
    mbatch = _meta_batch(batch)
    with _MetaDevice(), _OutputBytes() as counter:
        if getattr(trial, "stateful", False):
            trial.loss(params, extra, mbatch, rng)
        else:
            trial.loss(params, mbatch, rng)
    return counter


def analyze_trial(
    trial: Any,
    n_devices: int,
    batch: Any = None,
    hbm_budget_bytes: Optional[int] = None,
    large_leaf_bytes: int = LARGE_LEAF_BYTES,
    source_file: Optional[str] = None,
    trace_failure_excused: bool = False,
) -> Tuple[List[Diagnostic], Dict[str, Any], List[str]]:
    """Analyze a TorchTrial instance against its declared mesh.

    `batch`: one global batch (numpy arrays or tensors, any device); drawn
    from `trial.build_training_data()` when omitted — a trial whose
    context has no process group is one process, and its loader yields
    the global batch, as a JAX host's does. `trace_failure_excused`
    silences DTL005 when an AST finding (e.g. DTL101) already explains
    why the loss cannot trace.

    Returns (diagnostics, hbm breakdown, notes).
    """
    diags: List[Diagnostic] = []
    notes: List[str] = []
    hbm: Dict[str, Any] = {}

    mesh_cfg = trial.mesh_config().resolve(n_devices)
    sizes = dict(zip(AXIS_ORDER, mesh_cfg.sizes()))
    rules = trial.sharding_rules()

    # -- abstract state: params + optimizer state -----------------------
    try:
        params, opt_state, extra = abstract_state(trial)
    except Exception as e:  # init itself must trace for any memory analysis
        diags.append(RULES["DTL005"].diag(
            f"state initialization failed to trace on the meta device: "
            f"{type(e).__name__}: {e}", file=source_file))
        return diags, hbm, notes

    named = _named_leaves(params)
    axes = trial.param_logical_axes()
    if axes is not None and isinstance(params, dict):
        flat_specs = list(_flatten(aligned_param_specs(
            params, axes, rules)).values())
    else:
        flat_specs = [PartitionSpec()] * len(named)

    params_bytes = 0
    params_pd = 0  # per device
    factors: List[int] = []
    for (path, leaf), spec in zip(named, flat_specs):
        b = _nbytes(leaf.shape, leaf.dtype)
        factor = _spec_factor(spec, sizes)
        factors.append(factor)
        params_bytes += b
        params_pd += b // factor
        if n_devices > 1 and factor == 1 and b >= large_leaf_bytes:
            diags.append(RULES["DTL002"].diag(
                f"parameter '{path}' "
                f"({'x'.join(map(str, leaf.shape))} "
                f"{str(leaf.dtype).replace('torch.', '')}, "
                f"{b / 2**20:.1f} MiB) has no sharded dimension and is "
                f"replicated on all {n_devices} devices; annotate its "
                "param_logical_axes() (e.g. 'embed'/'vocab') to shard it",
                file=source_file))

    opt_bytes = 0
    opt_pd = 0
    for t, i in _mirrors(opt_state, [p for _, p in named]):
        b = _nbytes(t.shape, t.dtype)
        opt_bytes += b
        opt_pd += b // (factors[i] if i is not None else 1)

    # Gradients are transient but alive together with params + opt state at
    # the update; they shard like params.
    grads_pd = params_pd

    # -- batch ----------------------------------------------------------
    batch_pd = 0
    batch_axes = rules.mesh_axes("batch")
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    batch_axes = tuple(batch_axes or ())
    bprod = math.prod(sizes.get(a, 1) for a in batch_axes)
    if batch is None:
        try:
            batch = next(iter(trial.build_training_data()))
        except Exception as e:
            notes.append(f"could not draw a batch from "
                         f"build_training_data(): {type(e).__name__}: {e}")
            batch = None
    if batch is not None:
        bad: List[str] = []
        batch_bytes = 0
        for path, leaf in pytree.tree_flatten_with_path(batch)[0]:
            sd = _leaf_shape_dtype(leaf)
            if sd is None:
                continue
            shape, dtype = sd
            batch_bytes += _nbytes(shape, dtype)
            if shape and shape[0] % bprod != 0:
                bad.append(f"'{_path_str(path)}' [{shape[0]}, ...]")
        batch_pd = batch_bytes // max(1, bprod)
        hbm["batch_bytes"] = batch_pd
        if bad:
            diags.append(RULES["DTL003"].diag(
                f"global batch dims {', '.join(bad)} are not divisible by "
                f"the mesh batch axes {batch_axes} = {bprod} "
                f"(mesh {dict((a, s) for a, s in sizes.items() if s > 1)}); "
                "pad the loader batch or fix global_batch_size",
                file=source_file))

    # -- forward activations (upper bound: every op's output) -----------
    if batch is not None:
        try:
            counter = forward_output_bytes(trial, params, extra, batch)
            hbm["activations_upper_bound_bytes"] = \
                counter.total // max(1, bprod)
        except Exception as e:
            if not trace_failure_excused:
                diags.append(RULES["DTL005"].diag(
                    f"loss failed to trace on the meta device "
                    f"({type(e).__name__}: {e}); activation footprint "
                    "unknown — fix the trace error (often a host read of a "
                    "device value, or a shape that depends on the data)",
                    file=source_file))
            else:
                notes.append(
                    "activation estimate unavailable: loss does not trace "
                    "(already reported by an AST rule)")

    hbm.update({
        "params_bytes": params_pd,
        "opt_state_bytes": opt_pd,
        "grads_bytes": grads_pd,
        "donation_extra_bytes": 0,
        "params_total_bytes": params_bytes,
        "opt_state_total_bytes": opt_bytes,
        "mesh": {a: s for a, s in sizes.items()},
        "n_devices": n_devices,
        "donated": True,
    })
    total_pd = params_pd + opt_pd + grads_pd + batch_pd
    hbm["total_bytes"] = total_pd

    if hbm_budget_bytes:
        hbm["budget_bytes"] = int(hbm_budget_bytes)
        if total_pd > hbm_budget_bytes:
            diags.append(RULES["DTL004"].diag(
                f"estimated per-device memory lower bound "
                f"{total_pd / 2**30:.2f} GiB exceeds the configured budget "
                f"{hbm_budget_bytes / 2**30:.2f} GiB "
                f"(params {params_pd / 2**30:.2f} + opt {opt_pd / 2**30:.2f} "
                f"+ grads {grads_pd / 2**30:.2f} "
                f"+ batch {batch_pd / 2**30:.2f}); shard more axes or use "
                "more devices",
                file=source_file))

    return diags, hbm, notes
