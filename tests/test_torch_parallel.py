"""The port's mesh config and logical sharding rules against the JAX
package's, case by case, and the PartitionSpec -> DTensor placements map.
"""

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from determined_tpu.models import gpt2 as jgpt2
from determined_tpu.parallel import mesh as jmesh
from determined_tpu.parallel import sharding as jsharding
from determined_tpu_torch.models import gpt2 as tgpt2
from determined_tpu_torch.parallel import mesh as tmesh
from determined_tpu_torch.parallel import sharding as tsharding

MESH_CASES = [
    ({}, 1), ({}, 8), ({"data": 2}, 2), ({"data": 2, "fsdp": 2}, 4),
    ({"data": -1, "fsdp": 2}, 8), ({"fsdp": -1, "data": 1}, 4),
    ({"data": 2, "fsdp": 2, "tensor": 2}, 8), ({"tensor": -1}, 4),
    ({"data": 2}, 3), ({"data": -1, "fsdp": 3}, 8),
    ({"data": -1, "fsdp": -1}, 4), ({"data": 4}, 2),
    ({"pipeline": 2, "expert": 2, "context": 1}, 4), ({"bogus": 2}, 2),
]

RULES = [None, {"vocab": None}, {"embed": ("fsdp", "tensor")},
         {"batch": "data", "heads": ("tensor", "fsdp")}]
LOGICAL = [("batch", "seq", "embed"), ("vocab", "embed"), (None, "embed"),
           ("layers", "embed", "heads"), ("layers", "heads", "embed"),
           ("layers", "mlp", "embed"), ("embed", "embed"),
           ("batch", "seq", "heads", "kv"), ("expert", "embed", "mlp"),
           ("unmodeled",), ("missing",), ()]


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, KeyError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize(
    "kind,case",
    [("mesh", c) for c in MESH_CASES]
    + [("spec", (r, axes)) for r in RULES for axes in LOGICAL],
    ids=lambda c: str(c))
def test_mesh_config_and_logical_rules_match_jax(kind, case):
    if kind == "mesh":
        d, n = case

        def run(mod):
            def go():
                cfg = mod.MeshConfig.from_dict(d).resolve(n)
                return cfg.sizes(), cfg.resolvable(n), \
                    mod.mesh_shape_for_devices(n, mod.MeshConfig.from_dict(d))
            return _outcome(go)

        assert run(tmesh) == run(jmesh)
        assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
        return
    rules, axes = case

    def run(mod):
        r = mod.LogicalRules()
        if rules:
            r = r.override(**rules)
        return _outcome(lambda: tuple(r.spec(axes)))

    assert run(tsharding) == run(jsharding)
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES


def test_gpt2_param_specs_match_jax():
    cfg_t, cfg_j = tgpt2.Config.tiny(), jgpt2.Config.tiny()
    t_axes, j_axes = tgpt2.param_logical_axes(cfg_t), \
        jgpt2.param_logical_axes(cfg_j)
    assert t_axes == j_axes
    rules_t, rules_j = tsharding.LogicalRules(), jsharding.LogicalRules()
    for k, axes in tgpt2._flatten(t_axes).items():
        assert tuple(rules_t.spec(axes)) == tuple(rules_j.spec(axes)), k


def test_spec_to_placements():
    names = tmesh.AXIS_ORDER
    to = tsharding.spec_to_placements
    P = tsharding.PartitionSpec
    R = Replicate()
    assert to(P(), names) == [R] * 6
    assert to(P(None, "fsdp"), names) == [R, R, Shard(1), R, R, R]
    assert to(P(("data", "fsdp")), names) == [Shard(0), R, Shard(0), R, R, R]
    assert to(P("tensor", "fsdp", None), names) == \
        [R, R, Shard(1), R, R, Shard(0)]
    assert to(P("pipeline", "fsdp", "tensor"), names) == \
        [R, Shard(0), Shard(1), R, R, Shard(2)]
    with pytest.raises(ValueError, match="order"):
        to(P(("fsdp", "data")), names)
    with pytest.raises(ValueError, match="twice"):
        to(P("fsdp", "fsdp"), names)
    with pytest.raises(ValueError, match="not in"):
        to(P("model"), names)
    # Every GPT-2 leaf under the default rules: its embed dim over fsdp.
    rules = tsharding.LogicalRules()
    for k, axes in tgpt2._flatten(tgpt2.param_logical_axes(
            tgpt2.Config.tiny())).items():
        pl = to(rules.spec(axes), names)
        embed = [i for i, a in enumerate(axes) if a == "embed"]
        assert pl[names.index("fsdp")] == (Shard(embed[0]) if embed else R), k
        assert pl[names.index("data")] == R, k


def test_single_device_mesh_and_distribute_full():
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        mesh = tmesh.single_device_mesh("cpu")
        assert mesh.mesh_dim_names == tmesh.AXIS_ORDER
        assert tuple(mesh.mesh.shape) == (1,) * 6
        full = torch.arange(12.0).reshape(3, 4)
        d = tsharding.distribute_full(
            full, mesh, tsharding.mesh_placements(
                tsharding.PartitionSpec(None, "fsdp"), mesh))
        np.testing.assert_array_equal(d.full_tensor().numpy(), full.numpy())
        assert tsharding.shard_mesh_dims(d) == ()
    finally:
        dist.destroy_process_group()


def test_param_specs_and_step_input_shardings():
    from determined_tpu.train import state as jstate
    from determined_tpu_torch.train import state as tstate
    from determined_tpu_torch.train import step as tstep

    axes = tgpt2.param_logical_axes(tgpt2.Config.tiny())
    ours = tgpt2._flatten(tstate.param_specs(axes))
    theirs = jstate.param_specs(jgpt2.param_logical_axes(jgpt2.Config.tiny()))
    theirs = {"/".join(str(getattr(k, "key", k)) for k in path): spec
              for path, spec in jax.tree_util.tree_flatten_with_path(
                  theirs, is_leaf=lambda x: isinstance(
                      x, jsharding.PartitionSpec))[0]}
    assert {k: tuple(v) for k, v in ours.items()} == \
        {k: tuple(v) for k, v in theirs.items()}
    assert tuple(tsharding.logical_to_mesh_spec(("batch", "embed"))) == \
        tuple(jsharding.logical_to_mesh_spec(("batch", "embed")))

    class Mesh:  # what the placements read of a DeviceMesh
        mesh_dim_names = tmesh.AXIS_ORDER
        ndim = len(tmesh.AXIS_ORDER)

    R = Replicate()
    rows = [Shard(0), R, Shard(0), R, R, R]  # ("data", "fsdp") on the rows
    assert tstep.step_input_shardings(Mesh()) == rows
    assert tstep.step_input_shardings(Mesh(), leading_dims=2) == \
        [Shard(1), R, Shard(1), R, R, R]
    batch = {"tokens": np.zeros((4, 9)), "lr": np.zeros(())}
    assert tstep.step_input_shardings(Mesh(), batch=batch) == \
        {"tokens": rows, "lr": [R] * 6}
