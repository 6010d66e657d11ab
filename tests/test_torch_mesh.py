"""``divergen_tpu_torch/parallel/mesh.py`` against ``divergen_tpu/parallel/mesh.py``.

``create_mesh``'s arithmetic and its refusals are held against the JAX
function on the 8 virtual CPU devices of ``tests/conftest.py``: the same
shape and axis names for every (data, model) it takes, a refusal where it
refuses. A rank's rows of a batch are the rows the JAX batch sharding puts
on the device at the same place of the grid. ``param_sharding_rules`` shards
the leaves JAX's rule shards: on JAX-layout arrays, and on the detector of
the JAX dryrun (ResNet-18 + FPN, ``min_size`` 2**12 as there), whose flax
tree is traced with ``jax.eval_shape`` and whose port module is built on the
meta device, the leaves named as ``params_from_jax`` names them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.parallel import mesh as jmesh
from divergen_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

SHAPES = [(-1, 1), (-1, 2), (-1, 4), (-1, 8), (8, 1), (4, 2), (2, 4), (1, 8)]
REFUSED = [(3, 1), (-1, 3), (2, 2), (16, 1), (-1, 16)]


@pytest.mark.parametrize("data,model", SHAPES)
def test_create_mesh_against_jax(data, model):
    want = jmesh.create_mesh(data, model, devices=jax.devices("cpu")[:8])
    got = tmesh.create_mesh(data, model, world=8)
    assert got.axis_names == tuple(want.axis_names) == ("data", "model")
    assert got.shape == dict(want.shape)
    assert got.ranks.tolist() == [[d.id for d in row] for row in want.devices]


@pytest.mark.parametrize("data,model", REFUSED)
def test_create_mesh_refuses_as_jax(data, model):
    with pytest.raises(AssertionError):
        jmesh.create_mesh(data, model, devices=jax.devices("cpu")[:8])
    with pytest.raises(ValueError, match="ranks|not divisible"):
        tmesh.create_mesh(data, model, world=8)


def test_batch_rows_against_jax_sharding():
    devices = jax.devices("cpu")[:8]
    want_mesh = jmesh.create_mesh(-1, 1, devices=devices)
    x = np.arange(16 * 3).reshape(16, 3)
    placed = jax.device_put(jnp.asarray(x), jmesh.batch_sharding(want_mesh))
    by_device = {s.device.id: np.asarray(s.data) for s in placed.addressable_shards}
    mesh = tmesh.create_mesh(-1, 1, world=8)
    for rank in range(8):
        rows = tmesh.batch_slice(mesh, rank, 16)
        np.testing.assert_array_equal(x[rows], by_device[devices[rank].id])
        got = tmesh.batch_sharding(mesh, rank)({"a": torch.from_numpy(x), "b": {"c": x}})
        np.testing.assert_array_equal(got["a"].numpy(), x[rows])
        np.testing.assert_array_equal(got["b"]["c"], x[rows])
    with pytest.raises(ValueError, match="does not split"):
        tmesh.batch_slice(mesh, 0, 12)


def test_replicated_and_the_model_axis():
    """At model 1 every leaf is replicated; at model 2 the rule shards the
    leaves JAX's shards (on the same JAX-layout arrays), and a grid without a
    process group has no groups."""
    mesh = tmesh.create_mesh(world=1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group is None
    tree = {"w": torch.ones(2)}
    assert tmesh.replicated(mesh)(tree) is tree
    assert tmesh.shard_pytree(tree, mesh) is tree  # one process: nothing to broadcast
    assert tmesh.param_sharding_rules(tree, mesh) == {"w": None}
    wide = tmesh.create_mesh(1, 2, world=2)
    assert wide.group is None and wide.model_group is None and wide.index(1) == (0, 1)
    shapes = {"vec": (8192,), "odd_last": (4096, 3), "small": (32, 64), "big": (64, 64),
              "conv": (3, 3, 64, 32), "wide_last": (3, 4096)}
    leaves = {k: np.zeros(v, np.float32) for k, v in shapes.items()}
    jmesh_wide = jmesh.create_mesh(1, 2, devices=jax.devices("cpu")[:2])
    want = jmesh.param_sharding_rules(leaves, jmesh_wide, min_size=2**12)
    got = tmesh.param_sharding_rules({k: torch.from_numpy(v) for k, v in leaves.items()}, wide,
                                     min_size=2**12)
    assert {k for k, s in want.items() if "model" in s.spec} == {k for k, d in got.items()
                                                                 if d is not None}
    assert {k: d for k, d in got.items() if d is not None} == {"big": 1, "conv": 3,
                                                               "wide_last": 1}


def test_param_sharding_rules_on_the_dryrun_detector():
    """The port's rule shards the same leaves of the JAX dryrun's detector as
    JAX's rule at ``min_size=2**12`` and model 2, each on the torch dim that
    holds the JAX leaf's last axis (dim 0 of a Dense or Conv weight)."""
    import importlib

    from divergen_tpu.modeling.meta_arch import rcnn as jrcnn
    from divergen_tpu_torch import graft_entry as tge
    from divergen_tpu_torch.modeling.meta_arch import rcnn as trcnn

    jentry = importlib.import_module("__graft_entry__")
    images = jnp.zeros((1, 64, 64, 3))
    sizes = jnp.array([[64, 64]])
    shapes = jax.eval_shape(lambda k: jrcnn.build_model(jentry._small_cfg()).init(
        k, images, sizes, training=False), jax.random.PRNGKey(0))["params"]
    want_sh = jmesh.param_sharding_rules(shapes, jmesh.create_mesh(
        1, 2, devices=jax.devices("cpu")[:2]), min_size=2**12)
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
    want = {}
    for path, s in jax.tree_util.tree_leaves_with_path(want_sh):
        names = [str(p.key) for p in path]
        want[".".join(names[:-1] + [leaf.get(names[-1], names[-1])])] = "model" in s.spec
    model = trcnn.build_model(tge._small_cfg(), input_size=(64, 64), device="meta")
    got = tmesh.param_sharding_rules(model, tmesh.create_mesh(1, 2, world=2), min_size=2**12)
    assert set(got) == set(want)
    assert {k for k, d in got.items() if d is not None} == {k for k, v in want.items() if v}
    named = dict(model.named_parameters())
    sharded = {k: d for k, d in got.items() if d is not None}
    assert len(sharded) > 20
    for k, d in sharded.items():
        owner = model.get_submodule(k.rpartition(".")[0])
        kernel = k.endswith("weight") and named[k].dim() >= 2
        assert d == ((1 if isinstance(owner, torch.nn.ConvTranspose2d) else 0) if kernel
                     else named[k].dim() - 1), k
