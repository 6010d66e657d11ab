"""``divergen_tpu_torch/parallel/mesh.py`` against ``divergen_tpu/parallel/mesh.py``.

``create_mesh``'s arithmetic and its refusals are held against the JAX
function on the 8 virtual CPU devices of ``tests/conftest.py``: the same
shape and axis names for every (data, model) it takes, a refusal where it
refuses. A rank's rows of a batch are the rows the JAX batch sharding puts
on the device at the same place of the grid. A model axis above 1 raises
where the JAX package would shard parameters.
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
    mesh = tmesh.create_mesh(world=1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group is None
    tree = {"w": torch.ones(2)}
    assert tmesh.replicated(mesh)(tree) is tree
    assert tmesh.shard_pytree(tree, mesh) is tree  # one process: nothing to broadcast
    assert set(tmesh.param_sharding_rules(tree, mesh)) == {"w"}
    wide = tmesh.create_mesh(1, 2, world=2)
    for fn in (lambda: tmesh.param_sharding_rules(tree, wide), lambda: wide.group):
        with pytest.raises(NotImplementedError, match="ROADMAP.md §1, item 4"):
            fn()
