"""The port's padded containers (``structures/image_list.py``,
``structures/instances.py``) against the JAX package's, on the same arrays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.structures import image_list as jil
from divergen_tpu.structures import instances as jins
from divergen_tpu_torch.structures import ImageList, Instances, empty_instances


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("hw,div", [((30, 33), 32), ((8, 8), 0), ((17, 5), 4)])
def test_image_list(hw, div):
    rng = np.random.RandomState(0)
    x = rng.rand(2, *hw, 3).astype(np.float32)
    sizes = np.array([list(hw), [hw[0] // 2 + 1, hw[1] - 1]], np.int64)
    want = jil.ImageList.from_tensors(jnp.asarray(x), jnp.asarray(sizes), div)
    got = ImageList.from_tensors(t(x), t(sizes), div)
    assert got.padded_size == want.padded_size and len(got) == len(want) == 2
    np.testing.assert_array_equal(got.tensor.numpy(), np.asarray(want.tensor))
    np.testing.assert_array_equal(got.padding_mask().numpy(), np.asarray(want.padding_mask()))


def test_instances_fields_and_filters():
    want = jins.empty_instances((64, 48), 6, with_masks=True, mask_size=(8, 8))
    got = empty_instances((64, 48), 6, with_masks=True, mask_size=(8, 8))
    assert sorted(got.get_fields()) == sorted(want.get_fields())
    for k, v in want.get_fields().items():
        assert tuple(got.get(k).shape) == v.shape and str(got.get(k).dtype).endswith(str(v.dtype))
    valid = np.array([True, True, False, True, False, True])
    got, want = got.set("valid", t(valid)), want.set("valid", jnp.asarray(valid))
    got.scores = torch.arange(6.0)  # attribute assignment changes this one
    want.scores = jnp.arange(6.0)
    assert got.has("scores") and not got.has("keypoints") and len(got) == 6
    assert int(got.num_valid()) == int(want.num_valid()) == 4
    keep = np.array([True, False, True, True, True, False])
    np.testing.assert_array_equal(got.masked(t(keep)).valid.numpy(),
                                  np.asarray(want.masked(jnp.asarray(keep)).valid))
    idx = np.array([5, 0, 3])
    np.testing.assert_array_equal(got.gather(t(idx)).scores.numpy(),
                                  np.asarray(want.gather(jnp.asarray(idx)).scores))
    with pytest.raises(AttributeError, match="no field"):
        got.keypoints
    assert repr(got).startswith("Instances(image_size=(64, 48)")


@pytest.mark.parametrize("capacity", [12, 9, 4])
def test_instances_cat_and_pad(capacity):
    a, b = empty_instances((32, 32), 3), empty_instances((32, 32), 5)
    a = a.set("scores", torch.arange(3.0)).set("valid", torch.ones(3, dtype=torch.bool))
    ja, jb = jins.empty_instances((32, 32), 3), jins.empty_instances((32, 32), 5)
    ja = ja.set("scores", jnp.arange(3.0)).set("valid", jnp.ones(3, bool))
    got, want = Instances.cat([a, b]).pad_to(capacity), jins.Instances.cat([ja, jb]).pad_to(capacity)
    assert len(got) == len(want) == capacity
    for k, v in want.get_fields().items():
        np.testing.assert_array_equal(got.get(k).numpy(), np.asarray(v))
    with pytest.raises(AssertionError, match="field mismatch"):
        Instances.cat([a, a.set("masks", torch.zeros(3, 2, 2))])
