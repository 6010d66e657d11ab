"""The port's loss and mask functions against the JAX package's, values and
gradients, on the same numpy inputs in float32.

Values and gradients agree to 1e-5 of max |reference| (1e-6 absolute floor):
both sides do the same float32 arithmetic and differ in the order of their
sums. The two functions that draw random numbers are handed the uniform array
that the JAX key produces, after which their results must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops import losses as jl
from divergen_tpu.structures import masks as jm
from divergen_tpu_torch.ops import losses as tl
from divergen_tpu_torch.structures import masks as tm

torch.set_num_threads(1)


def t(a, grad=False):
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x.requires_grad_(grad) if grad else x


def close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-1)


def value_and_grads(jfn, tfn, arrays, reduce=True):
    """Both functions on the float arrays; returns nothing, asserts value and
    the gradient of the (summed) value for every array."""
    jsum = (lambda *a: jnp.sum(jfn(*a))) if reduce else jfn
    want, want_g = jax.value_and_grad(jsum, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [t(a, grad=True) for a in arrays]
    out = tfn(*leaves)
    got = out.sum() if reduce else out
    got.backward()
    close(got.detach().numpy(), want)
    for leaf, w in zip(leaves, want_g):
        close(leaf.grad.numpy(), w)


def test_heatmap_focal_loss():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 50).astype(np.float32) * 3
    targets = np.clip(rng.rand(2, 50).astype(np.float32) * 1.2, 0, 1)
    pos = (rng.rand(2, 50) > 0.8).astype(np.int32) * rng.randint(1, 3, (2, 50)).astype(np.int32)
    for part in (0, 1):
        for kw in (dict(), dict(ignore_high_fp=0.85), dict(alpha=-1.0, gamma=1.5)):
            value_and_grads(
                lambda x: jl.heatmap_focal_loss(x, jnp.asarray(targets), jnp.asarray(pos), **kw)[part],
                lambda x: tl.heatmap_focal_loss(x, t(targets), t(pos), **kw)[part],
                [logits], reduce=False)


@pytest.mark.parametrize("loss_type", ["giou", "iou", "linear_iou"])
def test_iou_loss(loss_type):
    rng = np.random.RandomState(1)
    pred = rng.rand(40, 4).astype(np.float32) * 5
    target = rng.rand(40, 4).astype(np.float32) * 5
    target[:5] = 0.0  # rows without a target are zeroed by the caller
    weight = (rng.rand(40) > 0.3).astype(np.float32)
    value_and_grads(
        lambda p: jl.iou_loss(p, jnp.asarray(target), jnp.asarray(weight), loss_type, "sum"),
        lambda p: tl.iou_loss(p, t(target), t(weight), loss_type, "sum"), [pred], reduce=False)
    close(tl.iou_loss(t(pred), t(target), None, loss_type, "none").numpy(),
          jl.iou_loss(jnp.asarray(pred), jnp.asarray(target), None, loss_type, "none"))
    close(tl.iou_loss(t(pred), t(target), None, loss_type, "mean").numpy(),
          jl.iou_loss(jnp.asarray(pred), jnp.asarray(target), None, loss_type, "mean"))


def test_giou_loss_xyxy_and_smooth_l1():
    rng = np.random.RandomState(2)
    xy = rng.rand(2, 30, 2).astype(np.float32) * 50
    pred = np.concatenate([xy, xy + rng.rand(2, 30, 2).astype(np.float32) * 40 + 1], -1)
    xy2 = xy + rng.randn(2, 30, 2).astype(np.float32) * 10
    target = np.concatenate([xy2, xy2 + rng.rand(2, 30, 2).astype(np.float32) * 40 + 1], -1)
    target[0, :3] = pred[0, :3] + 100  # disjoint boxes
    value_and_grads(lambda p: jl.giou_loss_xyxy(p, jnp.asarray(target)),
                    lambda p: tl.giou_loss_xyxy(p, t(target)), [pred])
    for beta in (0.0, 0.5):
        value_and_grads(lambda p: jl.smooth_l1_loss(p, jnp.asarray(target), beta),
                        lambda p: tl.smooth_l1_loss(p, t(target), beta), [pred])


def test_sigmoid_cross_entropy_and_bce():
    rng = np.random.RandomState(3)
    scores = rng.randn(24, 9).astype(np.float32) * 2
    classes = rng.randint(0, 9, 24).astype(np.int32)
    valid = rng.rand(24) > 0.25
    fed = (rng.rand(10) > 0.4).astype(np.float32)
    for mask in (None, fed):
        value_and_grads(
            lambda s: jl.sigmoid_cross_entropy_with_fed_loss(
                s, jnp.asarray(classes), jnp.asarray(valid), 9,
                None if mask is None else jnp.asarray(mask)),
            lambda s: tl.sigmoid_cross_entropy_with_fed_loss(
                s, t(classes), t(valid), 9, None if mask is None else t(mask)),
            [scores], reduce=False)
    labels = (rng.rand(24, 9) > 0.5).astype(np.float32)
    value_and_grads(lambda s: jl.optax_sigmoid_bce(s, jnp.asarray(labels)),
                    lambda s: tl.optax_sigmoid_bce(s, t(labels)), [scores * 20])


@pytest.mark.parametrize("case", ["few_appeared", "many_appeared", "sparse_weights"])
def test_get_fed_loss_classes_with_the_jax_draw(case):
    rng = np.random.RandomState(4)
    c, k = 40, 12
    n_gt = {"few_appeared": 5, "many_appeared": 30, "sparse_weights": 5}[case]
    classes = rng.randint(0, c, n_gt).astype(np.int32)
    valid = rng.rand(n_gt) > 0.2
    weight = (rng.rand(c) * 10 + 0.1).astype(np.float32)
    if case == "sparse_weights":
        weight[rng.rand(c) > 0.1] = 0.0  # fewer sampleable classes than the deficit
    key = jax.random.PRNGKey(7)
    want = jl.get_fed_loss_classes(key, jnp.asarray(classes), jnp.asarray(valid), c, k,
                                   jnp.asarray(weight))
    draw = np.asarray(jax.random.uniform(key, (c + 1,)))
    got = tl.get_fed_loss_classes({"fed": draw}, t(classes).long(), t(valid), c, k, t(weight))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32 and got[classes[valid]].all()
    if case == "few_appeared":
        assert got.sum() == k


@pytest.mark.parametrize("with_weight", [False, True], ids=["uniform", "weighted"])
def test_sample_dynamic_classifier_inds_with_the_jax_draw(with_weight):
    rng = np.random.RandomState(5)
    c, k = 30, 8
    classes = rng.randint(0, c, 6).astype(np.int32)
    valid = np.array([True, True, False, True, True, True])
    weight = (rng.rand(c) * 5).astype(np.float32) if with_weight else None
    if with_weight:
        weight[:4] = 0.0
    key = jax.random.PRNGKey(11)
    want_inds, want_map = jl.sample_dynamic_classifier_inds(
        key, jnp.asarray(classes), jnp.asarray(valid), c, k,
        None if weight is None else jnp.asarray(weight))
    draw = np.asarray(jax.random.uniform(key, (c,)))
    got_inds, got_map = tl.sample_dynamic_classifier_inds(
        {"dyn": draw}, t(classes).long(), t(valid), c, k, None if weight is None else t(weight))
    np.testing.assert_array_equal(got_inds.numpy(), np.asarray(want_inds))
    np.testing.assert_array_equal(got_map.numpy(), np.asarray(want_map))
    assert got_map[c] == k and set(classes[valid]) <= set(got_inds.tolist())


def test_uniform_draw_from_a_generator_and_from_a_mapping():
    gen = torch.Generator().manual_seed(0)
    a = tl.uniform_draw(gen, "x", (3, 5), "cpu")
    b = tl.uniform_draw(torch.Generator().manual_seed(0), "y", (3, 5), "cpu")
    assert torch.equal(a, b) and a.dtype == torch.float32 and 0 <= a.min() and a.max() < 1
    given = np.arange(6, dtype=np.float32).reshape(2, 3) / 6
    np.testing.assert_array_equal(tl.uniform_draw({"x": given}, "x", (2, 3), "cpu").numpy(), given)
    with pytest.raises(ValueError, match="shape"):
        tl.uniform_draw({"x": given}, "x", (3, 2), "cpu")
    with pytest.raises(KeyError):
        tl.uniform_draw({"x": given}, "match", (2, 3), "cpu")


# -- structures/masks.py --------------------------------------------------------

def test_masks_to_boxes_and_areas():
    rng = np.random.RandomState(6)
    masks = (rng.rand(5, 12, 17) > 0.7).astype(np.float32)
    masks[2] = 0.0  # an empty mask
    masks[3] = 0.0
    masks[3, 4:9, 2:3] = 1.0
    np.testing.assert_array_equal(tm.masks_to_boxes(t(masks)).numpy(),
                                  np.asarray(jm.masks_to_boxes(jnp.asarray(masks))))
    np.testing.assert_array_equal(tm.mask_areas(t(masks)).numpy(),
                                  np.asarray(jm.mask_areas(jnp.asarray(masks))))
    assert tm.masks_to_boxes(t(masks))[2].tolist() == [0, 0, 0, 0]


def test_crop_and_resize():
    rng = np.random.RandomState(7)
    masks = (rng.rand(4, 20, 24) > 0.5).astype(np.float32)
    xy = rng.rand(4, 2).astype(np.float32) * 10 - 2  # some boxes start outside
    boxes = np.concatenate([xy, xy + rng.rand(4, 2).astype(np.float32) * 14 + 2], -1)
    want = jm.crop_and_resize(jnp.asarray(masks), jnp.asarray(boxes), 7)
    close(tm.crop_and_resize(t(masks), t(boxes), 7).numpy(), want)


def test_mask_target_in_box_and_bilinear_sampling():
    rng = np.random.RandomState(8)
    crops = rng.rand(2, 6, 28, 28).astype(np.float32)
    xy = rng.rand(2, 6, 2).astype(np.float32) * 60
    src = np.concatenate([xy, xy + rng.rand(2, 6, 2).astype(np.float32) * 40 + 4], -1)
    dst = src + rng.randn(2, 6, 4).astype(np.float32) * 6
    src[0, 0, 2:] = src[0, 0, :2]  # a degenerate source box
    one = lambda m, s, d: jm.mask_target_in_box(m, s, d, 14)
    want = jax.vmap(jax.vmap(one))(jnp.asarray(crops), jnp.asarray(src), jnp.asarray(dst))
    got = tm.mask_target_in_box(t(crops), t(src), t(dst), 14)
    assert got.shape == (2, 6, 14, 14)
    close(got.numpy(), want)
    # one pair, as the JAX function takes it
    close(tm.mask_target_in_box(t(crops[1, 2]), t(src[1, 2]), t(dst[1, 2]), 14).numpy(),
          one(jnp.asarray(crops[1, 2]), jnp.asarray(src[1, 2]), jnp.asarray(dst[1, 2])))
    ys = np.array([-1.5, -0.25, 0.0, 3.4, 26.9, 27.0, 27.5, 30.0], np.float32)
    xs = np.array([-0.5, 5.25, 27.2], np.float32)
    close(tm._bilinear_sample_2d(t(crops[0, 0]), t(ys), t(xs)).numpy(),
          jm._bilinear_sample_2d(jnp.asarray(crops[0, 0]), jnp.asarray(ys), jnp.asarray(xs)))
