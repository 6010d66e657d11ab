"""The NMS fixpoint as ``torch.export`` traces it (``ops/nms.py``): a
``while_loop`` with no host read, against the eager loop that asks the host
after each step, and against the JAX ``nms_mask`` (its ``lax.while_loop``),
on the same inputs: random boxes over three tiles, a suppression chain of
300 boxes (deeper than a tile of 256, crossing its boundary), all-invalid
input; ``batched_nms_mask`` and ``nms_rotated`` take the same path. Keep
masks must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops import nms as jnms
from divergen_tpu_torch.ops import nms as tnms
from divergen_tpu_torch.ops.rotated import nms_rotated

torch.set_num_threads(1)
THRESH = 0.5


class _Nms(torch.nn.Module):
    def forward(self, boxes, scores, valid):
        return tnms.nms_mask(boxes, scores, THRESH, valid)


class _Batched(torch.nn.Module):
    def forward(self, boxes, scores, classes, valid):
        return tnms.batched_nms_mask(boxes, scores, classes, THRESH, valid)


class _Rotated(torch.nn.Module):
    def forward(self, boxes, scores, valid):
        return nms_rotated(boxes, scores, THRESH, valid)


def random_boxes(seed, n=600):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * 200
    wh = 8 + rng.rand(n, 2) * 60
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return boxes, rng.rand(n).astype(np.float32), rng.rand(n) > 0.1


def chain(n=300):
    """Box i overlaps box i + 1 at IoU 7/13 and box i + 2 at 1/4, scores
    falling along the chain: greedy NMS keeps every other box, a suppression
    chain n deep."""
    x = np.arange(n, dtype=np.float32)[:, None] * 3
    boxes = np.concatenate([x, 0 * x, x + 10, 0 * x + 10], 1)
    return boxes, np.linspace(1, 0.1, n).astype(np.float32), np.ones(n, bool)


def all_invalid(n=300):
    boxes, scores, _ = random_boxes(5, n)
    return boxes, scores, np.zeros(n, bool)


INPUTS = {"random": lambda: random_boxes(3), "chain": chain, "all_invalid": all_invalid}


def traced(module, *args):
    ep = torch.export.export(module, args)
    names = {str(n.target) for n in ep.graph.nodes}
    assert "while_loop" in names and "aten.equal.default" not in names
    return ep.module()(*args)


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_traced_nms_equals_eager_and_jax(case):
    boxes, scores, valid = INPUTS[case]()
    args = (torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid))
    syncs = tnms.nms_mask.host_syncs
    eager = tnms.nms_mask(*args[:2], THRESH, args[2])
    assert tnms.nms_mask.host_syncs > syncs  # the eager loop asks the host
    syncs = tnms.nms_mask.host_syncs
    got = traced(_Nms(), *args)
    assert tnms.nms_mask.host_syncs == syncs  # the trace asks nothing
    want = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), THRESH,
                                    jnp.asarray(valid)))
    np.testing.assert_array_equal(eager.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "chain":
        np.testing.assert_array_equal(want, np.arange(len(want)) % 2 == 0)
    if case == "all_invalid":
        assert not want.any()


def test_traced_batched_nms_equals_eager_and_jax():
    boxes, scores, valid = random_boxes(7)
    classes = np.random.RandomState(8).randint(0, 5, len(scores)).astype(np.int64)
    args = tuple(map(torch.from_numpy, (boxes, scores, classes, valid)))
    eager = tnms.batched_nms_mask(*args[:3], THRESH, args[3])
    got = traced(_Batched(), *args)
    want = jnms.batched_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                                 THRESH, jnp.asarray(valid))
    np.testing.assert_array_equal(eager.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_traced_rotated_nms_equals_eager():
    rng = np.random.RandomState(9)
    n = 300
    boxes = np.concatenate([rng.rand(n, 2) * 100, 5 + rng.rand(n, 2) * 30,
                            rng.rand(n, 1) * 180 - 90], 1).astype(np.float32)
    args = (torch.from_numpy(boxes), torch.from_numpy(rng.rand(n).astype(np.float32)),
            torch.from_numpy(rng.rand(n) > 0.1))
    eager = nms_rotated(*args[:2], THRESH, args[2])
    np.testing.assert_array_equal(traced(_Rotated(), *args).numpy(), eager.numpy())
