"""``divergen_tpu_torch/utils/comm.py`` and ``utils/dist.py:init_distributed``.

At world size 1 (no process group) every host helper is held against the
JAX package's ``comm`` run in this process: the same values, exactly. Over
two gloo ranks on the CPU (``torch_ranks.run_ranks``, a ``FileStore``
rendezvous) the host helpers and the device reductions of a step are held
against what they must give, exactly: ``all_gather`` and ``gather`` in rank
order, ``reduce_dict`` means and sums, one shared seed, the mean of the
gradients with a leaf one rank did not reach and buckets of a few bytes, a
count's mean with and without a floor on the global count, a mask's union,
rows gathered in rank order (bool too), the differentiable gather's
gradient (the sum over the ranks of each rank's own rows), and rank 0's
tensors on every rank after ``shard_pytree``; and the classwise CenterNet
losses of two images with six and one positives, one a rank, whose mean is
the one-process loss within 1e-6 relative.
"""
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from divergen_tpu.utils import comm as jcomm
from divergen_tpu_torch.utils import comm, dist as tdist
from torch_ranks import comm_checks, run_ranks

torch.set_num_threads(1)

WORLD_ONE = {
    "get_world_size": lambda c: c.get_world_size(),
    "get_rank": lambda c: c.get_rank(),
    "is_main_process": lambda c: c.is_main_process(),
    "synchronize": lambda c: c.synchronize(),
    "all_gather": lambda c: c.all_gather({"a": [1, 2], "b": "x"}),
    "gather": lambda c: c.gather((3, 4), dst=0),
    "shared_random_seed": lambda c: (np.random.seed(7), c.shared_random_seed())[1],
    "reduce_dict": lambda c: c.reduce_dict({"loss": 1.5, "acc": 0.25}),
    "reduce_dict sum": lambda c: c.reduce_dict({"loss": 1.5}, average=False),
}


@pytest.mark.parametrize("name", list(WORLD_ONE))
def test_world_size_one_against_jax(name):
    assert not dist.is_initialized()
    assert WORLD_ONE[name](comm) == WORLD_ONE[name](jcomm)


def test_device_helpers_without_a_group():
    like = [torch.zeros(2), torch.zeros(3)]
    grads = comm.all_reduce_grads([torch.ones(2), None], None, like=like)
    assert torch.equal(grads[0], torch.ones(2)) and torch.equal(grads[1], torch.zeros(3))
    assert float(comm.global_mean_count(torch.tensor(0), None, floor=1.0)) == 1.0
    assert float(comm.global_mean_count(torch.tensor(5), None)) == 5.0
    mask = torch.tensor([True, False])
    assert comm.all_reduce_max(mask, None) is mask
    x = torch.ones(2, 3)
    assert comm.all_gather_rows(x, None) is x and comm.all_gather_differentiable(x, None) is x
    assert comm.all_reduce_sum(x, None) is x


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_ranks(comm_checks, 2, tmp_path_factory.mktemp("comm"))


def test_host_helpers_over_two_ranks(two_ranks):
    for rank, out in enumerate(two_ranks):
        assert (out["world"], out["rank"], out["main"]) == (2, rank, rank == 0)
        assert out["all_gather"] == [{"rank": 0, "text": "r"}, {"rank": 1, "text": "rr"}]
        assert out["gather"] == ([] if rank == 0 else [[0, 0], [1, 1, 1]])
        assert out["mean"] == {"a": 1.0, "b": 1.5} and out["sum"] == {"a": 2.0, "b": 3.0}
        assert list(out["mean"]) == ["a", "b"]
    # rank 0's draw, on both ranks
    np.random.seed(100)
    assert two_ranks[0]["seed"] == two_ranks[1]["seed"] == int(np.random.randint(2**31))


def test_device_reductions_over_two_ranks(two_ranks):
    for out in two_ranks:
        g = out["grads"]
        assert torch.equal(g[0], torch.full((3, 2), 1.5))
        assert torch.equal(g[1], torch.arange(5.0) / 2)  # rank 0 had no gradient: zeros
        assert g[2].dtype == torch.float64 and torch.equal(g[2], torch.full((4,), 1.5,
                                                                            dtype=torch.float64))
        assert float(out["count"]) == 0.5
        assert float(out["count_floor"]) == 0.5  # max(0 + 0, 1) / 2
        assert out["union"].tolist() == [True, True, False]
        assert out["device_sum"].tolist() == [1, 6]
        assert out["gathered"].tolist() == [[0, 10], [1, 11]]
        assert out["gathered_bool"].tolist() == [False, True, True, True]
        assert out["bank"].tolist() == [[1.0] * 3] * 2 + [[2.0] * 3] * 2
        assert torch.equal(out["module"], torch.zeros(2, 2))
        assert torch.equal(out["tree"]["a"], torch.zeros(2)) and out["tree"]["b"]["c"].tolist() == [0]
    # d/dx_r of sum_s (s + 1) * <bank, arange>: 3 * arange over rank r's rows
    idx = torch.arange(12.0).reshape(4, 3)
    for rank, out in enumerate(two_ranks):
        assert torch.equal(out["bank_grad"], 3 * idx[2 * rank:2 * rank + 2])


def test_centernet_normalizers_over_two_ranks(two_ranks):
    """Images with six and one positives on two ranks: the mean of the
    ranks' classwise CenterNet losses is the one-process loss on both."""
    from divergen_tpu_torch.modeling.centernet.centernet import (CenterNetConfig,
                                                                 centernet_losses_classwise)
    from torch_ranks import centernet_inputs

    want = centernet_losses_classwise(CenterNetConfig(), *centernet_inputs())
    got = [r["centernet"] for r in two_ranks]
    for k, w in want.items():
        assert (got[0][k] + got[1][k]) / 2 == pytest.approx(float(w), rel=1e-6), k
    # each image's own normalizer would miss it
    alone = [centernet_losses_classwise(CenterNetConfig(), *[x[i:i + 1] for x in centernet_inputs()])
             for i in range(2)]
    k = "loss_centernet_pos"
    assert abs((alone[0][k] + alone[1][k]) / 2 - float(want[k])) > 1e-3 * abs(float(want[k]))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_distributed(monkeypatch):
    for k in tdist.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        tdist.init_distributed(device="cpu")
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port())}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA device"):
        tdist.init_distributed("nccl", device="cpu")
    assert not dist.is_initialized()
    try:
        assert tdist.init_distributed(device="cpu") == torch.device("cpu")
        assert dist.get_backend() == "gloo" and comm.get_world_size() == 1
        assert tdist.layout() == tdist.Layout()
        assert comm.all_gather(5) == [5] and comm.reduce_dict({"a": 2.0}) == {"a": 2.0}
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist.init_distributed()
