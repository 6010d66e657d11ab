"""Work the CPU tests hand to gloo ranks (``run_ranks``).

The ranks are ``torch.multiprocessing`` processes that meet through a
``FileStore`` under the test's temporary directory (no fixed port: the
xdist workers run side by side). This module imports torch and the port
only, so a rank starts in seconds; each function takes ``(rank, world,
...)`` and returns what the test compares, which ``run_ranks`` hands back
by rank.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from divergen_tpu_torch.ops.losses import RankDraws


def _rank_main(rank, world, store, out, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        torch.save(fn(rank, world, *args), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, tmp, *args):
    """``fn(rank, world, *args)`` in ``world`` gloo processes on the CPU;
    their results, by rank."""
    import torch.multiprocessing as mp

    store, out = os.path.join(str(tmp), "store"), os.path.join(str(tmp), "result")
    mp.spawn(_rank_main, args=(world, store, out, fn, args), nprocs=world)
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]


def rows_of(tree, rank, world):
    """``rank``'s contiguous rows of every batch-leading array of ``tree``."""
    if isinstance(tree, dict):
        return {k: rows_of(v, rank, world) for k, v in tree.items()}
    b = tree.shape[0]
    return tree[rank * b // world:(rank + 1) * b // world]


def checksum(model) -> float:
    return float(sum(p.detach().double().sum() for p in model.parameters()))


# -- comm -----------------------------------------------------------------------------------

def comm_checks(rank, world):
    """Every host helper of ``utils/comm.py`` and the device helpers, over
    the default group."""
    from divergen_tpu_torch.parallel.mesh import create_mesh, shard_pytree
    from divergen_tpu_torch.utils import comm

    group = dist.group.WORLD
    np.random.seed(100 + rank)
    out = {"world": comm.get_world_size(), "rank": comm.get_rank(),
           "main": comm.is_main_process()}
    comm.synchronize()
    out["all_gather"] = comm.all_gather({"rank": rank, "text": "r" * (rank + 1)})
    out["gather"] = comm.gather([rank] * (rank + 2), dst=1)
    out["seed"] = comm.shared_random_seed()
    out["mean"] = comm.reduce_dict({"b": float(rank + 1), "a": 2.0 * rank})
    out["sum"] = comm.reduce_dict({"b": float(rank + 1), "a": 2.0 * rank}, average=False)
    # gradients: a leaf only rank 1 reached (None on rank 0), buckets of a few bytes
    comm.BUCKET_BYTES = 40
    like = [torch.zeros(3, 2), torch.zeros(5), torch.zeros(4, dtype=torch.float64)]
    grads = [torch.full((3, 2), float(rank + 1)), None if rank == 0 else torch.arange(5.0),
             torch.full((4,), 3.0 * rank, dtype=torch.float64)]
    out["grads"] = comm.all_reduce_grads(grads, group, like=like)
    out["count"] = comm.global_mean_count(torch.tensor(float(rank)), group)
    out["count_floor"] = comm.global_mean_count(torch.tensor(0.0), group, floor=1.0)
    out["union"] = comm.all_reduce_max(torch.tensor([rank == 0, rank == 1, False]), group)
    out["device_sum"] = comm.all_reduce_sum(torch.tensor([rank, 3]), group)
    out["gathered"] = comm.all_gather_rows(torch.tensor([[rank, 10 + rank]]), group)
    out["gathered_bool"] = comm.all_gather_rows(torch.tensor([rank == 1, True]), group)
    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    bank = comm.all_gather_differentiable(x, group)
    (bank * torch.arange(bank.numel()).reshape(bank.shape)).sum().mul(rank + 1).backward()
    out["bank"], out["bank_grad"] = bank.detach(), x.grad
    # shard_pytree: rank 0's tensors everywhere
    mesh = create_mesh()
    model = torch.nn.Linear(2, 2)
    torch.nn.init.constant_(model.weight, float(rank))
    tree = {"a": torch.full((2,), float(rank)), "b": {"c": torch.tensor([rank])}}
    shard_pytree(model, mesh)
    shard_pytree(tree, mesh)
    out["module"], out["tree"] = model.weight.detach(), tree
    out["centernet"] = centernet_case(rank, world, group)
    return out


def centernet_inputs(seed=0, b=2, m=40, c=3):
    """CenterNet loss inputs of ``b`` images whose positives differ: image 0
    has six, image 1 one."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.zeros(b, m, c, dtype=torch.int32)
    pos[0, [1, 5, 9, 20, 30, 33], [0, 1, 2, 0, 1, 2]] = 1
    pos[1, 7, 2] = 1
    hm_cls = torch.rand(b, m, c, generator=g) * 0.5
    hm_cls[pos.bool()] = 1.0
    reg = torch.rand(b, m, 4, generator=g) * 3
    reg[torch.rand(b, m, generator=g) > 0.6] = -1.0
    return (torch.randn(b, m, c, generator=g), torch.randn(b, m, generator=g),
            torch.rand(b, m, 4, generator=g) * 3, reg, hm_cls.amax(-1), hm_cls, pos)


def centernet_case(rank, world, group):
    """This rank's image of ``centernet_inputs`` through the classwise
    CenterNet losses over ``group``."""
    from divergen_tpu_torch.modeling.centernet.centernet import (CenterNetConfig,
                                                                 centernet_losses_classwise)

    args = [rows_of(x, rank, world) for x in centernet_inputs()]
    losses = centernet_losses_classwise(CenterNetConfig(), *args, group=group)
    return {k: float(v) for k, v in losses.items()}


# -- the detector over ranks ----------------------------------------------------------------

def _model(cfg, state_dict, canvas):
    from divergen_tpu_torch.modeling.meta_arch.rcnn import build_model

    model = build_model(cfg, input_size=canvas)
    model.load_state_dict(state_dict)
    return model.train()


def _train(rank, world, group, spec):
    from divergen_tpu_torch.engine.train_loop import create_train_state, make_train_step
    from divergen_tpu_torch.solver.build import build_optimizer
    from divergen_tpu_torch.utils import comm

    model = _model(spec["cfg"], spec["state_dict"], spec["canvas"])
    opt = build_optimizer(spec["cfg"], model)
    state = create_train_state(model, opt, ema=True)
    step = make_train_step(model, opt, ema_decay=0.9, loss_weights=spec["loss_weights"],
                           group=group)
    batch = dict(rows_of({k: v for k, v in spec["batch"].items() if k != "fed_weight"},
                         rank, world), fed_weight=spec["batch"]["fed_weight"])
    state, metrics = step(state, batch, RankDraws(spec["draws"], rank, world))
    out = {"metrics": comm.reduce_dict({k: float(v) for k, v in metrics.items()}),
           "local": {k: float(v) for k, v in metrics.items()}, "step": state.step,
           "checksum": checksum(model)}
    if rank == 0:
        out["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        out["exp_avg"] = {n: opt.optim.state[p]["exp_avg"] for n, p in model.named_parameters()}
        out["exp_avg_sq"] = {n: opt.optim.state[p]["exp_avg_sq"]
                             for n, p in model.named_parameters()}
        out["ema"] = dict(state.ema_params)
    return out


def _caption(rank, world, group, spec):
    """The weak forward with the caption bank over the ranks: this rank's
    losses and the gradient of its rows of ``cap_emb``."""
    model = _model(spec["cfg"], spec["state_dict"], spec["canvas"])
    cap = rows_of(spec["cap"], rank, world).clone().requires_grad_(True)
    losses = model(rows_of(spec["images"], rank, world), rows_of(spec["sizes"], rank, world),
                   gt=rows_of(spec["gt"], rank, world), rng=RankDraws(spec["draws"], rank, world),
                   training=True, ann_type=spec["ann_type"], cap_emb=cap, group=group)
    sum(v for k, v in losses.items() if not k.startswith("aux_")).backward()
    return {"losses": {k: v.detach() for k, v in losses.items()}, "cap_grad": cap.grad}


def _bsgal(rank, world, group, spec):
    from divergen_tpu_torch.active import bsgal
    from divergen_tpu_torch.engine.train_loop import create_train_state
    from divergen_tpu_torch.solver.build import build_optimizer
    from divergen_tpu_torch.utils import comm

    model = _model(spec["cfg"], spec["state_dict"], spec["canvas"])
    opt = build_optimizer(spec["cfg"], model)
    state = create_train_state(model, opt, ema=True)
    astate = bsgal.init_active_state(dict(model.named_parameters()), queue_size=8)
    step = bsgal.make_active_train_step(model, opt, spec["cfg"], group=group)
    rng = RankDraws(torch.Generator().manual_seed(spec["seed"]), rank, world)
    state, astate, metrics = step(state, astate, rows_of(spec["batch"], rank, world), rng)
    metrics.pop("aux_paste_rows", None)
    out = {"metrics": comm.reduce_dict({k: float(v) for k, v in metrics.items()}),
           "local": {k: float(v) for k, v in metrics.items()},
           "counts": (int(astate.n_paste), int(astate.n_discard)), "checksum": checksum(model),
           "bank_checksum": float(sum(v.double().sum() for v in astate.grad_bank.values()))}
    if rank == 0:
        out["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    return out


class RecordingEvaluator:
    """An evaluator that keeps what ``process`` is given (the detections of
    every image on the host) around another evaluator."""

    def __init__(self, inner):
        self.inner, self.outputs = inner, []

    def reset(self):
        self.inner.reset()
        self.outputs = []

    def process(self, inputs, outputs):
        self.outputs.append(({k: np.asarray(v) for k, v in outputs.items()},
                             [int(s["image_id"]) for s in inputs]))
        self.inner.process(inputs, outputs)

    def evaluate(self):
        return self.inner.evaluate()


def _evaluate(rank, world, group, spec):
    from divergen_tpu_torch.data.datasets.lvis import lvis_meta_from_json, register_lvis_instances
    from divergen_tpu_torch.engine.eval_loop import build_evaluator, inference_on_dataset

    files, name, cfg = spec["files"], spec["dataset"], spec["cfg"]
    register_lvis_instances(name, lvis_meta_from_json(files["json_file"]), files["json_file"],
                            files["image_root"])
    model = _model(cfg, spec["state_dict"], spec["canvas"]).eval()
    evaluator = RecordingEvaluator(build_evaluator(cfg, name))
    results = inference_on_dataset(model, None, cfg, name, evaluator,
                                   batch_size=spec["batch_size"], group=group)
    return {"results": results, "outputs": evaluator.outputs}


def detector_session(rank, world, spec):
    """The tasks of ``spec`` (``train``, ``caption``, ``bsgal``, ``evaluate``)
    on the small Swin (``spec["tiny_swin"]``), each over the default group."""
    from divergen_tpu_torch.modeling.backbone import swin

    swin.SIZE2CONFIG["tiny"] = spec["tiny_swin"]
    tasks = {"train": _train, "caption": _caption, "bsgal": _bsgal, "evaluate": _evaluate}
    return {name: tasks[name](rank, world, dist.group.WORLD, task)
            for name, task in spec.items() if name in tasks}


class one_rank_group:
    """A gloo process group of this process alone (a ``FileStore`` in
    ``tmp``), destroyed on exit: the reductions over ranks run, over one."""

    def __init__(self, tmp):
        self.store = os.path.join(str(tmp), "one_rank_store")

    def __enter__(self):
        dist.init_process_group("gloo", store=dist.FileStore(self.store, 1), rank=0,
                                world_size=1)
        return dist.group.WORLD

    def __exit__(self, *exc):
        dist.destroy_process_group()
