"""BSGAL online active selection of pasted instances (ICML 2024).

Counterpart of ``divergen_tpu/active/bsgal.py``, function for function; the
JAX module's source is ``BSGAL/bsgal/modeling/meta_arch/custom_rcnn.py:49-1354``.
Each step estimates the *contribution* of the pasted synthetic instances by
the cosine between their gradient and an EMA bank of real-data gradients,
and decides paste or discard:

- the probe gradient ``g_test`` is one ``torch.autograd.grad`` of the probe
  batch's classification losses with the ground truth as the only proposals;
- the candidate gradient ``g_paste`` is the gradient of the
  ``loss_paste_ins*`` keys alone, from one forward on the pasted batch
  (``ACTIVE.FORWARD_ONCE``, the default); the other modes of the JAX package
  are here too (``only_gt``, dynamic and dynamic-linear thresholds, the
  two-forward gradient compare, the loss compare with its inner SGD step,
  per-instance decisions, the three ``MODE``s, the ``COMPARE`` baselines);
- gradients are taken with ``materialize_grads=True``: a parameter a loss
  does not reach gets zeros, as under ``jax.grad``, so the cosine and the
  bank's EMA see every parameter;
- the bank is a dict of float32 tensors under the parameters' names, updated
  in place; the decision stays on the device (``use_paste`` is a 0-d bool
  tensor and the chosen batch is ``torch.where`` of pasted and original), so
  a step makes no host sync;
- the final update steps the optimizer also after a ``paste_or_zero``
  discard, with zero gradients (assigned, never ``None``): AdamW still
  decays the weights and its moments and counts the step, as optax does.

Over ranks the gradients are reduced over the data group before every use;
the per-instance quantile is taken over the global batch's pastes (each
rank's per-paste means gathered); at a model axis above 1 the cosine's dot
products and norms add the slices' shares over the model group.

The step takes its random draws from a ``torch.Generator`` (every forward
draws from it in turn) or from a mapping ``{"probe", "paste", "final":
mappings of named draws for ``ops.losses.uniform_draw``, "compare": the
uniform of the ``COMPARE`` baselines}`` — the four keys the JAX step splits
from ``fold_in(rng, step)``. None of its forwards takes ``fed_weight``, as in
the JAX package (ROADMAP.md §3).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.copy_paste import normalize_cp_method
from ..ops.losses import RankDraws, Rng, uniform_draw
from ..solver.build import ema_update
from ..utils.comm import all_gather_rows, all_reduce_grads, all_reduce_sum, global_mean_count


@dataclasses.dataclass
class ActiveState:
    """Carried alongside ``TrainState``: the gradient bank (float32, one
    tensor per parameter name), the threshold queue and the decision counters
    (paste / not paste, :688-689), all tensors on the step's device."""

    grad_bank: Dict[str, torch.Tensor]
    bank_initialized: torch.Tensor  # () bool
    sim_queue: torch.Tensor  # (Q,) float32
    queue_pos: torch.Tensor  # () int32
    queue_filled: torch.Tensor  # () int32
    n_paste: torch.Tensor  # () int32
    n_discard: torch.Tensor  # () int32

    _SCALARS = ("bank_initialized", "sim_queue", "queue_pos", "queue_filled", "n_paste",
                "n_discard")

    def state_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {k: getattr(self, k) for k in self._SCALARS}
        out["grad_bank"] = dict(self.grad_bank)
        return out

    @torch.no_grad()
    def load_state_dict(self, raw: Dict[str, Any]) -> "ActiveState":
        """Copy a ``state_dict`` into this state's tensors, in place."""
        if set(raw["grad_bank"]) != set(self.grad_bank):
            raise KeyError("the saved grad bank holds other parameters than this model")
        for k, v in raw["grad_bank"].items():
            self.grad_bank[k].copy_(v)
        for k in self._SCALARS:
            getattr(self, k).copy_(raw[k])
        return self


def init_active_state(params: Dict[str, torch.Tensor], queue_size: int = 1000) -> ActiveState:
    """A zero bank shaped like ``params`` (float32, on their device), an empty
    queue and zero counters."""
    dev = next(iter(params.values())).device
    zeros = lambda dtype, shape=(): torch.zeros(shape, dtype=dtype, device=dev)
    return ActiveState(
        grad_bank={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        bank_initialized=zeros(torch.bool),
        sim_queue=zeros(torch.float32, (queue_size,)),
        queue_pos=zeros(torch.int32),
        queue_filled=zeros(torch.int32),
        n_paste=zeros(torch.int32),
        n_discard=zeros(torch.int32),
    )


def tree_cosine(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
                shards=None) -> torch.Tensor:
    """cos(flat(a), flat(b)) without flattening: per-name float32 dot products
    and squared norms, summed (compute_grad_sim, :1074-1086). ``shards``: the
    ``parallel.mesh.ModelShards`` whose leaves ``a`` and ``b`` hold as this
    rank's slices; their shares are summed over the model group, so the
    cosine is the full gradients'."""
    xs = [a[k].float().reshape(-1) for k in a]
    ys = [b[k].float().reshape(-1) for k in a]
    terms = [torch.stack([torch.dot(x, y) for x, y in zip(xs, ys)]),
             torch.stack([torch.dot(x, x) for x in xs]), torch.stack([torch.dot(y, y) for y in ys])]
    if shards is None:
        dot, na2, nb2 = (t.sum() for t in terms)
    else:
        dot, na2, nb2 = shards.global_sum(torch.stack(terms), [k in shards.dims for k in a])
    return dot / torch.clamp(na2.sqrt() * nb2.sqrt(), min=1e-12)


@torch.no_grad()
def update_bank(state: ActiveState, g_test: Dict[str, torch.Tensor], momentum: float) -> ActiveState:
    """EMA of the real-data gradient (update_grad_bank, :1046-1072), in
    place; the first update copies."""
    init = state.bank_initialized
    for k, bank in state.grad_bank.items():
        g = g_test[k].float()
        bank.copy_(torch.where(init, (1.0 - momentum) * bank + momentum * g, g))
    state.bank_initialized = torch.ones_like(init)
    return state


def dynamic_threshold(state: ActiveState, percent: Union[float, torch.Tensor]) -> torch.Tensor:
    """Percentile of the sims seen so far (DynamicThreshold, :29-48); the
    unfilled slots are +inf, so they never lower it."""
    q = state.sim_queue
    n = torch.clamp(state.queue_filled, min=1)
    masked = torch.where(torch.arange(q.shape[0], device=q.device) < n, q,
                         torch.full_like(q, float("inf")))
    s = torch.sort(masked).values
    idx = torch.clamp((percent * (n - 1)).to(torch.int32), 0, q.shape[0] - 1)
    return s[idx.long()]


@torch.no_grad()
def push_sim(state: ActiveState, sim: torch.Tensor) -> ActiveState:
    """Write ``sim`` into the ring buffer at ``queue_pos``, in place."""
    size = state.sim_queue.shape[0]
    state.sim_queue.scatter_(0, state.queue_pos.long().reshape(1),
                             sim.detach().float().reshape(1))
    state.queue_pos = (state.queue_pos + 1) % size
    state.queue_filled = torch.clamp(state.queue_filled + 1, max=size)
    return state


def unique_paste_ids(instance_source: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[0,0,1,1],[0,1,..] → [0,0,1,2],[0,3,..]: pasted instances numbered
    1..P sequentially across the whole batch (reset_instance_source,
    custom_rcnn.py:317-329), so per-paste loss columns identify individual
    pastes."""
    is_paste = (instance_source > 0) & valid
    flat = is_paste.reshape(-1)
    ids = torch.cumsum(flat.to(torch.int64), 0)
    return torch.where(flat, ids, torch.zeros_like(ids)).reshape(instance_source.shape)


def apply_compare_baseline(compare: str, decision: torch.Tensor, rng: Optional[Rng], step: int,
                           schedule_iters: int) -> torch.Tensor:
    """ACTIVE_COMPARE ablation baselines (compare_loss, custom_rcnn.py:
    1097-1169; '>' = paste). ``decision`` is the 0-d bool of sim > thr; the
    random baselines draw one uniform, ``uniform_draw(rng, "compare", ())``
    (``jax.random.bernoulli(key, p)`` is that uniform below p).

    default  — follow the decision.
    contra   — invert the decision (ref :1137-1141 flips the '<'/'>').
    all      — always paste.
    random   — paste w.p. 0.5; random_<p> — paste w.p. p.
    prob     — follow the decision w.p. 0.8, inverted otherwise.
    schedule — paste unconditionally w.p. step/schedule_iters, else follow.
    """
    if compare == "default":
        return decision
    if compare == "contra":
        return ~decision
    if compare == "all":
        return torch.ones_like(decision)
    u = lambda: uniform_draw(rng, "compare", (), decision.device)
    if compare.startswith("random"):
        p = float(compare.split("_")[1]) if "_" in compare else 0.5
        return u() < p
    if compare == "prob":
        follow = u() < 0.8
        return torch.where(follow, decision, ~decision)
    if compare == "schedule":
        ramp = torch.clamp(torch.tensor(step, dtype=torch.float32) / float(schedule_iters),
                           0.0, 1.0)
        return (u() < ramp.to(decision.device)) | decision
    raise NotImplementedError(f"ACTIVE.COMPARE={compare}")


class DecisionLogger:
    """Per-decision txt logs in the reference's layout (custom_rcnn.py:
    610-686): ``OUTPUT/paste_source/rank_<r>/<iter//10000+1>0000.txt`` one
    line per pasted file, and ``OUTPUT/paste_ins_loss/...`` per-instance
    loss columns when the per-paste rows are enabled. The same text as the
    JAX package's, byte for byte."""

    def __init__(self, out_dir: str, rank: int):
        self.out_dir = out_dir
        self.rank = rank

    def _open(self, sub: str, it: int):
        path = os.path.join(self.out_dir, sub, f"rank_{self.rank}", f"{it // 10000 + 1}0000.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return open(path, "a")

    def log_decision(self, it, filenames, select_classes, paste, sim, thr, paste_num):
        with self._open("paste_source", it) as f:
            for fn, cls in zip(filenames, select_classes):
                f.write(
                    f"{fn} select_class: {cls} paste: {int(paste)} iter: {it}"
                    f" loss_dif: {round(float(sim) - float(thr), 4)}"
                    f" paste_num: {paste_num}"
                    f" sim_paste_init: {round(float(sim), 4)}"
                    f" threshold: {round(float(thr), 4)}\n"
                )

    def close(self) -> None:
        """Files are opened per-write; nothing held open."""

    def log_paste_ins(self, it, rows, paste, paste_num):
        """rows: iterable of (filename, select_class, ins_loss, max_error_class,
        max_error_loss)."""
        with self._open("paste_ins_loss", it) as f:
            for fn, cls, loss, mec, mel in rows:
                f.write(
                    f"{fn} select_class: {cls} paste: {int(paste)} iter: {it}"
                    f" paste_num: {paste_num}"
                    f" paste_ins_loss: {round(float(loss), 4)}"
                    f" max_error_class: {int(mec)}"
                    f" max_error_loss: {round(float(mel), 4)}\n"
                )


def paste_ins_rows(aux: Dict[str, Any], filenames) -> list:
    """Join the per-paste loss columns (segment-mean over proposal rows by
    unique paste id) with host-side filename provenance.

    ``aux``: metrics['aux_paste_rows'] on the host (numpy).
    ``filenames``: (B, MP) string array from the mapper (never on the device).
    Returns rows for DecisionLogger.log_paste_ins.
    """
    ids_gt = np.asarray(aux["gt_ids"])  # (B, N)
    valid = np.asarray(aux["gt_valid"])
    classes = np.asarray(aux["gt_classes"])
    row_loss = np.asarray(aux["loss"]).reshape(-1)
    row_id = np.asarray(aux["id"]).reshape(-1)
    row_mec = np.asarray(aux["max_class"]).reshape(-1)
    row_mel = np.asarray(aux["max_loss"]).reshape(-1)

    fn_flat = np.asarray(filenames).reshape(-1) if filenames is not None else None
    rows = []
    b, n = ids_gt.shape
    # paste slots come after the base instances: the j-th pasted instance of
    # image i corresponds to filenames[i, j]
    for i in range(b):
        slot = 0
        for j in range(n):
            if not valid[i, j] or ids_gt[i, j] <= 0:
                continue
            uid = ids_gt[i, j]
            sel = row_id == uid
            if sel.any():
                loss = float(row_loss[sel].mean())
                mec = int(row_mec[sel][0])
                mel = float(row_mel[sel].max())
            else:
                loss, mec, mel = 0.0, -1, 0.0
            if fn_flat is not None:
                fn = np.asarray(filenames)[i, slot] if slot < np.asarray(filenames).shape[1] else ""
            else:
                fn = ""
            rows.append((fn, int(classes[i, j]), loss, mec, mel))
            slot += 1
    return rows


@dataclasses.dataclass(frozen=True)
class ActiveConfig:
    mode: str = "paste_or_ori"  # paste_or_zero | paste_or_ori | paste_only
    loss_keys: Tuple[str, ...] = ("loss_cls_stage0", "loss_cls_stage1", "loss_cls_stage2")
    momentum: float = 0.1
    threshold: float = -0.05
    dynamic: bool = False
    dynamic_percent: float = 0.5
    cp_mode: str = "basic"
    compare: str = "default"
    schedule_iters: int = 90000
    per_instance: bool = False
    per_instance_percent: float = 0.9
    per_paste_rows: bool = False
    # --- decision machinery selection (ref ACTIVE_GRAD_COMPARE /
    # ACTIVE_FORWARD_ONCE / ACTIVE_ONCE_MODE, custom_rcnn.py:341-605) ---
    grad_compare: bool = True  # False → inner-SGD probe-loss comparison
    forward_once: bool = True  # grad path: paste-keys-only grad from ONE fwd
    gt_compare: bool = False  # ONCE_MODE 'only_gt': sim(paste) vs sim(nopaste)
    # ONCE_MODE 'only_paste_dynamic_linear_<s>_<e>': keep-rate annealed
    # s→e over max_iter, queue percentile = 1-rate (ref :132-136,544-548)
    dynamic_linear: Optional[Tuple[float, float]] = None
    max_iter: int = 90000
    inner_lr: float = 0.01  # loss-compare probe update (ref ACTIVE_LR)
    bank_update_period: int = 1
    probe_batch: int = 4  # ACTIVE_TEST_BATCHSIZE (trainer slices the probe)

    @staticmethod
    def from_cfg(cfg) -> "ActiveConfig":
        a = cfg.MODEL.ACTIVE
        threshold = a.THRESHOLD
        dynamic = a.DYNAMIC_THRESHOLD
        dynamic_percent = a.DYNAMIC_PERCENT
        gt_compare = False
        dynamic_linear = None
        if a.FORWARD_ONCE and a.GRAD_COMPARE and a.ONCE_MODE:
            # the reference encodes the once-forward decision in a mode
            # string (custom_rcnn.py:127-136, 523-548)
            om = a.ONCE_MODE
            if om == "only_gt":
                gt_compare = True
            elif om.startswith("only_paste"):
                parts = om.split("_")
                if "dynamic" in parts:
                    dynamic = True
                    if "linear" in parts:
                        dynamic_linear = (float(parts[-2]), float(parts[-1]))
                    else:
                        dynamic_percent = 1.0 - float(parts[-1])
                else:
                    threshold = float(parts[-1])
                    dynamic = False
            else:
                raise NotImplementedError(f"ACTIVE.ONCE_MODE={om}")
        if a.OPTIMIZER.lower() != "sgd":
            raise NotImplementedError(
                f"ACTIVE.OPTIMIZER={a.OPTIMIZER} (loss-compare inner update "
                "implements the reference default 'SGD', custom_rcnn.py:150-156)"
            )
        return ActiveConfig(
            mode=a.MODE,
            loss_keys=tuple(a.LOSS),
            momentum=a.MOMENTUM,
            threshold=threshold,
            dynamic=dynamic,
            dynamic_percent=dynamic_percent,
            cp_mode=normalize_cp_method(cfg.INPUT.CP_METHOD),
            compare=a.COMPARE,
            schedule_iters=a.SCHEDULE_ITERS,
            per_instance=a.PER_INSTANCE,
            per_instance_percent=a.PER_INSTANCE_PERCENT,
            per_paste_rows=a.ONLY_GT_TRAIN or a.PER_INSTANCE,
            grad_compare=a.GRAD_COMPARE,
            forward_once=a.FORWARD_ONCE,
            gt_compare=gt_compare,
            dynamic_linear=dynamic_linear,
            max_iter=cfg.SOLVER.MAX_ITER,
            inner_lr=a.INNER_LR,
            bank_update_period=a.BANK_UPDATE_PERIOD,
            probe_batch=a.PROBE_BATCH,
        )


def split_rng(rng: Rng) -> Tuple[Rng, Rng, Rng, Rng]:
    """(probe, paste, final, compare) draws of one step: a generator serves
    all four in turn; a mapping holds the first three under their names and
    the compare uniform under ``"compare"``; over ranks either one in a
    ``RankDraws``."""
    if isinstance(rng, RankDraws):
        if isinstance(rng.source, torch.Generator):
            return rng, rng, rng, rng
        part = lambda k: RankDraws(rng.source[k], rng.rank, rng.world)
        return part("probe"), part("paste"), part("final"), rng
    if isinstance(rng, torch.Generator):
        return rng, rng, rng, rng
    return rng["probe"], rng["paste"], rng["final"], rng


def _scalar_keys(losses: Dict[str, torch.Tensor]) -> List[str]:
    return [k for k in losses if "paste_ins" not in k and not k.startswith("aux_")]


def _sum(losses: Dict[str, torch.Tensor], keys) -> torch.Tensor:
    keys = list(keys)
    if not keys:
        raise KeyError(f"no loss to sum among {sorted(losses)}")
    total = losses[keys[0]].float()
    for k in keys[1:]:
        total = total + losses[k].float()
    return total


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero rows appended along dim 1 up to ``n``."""
    extra = n - x.shape[1]
    if extra <= 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], extra, *x.shape[2:]))], dim=1)


def make_active_train_step(model, optimizer, cfg, group=None) -> Callable:
    """``step(state, active_state, batch, rng) → (state, active_state,
    metrics)``; the state, the model, the optimizer, the EMA copy and the
    active state are updated in place and returned.

    batch: the pasted-batch inputs (``image``, ``image_size``, ``gt``, the
    patch stack; trainer format) plus ``probe`` — a real-data batch
    ``{"image", "image_size", "gt"}`` for the test gradient
    (ACTIVE_TEST_BATCHSIZE images). Metrics: ``total_loss`` (the final
    step's losses without the split keys), ``grad_sim``, ``paste_used``,
    ``threshold``, ``paste_num``, every loss of the final forward but the
    ``aux_*`` rows, and with the per-paste rows ``aux_paste_rows``. ``group``:
    the ranks whose batches (and probes) make the global batch (module
    docstring).
    """
    from ..engine.train_loop import reduce_grads_
    from ..engine.trainer import composite
    from ..parallel.mesh import Mesh, model_shards

    if isinstance(group, Mesh):
        group = group.group
    acfg = ActiveConfig.from_cfg(cfg)
    shards = model_shards(model)
    cosine = lambda a, b: tree_cosine(a, b, shards)
    ema_decay = cfg.MODEL.MODEL_EMA
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    names, params = [n for n, _ in named], [p for _, p in named]

    def grads_of(loss: torch.Tensor, retain: bool = False) -> Dict[str, torch.Tensor]:
        grads = torch.autograd.grad(loss, params, retain_graph=retain, allow_unused=True,
                                    materialize_grads=True)
        return dict(zip(names, all_reduce_grads(grads, group)))

    def forward(images, sizes, gt, rng, **kw):
        return model(images, sizes, gt=gt, rng=rng, training=True, group=group, **kw)

    def probe_loss(probe, rng, call=forward) -> torch.Tensor:
        losses = call(probe["image"], probe["image_size"], probe["gt"], rng, gt_as_proposals=True)
        keys = [k for k in acfg.loss_keys if k in losses]
        # without them: every non-split loss (ACTIVE_LOSS 'all')
        return _sum(losses, keys or _scalar_keys(losses))

    def probe_loss_at(probe, rng, grads) -> torch.Tensor:
        """The probe loss after a virtual SGD step ``p - inner_lr · g``."""
        moved = {n: p.detach() - acfg.inner_lr * grads[n].to(p.dtype) for n, p in named}

        def call(images, sizes, gt, r, **kw):
            return torch.func.functional_call(model, moved, (images, sizes),
                                              dict(gt=gt, rng=r, training=True, **kw))

        with torch.no_grad():
            # each rank's loss holds its share of the global probe's: their mean
            return global_mean_count(probe_loss(probe, rng, call=call), group)

    def step_fn(state, astate: ActiveState, batch, rng: Rng):
        assert state.model is model and state.optimizer is optimizer
        k_probe, k_paste, k_final, k_cmp = split_rng(rng)
        images_pasted, gt_pasted = composite(batch, acfg.cp_mode)
        if acfg.per_paste_rows:
            # unique ids 1..P (reset_instance_source, :317-329) so stage-0
            # per-paste loss columns identify individual pasted instances
            gt_pasted["instance_source"] = unique_paste_ids(gt_pasted["instance_source"],
                                                            gt_pasted["valid"])
        sizes = batch["image_size"]
        # the original batch padded to the pasted gt width (candidate B of
        # the decision, and the loss-compare probe's 'ori' side)
        width = gt_pasted["boxes"].shape[1]
        gt_orig = {k: _pad_rows(batch["gt"][k], width) for k in gt_pasted}
        dev = images_pasted.device

        if acfg.grad_compare:
            # A. real-data probe gradient → EMA bank (:347-354,445-447),
            # refreshed every BANK_UPDATE_PERIOD steps
            if state.step % acfg.bank_update_period == 0:
                update_bank(astate, grads_of(probe_loss(batch["probe"], k_probe)),
                            acfg.momentum)
            bank = astate.grad_bank
            # B. candidate gradient + C. similarity decision (:480-605)
            if acfg.forward_once:
                paste_losses = forward(images_pasted, sizes, gt_pasted, k_paste)
                paste_part = _sum(paste_losses, [k for k in paste_losses if "loss_paste_ins" in k])
                if acfg.gt_compare:  # ONCE_MODE 'only_gt' (:523-529): one forward
                    sim = cosine(grads_of(paste_part, retain=True), bank)
                    nopaste = _sum(paste_losses,
                                   [k for k in paste_losses if "loss_nopaste_ins" in k])
                    thr = cosine(grads_of(nopaste), bank)
                else:
                    sim = cosine(grads_of(paste_part), bank)
                    if acfg.dynamic_linear is not None:
                        s_r, e_r = acfg.dynamic_linear
                        frac = torch.clamp(torch.tensor(state.step, dtype=torch.float32)
                                           / float(acfg.max_iter), 0.0, 1.0)
                        rate = s_r + (e_r - s_r) * frac
                        thr = dynamic_threshold(astate, (1.0 - rate).to(dev))
                    elif acfg.dynamic:
                        thr = dynamic_threshold(astate, acfg.dynamic_percent)
                    else:
                        thr = torch.tensor(acfg.threshold, dtype=torch.float32, device=dev)
            else:
                # two-forward grad compare (:366-383, :555-560): full-batch
                # grads of both candidates against the bank
                paste_losses = forward(images_pasted, sizes, gt_pasted, k_paste)
                sim = cosine(grads_of(_sum(paste_losses, _scalar_keys(paste_losses))), bank)
                ori = forward(batch["image"], sizes, gt_orig, k_paste)
                thr = cosine(grads_of(_sum(ori, _scalar_keys(ori))), bank)
        else:
            # loss-compare (ref ACTIVE_GRAD_COMPARE=False default,
            # :341-399,555-575): virtual inner-SGD step on each candidate,
            # compare the probe loss afterwards; the candidates' parameters
            # are new tensors, the model's stay as they are
            paste_losses = forward(images_pasted, sizes, gt_pasted, k_paste)
            g_paste = grads_of(_sum(paste_losses, _scalar_keys(paste_losses)))
            loss_paste_test = probe_loss_at(batch["probe"], k_probe, g_paste)
            del g_paste
            ori = forward(batch["image"], sizes, gt_orig, k_paste)
            g_ori = grads_of(_sum(ori, _scalar_keys(ori)))
            loss_ori_test = probe_loss_at(batch["probe"], k_probe, g_ori)
            del g_ori
            # loss_dif > 0 ⇔ paste probe loss lower ⇔ paste better
            # (compare_loss 'default': '>' when new < old, :1155-1159)
            sim = loss_ori_test - loss_paste_test
            thr = torch.zeros((), dtype=torch.float32, device=dev)

        sim, thr = sim.detach(), thr.detach()
        decision = apply_compare_baseline(acfg.compare, sim > thr, k_cmp, state.step,
                                          acfg.schedule_iters)
        use_paste = decision | (acfg.mode == "paste_only")
        push_sim(astate, sim)
        astate.n_paste = astate.n_paste + use_paste.to(torch.int32)
        astate.n_discard = astate.n_discard + (~use_paste).to(torch.int32)

        if acfg.per_instance:
            # per-INSTANCE decision: drop pasted instances whose stage-0
            # per-paste CE sits above the per_instance_percent quantile of
            # the global batch's pastes (each rank's means gathered over the
            # ranks; a paste's rows all lie on the rank holding its image)
            row_loss = paste_losses["aux_paste_row_loss_stage0"].detach().reshape(-1).float()
            row_id = paste_losses["aux_paste_row_id_stage0"].reshape(-1).long()
            n_ids = gt_pasted["instance_source"].numel() + 1  # static id cap
            seg = torch.zeros(n_ids, device=dev).index_add_(0, row_id, row_loss)
            cnt = torch.zeros(n_ids, device=dev).index_add_(0, row_id, (row_id > 0).float())
            per_id = seg / torch.clamp(cnt, min=1.0)
            present = cnt > 0
            present[0] = False
            n_present = torch.clamp(all_reduce_sum(present.sum(), group), min=1)
            ranked = all_gather_rows(torch.where(present, per_id,
                                                 torch.full_like(per_id, float("inf"))), group)
            s = torch.sort(ranked).values
            qidx = torch.clamp((acfg.per_instance_percent * (n_present - 1)).to(torch.int32),
                               0, s.shape[0] - 1)
            keep_id = per_id <= s[qidx.long()]
            ids_gt = gt_pasted["instance_source"].long()
            drop = (ids_gt > 0) & present[ids_gt] & ~keep_id[ids_gt]
            gt_pasted = dict(gt_pasted, valid=gt_pasted["valid"] & ~drop)

        # choose the batch: pasted vs original, on the device
        images = torch.where(use_paste, images_pasted, batch["image"])
        gt = {k: torch.where(use_paste, gt_pasted[k], gt_orig[k]) for k in gt_pasted}

        # E. final supervised step on the chosen batch (:701-778)
        losses = forward(images, sizes, gt, k_final)
        total = _sum(losses, _scalar_keys(losses))
        optimizer.zero_grad()
        total.backward()
        reduce_grads_(optimizer, group)
        if acfg.mode == "paste_or_zero":
            # a discard still steps the optimizer, on zero gradients
            zero_out = ~use_paste
            with torch.no_grad():
                for p in params:
                    g = p.grad if p.grad is not None else torch.zeros_like(p)
                    p.grad = torch.where(zero_out, torch.zeros_like(g), g)
        optimizer.step()
        if state.ema_params is not None:
            ema_update(state.ema_params, state.params, ema_decay)
        state.step += 1
        # the pasted instances of the global batch
        paste_num = all_reduce_sum(
            ((gt_pasted["instance_source"] > 0) & gt_pasted["valid"]).sum(), group)
        metrics = {
            "total_loss": total.detach(),
            "grad_sim": sim,
            "paste_used": use_paste.float(),
            "threshold": thr,
            "paste_num": paste_num.float(),
            **{k: v.detach().float() for k, v in losses.items() if not k.startswith("aux_")},
        }
        if acfg.per_paste_rows:
            # per-paste loss columns for the paste_ins_loss decision log
            # (custom_rcnn.py:671-686); the trainer pops this nested entry
            metrics["aux_paste_rows"] = {
                "loss": paste_losses["aux_paste_row_loss_stage0"].detach(),
                "max_class": paste_losses["aux_paste_row_max_class_stage0"],
                "max_loss": paste_losses["aux_paste_row_max_loss_stage0"].detach(),
                "id": paste_losses["aux_paste_row_id_stage0"],
                "gt_ids": gt_pasted["instance_source"],
                "gt_valid": gt_pasted["valid"],
                "gt_classes": gt_pasted["classes"],
            }
        return state, astate, metrics

    return step_fn
