"""Fine-tuning loop for the text models, LineVul and CodeT5's
``DefectModel``, alone or combined with the DeepDFA graph encoder (port
of ``deepdfa_tpu/train/text_loop.py``, one device).

Reference semantics: AdamW (lr 2e-5, eps 1e-8) behind a global-norm clip
(1.0), the learning rate warming up linearly over the first 20 % of the
steps from 0 and decaying linearly to 0 after (``optax.join_schedules``
of two linear pieces: the first update runs at count 0, so at lr 0; the
port sets each step's lr explicitly from the count); per-epoch
evaluation keeping the best state by validation F1, optional early stop
on patience, and the raise/rollback guard for a non-finite epoch loss.
Combined batches join each text row to its graph by example id: rows
with no graph, or whose graph would overflow the batch's node/edge
budget, stay in the batch but are masked out of loss and metrics
(``n_missing``).

The loss and the confusion counts accumulate on the device and are read
once an epoch. With ``attention_impl`` "auto" or "flash" on CUDA,
LineVul's attention runs the hand-written flash kernels forward and
backward (``ops/attention.py``; the T5 stack's attention is plain
torch); a graph encoder runs the gated-step kernels of
``ops/fused_gnn.py`` ("fused", "persistent") or the block-sparse kernel
of ``ops/tile_spmm.py`` ("tile"). Batches are padded with the model's
pad id (``model.pad_token_id``: 1 for codebert, 0 for codet5) unless
the caller gives one.

``init_params`` grafts a ``state_dict`` fragment (a trained graph
encoder, ``flowgnn.*``) over the fresh init. ``freeze_submodules`` holds
top-level submodules at their loaded values the way the paper's own
code does (linevul_main.py:595-602): ``requires_grad_(False)``, and the
frozen parameters stay out of AdamW and out of the global-norm clip.
The reference's ``optax.multi_transform`` with ``set_to_zero`` gives the
same updates (its clip sees only the trainable gradients); it computes
the frozen gradients and zeroes them, where here autograd computes none,
so a frozen graph encoder runs its forward kernels only. With a
``checkpointer`` the loop writes ``last`` and the periodic snapshot each
epoch and ``best`` on a validation-F1 improvement.

Not ported yet: the mesh and multi-process paths, the preemption
lifecycle and fleet drain, telemetry spans and the fault-injection hooks
(ROADMAP.md, section A).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Tuple, Union)

import numpy as np
import torch

from deepdfa_tpu_torch.core.config import TransformerTrainConfig
from deepdfa_tpu_torch.core.metrics import BinaryStats, binary_stats, compute_metrics
from deepdfa_tpu_torch.graphs.batch import GraphBatch, batch_graphs
from deepdfa_tpu_torch.models.linevul import LineVul, cross_entropy_loss
from deepdfa_tpu_torch.models.t5 import DefectModel
from deepdfa_tpu_torch.ops.tile_spmm import align_to_tile
from deepdfa_tpu_torch.train.loop import (
    TrainState,
    _live_state,
    _restore,
    _snapshot,
    clip_by_global_norm_,
)

logger = logging.getLogger(__name__)

# The models the loop trains: ``forward(input_ids, graphs, deterministic,
# generator) -> logits [B, 2]``, a ``graph_config`` and a
# ``pad_token_id``.
TextModel = Union[LineVul, DefectModel]


@dataclasses.dataclass
class TextBatch:
    """One host batch: ``input_ids`` [B, T] int32, ``labels`` [B] int32,
    ``example_mask`` [B] bool, ``index`` [B] int64 example ids (-1 for
    padding rows), the slotted graphs (slot i is row i's graph) and the
    rows with an example but no usable graph."""

    input_ids: np.ndarray
    labels: np.ndarray
    example_mask: np.ndarray
    index: np.ndarray
    graphs: Optional[GraphBatch]
    n_missing: int = 0


def make_schedule(cfg: TransformerTrainConfig,
                  max_steps: int) -> Callable[[int], float]:
    """count -> learning rate: ``optax.join_schedules`` of
    ``linear_schedule(0, lr, warmup)`` and ``linear_schedule(lr, 0,
    max_steps - warmup)``, in optax's f32 arithmetic."""
    warmup = max(int(max_steps * cfg.warmup_fraction), 1)
    decay = max(max_steps - warmup, 1)
    f32 = np.float32
    lr = cfg.learning_rate

    def linear(init: float, end: float, steps: int, count: int) -> float:
        c = min(max(count, 0), steps)
        frac = f32(1) - f32(c) / f32(steps)
        return float(f32(init - end) * frac + f32(end))

    def schedule(count: int) -> float:
        if count < warmup:
            return linear(0.0, lr, warmup, count)
        return linear(lr, 0.0, decay, count - warmup)

    return schedule


def make_text_optimizer(params: Iterable[torch.nn.Parameter],
                        cfg: TransformerTrainConfig) -> torch.optim.AdamW:
    """``optax.adamw(schedule, eps, weight_decay)`` over the parameters
    that train (frozen ones are left out); the train step sets each
    update's learning rate and clips the gradients first."""
    return torch.optim.AdamW([p for p in params if p.requires_grad],
                             lr=cfg.learning_rate,
                             betas=(0.9, 0.999), eps=cfg.adam_epsilon,
                             weight_decay=cfg.weight_decay)


def _merge_params(model: torch.nn.Module,
                  overrides: Mapping[str, torch.Tensor]) -> None:
    """Graft pretrained tensors (e.g. a trained ``flowgnn.*`` encoder)
    onto the model's fresh init, in place. A key the model lacks, or a
    shape that differs, raises: it would leave that part at its random
    init without a word."""
    own = model.state_dict()
    unknown = [k for k in overrides if k not in own]
    if unknown:
        raise KeyError(
            f"{len(unknown)} override params not present in the model, e.g. "
            f"{unknown[0]!r}; prefix the pretrained keys with the submodule "
            "name (e.g. 'flowgnn.')")
    for k, v in overrides.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"override {k!r} has shape {tuple(v.shape)}, "
                             f"the model's is {tuple(own[k].shape)}")
    with torch.no_grad():
        for k, v in overrides.items():
            own[k].copy_(v)


def _slotted_graph_batch(slot_graphs, n_slots: int, max_nodes: int,
                         max_edges: int, subkeys,
                         build_band_adj: bool = False,
                         build_tile_adj: bool = False) -> GraphBatch:
    """``batch_graphs``, but graph k lands in text-row slot
    ``slot_graphs[k][0]``; empty slots are masked."""
    ordered = [g for _, g in slot_graphs]
    if build_band_adj or build_tile_adj:
        max_nodes = align_to_tile(max_nodes)
    b = batch_graphs(ordered, n_slots, max_nodes, max_edges, subkeys,
                     build_band_adj=build_band_adj,
                     build_tile_adj=build_tile_adj)
    remap = np.zeros(max(len(ordered), 1), np.int32)
    graph_mask = np.zeros(n_slots, bool)
    graph_ids = np.full(n_slots, -1, np.int32)
    old_ids = b.graph_ids.numpy()
    for k, (row, _) in enumerate(slot_graphs):
        remap[k] = row
        graph_mask[row] = True
        graph_ids[row] = int(old_ids[k])
    # The band and tile adjacencies depend only on senders/receivers,
    # which the slot remap leaves untouched. The remapped node_graph stays
    # non-decreasing (keyed by the mask) where the slots ascend with k.
    return dataclasses.replace(
        b, node_graph=torch.from_numpy(remap[b.node_graph.numpy()]),
        graph_mask=torch.from_numpy(graph_mask),
        graph_ids=torch.from_numpy(graph_ids),
        node_graph_sorted=b.node_graph_sorted and bool(
            np.all(np.diff(remap[:len(ordered)]) > 0)))


def text_graph_batches(
    data: Mapping[str, np.ndarray], indices: np.ndarray, batch_size: int,
    graphs_by_id: Optional[Mapping[int, Mapping]] = None, subkeys=None,
    graph_budget: Optional[Dict[str, int]] = None,
    shuffle_rng: Optional[np.random.Generator] = None, pad_id: int = 1,
    build_band_adj: bool = False, build_tile_adj: bool = False,
) -> Iterable[TextBatch]:
    """Fixed-size text batches, each joined with its graphs. The final
    short batch is padded with masked rows (pad ids, label 0, index -1)
    so shapes stay static."""
    order = np.array(indices)
    if shuffle_rng is not None:
        order = shuffle_rng.permutation(order)
    for start in range(0, len(order), batch_size):
        sel = order[start:start + batch_size]
        pad = batch_size - len(sel)
        ids = np.concatenate([
            data["input_ids"][sel],
            np.full((pad,) + data["input_ids"].shape[1:], pad_id, np.int32)])
        labels = np.concatenate([data["labels"][sel], np.zeros(pad, np.int32)])
        index = np.concatenate([data["index"][sel],
                                np.full(pad, -1, np.int64)])
        mask = np.concatenate([np.ones(len(sel), bool), np.zeros(pad, bool)])
        gbatch = None
        if graphs_by_id is not None:
            budget = graph_budget or {}
            max_nodes = budget.get("max_nodes", batch_size * 64)
            max_edges = budget.get("max_edges", batch_size * 64 * 4)
            slots = []
            nodes = edges = 0
            for row, ex_id in enumerate(index):
                g = graphs_by_id.get(int(ex_id))
                if g is None:
                    mask[row] = False  # no graph, no loss
                    continue
                n = int(g["num_nodes"])
                e = len(g["senders"]) + n  # + self loops
                if nodes + n > max_nodes or edges + e > max_edges:
                    # Shuffling regroups batches each epoch, so a budget
                    # that held before can overflow now: degrade like a
                    # missing graph instead of aborting training.
                    logger.warning("graph for example %d dropped: batch over "
                                   "budget (%d+%d/%d nodes)", int(ex_id),
                                   nodes, n, max_nodes)
                    mask[row] = False
                    continue
                nodes += n
                edges += e
                slots.append((row, g))
            gbatch = _slotted_graph_batch(slots, batch_size, max_nodes,
                                          max_edges, subkeys, build_band_adj,
                                          build_tile_adj)
        n_missing = int((index >= 0).sum() - mask.sum())
        yield TextBatch(ids, labels, mask, index, gbatch, n_missing)


def _on_device(batch: TextBatch, device: torch.device):
    return (torch.from_numpy(batch.input_ids).to(device),
            torch.from_numpy(batch.labels).to(device),
            torch.from_numpy(batch.example_mask).to(device),
            None if batch.graphs is None else batch.graphs.to(device))


def make_text_train_step(model: TextModel, optimizer: torch.optim.Optimizer,
                         cfg: TransformerTrainConfig,
                         generator: Optional[torch.Generator] = None
                         ) -> Callable:
    """``step(batch, lr) -> (loss, stats)``: one clipped AdamW update at
    learning rate ``lr`` on a host :class:`TextBatch`, dropout on (its
    seeds from the CPU ``generator``); loss and counts stay on the
    device. The clip sees the parameters that train."""
    params = [p for p in model.parameters() if p.requires_grad]
    device = next(model.parameters()).device

    def step(batch: TextBatch, lr: float):
        ids, labels, mask, graphs = _on_device(batch, device)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        logits = model(ids, graphs, deterministic=False, generator=generator)
        loss = cross_entropy_loss(logits, labels, mask)
        loss.backward()
        clip_by_global_norm_(params, cfg.grad_clip_norm)
        optimizer.step()
        probs = torch.softmax(logits.detach(), dim=-1)[:, 1]
        return loss.detach(), binary_stats(probs, labels.float(), mask)

    return step


def make_text_eval_step(model: TextModel) -> Callable:
    """``step(batch) -> (loss, probs)`` under ``torch.inference_mode()``
    (the forward kernels only)."""
    device = next(model.parameters()).device

    def step(batch: TextBatch):
        ids, labels, mask, graphs = _on_device(batch, device)
        with torch.inference_mode():
            logits = model(ids, graphs, deterministic=True)
            loss = cross_entropy_loss(logits, labels, mask)
            probs = torch.softmax(logits, dim=-1)[:, 1]
        return loss, probs

    return step


def evaluate_text(eval_step: Callable, data: Mapping[str, np.ndarray],
                  indices: np.ndarray, cfg: TransformerTrainConfig,
                  graphs_by_id=None, subkeys=None, graph_budget=None,
                  pad_id: int = 1, build_band_adj: bool = False,
                  build_tile_adj: bool = False) -> Dict[str, Any]:
    """Loss (the mean over batches), metrics and per-example
    probabilities over ``indices`` in ``cfg.eval_batch_size`` batches."""
    stats = None
    losses = []
    probs_all, labels_all, index_all = [], [], []
    num_missing = 0
    for batch in text_graph_batches(
            data, indices, cfg.eval_batch_size, graphs_by_id, subkeys,
            graph_budget, pad_id=pad_id, build_band_adj=build_band_adj,
            build_tile_adj=build_tile_adj):
        num_missing += batch.n_missing
        loss, probs = eval_step(batch)
        p = probs.cpu()
        m = batch.example_mask
        bstats = binary_stats(p, torch.from_numpy(batch.labels).float(),
                              torch.from_numpy(m))
        stats = bstats if stats is None else stats + bstats
        probs_all.append(p.numpy()[m])
        labels_all.append(batch.labels[m])
        index_all.append(batch.index[m])
        losses.append(loss)
    if stats is None:
        stats = BinaryStats.zeros("cpu")
    if num_missing:
        logger.info("eval: %d examples missing graphs (masked)", num_missing)
    return {
        "loss": (float(torch.stack(losses).mean()) if losses else 0.0),
        "metrics": {k: float(v) for k, v in compute_metrics(stats).items()},
        "probs": np.concatenate(probs_all) if probs_all else np.zeros(0),
        "labels": np.concatenate(labels_all) if labels_all else np.zeros(0),
        "index": (np.concatenate(index_all) if index_all
                  else np.zeros(0, np.int64)),
        "num_missing": num_missing,
    }


def fit_text(model: TextModel, data: Mapping[str, np.ndarray],
             splits: Mapping[str, np.ndarray],
             cfg: TransformerTrainConfig = TransformerTrainConfig(),
             graphs_by_id: Optional[Mapping[int, Mapping]] = None,
             subkeys=None, graph_budget: Optional[Dict[str, int]] = None,
             pad_id: Optional[int] = None,
             init_params: Optional[Mapping[str, torch.Tensor]] = None,
             freeze_submodules: Tuple[str, ...] = (),
             checkpointer=None) -> Tuple[TrainState, Dict[str, Any]]:
    """Fine-tune ``model`` in place, keeping the best state by
    validation F1.

    Returns ``(best_state, history)``; the model keeps the last epoch's
    weights (load ``best_state.params`` for the best). Each epoch record
    holds the reference's keys plus ``step_losses`` (read once, at the
    epoch's end).

    ``init_params``: a ``state_dict`` fragment merged over the model's
    init. ``pad_id``: the id padding rows get (None: the model's).
    ``freeze_submodules``: top-level submodule names (e.g.
    ``("flowgnn",)``) left untrained; they stay frozen
    (``requires_grad`` False) after the fit. ``checkpointer``: a
    ``CheckpointManager`` that gets ``last`` (and the periodic snapshot)
    each epoch and ``best`` on improvement."""
    if cfg.anomaly_policy not in ("raise", "rollback"):
        raise ValueError(f"anomaly_policy must be 'raise' or 'rollback', "
                         f"got {cfg.anomaly_policy!r}")
    # ceil: the padded partial batch is a real step the schedule covers.
    steps_per_epoch = max(-(-len(splits["train"]) // cfg.batch_size), 1)
    schedule = make_schedule(cfg, steps_per_epoch * cfg.max_epochs)
    graph_cfg = model.graph_config
    if pad_id is None:
        pad_id = model.pad_token_id
    build_band_adj = graph_cfg is not None and graph_cfg.uses_band_adj
    build_tile_adj = graph_cfg is not None and graph_cfg.uses_tile_adj
    device = next(model.parameters()).device
    if init_params is not None:
        _merge_params(model, init_params)
    for name in freeze_submodules:
        getattr(model, name).requires_grad_(False)
    optimizer = make_text_optimizer(model.parameters(), cfg)
    train_step = make_text_train_step(
        model, optimizer, cfg, torch.Generator().manual_seed(cfg.seed))
    eval_step = make_text_eval_step(model)
    detect_anomaly = cfg.detect_anomaly or cfg.anomaly_policy == "rollback"
    anomaly_budget = cfg.anomaly_retry_budget
    history: Dict[str, Any] = {"epochs": [], "best_epoch": -1,
                               "best_val_f1": -1.0}
    steps = 0
    best_state = _snapshot(model, optimizer, steps)
    rng = np.random.default_rng(cfg.seed)
    kw = dict(graphs_by_id=graphs_by_id, subkeys=subkeys,
              graph_budget=graph_budget, pad_id=pad_id,
              build_band_adj=build_band_adj, build_tile_adj=build_tile_adj)
    for epoch in range(cfg.max_epochs):
        t0 = time.time()
        epoch_start = (_snapshot(model, optimizer, steps) if detect_anomaly
                       else None)
        stats = BinaryStats.zeros(device)
        loss_sum = torch.zeros((), device=device)
        step_losses: List[torch.Tensor] = []
        n_batches = num_missing = 0
        for batch in text_graph_batches(data, splits["train"],
                                        cfg.batch_size, shuffle_rng=rng,
                                        **kw):
            num_missing += batch.n_missing
            loss, bstats = train_step(batch, schedule(steps))
            steps += 1
            loss_sum = loss_sum + loss
            stats = stats + bstats
            step_losses.append(loss)
            n_batches += 1
        epoch_loss = float(loss_sum)
        rolled_back = False
        if detect_anomaly and not math.isfinite(epoch_loss):
            if cfg.anomaly_policy != "rollback":
                raise FloatingPointError(f"non-finite loss in epoch {epoch}")
            if anomaly_budget <= 0:
                raise FloatingPointError(
                    f"non-finite loss in epoch {epoch} (anomaly retry "
                    "budget exhausted)")
            anomaly_budget -= 1
            rolled_back = True
            history["anomaly_rollbacks"] = history.get("anomaly_rollbacks",
                                                       0) + 1
            logger.warning("non-finite loss in epoch %d: rolling back to the "
                           "epoch-start state and continuing (%d retries "
                           "left)", epoch, anomaly_budget)
            _restore(model, optimizer, epoch_start)
            steps = epoch_start.step
        val = evaluate_text(eval_step, data, splits["val"], cfg, **kw)
        record = {
            "epoch": epoch,
            "train_loss": epoch_loss / max(n_batches, 1),
            "train_metrics": {k: float(v)
                              for k, v in compute_metrics(stats).items()},
            "val_loss": val["loss"],
            "val_metrics": val["metrics"],
            "num_missing": num_missing,
            "seconds": time.time() - t0,
            "step_losses": (torch.stack(step_losses).tolist()
                            if step_losses else []),
        }
        if rolled_back:
            record["rolled_back"] = True
        history["epochs"].append(record)
        logger.info("epoch %d train_loss %.4f val_f1 %.4f (%.1fs)", epoch,
                    record["train_loss"], val["metrics"]["f1"],
                    record["seconds"])
        if checkpointer is not None:
            live = _live_state(model, optimizer, steps)
            checkpointer.save_last(live, epoch)
            checkpointer.maybe_save_periodic(live, epoch)
        if val["metrics"]["f1"] > history["best_val_f1"]:
            history["best_val_f1"] = val["metrics"]["f1"]
            history["best_epoch"] = epoch
            best_state = _snapshot(model, optimizer, steps)
            if checkpointer is not None:
                checkpointer.save_best(
                    best_state, epoch,
                    metrics={"val_f1": val["metrics"]["f1"]})
        elif (cfg.early_stop_patience is not None
              and epoch - history["best_epoch"] >= cfg.early_stop_patience):
            logger.info("early stop at epoch %d (best %d)", epoch,
                        history["best_epoch"])
            history["early_stopped"] = True
            break
    return best_state, history
