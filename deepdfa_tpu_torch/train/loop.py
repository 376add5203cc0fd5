"""Training loop for FlowGNN (port of ``deepdfa_tpu/train/loop.py``).

AdamW (lr 1e-3, weight decay 1e-2: ``optax.adamw``'s decoupled decay,
which ``torch.optim.AdamW`` computes), BCE-with-logits with an optional
positive weight, per-epoch undersampling (``data/sampling.py``), best
state by validation loss, and the non-finite-loss guard
(``anomaly_policy`` "raise" or "rollback") at ``log_every`` windows.

The loss, the confusion counts and the first non-finite step accumulate
on the device and are read once a window and once an epoch, never every
step. One process, one device: the model's. With ``message_impl``
"fused" or "persistent" on CUDA, the forward and the backward of the
gated steps are the hand-written kernels of ``ops/fused_gnn.py``; with
"tile", each step's aggregate and its VJP are the block-sparse kernel
of ``ops/tile_spmm.py``.

With a ``checkpointer`` (or ``TrainConfig.checkpoint_dir``) ``fit``
snapshots the trainer state at the reference's points: ``best`` when the
validation loss improves, then ``last`` and the periodic snapshot every
epoch (``train/checkpoint.py``). ``resume=True`` continues at epoch
granularity from the newest intact snapshot; the data order comes from
``(seed, epoch)``, so a resumed run repeats the uninterrupted run's
later epochs.

Not ported yet: the mesh and multi-host paths, step-granular (preempt)
resume, the preemption lifecycle and fleet drain, telemetry spans, fault
injection hooks and TensorBoard (ROADMAP.md, section A).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepdfa_tpu_torch.core.config import DataConfig, TrainConfig, subkeys_for
from deepdfa_tpu_torch.core.metrics import BinaryStats, binary_stats, compute_metrics
from deepdfa_tpu_torch.data.sampling import epoch_indices
from deepdfa_tpu_torch.graphs.batch import (
    GraphBatch,
    batch_iterator,
    graph_label_from_nodes,
)
from deepdfa_tpu_torch.models.flowgnn import FlowGNN
from deepdfa_tpu_torch.ops.tile_spmm import align_to_tile
from deepdfa_tpu_torch.train.checkpoint import (
    CheckpointError,
    make_checkpoint_manager,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    """A snapshot: optimizer steps taken, a copy of the model's
    ``state_dict`` and of the optimizer's."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]


@dataclasses.dataclass
class EvalResult:
    loss: float
    metrics: Dict[str, float]
    probs: np.ndarray
    labels: np.ndarray
    graph_ids: np.ndarray


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor,
                    positive_weight: Optional[float] = None) -> torch.Tensor:
    """Masked mean BCE-with-logits; ``positive_weight`` scales the
    positive term like ``BCEWithLogitsLoss(pos_weight=...)``."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    w_pos = 1.0 if positive_weight is None else positive_weight
    per = -(w_pos * labels * log_p + (1.0 - labels) * log_not_p)
    m = mask.float()
    return torch.sum(per * m) / torch.clamp(torch.sum(m), min=1.0)


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: TrainConfig) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay)``: decoupled decay on every
    parameter, biases and embeddings included. The optional global-norm
    clip is :func:`clip_by_global_norm_`, applied by the train step."""
    return torch.optim.AdamW(params, lr=cfg.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def clip_by_global_norm_(params: Iterable[torch.nn.Parameter],
                         max_norm: float) -> None:
    """``optax.clip_by_global_norm``, in place on the gradients: below
    ``max_norm`` they stay as they are, otherwise each becomes
    ``g / norm * max_norm``. (``torch.nn.utils.clip_grad_norm_`` scales
    by ``max_norm / (norm + 1e-6)`` instead.) No host read."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class MissingDataflowBits(ValueError, NotImplementedError):
    """A dataflow label style met a batch without ``df_in``/``df_out``
    bits. A ValueError, as the reference raises; also the
    NotImplementedError that the port raised for these styles before it
    built dataflow batches, so a caller catching that still does."""


def _labels_for(model: FlowGNN, batch: GraphBatch
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels, mask) per the configured label style.

    ``dataflow_solution_in/out`` train against per-node
    reaching-definitions bits (``df_in``/``df_out``, batches built with
    ``with_dataflow``). The "in" style also cuts the loss and metrics to
    definition nodes (a nonzero abstract-dataflow index on any subkey),
    the reference's ``cut_nodef``.
    """
    style = model.config.label_style
    if style == "graph":
        return graph_label_from_nodes(batch), batch.graph_mask
    if style == "node":
        return batch.node_vuln.float(), batch.node_mask
    if style in ("dataflow_solution_in", "dataflow_solution_out"):
        sol = batch.node_df_in if style.endswith("_in") else batch.node_df_out
        if sol is None:
            raise MissingDataflowBits(
                f"label_style {style!r} needs batches built with "
                "with_dataflow=True (examples carrying df_in/df_out bits)")
        mask = batch.node_mask
        if style.endswith("_in"):
            is_def = torch.zeros_like(mask)
            for f in batch.node_feats.values():
                is_def = is_def | (f != 0)
            mask = mask & is_def
        return sol.float(), mask
    raise NotImplementedError(f"label_style {style!r}")


def make_train_step(model: FlowGNN, optimizer: torch.optim.Optimizer,
                    cfg: TrainConfig) -> Callable:
    """``step(batch) -> (loss, stats)``: one AdamW step on ``batch`` (on
    the model's device); the loss and counts stay on the device."""
    params = list(model.parameters())

    def step(batch: GraphBatch):
        model.train()
        labels, mask = _labels_for(model, batch)
        optimizer.zero_grad(set_to_none=True)
        logits = model(batch)
        loss = bce_with_logits(logits, labels, mask, cfg.positive_weight)
        loss.backward()
        if cfg.grad_clip_norm:
            clip_by_global_norm_(params, cfg.grad_clip_norm)
        optimizer.step()
        stats = binary_stats(torch.sigmoid(logits.detach()), labels, mask)
        return loss.detach(), stats

    return step


def make_eval_step(model: FlowGNN, cfg: TrainConfig) -> Callable:
    """``step(batch) -> (loss, probs, labels, mask)`` under
    ``torch.inference_mode()`` (the forward kernels only)."""

    def step(batch: GraphBatch):
        model.eval()
        labels, mask = _labels_for(model, batch)
        with torch.inference_mode():
            logits = model(batch)
            loss = bce_with_logits(logits, labels, mask, cfg.positive_weight)
            probs = torch.sigmoid(logits)
        return loss, probs, labels, mask

    return step


def _batches(examples: List[dict], indices: np.ndarray, data_cfg: DataConfig,
             subkeys, batch_size: int, build_band_adj: bool = False,
             build_tile_adj: bool = False,
             with_dataflow: bool = False) -> Iterable[GraphBatch]:
    """Pack ``examples[indices]`` greedily into padded host batches of
    ``batch_size`` graph slots (a band or tile batch's node budget
    aligned to the tile), as the reference's single-shard ``_batches``;
    ``with_dataflow`` carries the dataflow-solution bits."""
    chosen = [examples[i] for i in indices]
    budget_nodes = batch_size * data_cfg.max_nodes_per_graph
    budget_edges = budget_nodes * data_cfg.max_edges_per_node
    if build_band_adj or build_tile_adj:
        budget_nodes = align_to_tile(budget_nodes)
    return batch_iterator(chosen, batch_size, budget_nodes, budget_edges,
                          subkeys, build_band_adj=build_band_adj,
                          build_tile_adj=build_tile_adj,
                          with_dataflow=with_dataflow)


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def evaluate(eval_step: Callable, examples: List[dict], indices: np.ndarray,
             data_cfg: DataConfig, subkeys, device,
             build_band_adj: bool = False,
             build_tile_adj: bool = False,
             with_dataflow: bool = False) -> EvalResult:
    """Loss, metrics and per-example probabilities over
    ``examples[indices]`` in ``data_cfg.eval_batch_size`` batches. The
    loss sums on the device and is read once."""
    loss_sum = torch.zeros((), device=device)
    n_batches = 0
    stats = BinaryStats.zeros(device)
    probs_all, labels_all, ids_all = [], [], []
    for batch in _batches(examples, indices, data_cfg, subkeys,
                          data_cfg.eval_batch_size, build_band_adj,
                          build_tile_adj, with_dataflow):
        graph_ids = batch.graph_ids.numpy()
        node_graph = batch.node_graph.numpy()
        loss, probs, labels, mask = eval_step(batch.to(device))
        m = mask.cpu().numpy()
        probs_all.append(probs.cpu().numpy()[m])
        labels_all.append(labels.cpu().numpy()[m])
        # ids 1:1 with probs: per graph, or the owning graph's per node.
        ids_all.append(graph_ids[m] if m.shape == graph_ids.shape
                       else graph_ids[node_graph][m])
        stats = stats + binary_stats(probs, labels, mask)
        loss_sum = loss_sum + loss
        n_batches += 1
    return EvalResult(
        loss=float(loss_sum) / max(n_batches, 1),
        metrics={k: float(v) for k, v in compute_metrics(stats).items()},
        probs=np.concatenate(probs_all) if probs_all else np.zeros(0),
        labels=np.concatenate(labels_all) if labels_all else np.zeros(0),
        graph_ids=(np.concatenate(ids_all) if ids_all
                   else np.zeros(0, np.int64)),
    )


def _snapshot(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
              step: int) -> TrainState:
    return TrainState(
        step=step,
        params={k: v.detach().clone() for k, v in model.state_dict().items()},
        opt_state=copy.deepcopy(optimizer.state_dict()))


def _live_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                step: int) -> TrainState:
    """The current state without copies, for a snapshot written at once
    (the checkpointer copies it to the host)."""
    return TrainState(step=step, params=model.state_dict(),
                      opt_state=optimizer.state_dict())


def _restore(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
             state: TrainState) -> None:
    model.load_state_dict(state.params)
    optimizer.load_state_dict(state.opt_state)


def _resume(checkpointer, candidate: str, model: torch.nn.Module,
            optimizer: torch.optim.Optimizer, device, history: Dict[str, Any],
            best_state: TrainState) -> Tuple[int, int, TrainState]:
    """Restore ``candidate`` (verified, with fallback) into ``model`` and
    ``optimizer``: ``(start_epoch, steps, best_state)``, and the best
    epoch and loss from the meta into ``history``. Every snapshot
    damaged: log it and start from scratch."""
    meta = checkpointer.best_meta
    try:
        state = TrainState(**checkpointer.restore(candidate,
                                                  map_location=device))
    except CheckpointError:
        logger.exception("resume: no intact snapshot under %s; restarting "
                         "from scratch", checkpointer.directory)
        return 0, 0, best_state
    _restore(model, optimizer, state)
    restored = dict(checkpointer.last_restored)
    history["resumed_from"] = restored
    if candidate != "last":
        logger.warning("resume: no 'last' snapshot on disk; resuming from "
                       "%s (epoch %d)", candidate, restored["epoch"])
    if restored["epoch"] < 0:
        logger.warning("resume: checkpoint dir has a snapshot but no epoch "
                       "record in meta.json — restarting the epoch schedule "
                       "at 0 on top of the restored weights")
    start_epoch = restored["epoch"] + 1
    if restored["fallback"]:
        logger.warning("resume: restored fallback snapshot %s; restarting "
                       "at epoch %d", restored["name"], start_epoch)
    history["best_epoch"] = int(meta.get("best_epoch", -1))
    history["best_val_loss"] = float(meta.get("best_val_loss",
                                              float("inf")))
    best_state = state
    if checkpointer.has("best"):
        try:
            best_state = TrainState(**checkpointer.restore(
                "best", map_location=device))
        except CheckpointError:
            logger.exception("resume: no intact 'best' snapshot; tracking "
                             "best from the restored state")
    logger.info("resuming from epoch %d (best val_loss %.4f @ epoch %d)",
                start_epoch, history["best_val_loss"], history["best_epoch"])
    return start_epoch, state.step, best_state


class _AnomalyGuard:
    """Non-finite-loss handling at window granularity (one window =
    ``log_every`` steps, where the host reads anyway). "raise" fails at
    the first offending step; "rollback" restores the window-start state
    and accumulators (the window's batches are skipped, not replayed), at
    most ``anomaly_retry_budget`` times a fit."""

    def __init__(self, train_cfg: TrainConfig):
        self.policy = train_cfg.anomaly_policy
        self.active = train_cfg.detect_anomaly or self.policy == "rollback"
        self.budget = train_cfg.anomaly_retry_budget

    def check(self, epoch: int, bad_step: torch.Tensor,
              history: Dict[str, Any]) -> bool:
        """True when the window must roll back; raises per the policy."""
        if not self.active:
            return False
        first = int(bad_step)
        if first < 0:
            return False
        if self.policy != "rollback":
            raise FloatingPointError(
                f"non-finite loss at epoch {epoch} step {first}")
        if self.budget <= 0:
            raise FloatingPointError(
                f"non-finite loss at epoch {epoch} step {first} "
                "(anomaly retry budget exhausted)")
        self.budget -= 1
        history["anomaly_rollbacks"] = history.get("anomaly_rollbacks", 0) + 1
        logger.warning(
            "non-finite loss at epoch %d step %d: rolling back to the last "
            "good state and skipping the window (%d retries left)",
            epoch, first, self.budget)
        return True


def fit(model: FlowGNN, examples: List[dict], splits: Dict[str, np.ndarray],
        train_cfg: TrainConfig = TrainConfig(),
        data_cfg: DataConfig = DataConfig(), log_every: int = 50,
        on_epoch_end: Optional[Callable[[int, Dict[str, Any]], bool]] = None,
        checkpointer=None, resume: bool = False,
        ) -> Tuple[TrainState, Dict[str, Any]]:
    """Train ``model`` in place to ``max_epochs``, tracking the best state
    by validation loss.

    Returns ``(best_state, history)``; the model keeps the last epoch's
    weights (load ``best_state.params`` for the best). Each epoch
    record holds the reference's keys plus ``step_losses``, the epoch's
    per-step losses (read from the device once, at the epoch's end).
    ``on_epoch_end(epoch, record) -> bool``: True stops training
    (``history["early_stopped"]``).

    ``checkpointer``: a ``CheckpointManager``; built from
    ``train_cfg.checkpoint_dir`` and ``checkpoint_every_epochs`` when
    None. ``resume=True`` restores its newest intact snapshot (model,
    optimizer, step count) and continues at the epoch after it, with
    ``best_epoch``/``best_val_loss`` from its meta and the best state
    from ``best``; ``history["epochs"]`` then holds only the resumed
    epochs and ``history["resumed_from"]`` what was loaded. With no
    intact snapshot it logs that and starts from scratch.
    """
    if train_cfg.anomaly_policy not in ("raise", "rollback"):
        raise ValueError(
            f"anomaly_policy must be 'raise' or 'rollback', "
            f"got {train_cfg.anomaly_policy!r}")
    subkeys = subkeys_for(model.config.feature)
    use_band = model.config.uses_band_adj
    use_tile = model.config.uses_tile_adj
    use_df = model.config.label_style.startswith("dataflow_solution")
    device = _device_of(model)
    optimizer = make_optimizer(model.parameters(), train_cfg)
    train_step = make_train_step(model, optimizer, train_cfg)
    eval_step = make_eval_step(model, train_cfg)
    guard = _AnomalyGuard(train_cfg)

    labels = [int(ex["label"]) for ex in examples]
    history: Dict[str, Any] = {"epochs": [], "best_epoch": -1,
                               "best_val_loss": float("inf")}
    steps = 0
    best_state = _snapshot(model, optimizer, steps)
    if checkpointer is None and train_cfg.checkpoint_dir:
        checkpointer = make_checkpoint_manager(
            train_cfg.checkpoint_dir,
            periodic_every=train_cfg.checkpoint_every_epochs)
    start_epoch = 0
    candidate = (checkpointer.resume_candidate(include_preempt=False)
                 if resume and checkpointer is not None else None)
    if candidate is not None:
        start_epoch, steps, best_state = _resume(
            checkpointer, candidate, model, optimizer, device, history,
            best_state)
    for epoch in range(start_epoch, train_cfg.max_epochs):
        # Fresh undersample + reshuffle every epoch.
        train_idx = splits["train"]
        idx = epoch_indices(
            [labels[i] for i in train_idx], epoch, seed=data_cfg.seed,
            undersample_factor=data_cfg.undersample_factor,
            oversample_factor=data_cfg.oversample_factor)
        t0 = time.time()
        stats = BinaryStats.zeros(device)
        loss_sum = torch.zeros((), device=device)
        bad_step = torch.full((), -1, dtype=torch.int64, device=device)
        step_losses: List[torch.Tensor] = []
        n_batches = seen = 0
        epoch_rolled = False
        # Window-start state for a rollback (copied only when the guard
        # is on: torch state is mutable, so a reference would not do).
        window = ((_snapshot(model, optimizer, steps), loss_sum, stats,
                   n_batches) if guard.active else None)
        for batch in _batches(examples, train_idx[idx], data_cfg, subkeys,
                              data_cfg.batch_size, use_band, use_tile,
                              use_df):
            loss, bstats = train_step(batch.to(device))
            steps += 1
            if guard.active:
                bad_step = torch.where(
                    (bad_step < 0) & ~torch.isfinite(loss),
                    torch.full_like(bad_step, seen), bad_step)
            loss_sum = loss_sum + loss
            stats = stats + bstats
            step_losses.append(loss)
            n_batches += 1
            seen += 1
            if seen % log_every == 0:
                if guard.check(epoch, bad_step, history):
                    snap, loss_sum, stats, n_batches = window
                    _restore(model, optimizer, snap)
                    steps = snap.step
                    del step_losses[n_batches:]
                    bad_step = torch.full_like(bad_step, -1)
                    epoch_rolled = True
                else:
                    logger.info("epoch %d step %d loss %.4f", epoch, seen,
                                float(loss))
                if guard.active:
                    window = (_snapshot(model, optimizer, steps), loss_sum,
                              stats, n_batches)
        if guard.check(epoch, bad_step, history):
            snap, loss_sum, stats, n_batches = window
            _restore(model, optimizer, snap)
            steps = snap.step
            del step_losses[n_batches:]
            epoch_rolled = True
        # An epoch whose every window rolled back kept no batches.
        epoch_loss = (float("nan") if epoch_rolled and n_batches == 0
                      else float(loss_sum))
        train_metrics = {k: float(v)
                         for k, v in compute_metrics(stats).items()}
        val = evaluate(eval_step, examples, splits["val"], data_cfg, subkeys,
                       device, build_band_adj=use_band,
                       build_tile_adj=use_tile, with_dataflow=use_df)
        record = {
            "epoch": epoch,
            "train_loss": epoch_loss / max(n_batches, 1),
            "train_metrics": train_metrics,
            "val_loss": val.loss,
            "val_metrics": val.metrics,
            "seconds": time.time() - t0,
            "step_losses": (torch.stack(step_losses).tolist()
                            if step_losses else []),
        }
        if epoch_rolled:
            record["rolled_back"] = True
        history["epochs"].append(record)
        logger.info("epoch %d train_loss %.4f val_loss %.4f val_f1 %.4f "
                    "(%.1fs)", epoch, record["train_loss"], val.loss,
                    val.metrics["f1"], record["seconds"])
        if val.loss < history["best_val_loss"]:
            history["best_val_loss"] = val.loss
            history["best_epoch"] = epoch
            best_state = _snapshot(model, optimizer, steps)
            if checkpointer is not None:
                checkpointer.save_best(best_state, epoch, val.loss)
        if checkpointer is not None:
            live = _live_state(model, optimizer, steps)
            checkpointer.save_last(live, epoch)
            checkpointer.maybe_save_periodic(live, epoch)
        if (on_epoch_end is not None and on_epoch_end(epoch, record)
                and epoch < train_cfg.max_epochs - 1):
            history["early_stopped"] = True
            logger.info("on_epoch_end stopped the run at epoch %d", epoch)
            break
    return best_state, history
