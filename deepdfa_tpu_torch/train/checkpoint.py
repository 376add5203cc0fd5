"""Snapshots of a training run (port of ``deepdfa_tpu/train/checkpoint.py``,
its synchronous ``CheckpointManager``).

The contract is the reference's:

* ``best`` (by validation loss, or by a named metric), ``last`` and a
  periodic ``epoch_<N>`` snapshot every ``periodic_every`` epochs.
* ``meta.json`` is committed atomically (tmp file, fsync, ``os.replace``,
  fsync of the directory), with the reference's fields: ``best_epoch``,
  ``best_val_loss``, ``last_epoch``, ``best_metrics`` and
  ``snapshots: {name: {epoch, sha256}}``. A corrupt ``meta.json``
  degrades to defaults with a warning.
* Each snapshot's content digest (:func:`snapshot_checksum`, the same
  algorithm, so one directory gives one hex digest in both packages) is
  checked on restore; a damaged snapshot falls back to the newest intact
  one, in the order: the requested name, then by descending epoch, ties
  ``last`` > ``preempt_E_S`` > ``epoch_N`` > ``best``. ``last_restored``
  says what was loaded.

The format is torch's own: a snapshot is the directory ``<run>/<name>/``
holding ``state.pt``, written by ``torch.save`` from CPU tensors and read
with ``torch.load(weights_only=True)``, so a snapshot written on the card
restores on the CPU. A trainer state is ``{"step", "params":
state_dict, "opt_state": optimizer.state_dict()}``; a params-only
snapshot is ``{"params": state_dict}``. The port cannot read the
reference's orbax snapshots.

Not ported (ROADMAP A6, A7): the asynchronous manager, preemption
snapshots (the ``preempt_E_S`` names still rank as in the reference),
sharded snapshots, ``redistribute``, ``set_host``, ``set_layout`` and the
fault-injection hooks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import re
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

_EPOCH_NAME_RE = re.compile(r"^epoch_(\d+)$")
_PREEMPT_NAME_RE = re.compile(r"^preempt_(\d+)_(\d+)$")

STATE_FILE = "state.pt"


class CheckpointError(RuntimeError):
    """No intact snapshot exists for a requested restore."""


def make_checkpoint_manager(directory: str, periodic_every: int = 25):
    """The manager the training loops use: the synchronous one (the
    port has no asynchronous writer)."""
    return CheckpointManager(directory, periodic_every=periodic_every)


def snapshot_checksum(path: str) -> str:
    """Content digest of one snapshot directory: sha256 over the sorted
    relative paths and file bytes."""
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames.sort()
        for fn in sorted(filenames):
            p = os.path.join(dirpath, fn)
            h.update(os.path.relpath(p, path).encode())
            h.update(b"\0")
            with open(p, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            h.update(b"\0")
    return h.hexdigest()


def _host_tree(tree: Any) -> Any:
    """``tree`` with every tensor on the CPU (a dataclass, such as the
    loops' ``TrainState``, becomes the dict of its fields)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return tree


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def load_encoder_params(full_params: Mapping[str, torch.Tensor],
                        drop_keys=("head", "pooling")
                        ) -> Dict[str, torch.Tensor]:
    """Partial load for encoder freezing: a FlowGNN ``state_dict``
    without the classification head and the pooling (``head.*``,
    ``pooling.*``), keeping the embeddings and the gated step
    (``embeds.*``, ``ggnn_step.*``), as the reference's
    ``load_encoder_params`` drops ``_head`` and ``pooling``."""
    drop = set(drop_keys)
    return {k: v for k, v in full_params.items()
            if k.split(".", 1)[0] not in drop}


class CheckpointManager:
    def __init__(self, directory: str, periodic_every: int = 25):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.periodic_every = periodic_every
        self._meta_path = os.path.join(self.directory, "meta.json")
        self._meta: Dict[str, Any] = {
            "best_epoch": -1, "best_val_loss": float("inf"),
            "last_epoch": -1,
        }
        # verify() digest cache: name -> (stat signature, sha256), so a
        # fallback that verifies a snapshot twice reads its bytes once.
        self._digest_cache: Dict[str, Tuple[Tuple, str]] = {}
        # What the latest restore actually loaded: {"name", "epoch",
        # "fallback"}.
        self.last_restored: Optional[Dict[str, Any]] = None
        if os.path.exists(self._meta_path):
            try:
                with open(self._meta_path) as f:
                    self._meta.update(json.load(f))
            except (json.JSONDecodeError, OSError, ValueError) as e:
                # The snapshots themselves may be fine: degrade to
                # defaults instead of refusing the run directory.
                logger.warning(
                    "corrupt meta.json in %s (%s); continuing with default "
                    "metadata — snapshot checksums are lost, restores of "
                    "pre-existing snapshots run unverified",
                    self.directory, e)

    # -- writes ------------------------------------------------------------

    def _write_bytes(self, path: str, state: Any) -> None:
        """Write ``state`` into ``path`` beside the old bytes, then swap
        it in: the old snapshot goes only once the new one is on disk."""
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(_host_tree(state), f)
            f.flush()
            os.fsync(f.fileno())
        old = path + ".old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(path):
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
        _fsync_dir(self.directory)

    def _save(self, name: str, state: Any, epoch: int) -> None:
        """Write the snapshot and record its checksum in the in-memory
        meta; the caller commits meta.json once."""
        path = os.path.join(self.directory, name)
        self._write_bytes(path, state)
        digest = snapshot_checksum(path)
        self._meta.setdefault("snapshots", {})[name] = {
            "epoch": int(epoch), "sha256": digest}
        self._digest_cache[name] = (self._snapshot_sig(path), digest)

    def _write_meta(self) -> None:
        """Atomic: a reader sees the old meta or the new one, never a torn
        write, and the rename is durable before this returns."""
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path)
        _fsync_dir(self.directory)

    def save_best(self, state: Any, epoch: int,
                  val_loss: Optional[float] = None,
                  metrics: Optional[dict] = None) -> None:
        """``val_loss`` is the GNN trainer's selection quantity; a run
        that selects on something else (val F1) records it under its own
        name in ``metrics``."""
        self._save("best", state, epoch)
        self._meta["best_epoch"] = epoch
        if val_loss is not None:
            self._meta["best_val_loss"] = val_loss
        if metrics:
            self._meta["best_metrics"] = {k: float(v)
                                          for k, v in metrics.items()}
        self._write_meta()

    def save_last(self, state: Any, epoch: int) -> None:
        self._save("last", state, epoch)
        self._meta["last_epoch"] = epoch
        self._write_meta()

    def maybe_save_periodic(self, state: Any, epoch: int) -> None:
        if self.periodic_every and (epoch + 1) % self.periodic_every == 0:
            self._save(f"epoch_{epoch}", state, epoch)
            self._write_meta()

    # -- integrity ---------------------------------------------------------

    def has(self, name: str) -> bool:
        return os.path.isdir(os.path.join(self.directory, name))

    @staticmethod
    def _snapshot_sig(path: str) -> Tuple:
        """Sorted relative paths with sizes and mtimes: no file reads."""
        sig = []
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames.sort()
            for fn in sorted(filenames):
                p = os.path.join(dirpath, fn)
                st = os.stat(p)
                sig.append((os.path.relpath(p, path), st.st_size,
                            st.st_mtime_ns))
        return tuple(sig)

    def verify(self, name: str) -> bool:
        """True when the snapshot's content matches its recorded checksum.
        An unrecorded snapshot passes with a warning (nothing to verify
        against). The digest is cached per (name, stat signature)."""
        path = os.path.join(self.directory, name)
        if not os.path.isdir(path):
            return False
        record = self._meta.get("snapshots", {}).get(name)
        if record is None:
            logger.warning("snapshot %s has no recorded checksum; "
                           "restoring unverified", name)
            return True
        sig = self._snapshot_sig(path)
        cached = self._digest_cache.get(name)
        if cached is not None and cached[0] == sig:
            digest = cached[1]
        else:
            digest = snapshot_checksum(path)
            self._digest_cache[name] = (sig, digest)
        return digest == record["sha256"]

    def resume_candidate(self, include_preempt: bool = True) -> Optional[str]:
        """The snapshot a resume starts from: the newest on disk by epoch,
        ties ``last`` > ``preempt`` > ``epoch_N`` > ``best``; None when
        nothing is there. ``include_preempt=False`` skips ``preempt_*``."""
        order = self._fallback_order("")
        if not include_preempt:
            order = [n for n in order if not _PREEMPT_NAME_RE.match(n)]
        return order[0] if order else None

    def drain(self, timeout: Optional[float] = None) -> float:
        """No pending writes in a synchronous manager: a no-op, so call
        sites read as the reference's."""
        return 0.0

    def _snapshot_epoch(self, name: str) -> int:
        record = self._meta.get("snapshots", {}).get(name)
        if record is not None:
            return int(record["epoch"])
        m = _EPOCH_NAME_RE.match(name)
        if m:
            return int(m.group(1))
        m = _PREEMPT_NAME_RE.match(name)
        if m:
            return int(m.group(1))
        if name == "last":
            return int(self._meta.get("last_epoch", -1))
        if name == "best":
            return int(self._meta.get("best_epoch", -1))
        return -1

    def _fallback_order(self, requested: str) -> List[str]:
        """Requested name first, then every other on-disk snapshot by
        descending epoch (ties: last > preempt > epoch_N > best)."""
        on_disk = [
            d for d in sorted(os.listdir(self.directory))
            if os.path.isdir(os.path.join(self.directory, d))
            and (d in ("best", "last") or _EPOCH_NAME_RE.match(d)
                 or _PREEMPT_NAME_RE.match(d))
        ]
        pref = {"last": 0, "best": 3}

        def rank(name: str) -> Tuple:
            tie = pref.get(name, 1 if _PREEMPT_NAME_RE.match(name) else 2)
            m = _PREEMPT_NAME_RE.match(name)
            step = -int(m.group(2)) if m else 0
            return (-self._snapshot_epoch(name), tie, step, name)

        rest = sorted((d for d in on_disk if d != requested), key=rank)
        head = [requested] if requested in on_disk else []
        return head + rest

    def _resolve_intact(self, name: str) -> str:
        candidates = self._fallback_order(name)
        for cand in candidates:
            if self.verify(cand):
                if cand != name:
                    logger.error(
                        "snapshot %s failed integrity verification; falling "
                        "back to %s (epoch %d)", name, cand,
                        self._snapshot_epoch(cand))
                return cand
        raise CheckpointError(
            f"no intact snapshot under {self.directory} "
            f"(requested {name!r}, tried {candidates})")

    # -- reads -------------------------------------------------------------

    def _load(self, name: str, map_location) -> Dict[str, Any]:
        path = os.path.join(self.directory, name, STATE_FILE)
        return torch.load(path, map_location=map_location, weights_only=True)

    def _restored(self, used: str, requested: str) -> None:
        self.last_restored = {"name": used,
                              "epoch": self._snapshot_epoch(used),
                              "fallback": used != requested}

    def restore(self, name: str, map_location=None) -> Dict[str, Any]:
        """Verified restore of the saved tree (tensors on
        ``map_location``), falling back to the newest intact snapshot when
        the requested one is damaged; ``last_restored`` records what was
        loaded. A snapshot that was never written raises
        ``FileNotFoundError``: that is a caller's error, not damage."""
        if not self.has(name):
            raise FileNotFoundError(
                f"no checkpoint {name!r} under {self.directory}")
        candidates = self._fallback_order(name)
        last_err: Optional[Exception] = None
        for cand in candidates:
            if not self.verify(cand):
                logger.error("snapshot %s failed integrity verification; "
                             "trying the next fallback", cand)
                continue
            try:
                restored = self._load(cand, map_location)
            except Exception as e:
                # Checksums catch bit damage; this catches an unrecorded
                # snapshot whose bytes do not load.
                logger.warning("restore of snapshot %s failed (%s); trying "
                               "the next fallback", cand, e)
                last_err = e
                continue
            self._restored(cand, name)
            if cand != name:
                logger.error("restored fallback snapshot %s (epoch %d) in "
                             "place of %s", cand,
                             self.last_restored["epoch"], name)
            return restored
        raise CheckpointError(
            f"no intact snapshot under {self.directory} "
            f"(requested {name!r}, tried {candidates})") from last_err

    def restore_params(self, name: str = "best",
                       map_location=None) -> Dict[str, torch.Tensor]:
        """The model ``state_dict`` of a saved state, from either layout
        (a trainer state or ``{"params": ...}``): the inference path.
        Damaged snapshots fall back as in :meth:`restore`."""
        if not self.has(name):
            raise FileNotFoundError(
                f"no checkpoint {name!r} under {self.directory}")
        used = self._resolve_intact(name)
        self._restored(used, name)
        restored = self._load(used, map_location)
        params = restored.get("params") if isinstance(restored, dict) else None
        if not isinstance(params, dict):
            raise ValueError(
                f"checkpoint {os.path.join(self.directory, used)} holds no "
                "recognizable state_dict (expected a trainer state or a "
                "{'params': ...} tree)")
        return params

    @property
    def best_meta(self) -> dict:
        return dict(self._meta)
