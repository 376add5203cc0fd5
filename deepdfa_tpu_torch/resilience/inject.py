"""Seeded, declarative fault injection (port of
``deepdfa_tpu/resilience/inject.py``).

A *fault plan* is a JSON document describing faults to fire at named
*sites* of the code:

.. code-block:: json

    {"seed": 0, "faults": [
      {"site": "serve.batch",       "kind": "raise", "at": 0},
      {"site": "lifecycle.preempt", "kind": "kill",  "at": 3}
    ]}

Spec fields:

``site``
    Which hook fires it. The port's instrumented sites and their index
    semantics:

    ========================  =================================================
    ``serve.batch``           on the host before each serving micro-batch
                              replays; index = flush ordinal
    ``lifecycle.preempt``     ``resilience/lifecycle.poll``; index = poll
                              ordinal. ANY matching non-raising kind is
                              treated as a simulated preemption notice
                              (the stand-in for a real SIGTERM)
    ========================  =================================================

    The reference's training, checkpoint, ETL and scan sites, and its
    helpers that act on their faults (``corrupt_loss``, ``corrupt_path``,
    ``tear_snapshot``), come with the port of those layers; a plan naming
    those sites arms without error.
``kind``
    ``raise`` (throw ``exc``), ``nan`` (poison a loss), ``corrupt`` /
    ``truncate`` (damage a snapshot file), ``kill`` / ``hang`` (child
    process faults), ``delay`` (sleep ``seconds`` at the site: a pure
    latency fault, the work completes late). Sites ignore kinds they
    don't understand.
``at`` / ``every`` / ``p``
    Match conditions on the spec's occurrence index: exact index, a
    period, or a probability drawn from the plan's seeded RNG. With none
    given the spec matches every occurrence.
``times``
    Maximum number of fires (default 1 for exact/unconditional specs,
    unlimited for ``every``/``p`` specs). Exhausted specs go inert.
``exc`` / ``msg`` / ``name``
    Exception type name for ``raise`` (resolved from builtins, default
    :class:`FaultError`), message, and the snapshot-name filter for
    checkpoint faults.

Arming: programmatically (``install(plan)`` / ``clear()`` / the
``armed`` context manager) or via the environment:
``DEEPDFA_FAULT_PLAN`` holding either inline JSON or a path to a JSON
file, loaded once per process; its per-spec counters then evolve with
the process, so the same plan on the same code path fires the same
faults. Forked workers inherit a copy of the armed plan: plans for forked
sites should match on the caller's index (``at``).

With no plan armed every hook is a cheap no-op (one None check), so the
instrumentation stays on the serving path.
"""

from __future__ import annotations

import builtins
import contextlib
import dataclasses
import json
import logging
import os
import random
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

ENV_VAR = "DEEPDFA_FAULT_PLAN"

KINDS = ("raise", "nan", "corrupt", "truncate", "kill", "hang", "delay")


class FaultError(RuntimeError):
    """Default exception for injected ``raise`` faults."""


@dataclasses.dataclass
class FaultSpec:
    site: str
    kind: str
    at: Optional[int] = None
    every: Optional[int] = None
    p: Optional[float] = None
    times: Optional[int] = None
    exc: str = "FaultError"
    msg: str = ""
    name: Optional[str] = None
    seconds: float = 0.05  # delay-kind sleep
    # runtime state
    seen: int = 0   # filter-passing occurrences of this spec's site
    fired: int = 0  # times this spec actually fired

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {KINDS})")
        if self.times is None:
            # Exact-index and unconditional specs are one-shot by default;
            # periodic/probabilistic specs keep firing.
            self.times = 1 if (self.every is None and self.p is None) else 0

    def exhausted(self) -> bool:
        return bool(self.times) and self.fired >= self.times

    def matches(self, idx: int, rng: random.Random) -> bool:
        if self.at is not None and idx != self.at:
            return False
        if self.every is not None and idx % self.every != 0:
            return False
        if self.p is not None and rng.random() >= self.p:
            return False
        return True

    def exception(self) -> BaseException:
        cls: Any = FaultError
        if self.exc and self.exc != "FaultError":
            cand = getattr(builtins, self.exc, None)
            if isinstance(cand, type) and issubclass(cand, BaseException):
                cls = cand
            else:
                logger.warning("fault plan names unknown exception %r; "
                               "raising FaultError", self.exc)
        return cls(self.msg or
                   f"injected fault at {self.site} (occurrence {self.seen})")


class FaultPlan:
    """A parsed plan plus its per-spec runtime counters."""

    def __init__(self, faults: Sequence[FaultSpec], seed: int = 0):
        import threading

        self.faults = list(faults)
        self.seed = seed
        self.rng = random.Random(seed)
        # Sites may fire from concurrent threads (one serve pump a
        # replica); the counter read-modify-write must be exact or an
        # ``at`` spec can double-fire or skip. Actions (sleep/raise) stay
        # outside the lock.
        self._lock = threading.Lock()

    @classmethod
    def from_doc(cls, doc: Dict) -> "FaultPlan":
        fields = {f.name for f in dataclasses.fields(FaultSpec)
                  if f.name not in ("seen", "fired")}
        specs = []
        for raw in doc.get("faults", []):
            unknown = set(raw) - fields
            if unknown:
                raise ValueError(
                    f"fault spec {raw!r}: unknown field(s) {sorted(unknown)}"
                )
            specs.append(FaultSpec(**raw))
        return cls(specs, seed=int(doc.get("seed", 0)))

    @classmethod
    def from_source(cls, source: str) -> "FaultPlan":
        """Inline JSON (starts with ``{``) or a path to a JSON file — the
        ``DEEPDFA_FAULT_PLAN`` formats."""
        text = source.strip()
        if not text.startswith("{"):
            with open(text, encoding="utf-8") as f:
                text = f.read()
        return cls.from_doc(json.loads(text))

    def fire(self, site: str, index: Optional[int] = None,
             **ctx: Any) -> Tuple[FaultSpec, ...]:
        """Advance counters; raise any matching ``raise``/``hang`` fault,
        return the other matching specs for the caller to act on."""
        hits: List[FaultSpec] = []
        with self._lock:
            for spec in self.faults:
                if spec.site != site or spec.exhausted():
                    continue
                want_name = spec.name
                if want_name is not None and ctx.get("name") != want_name:
                    continue
                idx = index if index is not None else spec.seen
                spec.seen += 1
                if spec.matches(idx, self.rng):
                    spec.fired += 1
                    hits.append(spec)
                    # Every fired fault is a trace event BEFORE it acts (a
                    # `raise` fault must still appear in events.jsonl).
                    from deepdfa_tpu_torch import telemetry

                    telemetry.event("fault.fired", site=site,
                                    kind=spec.kind, index=idx,
                                    seed=self.seed)
        for spec in hits:
            if spec.kind == "delay":
                # Pure latency: the site's work still runs — afterwards,
                # and late enough to blow a p99 SLO.
                import time

                time.sleep(spec.seconds)
            if spec.kind == "raise":
                raise spec.exception()
            if spec.kind == "hang":
                # A real hang would stall the caller until its own read
                # deadline; surfacing the deadline's TimeoutError directly
                # keeps tests fast while exercising the same recovery path.
                raise TimeoutError(
                    spec.msg or f"injected hang at {site} "
                                f"(occurrence {spec.seen - 1})")
        return tuple(hits)

    def report(self) -> List[Dict]:
        return [
            {"site": s.site, "kind": s.kind, "seen": s.seen, "fired": s.fired}
            for s in self.faults
        ]


# ---------------------------------------------------------------------------
# Process-global arming
# ---------------------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None
_ENV_CHECKED = False
# Guards writes to the arming pair: active() runs inside every fire()
# call, from any thread, and its lazy env arming must not race
# install()/clear(). Reads stay lock-free; only writers serialize.
_ARM_LOCK = threading.Lock()


def install(plan: FaultPlan) -> FaultPlan:
    global _PLAN, _ENV_CHECKED
    with _ARM_LOCK:
        _PLAN = plan
        _ENV_CHECKED = True
    from deepdfa_tpu_torch import telemetry

    telemetry.event("fault.armed", specs=len(plan.faults), seed=plan.seed)
    return plan


def clear() -> None:
    global _PLAN, _ENV_CHECKED
    with _ARM_LOCK:
        _PLAN = None
        _ENV_CHECKED = True


def active() -> Optional[FaultPlan]:
    global _PLAN, _ENV_CHECKED
    if _PLAN is None and not _ENV_CHECKED:
        with _ARM_LOCK:
            if _PLAN is None and not _ENV_CHECKED:
                _ENV_CHECKED = True
                raw = os.environ.get(ENV_VAR)
                if raw:
                    _PLAN = FaultPlan.from_source(raw)
                    logger.warning("fault plan armed from %s (%d specs)",
                                   ENV_VAR, len(_PLAN.faults))
    return _PLAN


@contextlib.contextmanager
def armed(plan: FaultPlan):
    """Arm ``plan`` for the duration of the block, restoring the previous
    arming state after (the test entry point)."""
    global _PLAN, _ENV_CHECKED
    with _ARM_LOCK:
        prev, prev_checked = _PLAN, _ENV_CHECKED
    install(plan)
    try:
        yield plan
    finally:
        with _ARM_LOCK:
            _PLAN, _ENV_CHECKED = prev, prev_checked


# ---------------------------------------------------------------------------
# Site hooks (the instrumented-code API)
# ---------------------------------------------------------------------------


def fire(site: str, index: Optional[int] = None,
         **ctx: Any) -> Tuple[FaultSpec, ...]:
    """The hook call: no-op unless a plan is armed. May raise (``raise``/
    ``hang`` faults); returns matching non-raising specs otherwise."""
    plan = active()
    if plan is None:
        return ()
    return plan.fire(site, index, **ctx)
