"""Process-wide preemption lifecycle: SIGTERM, a typed notice, a graceful
drain (port of ``deepdfa_tpu/resilience/lifecycle.py`` up to ``poll``).

A scheduler that reclaims a machine delivers SIGTERM and a grace window,
then SIGKILL. This module turns that signal (or SIGINT, or a simulated
preemption fired through the fault plan) into one typed
:class:`PreemptionNotice` broadcast to the registered drain participants.
The port's participant is the HTTP server (``serve/http.serve_forever``):
lame-duck mode, where admission answers 503 with ``Retry-After``, the
batchers flush partially filled buckets at once, and every request
admitted before the notice is answered; then ``cli serve`` exits with
:data:`EXIT_PREEMPTED`.

* **The signal handler only sets a flag.** Handlers run between
  bytecodes on the main thread; blocking work there (I/O, locks, kernel
  launches) deadlocks or re-enters. The handler body is one attribute
  assignment; the notice is materialized on the main path (:func:`poll`)
  or by the monitor thread, whichever runs first.
* **A wedged drain can't eat the grace window.** On notice a hung-drain
  watchdog arms: participants heartbeat through
  :meth:`LifecycleCoordinator.beat` as they make progress; no beat
  inside the hang deadline, or a grace overrun, emits ``lifecycle.hang``
  with every thread's stack, runs the ``on_hang`` hooks and exits with
  :data:`EXIT_HANG`.
* **Everything is auditable.** ``lifecycle.notice`` /
  ``lifecycle.drain`` / ``lifecycle.hang`` / ``lifecycle.exit`` (and the
  engine's ``lifecycle.lame_duck``) events ride the telemetry run.

Knobs: ``DEEPDFA_DRAIN_GRACE_S`` (global grace budget, default 30 s) and
``DEEPDFA_HANG_DEADLINE_S`` (the watchdog's no-progress deadline inside
it, default half the grace). Per-participant deadlines are clamped
inside the global budget at registration.

Fault site: ``lifecycle.preempt``: any matching (non-raising) spec there
simulates a preemption notice, so a test drives the whole drain without
a real signal:

.. code-block:: json

    {"faults": [{"site": "lifecycle.preempt", "kind": "kill", "at": 7}]}

The reference's training half (``drain_with_beats``,
``preempt_snapshot_exit``) and its elastic-fleet drain (``FleetDrain``)
come with the port of those layers.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from deepdfa_tpu_torch import telemetry
from deepdfa_tpu_torch.resilience import inject

logger = logging.getLogger(__name__)

GRACE_ENV_VAR = "DEEPDFA_DRAIN_GRACE_S"
HANG_ENV_VAR = "DEEPDFA_HANG_DEADLINE_S"
DEFAULT_GRACE_S = 30.0

# Distinct exit codes, so orchestrators can tell
# a graceful preemption drain from a crash — and a watchdog-forced exit
# from a clean one. 75 is EX_TEMPFAIL ("try again later"), the
# conventional preemption posture.
EXIT_PREEMPTED = 75
EXIT_HANG = 76

# Monitor cadence: how often the daemon thread converts a pending signal
# flag into a notice when the main path isn't polling (a serve process
# blocked in its selector), and the watchdog check tick.
_MONITOR_TICK_S = 0.02


class Preempted(BaseException):
    """Raised by a training loop after it drained for a preemption notice
    (kept for the trainers' drain, which is not ported yet).

    Derives from BaseException on purpose: a preemption drain must unwind
    past ``except Exception`` recovery layers (retry wrappers, anomaly
    policies) that would otherwise swallow the exit. Carries what the
    caller needs to report and resume."""

    def __init__(self, notice: "PreemptionNotice", snapshot: Optional[str],
                 epoch: int, step: int, history: Optional[dict] = None):
        super().__init__(
            f"preempted ({notice.reason}) at epoch {epoch} step {step}; "
            f"snapshot {snapshot!r}"
        )
        self.notice = notice
        self.snapshot = snapshot
        self.epoch = epoch
        self.step = step
        self.history = history


@dataclasses.dataclass(frozen=True)
class PreemptionNotice:
    """One preemption notice: why, when, and how long the process has."""

    reason: str          # "SIGTERM" | "SIGINT" | "simulated"
    received_at: float   # time.monotonic() seconds
    grace_s: float       # global drain budget from receipt

    @property
    def deadline(self) -> float:
        return self.received_at + self.grace_s

    def remaining(self) -> float:
        return max(self.deadline - time.monotonic(), 0.0)


def grace_budget_s() -> float:
    """The global drain budget (``DEEPDFA_DRAIN_GRACE_S``)."""
    try:
        return max(float(os.environ.get(GRACE_ENV_VAR, DEFAULT_GRACE_S)),
                   0.1)
    except ValueError:
        return DEFAULT_GRACE_S


def hang_deadline_s(grace: float) -> float:
    """Watchdog no-progress deadline (``DEEPDFA_HANG_DEADLINE_S``,
    default half the grace budget): a drain that makes no heartbeat for
    this long is wedged, and waiting out the rest of the grace window
    would only convert a recoverable snapshot into a SIGKILL."""
    raw = os.environ.get(HANG_ENV_VAR)
    if raw:
        try:
            return max(float(raw), 0.05)
        except ValueError:
            pass
    return max(grace / 2.0, 0.05)


class Participant:
    """One registered drain participant.

    ``deadline_s`` is the per-component share of the global grace budget
    (clamped to it). ``on_notice`` runs on the monitor thread when the
    notice fires — use it for surfaces that block outside a step loop
    (the HTTP server); polling surfaces (train loops) ignore it.
    ``on_hang`` runs on the watchdog thread right before a forced exit —
    the emergency-snapshot hook."""

    def __init__(self, coordinator: "LifecycleCoordinator", name: str,
                 deadline_s: float,
                 on_notice: Optional[Callable[[PreemptionNotice], None]],
                 on_hang: Optional[Callable[[PreemptionNotice], None]]):
        self._coordinator = coordinator
        self.name = name
        self.deadline_s = deadline_s
        self.on_notice = on_notice
        self.on_hang = on_hang
        self.drain_started: Optional[float] = None
        self.drain_ms: Optional[float] = None
        self.drain_ok: Optional[bool] = None

    def beat(self) -> None:
        """Heartbeat: this participant is making drain progress."""
        self._coordinator.beat()

    def drained(self, ok: bool = True) -> None:
        """Mark this participant's drain complete (audited as a
        ``lifecycle.drain`` event carrying the measured duration)."""
        self._coordinator._mark_drained(self, ok)


class LifecycleCoordinator:
    """Converts SIGTERM/SIGINT (or a simulated notice) into one
    process-wide :class:`PreemptionNotice` broadcast to registered drain
    participants, and polices the drain with the hung-step watchdog.

    One instance per process (module-level :func:`coordinator`); tests
    build private instances with short budgets and a captured ``_exit``.
    """

    def __init__(self, grace_s: Optional[float] = None,
                 hang_s: Optional[float] = None,
                 _exit: Callable[[int], None] = os._exit):
        self._grace_s = grace_s
        self._hang_s = hang_s
        self._exit = _exit
        self._lock = threading.Lock()
        self._participants: List[Participant] = []
        # Written ONLY by the signal handler (a single attribute
        # assignment); consumed by poll()
        # on the main path or the monitor thread, whichever runs first.
        self._pending_signal: Optional[int] = None
        self._notice: Optional[PreemptionNotice] = None
        self._notice_event = threading.Event()
        self._last_beat = 0.0
        self._complete = threading.Event()
        self._installed: Dict[int, Any] = {}
        self._monitor: Optional[threading.Thread] = None
        self._watchdog: Optional[threading.Thread] = None
        self.hang_fired = False

    # -- signal plumbing ---------------------------------------------------

    def _handler(self, signum, frame) -> None:
        # Flag only. Anything heavier (locks, I/O, telemetry, launches)
        # in a signal handler can deadlock or re-enter.
        self._pending_signal = signum

    def install(self, signals: Tuple[int, ...] = (signal.SIGTERM,
                                                  signal.SIGINT)) -> bool:
        """Install the flag-setting handlers + the monitor thread.
        Idempotent; returns False (and stays uninstalled) when not on the
        main thread — ``signal.signal`` is main-thread-only."""
        if threading.current_thread() is not threading.main_thread():
            logger.warning("lifecycle: install skipped (not main thread)")
            return False
        with self._lock:
            for sig in signals:
                if sig not in self._installed:
                    self._installed[sig] = signal.signal(sig, self._handler)
        self._ensure_monitor()
        return True

    def uninstall(self) -> None:
        """Restore the previous handlers (bench/test hygiene)."""
        if threading.current_thread() is not threading.main_thread():
            return
        with self._lock:
            installed, self._installed = self._installed, {}
        for sig, prev in installed.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # interpreter teardown
                pass

    def _ensure_monitor(self) -> None:
        with self._lock:
            if self._monitor is not None and self._monitor.is_alive():
                return
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="lifecycle-monitor",
                daemon=True)
            self._monitor.start()

    def _monitor_loop(self) -> None:
        # Converts a pending signal flag into the notice for processes
        # whose main thread is blocked (serve's selector loop, a wedged
        # step). The main path's poll() usually wins the race; both
        # funnel through _materialize, which is idempotent.
        while not self._complete.is_set():
            pending = self._pending_signal
            if pending is not None and self._notice is None:
                self._materialize(_signal_name(pending))
            self._complete.wait(_MONITOR_TICK_S)

    # -- notice creation ---------------------------------------------------

    def _materialize(self, reason: str) -> PreemptionNotice:
        run_callbacks: List[Participant] = []
        created = False
        with self._lock:
            if self._notice is None:
                created = True
                grace = (self._grace_s if self._grace_s is not None
                         else grace_budget_s())
                self._notice = PreemptionNotice(
                    reason=reason, received_at=time.monotonic(),
                    grace_s=grace)
                self._last_beat = self._notice.received_at
                for p in self._participants:
                    p.drain_started = self._notice.received_at
                run_callbacks = list(self._participants)
        notice = self._notice
        if created:
            self._notice_event.set()
            logger.warning(
                "lifecycle: preemption notice (%s); draining %d "
                "participant(s) inside a %.1fs grace budget",
                notice.reason, len(run_callbacks), notice.grace_s)
            telemetry.event("lifecycle.notice", reason=notice.reason,
                            grace_s=notice.grace_s,
                            participants=[p.name for p in run_callbacks])
            # Armed even with no participants (library use without
            # registration): a wedged process must never outlive the
            # grace window silently.
            self._start_watchdog()
            for p in run_callbacks:
                if p.on_notice is not None:
                    try:
                        p.on_notice(notice)
                    except Exception:
                        logger.exception(
                            "lifecycle: %s on_notice failed", p.name)
        return notice

    def notify(self, reason: str = "simulated") -> PreemptionNotice:
        """Programmatic preemption notice: the simulated path and the
        fault plan's entry."""
        return self._materialize(reason)

    # -- the main-path hooks ----------------------------------------------

    def poll(self, index: Optional[int] = None) -> Optional[PreemptionNotice]:
        """The step-granularity check: cheap when nothing is pending (one
        flag read + the fault-site no-op). Fires the ``lifecycle.preempt``
        fault site — a matching spec simulates a preemption notice."""
        for _spec in inject.fire("lifecycle.preempt", index=index):
            # Any non-raising matching kind at this site IS the simulated
            # notice; which kind was used doesn't matter.
            return self.notify("simulated")
        pending = self._pending_signal
        if pending is not None and self._notice is None:
            return self._materialize(_signal_name(pending))
        return self._notice

    @property
    def notice(self) -> Optional[PreemptionNotice]:
        return self._notice

    def wait(self, timeout: Optional[float] = None) -> Optional[PreemptionNotice]:
        """Block until a notice exists (monitor-thread delivery)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._notice is None:
            if deadline is not None and time.monotonic() >= deadline:
                return None
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            self._notice_event.wait(min(_MONITOR_TICK_S,
                                        remaining or _MONITOR_TICK_S))
        return self._notice

    def beat(self) -> None:
        """Watchdog heartbeat: drain progress happened."""
        self._last_beat = time.monotonic()

    # -- participants ------------------------------------------------------

    def register(self, name: str,
                 on_notice: Optional[Callable[[PreemptionNotice], None]] = None,
                 on_hang: Optional[Callable[[PreemptionNotice], None]] = None,
                 deadline_s: Optional[float] = None) -> Participant:
        """Register a drain participant. ``deadline_s`` is clamped inside
        the global grace budget — a component can narrow its share, never
        widen the window."""
        grace = self._grace_s if self._grace_s is not None else grace_budget_s()
        share = grace if deadline_s is None else min(float(deadline_s), grace)
        p = Participant(self, name, share, on_notice, on_hang)
        with self._lock:
            self._participants.append(p)
            pending = self._notice
        if pending is not None:
            # Late registration during an active notice: deliver — on a
            # separate thread, never synchronously. A registrant whose
            # on_notice ultimately blocks on work the registering thread
            # hasn't started yet (serve_forever registers, THEN serves;
            # its callback calls server.shutdown(), which waits for
            # serve_forever to run) would otherwise deadlock the exact
            # drain this module exists to guarantee.
            p.drain_started = time.monotonic()
            if p.on_notice is not None:
                def _deliver():
                    try:
                        p.on_notice(pending)
                    except Exception:
                        logger.exception("lifecycle: %s on_notice failed",
                                         name)

                threading.Thread(target=_deliver,
                                 name=f"lifecycle-notify:{name}",
                                 daemon=True).start()
        return p

    def unregister(self, participant: Participant) -> None:
        with self._lock:
            if participant in self._participants:
                self._participants.remove(participant)

    def _mark_drained(self, participant: Participant, ok: bool) -> None:
        self.beat()
        now = time.monotonic()
        start = participant.drain_started
        if start is None and self._notice is not None:
            start = self._notice.received_at
        participant.drain_ms = ((now - start) * 1e3
                                if start is not None else 0.0)
        participant.drain_ok = ok
        telemetry.event("lifecycle.drain", participant=participant.name,
                        ok=ok, drain_ms=participant.drain_ms,
                        deadline_s=participant.deadline_s)
        telemetry.REGISTRY.histogram("lifecycle_drain_ms").observe(
            participant.drain_ms)
        with self._lock:
            pending = [p for p in self._participants
                       if p.drain_ok is None]
        if not pending and self._notice is not None:
            self.complete()

    def complete(self) -> None:
        """Declare the drain finished: the watchdog stands down."""
        if not self._complete.is_set():
            self._complete.set()
            if self._notice is not None:
                telemetry.event(
                    "lifecycle.exit", reason=self._notice.reason,
                    drain_s=time.monotonic() - self._notice.received_at)

    # -- the hung-step watchdog --------------------------------------------

    def _start_watchdog(self) -> None:
        with self._lock:
            if self._watchdog is not None and self._watchdog.is_alive():
                return
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="lifecycle-watchdog",
                daemon=True)
            self._watchdog.start()

    def _watchdog_loop(self) -> None:
        notice = self._notice
        if notice is None:
            return
        grace = notice.grace_s
        hang = (self._hang_s if self._hang_s is not None
                else hang_deadline_s(grace))
        while not self._complete.wait(_MONITOR_TICK_S):
            now = time.monotonic()
            silent = now - self._last_beat
            overrun = now - notice.received_at - grace
            if silent >= hang or overrun >= 0:
                why = "no_progress" if silent >= hang else "grace_exceeded"
                self._on_hang(notice, why, silent)
                return

    def _on_hang(self, notice: PreemptionNotice, why: str,
                 silent_s: float) -> None:
        """The forced-exit path: a wedged step/flush (or a drain that
        overran the grace budget) must still leave a durable snapshot and
        a diagnosable trace, then exit — never a wedged process that eats
        the whole window and gets SIGKILLed mid-write."""
        self.hang_fired = True
        stacks = _thread_stacks()
        logger.error(
            "lifecycle: hung drain (%s; %.2fs without progress) — forcing "
            "the snapshot/exit path.\n%s", why, silent_s,
            "\n".join(stacks.values()))
        telemetry.event("lifecycle.hang", reason=notice.reason, why=why,
                        silent_s=silent_s, stacks=list(stacks.values()))
        with self._lock:
            hooks = [p for p in self._participants if p.on_hang is not None]
        for p in hooks:
            try:
                p.on_hang(notice)
            except Exception:
                logger.exception("lifecycle: %s on_hang failed", p.name)
        telemetry.event("lifecycle.exit", reason=notice.reason,
                        forced=True,
                        drain_s=time.monotonic() - notice.received_at)
        try:
            telemetry.flush()
        except Exception:
            pass
        self._complete.set()
        self._exit(EXIT_HANG)


def _signal_name(signum: int) -> str:
    try:
        return signal.Signals(signum).name
    except ValueError:
        return f"signal_{signum}"


def _thread_stacks() -> Dict[str, str]:
    """One formatted stack per live thread — the lifecycle.hang payload
    that makes a wedged device diagnosable post-mortem."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, str] = {}
    for tid, frame in sys._current_frames().items():
        name = names.get(tid, f"tid-{tid}")
        out[name] = (f"--- thread {name} ---\n"
                     + "".join(traceback.format_stack(frame)))
    return out


# ---------------------------------------------------------------------------
# The process-wide instance
# ---------------------------------------------------------------------------

_COORDINATOR: Optional[LifecycleCoordinator] = None
_COORD_LOCK = threading.Lock()


def coordinator() -> LifecycleCoordinator:
    """THE process-wide coordinator (created lazily; signal handlers are
    installed only by explicit :meth:`LifecycleCoordinator.install` —
    importing this module never touches signal state)."""
    global _COORDINATOR
    with _COORD_LOCK:
        if _COORDINATOR is None:
            _COORDINATOR = LifecycleCoordinator()
        return _COORDINATOR


def reset(instance: Optional[LifecycleCoordinator] = None) -> None:
    """Swap the process-wide coordinator (tests/bench). Uninstalls the
    old one's handlers."""
    global _COORDINATOR
    with _COORD_LOCK:
        old, _COORDINATOR = _COORDINATOR, instance
    if old is not None:
        old.complete()
        old.uninstall()


def fresh() -> LifecycleCoordinator:
    """A fresh process-wide coordinator for a new CLI command: clears any
    consumed notice from a previous in-process invocation (tests drive
    ``cli.main`` repeatedly in one process) and installs the SIGTERM/
    SIGINT handlers when on the main thread."""
    reset(LifecycleCoordinator())
    co = coordinator()
    co.install()
    return co


def poll(index: Optional[int] = None) -> Optional[PreemptionNotice]:
    """Module-level step check (the loops' one-liner): cheap no-op when
    no coordinator exists, no plan is armed, and no signal landed."""
    co = _COORDINATOR
    if co is None:
        # Without a live coordinator the fault site must still work: a
        # plan arming lifecycle.preempt expects the simulated notice
        # machinery end to end.
        if inject.active() is None:
            return None
        co = coordinator()
    return co.poll(index)
