"""Resilience: deterministic fault injection and the preemption
lifecycle (port of ``deepdfa_tpu/resilience``).

* ``inject`` — the seeded, declarative fault plan (``DEEPDFA_FAULT_PLAN``
  or ``install``/``armed``) and the ``fire`` hook the instrumented sites
  call (``serve.batch``, ``lifecycle.preempt``).
* ``lifecycle`` — SIGTERM/SIGINT (or a simulated notice) becomes a typed
  ``PreemptionNotice`` broadcast to the registered drain participants
  under a global grace budget, policed by the hung-drain watchdog;
  ``cli serve`` lame-ducks, answers what it admitted and exits
  ``EXIT_PREEMPTED`` (75).

The reference's chaos soak (``chaos.py``) and elastic training
(``elastic.py``) are not ported.
"""

from deepdfa_tpu_torch.resilience.inject import (  # noqa: F401
    ENV_VAR,
    FaultError,
    FaultPlan,
    FaultSpec,
    armed,
    clear,
    fire,
    install,
)
