"""Declarative SLOs: burn-rate monitoring over metric snapshots (port of
``deepdfa_tpu/telemetry/slo.py``).

One spec format, two evaluation surfaces:

* **Offline** — :func:`evaluate_report` checks a report dict (a trace
  report, or any dict of the same dotted shape) against the spec.
* **Live** — :class:`SLOMonitor` consumes periodic metric snapshots (the
  serve pump feeds it the registry and the fleet's stats once a second)
  and evaluates each objective as a *burn rate*: the fraction of
  observations inside ``window_s`` that violate the threshold. A rule
  breaches when its burn rate exceeds its error ``budget`` (default 0:
  one bad observation burns the whole budget, which is what
  ``compiles_after_warmup: 0`` means). Breaches emit ``slo.breach``
  events, bump ``slo_breach_total``, raise the ``slo_burning`` gauge and
  degrade ``/healthz``.

Spec format (JSON or dict)::

    {"slos": [
        {"metric": "compiles.after_warmup", "max": 0},
        {"metric": "serve.request_ms_p99",  "max": 2000.0},
        {"metric": "serve_latency_ms.p99",  "max": 0.25,
         "window_s": 60, "budget": 0.1},
        {"metric": "queue_depth",           "max": 128}
    ]}

``metric`` is a dotted path into whatever snapshot the surface is fed
(registry histograms expand, so ``serve_latency_ms.p99`` works). A
metric absent from the snapshot is skipped, not breached, unless
``"required": true``.
"""

from __future__ import annotations

import collections
import copy
import json
import math
import os
import time
from typing import Any, Deque, Dict, List, Mapping, Optional, Tuple

# Built-in specs, selectable by name anywhere a spec path is accepted.
# "smoke": zero programs built after warmup, zero telemetry drops, and a
# p99 bound generous enough for a shared CPU host (the real latency SLO
# is a deployment's; this one catches blowouts).
BUILTIN_SPECS: Dict[str, Dict[str, Any]] = {
    "smoke": {"slos": [
        {"metric": "compiles.after_warmup", "max": 0},
        {"metric": "telemetry_drops", "max": 0},
        {"metric": "serve.request_ms_p99", "max": 5000.0},
    ]},
    # Under injected faults: nothing dropped, and end-to-end latency.
    "chaos": {"slos": [
        {"metric": "telemetry_drops", "max": 0},
        {"metric": "serve.request_ms_p99", "max": 60000.0},
    ]},
}
BUILTIN_SPECS["default"] = BUILTIN_SPECS["smoke"]


def load_spec(spec: "str | Mapping[str, Any]") -> Dict[str, Any]:
    """A spec dict from a built-in name, a JSON file path, or a dict."""
    if isinstance(spec, Mapping):
        doc = dict(spec)
    elif spec in BUILTIN_SPECS:
        doc = copy.deepcopy(BUILTIN_SPECS[spec])
    elif os.path.exists(spec):
        with open(spec) as f:
            doc = json.load(f)
    else:
        raise ValueError(
            f"unknown SLO spec {spec!r} (a JSON file path or one of "
            f"{sorted(BUILTIN_SPECS)})"
        )
    rules = doc.get("slos")
    if not isinstance(rules, list) or not rules:
        raise ValueError("SLO spec must carry a non-empty 'slos' list")
    for rule in rules:
        if "metric" not in rule or ("max" not in rule and "min" not in rule):
            raise ValueError(
                f"each SLO needs 'metric' and 'max' (or 'min'): {rule!r}"
            )
    return doc


def lookup(values: Mapping[str, Any], dotted: str) -> Optional[float]:
    """Dotted-path numeric lookup (``serve.request_ms_p99``); None when
    any hop is missing or the leaf is not a number."""
    cur: Any = values
    for part in dotted.split("."):
        if not isinstance(cur, Mapping) or part not in cur:
            return None
        cur = cur[part]
    if isinstance(cur, bool) or not isinstance(cur, (int, float)):
        return None
    return float(cur)


def _violates(rule: Mapping[str, Any], value: float) -> bool:
    if "max" in rule and value > float(rule["max"]):
        return True
    if "min" in rule and value < float(rule["min"]):
        return True
    return False


def _threshold(rule: Mapping[str, Any]) -> float:
    return float(rule["max"] if "max" in rule else rule["min"])


def evaluate_report(report: Mapping[str, Any],
                    spec: "str | Mapping[str, Any]") -> Dict[str, Any]:
    """Offline gate: the spec against one report dict."""
    doc = load_spec(spec)
    breaches: List[Dict[str, Any]] = []
    skipped: List[str] = []
    checked = 0
    for rule in doc["slos"]:
        value = lookup(report, rule["metric"])
        if value is None:
            if rule.get("required"):
                breaches.append({"metric": rule["metric"], "value": None,
                                 "threshold": _threshold(rule),
                                 "reason": "required metric missing"})
            else:
                skipped.append(rule["metric"])
            continue
        checked += 1
        if _violates(rule, value):
            breaches.append({"metric": rule["metric"], "value": value,
                             "threshold": _threshold(rule)})
    return {"ok": not breaches, "checked": checked, "skipped": skipped,
            "breaches": breaches}


class SLOMonitor:
    """Burn-rate evaluation over a stream of metric snapshots.

    ``observe(values)`` records one snapshot and returns the rules that
    *newly* breached on it (each already emitted as an ``slo.breach``
    event). ``status()`` is the ``/healthz`` face: overall ok, currently
    burning metrics, and totals. Thread-safety: the serve pump is the
    single caller of ``observe``; ``status`` reads are tolerant of the
    races a snapshot view allows.
    """

    def __init__(self, spec: "str | Mapping[str, Any]",
                 clock=time.monotonic):
        self.spec = load_spec(spec)
        self._clock = clock
        # One deque[(t, violated)] and burn-state entry per *rule*, not
        # per metric: a spec may bound the same metric twice (max + min,
        # or two window/budget tiers) and their violation streams must
        # not mix.
        self._obs: List[Deque[Tuple[float, bool]]] = [
            collections.deque() for _ in self.spec["slos"]
        ]
        self._burning: Dict[int, Dict[str, Any]] = {}
        self.breaches_total = 0

    def observe(self, values: Mapping[str, Any]) -> List[Dict[str, Any]]:
        from deepdfa_tpu_torch import telemetry

        now = self._clock()
        new_breaches: List[Dict[str, Any]] = []
        for i, rule in enumerate(self.spec["slos"]):
            metric = rule["metric"]
            value = lookup(values, metric)
            if value is None:
                continue
            window_s = float(rule.get("window_s", 60.0))
            budget = float(rule.get("budget", 0.0))
            # A nonzero budget is a *fraction*: it means nothing until at
            # least 1/budget observations exist — otherwise one flaky
            # sample reads as a 100% burn. Zero-budget rules (the
            # compiles-after-warmup class) stay single-observation.
            min_obs = int(rule.get("min_obs") or (
                1 if budget <= 0.0 else min(math.ceil(1.0 / budget), 100)))
            obs = self._obs[i]
            obs.append((now, _violates(rule, value)))
            while obs and obs[0][0] < now - window_s:
                obs.popleft()
            bad = sum(1 for _, v in obs if v)
            burn_rate = bad / len(obs)
            if burn_rate > budget and len(obs) >= min_obs:
                breach = {"metric": metric, "value": value,
                          "threshold": _threshold(rule),
                          "burn_rate": round(burn_rate, 4),
                          "budget": budget, "window_s": window_s}
                if i not in self._burning:
                    # Transition into breach: one event per episode, not
                    # one per polling tick.
                    self.breaches_total += 1
                    telemetry.event("slo.breach", **breach)
                    telemetry.REGISTRY.counter("slo_breach_total").inc()
                    new_breaches.append(breach)
                self._burning[i] = breach
            elif i in self._burning:
                del self._burning[i]
                telemetry.event("slo.recovered", metric=metric)
        telemetry.REGISTRY.gauge("slo_burning").set(len(self._burning))
        return new_breaches

    def status(self) -> Dict[str, Any]:
        burning = list(self._burning.values())
        return {"ok": not burning, "burning": burning,
                "breaches_total": self.breaches_total}
