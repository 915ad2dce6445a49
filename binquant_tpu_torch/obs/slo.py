"""Unified SLO registry + the machine-readable verdict plane.

Port of ``binquant_tpu/obs/slo.py``, the one place every service-level
objective registers:

* :class:`SloRegistry` — named SLOs (``freshness``, ``staleness``,
  ``delivery.<sink>``) behind ONE burn/recover hysteresis model: a failing
  observation force-emits ``slo_burn`` on burn ENTRY, re-emits at the
  ``event_every`` cadence while burning (a multi-tick outage must not
  flood one event per observation), and the first clean observation emits
  ``slo_recover`` with the burn length. The per-plane events keep firing
  either way: the registry is an additional, uniform judging surface.

* **invariants** — registered callables probing pass/fail facts that are
  not rate-like (the delivery plane's zero-loss and zero-duplicate
  contracts, breaker state). A probe that crashes reads as FAILED, never
  as green.

* :func:`slo_verdict` — folds every registered SLO plus every invariant
  into one machine-readable pass/fail JSON, served live at
  ``GET /debug/slo``.

The registry is observation-driven (the owning monitors call
:meth:`SloRegistry.observe` from their existing paths): it adds no
per-tick dispatch of its own.
"""

from __future__ import annotations

from typing import Any, Callable

from binquant_tpu_torch.obs.events import get_event_log
from binquant_tpu_torch.obs.instruments import (
    SLO_BREACHES,
    SLO_BURNING,
    SLO_RECOVERIES,
)


class SloRegistry:
    """Named SLOs + invariants behind one burn/recover event model."""

    def __init__(self, enabled: bool = True, event_every: int = 256) -> None:
        self.enabled = bool(enabled)
        self.event_every = max(int(event_every), 1)
        self._slos: dict[str, dict] = {}
        self._invariants: dict[str, Callable[[], Any]] = {}
        # drill-phase window: while set, observations tally
        # into per-phase windows and burn/recover events carry the label
        self.phase: str | None = None
        # mid-run invariant probes: failures LATCH — a
        # transient violation that self-heals before shutdown must not
        # read as a clean verdict
        self._probes_run = 0
        self._probe_failures: dict[str, int] = {}

    # -- registration ---------------------------------------------------------

    def register(
        self, name: str, kind: str, budget: float, unit: str = "ms"
    ) -> dict:
        """Register (or re-parameterize) one SLO; returns its state cell.
        Re-registering keeps the burn state — a config reload must not
        reset an in-progress burn."""
        slo = self._slos.get(name)
        if slo is None:
            slo = {
                "kind": kind,
                "budget": float(budget),
                "unit": unit,
                "observations": 0,
                "breaches": 0,
                "recoveries": 0,
                "burning": False,
                "burn_obs": 0,
                "last": {},
            }
            self._slos[name] = slo
        else:
            slo["kind"] = kind
            slo["budget"] = float(budget)
            slo["unit"] = unit
        return slo

    def ensure(
        self, name: str, kind: str, budget: float, unit: str = "ms"
    ) -> dict:
        """``register`` that never re-parameterizes an existing SLO —
        for observers that discover their subjects lazily (one delivery
        SLO per sink, minted on the first ack)."""
        slo = self._slos.get(name)
        return slo if slo is not None else self.register(
            name, kind, budget, unit=unit
        )

    def add_invariant(self, name: str, probe: Callable[[], Any]) -> None:
        """Register one pass/fail probe. ``probe()`` returns a dict with
        at least ``ok`` (extra keys ride into the verdict verbatim) or a
        bare truthy/falsy value."""
        self._invariants[name] = probe

    def begin_phase(self, phase: str | None) -> None:
        """Stamp subsequent observations and burn/recover events with a
        drill-phase window label (the soak judge's attribution surface;
        ``None`` turns stamping back off)."""
        self.phase = str(phase) if phase is not None else None

    # -- observations (burn/recover hysteresis) -------------------------------

    def observe(self, name: str, ok: bool, **detail: Any) -> None:
        """One observation against a registered SLO. Unregistered names
        are ignored — monitors observe unconditionally; which SLOs exist
        is the wiring layer's decision."""
        if not self.enabled:
            return
        slo = self._slos.get(name)
        if slo is None:
            return
        slo["observations"] += 1
        if detail:
            slo["last"] = detail
        if self.phase is not None:
            window = slo.setdefault("phases", {}).setdefault(
                self.phase, {"observations": 0, "breaches": 0}
            )
            window["observations"] += 1
            if not ok:
                window["breaches"] += 1
        stamp = {"phase": self.phase} if self.phase is not None else {}
        if not ok:
            slo["breaches"] += 1
            slo["burn_obs"] += 1
            SLO_BREACHES.labels(slo=name).inc()
            entering = not slo["burning"]
            slo["burning"] = True
            SLO_BURNING.labels(slo=name).set(1)
            if entering or slo["burn_obs"] % self.event_every == 0:
                # force-emit on burn ENTRY, then at the sampling cadence
                # (the IngestHealthMonitor pattern — a sustained outage
                # must not flood one event per failing observation).
                # Reserved event fields win over same-named detail keys
                # (observe_digest passes its own `budget`) — an observer's
                # detail vocabulary must never crash the registry.
                get_event_log().emit(
                    "slo_burn",
                    **{
                        **detail,
                        **stamp,
                        "slo": name,
                        "kind": slo["kind"],
                        "budget": slo["budget"],
                        "unit": slo["unit"],
                        "burn_obs": slo["burn_obs"],
                        "entering": entering,
                    },
                )
        else:
            if slo["burning"]:
                slo["recoveries"] += 1
                SLO_RECOVERIES.labels(slo=name).inc()
                get_event_log().emit(
                    "slo_recover",
                    **{
                        **detail,
                        **stamp,
                        "slo": name,
                        "kind": slo["kind"],
                        "burn_obs": slo["burn_obs"],
                    },
                )
            slo["burning"] = False
            slo["burn_obs"] = 0
            SLO_BURNING.labels(slo=name).set(0)

    # -- the verdict ----------------------------------------------------------

    def invariants_report(self) -> dict[str, dict]:
        """Run every probe; a crashing probe reads FAILED (a broken
        integrity check must never read as passing)."""
        out: dict[str, dict] = {}
        for name, probe in self._invariants.items():
            try:
                result = probe()
            except Exception as exc:
                out[name] = {"ok": False, "error": repr(exc)}
                continue
            if isinstance(result, dict):
                result.setdefault("ok", False)
                out[name] = result
            else:
                out[name] = {"ok": bool(result)}
        return out

    def probe_invariants(self) -> dict[str, dict]:
        """Mid-run invariant probe cadence: run every probe
        NOW and LATCH any failure into the registry. ``verdict()`` alone
        probes only at read time — a transient zero-loss violation that
        self-heals before shutdown would read as a clean verdict. A
        failing mid-run probe also emits ``invariant_probe_failed``
        (phase-stamped) so a concurrent judge can attribute it."""
        report = self.invariants_report()
        if not self.enabled:
            return report
        self._probes_run += 1
        for name, result in report.items():
            if not result.get("ok", False):
                self._probe_failures[name] = (
                    self._probe_failures.get(name, 0) + 1
                )
                get_event_log().emit(
                    "invariant_probe_failed",
                    invariant=name,
                    probe=self._probes_run,
                    **(
                        {"phase": self.phase}
                        if self.phase is not None
                        else {}
                    ),
                    detail={k: v for k, v in result.items() if k != "ok"},
                )
        return report

    def verdict(self) -> dict:
        """THE machine-readable pass/fail JSON: every SLO's burn state +
        every invariant probe, folded into one top-level ``ok``. A
        disabled registry verdicts ``ok: None`` — neither a false green
        nor a false alarm. Failures latched by a mid-run
        :meth:`probe_invariants` cadence keep the fold red even after the
        probed fact self-heals."""
        if not self.enabled:
            return {"enabled": False, "ok": None, "slos": {}, "invariants": {}}
        slos = {}
        for name, slo in self._slos.items():
            cell = {
                "ok": not slo["burning"],
                "kind": slo["kind"],
                "budget": slo["budget"],
                "unit": slo["unit"],
                "burning": slo["burning"],
                "burn_obs": slo["burn_obs"],
                "observations": slo["observations"],
                "breaches": slo["breaches"],
                "recoveries": slo["recoveries"],
                "last": dict(slo["last"]),
            }
            if slo.get("phases"):
                cell["phases"] = {
                    ph: dict(w) for ph, w in slo["phases"].items()
                }
            slos[name] = cell
        invariants = self.invariants_report()
        ok = (
            all(s["ok"] for s in slos.values())
            and all(inv.get("ok", False) for inv in invariants.values())
            and not self._probe_failures
        )
        out = {
            "enabled": True,
            "ok": ok,
            "slos": slos,
            "invariants": invariants,
        }
        if self._probes_run:
            out["probes"] = {
                "runs": self._probes_run,
                "failures": dict(self._probe_failures),
            }
        return out

    def snapshot(self) -> dict:
        """The ``GET /debug/slo`` payload (and the /healthz ``slo``
        section): the verdict plus the registry's own config."""
        out = self.verdict()
        out["event_every"] = self.event_every
        return out


def slo_verdict(registry: SloRegistry | None) -> dict:
    """The one verdict entrypoint drills/harnesses call: tolerates an
    engine without a registry wired (plane off) the same way a disabled
    registry reads — ``ok: None``, never a false green."""
    if registry is None:
        return {"enabled": False, "ok": None, "slos": {}, "invariants": {}}
    return registry.verdict()
