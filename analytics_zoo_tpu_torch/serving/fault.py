"""Deterministic fault injection for the serving fleet: a config-declared
schedule of faults (pump kill or crash, a raising or frozen step, an
allocation-failure storm, dropped or delayed handoffs) fired at exact
tick or handoff counts by a thread-safe :class:`FaultInjector`.

A copy of ``analytics_zoo_tpu/serving/fault.py`` (stdlib only).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["FAULT_KINDS", "FaultSpec", "FaultInjector", "InjectedFault",
           "parse_faults"]

FAULT_KINDS: Tuple[str, ...] = (
    "kill_pump", "crash_pump", "raise_step", "freeze_tick",
    "alloc_storm", "drop_handoff", "delay_handoff")

#: Kinds triggered by a replica-local tick counter.
_TICK_KINDS = frozenset({"kill_pump", "crash_pump", "raise_step",
                         "freeze_tick", "alloc_storm"})
#: Kinds triggered by the fleet-wide handoff sequence number.
_HANDOFF_KINDS = frozenset({"drop_handoff", "delay_handoff"})


class InjectedFault(RuntimeError):
    """Raised by an armed ``raise_step`` / ``crash_pump`` fault — a
    distinct type so tests and log readers can tell injected chaos
    from organic failures."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault, as plain data (see module docstring for
    the kinds and which trigger field each reads)."""

    kind: str
    replica: int = 0
    #: Engine-tick trigger (live engines / pumps count busy ticks).
    at_tick: Optional[int] = None
    #: Virtual-time trigger (the simulator's ``FleetModel``).
    at_t: Optional[float] = None
    #: Fleet-wide handoff sequence trigger (0-based; ``None`` = the
    #: next handoff after the spec arms).
    at_handoff: Optional[int] = None
    #: ``alloc_storm``: storm length in ticks; ``drop/delay_handoff``:
    #: how many deliveries to affect.
    count: int = 1
    #: ``freeze_tick``: sleep length; ``delay_handoff``: added latency.
    duration_s: float = 0.0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultSpec":
        if not isinstance(d, dict):
            raise TypeError(f"fault spec must be a dict, got {type(d)}")
        kind = d.get("kind")
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(choose from {FAULT_KINDS})")
        unknown = set(d) - {"kind", "replica", "at_tick", "at_t",
                            "at_handoff", "count", "duration_s"}
        if unknown:
            raise ValueError(f"unknown fault spec fields {sorted(unknown)}")
        spec = cls(
            kind=kind, replica=int(d.get("replica", 0)),
            at_tick=(None if d.get("at_tick") is None
                     else int(d["at_tick"])),
            at_t=(None if d.get("at_t") is None else float(d["at_t"])),
            at_handoff=(None if d.get("at_handoff") is None
                        else int(d["at_handoff"])),
            count=int(d.get("count", 1)),
            duration_s=float(d.get("duration_s", 0.0)))
        if spec.count < 1:
            raise ValueError(f"fault count must be >= 1, got {spec.count}")
        if spec.kind in _TICK_KINDS and spec.at_tick is None \
                and spec.at_t is None:
            raise ValueError(
                f"{kind!r} needs at_tick (live) or at_t (sim)")
        return spec


def parse_faults(specs: Optional[Sequence[Any]]) -> List[FaultSpec]:
    """Validate a config-level fault schedule (a list of dicts, or
    already-built :class:`FaultSpec` instances) into specs.  ``None``
    / empty parses to an empty schedule — injection off."""
    out: List[FaultSpec] = []
    for s in specs or ():
        out.append(s if isinstance(s, FaultSpec)
                   else FaultSpec.from_dict(s))
    return out


class _Armed:
    """Mutable firing state for one spec."""

    __slots__ = ("spec", "remaining")

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.remaining = spec.count


class FaultInjector:
    """Deterministic fault scheduler for one fleet (see module
    docstring).  ``seed`` is carried for schedule provenance (bundles
    record it) — firing order itself is fully determined by the
    schedule, never sampled."""

    def __init__(self, specs: Optional[Sequence[Any]] = None,
                 seed: int = 0):
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._armed = [_Armed(s) for s in parse_faults(specs)]
        self._ticks: Dict[int, int] = {}    # replica -> busy ticks seen
        self._handoffs = 0                  # fleet-wide handoff seq
        self.fired: List[Tuple[str, Dict[str, Any]]] = []

    @property
    def enabled(self) -> bool:
        return bool(self._armed)

    def _fire(self, a: _Armed, **detail: Any) -> None:
        a.remaining -= 1
        self.fired.append((a.spec.kind,
                           dict(detail, replica=a.spec.replica)))

    # -- engine side ----------------------------------------------------

    def tick_actions(self, replica: int) -> Dict[str, Any]:
        """Called by ``ContinuousEngine.step`` once per BUSY tick
        (idle polls don't count — the sim's ``EngineModel`` only ticks
        with work too).  Advances this replica's tick counter and
        returns the due engine-side actions:
        ``{"freeze_s": float, "alloc_fail": bool, "raise_step": str?}``
        — an empty dict when nothing fires."""
        out: Dict[str, Any] = {}
        with self._lock:
            tick = self._ticks.get(replica, 0)
            self._ticks[replica] = tick + 1
            for a in self._armed:
                s = a.spec
                if (a.remaining <= 0 or s.replica != replica
                        or s.at_tick is None or tick < s.at_tick):
                    continue
                if s.kind == "freeze_tick":
                    self._fire(a, tick=tick)
                    out["freeze_s"] = out.get("freeze_s", 0.0) \
                        + s.duration_s
                elif s.kind == "alloc_storm":
                    # stays armed for `count` consecutive ticks
                    if tick < s.at_tick + s.count:
                        if tick == s.at_tick + s.count - 1:
                            a.remaining = 0
                        self.fired.append((s.kind, {"replica": replica,
                                                    "tick": tick}))
                        out["alloc_fail"] = True
                elif s.kind == "raise_step":
                    self._fire(a, tick=tick)
                    out["raise_step"] = (
                        f"injected device-step fault "
                        f"(replica {replica}, tick {tick})")
        return out

    def pump_action(self, replica: int) -> Optional[str]:
        """Polled by the pump loop between submits and steps: returns
        ``"kill"`` (graceful self-retirement), ``"crash"`` (raise out
        of the pump), or ``None``.  Fires once the replica's tick
        counter reaches ``at_tick`` — at-or-after, so a schedule can
        name a tick the replica never exactly lands on."""
        with self._lock:
            tick = self._ticks.get(replica, 0)
            for a in self._armed:
                s = a.spec
                if (a.remaining <= 0 or s.replica != replica
                        or s.kind not in ("kill_pump", "crash_pump")
                        or s.at_tick is None or tick < s.at_tick):
                    continue
                self._fire(a, tick=tick)
                return "kill" if s.kind == "kill_pump" else "crash"
        return None

    # -- handoff path (broker / sim fleet) ------------------------------

    def handoff_action(self, t: Optional[float] = None
                       ) -> Optional[Tuple[str, float]]:
        """Called once per prefill→decode handoff delivery (the broker
        before ``submit_handoff``; the sim fleet before ``_deliver``).
        Returns ``("drop", 0.0)``, ``("delay", seconds)``, or ``None``
        (deliver normally).  A spec with ``at_handoff`` fires on that
        sequence number; one with only ``at_t`` fires once virtual
        time reaches it (sim); one with neither fires on the next
        delivery."""
        with self._lock:
            seq = self._handoffs
            self._handoffs += 1
            for a in self._armed:
                s = a.spec
                if a.remaining <= 0 or s.kind not in _HANDOFF_KINDS:
                    continue
                if s.at_handoff is not None:
                    if not (s.at_handoff <= seq
                            < s.at_handoff + s.count):
                        continue
                elif s.at_t is not None:
                    if t is None or t < s.at_t:
                        continue
                self._fire(a, handoff=seq)
                return (("drop", 0.0) if s.kind == "drop_handoff"
                        else ("delay", s.duration_s))
        return None

    # -- simulator side -------------------------------------------------

    def due_crashes(self, replica: int, now_t: float) -> bool:
        """Virtual-time twin of ``pump_action``'s crash: True once
        when ``replica`` has a ``crash_pump`` spec with
        ``at_t <= now_t`` (the sim fleet marks the replica dead and
        re-dispatches its lost requests)."""
        with self._lock:
            for a in self._armed:
                s = a.spec
                if (a.remaining <= 0 or s.kind != "crash_pump"
                        or s.replica != replica or s.at_t is None
                        or now_t < s.at_t):
                    continue
                self._fire(a, t=now_t)
                return True
        return False

    # -- observability --------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Diagnostic view for bundles / ``router_status``."""
        with self._lock:
            return {
                "seed": self.seed,
                "armed": [{"kind": a.spec.kind,
                           "replica": a.spec.replica,
                           "remaining": a.remaining}
                          for a in self._armed if a.remaining > 0],
                "fired": [{"kind": k, **d} for k, d in self.fired],
            }
