"""Discrete-event model of a disaggregated serving fleet
(``FleetModel``): ``EngineModel`` replicas behind the router policy of
``serving/policy.py`` (``route_request``), with the prefill-to-decode
KV handoff modelled as a delivery delay.

A copy of ``analytics_zoo_tpu/serving/sim/fleet.py``, held to it by
``tests/test_torch_serving_pins.py``.  Virtual clocks, one seeded RNG a
replica.  Standard library, ``serving/policy.py`` and
``serving/fault.py`` only.
"""

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import policy as scheduler_policy
from ..fault import FaultInjector
from ..policy import (PRIORITIES, REPLICA_ROLES, QosPolicy,
                      ReplicaSignals, pick_retry_target,
                      plan_handoff_recovery, plan_redispatch)
from .model import (AcceptanceModel, EngineConfig, EngineModel,
                    TimingModel, summarize)
from .trace import Request

__all__ = ["FleetModel"]


class FleetModel:
    """N modelled replicas + the real routing policy + KV handoff.

    Fault twin (``faults``): the fleet consumes the SAME fault
    schedules the live ``ClusterServing`` does (``serving/fault.py``),
    against virtual time — ``crash_pump`` at ``at_t`` kills a replica
    and re-dispatches its lost requests through the same pure policy
    functions the live supervisor calls (``plan_redispatch`` /
    ``pick_retry_target``), ``drop_handoff``/``delay_handoff`` hit the
    two-phase handoff path recovered by ``plan_handoff_recovery``.
    ``faults=None`` (the default) leaves every code path bit-identical
    to the fault-free model the golden envelopes pin."""

    def __init__(self, configs: Sequence[EngineConfig],
                 roles: Optional[Sequence[Optional[str]]] = None,
                 qos: Optional[QosPolicy] = None,
                 acceptance: Optional[AcceptanceModel] = None,
                 timing: Optional[TimingModel] = None,
                 seed: int = 0, record_events: bool = True,
                 handoff_s: float = 0.0,
                 faults: Optional[Sequence[Any]] = None,
                 retry_budget: int = 2,
                 handoff_timeout_s: float = 0.0,
                 request_deadline_s: float = 0.0,
                 brownout: Optional[
                     "scheduler_policy.BrownoutPolicy"] = None,
                 slo_targets: Optional[
                     Dict[str, Dict[str, float]]] = None):
        if not configs:
            raise ValueError("FleetModel needs at least one replica")
        if roles is not None:
            if len(roles) != len(configs):
                raise ValueError(
                    f"roles has {len(roles)} entries for "
                    f"{len(configs)} replicas")
            bad = [r for r in roles
                   if r is not None and r not in REPLICA_ROLES]
            if bad:
                raise ValueError(f"unknown replica roles {bad!r} "
                                 f"(choose from {REPLICA_ROLES})")
        self.engines = [
            EngineModel(c, qos=qos, acceptance=acceptance, timing=timing,
                        seed=seed + i, record_events=record_events,
                        brownout=brownout, slo_targets=slo_targets)
            for i, c in enumerate(configs)]
        # overload brownout: ONE broker-level controller over the whole
        # fleet (the live ClusterServing._brownout_eval twin) — engines
        # keep their per-replica goodput windows / alloc streaks / tick
        # trends but never self-evaluate; the fleet aggregates the
        # worst-case signals and pushes one shared level, so replicas
        # degrade and recover together
        self.brownout = brownout
        self._bstate = scheduler_policy.BrownoutState()
        self.brownout_transitions = 0
        self.brownout_max_level = 0
        for e in self.engines:
            e.brownout_managed = True
        self.roles = list(roles) if roles is not None else None
        self.handoff_s = float(handoff_s)
        self.handoffs = 0
        self.routed = [0] * len(configs)
        self._rr = 0
        self._seq = 0               # stable tiebreak for inbox ordering
        # per-replica pending deliveries: (available_t, seq, req, record)
        self._inbox: List[List[Tuple[float, int, Any, Any]]] = [
            [] for _ in configs]
        # -- crash tolerance (the live supervisor's virtual twin) -----
        self.injector = FaultInjector(faults) if faults else None
        self.retry_budget = int(retry_budget)
        self.handoff_timeout_s = float(handoff_timeout_s)
        self.request_deadline_s = float(request_deadline_s)
        self.dead = [False] * len(configs)
        self.replica_deaths = 0
        self.redispatched = 0
        self.handoff_timeouts = 0
        self.handoff_retries = 0
        self.dropped_handoffs = 0
        #: uri -> original trace Request (the sim's "unacked stream
        #: entry": what a redispatch re-reads to re-run from scratch)
        self._requests: Dict[str, Request] = {}
        #: uri -> pending two-phase handoff awaiting adoption ack
        self._pending_handoffs: Dict[str, Dict[str, Any]] = {}
        if self.roles is not None:
            for i, e in enumerate(self.engines):
                if self.roles[i] == "prefill":
                    e.handoff_cb = (lambda row, t, _i=i:
                                    self._handoff(_i, row, t))

    # -- routing --------------------------------------------------------

    def _signals(self, request=None) -> List[ReplicaSignals]:
        """Fabricate per-replica signals; when ``request`` carries a
        shared prefix, fill the per-request ``prefix_blocks`` rank
        input from each replica's tier residency — the sim's
        ``PrefixDirectory.match_depths`` (the live router fills it the
        same way, so ``route_request`` sees identical inputs)."""
        sigs = []
        for i, e in enumerate(self.engines):
            pb = 0
            if request is not None and getattr(request, "prefix_id", ""):
                cap = (min(int(request.prefix_len),
                           int(request.prompt_len) - 1)
                       // e.config.block_size)
                pb = min(e.prefix_resident_blocks(request.prefix_id),
                         max(0, cap))
            sigs.append(ReplicaSignals(
                replica=i, live=not self.dead[i],
                queue_depth=len(e._waiting) + e.n_active
                + len(self._inbox[i]),
                allocatable_blocks=(e._pool.allocatable()
                                    if e._pool is not None else None),
                role=(self.roles[i] if self.roles is not None
                      else None),
                prefix_blocks=pb))
        return sigs

    def _route(self, priority: Optional[str],
               phase: Optional[str], request=None) -> int:
        r = scheduler_policy.route_request(
            self._signals(request), priority=priority,
            rr_cursor=self._rr,
            phase=phase if self.roles is not None else None)
        self._rr = (self._rr + 1) % len(self.engines)
        if r is None:
            # only reachable with faults: every replica crashed.  The
            # live broker parks unrouted work; the sim treats a fully
            # dead fleet as a scenario bug and says so.
            raise RuntimeError(
                "sim fleet has no live replicas left to route to "
                "(fault schedule killed every replica?)")
        return r

    def _deliver(self, dst: int, available_t: float, req, record) -> None:
        self._seq += 1
        self._inbox[dst].append((available_t, self._seq, req, record))
        self._inbox[dst].sort(key=lambda e: (e[0], e[1]))

    def _handoff(self, src: int, row, t: float) -> None:
        """A prefill replica exported ``row`` at time ``t``: route the
        decode phase and deliver the adopted request ``handoff_s``
        later.  The router may pick the source itself (every decode
        replica saturated) — self-adoption, same as the live broker's
        fallback.

        With ``handoff_timeout_s > 0`` the delivery is two-phase: a
        pending entry holds the (req, record) pair — the sim twin of
        the source keeping the exported chain referenced — until the
        destination's adoption (``_drain_inbox``) acks it; the fault
        injector may drop or delay the delivery, and ``_fault_sweep``
        recovers un-acked entries via ``plan_handoff_recovery``."""
        req = row.req
        req.handoff = int(row.emitted)
        dst = self._route(req.priority, "decode")
        self.handoffs += 1
        record = self.engines[src].records[req.uri]
        if self.handoff_timeout_s > 0:
            self._pending_handoffs[req.uri] = {
                "req": req, "record": record, "src": src, "dst": dst,
                "sent_at": t, "retries": 0}
        delay = self.handoff_s
        if self.injector is not None:
            act = self.injector.handoff_action(t)
            if act is not None:
                kind, extra = act
                if kind == "drop" and self.handoff_timeout_s > 0:
                    # swallowed delivery: the pending entry stays;
                    # the ack-timeout sweep recovers the request
                    self.dropped_handoffs += 1
                    return
                if kind == "delay":
                    delay += extra
        self._deliver(dst, t + delay, req, record)

    # -- crash tolerance (virtual twin of server.py's _supervise) -------

    def _fault_sweep(self) -> None:
        """One pass of the supervisor's virtual twin: fire due
        ``crash_pump`` faults, then recover un-acked two-phase
        handoffs — the SAME pure policy calls the live router makes
        (``plan_handoff_recovery`` / ``pick_retry_target``)."""
        n = len(self.engines)
        for i in range(n):
            if not self.dead[i] and self.injector.due_crashes(
                    i, self.engines[i].now):
                self._crash_replica(i)
        if self.handoff_timeout_s <= 0 or not self._pending_handoffs:
            return
        now = max(e.now for e in self.engines)
        for uri in list(self._pending_handoffs):
            info = self._pending_handoffs.get(uri)
            if info is None:
                continue
            verdict = plan_handoff_recovery(
                age_s=now - info["sent_at"],
                timeout_s=self.handoff_timeout_s,
                retries=info["retries"],
                retry_budget=self.retry_budget)
            if verdict == "wait":
                continue
            self.handoff_timeouts += 1
            if verdict == "give_up":
                self._pending_handoffs.pop(uri, None)
                info["record"].dropped = "handoff_failed"
                continue
            r = pick_retry_target(
                self._signals(), info["req"].priority, self._rr,
                exclude=(info["dst"],),
                phase="decode" if self.roles is not None else None)
            if r is None:
                # nothing else eligible: back to any live replica
                # (the source itself is the live broker's last resort)
                r = self._route(info["req"].priority, "decode")
            info["retries"] += 1
            info["dst"] = r
            info["sent_at"] = now
            self.handoff_retries += 1
            self._deliver(r, now + self.handoff_s, info["req"],
                          info["record"])

    def _crash_replica(self, i: int) -> None:
        """An unplanned replica death at its own virtual ``now`` (the
        live path: InjectedFault escaping the pump loop → supervisor
        declare-dead): mark it dead, then re-dispatch every lost
        request — active rows, queued waiters, and undelivered inbox
        entries — through ``plan_redispatch``, bumping each record's
        ``attempts`` exactly like the live at-least-once recovery."""
        e = self.engines[i]
        t = e.now
        self.dead[i] = True
        self.replica_deaths += 1
        lost = []
        for s in range(len(e._slots)):
            row = e._slots[s]
            if row is None:
                continue
            e._slots[s] = None
            e._free.append(s)
            e._release_blocks(row)
            lost.append(row.req)
        while len(e._waiting):
            lost.append(e._waiting.popleft())
        inbox, self._inbox[i] = self._inbox[i], []
        for _avail, _seq, req, record in inbox:
            if record is None:
                # routed-but-undelivered arrival: the live router's
                # _reroute_dead — re-place, no attempt bump (the
                # request never started anywhere)
                dst = self._route(req.priority, "prefill", request=req)
                self._deliver(dst, max(_avail, t), req, None)
            elif req.uri in self._pending_handoffs:
                pass    # the ack-timeout sweep recovers it
            elif getattr(req, "handoff", None) is not None:
                # in-flight adoption with two-phase off: re-route the
                # decode leg directly to a survivor
                dst = self._route(req.priority, "decode")
                self.handoff_retries += 1
                self._deliver(dst, t + self.handoff_s, req, record)
            else:
                lost.append(req)
        for req in lost:
            rec = e.records.get(req.uri)
            if rec is None or rec.finished or rec.dropped:
                continue
            orig = self._requests.get(req.uri)
            deadline = (orig.deadline_s if orig is not None
                        and orig.deadline_s > 0
                        else self.request_deadline_s)
            verdict = plan_redispatch(
                attempt=rec.attempts, retry_budget=self.retry_budget,
                cancelled=False, age_s=t - rec.arrival,
                deadline_s=deadline)
            if verdict != "retry":
                rec.dropped = ("cancelled" if verdict == "cancel"
                               else "retry_budget")
                continue
            if orig is None:    # adopted row whose origin we never saw
                rec.dropped = "lost_entry"
                continue
            self._pending_handoffs.pop(req.uri, None)
            rec.attempts += 1
            self.redispatched += 1
            dst = self._route(orig.priority, "prefill", request=orig)
            self._deliver(dst, t, orig, rec)

    # -- overload brownout (broker controller twin) ---------------------

    def _brownout_sweep(self) -> None:
        """One shared-controller decision over aggregated worst-case
        fleet signals: min per-class windowed goodput, max backlog
        (engine queue + undelivered inbox), max alloc-fail streak, max
        per-replica tick trend — the same aggregation the live broker's
        ``_brownout_eval`` performs over its replicas."""
        live = [i for i in range(len(self.engines)) if not self.dead[i]]
        if not live:
            return
        goodput = {
            cls: min(self.engines[i].windowed_goodput()[cls]
                     for i in live)
            for cls in PRIORITIES}
        queue_depth = max(
            len(self.engines[i]._waiting) + len(self._inbox[i])
            for i in live)
        streak = max(self.engines[i]._alloc_streak for i in live)
        tick_means = [
            sum(self.engines[i]._tick_durs)
            / len(self.engines[i]._tick_durs)
            for i in live if self.engines[i]._tick_durs]
        prev = self._bstate
        self._bstate = scheduler_policy.plan_brownout(
            self.brownout, prev, goodput=goodput,
            queue_depth=queue_depth, alloc_fail_streak=streak,
            tick_s=max(tick_means) if tick_means else None)
        if self._bstate.level != prev.level:
            self.brownout_transitions += 1
            self.brownout_max_level = max(self.brownout_max_level,
                                          self._bstate.level)
            for i in live:
                self.engines[i].set_brownout(self._bstate.level)

    # -- driving --------------------------------------------------------

    def _drain_inbox(self, i: int) -> None:
        """Hand every delivery whose time has come to replica ``i``'s
        waiting queue.  An ACTIVE replica only sees deliveries at/behind
        its own clock (a future handoff cannot jump the queue); an idle
        one fast-forwards in ``run``."""
        e = self.engines[i]
        box = self._inbox[i]
        while box and box[0][0] <= e.now:
            _, _, req, record = box.pop(0)
            if record is None:
                e.submit(req)
            elif getattr(req, "handoff", None) is not None:
                e.submit_prefilled(req, record)
                # adoption IS the ack: release the source-side pending
                # entry (the live engine's on_adopt callback)
                self._pending_handoffs.pop(req.uri, None)
            else:
                # crash-recovery redispatch: full re-run on a survivor,
                # lifecycle record continued
                e.submit_retry(req, record)

    def _has_work(self, i: int) -> bool:
        if self.dead[i]:
            return False
        e = self.engines[i]
        return e.n_active > 0 or len(e._waiting) > 0

    def run(self, trace: Sequence[Request],
            max_ticks: Optional[int] = None) -> Dict[str, Any]:
        """Feed ``trace`` through the routed fleet until every request
        finishes or drops; returns the merged per-request records."""
        pending = sorted(trace, key=lambda r: (r.arrival_t, r.uri))
        guard = max_ticks if max_ticks is not None else 20_000_000
        p = 0
        n = len(self.engines)
        while True:
            # 0. fault sweep: due crashes + un-acked handoff recovery
            if self.injector is not None:
                self._fault_sweep()
            # 1. route arrivals due at/before the busiest frontier (or
            #    all remaining ones once the fleet has gone idle)
            busy_now = [self.engines[i].now for i in range(n)
                        if self._has_work(i)]
            frontier = min(busy_now) if busy_now else None
            while p < len(pending) and (
                    frontier is None
                    or pending[p].arrival_t <= frontier):
                r = pending[p]
                self._requests[r.uri] = r
                # arrivals route prefix-locality-aware (handoffs stay
                # locality-blind, like the live broker's rebalance)
                dst = self._route(r.priority, "prefill", request=r)
                self.routed[dst] += 1
                self._deliver(dst, r.arrival_t, r, None)
                p += 1
                if frontier is None:
                    break       # idle fleet: one arrival re-busies it
            # 2. deliver matured inbox entries; fast-forward idle
            #    replicas to their next delivery
            for i in range(n):
                if self.dead[i]:
                    continue
                e = self.engines[i]
                if (not self._has_work(i)) and self._inbox[i]:
                    e.now = max(e.now, self._inbox[i][0][0])
                self._drain_inbox(i)
            # 3. step the lagging busy replica
            work = [i for i in range(n) if self._has_work(i)]
            if not work:
                if p < len(pending) or any(self._inbox[i]
                                           for i in range(n)):
                    continue    # future arrivals/deliveries remain
                if self._pending_handoffs and self.handoff_timeout_s > 0:
                    # idle fleet with un-acked handoffs (a dropped
                    # delivery): fast-forward virtual time to the
                    # earliest ack deadline so the recovery sweep
                    # fires instead of stranding the request
                    t_next = min(h["sent_at"] + self.handoff_timeout_s
                                 for h in self._pending_handoffs.values())
                    for i in range(n):
                        if not self.dead[i]:
                            self.engines[i].now = max(
                                self.engines[i].now, t_next + 1e-9)
                    continue
                break
            i = min(work, key=lambda j: (self.engines[j].now, j))
            self.engines[i].step()
            if self.brownout is not None:
                self._brownout_sweep()
            if sum(e.ticks for e in self.engines) >= guard:
                raise RuntimeError(
                    f"fleet simulation exceeded {guard} ticks "
                    f"(arrival rate beyond modelled capacity?)")
        return self.records

    # -- results --------------------------------------------------------

    @property
    def records(self) -> Dict[str, Any]:
        """Merged per-request records.  A handed-off request's record
        OBJECT is shared between source and destination replicas, so
        the union has exactly one entry per uri."""
        out: Dict[str, Any] = {}
        for e in self.engines:
            out.update(e.records)
        return out

    def summary(self, targets: Optional[Dict[str, Dict[str, float]]]
                = None) -> Dict[str, Any]:
        out = summarize(self.records, targets)
        out["ticks"] = sum(e.ticks for e in self.engines)
        out["preemptions"] = sum(e.preemptions for e in self.engines)
        out["prefill_stall_ticks"] = sum(e.prefill_stall_ticks
                                         for e in self.engines)
        out["handoffs"] = self.handoffs
        out["handoffs_adopted"] = sum(e.handoffs_in
                                      for e in self.engines)
        out["routed"] = list(self.routed)
        out["per_replica_ticks"] = [e.ticks for e in self.engines]
        if self.injector is not None:
            # chaos counters, present only when a fault schedule is
            # configured — fault-free summaries stay key-identical to
            # previous releases (golden envelopes pin on them)
            recs = list(self.records.values())
            out["replica_deaths"] = self.replica_deaths
            out["redispatched"] = self.redispatched
            out["handoff_timeouts"] = self.handoff_timeouts
            out["handoff_retries"] = self.handoff_retries
            out["dropped_handoffs"] = self.dropped_handoffs
            out["max_attempts"] = max(
                [r.attempts for r in recs] or [1])
            # the gate's zero-stranded contract: every request reached
            # a terminal state (finished or an explicit drop reason)
            out["stranded"] = sum(1 for r in recs
                                  if not r.finished and not r.dropped)
        if self.brownout is not None:
            # brownout counters, present only when the ladder is
            # configured — brownout-off summaries stay key-identical
            # to previous releases (golden envelopes pin on them)
            out["brownout_sheds"] = sum(e.brownout_sheds
                                        for e in self.engines)
            out["brownout_max_level"] = self.brownout_max_level
            out["brownout_final_level"] = self._bstate.level
            out["brownout_transitions"] = self.brownout_transitions
        if (self.brownout is not None
                or any(e.deadline_seen for e in self.engines)):
            out["deadline_sheds"] = sum(e.deadline_sheds
                                        for e in self.engines)
        if any(e._prefix_on for e in self.engines):
            # tiered-KV sums, present only when a replica runs the
            # tier — tier-off summaries stay key-identical to previous
            # releases (golden envelopes pin on them)
            out["kv_spills"] = sum(e.kv_spills for e in self.engines)
            out["kv_readmits"] = sum(e.kv_readmits
                                     for e in self.engines)
            out["kv_readmit_tokens_saved"] = sum(
                e.kv_readmit_tokens_saved for e in self.engines)
            out["recompute_tokens_saved"] = sum(
                e.recompute_tokens_saved for e in self.engines)
        return out
