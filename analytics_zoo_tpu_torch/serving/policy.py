"""Pure scheduler policy of the serving engine: admission order,
prefill grants, preemption victims, token-budget billing, replica
routing, pool resizing and the brownout ladder, as side-effect-free
functions over plain data.

A copy of ``analytics_zoo_tpu/serving/policy.py`` (stdlib only).  The
port's engine calls :func:`pick_victim`; the server calls the routing,
supervisor and brownout functions; the rest waits for the engine modes
that use it (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: Monotonically bumped whenever a decision function's observable
#: behavior changes.  The simulator stamps it into every event log so
#: a golden-trace mismatch distinguishes "policy changed" from "sim
#: drifted".
SCHEDULER_POLICY_VERSION = 4

#: Priority classes, best-first.  The wire encodes a priority as its
#: index in this tuple (the input queue transports ints, not strings);
#: aging promotes a waiting request one index at a time toward 0.
PRIORITIES: Tuple[str, ...] = ("interactive", "standard", "batch")

DEFAULT_WEIGHTS: Dict[str, float] = {
    "interactive": 8.0, "standard": 4.0, "batch": 1.0}


@dataclass(frozen=True)
class QosPolicy:
    """Admission policy knobs: per-class weights and the aging bound.

    ``weights`` are stride-scheduling shares — a class with weight 8
    gets ~8x the admission slots of weight 1 under contention, it does
    NOT strictly preempt it.  ``aging_s`` is the starvation bound: a
    request that has waited ``aging_s`` is treated as one class better
    (both for its subqueue's stride and for prefill-grant ordering),
    two intervals promotes two classes, so batch work can wait at most
    ``2 * aging_s`` before it competes as interactive.  ``aging_s <= 0``
    disables promotion (weights alone still prevent total starvation:
    a never-popped subqueue's virtual pass stands still while every
    other queue's advances, so it eventually holds the minimum)."""

    weights: Dict[str, float] = field(
        default_factory=lambda: dict(DEFAULT_WEIGHTS))
    aging_s: float = 30.0

    def __post_init__(self):
        for cls in PRIORITIES:
            w = self.weights.get(cls, DEFAULT_WEIGHTS[cls])
            if w <= 0:
                raise ValueError(f"qos weight for {cls!r} must be > 0, "
                                 f"got {w}")
            self.weights.setdefault(cls, DEFAULT_WEIGHTS[cls])

    def class_rank(self, priority: str, waited_s: float) -> int:
        """Aged class index (0 best).  Unknown priorities rank as
        ``standard`` rather than raising — the pump must never die on a
        stale wire value."""
        try:
            idx = PRIORITIES.index(priority)
        except ValueError:
            idx = PRIORITIES.index("standard")
        if self.aging_s > 0 and waited_s > 0:
            idx -= int(waited_s // self.aging_s)
        return max(0, idx)

    def effective_weight(self, priority: str, waited_s: float) -> float:
        return self.weights[PRIORITIES[self.class_rank(priority,
                                                       waited_s)]]


# ---------------------------------------------------------------------------
# decision functions (pure: plain data in, decision out)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# multi-replica routing (ClusterServing n_replicas > 1)
# ---------------------------------------------------------------------------

#: A replica whose per-class SLO goodput (SloWatchdog.status) falls
#: below this fraction is avoided while any healthy peer exists.
ROUTER_GOODPUT_FLOOR = 0.9

#: A paged replica reporting fewer allocatable blocks than this is
#: treated as pool-pressured (the alloc-fail streak catches sustained
#: pressure; this floor catches it one tick earlier).
ROUTER_MIN_ALLOCATABLE = 1

#: Replica specializations under prefill/decode disaggregation
#: (``ServingConfig.replica_roles``).  ``None`` means symmetric — the
#: replica takes either phase, which is also every replica's role when
#: disaggregation is off (the role-blind behavior, bit-identical ranks).
REPLICA_ROLES: Tuple[str, ...] = ("prefill", "decode")


@dataclass(frozen=True)
class ReplicaSignals:
    """One replica's live routing signals, as plain data — the server
    snapshots these from each replica's engine/watchdog per routed
    request, the simulator fabricates them, and ``route_request``
    never sees anything richer.

    ``queue_depth`` is the replica's total uncompleted load (routed-
    but-unclaimed + engine-waiting + engine-resident).
    ``allocatable_blocks`` is ``BlockPool.allocatable()`` (``None``
    for an arena-mode replica: no pool, never pool-pressured).
    ``goodput`` maps priority class -> SLO goodput fraction from the
    replica's watchdog (``None``/missing class reads as healthy —
    a replica that served nothing yet must not read as degraded).
    ``role`` is the replica's disaggregation specialization
    (``"prefill"`` / ``"decode"`` / ``None`` = symmetric, takes
    either phase).
    ``prefix_blocks`` is THIS request's estimated reuse depth on the
    replica — leading prompt blocks the fleet ``PrefixDirectory``
    says it already holds (HBM index or host KV store), i.e. blocks
    it would not re-prefill.  Per-request, unlike every other field:
    the router fills it from ``PrefixDirectory.match_depths`` after
    snapshotting the rest.  0 (the default, and always when no
    directory runs) keeps ranks bit-identical to the locality-blind
    router."""

    replica: int
    live: bool = True
    queue_depth: int = 0
    allocatable_blocks: Optional[int] = None
    alloc_fail_streak: int = 0
    goodput: Optional[Dict[str, float]] = None
    role: Optional[str] = None
    prefix_blocks: int = 0
    #: Seconds since the replica's pump thread last stamped its
    #: heartbeat (``None`` = no supervisor running / pump never beat).
    #: A liveness input for ``replica_dead``, NOT a rank term —
    #: ``route_request`` ignores it, so fleets without a supervisor
    #: keep bit-identical ranks.
    heartbeat_age_s: Optional[float] = None


def replica_pressured(sig: ReplicaSignals,
                      min_allocatable: int = ROUTER_MIN_ALLOCATABLE
                      ) -> bool:
    """Pool pressure: a live alloc-fail streak, or an allocatable-block
    count below the floor.  Arena replicas are never pressured."""
    if sig.alloc_fail_streak > 0:
        return True
    return (sig.allocatable_blocks is not None
            and sig.allocatable_blocks < min_allocatable)


def replica_degraded(sig: ReplicaSignals, priority: Optional[str],
                     goodput_floor: float = ROUTER_GOODPUT_FLOOR
                     ) -> bool:
    """SLO degradation for THIS request's class: the replica's
    watchdog goodput for the class sits below the floor."""
    if not sig.goodput:
        return False
    cls = priority if priority in PRIORITIES else "standard"
    return sig.goodput.get(cls, 1.0) < goodput_floor


def route_request(replicas: Sequence[ReplicaSignals],
                  priority: Optional[str] = None,
                  rr_cursor: int = 0,
                  *,
                  phase: Optional[str] = None,
                  goodput_floor: float = ROUTER_GOODPUT_FLOOR,
                  min_allocatable: int = ROUTER_MIN_ALLOCATABLE
                  ) -> Optional[int]:
    """Place one request on a replica.  Returns the chosen replica id,
    or ``None`` when no replica is live (the caller's requeue/error
    path).

    Rank order, best first:

    0. role match FIRST, when ``phase`` is given ("prefill"/"decode"
       — the disaggregated router passes the request's current phase):
       a replica whose ``role`` is ``None`` or equals the phase
       outranks a role-mismatched one.  The term is a preference, not
       a partition — with every same-role replica dead (mid
       ``kill_pump`` drain) traffic falls through to the other role
       rather than failing, and with no roles configured anywhere the
       term is constant, leaving ranks bit-identical to the symmetric
       router;
    1. deepest ``prefix_blocks`` (prefix locality, tiered-KV fleets):
       the replica already holding the most leading prompt blocks —
       device index or host store — skips that much re-prefill, which
       dwarfs a few queue positions.  Locality sits BELOW role match
       (a disaggregated prefill replica is still the right place to
       prefill even when a decode replica holds the prefix) and ABOVE
       pool pressure (the reuse frees more blocks than the pressured
       admission would need).  With no directory every signal carries
       the 0 default, the term is constant, and ranks are
       bit-identical to the locality-blind router;
    2. not pool-pressured (``replica_pressured``) — a dry pool means
       admission would preempt or stall, so pressure outranks depth;
    3. not SLO-degraded FOR THIS CLASS (``replica_degraded``) — a
       replica failing interactive targets still takes batch work;
    4. least ``queue_depth`` (least-loaded);
    5. round-robin distance from ``rr_cursor`` — the DETERMINISTIC
       tie-break: equal replicas take turns as the caller advances the
       cursor per routed request, never a coin flip.

    Every signal equal (cold start) this degrades to exactly
    least-loaded round-robin, the documented fallback."""
    live = [r for r in replicas if r.live]
    if not live:
        return None
    n = max(r.replica for r in live) + 1

    def rank(r: ReplicaSignals):
        mismatch = (phase is not None and r.role is not None
                    and r.role != phase)
        return (mismatch,
                -r.prefix_blocks,
                replica_pressured(r, min_allocatable),
                replica_degraded(r, priority, goodput_floor),
                r.queue_depth,
                (r.replica - rr_cursor) % n)

    return min(live, key=rank).replica


# ---------------------------------------------------------------------------
# fleet supervision: declare-dead / retry-budget / pick-retry-target
# (ClusterServing supervisor + serving/sim FleetModel faults)
# ---------------------------------------------------------------------------

def replica_dead(heartbeat_age_s: Optional[float],
                 miss_s: float) -> bool:
    """Liveness verdict for the supervisor: a pump that has not
    stamped its heartbeat for ``miss_s`` seconds is declared dead
    (wedged tick, frozen device, or a thread that silently exited).
    ``miss_s <= 0`` disables heartbeat-based death (escaped pump
    exceptions still declare death explicitly); ``None`` age means no
    beat was ever observed — never declared dead on silence alone,
    the pump may simply not have started."""
    if miss_s <= 0 or heartbeat_age_s is None:
        return False
    return heartbeat_age_s > miss_s


def plan_redispatch(*, attempt: int, retry_budget: int,
                    cancelled: bool = False,
                    age_s: float = 0.0,
                    deadline_s: float = 0.0) -> str:
    """Terminal-or-retry decision for one lost in-flight request (its
    replica was declared dead).  Returns one of:

    - ``"cancel"`` — the client already cancelled it; surface the
      terminal *cancelled*, never resurrect it on a survivor;
    - ``"error"`` — retry budget exhausted (``attempt`` placements
      already happened and ``attempt >= retry_budget``) or the
      request's deadline passed (``deadline_s > 0`` and
      ``age_s > deadline_s``): terminal error, at-least-once gives up
      loudly rather than looping forever;
    - ``"retry"`` — re-dispatch to a survivor (the caller increments
      the attempt counter and emits the client-visible ``restart``).

    ``attempt`` counts placements so far (first submit = 1);
    ``retry_budget`` is the MAX total placements a request may
    consume."""
    if cancelled:
        return "cancel"
    if attempt >= max(1, retry_budget):
        return "error"
    if deadline_s > 0 and age_s > deadline_s:
        return "error"
    return "retry"


def pick_retry_target(replicas: Sequence[ReplicaSignals],
                      priority: Optional[str] = None,
                      rr_cursor: int = 0,
                      *,
                      exclude: Sequence[int] = (),
                      phase: Optional[str] = None) -> Optional[int]:
    """Placement for a re-dispatched request: ``route_request`` over
    the survivors, never the replicas in ``exclude`` (the dead source,
    or a handoff destination that already timed out) even if their
    signals still read live — the supervisor may re-dispatch before
    the death propagates into a fresh snapshot.  Returns ``None``
    when no eligible replica remains (the caller parks or errors)."""
    bad = set(exclude)
    eligible = [r for r in replicas if r.replica not in bad]
    return route_request(eligible, priority, rr_cursor, phase=phase)


def plan_handoff_recovery(*, age_s: float, timeout_s: float,
                          retries: int, retry_budget: int) -> str:
    """Two-phase handoff: the prefill source holds the exported chain
    until the decode side acks adoption.  Given a pending (un-acked)
    handoff's age, decide ``"wait"`` (not yet timed out), ``"retry"``
    (timed out, budget left: re-dispatch to an alternate decode
    replica), or ``"give_up"`` (timed out past the budget: the caller
    errors the request terminally).  ``timeout_s <= 0`` disables the
    timeout — pending entries wait for the ack forever (the pre-
    supervisor fire-and-forget behavior)."""
    if timeout_s <= 0 or age_s <= timeout_s:
        return "wait"
    if retries < max(0, retry_budget):
        return "retry"
    return "give_up"


# ---------------------------------------------------------------------------
# elastic per-replica pool sizing (ContinuousEngine.maybe_autoresize)
# ---------------------------------------------------------------------------

#: Allocatable fraction below which the elastic planner grows the pool
#: (the one-tick-early analog of the alloc-fail streak).
POOL_GROW_FRAC = 0.125

#: Allocatable fraction above which the planner hands blocks back —
#: conservatively high so the pool breathes, not oscillates.
POOL_SHRINK_FRAC = 0.5


def plan_pool_resize(*, n_blocks: int, allocatable: int,
                     alloc_fail_streak: int, step: int, floor: int,
                     ceiling: int,
                     goodput: Optional[Dict[str, float]] = None,
                     goodput_floor: float = ROUTER_GOODPUT_FLOOR,
                     low_frac: float = POOL_GROW_FRAC,
                     high_frac: float = POOL_SHRINK_FRAC) -> int:
    """One elastic-pool step for a paged replica, as a signed block
    delta (positive = grow, negative = shrink, 0 = hold).  Pure policy:
    the engine executes the delta at the eviction boundary
    (``BlockPool.shrink`` stops at the first referenced block, so the
    delta here is a TARGET the executor may clamp).

    Decision order:

    1. grow ``step`` (clamped to ``ceiling``) under pool pressure — a
       live alloc-fail streak, or allocatable at/below
       ``low_frac * n_blocks``;
    2. hold while any priority class's goodput sits below
       ``goodput_floor`` — shrinking a replica that is already missing
       SLOs can only make it worse;
    3. shrink ``step`` when allocatable sits at/above
       ``high_frac * n_blocks`` and the result stays at/above
       ``floor`` (the engine's minimum working set);
    4. otherwise hold."""
    if step <= 0:
        return 0
    if alloc_fail_streak > 0 or allocatable <= low_frac * n_blocks:
        return min(step, max(0, ceiling - n_blocks))
    if goodput and any(g < goodput_floor for g in goodput.values()):
        return 0
    if allocatable >= high_frac * n_blocks and n_blocks - step >= floor:
        return -step
    return 0


# ---------------------------------------------------------------------------
# overload brownout ladder (docs/serving_qos.md "Overload & brownout")
# ---------------------------------------------------------------------------

#: Deepest degradation level: interactive-only serving.  Levels are
#: cumulative — every restriction of level N-1 stays active at N.
BROWNOUT_MAX_LEVEL = 4


@dataclass(frozen=True)
class BrownoutPolicy:
    """Knobs for the overload degradation ladder.

    A tick is a *breach* when any still-admitted class's windowed
    goodput sits below ``goodput_floor``, the admission backlog reaches
    ``queue_high``, the paged pool's alloc-fail streak reaches
    ``alloc_streak_high``, or (``tick_s_high > 0``) the engine tick
    duration exceeds ``tick_s_high``.  ``enter_ticks`` consecutive
    breaches ascend ONE level; descending needs ``exit_ticks``
    consecutive *recovered* ticks — backlog at or below
    ``queue_recover_frac * queue_high`` with no alloc pressure and
    every admitted class back above the floor.  The asymmetric gap
    between breach and recovery is the hysteresis band: a fleet
    hovering at the breach threshold holds its level instead of
    flapping.  ``standard_max_new`` is the level-2 per-request token
    clamp for ``standard`` class (0 disables the clamp)."""

    goodput_floor: float = 0.9
    queue_high: int = 64
    queue_recover_frac: float = 0.5
    alloc_streak_high: int = 4
    tick_s_high: float = 0.0
    enter_ticks: int = 3
    exit_ticks: int = 6
    standard_max_new: int = 16

    def __post_init__(self):
        if not 0.0 < self.goodput_floor <= 1.0:
            raise ValueError(f"goodput_floor must be in (0, 1], got "
                             f"{self.goodput_floor}")
        if self.queue_high < 1:
            raise ValueError(f"queue_high must be >= 1, got "
                             f"{self.queue_high}")
        if not 0.0 <= self.queue_recover_frac <= 1.0:
            raise ValueError(f"queue_recover_frac must be in [0, 1], "
                             f"got {self.queue_recover_frac}")
        if self.enter_ticks < 1 or self.exit_ticks < 1:
            raise ValueError("enter_ticks/exit_ticks must be >= 1")


@dataclass(frozen=True)
class BrownoutState:
    """The controller's whole memory, as plain immutable data: the
    current ladder level plus the consecutive breach/clear streaks the
    hysteresis gates count.  Callers thread it through
    ``plan_brownout`` and persist nothing else, so replays are exact."""

    level: int = 0
    breach_streak: int = 0
    clear_streak: int = 0


def brownout_classes(level: int) -> Tuple[str, ...]:
    """Priority classes still admitted at ``level`` (best-first).
    Shedding is strictly worst-class-first: batch goes at level 1,
    standard at level 4, interactive NEVER sheds."""
    if level >= 4:
        return ("interactive",)
    if level >= 1:
        return ("interactive", "standard")
    return PRIORITIES


def brownout_admit(level: int, priority: Optional[str]) -> bool:
    """Admission verdict for one request under the ladder.  Unknown
    priorities rank as ``standard`` (the ``class_rank`` convention —
    a stale wire value must degrade, not crash)."""
    cls = priority if priority in PRIORITIES else "standard"
    return cls in brownout_classes(level)


def brownout_max_new(level: int, priority: Optional[str],
                     max_new: int, clamp: int) -> int:
    """Level-2 token clamp: ``standard``-class requests are capped at
    ``clamp`` new tokens (never raised, never below 1).  Interactive
    is untouched at every level; batch is already shed by level 2."""
    if level < 2 or clamp <= 0:
        return max_new
    cls = priority if priority in PRIORITIES else "standard"
    if cls != "standard":
        return max_new
    return max(1, min(max_new, clamp))


def brownout_spec_enabled(level: int) -> bool:
    """Level-3 switch: speculative rounds are pure overhead when the
    fleet is saturated (draft ticks burn budget the verify can't
    repay), so the ladder drops them before it sheds standard."""
    return level < 3


def brownout_breached(policy: BrownoutPolicy, level: int, *,
                      goodput: Optional[Dict[str, float]] = None,
                      queue_depth: int = 0,
                      alloc_fail_streak: int = 0,
                      tick_s: Optional[float] = None) -> bool:
    """One tick's breach verdict.  Only classes the CURRENT level still
    admits are judged — a shed class's collapsing goodput must not
    hold the ladder up after the shedding already handled it."""
    if queue_depth >= policy.queue_high:
        return True
    if alloc_fail_streak >= policy.alloc_streak_high:
        return True
    if (policy.tick_s_high > 0 and tick_s is not None
            and tick_s > policy.tick_s_high):
        return True
    if goodput:
        for cls in brownout_classes(level):
            g = goodput.get(cls)
            if g is not None and g < policy.goodput_floor:
                return True
    return False


def brownout_recovered(policy: BrownoutPolicy, level: int, *,
                       goodput: Optional[Dict[str, float]] = None,
                       queue_depth: int = 0,
                       alloc_fail_streak: int = 0,
                       tick_s: Optional[float] = None) -> bool:
    """One tick's recovery verdict — deliberately STRICTER than "not
    breached": the backlog must fall to ``queue_recover_frac`` of the
    breach threshold, not merely below it.  The gap is the hysteresis
    band that keeps the ladder from flapping at the boundary."""
    if queue_depth > policy.queue_recover_frac * policy.queue_high:
        return False
    if alloc_fail_streak > 0:
        return False
    if (policy.tick_s_high > 0 and tick_s is not None
            and tick_s > policy.tick_s_high):
        return False
    if goodput:
        for cls in brownout_classes(level):
            g = goodput.get(cls)
            if g is not None and g < policy.goodput_floor:
                return False
    return True


def plan_brownout(policy: BrownoutPolicy, state: BrownoutState, *,
                  goodput: Optional[Dict[str, float]] = None,
                  queue_depth: int = 0,
                  alloc_fail_streak: int = 0,
                  tick_s: Optional[float] = None) -> BrownoutState:
    """One controller step: fold this tick's overload signals into the
    ladder state.  Pure and deterministic — the live broker
    (``ClusterServing``), ``EngineModel``, and ``FleetModel`` all call
    exactly this function, so the golden-brownout scenario replays the
    production controller byte-for-byte.

    Transitions move ONE level per decision: ``enter_ticks``
    consecutive breaches ascend, ``exit_ticks`` consecutive recovered
    ticks descend, and a tick that is neither (inside the hysteresis
    band) resets BOTH streaks — holding the level is the default
    outcome, flapping requires the signals themselves to oscillate
    across the full band."""
    kw = dict(goodput=goodput, queue_depth=queue_depth,
              alloc_fail_streak=alloc_fail_streak, tick_s=tick_s)
    if brownout_breached(policy, state.level, **kw):
        streak = state.breach_streak + 1
        if (streak >= policy.enter_ticks
                and state.level < BROWNOUT_MAX_LEVEL):
            return BrownoutState(level=state.level + 1)
        return BrownoutState(level=state.level, breach_streak=streak)
    if brownout_recovered(policy, state.level, **kw):
        streak = state.clear_streak + 1
        if streak >= policy.exit_ticks and state.level > 0:
            return BrownoutState(level=state.level - 1)
        return BrownoutState(level=state.level, clear_streak=streak)
    return BrownoutState(level=state.level)


def grant_rank(policy: Optional[QosPolicy], priority: Optional[str],
               waited_s: float, admit_seq: int):
    """Prefill-grant sort key for the chunked ticks.  QoS off: the
    admission sequence number — bit-identical FIFO to the
    pre-front-door engine (the parity guarantee).  QoS on: aged
    priority class first, FIFO within a class, so an interactive
    prompt's chunks land ahead of a batch prompt admitted earlier
    while aging still bounds how long batch can be outranked."""
    if policy is None:
        return admit_seq
    if priority is None:
        return (policy.class_rank("standard", 0.0), admit_seq)
    return (policy.class_rank(priority, waited_s), admit_seq)


def pick_victim(rows: Iterable[Tuple[int, str, int]]) -> int:
    """Pool-dry preemption choice over resident rows, each a
    ``(slot, state, admit_seq)`` triple.  PREFILLING rows first: they
    lost no emitted tokens and requeue cheaply; among candidates,
    always the LATEST admission (earliest admissions keep strict
    forward progress, so repeated preemption terminates)."""
    rows = list(rows)
    pre = [r for r in rows if r[1] == "PREFILLING"]
    return max(pre or rows, key=lambda r: r[2])[0]


def plan_chunks(budget: int, per_row_cost: int, n_decode: int,
                prefill: Sequence[Tuple[int, int]],
                chunk_cap: int) -> Tuple[List[Tuple[int, int]], bool]:
    """Token-budget billing for one chunked tick.  Every decode row is
    billed ``per_row_cost`` positions (1 plain, ``speculation_k + 1``
    speculative); the remainder grants prefill chunks to ``prefill`` —
    ``(slot, remaining_prompt_tokens)`` pairs ALREADY in grant order
    (``grant_rank``) — each chunk capped at ``chunk_cap`` (the widest
    chunk bucket).  Returns ``(chunks, stalled)`` where ``chunks`` is
    ``[(slot, chunk_len), ...]`` and ``stalled`` flags a tick whose
    budget was fully consumed by decode rows while prefill work
    waited (the engine's ``prefill_stall_ticks`` counter)."""
    remaining = budget - per_row_cost * n_decode
    chunks: List[Tuple[int, int]] = []
    for slot, rem in prefill:
        if remaining <= 0:
            break
        clen = min(rem, remaining, chunk_cap)
        if clen <= 0:
            continue
        chunks.append((slot, clen))
        remaining -= clen
    return chunks, bool(prefill) and not chunks


def select_subqueue(entries: Iterable[Tuple[Tuple[str, str], float,
                                            float]]):
    """The weighted-stride pop decision: given ``(key, pass, head
    enqueue time)`` for every NONEMPTY subqueue, return the key to
    serve — minimum virtual pass, oldest head entry on ties (two idle
    subqueues re-armed at the same clock must pop FIFO)."""
    best_key = None
    best_rank: Optional[Tuple[float, float]] = None
    for key, pv, enq_t in entries:
        rank = (pv, enq_t)
        if best_rank is None or rank < best_rank:
            best_key, best_rank = key, rank
    return best_key


def stride_charge(policy: QosPolicy, priority: str,
                  waited_s: float) -> float:
    """Virtual-pass advance for serving one entry: ``1 / effective
    weight``.  Aging shrinks a promoted subqueue's stride, so a
    starved batch tenant catches up instead of merely not falling
    further behind."""
    return 1.0 / policy.effective_weight(priority, waited_s)


class WeightedWaitQueue:
    """Weighted deficit/stride scheduler over (priority class, tenant)
    FIFO subqueues, exposing the exact ``collections.deque`` surface
    the engine uses for ``self._waiting`` (``append`` / ``appendleft``
    / ``popleft`` / ``remove`` / iteration / ``len``) so QoS admission
    is a constructor-time swap, not a call-site rewrite.

    Entries are the engine's ``_Req`` tuples; the scheduler reads only
    their ``priority`` / ``tenant`` / ``enq_t`` attributes (absent
    attributes degrade to standard/shared/now).  Each subqueue carries
    a virtual ``pass``; ``popleft`` serves the minimum-pass nonempty
    subqueue (``select_subqueue``) and advances its pass by
    ``stride_charge`` — equal passes per unit work means admission
    slots divide proportionally to weight across classes and EQUALLY
    across tenants inside a class (each (class, tenant) pair is its
    own subqueue at the class weight).

    ``appendleft`` is the engine's requeue path (preemption, blocked
    admission): the entry returns to the FRONT of its own subqueue and
    the pop's stride charge is refunded, so bouncing off a full pool
    costs a tenant nothing.  All call sites run under the engine lock —
    no internal locking.

    ``clock`` injects the time source (default ``time.monotonic``):
    the simulator drives the SAME scheduler on virtual time, which is
    what makes its event logs reproducible byte-for-byte."""

    def __init__(self, policy: QosPolicy, clock=time.monotonic):
        self.policy = policy
        self._now = clock
        self._queues: "collections.OrderedDict[Tuple[str, str], collections.deque]" = \
            collections.OrderedDict()
        self._pass: Dict[Tuple[str, str], float] = {}
        self._clock = 0.0
        self._charges: Dict[int, Tuple[Tuple[str, str], float]] = {}
        self._n = 0

    @staticmethod
    def _key(req) -> Tuple[str, str]:
        return (getattr(req, "priority", "standard"),
                getattr(req, "tenant", ""))

    def _subqueue(self, req) -> collections.deque:
        key = self._key(req)
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = collections.deque()
        if not q:
            # (re)arming an idle subqueue: clamp its pass to the global
            # virtual clock, or a long-idle tenant would bank credit
            # and burst past everyone on return
            self._pass[key] = max(self._pass.get(key, 0.0), self._clock)
        return q

    def append(self, req) -> None:
        """Enqueue at the tail — except that a deadline-carrying entry
        (``req.deadline_t > 0``, monotonic seconds) ranks earliest-
        deadline-first WITHIN its subqueue: it slots ahead of the first
        entry with a later deadline or none at all (no-deadline entries
        read as infinitely patient).  Traffic without deadlines takes
        the plain tail append, so FIFO order — and with it the QoS-off
        parity guarantee — is bit-identical when nobody sends one."""
        q = self._subqueue(req)
        dl = getattr(req, "deadline_t", 0.0) or 0.0
        if dl > 0 and q:
            for i, other in enumerate(q):
                od = getattr(other, "deadline_t", 0.0) or 0.0
                if od <= 0 or od > dl:
                    q.insert(i, req)
                    self._n += 1
                    return
        q.append(req)
        self._n += 1

    def appendleft(self, req) -> None:
        self._subqueue(req).appendleft(req)
        self._n += 1
        ent = self._charges.pop(id(req), None)
        if ent is not None:
            key, prior_pass = ent
            if key == self._key(req):
                self._pass[key] = prior_pass    # requeue is cost-neutral

    def popleft(self):
        if self._n == 0:
            raise IndexError("pop from an empty WeightedWaitQueue")
        now = self._now()
        best_key = select_subqueue(
            (key, self._pass[key], getattr(q[0], "enq_t", now))
            for key, q in self._queues.items() if q)
        q = self._queues[best_key]
        req = q.popleft()
        self._n -= 1
        pv = self._pass[best_key]
        self._clock = max(self._clock, pv)
        waited = now - getattr(req, "enq_t", now)
        self._pass[best_key] = pv + stride_charge(
            self.policy, best_key[0], waited)
        if len(self._charges) > 4096:   # requeues long consumed
            self._charges.clear()
        self._charges[id(req)] = (best_key, pv)
        return req

    def remove(self, req) -> None:
        key = self._key(req)
        q = self._queues.get(key)
        if q is None:
            raise ValueError("WeightedWaitQueue.remove(x): x not in queue")
        q.remove(req)       # raises ValueError like deque when absent
        self._n -= 1

    def __iter__(self):
        for q in self._queues.values():
            yield from q

    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def depths(self) -> Dict[Tuple[str, str], int]:
        """Per-(class, tenant) backlog snapshot (telemetry food)."""
        return {k: len(q) for k, q in self._queues.items() if q}
