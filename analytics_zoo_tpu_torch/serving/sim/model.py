"""Discrete-event model of the continuous-batching engine
(``EngineModel``): admission, chunked/spec/decode tick dispatch, token
budget billing, paged block accounting with pool-dry preemption and QoS
weighted admission, with a timing model in place of the device and a
completion-length oracle in place of the LM.

A copy of ``analytics_zoo_tpu/serving/sim/model.py``, held to it by
``tests/test_torch_serving_pins.py``.  Each scheduling decision is made
by the functions of ``serving/policy.py`` that the port's engine calls;
``tests/test_torch_sim.py`` holds the two decision sequences equal.
Virtual time only: a (config, trace, seed) gives a byte-identical event
log.  Standard library only.
"""

import json
import math
import random
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import policy as scheduler_policy
from ..policy import PRIORITIES, QosPolicy, WeightedWaitQueue
from .trace import Request

__all__ = ["AcceptanceModel", "EngineConfig", "EngineModel",
           "TimingModel", "percentile", "summarize",
           "DEFAULT_SLO_TARGETS"]

#: Mirror of serving/flight.py::DEFAULT_SLO_TARGETS (seconds).  The sim
#: cannot import flight.py (numpy); tests/test_sim.py pins the two
#: tables equal so they cannot drift apart silently.
DEFAULT_SLO_TARGETS: Dict[str, Dict[str, float]] = {
    "interactive": {"ttft": 1.0, "tpot": 0.25, "queue_wait": 0.5},
    "standard": {"ttft": 2.5, "tpot": 0.5, "queue_wait": 2.0},
    "batch": {"ttft": 10.0, "tpot": 2.0, "queue_wait": 30.0},
}


def _t(x: float) -> float:
    """Stable float for event logs: fixed 9-dp rounding."""
    return round(float(x), 9)


# ---------------------------------------------------------------------------
# calibrated sub-models
# ---------------------------------------------------------------------------

class TimingModel:
    """Tick duration, affine in billed tokens:
    ``dur_s = base_s + per_token_s * tokens``.

    ``fit`` calibrates from a bundle's tick records (least squares of
    ``dur_ms`` against billed tokens), so a replayed bundle runs on the
    recorded machine's measured speed rather than a guess."""

    def __init__(self, base_s: float = 0.002,
                 per_token_s: float = 0.00005):
        self.base_s = float(base_s)
        self.per_token_s = float(per_token_s)

    def tick_s(self, tokens: int) -> float:
        return self.base_s + self.per_token_s * max(0, int(tokens))

    def to_dict(self) -> Dict[str, float]:
        return {"base_s": self.base_s, "per_token_s": self.per_token_s}

    @classmethod
    def fit(cls, samples: Sequence[Tuple[int, float]],
            default: Optional["TimingModel"] = None) -> "TimingModel":
        """Least-squares fit of ``(tokens, dur_s)`` samples; degenerate
        inputs (no samples, constant x) fall back to the mean duration
        as ``base_s`` (or ``default`` when there are no samples)."""
        samples = [(int(n), float(d)) for n, d in samples if d >= 0]
        if not samples:
            return default or cls()
        n = len(samples)
        mx = sum(s[0] for s in samples) / n
        my = sum(s[1] for s in samples) / n
        sxx = sum((s[0] - mx) ** 2 for s in samples)
        if sxx <= 0:
            return cls(base_s=my, per_token_s=0.0)
        slope = sum((s[0] - mx) * (s[1] - my) for s in samples) / sxx
        base = my - slope * mx
        if slope < 0 or base < 0:
            # noisy small bundles can fit a negative slope/intercept;
            # clamp to the physically meaningful constant model
            return cls(base_s=max(my, 0.0), per_token_s=0.0)
        return cls(base_s=base, per_token_s=slope)


class AcceptanceModel:
    """Speculative acceptance-length distribution: P(accept_len = a)
    for ``a`` in ``0..k``, sampled per decode row per spec round.

    ``from_counts`` calibrates from the engine's recorded exact counts
    (the ``spec_acceptance`` bundle section / histogram satellite);
    ``constant`` gives a degenerate distribution for what-if sweeps."""

    def __init__(self, k: int, pmf: Sequence[float]):
        if k < 0:
            raise ValueError("k must be >= 0")
        if len(pmf) != k + 1:
            raise ValueError(f"pmf needs k+1={k + 1} entries, "
                             f"got {len(pmf)}")
        total = float(sum(pmf))
        if total <= 0:
            raise ValueError("pmf must have positive mass")
        self.k = int(k)
        self.pmf = [float(p) / total for p in pmf]
        self._cdf = []
        acc = 0.0
        for p in self.pmf:
            acc += p
            self._cdf.append(acc)

    @classmethod
    def from_counts(cls, counts: Dict[Any, int], k: int) -> "AcceptanceModel":
        pmf = [0.0] * (k + 1)
        for key, v in counts.items():
            a = int(key)
            if 0 <= a <= k:
                pmf[a] += int(v)
        if sum(pmf) <= 0:
            return cls.constant(k, k)
        return cls(k, pmf)

    @classmethod
    def constant(cls, accept_len: int, k: int) -> "AcceptanceModel":
        pmf = [0.0] * (k + 1)
        pmf[max(0, min(int(accept_len), k))] = 1.0
        return cls(k, pmf)

    @property
    def mean(self) -> float:
        return sum(a * p for a, p in enumerate(self.pmf))

    def sample(self, rng: random.Random) -> int:
        x = rng.random()
        for a, c in enumerate(self._cdf):
            if x < c:
                return a
        return self.k


# ---------------------------------------------------------------------------
# engine configuration
# ---------------------------------------------------------------------------

@dataclass
class EngineConfig:
    """The scheduling-relevant subset of ``ContinuousEngine``'s
    constructor knobs.  Derived quantities (default token budget, chunk
    buckets, paged caps) reproduce the engine's formulas exactly."""

    slots: int = 8
    max_new_tokens: int = 32
    ticks_per_step: int = 1
    prompt_buckets: Tuple[int, ...] = (16, 32, 64, 128)
    chunked: bool = False
    tick_token_budget: Optional[int] = None
    paged: bool = False
    block_size: int = 16
    n_blocks: Optional[int] = None
    draft_n_blocks: Optional[int] = None
    spec_k: int = 0             # 0 = no draft model
    # tiered KV memory (serving/kv_store.py): a device-tier prefix
    # cache of ``prefix_cache_blocks`` blocks (reserved OUTSIDE
    # ``n_blocks`` — pool pressure and prefix residency are separate
    # modelled choices) with an optional ``host_store_blocks`` host
    # tier behind it.  0/0 = tier off, the historical model.
    prefix_cache_blocks: int = 0
    host_store_blocks: int = 0

    def __post_init__(self):
        self.prompt_buckets = tuple(sorted(int(b)
                                           for b in self.prompt_buckets))
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        if self.paged and self.n_blocks is None:
            # engine default: enough blocks for every slot's full
            # context is the caller's job; the sim wants an explicit
            # number so pool pressure is a modelled choice
            raise ValueError("paged=True needs n_blocks")
        if self.spec_k > 0 and self.paged and self.draft_n_blocks is None:
            self.draft_n_blocks = self.n_blocks
        if self.prefix_cache_blocks < 0 or self.host_store_blocks < 0:
            raise ValueError("tier sizes must be >= 0")
        if self.prefix_cache_blocks > 0 and not self.paged:
            raise ValueError("prefix_cache_blocks needs paged=True")
        if self.host_store_blocks > 0 and self.prefix_cache_blocks <= 0:
            # the host tier is fed by device-tier evictions; without a
            # device tier nothing ever spills into it
            raise ValueError(
                "host_store_blocks needs prefix_cache_blocks > 0")
        if self.prefix_cache_blocks > 0 and self.spec_k > 0:
            # mirror of ContinuousEngine: the tiered store refuses a
            # draft model (two pool tenants in lockstep don't compose
            # with shared-block offsets)
            raise ValueError(
                "prefix_cache_blocks does not compose with spec_k > 0")
        if self.chunked:
            per_row = self.spec_k + 1 if self.spec_k > 0 else 1
            if self.tick_token_budget is None:
                # ContinuousEngine's default budget formula
                budget = max(self.prompt_buckets[0] + per_row * self.slots,
                             2 * per_row * self.slots)
                if self.paged:
                    budget = max(budget, self.block_size)
                self.tick_token_budget = budget
            if self.tick_token_budget < self.prompt_buckets[0]:
                raise ValueError(
                    f"tick_token_budget {self.tick_token_budget} below "
                    f"the smallest prompt bucket "
                    f"{self.prompt_buckets[0]}")
            if self.paged and self.tick_token_budget < self.block_size:
                raise ValueError(
                    f"tick_token_budget {self.tick_token_budget} below "
                    f"block_size {self.block_size}")

    @property
    def chunk_buckets(self) -> Tuple[int, ...]:
        return tuple(b for b in self.prompt_buckets
                     if b <= (self.tick_token_budget or 0))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngineConfig":
        known = {f for f in cls.__dataclass_fields__}  # noqa: C401
        return cls(**{k: v for k, v in d.items() if k in known})


class _Pool:
    """Counter model of ``paged_cache.BlockPool``: block 0 is the sink,
    ``n_blocks - 1`` usable blocks, no prefix cache (so ``allocatable``
    is just the free count)."""

    def __init__(self, n_blocks: int):
        self.n_blocks = int(n_blocks)
        self.free = self.n_blocks - 1
        self.alloc_failures = 0

    def allocatable(self) -> int:
        return self.free

    def allocate(self) -> bool:
        if self.free <= 0:
            self.alloc_failures += 1
            return False
        self.free -= 1
        return True

    def release(self, n: int) -> None:
        self.free += int(n)


class _Row:
    """A resident slot: the sim's ``_Slot``."""

    __slots__ = ("req", "state", "fill_pos", "emitted", "admit_seq",
                 "blocks", "shared", "gen_len")

    def __init__(self, req: "_SimReq", state: str, admit_seq: int):
        self.req = req
        self.state = state
        self.fill_pos = 0
        self.emitted = 0
        self.admit_seq = admit_seq
        self.blocks = 0         # both tenants grow in lockstep
        # blocks served by the prefix-cache tier, NOT held from the
        # pool: growth targets subtract these and release ignores them
        self.shared = 0
        self.gen_len = req.gen_len

    @property
    def pos(self) -> int:
        """Next write position (engine ``_pos``).  The engine parks a
        fresh decode row at ``prompt_len`` with its first token already
        emitted — the token's K/V lands at ``prompt_len`` on the *next*
        forward pass — so a decode row's next write is
        ``prompt_len + emitted - 1``, not ``+ emitted``."""
        return self.req.prompt_len + max(0, self.emitted - 1)


class _SimReq:
    """Queue entry: carries the attributes ``WeightedWaitQueue`` reads
    (``priority`` / ``tenant`` / ``enq_t``) plus the request body.
    Deliberately a plain mutable object — the queue keys refunds by
    ``id()`` like the engine's ``_Req``."""

    __slots__ = ("uri", "prompt_len", "gen_len", "priority", "tenant",
                 "enq_t", "handoff", "prefix_id", "prefix_len",
                 "deadline_t")

    def __init__(self, r: Request, max_new_tokens: int):
        self.uri = r.uri
        self.prompt_len = int(r.prompt_len)
        self.prefix_id = r.prefix_id
        self.prefix_len = int(r.prefix_len)
        self.gen_len = max(1, min(int(r.gen_len), max_new_tokens))
        self.priority = r.priority if r.priority in PRIORITIES \
            else "standard"
        self.tenant = r.tenant
        self.enq_t = float(r.arrival_t)
        # absolute virtual-time deadline (the live wire carries an
        # absolute wall-clock ms; decode_deadline turns it into the
        # consumer's clock — here that clock is the model's ``now``).
        # 0 = none; WeightedWaitQueue EDF-ranks on this attribute.
        self.deadline_t = (self.enq_t + float(r.deadline_s)
                           if float(getattr(r, "deadline_s", 0.0)) > 0
                           else 0.0)
        # tokens already emitted on a prefill replica; None for a plain
        # request.  Set by FleetModel's handoff path — an adopted
        # request admits straight into DECODE (``_admit_adopted``), and
        # a preempted adopted row re-adopts from this same immutable
        # state, exactly like the engine's requeued handoff ``_Req``.
        self.handoff: Optional[int] = None


@dataclass
class _Record:
    """Per-request lifecycle record, mirroring what telemetry's trace
    events expose: every admission epoch observes queue-wait from the
    ORIGINAL arrival, every first token observes TTFT from the original
    arrival (the engine re-stamps both after preemption)."""

    uri: str
    priority: str
    tenant: str
    arrival: float
    admits: List[float] = field(default_factory=list)
    queue_waits: List[float] = field(default_factory=list)
    first_tokens: List[float] = field(default_factory=list)
    preempts: int = 0
    finish_t: Optional[float] = None
    tokens: int = 0
    dropped: Optional[str] = None
    #: Total placements (first submit = 1).  Bumped by the fleet's
    #: crash-recovery redispatch — the sim twin of the live router's
    #: per-request ``attempt`` counter.
    attempts: int = 1

    @property
    def finished(self) -> bool:
        return self.finish_t is not None

    @property
    def ttfts(self) -> List[float]:
        return [ft - self.arrival for ft in self.first_tokens]

    @property
    def tpot(self) -> Optional[float]:
        if not self.finished or self.tokens < 2 or not self.first_tokens:
            return None
        return (self.finish_t - self.first_tokens[-1]) / (self.tokens - 1)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class EngineModel:
    """Virtual-time discrete-event model of ``ContinuousEngine``.

    ``run(trace)`` feeds a sorted request list through the modelled
    engine and returns the per-request records; ``summarize`` turns
    records into per-class latency/goodput tables.  ``record_events``
    keeps the per-tick decision log (admissions, grants, preemptions) —
    turn it off for million-request sweeps where only the summary
    matters."""

    def __init__(self, config: EngineConfig,
                 qos: Optional[QosPolicy] = None,
                 acceptance: Optional[AcceptanceModel] = None,
                 timing: Optional[TimingModel] = None,
                 seed: int = 0, record_events: bool = True,
                 brownout: Optional["scheduler_policy.BrownoutPolicy"]
                 = None,
                 slo_targets: Optional[Dict[str, Dict[str, float]]]
                 = None):
        self.config = config
        self.qos = qos
        self.timing = timing or TimingModel()
        self.rng = random.Random(seed)
        self.seed = int(seed)
        self.record_events = bool(record_events)
        if config.spec_k > 0:
            self.acceptance = acceptance or AcceptanceModel.constant(
                config.spec_k, config.spec_k)
            if self.acceptance.k != config.spec_k:
                raise ValueError(
                    f"acceptance model k={self.acceptance.k} != "
                    f"config spec_k={config.spec_k}")
        else:
            self.acceptance = None

        self.now = 0.0
        S = config.slots
        self._slots: List[Optional[_Row]] = [None] * S
        self._free: deque = deque(range(S))
        self._admit_seq = 0
        self._waiting = (WeightedWaitQueue(qos, clock=lambda: self.now)
                         if qos is not None else deque())
        self._pool = _Pool(config.n_blocks) if config.paged else None
        self._dpool = (_Pool(config.draft_n_blocks)
                       if config.paged and config.spec_k > 0 else None)
        # tiered KV memory: LRU residency at prefix-ID granularity,
        # prefix_id -> resident blocks (see _prefix_admit)
        self._prefix_on = config.paged and config.prefix_cache_blocks > 0
        self._dev_prefix: "OrderedDict[str, int]" = OrderedDict()
        self._host_prefix: "OrderedDict[str, int]" = OrderedDict()
        self.kv_spills = 0
        self.kv_readmits = 0
        self.kv_readmit_tokens_saved = 0
        self.recompute_tokens_saved = 0

        # overload brownout (policy.plan_brownout — the SAME pure
        # controller the live broker runs).  ``brownout=None`` (the
        # default) leaves every code path bit-identical to the
        # pre-brownout model the golden envelopes pin.  A standalone
        # model evaluates the controller itself each tick; FleetModel
        # flips ``brownout_managed`` and pushes fleet-wide levels via
        # ``set_brownout`` instead (the sim's broker-side controller).
        self.brownout = brownout
        self.brownout_managed = False
        self.slo_targets = slo_targets or DEFAULT_SLO_TARGETS
        self._bstate = scheduler_policy.BrownoutState()
        self._goodput_win: Dict[str, deque] = {
            c: deque(maxlen=32) for c in PRIORITIES}
        self._tick_durs: deque = deque(maxlen=8)
        self._alloc_streak = 0
        self._spec_on = True
        self.brownout_sheds = 0
        self.brownout_max_level = 0
        self.brownout_transitions = 0
        self.deadline_sheds = 0
        self.deadline_seen = False

        self.records: Dict[str, _Record] = {}
        self.events: List[Dict[str, Any]] = []
        self.ticks = 0
        # prefill/decode disaggregation (sim/fleet.py): a fleet sets
        # ``handoff_cb`` on its prefill replicas; a row then exports at
        # its first token instead of decoding here.  ``None`` (the
        # default) leaves every code path bit-identical to the
        # single-engine model the determinism tests pin.
        self.handoff_cb = None
        self.handoffs_out = 0
        self.handoffs_in = 0
        self.preemptions = 0
        self.prefill_preemptions = 0
        self.prefill_stall_ticks = 0
        self.budget_ticks = 0
        self.budget_tokens_used = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        # scratch decision lists, reset per tick, flushed to the event
        # log — lets the tick event carry what THIS tick decided
        self._ev_admitted: List[str] = []
        self._ev_preempted: List[str] = []
        self._ev_chunks: List[Tuple[str, int]] = []
        self._ev_dropped: List[str] = []
        # (row, n) emissions decided during a tick, landed at its end
        self._pending_emits: List[Tuple[_Row, int]] = []

    # -- bookkeeping ----------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def _emit(self, kind: str, **kw) -> None:
        if self.record_events:
            ev = {"event": kind, "t": _t(self.now)}
            ev.update(kw)
            self.events.append(ev)

    def event_log_lines(self) -> List[str]:
        """Canonical event-log serialization: one sorted-key compact
        JSON object per line.  Byte-identical across runs of the same
        (config, trace, seed) — the determinism tests hash this."""
        return [json.dumps(e, sort_keys=True, separators=(",", ":"))
                for e in self.events]

    # -- request lifecycle ----------------------------------------------

    def submit(self, r: Request) -> None:
        req = _SimReq(r, self.config.max_new_tokens)
        self.records[req.uri] = _Record(
            uri=req.uri, priority=req.priority, tenant=req.tenant,
            arrival=req.enq_t)
        if req.deadline_t > 0:
            self.deadline_seen = True
        if (self.brownout is not None and self._bstate.level > 0
                and not scheduler_policy.brownout_admit(
                    self._bstate.level, req.priority)):
            # the live front door's brownout 429: a shed class never
            # enters the queue (drops, not deferrals — the client is
            # told to retry later, so the request leaves the system)
            self.brownout_sheds += 1
            self.records[req.uri].dropped = "brownout_shed"
            self._emit("brownout_shed", uri=req.uri,
                       level=self._bstate.level)
            return
        self._waiting.append(req)

    def submit_prefilled(self, req: "_SimReq", record: _Record) -> None:
        """Adopt a handed-off request from a prefill replica
        (``ContinuousEngine.submit_handoff``): the lifecycle record
        continues — same arrival, first token already stamped on the
        source replica — and admission skips prefill entirely
        (``_admit_adopted``)."""
        if req.handoff is None:
            raise ValueError("submit_prefilled needs req.handoff set")
        self.records[req.uri] = record
        self._waiting.append(req)

    def submit_retry(self, r: Request, record: _Record) -> None:
        """Crash-recovery redispatch (``FleetModel``): re-admit a lost
        request from scratch — full re-prefill, full re-generation,
        exactly like the live broker re-reading the original unacked
        stream entry — while CONTINUING its lifecycle record (same
        arrival, ``attempts`` already bumped), so the merged fleet
        records keep one shared entry per uri and TTFT observes the
        original arrival across the death."""
        req = _SimReq(r, self.config.max_new_tokens)
        self.records[req.uri] = record
        self._waiting.append(req)

    def _drop(self, req: "_SimReq", reason: str) -> None:
        self.records[req.uri].dropped = reason
        self._ev_dropped.append(req.uri)

    def _record_admit(self, req: "_SimReq") -> None:
        rec = self.records[req.uri]
        rec.admits.append(self.now)
        rec.queue_waits.append(self.now - rec.arrival)
        self._ev_admitted.append(req.uri)

    def _record_tokens(self, row: _Row, n: int, t: float) -> None:
        """Land ``n`` generated tokens at time ``t``; finish + free the
        slot when the completion length is reached (``_record_token``'s
        finish path)."""
        if n <= 0:
            return
        rec = self.records[row.req.uri]
        if row.emitted == 0:
            rec.first_tokens.append(t)
            if self.handoff_cb is not None and n < row.gen_len:
                # disaggregated prefill replica: export at the first
                # token (ContinuousEngine._handoff_slot) — free the
                # slot like a completion and ship the row; the decode
                # replica finishes it.  A request done at its first
                # token (n >= gen_len) never hands off, matching the
                # engine's not-done condition.
                row.emitted = n
                i = self._slots.index(row)
                self._slots[i] = None
                self._free.append(i)
                self._release_blocks(row)
                self.handoffs_out += 1
                self._emit("handoff_out", uri=row.req.uri)
                self.handoff_cb(row, t)
                return
        row.emitted += n
        if row.emitted >= row.gen_len:
            row.emitted = row.gen_len
            rec.finish_t = t
            rec.tokens = row.gen_len
            i = self._slots.index(row)
            self._slots[i] = None
            self._free.append(i)
            self._release_blocks(row)
            self._emit("finish", uri=row.req.uri, tokens=row.gen_len)
            if self.brownout is not None:
                # per-class windowed goodput: what SloWatchdog's
                # finish-outcome window feeds the live controller — a
                # bounded window, so a bad burst can UNLATCH once the
                # recent finishes come good again
                self._goodput_win[rec.priority].append(self._slo_ok(rec))

    def _release_blocks(self, row: _Row) -> None:
        if self._pool is not None and row.blocks:
            self._pool.release(row.blocks)
            if self._dpool is not None:
                self._dpool.release(row.blocks)
            row.blocks = 0

    # -- preemption (engine `_preempt` / `_grow_tenant`) ----------------

    def _pick_victim(self) -> int:
        return scheduler_policy.pick_victim(
            (i, s.state, s.admit_seq)
            for i, s in enumerate(self._slots) if s is not None)

    def _preempt(self, slot: int) -> None:
        row = self._slots[slot]
        self._slots[slot] = None
        self._free.append(slot)
        self._release_blocks(row)
        self.preemptions += 1
        if row.state == "PREFILLING":
            self.prefill_preemptions += 1
        rec = self.records[row.req.uri]
        rec.preempts += 1
        # partial tokens are discarded; the epoch's first-token stamp
        # stays in history (the engine's watchdog saw it too) and the
        # NEXT epoch re-stamps TTFT from the original arrival
        self._waiting.appendleft(row.req)
        self._ev_preempted.append(row.req.uri)

    def _grow_row(self, i: int, need: int) -> None:
        # ``need`` counts TOTAL blocks for the row's context; blocks
        # served by the prefix-cache tier are already resident outside
        # the pool, so only the private remainder is allocated
        while (self._slots[i] is not None
               and (self._slots[i].blocks
                    + self._slots[i].shared) < need):
            ok = self._pool.allocate()
            if ok and self._dpool is not None:
                if not self._dpool.allocate():
                    self._pool.release(1)
                    ok = False
            if not ok:
                self._preempt(self._pick_victim())
                continue
            self._slots[i].blocks += 1

    def _ensure_blocks(self, active: List[int]) -> List[int]:
        bs = self.config.block_size
        for i in list(active):
            row = self._slots[i]
            if row is None:
                continue
            if self.config.spec_k > 0:
                last_write = row.pos + (self.config.spec_k
                                        if self._spec_on else 0)
            else:
                ticks = max(1, min(self.config.ticks_per_step,
                                   row.gen_len - row.emitted))
                last_write = row.pos + ticks - 1
            self._grow_row(i, last_write // bs + 1)
        return [i for i in active if self._slots[i] is not None]

    def _grow_chunk_blocks(self, decode_rows, chunks) -> None:
        bs = self.config.block_size
        for i in decode_rows:
            if self._slots[i] is None:
                continue
            last_write = self._slots[i].pos + (
                self.config.spec_k
                if self.config.spec_k > 0 and self._spec_on else 0)
            self._grow_row(i, last_write // bs + 1)
        for i, clen in chunks:
            row = self._slots[i]
            if row is None:
                continue
            self._grow_row(i, (row.fill_pos + clen - 1) // bs + 1)

    # -- tiered KV memory (engine kv_store.py wiring) -------------------

    def _shared_block_cap(self, req: "_SimReq") -> int:
        """FULL leading blocks of ``req``'s shared prefix (the engine
        caps matching at ``(plen - 1) // bs`` so the final write block
        is always private)."""
        return (min(int(req.prefix_len), req.prompt_len - 1)
                // self.config.block_size)

    def _prefix_peek(self, req: "_SimReq") -> int:
        """Device-tier match depth, side-effect free.  Admission gates
        use this exactly like the engine uses ``BlockPool.lookup``: the
        host tier only extends the match AFTER the gates pass, so both
        gate conservatively on the device match alone."""
        if not self._prefix_on or not req.prefix_id:
            return 0
        n_shared = self._shared_block_cap(req)
        if n_shared <= 0 or req.prefix_id not in self._dev_prefix:
            return 0
        return min(self._dev_prefix[req.prefix_id], n_shared)

    def _prefix_admit(self, req: "_SimReq") -> int:
        """Commit the tier transaction for an admitted request: match
        against the device tier, fall back to a host-tier re-admission
        (counted; the host entry stays, mirroring the engine's
        rollback contract), then publish the request's full shared
        depth to the device tier.  Returns matched full blocks."""
        if not self._prefix_on or not req.prefix_id:
            return 0
        bs = self.config.block_size
        n_shared = self._shared_block_cap(req)
        if n_shared <= 0:
            return 0
        pid = req.prefix_id
        if pid in self._dev_prefix:
            matched = min(self._dev_prefix[pid], n_shared)
        elif pid in self._host_prefix:
            matched = min(self._host_prefix[pid], n_shared)
            self._host_prefix.move_to_end(pid)
            self.kv_readmits += 1
            self.kv_readmit_tokens_saved += matched * bs
        else:
            matched = 0
        self.recompute_tokens_saved += matched * bs
        self._publish_prefix(pid, n_shared)
        return matched

    def _publish_prefix(self, pid: str, n: int) -> None:
        """Install/refresh ``pid`` in the device tier (LRU over prefix
        ids, capacity in blocks), spilling evictees to the host tier
        when one is configured."""
        self._dev_prefix[pid] = max(n, self._dev_prefix.get(pid, 0))
        self._dev_prefix.move_to_end(pid)
        cap = self.config.prefix_cache_blocks
        while (self._dev_prefix
               and sum(self._dev_prefix.values()) > cap):
            victim, d = self._dev_prefix.popitem(last=False)
            self._spill_prefix(victim, d)

    def _spill_prefix(self, pid: str, d: int) -> None:
        if self.config.host_store_blocks <= 0:
            return
        self.kv_spills += d     # the engine spills (and counts) blocks
        self._host_prefix[pid] = max(d, self._host_prefix.get(pid, 0))
        self._host_prefix.move_to_end(pid)
        while (self._host_prefix
               and (sum(self._host_prefix.values())
                    > self.config.host_store_blocks)):
            self._host_prefix.popitem(last=False)

    def prefix_resident_blocks(self, prefix_id: str) -> int:
        """Resident depth of ``prefix_id`` across BOTH tiers — what the
        fleet's ``PrefixDirectory`` lookup would report for this
        replica (``policy.ReplicaSignals.prefix_blocks``)."""
        if not self._prefix_on or not prefix_id:
            return 0
        return max(self._dev_prefix.get(prefix_id, 0),
                   self._host_prefix.get(prefix_id, 0))

    # -- overload brownout (engine/broker controller twin) --------------

    @property
    def brownout_level(self) -> int:
        return self._bstate.level

    def set_brownout(self, level: int) -> None:
        """External (fleet) controller pushing a ladder level — the
        sim's ``ContinuousEngine.set_brownout``."""
        lvl = max(0, min(int(level), scheduler_policy.BROWNOUT_MAX_LEVEL))
        if lvl != self._bstate.level:
            self.brownout_transitions += 1
            self.brownout_max_level = max(self.brownout_max_level, lvl)
            self._emit("brownout_level", level=lvl,
                       prev=self._bstate.level)
            self._bstate = scheduler_policy.BrownoutState(level=lvl)

    def _slo_ok(self, rec: _Record) -> bool:
        """Judge one finished request exactly like ``summarize`` (and
        the live SloWatchdog): good iff no observation of any dimension
        breached its class target."""
        tgt = self.slo_targets.get(rec.priority, {})
        for metric, obs in (("queue_wait", rec.queue_waits),
                            ("ttft", rec.ttfts)):
            lim = float(tgt.get(metric, 0.0))
            if lim > 0 and any(v > lim for v in obs):
                return False
        lim = float(tgt.get("tpot", 0.0))
        if lim > 0 and rec.tpot is not None and rec.tpot > lim:
            return False
        return True

    def windowed_goodput(self) -> Dict[str, float]:
        """Per-class goodput over the recent-finish window (1.0 cold,
        like the live ``SloWatchdog.windowed_goodput``)."""
        out: Dict[str, float] = {}
        for cls in PRIORITIES:
            win = self._goodput_win[cls]
            out[cls] = (sum(1 for ok in win if ok) / len(win)
                        if win else 1.0)
        return out

    def _brownout_step(self) -> None:
        """One standalone-controller decision on this tick's signals —
        the engine-level twin of the live broker's ``_brownout_eval``."""
        prev = self._bstate
        self._bstate = scheduler_policy.plan_brownout(
            self.brownout, prev,
            goodput=self.windowed_goodput(),
            queue_depth=len(self._waiting),
            alloc_fail_streak=self._alloc_streak,
            tick_s=(sum(self._tick_durs) / len(self._tick_durs)
                    if self._tick_durs else None))
        if self._bstate.level != prev.level:
            self.brownout_transitions += 1
            self.brownout_max_level = max(self.brownout_max_level,
                                          self._bstate.level)
            self._emit("brownout_level", level=self._bstate.level,
                       prev=prev.level)

    # -- admission (engine `_admit` family) -----------------------------

    def _pop_waiting(self) -> Optional["_SimReq"]:
        return self._waiting.popleft() if self._waiting else None

    def _requeue_front(self, req: "_SimReq") -> None:
        self._waiting.appendleft(req)

    def _admit(self) -> int:
        if self.deadline_seen:
            # the engine's _shed_expired_waiting: sweep the WHOLE
            # queue — including brownout-deferred classes, which is
            # what lets a shed class's backlog drain (and the ladder
            # recover) while the class is not being admitted
            expired = [r for r in self._waiting
                       if r.deadline_t > 0 and self.now > r.deadline_t]
            for r in expired:
                self._waiting.remove(r)
                self.deadline_sheds += 1
                self._drop(r, "deadline_exceeded")
        deferred: List[_SimReq] = []
        if self.brownout is not None and self._bstate.level >= 1:
            # the engine's _brownout_defer_extract: already-queued
            # requests of a shed class are HELD (still aging), not
            # dropped — only the front door drops new arrivals
            lvl = self._bstate.level
            deferred = [r for r in self._waiting
                        if not scheduler_policy.brownout_admit(
                            lvl, r.priority)]
            for r in deferred:
                self._waiting.remove(r)
        try:
            admitted = self._admit_pass()
            if deferred and admitted == 0 and self._free \
                    and not len(self._waiting):
                # work-conserving brownout (engine `_admit` second
                # pass): zero admissible demand + free slots means the
                # held backlog serves opportunistically instead of
                # idling the engine and latching the depth signal
                for r in reversed(deferred):
                    self._waiting.appendleft(r)
                deferred = []
                admitted = self._admit_pass()
            return admitted
        finally:
            for r in reversed(deferred):
                self._waiting.appendleft(r)

    def _admit_pass(self) -> int:
        if self.config.chunked:
            return self._admit_chunked()
        return self._admit_monolithic()

    def _admit_chunked(self) -> int:
        admitted = 0
        while self._free:
            req = self._pop_waiting()
            if req is None:
                break
            if req.handoff is not None:
                res = self._admit_adopted(req)
            else:
                res = (self._admit_one_chunked_paged(req)
                       if self.config.paged
                       else self._admit_one_chunked(req))
            if res == "admitted":
                admitted += 1
            elif res == "blocked":
                self._requeue_front(req)
                break
        return admitted

    def _install_prefill(self, req: "_SimReq", shared: int = 0) -> None:
        slot = self._free.popleft()
        row = _Row(req, "PREFILLING", self._admit_seq)
        self._admit_seq += 1
        if self.brownout is not None:
            # level-2 clamp, applied at install time like the engine's
            # _install_prefill — the level in force WHEN the row lands
            # decides its budget, so a descending ladder restores full
            # completions for later admissions
            row.gen_len = scheduler_policy.brownout_max_new(
                self._bstate.level, req.priority, row.gen_len,
                self.brownout.standard_max_new)
        if shared:
            # matched prefix blocks are already filled: prefill starts
            # past them (this is where recompute savings become real
            # work saved — chunked billing never sees those tokens)
            row.shared = shared
            row.fill_pos = shared * self.config.block_size
        self._slots[slot] = row
        self._record_admit(req)

    def _admit_one_chunked(self, req: "_SimReq") -> str:
        self._install_prefill(req)
        return "admitted"

    def _admit_one_chunked_paged(self, req: "_SimReq") -> str:
        bs = self.config.block_size
        plen = req.prompt_len
        need = -(-plen // bs) - self._prefix_peek(req)
        cap = self._pool.n_blocks - 1
        if self._dpool is not None:
            cap = min(cap, self._dpool.n_blocks - 1)
        if need + 1 > cap:
            self._drop(req, "prompt_exceeds_pool")
            return "error"
        dry = self._pool.allocatable() < 2 or (
            self._dpool is not None and self._dpool.allocatable() < 2)
        if dry:
            if self.n_active == 0:
                self._drop(req, "pool_dry_no_residents")
                return "error"
            return "blocked"
        # commit the tier transaction only once the gates pass — a
        # blocked request requeues and must not double-count readmits
        self._install_prefill(req, self._prefix_admit(req))
        return "admitted"

    def _admit_adopted(self, req: "_SimReq") -> str:
        """Admit a handed-off row straight into DECODE
        (``ContinuousEngine._admit_handoff``): blocks for the prompt's
        KV chain plus one decode block of headroom, no prefill phase,
        first token NOT re-emitted (the source replica stamped it)."""
        if self.config.paged:
            bs = self.config.block_size
            need = -(-req.prompt_len // bs)
            cap = self._pool.n_blocks - 1
            if self._dpool is not None:
                cap = min(cap, self._dpool.n_blocks - 1)
            if need + 1 > cap:
                self._drop(req, "prompt_exceeds_pool")
                return "error"
            short = self._pool.allocatable() < need + 1 or (
                self._dpool is not None
                and self._dpool.allocatable() < need + 1)
            if short:
                if self.n_active == 0:
                    self._drop(req, "pool_dry_no_residents")
                    return "error"
                return "blocked"
        slot = self._free.popleft()
        row = _Row(req, "DECODE", self._admit_seq)
        self._admit_seq += 1
        row.fill_pos = req.prompt_len
        row.emitted = int(req.handoff)
        self._slots[slot] = row
        if self.config.paged:
            need = -(-req.prompt_len // self.config.block_size)
            row.blocks = need
            self._pool.free -= need
            if self._dpool is not None:
                self._dpool.free -= need
        self.handoffs_in += 1
        self._record_admit(req)
        self._emit("handoff_in", uri=req.uri)
        return "admitted"

    def _admit_monolithic(self) -> int:
        """Non-chunked admission, approximated: the whole prompt
        prefills at admission time (first token stamped immediately);
        paged admission gates on blocks for the full prompt plus one
        decode block of headroom, requeueing at the front when the pool
        cannot take it (``_admit_paged``'s plan gate)."""
        admitted = 0
        while self._free:
            req = self._pop_waiting()
            if req is None:
                break
            if req.handoff is not None:
                res = self._admit_adopted(req)
                if res == "admitted":
                    admitted += 1
                elif res == "blocked":
                    self._requeue_front(req)
                    break
                continue
            if self.config.paged:
                bs = self.config.block_size
                need = -(-req.prompt_len // bs) + 1 \
                    - self._prefix_peek(req)
                cap = self._pool.n_blocks - 1
                if self._dpool is not None:
                    cap = min(cap, self._dpool.n_blocks - 1)
                if need > cap:
                    self._drop(req, "prompt_exceeds_pool")
                    continue
                short = self._pool.allocatable() < need or (
                    self._dpool is not None
                    and self._dpool.allocatable() < need)
                if short:
                    if self.n_active == 0:
                        self._drop(req, "pool_dry_no_residents")
                        continue
                    self._requeue_front(req)
                    break
                # gates passed: commit the tier transaction (the host
                # tier may extend the match, so recompute need)
                shared = self._prefix_admit(req)
                need = -(-req.prompt_len // bs) + 1 - shared
            slot = self._free.popleft()
            row = _Row(req, "DECODE", self._admit_seq)
            self._admit_seq += 1
            if self.brownout is not None:
                row.gen_len = scheduler_policy.brownout_max_new(
                    self._bstate.level, req.priority, row.gen_len,
                    self.brownout.standard_max_new)
            row.fill_pos = req.prompt_len
            self._slots[slot] = row
            if self.config.paged:
                row.blocks = need
                row.shared = shared
                self._pool.free -= need
                if self._dpool is not None:
                    self._dpool.free -= need
            self._record_admit(req)
            # monolithic prefill picks the request's first token
            self._record_tokens(row, 1, self.now)
            admitted += 1
        return admitted

    # -- grant ordering --------------------------------------------------

    def _grant_rank(self, i: int):
        row = self._slots[i]
        return scheduler_policy.grant_rank(
            self.qos, row.req.priority, self.now - row.req.enq_t,
            row.admit_seq)

    # -- ticks (engine `_step_impl` dispatch) ----------------------------

    def step(self) -> int:
        """One engine iteration on virtual time.  Returns active slots
        after the tick; 0 means idle (no tick happened)."""
        if self.n_active == 0 and not self._waiting:
            return 0
        self._ev_admitted, self._ev_preempted = [], []
        self._ev_chunks, self._ev_dropped = [], []
        t0 = self.now
        f0 = 0
        if self._pool is not None:
            f0 = self._pool.alloc_failures + (
                self._dpool.alloc_failures
                if self._dpool is not None else 0)
        self._admit()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            # every waiting request errored out during admission — or,
            # under brownout, everything left waiting is a deferred
            # shed-class request: idle-tick the clock forward so the
            # controller can observe the drained engine and descend
            # (the model must not spin without advancing time)
            self._tick_event("admit", t0, 0.0, 0)
            if self.brownout is not None and len(self._waiting) > 0:
                dur = self.timing.tick_s(0)
                self.now = t0 + dur
                self.ticks += 1
                self._tick_durs.append(dur)
                self._alloc_streak = 0
                if not self.brownout_managed:
                    self._brownout_step()
            return 0
        spec = self.config.spec_k > 0
        if spec and self.brownout is not None:
            # level-3: park the draft model (the engine's
            # brownout_spec_enabled gate in _step_impl)
            spec = scheduler_policy.brownout_spec_enabled(
                self._bstate.level)
        self._spec_on = spec or self.config.spec_k == 0
        prefilling = any(self._slots[i].state == "PREFILLING"
                         for i in active)
        if spec and self.config.chunked and prefilling:
            kind, work = self._chunked_tick(active,
                                            self.config.spec_k + 1)
            kind = "spec_chunked"
        elif spec:
            kind, work = self._spec_tick(active)
        elif self.config.chunked and prefilling:
            kind, work = self._chunked_tick(active, 1)
        else:
            kind, work = self._decode_tick(active)
        dur = self.timing.tick_s(work)
        self.now = t0 + dur
        self._apply_emissions()
        self._admit()       # freed slots recycle on the SAME iteration
        self.ticks += 1
        self._tick_event(kind, t0, dur, work)
        if self.brownout is not None:
            self._tick_durs.append(dur)
            if self._pool is not None:
                f1 = self._pool.alloc_failures + (
                    self._dpool.alloc_failures
                    if self._dpool is not None else 0)
                self._alloc_streak = (self._alloc_streak + 1
                                      if f1 > f0 else 0)
            if not self.brownout_managed:
                self._brownout_step()
        return self.n_active

    def _tick_event(self, kind: str, t0: float, dur: float,
                    work: int) -> None:
        if not self.record_events:
            return
        ev = {"event": "tick", "seq": self.ticks, "t": _t(t0),
              "dur_s": _t(dur), "kind": kind, "work": int(work),
              "active": self.n_active,
              "queue_depth": len(self._waiting),
              "admitted": list(self._ev_admitted),
              "preempted": list(self._ev_preempted),
              "chunks": [[u, int(c)] for u, c in self._ev_chunks]}
        if self._ev_dropped:
            ev["dropped"] = list(self._ev_dropped)
        if self._pool is not None:
            ev["free_blocks"] = self._pool.allocatable()
            if self._dpool is not None:
                ev["draft_free_blocks"] = self._dpool.allocatable()
        if self._prefix_on:
            # cumulative, like the flight recorder's v3 counters; only
            # tiered configs emit them so tier-off logs stay
            # byte-identical to previous releases
            ev["kv_spills"] = self.kv_spills
            ev["kv_readmits"] = self.kv_readmits
        self.events.append(ev)

    # Emissions are decided during the tick but land at its END (see
    # module docstring); the tick body queues (row, n) pairs here.
    def _queue_emit(self, row: _Row, n: int) -> None:
        self._pending_emits.append((row, n))

    def _apply_emissions(self) -> None:
        for row, n in self._pending_emits:
            # a row preempted AFTER its emission was queued lost those
            # tokens (the engine discards them too)
            if row in self._slots:
                self._record_tokens(row, n, self.now)
        self._pending_emits = []

    def _decode_tick(self, active: List[int]) -> Tuple[str, int]:
        self._pending_emits = []
        if self.config.paged:
            active = self._ensure_blocks(active)
            if not active:
                return "decode", 0
        if self.config.spec_k > 0 and not self._spec_on:
            # brownout level 3 parked the draft: plain decode, one
            # token per tick (the engine forces n_eff=1 whenever a
            # draft tenant exists, to hold the lockstep write frontier)
            n_eff = 1
        else:
            n_eff = max(1, min(
                self.config.ticks_per_step,
                max(self._slots[i].gen_len - self._slots[i].emitted
                    for i in active)))
        work = 0
        for i in active:
            row = self._slots[i]
            n = min(n_eff, row.gen_len - row.emitted)
            self._queue_emit(row, n)
            work += n_eff
        return "decode", work

    def _spec_tick(self, active: List[int]) -> Tuple[str, int]:
        self._pending_emits = []
        if self.config.paged:
            active = self._ensure_blocks(active)
            if not active:
                return "spec", 0
        k = self.config.spec_k
        work = 0
        for i in active:
            row = self._slots[i]
            a = self.acceptance.sample(self.rng)
            self.spec_proposed += k
            self.spec_accepted += a
            self._queue_emit(row, min(a + 1, row.gen_len - row.emitted))
            work += k + 1
        return "spec", work

    def _chunked_tick(self, active: List[int],
                      per_row: int) -> Tuple[str, int]:
        self._pending_emits = []
        decode_rows = [i for i in active
                       if self._slots[i].state == "DECODE"]
        prefill_rows = sorted(
            (i for i in active
             if self._slots[i].state == "PREFILLING"),
            key=self._grant_rank)
        chunks, stalled = scheduler_policy.plan_chunks(
            self.config.tick_token_budget, per_row, len(decode_rows),
            [(i, self._slots[i].req.prompt_len - self._slots[i].fill_pos)
             for i in prefill_rows],
            self.config.chunk_buckets[-1])
        if stalled:
            self.prefill_stall_ticks += 1
        if self.config.paged:
            self._grow_chunk_blocks(decode_rows, chunks)  # may preempt
            decode_rows = [i for i in decode_rows
                           if self._slots[i] is not None]
            chunks = [(i, c) for i, c in chunks
                      if self._slots[i] is not None]
        if not decode_rows and not chunks:
            return "chunked", 0
        self.budget_ticks += 1
        work = per_row * len(decode_rows) + sum(c for _, c in chunks)
        self.budget_tokens_used += work
        k = self.config.spec_k if self._spec_on else 0
        for i in decode_rows:
            row = self._slots[i]
            if k > 0:
                a = self.acceptance.sample(self.rng)
                self.spec_proposed += k
                self.spec_accepted += a
                n = min(a + 1, row.gen_len - row.emitted)
            else:
                n = 1
            self._queue_emit(row, n)
        for i, clen in chunks:
            row = self._slots[i]
            row.fill_pos += clen
            self._ev_chunks.append((row.req.uri, clen))
            if row.fill_pos >= row.req.prompt_len:
                row.state = "DECODE"
                # the prompt's final chunk also picks its first token
                self._queue_emit(row, 1)
        return "chunked", work

    # -- driving ---------------------------------------------------------

    def run(self, trace: Sequence[Request],
            max_ticks: Optional[int] = None) -> Dict[str, _Record]:
        """Feed ``trace`` (sorted by arrival) through the model until
        every request finishes or drops.  The clock jumps across idle
        gaps to the next arrival, mirroring the serving pump's idle
        wait."""
        pending = sorted(trace, key=lambda r: (r.arrival_t, r.uri))
        i = 0
        guard = max_ticks if max_ticks is not None else \
            20_000_000
        while True:
            while i < len(pending) and pending[i].arrival_t <= self.now:
                self.submit(pending[i])
                i += 1
            if self.n_active == 0 and not self._waiting:
                if i < len(pending):
                    self.now = max(self.now, pending[i].arrival_t)
                    continue
                break
            self.step()
            if self.ticks >= guard:
                raise RuntimeError(
                    f"simulation exceeded {guard} ticks "
                    f"(arrival rate beyond modelled capacity?)")
        return self.records


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))
    return s[k]


def _dist(xs: List[float]) -> Dict[str, float]:
    return {"n": len(xs),
            "mean": _t(sum(xs) / len(xs)) if xs else 0.0,
            "p50": _t(percentile(xs, 50)),
            "p99": _t(percentile(xs, 99))}


def summarize(records, targets: Optional[Dict[str, Dict[str, float]]]
              = None) -> Dict[str, Any]:
    """Per-class latency distributions + SLO goodput from request
    records.  Judges requests exactly like ``SloWatchdog``: a request
    is GOOD when no observation of any dimension breached its class
    target (every admission epoch's queue wait and TTFT counts — a
    preempted request that breached before preemption stays bad).
    ``records`` accepts the model's ``_Record`` map or any iterable of
    objects/dicts with the same fields."""
    targets = targets or DEFAULT_SLO_TARGETS
    if isinstance(records, dict):
        records = list(records.values())
    per_class: Dict[str, Dict[str, Any]] = {}
    dropped = 0
    total_tokens = 0
    end_t = 0.0
    for cls in PRIORITIES:
        rows = [r for r in records if r.priority == cls]
        if not rows:
            continue
        fin = [r for r in rows if r.finished]
        tgt = targets.get(cls, {})
        good = 0
        for r in fin:
            ok = True
            for metric, obs in (("queue_wait", r.queue_waits),
                                ("ttft", r.ttfts)):
                lim = float(tgt.get(metric, 0.0))
                if lim > 0 and any(v > lim for v in obs):
                    ok = False
            lim = float(tgt.get("tpot", 0.0))
            if lim > 0 and r.tpot is not None and r.tpot > lim:
                ok = False
            if ok:
                good += 1
        dropped += sum(1 for r in rows if r.dropped)
        total_tokens += sum(r.tokens for r in fin)
        if fin:
            end_t = max(end_t, max(r.finish_t for r in fin))
        per_class[cls] = {
            "submitted": len(rows),
            "finished": len(fin),
            "good": good,
            "goodput": _t(good / len(fin)) if fin else 1.0,
            "preemptions": sum(r.preempts for r in rows),
            "ttft": _dist([r.ttfts[-1] for r in fin if r.ttfts]),
            "tpot": _dist([r.tpot for r in fin
                           if r.tpot is not None]),
            "queue_wait": _dist([w for r in fin
                                 for w in r.queue_waits]),
        }
    n_fin = sum(c["finished"] for c in per_class.values())
    n_good = sum(c["good"] for c in per_class.values())
    return {
        "per_class": per_class,
        "finished": n_fin,
        "good": n_good,
        "goodput": _t(n_good / n_fin) if n_fin else 1.0,
        "dropped": dropped,
        "tokens": total_tokens,
        "duration_s": _t(end_t),
        "tokens_per_s": _t(total_tokens / end_t) if end_t > 0 else 0.0,
    }
