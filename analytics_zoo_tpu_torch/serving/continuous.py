"""Continuous batching for generative serving, on a slot arena or a
paged KV cache.

The port of ``analytics_zoo_tpu/serving/continuous.py``.

- **Arena** (``paged=False``, the default, as in the reference): every
  slot owns a full-length row of one ``[n_layers, S, L, kv_heads, D]``
  cache.  Joiners sharing a prompt bucket prefill together in one
  causal forward (``TransformerLM.prefill``, whose attention is the
  flash kernel on a CUDA device), and each row's K/V are copied into
  its slot.  ``register_prefix`` prefills a shared prompt prefix once;
  requests naming it get the stored K/V spliced into their rows and
  prefill only their suffix against it (``prefill_chunk``).
- **Paged** (``paged=True``): K/V live in one flat pool of
  ``block_size``-token blocks per layer (``[n_layers, N, kv_heads, bs,
  D]``, head-major); each resident holds only the blocks it has filled,
  through a per-slot block table kept on the host by
  :class:`BlockPool`.  Full prompt blocks are hash-indexed, so a request
  sharing a prompt prefix attaches to the same physical blocks and
  prefills only its suffix; when the pool runs dry the latest admission
  is PREEMPTED back to the queue front and regenerates the same tokens
  on readmission.

- **Chunked prefill** (``chunked=True``, either cache): admission runs
  no prefill; a request is installed PREFILLING and its prompt lands
  chunk by chunk inside the ticks, next to the decodes, under a per-tick
  token budget (``tick_token_budget``), so a long prompt does not stall
  the residents.  A tick decodes every slot once and then runs the
  tick's chunks in one ``prefill_chunk`` (arena, on a window of the
  chunk rows' caches) or ``prefill_chunk_paged`` call (through block
  tables sliced narrow to the fill frontier, writes limited to each
  chunk's true length); a prompt's last chunk picks its first token.
- **Speculative decoding** (``draft_model=``, either cache, greedy
  only): a round runs k+1 cached draft steps, verifies the k proposals
  of every row in one ``verify_step`` (arena) or ``verify_step_paged``
  call, accepts each row's longest matching prefix
  (``models.speculative.accept_proposals``) and advances each row by
  its own count; rejected entries stay written past the pointer and
  the next round overwrites them.  The draft keeps its own arena, or
  its own block pool (a second pool tenant, grown and freed in
  lockstep with the target's).  With ``chunked=True`` as well, a tick
  with PREFILLING rows runs a spec round for the decoders and lands the
  chunks in both models' caches.

Decode is one ``decode_step`` (arena) or ``decode_step_paged`` per
tick, ``ticks_per_step`` ticks per :meth:`ContinuousEngine.step` in a
plain Python loop.  PyTorch runs eagerly, so nothing is compiled per
shape; monolithic admission groups are not padded to a power of two,
and chunk grids are (their row count and width bucketed as in the
reference, padding rows on all-sink tables); caches are updated in
place where the JAX engine donates its buffers.

Every pick, the first token of an admission and each decode tick's, goes
through ``models.lm.pick_next``: greedy argmax, or with ``temperature >
0`` a draw that is a pure function of (``rng_seed``, absolute position,
logits), so a preempted row replays identical tokens and the engine
emits what ``generate`` emits for the same seed.

The engine carries the reference's serving surface: the ``Telemetry``
request-lifecycle hooks and scrape-time gauges (``/metrics``), the
per-tick flight recorder, the fault injector's tick hook, and the
accessors ``ClusterServing`` reads, and the reference's production
modes:

- **QoS** (``qos=``): the waiting queue is a ``WeightedWaitQueue``
  (weighted stride over (class, tenant) subqueues, EDF inside a class)
  and chunk grants rank by aged class first; ``qos=None`` keeps the
  plain FIFO deque.
- **Deadlines and brownout**: ``submit(deadline_t=)`` sheds a request
  whose deadline passed before any prefill (``DeadlineExceeded``);
  ``set_brownout`` levels 1-4 defer batch admission (work-conserving
  when slots idle), clamp standard ``max_new``, drop speculative rounds
  and admit interactive only.
- **Host KV tier** (``kv_host_store_bytes``, paged): evicted indexed
  blocks spill to a ``HostKVStore`` in one batched D2H gather a wave
  and are readmitted H2D at admission instead of re-prefilled;
  ``prefix_directory`` mirrors both tiers' membership fleet-wide.
- **Elastic pool** (``elastic_pool``, paged): ``resize_pool`` grows or
  shrinks both tenants' pools at the eviction boundary, and
  ``maybe_autoresize`` runs ``policy.plan_pool_resize``.
- **Prefill/decode handoff** (paged, greedy, no draft):
  ``submit(handoff_cb=)`` exports a row's block chain and a copy of its
  K/V at first-token time; ``submit_handoff`` adopts it on another
  engine, which decodes it without a prefill.

The pools are updated in place (the reference donates them), so every
ordering rule the reference states is a real hazard here: an evicted
block is gathered to the host before any write can reuse its id, and
no device copy runs under the pool lock.
- **Tensor parallelism** (``mesh`` with a ``tp`` axis, one process a
  rank): the model is sharded by ``partition_rules``
  (``models.lm.shard_lm``, default ``LM_PARTITION_RULES``), the arena
  or pool holds this rank's kv heads from birth (every kv head when
  they do not divide tp: the replicated hatch), and the block tables
  and every host decision stay identical on every rank.  Every other
  axis of the mesh replicates (a ``{"dp": 2, "tp": 2}`` mesh serves the
  tokens of ``{"tp": 2}`` on each dp line).  The rank at coordinate 0
  on every axis is the leader: ``submit``, ``submit_handoff``,
  ``abort``, ``set_brownout``, ``register_prefix``,
  ``unregister_prefix``, ``resize_pool`` and ``step`` on it broadcast
  each mutation with the tick's clock reading (a gloo control group
  over every rank of the mesh), the other ranks apply them in the same
  order from ``follow()``, so admission, preemption, chunk budgets,
  deadline sheds, the brownout ladder, elastic resizes, host-tier
  spills and readmits decide alike everywhere; the pick reads
  all-gathered logits.  Each rank spills and readmits its own kv-head
  shard; only the leader publishes to the prefix directory.  A handoff
  moves each rank's shard of the chain between that rank's two
  engines (a follower's export waits, keyed by uri, for the replayed
  adoptions until the leader drops its own copy of the chain).
  ``stop_followers`` ends their loops.  On a mesh whose ``tp`` is 1 the
  engine serves this rank alone.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import (Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.learn.inference_model import (
    _next_bucket, filter_prompt_buckets)
from analytics_zoo_tpu_torch.models.lm import (TransformerLM, load_sharded,
                                               pick_next, shard_lm)
from analytics_zoo_tpu_torch.models.speculative import (
    accept_proposals, load_draft)
from analytics_zoo_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS, KV_SCALE_DTYPE, PAGED_MAX_BLOCK, QuantKV,
    paged_kernel_takes)
from analytics_zoo_tpu_torch.serving import policy as scheduler_policy
from analytics_zoo_tpu_torch.serving.flight import FlightRecorder
from analytics_zoo_tpu_torch.serving.frontdoor import PRIORITIES
from analytics_zoo_tpu_torch.serving.kv_store import (HostKVStore,
                                                      TIER_HBM, TIER_HOST)
from analytics_zoo_tpu_torch.serving.paged_cache import (
    BlockPool, SINK_BLOCK, block_bytes, split_block_budget)
from analytics_zoo_tpu_torch.serving.policy import WeightedWaitQueue
from analytics_zoo_tpu_torch.serving.telemetry import Telemetry

logger = logging.getLogger("analytics_zoo_tpu_torch")

_KV_LABELS = {torch.bfloat16: "bf16", torch.float32: "f32",
              torch.float16: "f16", torch.float64: "f64"}


def _kv_map(fn, *pools):
    """``fn`` over KV pool tensors, or over each part of ``QuantKV``
    pools (int8 data, then scales): a copy of an int8 pool must move
    its scales with its data."""
    if isinstance(pools[0], QuantKV):
        return QuantKV(fn(*(p.data for p in pools)),
                       fn(*(p.scale for p in pools)))
    return fn(*pools)


def _kv_parts(pool) -> list:
    """The tensors of one KV pool: itself, or an int8 pool's data and
    scales."""
    return [pool.data, pool.scale] if isinstance(pool, QuantKV) \
        else [pool]


def _kv_scatter(dst, idx: torch.Tensor, src) -> None:
    """Write ``src`` (``[layers, n, ...]`` per part, on any device) into
    pool ``dst`` at block ids ``idx``, in place."""
    for d, s in zip(_kv_parts(dst), _kv_parts(src)):
        d[:, idx] = s.to(device=d.device, dtype=d.dtype)


class DeadlineExceeded(RuntimeError):
    """Terminal error of a request shed at ADMISSION because its
    end-to-end deadline had already passed, apart from the supervisor's
    in-flight deadline give-up.  The message starts with
    ``deadline_exceeded``, the wire error event's name."""


class _Req(NamedTuple):
    """One waiting-queue entry."""

    uri: str
    prompt: np.ndarray
    on_done: Optional[Callable]
    on_error: Optional[Callable]
    max_new: int
    on_token: Optional[Callable] = None
    prefix: Optional[int] = None
    temperature: float = 0.0
    rng_seed: Optional[int] = None
    top_p: float = 0.0
    # front-door fields: the QoS scheduler's class, tenant and arrival
    # (``time.monotonic``); recorded for telemetry without QoS
    priority: str = "standard"
    tenant: str = ""
    enq_t: float = 0.0
    # prefill/decode handoff: on the SOURCE engine ``handoff_cb(state)``
    # fires when the prompt's first token lands; on the DESTINATION
    # ``handoff_state`` carries the exported chain (``submit_handoff``)
    handoff_cb: Optional[Callable] = None
    handoff_state: Optional[dict] = None
    # a follower's copy of a handoff_cb request: its export parks this
    # rank's shard for the replayed adoption (``_HandoffBox``)
    park_handoff: bool = False
    # absolute ``time.monotonic`` deadline, 0.0 = none: admission sheds
    # an entry already past it before any prefill
    deadline_t: float = 0.0


@dataclass
class _Slot:
    uri: str
    max_new: int
    tokens: List[int] = field(default_factory=list)
    on_done: Optional[Callable] = None
    on_token: Optional[Callable] = None
    temperature: float = 0.0
    rng_seed: Optional[int] = None
    top_p: float = 0.0
    # the original request (requeued verbatim on preemption) and an
    # admission sequence number (the preemption victim is always the
    # LATEST admission, so preemption can never livelock)
    req: Optional[_Req] = None
    admit_seq: int = 0
    # chunked-prefill state machine: a slot admits as "PREFILLING" and
    # feeds its prompt to the cache chunk by chunk (fill_pos = next
    # cache position to write, starting past any spliced/shared
    # prefix); the tick its last chunk lands it emits its first token
    # and flips to "DECODE".  ``full`` holds the not-yet-fed tokens
    # (positions base..plen-1); ``hashes``/``n_pub`` track which full
    # prompt blocks the paged path has already published for sharing.
    plen: int = 0
    state: str = "DECODE"
    fill_pos: int = 0
    base: int = 0
    full: Optional[np.ndarray] = None
    hashes: Optional[list] = None
    n_pub: int = 0


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype by the reference's (numpy) name: "float32"."""
    return str(dtype).replace("torch.", "")


class _HandoffBox:
    """A lane's handoff exports on this rank, keyed by uri.  On a
    follower the engine's replayed export parks this rank's shard of the
    chain here, and each replayed adoption of it (on any lane of the
    rank) takes it, waiting at most ``WAIT_S`` for the export to be
    replayed.  A shard stays until the leader's release for its uri
    (:class:`_HandoffLease`) and every adoption the leader posted before
    that release have been replayed, so a re-sent adoption finds its
    shard and one never delivered is freed.  The shard never leaves its
    rank.  On the leader the box counts each export's adoptions for its
    release."""

    WAIT_S = 300.0

    def __init__(self):
        self._cv = threading.Condition()
        # uri -> [shard, adoptions replayed, adoptions released or None]
        self._box: Dict[str, list] = {}
        self._sent: Dict[str, int] = {}

    def __len__(self) -> int:
        with self._cv:
            return len(self._box)

    def put(self, uri: str, kv: dict) -> None:
        with self._cv:
            self._box[uri] = [kv, 0, None]
            self._cv.notify_all()

    def take(self, uri: str) -> dict:
        with self._cv:
            if not self._cv.wait_for(lambda: uri in self._box,
                                     self.WAIT_S):
                raise RuntimeError(
                    f"handoff adoption of {uri!r}: this rank's source "
                    f"engine parked no shard for it in {self.WAIT_S} s")
            entry = self._box[uri]
            entry[1] += 1
            self._drop_if_done(uri)
            return entry[0]

    def release(self, uri: str, n: int) -> None:
        """Free ``uri``'s shard once ``n`` adoptions have taken it.  The
        source lane replays the export before its release, so a release
        finds its shard unless it was freed already."""
        with self._cv:
            if uri in self._box:
                self._box[uri][2] = n
                self._drop_if_done(uri)

    def _drop_if_done(self, uri: str) -> None:
        _, taken, n = self._box[uri]
        if n is not None and taken >= n:
            del self._box[uri]

    def sent(self, uri: str) -> None:
        """Leader: one more adoption of ``uri`` was posted."""
        with self._cv:
            self._sent[uri] = self._sent.get(uri, 0) + 1

    def unsend(self, uri: str) -> int:
        """Leader: the adoptions of ``uri`` posted so far, forgotten."""
        with self._cv:
            return self._sent.pop(uri, 0)


class _HandoffLease:
    """The leader's token for one export under a mesh, held in its state
    dict (and so in every copy a deliverer keeps: a server's pending
    handoff, an adoption's request): when the last reference dies no
    adoption of the export can be delivered any more, and the uri is
    queued for the release its source lane broadcasts at its next flush
    (``_Lockstep.take``).  The followers' shards live as long as the
    leader's own copy of the chain."""

    __slots__ = ("uri", "released")

    def __init__(self, uri: str, released: collections.deque):
        self.uri, self.released = uri, released

    def __del__(self):
        # a deque append takes no lock: this may run inside any code
        self.released.append(self.uri)


class _Lockstep:
    """The control plane of a tensor-parallel engine: the leader (the
    rank at coordinate 0 on every axis) queues the mutations client
    threads ask for and, at each flush from its pump thread, broadcasts
    them with its own over a gloo group that spans every rank of the
    mesh; the other ranks receive and apply the same list in the same
    order.  ``replaying`` marks the application of a message, which runs
    each mutation's own code.  ``lane`` picks the engine's own control
    group and tp data group (``Mesh.control_group``, ``Mesh.group``):
    engines on one rank each take a lane of their own.  A follower's
    handoff exports wait in ``handoffs`` (also the mesh's
    ``lane_boxes[lane]``) for their adoptions and the leader's release
    (``released``: the uris whose :class:`_HandoffLease` died)."""

    def __init__(self, mesh, lane: int = 0):
        import torch.distributed as dist

        self._dist = dist
        self.lane = lane
        self.group = mesh.control_group(lane)
        self.src = 0
        self.leader = mesh.rank == 0
        # lane 0's tp group is the one the sharded model holds
        self.data_group = mesh.group("tp", lane) if lane else None
        # the newest engine on a lane replaces the last, and its parked
        # shards with it; a destination engine finds them on the mesh
        self.handoffs = mesh.lane_boxes[lane] = _HandoffBox()
        # leader: uris of exports whose lease died, to release
        self.released: collections.deque = collections.deque()
        self.outbox: list = []
        self.lock = threading.Lock()
        # one broadcast-and-apply at a time (the pump's step, a client's
        # register_prefix), so every rank sees one order
        self.flush_lock = threading.Lock()
        # per thread: the pump replays while client threads submit
        self._local = threading.local()

    @property
    def replaying(self) -> bool:
        return getattr(self._local, "on", False)

    @replaying.setter
    def replaying(self, on: bool) -> None:
        self._local.on = on

    def post(self, wire, local) -> None:
        with self.lock:
            self.outbox.append((wire, local))

    def take(self) -> list:
        with self.lock:
            ops, self.outbox = self.outbox, []
        # each release counts the adoptions posted before it, so it may
        # pass an adoption still queued on another lane
        while self.released:
            uri = self.released.popleft()
            op = ("release", uri, self.handoffs.unsend(uri))
            ops.append((op, op))
        return ops

    def pending_submits(self) -> int:
        with self.lock:
            return sum(1 for w, _ in self.outbox if w[0] == "submit")

    def broadcast(self, obj):
        box = [obj]
        self._dist.broadcast_object_list(box, src=self.src,
                                         group=self.group)
        return box[0]


class ContinuousEngine:
    """Continuous-batching engine over one ``TransformerLM``: the slot
    arena by default, a paged block pool with ``paged=True``.

    Same constructor names as the JAX engine.  ``mesh`` (a
    ``parallel.mesh.Mesh`` with a ``tp`` axis; every other axis
    replicates) serves the model tensor-parallel: construct the engine
    on every rank of the mesh with the same arguments; the leader (rank
    0) serves (``submit``, ``step``, ``drain``) and the others call
    :meth:`follow`.  Under the default rules the kv heads must divide tp
    (``ValueError``); ``partition_rules`` with the key/value kernels
    replicated take the replicated hatch.  ``replica_id`` is also the
    engine's lane of the mesh: its own control and tp groups (replica
    0: the mesh's own), so several engines on one mesh
    (``ClusterServing`` replicas) share one sharded copy of the model,
    each with its own collectives; every rank builds them in the same
    order.
    ``variables``, when given, is a ``state_dict`` (for example
    from ``models.lm.params_from_flax``) loaded into ``model`` before
    serving; ``None`` serves the model's own weights.  ``device``:
    ``cuda`` unless the caller names another; without a CUDA device
    the caller must pass ``device="cpu"``.  The model's ``use_flash``
    picks the arena prefill's attention.

    ``kernel`` and ``kv_dtype`` select the PAGED path only, as in the
    reference; an arena engine raises for ``kernel="fused"`` or a
    ``kv_dtype``.  ``kernel`` picks the paged-attention read:
    ``"fused"`` is the CUDA kernel on a CUDA device (the plain version on
    the CPU), ``"gather"`` the plain PyTorch version everywhere.  A
    paged engine resolves ``None`` by shape, up front: ``"fused"`` where
    the kernel takes the model's head dim and the block size
    (``ops.flash_attention.paged_kernel_takes``), ``"gather"`` otherwise;
    ``engine.kernel`` records the choice; a draft tenant resolves its
    own read by its own head dim.  An explicit ``"fused"`` for a
    shape the kernel does not take raises here, not at the first
    launch.  ``kv_dtype`` picks the pool's
    storage: ``None`` follows ``cache_dtype`` (itself defaulting to the
    model dtype), ``"bf16"`` forces bfloat16, ``"int8"`` stores
    quantized rows with bfloat16 scales.

    ``telemetry`` (a ``serving.telemetry.Telemetry``) and ``flight`` (a
    ``serving.flight.FlightRecorder``) default to ones of the engine's
    own (``flight_capacity=0``: no recorder); the server passes shared
    ones.  ``fault_injector`` (``serving.fault.FaultInjector``) fires its
    engine-side faults at tick counts of ``replica_id``.
    ``record_timings`` keeps per-request stamps for
    ``pop_request_timings``.  ``hbm_fraction`` (paged, ``n_blocks``
    unset) sizes the pool to that fraction of the device memory
    ``torch.cuda.mem_get_info`` reports; on the CPU it is ignored and
    the pool is arena-equivalent, as in the reference; with a draft
    the fraction covers both tenants.

    ``chunked=True`` streams prompts into the cache in chunks under
    ``tick_token_budget`` tokens a tick (default: all slots' decode
    positions plus one smallest-bucket chunk, at least one block; a
    budget below the smallest prompt bucket or, paged, below
    ``block_size`` raises).  ``draft_model`` with ``draft_variables``
    (both required together; a state_dict, as ``variables``) switches
    decoding to speculative rounds of ``speculation_k`` proposals
    (greedy requests only); paged, the draft's pool holds
    ``draft_n_blocks`` blocks (default ``n_blocks``).  Both compose with
    either cache and with each other.

    ``qos`` (a ``policy.QosPolicy``) orders admission and chunk grants
    by class and tenant.  ``kv_host_store_bytes`` (paged, no draft)
    sizes the host tier for evicted prefix blocks; ``prefix_directory``
    (a ``kv_store.PrefixDirectory``, paged) receives this replica's
    (``replica_id``) tier claims.  ``elastic_pool`` (paged) lets
    ``resize_pool``/``maybe_autoresize`` move the pool between a floor
    of one full-length sequence and a ceiling probed at construction:
    the pool plus 80% of the device memory ``torch.cuda.mem_get_info``
    reports free after it (memory PyTorch's allocator holds cached
    counts as used), arena-equivalent on the CPU.

    Not thread-safe by itself: ``submit``, ``submit_handoff`` and
    ``set_brownout`` may be called from any thread, but ``step``/
    ``drain``/``abort``, ``register_prefix`` and ``resize_pool``/
    ``maybe_autoresize`` (which write the caches) must run on ONE pump
    thread.  The block pools are guarded by ``_pool_lock``, the
    reference's: ``unregister_prefix`` releases from client threads and
    scrapes and the router read pool state from theirs.  Pool callbacks
    fire under it and only record; no device copy runs under it.
    """

    def __init__(self, model: TransformerLM,
                 variables: Optional[Dict[str, torch.Tensor]] = None, *,
                 max_new_tokens: int, max_slots: int = 8,
                 prompt_buckets: Sequence[int] = (16, 32, 64, 128),
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 ticks_per_step: int = 1,
                 cache_dtype: Optional[torch.dtype] = None,
                 kernel: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 mesh=None, partition_rules=None,
                 draft_model: Optional[TransformerLM] = None,
                 draft_variables: Optional[Dict[str, torch.Tensor]] = None,
                 speculation_k: int = 4,
                 paged: bool = False, block_size: int = 16,
                 n_blocks: Optional[int] = None,
                 draft_n_blocks: Optional[int] = None,
                 hbm_fraction: Optional[float] = None,
                 enable_prefix_cache: bool = True,
                 elastic_pool: bool = False,
                 kv_host_store_bytes: int = 0,
                 prefix_directory=None,
                 replica_id: int = 0,
                 fault_injector=None,
                 chunked: bool = False,
                 tick_token_budget: Optional[int] = None,
                 record_timings: bool = False,
                 telemetry: Optional[Telemetry] = None,
                 qos=None,
                 flight: Optional[FlightRecorder] = None,
                 flight_capacity: int = 2048,
                 device=None):
        self._lockstep: Optional[_Lockstep] = None
        self._tick_now = 0.0
        self.mesh = mesh
        tp = 1 if mesh is None else mesh.size("tp")
        if partition_rules is not None and tp == 1:
            raise ValueError("partition_rules need a mesh with a tp axis")
        if kernel not in (None, "gather", "fused"):
            raise ValueError(f"kernel must be 'gather' or 'fused', got "
                             f"{kernel!r}")
        if kv_dtype not in (None, "bf16", "int8"):
            raise ValueError(f"kv_dtype must be None, 'bf16' or "
                             f"'int8', got {kv_dtype!r}")
        if not paged and (kernel == "fused" or kv_dtype is not None):
            raise ValueError(
                f"kernel={kernel!r} / kv_dtype={kv_dtype!r} require "
                f"paged=True: both select the paged-attention path "
                f"(the arena engine has no block pool to apply them to)")
        if elastic_pool and not paged:
            raise ValueError(
                "elastic_pool=True requires paged=True: the arena "
                "engine has no block pool to grow or shrink")
        if kv_host_store_bytes < 0:
            raise ValueError(f"kv_host_store_bytes must be >= 0, got "
                             f"{kv_host_store_bytes}")
        if (kv_host_store_bytes > 0 or prefix_directory is not None) \
                and not paged:
            raise ValueError(
                "kv_host_store_bytes / prefix_directory require "
                "paged=True: the tiered KV store spills and re-admits "
                "BLOCK CHAINS (the arena engine has no blocks to spill)")
        if kv_host_store_bytes > 0 and draft_model is not None:
            raise ValueError(
                "kv_host_store_bytes does not compose with a draft "
                "model: speculative mode runs two pool tenants in "
                "lockstep and re-admitting only the target tenant's "
                "chain would desynchronize them; serve the host tier "
                "on non-speculative replicas")
        # speculative mode: greedy only (submit() rejects temperature >
        # 0); each verify round advances every row by its own count
        self._spec_k = int(speculation_k) if draft_model is not None else 0
        if draft_model is not None:
            if draft_variables is None:
                raise ValueError("draft_model needs draft_variables")
            if draft_model.vocab_size != model.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_model.vocab_size} != target "
                    f"vocab {model.vocab_size}")
            if self._spec_k < 1:
                raise ValueError("speculation_k must be >= 1")
        self.device = resolve_device(device if mesh is None or
                                     device is not None else mesh.device)
        self._tp = tp
        self._kv_tp = self._dkv_tp = False
        if tp > 1:
            if model.kv_heads % tp and partition_rules is None:
                raise ValueError(
                    f"kv_heads={model.kv_heads} must divide by tp={tp} to "
                    f"shard the KV cache under the default "
                    f"LM_PARTITION_RULES; narrow-KV (MQA/GQA) models pass "
                    f"partition_rules with the key/value kernels "
                    f"replicated (P()): the KV storage then replicates too")
            # sharded from birth: the model keeps only its shards, then
            # the whole or sharded variables load into them
            self._kv_tp = shard_lm(model, mesh, partition_rules)["kv"]
            if draft_model is not None and draft_model is not model:
                self._dkv_tp = shard_lm(draft_model, mesh,
                                        partition_rules)["kv"]
            elif draft_model is model:
                self._dkv_tp = self._kv_tp
            self._lockstep = _Lockstep(mesh, int(replica_id))
            if not self._lockstep.leader:
                # the leader alone speaks for the replica fleet-wide
                prefix_directory = None
        if variables is not None:
            if tp > 1:
                load_sharded(model, variables)
            else:
                model.load_state_dict(variables)
        self.model = model.to(self.device).eval()
        self.draft_model = None
        if draft_model is not None:
            if tp == 1:
                load_draft(model, draft_model, draft_variables)
            elif draft_model is not model:
                load_sharded(draft_model, draft_variables)
            self.draft_model = draft_model.to(self.device).eval()
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.paged = bool(paged)
        # ---- telemetry, flight recorder, fault hook --------------------
        # host ints and floats only: nothing here reads the device
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry()
        self.flight = flight if flight is not None else (
            FlightRecorder(flight_capacity) if flight_capacity > 0
            else None)
        self.record_timings = bool(record_timings)
        self._replica_id = int(replica_id)
        self._fault = fault_injector
        self._tick_kind = "decode"
        self._alloc_fail_streak = 0
        # cumulative-counter baselines for the flight record's deltas
        self._flight_last = {"preempt": 0, "chunks": 0, "budget_tokens": 0,
                             "alloc_fail": 0, "draft_alloc_fail": 0,
                             "spec_proposed": 0, "spec_accepted": 0,
                             "pool_resizes": 0, "handoffs_out": 0,
                             "handoffs_in": 0, "kv_spills": 0,
                             "kv_readmits": 0, "deadline_sheds": 0}
        # brownout and deadline admission: 0/off until the broker calls
        # set_brownout or a deadline arrives, and every gate checks the
        # level first, so untouched engines decide as before
        self._brownout_level = 0
        self._brownout_enabled = False
        self._brownout_clamp = 0
        self._deadline_seen = False
        self._deadline_sheds = 0
        self._pool: Optional[BlockPool] = None
        self._dpool: Optional[BlockPool] = None
        # pool-mutation guard (the reference's): pool callbacks fire
        # under it and only record; the device work they defer (spill
        # gathers, readmit scatters) runs after it is released
        self._pool_lock = threading.Lock()
        # tiered KV: host store, fleet directory, their counters and the
        # deferred device work ((block, hash) spills; (blocks, k, v)
        # readmits), drained by the pump before its next pool write
        self._kv_store: Optional[HostKVStore] = None
        self._prefix_directory = prefix_directory
        self._kv_spills = 0
        self._kv_spill_bytes = 0
        self._kv_readmits = 0
        self._kv_readmit_tokens_saved = 0
        self._pending_spills: List[Tuple[int, int]] = []
        self._pending_readmits: List[tuple] = []
        # handoff traffic: rows exported at first token / adopted
        self._handoffs_out = 0
        self._handoffs_in = 0
        # the host tier counts whole blocks (every rank's shard), as the
        # reference's store does, so each rank evicts where it does
        self._kv_shards = tp if self._kv_tp else 1
        D = model.hidden_size // model.num_heads
        self.kernel = self._resolve_kernel(kernel, D, int(block_size))
        # the draft tenant's read, resolved by its own shape
        self._dkernel = None if draft_model is None else \
            self._resolve_kernel(
                kernel, draft_model.hidden_size // draft_model.num_heads,
                int(block_size))
        # speculative verify writes k+1 entries past the pointer, so the
        # bucket limit tightens by k+1 and must fit BOTH position tables
        eff_max_pos = model.max_position if draft_model is None else \
            min(model.max_position, draft_model.max_position)
        extra = self._spec_k + 1 if draft_model is not None else 0
        self.prompt_buckets = filter_prompt_buckets(
            prompt_buckets, eff_max_pos, max_new_tokens + extra)
        self.max_prompt_width = self.prompt_buckets[-1]
        S = int(max_slots)
        L = self.max_prompt_width + self.max_new_tokens + extra
        self._S, self._L = S, L
        # this rank's kv heads: a shard under tp with the k/v split
        H = model.cache_kv_heads
        cdtype = model.dtype if cache_dtype is None else cache_dtype
        if not (isinstance(cdtype, torch.dtype) and cdtype.is_floating_point):
            raise ValueError(
                f"cache_dtype {cache_dtype!r} is not a floating torch "
                f"dtype the KV cache can be allocated with")
        if kv_dtype == "bf16":
            cdtype = torch.bfloat16
        self._kv_int8 = kv_dtype == "int8"
        self.kv_dtype = "int8" if self._kv_int8 else _KV_LABELS[cdtype]
        self._preemptions = 0
        self._peak_resident = 0
        self._admit_seq = 0
        # device-call counters: chip runs check that every attention
        # call of these went through the selected kernel.  prefill_calls
        # counts the target's admission prefills (arena: one ``prefill``
        # forward per prompt bucket; paged: one ``prefill_chunk_paged``
        # per suffix bucket, and one per ``register_prefix`` that has
        # blocks to fill); prefill_shapes counts them by (rows, width)
        # in the arena and by (rows, suffix bucket, each row's start
        # position) in paged mode.  decode_ticks counts the target's
        # decode steps (fused chunked ticks included), chunk_calls the
        # ticks' chunk calls, spec_rounds the verify rounds; the draft's
        # calls are draft_prefill_calls (its admission prefills and
        # prefix pins, counted like the target's) plus k+1 decode steps
        # a round plus draft_chunk_calls, the chunk calls that landed in
        # the draft too (all of them unless brownout dropped
        # speculation).
        self.decode_ticks = 0
        self.prefill_calls = 0
        self.prefill_shapes: collections.Counter = collections.Counter()
        self.chunk_calls = 0
        self.draft_chunk_calls = 0
        self.draft_prefill_calls = 0
        self._spec_rounds = 0
        self._spec_emitted = 0
        # register_prefix ids -> arena (ks, vs, P, dks, dvs) / paged
        # (tokens, pinned blocks, pinned draft blocks)
        self._prefixes: Dict[int, tuple] = {}
        self._next_prefix_id = 0
        dev = self.device
        if not self.paged:
            self._ck = torch.zeros((model.num_layers, S, L, H, D),
                                   dtype=cdtype, device=dev)
            self._cv = torch.zeros_like(self._ck)
            self._kv_bytes_per_token = \
                2 * model.num_layers * H * D * cdtype.itemsize
            if draft_model is not None:
                dm = draft_model
                dD = dm.hidden_size // dm.num_heads
                self._dck = torch.zeros(
                    (dm.num_layers, S, L, dm.cache_kv_heads, dD),
                    dtype=cdtype, device=dev)
                self._dcv = torch.zeros_like(self._dck)
                self._kv_bytes_per_token += \
                    2 * dm.num_layers * dm.cache_kv_heads * dD \
                    * cdtype.itemsize
        else:
            self._init_pool(model, S, L, H, D, cdtype, int(block_size),
                            n_blocks, draft_n_blocks, hbm_fraction,
                            enable_prefix_cache, int(kv_host_store_bytes))
            self._kv_bytes_per_token = (
                self._per_block_bytes + self._draft_per_block_bytes) \
                // self._bs
        self._init_elastic(bool(elastic_pool))
        self._init_chunked(chunked, tick_token_budget)
        self.ticks_per_step = max(1, int(ticks_per_step))
        # host-side per-slot state (device copies travel per step)
        self._tok = np.zeros(S, np.int32)
        self._pos = np.zeros(S, np.int32)
        self._dpos = np.zeros(S, np.int32)
        self._done = np.zeros(S, bool)
        self._slots: List[Optional[_Slot]] = [None] * S
        self._free = collections.deque(range(S))
        self._lock = threading.Lock()
        # QoS off: the plain FIFO deque (decisions bit-identical to an
        # engine without the front door); on: the weighted scheduler,
        # with the same deque surface at every call site
        self._qos = qos
        self._waiting = (WeightedWaitQueue(qos, clock=self._now)
                         if qos is not None else collections.deque())
        self._register_engine_gauges()

    # ---- tensor-parallel lockstep --------------------------------------

    def _now(self) -> float:
        """The clock every admission decision reads: ``time.monotonic``,
        or under a mesh the leader's reading for the tick, so every rank
        decides alike."""
        if self._lockstep is None:
            return time.monotonic()
        return self._tick_now

    def _agree(self, value):
        """``value`` as the leader has it (a memory probe, under a mesh);
        ``value`` itself on one rank.  Every rank calls it together."""
        if self._lockstep is None:
            return value
        return self._lockstep.broadcast(value)

    def _leads(self) -> bool:
        """Whether a mutation called here must go through the control
        plane first: a tp leader outside a message's replay.  A follower
        that is called directly raises: its leader drives it."""
        ls = self._lockstep
        if ls is None or ls.replaying:
            return False
        if not ls.leader:
            raise RuntimeError(
                "this rank follows a tensor-parallel leader: call "
                "follow(); submit/step/abort go to the tp-rank-0 engine")
        return True

    def _flush(self, op=None):
        """Leader: broadcast the queued mutations (and ``op``), then apply
        them here in the same order; returns ``op``'s result."""
        ls = self._lockstep
        with ls.flush_lock:
            ops = ls.take()
            if op is not None:
                ops.append((op, op))
            ls.broadcast([w for w, _ in ops])
            out = None
            for _, local in ops:
                out = self._apply(local)
        return out

    def _apply(self, op):
        """Run one control-plane mutation (leader and followers alike),
        its collectives over this engine's tp group."""
        ls = self._lockstep
        kind = op[0]
        ls.replaying = True
        lanes = contextlib.ExitStack()
        for m in (self.model, self.draft_model):
            if m is not None and m.tp is not None:
                lanes.enter_context(m.tp.using(ls.data_group))
        try:
            if kind == "submit":
                req = op[1]
                if ls.leader is False:
                    self.telemetry.req_enqueued(req.uri)
                if req.deadline_t > 0.0:
                    self._deadline_seen = True
                with self._lock:
                    self._waiting.append(req)
                return None
            if kind == "step":
                self._tick_now = op[1]
                return self.step()
            if kind == "brownout":
                return self.set_brownout(op[1], op[2])
            if kind == "abort":
                return self.abort(op[1])
            if kind == "prefix":
                return self.register_prefix(op[1])
            if kind == "unprefix":
                return self.unregister_prefix(op[1])
            if kind == "resize":
                return self.resize_pool(op[1])
            if kind == "precompile":
                return self.precompile_chunked(*op[1:])
            if kind == "handoff":
                state = op[1]
                if "k" not in state:
                    box = self.mesh.lane_boxes[state["lane"]]
                    state = dict(state, **box.take(state["uri"]))
                return self._enqueue_handoff(state)
            if kind == "release":
                return ls.handoffs.release(op[1], op[2])
            raise ValueError(f"unknown control-plane op {kind!r}")
        finally:
            ls.replaying = False
            lanes.close()

    def follow(self) -> None:
        """A follower rank's loop: apply the leader's messages in order
        until :meth:`stop_followers` (pump thread of this rank).  Returns
        at once on an engine without a mesh or on the leader."""
        ls = self._lockstep
        if ls is None or ls.leader:
            return
        with torch.no_grad():
            while True:
                ops = ls.broadcast(None)
                if any(op[0] == "stop" for op in ops):
                    return
                for op in ops:
                    self._apply(op)

    def stop_followers(self) -> None:
        """Leader: end every follower's :meth:`follow` (after the queued
        mutations).  A no-op without a mesh or on a follower."""
        ls = self._lockstep
        if ls is None or not ls.leader:
            return
        with ls.flush_lock:
            ls.take()
            ls.broadcast([("stop",)])

    def _init_elastic(self, elastic_pool: bool) -> None:
        """The elastic pool's bounds, probed once after the weights and
        the pool are allocated: floor one full-length sequence (M+1
        blocks), step an eighth of the pool (at least a block's token
        count), ceiling the pool plus 80% of the free device memory
        split over both tenants' per-block bytes (the reference's
        formula; ``torch.cuda.mem_get_info``'s free figure counts
        memory PyTorch's allocator has reserved but not handed out as
        used), arena-equivalent (S*M+1) where the device reports no
        memory.  Two elastic engines on one card probe the same free
        memory, so their ceilings overlap, as in the reference."""
        self.elastic_pool = elastic_pool
        self._pool_resizes = 0
        self._pool_resize_clamps = 0
        self._autoresize_last_fails = 0
        self._pool_floor = (self._M + 1) if self.paged else 0
        self._pool_ceiling = 0
        self._resize_step = 0
        self.elastic_probe_free_bytes = 0
        if not elastic_pool:
            return
        n = self._pool.n_blocks
        self._resize_step = max(self._bs, n // 8)
        free = 0
        if self.device.type == "cuda":
            free = int(torch.cuda.mem_get_info(self.device)[0])
        # the leader's probe decides for every rank of a tp engine
        free = self._agree(free)
        self.elastic_probe_free_bytes = free
        per = self._per_block_bytes + self._draft_per_block_bytes
        if free > 0 and per > 0:
            # leave 20% of the probed headroom for activations: the
            # elastic pool must never be the reason a forward runs out
            ceiling = max(n, n + int(free * 0.8) // per)
        else:
            ceiling = max(n, self._S * self._M + 1)
        self._pool_ceiling = int(ceiling)

    def _init_chunked(self, chunked: bool,
                      tick_token_budget: Optional[int]) -> None:
        """The token-budget tick scheduler's state: the budget (by
        default all S decode rows, at k+1 positions each under
        speculation, plus one smallest-bucket chunk and at least one
        paged block), the chunk widths (the prompt buckets the budget
        can schedule) and the arena's read windows (powers of two up to
        the cache length)."""
        self.chunked = bool(chunked)
        self._prefill_stall_ticks = 0
        self._prefill_preemptions = 0
        self._budget_tokens_used = 0
        self._budget_ticks = 0
        self.tick_token_budget: Optional[int] = None
        if not self.chunked:
            return
        S, L = self._S, self._L
        if tick_token_budget is None:
            per_row = self._spec_k + 1
            budget = max(self.prompt_buckets[0] + per_row * S,
                         2 * per_row * S)
            if self.paged:
                budget = max(budget, self._bs)
        else:
            budget = int(tick_token_budget)
            if budget < self.prompt_buckets[0]:
                raise ValueError(
                    f"tick_token_budget={budget} is below the smallest "
                    f"chunk bucket {self.prompt_buckets[0]}: no prefill "
                    f"chunk could ever be scheduled and admission would "
                    f"livelock; raise the budget or add a smaller prompt "
                    f"bucket")
            if self.paged and budget < self._bs:
                raise ValueError(
                    f"tick_token_budget={budget} is below "
                    f"block_size={self._bs}: a chunk could never cover "
                    f"one paged block per tick; raise the budget or "
                    f"shrink block_size")
        self.tick_token_budget = budget
        self._chunk_buckets = tuple(
            b for b in self.prompt_buckets if b <= budget)
        rb: List[int] = []
        v = 8
        while v < L:
            rb.append(v)
            v *= 2
        rb.append(L)
        self._read_buckets = tuple(rb)

    def _resolve_kernel(self, kernel: Optional[str], head_dim: int,
                        block_size: int) -> str:
        """One pool tenant's paged-attention read, decided by its shape
        before any launch (the arena reads through plain attention).
        The target and a draft resolve apart: a draft head dim the
        kernel does not take leaves the target on the kernel."""
        if not self.paged:
            return "gather"
        takes = paged_kernel_takes(head_dim, block_size)
        if kernel == "fused" and not takes:
            raise ValueError(
                f"kernel='fused': the paged-attention kernel does not take "
                f"head dim {head_dim} with block_size "
                f"{block_size} (head dims {KERNEL_HEAD_DIMS}, blocks of "
                f"1-{PAGED_MAX_BLOCK} tokens); pass kernel='gather' or "
                f"None")
        return kernel or ("fused" if takes else "gather")

    def _init_pool(self, model, S, L, H, D, cdtype, bs, n_blocks,
                   draft_n_blocks, hbm_fraction, enable_prefix_cache,
                   kv_host_store_bytes) -> None:
        """The paged mode's block pools, device pools and tables: the
        target's, and with a draft model the draft's second tenant (its
        own block ids, tables and allocator; stored in the cache dtype
        even when the target pool is int8).  The host tier and the
        directory hook into the target pool's evictions and index."""
        if bs < 1:
            raise ValueError(f"block_size must be >= 1, got {bs}")
        M = -(-L // bs)         # logical blocks per row, ceil(L/bs)
        if self._kv_int8:
            per_block = block_bytes(model.num_layers, bs, H, D, "int8")
        else:
            per_block = 2 * model.num_layers * bs * H * D \
                * cdtype.itemsize
        dm = self.draft_model
        draft_per_block = 0
        if dm is not None:
            dD = dm.hidden_size // dm.num_heads
            draft_per_block = 2 * dm.num_layers * bs * dm.cache_kv_heads \
                * dD * cdtype.itemsize
        if n_blocks is None:
            lim = 0
            if hbm_fraction is not None and self.device.type == "cuda":
                lim = int(torch.cuda.mem_get_info(self.device)[1])
            lim = self._agree(lim)
            if lim:
                # with a draft the byte budget covers BOTH tenants: the
                # common block count splits it by per-block cost
                n_blocks = max(M + 1, split_block_budget(
                    int(lim * float(hbm_fraction)),
                    (per_block, draft_per_block) if dm is not None
                    else (per_block,)))
            else:
                if hbm_fraction is not None:
                    logger.warning(
                        "hbm_fraction=%s ignored: the %s device reports "
                        "no memory size; sizing the pool arena-equivalent "
                        "(S*M+1 blocks)", hbm_fraction, self.device.type)
                # arena-equivalent capacity: every slot can run to full
                # length — paged still wins whenever real traffic
                # doesn't
                n_blocks = S * M + 1
        n_blocks = int(n_blocks)
        if n_blocks < M + 1:
            raise ValueError(
                f"n_blocks={n_blocks} cannot hold one full-length "
                f"sequence: need >= {M + 1} ({M} logical blocks of "
                f"{bs} positions + the sink block 0)")
        self._bs, self._M = bs, M
        self._per_block_bytes = per_block
        self._draft_per_block_bytes = draft_per_block
        if kv_host_store_bytes > 0:
            self._kv_store = HostKVStore(kv_host_store_bytes,
                                         evict_cb=self._store_evicted)
        self._pool = BlockPool(
            n_blocks, bs, enable_prefix_cache,
            event_cb=self.telemetry.pool_event, name="target",
            kv_dtype=self.kv_dtype, bytes_per_block=per_block,
            spill_cb=(self._spill_block if self._kv_store is not None
                      else None),
            index_cb=(self._pool_index_event
                      if self._prefix_directory is not None else None))
        # HEAD-MAJOR pool layout [layers, N, KH, bs, D], the kernel's
        # (and the reference's) page layout; int8 pools are QuantKV
        # pairs (int8 data + per-(block, position, head) bf16 scales)
        shape = (model.num_layers, n_blocks, H, bs, D)
        dev = self.device
        if self._kv_int8:
            self._pk = QuantKV(
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.ones(shape[:-1], dtype=KV_SCALE_DTYPE, device=dev))
            self._pv = QuantKV(
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.ones(shape[:-1], dtype=KV_SCALE_DTYPE, device=dev))
        else:
            self._pk = torch.zeros(shape, dtype=cdtype, device=dev)
            self._pv = torch.zeros(shape, dtype=cdtype, device=dev)
        # per-slot block tables; SINK everywhere a row holds no block,
        # so stray writes land in storage nothing attends
        self._tables = np.full((S, M), SINK_BLOCK, np.int32)
        self._row_blocks: List[List[int]] = [[] for _ in range(S)]
        if dm is None:
            return
        dnb = n_blocks if draft_n_blocks is None else int(draft_n_blocks)
        if dnb < M + 1:
            raise ValueError(
                f"draft_n_blocks={dnb} cannot hold one full-length "
                f"sequence: need >= {M + 1} ({M} logical blocks of {bs} "
                f"positions + the sink block 0)")
        self._dpool = BlockPool(dnb, bs, enable_prefix_cache,
                                event_cb=self.telemetry.pool_event,
                                name="draft", kv_dtype=_KV_LABELS[cdtype],
                                bytes_per_block=draft_per_block)
        dshape = (dm.num_layers, dnb, dm.cache_kv_heads, bs,
                  dm.hidden_size // dm.num_heads)
        self._dpk = torch.zeros(dshape, dtype=cdtype, device=dev)
        self._dpv = torch.zeros(dshape, dtype=cdtype, device=dev)
        self._dtables = np.full((S, M), SINK_BLOCK, np.int32)
        self._drow_blocks: List[List[int]] = [[] for _ in range(S)]

    @property
    def n_active(self) -> int:
        return self._S - len(self._free)

    @property
    def n_waiting(self) -> int:
        pending = 0 if self._lockstep is None \
            else self._lockstep.pending_submits()
        with self._lock:
            return len(self._waiting) + pending

    def _register_engine_gauges(self) -> None:
        """Scrape-time gauges over engine and pool state, the
        reference's families: each callback reads the live value when
        ``/metrics`` is scraped; pool fields are read under the pool
        lock.  Every paged engine registers the elastic, handoff and
        host-tier families, zero while those modes are off."""
        m = self.telemetry.metrics
        m.gauge("zoo_engine_queue_depth",
                "requests waiting for a slot", fn=lambda: self.n_waiting)
        m.counter("zoo_engine_deadline_admission_sheds_total",
                  "requests shed at admission because their deadline "
                  "had already passed (never reached prefill)")
        m.gauge("zoo_engine_active_slots",
                "resident requests (decode + prefilling)",
                fn=lambda: self.n_active)
        m.gauge("zoo_engine_peak_resident",
                "max co-resident requests observed",
                fn=lambda: self._peak_resident)
        m.gauge("zoo_engine_kv_bytes_per_token",
                "HBM bytes one cached token position costs across all "
                "layers and tenants",
                fn=lambda: self._kv_bytes_per_token)
        if self.chunked:
            def _budget_util():
                denom = self._budget_ticks * self.tick_token_budget
                return (self._budget_tokens_used / denom) if denom \
                    else 0.0

            m.gauge("zoo_engine_budget_utilization",
                    "mean filled fraction of the tick token budget",
                    fn=_budget_util)
            m.gauge("zoo_engine_prefill_stall_ticks_total",
                    "ticks whose budget left no room for any chunk",
                    fn=lambda: self._prefill_stall_ticks,
                    kind="counter")
        if not self.paged:
            return
        m.gauge("zoo_engine_kv_pool_bytes",
                "total HBM bytes of the paged KV pools (target + "
                "draft, all blocks)",
                fn=lambda: (
                    self._per_block_bytes * self._pool.n_blocks
                    + (self._draft_per_block_bytes * self._dpool.n_blocks
                       if self._dpool is not None else 0)))

        def _pool_read(key):
            def read():
                with self._pool_lock:
                    return self._pool.metrics()[key]
            return read

        for key, name, kind, hlp in (
                ("free_blocks", "zoo_engine_free_blocks", "gauge",
                 "pool blocks on the free list"),
                ("cached_blocks", "zoo_engine_cached_blocks", "gauge",
                 "unreferenced blocks parked in the prefix LRU"),
                ("referenced_blocks", "zoo_engine_referenced_blocks",
                 "gauge", "blocks held by live requests"),
                ("occupancy", "zoo_engine_pool_occupancy", "gauge",
                 "referenced fraction of non-sink blocks"),
                ("prefix_hit_rate", "zoo_engine_prefix_hit_rate",
                 "gauge", "prefix-cache block hits / queries"),
                ("prefix_queries", "zoo_engine_prefix_queries_total",
                 "counter", "prompt blocks offered to lookup()"),
                ("prefix_hits", "zoo_engine_prefix_hits_total",
                 "counter", "prompt blocks answered from the index"),
                ("evictions", "zoo_engine_pool_evictions_total",
                 "counter", "LRU evictions of cached blocks"),
                ("alloc_failures",
                 "zoo_engine_pool_alloc_failures_total", "counter",
                 "allocate() calls the pool could not serve")):
            m.gauge(name, hlp, fn=_pool_read(key), kind=kind)
        m.gauge("zoo_engine_pool_n_blocks",
                "current per-tenant pool size in blocks (moves "
                "only under elastic_pool)",
                fn=lambda: self._pool.n_blocks)
        for name, hlp, fn in (
                ("zoo_engine_pool_resize_total",
                 "applied elastic pool resizes (grow + shrink)",
                 lambda: self._pool_resizes),
                ("zoo_engine_pool_resize_clamped_total",
                 "resize requests clamped at the eviction boundary "
                 "or the floor/ceiling",
                 lambda: self._pool_resize_clamps),
                ("zoo_engine_handoffs_out_total",
                 "prefilled rows exported to a decode replica",
                 lambda: self._handoffs_out),
                ("zoo_engine_handoffs_in_total",
                 "prefilled rows adopted from a prefill replica",
                 lambda: self._handoffs_in),
                ("zoo_engine_kv_spill_chains_total",
                 "evicted blocks accepted by the host KV store",
                 lambda: self._kv_spills),
                ("zoo_engine_kv_spill_bytes_total",
                 "KV bytes spilled to the host store",
                 lambda: self._kv_spill_bytes),
                ("zoo_engine_kv_readmit_chains_total",
                 "host-store chains adopted back into the pool at "
                 "admission", lambda: self._kv_readmits),
                ("zoo_engine_kv_readmit_tokens_saved_total",
                 "prompt tokens served host->HBM instead of "
                 "re-prefilled", lambda: self._kv_readmit_tokens_saved)):
            m.gauge(name, hlp, fn=fn, kind="counter")
        m.gauge("zoo_engine_kv_store_bytes",
                "host KV store occupancy in bytes",
                fn=lambda: (self._kv_store.occupancy_bytes
                            if self._kv_store is not None else 0))
        if self._dpool is None:
            return

        def _dpool_read(key):
            def read():
                with self._pool_lock:
                    return self._dpool.metrics()[key]
            return read

        for key, name, kind, hlp in (
                ("free_blocks", "zoo_engine_draft_free_blocks",
                 "gauge", "draft-pool blocks on the free list"),
                ("referenced_blocks",
                 "zoo_engine_draft_referenced_blocks", "gauge",
                 "draft-pool blocks held by live requests"),
                ("occupancy", "zoo_engine_draft_pool_occupancy",
                 "gauge", "referenced fraction of the draft pool"),
                ("alloc_failures",
                 "zoo_engine_draft_pool_alloc_failures_total",
                 "counter", "draft-pool allocate() calls it could not "
                 "serve")):
            m.gauge(name, hlp, fn=_dpool_read(key), kind=kind)

    def capacity_report(self) -> dict:
        """KV memory economics, the reference's report: bytes per slot
        (arena) or per block (paged), the whole cache's bytes, and
        (arena) the multiplier against a full-head cache in the model
        dtype; the draft's cache and the arena's stored prefixes beside
        them.  Under a mesh ``arena_bytes`` counts every rank's shard and
        ``arena_bytes_per_chip`` this rank's (equal when the cache
        replicates)."""
        m = self.model
        # this rank holds 1/tp of a kv-split cache: the totals count
        # every rank's shard, the per-chip figures this rank's
        shards = self._tp if self._kv_tp else 1
        if self.paged:
            per_block = self._per_block_bytes * shards
            return {
                "mode": "paged",
                "slots": self._S,
                "cache_len": self._L,
                "kv_heads": m.kv_heads,
                "cache_dtype": _dtype_name(self._pk.data.dtype
                                           if self._kv_int8
                                           else self._pk.dtype),
                "kv_dtype": self.kv_dtype,
                "kernel": self.kernel,
                "kv_bytes_per_token": self._kv_bytes_per_token,
                "block_size": self._bs,
                "n_blocks": self._pool.n_blocks,
                "blocks_per_row_max": self._M,
                "bytes_per_block": per_block,
                "bytes_per_slot": per_block * self._M,
                "arena_bytes": per_block * self._pool.n_blocks,
                "arena_equivalent_bytes":
                    (per_block // self._bs) * self._L * self._S,
                "tp": self._tp,
                "arena_bytes_per_chip":
                    self._per_block_bytes * self._pool.n_blocks,
                "draft_arena_bytes": (
                    self._draft_per_block_bytes * self._dpool.n_blocks
                    if self._dpool is not None else 0),
                "draft_n_blocks": (self._dpool.n_blocks
                                   if self._dpool is not None else 0),
                "prefix_bytes": 0,
            }
        H, D = self._ck.shape[3] * shards, self._ck.shape[4]
        per_slot = 2 * m.num_layers * self._L * H * D * \
            self._ck.dtype.itemsize
        full = 2 * m.num_layers * self._L * m.num_heads * D * \
            m.dtype.itemsize
        with self._lock:
            prefixes = list(self._prefixes.values())
        return {
            "slots": self._S,
            "cache_len": self._L,
            "kv_heads": H,
            "cache_dtype": _dtype_name(self._ck.dtype),
            "bytes_per_slot": per_slot,
            "arena_bytes": per_slot * self._S,
            "tp": self._tp,
            "arena_bytes_per_chip": per_slot * self._S // shards,
            "capacity_multiplier_vs_mha_model_dtype":
                round(full / per_slot, 2),
            "draft_arena_bytes": (
                2 * self._dck.numel() * self._dck.element_size()
                if self.draft_model is not None else 0),
            "prefix_bytes": sum(e.numel() * e.element_size()
                                for entry in prefixes
                                for e in (entry[0], entry[1], entry[3],
                                          entry[4])
                                if e is not None),
        }

    @torch.no_grad()
    def register_prefix(self, tokens: np.ndarray) -> int:
        """Prefill a shared prompt PREFIX (system prompt) once; returns
        an id for ``submit(..., prefix=id)``, whose prompt is then only
        the suffix.  Arena: the prefix's K/V (and the draft's) are kept,
        and admission splices them into each request's row and prefills
        the suffix against them.  Paged: the prefix's full blocks are
        prefilled and pinned in the pool (in both tenants with a draft),
        and requests concatenate the tokens on the host and match the
        pinned blocks at admission."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1 or len(tokens) < 1:
            raise ValueError("prefix must be a non-empty 1-D int32 array")
        P = len(tokens)
        if P < self.max_prompt_width and self._leads():
            return self._flush(("prefix", tokens))
        if P >= self.max_prompt_width:
            raise ValueError(
                f"prefix length {P} leaves no room for a suffix inside "
                f"max prompt width {self.max_prompt_width}")
        if self.paged:
            blocks = self._pin_prefix_blocks(tokens, self._pool, self.model,
                                             self._pk, self._pv)
            dblocks: List[int] = []
            if self._dpool is not None:
                try:
                    dblocks = self._pin_prefix_blocks(
                        tokens, self._dpool, self.draft_model, self._dpk,
                        self._dpv)
                except Exception:
                    # a half-pinned prefix would leak target blocks
                    with self._pool_lock:
                        for b in blocks:
                            self._pool.release(b)
                    raise
            entry = (tokens, blocks, dblocks)
        else:
            toks = torch.as_tensor(tokens[None], device=self.device)
            _, ks, vs = self.model._prefill_hidden(toks)
            dks = dvs = None
            if self.draft_model is not None:
                _, dks, dvs = self.draft_model._prefill_hidden(toks)
            entry = (ks, vs, P, dks, dvs)
        with self._lock:
            pid = self._next_prefix_id
            self._next_prefix_id += 1
            self._prefixes[pid] = entry
        return pid

    def _pin_prefix_blocks(self, tokens: np.ndarray, pool: BlockPool,
                           model: TransformerLM, pk, pv) -> List[int]:
        """Paged ``register_prefix`` for one pool tenant: match the
        prefix's FULL blocks in the index, allocate the rest, prefill
        the unmatched span through the tenant's paged path and publish
        it; the blocks stay referenced until ``unregister_prefix``.  The
        partial tail block recomputes per request inside its suffix (a
        partial block keeps growing, so it is never shared)."""
        bs = self._bs
        nfull = len(tokens) // bs
        hashes = pool.block_hashes(tokens[:nfull * bs])
        with self._pool_lock:
            matched = pool.lookup(hashes)
            for b in matched:
                pool.acquire(b)
            blocks = list(matched)
            for _ in range(nfull - len(matched)):
                b = pool.allocate()
                if b is None:
                    for bb in blocks:
                        pool.release(bb)
                    raise RuntimeError(
                        f"{pool.name} block pool has no room to pin a "
                        f"{nfull}-block prefix ({pool.num_referenced()} "
                        f"of {pool.n_blocks} blocks referenced)")
                blocks.append(b)
        # allocation may have evicted indexed blocks: gather their old
        # bytes before the prefill below rewrites the ids
        self._drain_spills()
        if len(matched) < nfull:
            span = tokens[len(matched) * bs:nfull * bs]
            sb = _next_bucket(len(span), self.prompt_buckets)
            padded = np.full((1, sb), self.pad_id, np.int32)
            padded[0, :len(span)] = span
            tabs = np.full((1, self._M), SINK_BLOCK, np.int32)
            tabs[0, :len(blocks)] = blocks
            dev = self.device
            model.prefill_chunk_paged(
                torch.as_tensor(padded, device=dev), pk, pv,
                torch.as_tensor(tabs, device=dev),
                torch.tensor([len(matched) * bs], dtype=torch.int32,
                             device=dev),
                torch.tensor([len(span)], dtype=torch.int32, device=dev),
                kernel=self.kernel if pool is self._pool else self._dkernel)
            if pool is self._pool:
                self.prefill_calls += 1
                self.prefill_shapes[(1, sb, (len(matched) * bs,))] += 1
            else:
                self.draft_prefill_calls += 1
            with self._pool_lock:
                for j in range(len(matched), nfull):
                    pool.insert(hashes[j], blocks[j])
        return blocks

    def unregister_prefix(self, pid: int) -> None:
        """Release a prefix: the arena drops its stored K/V; the paged
        engine drops its pin on the prefix's blocks (both tenants'),
        which park in the pool's LRU (still shareable) until allocation
        evicts them.  Admitted requests keep what they already have;
        queued requests naming the id fail admission."""
        if self._lockstep is not None and not self._lockstep.replaying:
            with self._lock:
                if pid not in self._prefixes:
                    raise ValueError(f"unknown prefix id {pid}")
            if self._leads():
                # any thread: applied at the leader's next flush
                self._lockstep.post(("unprefix", pid), ("unprefix", pid))
            return
        with self._lock:
            if pid not in self._prefixes:
                raise ValueError(f"unknown prefix id {pid}")
            entry = self._prefixes.pop(pid)
        if self.paged:
            with self._pool_lock:
                for b in entry[1]:
                    self._pool.release(b)
                for b in entry[2]:
                    self._dpool.release(b)

    def abort(self, uri: str) -> bool:
        """Drop a request nobody will collect: remove it from the
        waiting queue, or free its resident slot (and, paged, its blocks
        in both pool tenants).  Returns True if the uri was found.  No
        callback fires."""
        if self._leads():
            return self._flush(("abort", uri))
        with self._lock:
            for req in self._waiting:
                if req.uri == uri:
                    self._waiting.remove(req)
                    self.telemetry.req_errored(uri, "aborted")
                    return True
        for slot, st in enumerate(self._slots):
            if st is not None and st.uri == uri:
                self._slots[slot] = None
                self._done[slot] = True     # frozen until readmission
                self._free.append(slot)
                if self.paged:
                    self._release_slot_blocks(slot)
                self.telemetry.req_errored(uri, "aborted")
                return True
        return False

    def submit(self, uri: str, prompt: np.ndarray,
               on_done: Optional[Callable] = None, *,
               on_error: Optional[Callable] = None,
               temperature: float = 0.0,
               rng_seed: Optional[int] = None,
               max_new: Optional[int] = None,
               prefix: Optional[int] = None,
               top_p: float = 0.0,
               on_token: Optional[Callable] = None,
               priority: str = "standard",
               tenant: str = "",
               handoff_cb: Optional[Callable] = None,
               deadline_t: float = 0.0) -> None:
        """Queue one request.  ``prompt``: 1-D int32 token array.
        ``on_done(uri, tokens)`` fires from the pump thread when the
        request finishes (tokens: ``[max_new]`` int32, eos-padded frozen
        tail); ``on_error(uri, exc)`` fires if admission fails after the
        request left the waiting queue; ``on_token(uri, token, index)``
        streams every generated token.  ``max_new`` (default: the
        engine budget) caps THIS request's tokens.  ``prefix``: a
        ``register_prefix`` id; ``prompt`` is then the suffix that
        follows it.  ``temperature > 0`` samples (needs ``rng_seed``,
        masked to 32 bits; ``top_p`` in (0, 1) adds the nucleus
        filter; not with a draft model: speculative serving is greedy
        only).  ``priority``/``tenant`` feed the QoS scheduler of an
        engine built with ``qos`` (recorded for telemetry otherwise).
        ``deadline_t`` (absolute ``time.monotonic`` seconds, 0 = none):
        a request still waiting past it is shed at admission with
        ``DeadlineExceeded``.  ``handoff_cb(state)`` makes this engine
        the request's prefill side: when the first token lands the
        row's block chain and a copy of its K/V are exported, the row
        is freed, and the callback gets the state dict for another
        engine's ``submit_handoff`` (paged, greedy, no draft).  Raises
        on bounds violations."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got {prompt.shape}")
        n = len(prompt)
        if prefix is not None:
            with self._lock:
                if prefix not in self._prefixes:
                    raise ValueError(f"unknown prefix id {prefix}")
                entry = self._prefixes[prefix]
            plen_pref = len(entry[0]) if self.paged else entry[2]
            # the TRUE prompt (prefix + suffix) must fit the prompt
            # budget; the padded suffix only needs to fit the cache
            if n < 1 or plen_pref + n > self.max_prompt_width:
                raise ValueError(
                    f"prefix({plen_pref}) + suffix({n}) exceeds max "
                    f"prompt width {self.max_prompt_width}")
        elif n < 1 or n > self.max_prompt_width:
            raise ValueError(
                f"prompt length {n} outside [1, {self.max_prompt_width}]")
        if temperature > 0.0 and rng_seed is None:
            raise ValueError("temperature > 0 needs rng_seed")
        if temperature > 0.0 and self.draft_model is not None:
            raise ValueError(
                "speculative continuous batching is greedy-only (the "
                "sampled contract needs rejection sampling); submit "
                "with temperature=0 or build the engine without a draft")
        if rng_seed is not None:
            # an out-of-range client seed must not crash the pump
            rng_seed = int(rng_seed) & 0xFFFFFFFF
        mn = self.max_new_tokens if max_new is None else int(max_new)
        if not 1 <= mn <= self.max_new_tokens:
            raise ValueError(
                f"max_new {mn} outside [1, {self.max_new_tokens}]")
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got {priority!r}")
        if handoff_cb is not None:
            if not self.paged:
                raise ValueError(
                    "handoff_cb requires paged=True: a prefill/decode "
                    "handoff exports a KV BLOCK chain; the arena engine "
                    "has no block tables to rewrite")
            if temperature > 0.0:
                raise ValueError(
                    "prefill/decode handoff is greedy-only: a sampled "
                    "row's RNG stream cannot be split across replicas "
                    "bitwise; submit with temperature=0 or without "
                    "handoff_cb")
            if self.draft_model is not None:
                raise ValueError(
                    "prefill/decode handoff does not compose with "
                    "speculative decoding yet: the draft tenant's block "
                    "chain would have to ship alongside the target's "
                    "(the ROADMAP follow-on 'spec-aware KV handoff' "
                    "lifts this); serve the disaggregated fleet without "
                    "a draft model")
        deadline_t = float(deadline_t or 0.0)
        if deadline_t > 0.0:
            # the admission sweep costs a queue scan a tick: armed by
            # the first deadline, so deadline-free serving pays nothing
            self._deadline_seen = True
        # stamp AFTER validation: a rejected submit never existed as
        # far as queue-wait/TTFT accounting is concerned
        self.telemetry.req_enqueued(uri)
        req = _Req(uri, prompt, on_done, on_error, mn, on_token, prefix,
                   float(temperature), rng_seed, float(top_p), priority,
                   str(tenant), time.monotonic(), handoff_cb,
                   deadline_t=deadline_t)
        if self._leads():
            # every rank queues it at the leader's next flush; the
            # followers' copy carries no callbacks, and a handoff's
            # export parks each follower's shard on its rank
            self._lockstep.post(("submit", req._replace(
                on_done=None, on_error=None, on_token=None,
                handoff_cb=None, park_handoff=handoff_cb is not None)),
                ("submit", req))
            return
        with self._lock:
            self._waiting.append(req)

    def submit_handoff(self, state: dict) -> None:
        """Adopt a prefilled request exported by another engine's
        ``handoff_cb``: queue it for admission as a DECODE row whose
        block chain is copied from the shipped K/V instead of
        recomputed.  ``state`` is the dict ``_handoff_slot`` built on
        the source (prompt, emitted tokens, chain hashes, the K/V
        copies, callbacks).  Thread-safe like ``submit``: the source's
        pump may call straight in; every device write happens later on
        THIS engine's pump thread, at admission.  Under a mesh the leader
        posts the adoption to its followers without the K/V and the
        callbacks: each follower adopts its own shard of the chain, which
        its rank's source engine exported."""
        if not self.paged:
            raise ValueError(
                "submit_handoff requires a paged engine: the handoff "
                "wire format is a KV block chain")
        if self.draft_model is not None:
            raise ValueError(
                "prefill/decode handoff does not compose with "
                "speculative decoding yet (ROADMAP follow-on "
                "'spec-aware KV handoff'); the decode replica must "
                "serve without a draft model")
        chain = state["chain"]
        if int(chain["block_size"]) != self._bs:
            raise ValueError(
                f"handoff block_size {chain['block_size']} != this "
                f"engine's block_size {self._bs}")
        if chain["kv_dtype"] != self.kv_dtype:
            raise ValueError(
                f"handoff kv_dtype {chain['kv_dtype']!r} != this "
                f"engine's kv_dtype {self.kv_dtype!r}")
        plen = int(state["plen"])
        mn = int(state["max_new"])
        if plen > self.max_prompt_width:
            raise ValueError(
                f"handoff prompt length {plen} exceeds max prompt "
                f"width {self.max_prompt_width}")
        if mn > self.max_new_tokens:
            raise ValueError(
                f"handoff max_new {mn} exceeds engine budget "
                f"{self.max_new_tokens}")
        ls = self._lockstep
        if ls is not None and ls.leader:
            # posted even from inside the leader's own replay (a source's
            # handoff callback adopting on this engine): the followers
            # adopt only what they replay
            self.mesh.lane_boxes[state["lane"]].sent(state["uri"])
            ls.post(("handoff", {
                k: v for k, v in state.items()
                if k not in ("k", "v", "lease") and not callable(v)}),
                ("handoff", state))
            return
        self._leads()
        self._enqueue_handoff(state)

    def _enqueue_handoff(self, state: dict) -> None:
        """Queue a validated handoff for admission."""
        self.telemetry.req_enqueued(state["uri"])
        with self._lock:
            self._waiting.append(_Req(
                state["uri"], np.asarray(state["prompt"], np.int32),
                state.get("on_done"), state.get("on_error"),
                int(state["max_new"]), state.get("on_token"),
                priority=state.get("priority", "standard"),
                tenant=state.get("tenant", ""), enq_t=time.monotonic(),
                handoff_state=state))

    # ---- pump ---------------------------------------------------------

    def _req_error(self, uri, on_error, exc):
        self.telemetry.req_errored(uri, f"{type(exc).__name__}: {exc}")
        if on_error is None:
            return
        try:
            on_error(uri, exc)
        except Exception:
            logger.exception("on_error callback failed for %r", uri)

    def _full_prompt(self, req: _Req) -> np.ndarray:
        """The TRUE token sequence a paged request decodes: a
        ``prefix=`` id expands to its registered tokens + the suffix,
        and the chain-hash index then shares the pinned blocks."""
        if req.prefix is None:
            return req.prompt
        with self._lock:
            if req.prefix not in self._prefixes:
                raise ValueError(f"prefix id {req.prefix} was "
                                 f"unregistered while queued")
            ptoks = self._prefixes[req.prefix][0]
        return np.concatenate([ptoks, req.prompt])

    def _admit(self) -> int:
        """Move waiting requests into free slots: shed expired
        deadlines, hold the classes the brownout level sheds, run one
        admission pass, and with nothing admissible left and slots free
        serve the held requests after all (work-conserving: the ladder
        gates NEW arrivals at the front door; work already accepted
        must not strand behind idle slots).  Held requests return to
        the front of their subqueues in order.  Returns the number
        admitted."""
        if self._deadline_seen:
            self._shed_expired_waiting()
        deferred = (self._brownout_defer_extract()
                    if self._brownout_level >= 1 else None)
        try:
            admitted = self._admit_pass()
            if deferred and admitted == 0 and self._free \
                    and not len(self._waiting):
                with self._lock:
                    for req in reversed(deferred):
                        self._waiting.appendleft(req)
                deferred = None
                admitted = self._admit_pass()
            return admitted
        finally:
            if deferred:
                with self._lock:
                    for req in reversed(deferred):
                        self._waiting.appendleft(req)

    def _admit_pass(self) -> int:
        if self.chunked:
            return self._admit_chunked()
        return self._admit_paged() if self.paged else self._admit_arena()

    def _shed_expired_waiting(self) -> None:
        """Admission-time deadline shed: every waiting request whose
        ``deadline_t`` has passed ends now with ``DeadlineExceeded``,
        before any prefill, slot or block is spent on it."""
        now = self._now()
        with self._lock:
            expired = [r for r in self._waiting
                       if r.deadline_t > 0.0 and now > r.deadline_t]
            for r in expired:
                self._waiting.remove(r)
        for r in expired:
            self._deadline_sheds += 1
            self.telemetry.deadline_shed(r.uri)
            late_ms = (now - r.deadline_t) * 1e3
            self._req_error(r.uri, r.on_error, DeadlineExceeded(
                f"deadline_exceeded: deadline passed {late_ms:.0f}ms "
                f"before admission"))

    def _brownout_defer_extract(self) -> list:
        """Take every waiting request whose class the brownout level
        sheds out of the queue for this admission pass (the caller puts
        them back at the front).  Their ``enq_t`` is untouched, so they
        keep aging."""
        lvl = self._brownout_level
        with self._lock:
            deferred = [r for r in self._waiting
                        if not scheduler_policy.brownout_admit(
                            lvl, r.priority)]
            for r in deferred:
                self._waiting.remove(r)
        return deferred

    # ---- arena mode ---------------------------------------------------

    def _admit_arena(self) -> int:
        """Move waiting requests into free slots.  Joiners sharing a
        prompt bucket prefill TOGETHER in one forward (the draft too,
        with a draft model) and their K/V are copied into their slots;
        prefix-id requests sharing (prefix, suffix width) are admitted
        as one group.  Returns the number admitted."""
        admitted = 0
        while self._free:
            with self._lock:
                grab = min(len(self._free), len(self._waiting))
                batch = [self._waiting.popleft() for _ in range(grab)]
            if not batch:
                break
            by_bucket: Dict[int, list] = {}
            by_prefix: Dict[tuple, list] = {}
            for req in batch:
                if req.prefix is not None:
                    with self._lock:
                        P = self._prefixes.get(req.prefix,
                                               (None, None, 0))[2]
                    sb = self._suffix_width(len(req.prompt), P)
                    by_prefix.setdefault((req.prefix, sb), []).append(req)
                    continue
                pb = _next_bucket(len(req.prompt), self.prompt_buckets)
                by_bucket.setdefault(pb, []).append(req)
            for (pid, sb), reqs in by_prefix.items():
                try:
                    admitted += self._admit_prefix_group(pid, sb, reqs)
                except Exception as e:
                    logger.exception("prefix admission failed for %d "
                                     "request(s), prefix %s", len(reqs),
                                     pid)
                    for req in reqs:
                        self._req_error(req.uri, req.on_error, e)
            for pb, reqs in by_bucket.items():
                # a failed prefill/splice must not swallow requests that
                # already left the waiting queue
                try:
                    pre = self._prefill(pb, reqs)
                except Exception as e:
                    logger.exception("prefill failed for %d request(s), "
                                     "bucket %d", len(reqs), pb)
                    for req in reqs:
                        self._req_error(req.uri, req.on_error, e)
                    continue
                for i, req in enumerate(reqs):
                    try:
                        self._splice_one(pre, i, req)
                        admitted += 1
                    except Exception as e:
                        logger.exception("splice failed for %r", req.uri)
                        self._req_error(req.uri, req.on_error, e)
        return admitted

    @torch.no_grad()
    def _prefill(self, pb: int, reqs):
        """One causal forward over a bucket's ``[k, pb]`` right-padded
        prompts, and the draft's over the same prompts; returns (first
        tokens ``[k]`` on the host, K/V ``[n_layers, k, pb, KH, D]``,
        the draft's K/V or ``None``).  The head is applied to each row's
        last real position only."""
        k = len(reqs)
        padded = np.full((k, pb), self.pad_id, np.int32)
        plens = np.empty(k, np.int64)
        for i, req in enumerate(reqs):
            padded[i, :len(req.prompt)] = req.prompt
            plens[i] = len(req.prompt)
        dev = self.device
        toks = torch.as_tensor(padded, device=dev)
        h, ks, vs = self.model._prefill_hidden(toks)
        last = self.model._logits(
            h[torch.arange(k, device=dev), torch.as_tensor(plens - 1,
                                                           device=dev)])
        self.prefill_calls += 1
        self.prefill_shapes[(k, pb)] += 1
        dks = dvs = None
        if self.draft_model is not None:
            _, dks, dvs = self.draft_model._prefill_hidden(toks)
            self.draft_prefill_calls += 1
        return self._pick_first(last, reqs, plens), ks, vs, dks, dvs

    def _splice_one(self, pre, i: int, req: _Req) -> None:
        """Copy joiner ``i``'s prefilled K/V (both models') into a free
        slot's row and install it; the slot goes back to the free list
        if that fails."""
        firsts, ks, vs, dks, dvs = pre
        slot = self._free.popleft()
        try:
            pb = ks.shape[2]
            self._ck[:, slot, :pb] = ks[:, i]
            self._cv[:, slot, :pb] = vs[:, i]
            if dks is not None:
                self._dck[:, slot, :pb] = dks[:, i]
                self._dcv[:, slot, :pb] = dvs[:, i]
        except Exception:
            self._free.append(slot)
            raise
        self._install_slot(slot, req, len(req.prompt), int(firsts[i]))

    def _suffix_width(self, n: int, P: int) -> int:
        """Padded width of a prefix request's suffix: a prompt bucket
        when one fits after the prefix, else the exact room left in the
        cache.  Suffix padding writes dead K/V past the true prompt that
        are never attended and later overwritten, so only the cache
        bound (L) applies, not the prompt budget."""
        for b in self.prompt_buckets:
            if n <= b and P + b <= self._L - 1:
                return b
        return self._L - 1 - P

    @torch.no_grad()
    def _admit_prefix_group(self, pid: int, sb: int, reqs) -> int:
        """Admission for prefix-id requests sharing (prefix, suffix
        width): splice the stored prefix K/V into each member's row and
        run all their suffixes against it in one ``prefill_chunk``
        forward at offset P (the draft likewise, against its own stored
        prefix), which is what prefilling each concatenated prompt
        computes.  Returns the number admitted."""
        with self._lock:
            if pid not in self._prefixes:
                raise ValueError(f"prefix id {pid} was unregistered "
                                 f"while queued")
            pks, pvs, P, dks, dvs = self._prefixes[pid]
        n = min(len(reqs), len(self._free))
        if n < len(reqs):
            # free slots ran out mid-batch: requeue the rest in order
            with self._lock:
                for req in reversed(reqs[n:]):
                    self._waiting.appendleft(req)
            reqs = reqs[:n]
        if not reqs:
            return 0
        padded = np.full((n, sb), self.pad_id, np.int32)
        lens = np.empty(n, np.int32)
        for i, req in enumerate(reqs):
            padded[i, :len(req.prompt)] = req.prompt
            lens[i] = len(req.prompt)
        slots = [self._free.popleft() for _ in range(n)]
        dev = self.device
        toks = torch.as_tensor(padded, device=dev)
        pos = torch.full((n,), P, dtype=torch.int32, device=dev)
        lens_t = torch.as_tensor(lens, device=dev)
        try:
            idx = torch.as_tensor(slots, device=dev)
            tenants = [(self.model, self._ck, self._cv, pks, pvs)]
            if self.draft_model is not None:
                tenants.append((self.draft_model, self._dck, self._dcv,
                                dks, dvs))
            for j, (m, ck, cv, qk, qv) in enumerate(tenants):
                rows_k = ck[:, idx]             # [layers, n, L, KH, D]
                rows_v = cv[:, idx]
                rows_k[:, :, :P] = qk
                rows_v[:, :, :P] = qv
                out = m.prefill_chunk(toks, rows_k, rows_v, pos, lens_t)
                ck[:, idx] = rows_k
                cv[:, idx] = rows_v
                if j == 0:
                    last = out
        except Exception:
            self._free.extend(slots)
            raise
        firsts = self._pick_first(last, reqs, P + lens)
        admitted = 0
        for i, req in enumerate(reqs):
            try:
                self._install_slot(slots[i], req, P + int(lens[i]),
                                   int(firsts[i]))
                admitted += 1
            except Exception as e:
                self._free.append(slots[i])
                self._req_error(req.uri, req.on_error, e)
        return admitted

    # ---- paged mode ---------------------------------------------------

    def _match_blocks(self, hashes, plen: int):
        """Leading full prompt blocks found in the index, capped at
        ``(plen-1)//bs`` so the LAST prompt token always recomputes (its
        forward yields the first-token logits).  With a draft both
        tenants must start at the same frontier, so the usable match is
        the shorter of the two.  Returns (matched, draft matched or
        None); nothing is acquired."""
        cap = (plen - 1) // self._bs
        matched = self._pool.lookup(hashes[:cap])
        if self._dpool is None:
            return matched, None
        dmatch = self._dpool.lookup(hashes[:cap])
        m = min(len(matched), len(dmatch))
        return matched[:m], dmatch[:m]

    def _pool_cap(self) -> int:
        cap = self._pool.n_blocks - 1
        if self._dpool is not None:
            cap = min(cap, self._dpool.n_blocks - 1)
        return cap

    def _pools_short(self, n: int) -> bool:
        """Whether either pool tenant has fewer than ``n`` allocatable
        blocks."""
        return self._pool.allocatable() < n or (
            self._dpool is not None and self._dpool.allocatable() < n)

    def _admit_paged(self) -> int:
        """Paged admission: per request, match leading FULL prompt
        blocks in the chain-hash index (copy-free sharing), allocate
        private blocks for the rest (in both tenants with a draft), and
        prefill only the unshared suffix — grouped by suffix bucket, one
        device call per bucket and tenant.  A request the pool can't
        hold yet requeues at the FRONT (order preserved) and admission
        stops."""
        admitted = 0
        while self._free:
            with self._lock:
                grab = min(len(self._free), len(self._waiting))
                batch = [self._waiting.popleft() for _ in range(grab)]
            if not batch:
                break
            plans, blocked = [], []
            for req in batch:
                if blocked:         # keep queue order behind the block
                    blocked.append(req)
                    continue
                if req.handoff_state is not None:
                    # an adopted chain runs no prefill: no plan, no group
                    res = self._admit_handoff(req)
                    if res == "admitted":
                        admitted += 1
                    elif res == "blocked":
                        blocked.append(req)
                    continue
                try:
                    full = self._full_prompt(req)
                except Exception as e:
                    self._req_error(req.uri, req.on_error, e)
                    continue
                plan = self._plan_paged(req, full,
                                        not plans and admitted == 0)
                if plan == "blocked":
                    blocked.append(req)
                elif plan is not None:
                    plans.append(plan)
            if blocked:
                with self._lock:
                    for req in reversed(blocked):
                        self._waiting.appendleft(req)
            # deferred pool-callback device work, in dependency order:
            # spills gather an evicted id's OLD bytes before a readmit
            # scatter or the group prefill below rewrites it
            self._drain_spills()
            self._apply_readmits()
            groups: Dict[int, list] = {}
            for plan in plans:
                slen = len(plan[1]) - plan[3] * self._bs
                sb = _next_bucket(slen, self.prompt_buckets)
                groups.setdefault(sb, []).append(plan)
            for sb, plist in groups.items():
                try:
                    admitted += self._admit_paged_group(sb, plist)
                except Exception as e:
                    logger.exception("paged admission failed for %d "
                                     "request(s)", len(plist))
                    with self._pool_lock:
                        for _, _, _, _, blocks, dblocks in plist:
                            for b in blocks:
                                self._pool.release(b)
                            for b in dblocks or ():
                                self._dpool.release(b)
                    for req, _, _, _, _, _ in plist:
                        self._req_error(req.uri, req.on_error, e)
            if blocked:
                break
        return admitted

    @torch.no_grad()
    def _plan_paged(self, req: _Req, full: np.ndarray, first: bool):
        """One request's monolithic paged plan, under the pool lock:
        match and acquire its leading prompt blocks, extend the match
        from the host tier, allocate the rest in both tenants.  Returns
        the plan, ``"blocked"`` when the pools cannot hold it yet, or
        None after failing the request (a prompt larger than the pool,
        or a dry pool with nothing in flight when ``first``).  Errors
        surface after the lock: ``on_error`` is user code."""
        plen = len(full)
        hashes = self._pool.block_hashes(full)
        total = -(-plen // self._bs)
        err: Optional[Exception] = None
        with self._pool_lock:
            matched, dmatch = self._match_blocks(hashes, plen)
            need = total - len(matched)
            # +1 headroom: the first decode tokens must not instantly
            # preempt what admission just built
            cap = self._pool_cap()
            if need + 1 > cap:
                err = ValueError(
                    f"prompt needs {need} private blocks + headroom but "
                    f"the pool holds {cap}")
            elif self._take_matched(matched, dmatch, need):
                if self._kv_store is not None:
                    # extend the (now pinned: adoption may evict CACHED
                    # blocks, never a held one) device match from the
                    # host tier; adoption takes exactly the blocks the
                    # shorter ``need`` no longer asks for, so the dry
                    # gate still covers the allocations below
                    matched = matched + self._store_readmit(
                        hashes, len(matched), (plen - 1) // self._bs)
                    need = total - len(matched)
                blocks = list(matched)
                for _ in range(need):
                    blocks.append(self._pool.allocate())
                dblocks = None
                if dmatch is not None:
                    dblocks = list(dmatch)
                    for _ in range(need):
                        dblocks.append(self._dpool.allocate())
            elif not (self.n_active == 0 and first):
                return "blocked"
            else:
                # nothing in flight will ever free blocks
                err = RuntimeError(
                    f"pool dry with no residents: "
                    f"{self._pool.num_referenced()} of "
                    f"{self._pool.n_blocks} blocks are held")
        if err is not None:
            self._req_error(req.uri, req.on_error, err)
            return None
        return req, full, hashes, len(matched), blocks, dblocks

    def _take_matched(self, matched, dmatch, need: int) -> bool:
        """Acquire a plan's matched blocks (both tenants) if the pools
        can then still allocate its ``need`` private blocks, with one
        block of headroom checked first.  A matched block parked in the
        LRU counts as allocatable until it is acquired, so the check
        repeats after the acquires, which are undone when it fails (the
        reference's gate checks only before, and its allocation then
        hands out no block).  Caller holds ``_pool_lock``."""
        if self._pools_short(need + 1):
            return False
        for b in matched:
            self._pool.acquire(b)
        for b in dmatch or ():
            self._dpool.acquire(b)
        if not self._pools_short(need):
            return True
        for b in matched:
            self._pool.release(b)
        for b in dmatch or ():
            self._dpool.release(b)
        return False

    def _admit_paged_group(self, sb: int, plans) -> int:
        """One paged-prefill device call for every planned request
        sharing a suffix bucket, and the same grid against the draft
        tenant (whose logits are discarded).  After the call each row's
        full private prompt blocks are published in the hash index, so
        the NEXT identical prompt shares them.  (The JAX engine also
        pads the row count to a power of two to bound its compile count;
        eager PyTorch compiles nothing, so rows are not padded.)"""
        n = len(plans)
        padded = np.full((n, sb), self.pad_id, np.int32)
        lens = np.ones(n, np.int32)
        pos = np.zeros(n, np.int32)
        tabs = np.full((n, self._M), SINK_BLOCK, np.int32)
        dtabs = np.full((n, self._M), SINK_BLOCK, np.int32)
        for i, (req, full, hashes, n_match, blocks,
                dblocks) in enumerate(plans):
            sfx = full[n_match * self._bs:]
            padded[i, :len(sfx)] = sfx
            lens[i] = len(sfx)
            pos[i] = n_match * self._bs
            tabs[i, :len(blocks)] = blocks
            if dblocks is not None:
                dtabs[i, :len(dblocks)] = dblocks
        dev = self.device
        toks = torch.as_tensor(padded, device=dev)
        pos_t = torch.as_tensor(pos, device=dev)
        lens_t = torch.as_tensor(lens, device=dev)
        last = self.model.prefill_chunk_paged(
            toks, self._pk, self._pv, torch.as_tensor(tabs, device=dev),
            pos_t, lens_t, kernel=self.kernel)
        self.prefill_calls += 1
        self.prefill_shapes[(n, sb, tuple(pos.tolist()))] += 1
        if self._dpool is not None:
            self.draft_model.prefill_chunk_paged(
                toks, self._dpk, self._dpv,
                torch.as_tensor(dtabs, device=dev), pos_t, lens_t,
                kernel=self._dkernel)
            self.draft_prefill_calls += 1
        firsts = self._pick_first(
            last, [plan[0] for plan in plans],
            np.array([len(plan[1]) for plan in plans], np.int64))
        admitted = 0
        for i, (req, full, hashes, n_match, blocks,
                dblocks) in enumerate(plans):
            plen = len(full)
            slot = self._free.popleft()
            self._set_row_blocks(slot, blocks, dblocks)
            # publish BEFORE install: the prefill succeeded, so the
            # blocks' content is valid for sharing
            with self._pool_lock:
                for j in range(n_match, plen // self._bs):
                    self._pool.insert(hashes[j], blocks[j])
                    if dblocks is not None:
                        self._dpool.insert(hashes[j], dblocks[j])
            try:
                self._install_slot(slot, req, plen, int(firsts[i]))
                admitted += 1
            except Exception as e:
                self._free.append(slot)
                self._release_slot_blocks(slot)
                self._req_error(req.uri, req.on_error, e)
        return admitted

    def _set_row_blocks(self, slot: int, blocks, dblocks) -> None:
        """Point a slot's block table(s) at its blocks, SINK beyond."""
        self._row_blocks[slot] = list(blocks)
        self._tables[slot, :] = SINK_BLOCK
        self._tables[slot, :len(blocks)] = blocks
        if dblocks is not None:
            self._drow_blocks[slot] = list(dblocks)
            self._dtables[slot, :] = SINK_BLOCK
            self._dtables[slot, :len(dblocks)] = dblocks

    # ---- chunked admission (PREFILLING slots, no device call) ---------

    def _admit_chunked(self) -> int:
        """Chunked admission runs NO prefill: it claims a slot, installs
        it PREFILLING and (paged) attaches any prefix-matched blocks;
        the prompt lands chunk by chunk inside the ticks.  A paged
        request the pool can't start yet requeues at the front and
        admission stops (order preserved)."""
        admitted = 0
        while self._free:
            with self._lock:
                req = self._waiting.popleft() if self._waiting else None
            if req is None:
                break
            res = (self._admit_one_chunked_paged(req) if self.paged
                   else self._admit_one_chunked(req))
            if res == "admitted":
                admitted += 1
            elif res == "blocked":
                with self._lock:
                    self._waiting.appendleft(req)
                break
        return admitted

    def _admit_one_chunked(self, req: _Req) -> str:
        """Arena chunked admission: splice a named prefix's stored K/V
        (both models') into the slot's row and install it PREFILLING at
        the prefix boundary."""
        base = 0
        entry = None
        if req.prefix is not None:
            with self._lock:
                entry = self._prefixes.get(req.prefix)
            if entry is None:
                self._req_error(req.uri, req.on_error, ValueError(
                    f"prefix id {req.prefix} was unregistered while "
                    f"queued"))
                return "error"
            base = entry[2]
        slot = self._free.popleft()
        if entry is not None:
            pks, pvs, P, dks, dvs = entry
            try:
                self._ck[:, slot, :P] = pks[:, 0]
                self._cv[:, slot, :P] = pvs[:, 0]
                if self.draft_model is not None:
                    # the draft's chunks run against the same prefix
                    self._dck[:, slot, :P] = dks[:, 0]
                    self._dcv[:, slot, :P] = dvs[:, 0]
            except Exception as e:
                self._free.append(slot)
                logger.exception("chunked prefix splice failed for %r",
                                 req.uri)
                self._req_error(req.uri, req.on_error, e)
                return "error"
        self._install_prefill(slot, req, base + len(req.prompt),
                              base=base, full=req.prompt)
        return "admitted"

    def _admit_one_chunked_paged(self, req: _Req) -> str:
        """Paged chunked admission: match and acquire leading full
        prompt blocks (both tenants) and install PREFILLING at the
        matched boundary.  Blocks for the unmatched tail are allocated
        per chunk by the tick; a mid-prompt dry pool preempts this
        prefilling row back to the queue, never a decoder."""
        if req.handoff_state is not None:
            return self._admit_handoff(req)
        try:
            full = self._full_prompt(req)
        except Exception as e:
            self._req_error(req.uri, req.on_error, e)
            return "error"
        plen = len(full)
        hashes = self._pool.block_hashes(full)
        total = -(-plen // self._bs)
        err: Optional[Exception] = None
        with self._pool_lock:
            matched, dmatch = self._match_blocks(hashes, plen)
            need = total - len(matched)
            cap = self._pool_cap()
            if need + 1 > cap:
                err = ValueError(
                    f"prompt needs {need} private blocks + headroom but "
                    f"the pool holds {cap}")
            # per-chunk allocation only needs room to START (first
            # chunk block + decode headroom)
            elif self._pools_short(2):
                if self.n_active != 0:
                    return "blocked"
                err = RuntimeError(
                    f"pool dry with no residents: "
                    f"{self._pool.num_referenced()} of "
                    f"{self._pool.n_blocks} blocks are pinned (unregister "
                    f"a prefix or raise n_blocks)")
            else:
                for b in matched:
                    self._pool.acquire(b)
                for b in dmatch or ():
                    self._dpool.acquire(b)
                if self._kv_store is not None:
                    # extend the device match from the host tier, leaving
                    # the 2 allocatable blocks the first chunk needs (no
                    # draft tenant: the tier refuses speculative engines)
                    limit = min((plen - 1) // self._bs,
                                len(matched)
                                + max(0, self._pool.allocatable() - 2))
                    matched = matched + self._store_readmit(
                        hashes, len(matched), limit)
        if err is not None:
            self._req_error(req.uri, req.on_error, err)
            return "error"
        # adoption may have evicted (spill pending) and recorded host
        # payloads: flush both before the tick's device work
        self._drain_spills()
        self._apply_readmits()
        slot = self._free.popleft()
        self._set_row_blocks(slot, matched, dmatch)
        self._install_prefill(slot, req, plen, base=0, full=full,
                              hashes=list(hashes),
                              fill=len(matched) * self._bs,
                              n_pub=len(matched))
        return "admitted"

    def _install_prefill(self, slot: int, req: _Req, plen: int, *,
                         base: int, full, hashes=None, fill=None,
                         n_pub: int = 0) -> None:
        """Install a slot PREFILLING: the decode side sees a frozen row
        (done, fed pad) anchored at the fill frontier until its last
        chunk lands.  ``fill`` (paged) starts past prefix-matched
        blocks; arena rows start past the spliced prefix (``base``)."""
        st = _Slot(uri=req.uri,
                   max_new=self._brownout_mn(req.priority, req.max_new),
                   on_done=req.on_done, on_token=req.on_token,
                   temperature=req.temperature, rng_seed=req.rng_seed,
                   top_p=req.top_p, req=req, admit_seq=self._admit_seq,
                   plen=plen, state="PREFILLING",
                   fill_pos=base if fill is None else fill, base=base,
                   full=np.asarray(full, np.int32), hashes=hashes,
                   n_pub=n_pub)
        self._slots[slot] = st
        self._admit_seq += 1
        self._tok[slot] = self.pad_id
        self._pos[slot] = st.fill_pos
        self._dpos[slot] = st.fill_pos
        self._done[slot] = True
        self.telemetry.req_admitted(req.uri, slot, prefilling=True,
                                    priority=req.priority)

    def _ensure_blocks(self, active) -> list:
        """Grow each resident's block table(s) to cover the positions
        the coming step will write (a spec round writes k+1 verify
        positions).  When a pool is dry, PREEMPT the latest admission
        (never the oldest — earliest requests keep strict forward
        progress, so this terminates).  Returns the still-active
        subset."""
        for i in list(active):
            st = self._slots[i]
            if st is None:
                continue
            if self.draft_model is not None:
                last_write = min(int(self._pos[i]) + self._spec_k,
                                 self._L - 1)
            else:
                ticks = max(1, min(self.ticks_per_step,
                                   st.max_new - len(st.tokens)))
                last_write = min(int(self._pos[i]) + ticks - 1,
                                 self._L - 1)
            self._grow_row(i, last_write // self._bs + 1)
        # growth may have evicted indexed blocks: gather their bytes
        # before the coming step writes the reused ids
        self._drain_spills()
        return [i for i in active if self._slots[i] is not None]

    def _grow_row(self, i: int, need: int) -> None:
        """Grow row ``i``'s block table(s) to ``need`` blocks,
        preempting whenever a pool is dry — including row ``i`` itself,
        which ends the loop.  With a draft model the two tenants grow in
        LOCKSTEP to the same block count, and a preemption frees both,
        so a row's verify pointer never outruns its draft pages."""
        self._grow_tenant(i, need, self._pool, self._row_blocks,
                          self._tables)
        if self._dpool is not None:
            self._grow_tenant(i, need, self._dpool, self._drow_blocks,
                              self._dtables)

    def _grow_tenant(self, i: int, need: int, pool, row_blocks,
                     tables) -> None:
        while self._slots[i] is not None and len(row_blocks[i]) < need:
            with self._pool_lock:
                b = pool.allocate()
            if b is None:
                self._preempt(self._pick_victim())
                continue
            tables[i, len(row_blocks[i])] = b
            row_blocks[i].append(b)

    def _grow_chunk_blocks(self, decode_rows, chunks) -> None:
        """Per-tick paged growth for a chunked tick: decode rows need
        their write positions covered (k+1 under speculation); each
        chunk row needs blocks through its chunk's last write.  Pool-dry
        preemption takes the LATEST PREFILLING row first
        (``_pick_victim``): decoders that already emitted tokens are
        never evicted to feed a joiner's prompt."""
        for i in decode_rows:
            if self._slots[i] is None:
                continue
            last_write = min(int(self._pos[i]) + self._spec_k,
                             self._L - 1)
            self._grow_row(i, last_write // self._bs + 1)
        for i, clen in chunks:
            st = self._slots[i]
            if st is None:
                continue
            self._grow_row(i, (st.fill_pos + clen - 1) // self._bs + 1)
        # growth may have evicted indexed blocks: gather their bytes
        # before the tick writes the reused ids
        self._drain_spills()

    def _publish_chunk_blocks(self, i: int, st: _Slot) -> None:
        """Hash-publish the prompt blocks a landed chunk fully covered
        (never the frontier block: a partially written block must not
        be shared), in both tenants, as monolithic admission publishes
        after its prefill."""
        if st.hashes is None:
            return
        hi = min(st.fill_pos // self._bs, st.plen // self._bs)
        if hi <= st.n_pub:
            return
        with self._pool_lock:
            for j in range(st.n_pub, hi):
                self._pool.insert(st.hashes[j], self._row_blocks[i][j])
                if self._dpool is not None:
                    self._dpool.insert(st.hashes[j],
                                       self._drow_blocks[i][j])
        st.n_pub = hi

    def _table_width(self, need: int) -> int:
        """Power-of-two narrow table width for a chunk grid, wide enough
        for every position the chunks write or attend, at most M."""
        v = 1
        while v < need:
            v *= 2
        return min(v, self._M)

    def _pick_victim(self) -> int:
        return scheduler_policy.pick_victim(
            (i, s.state, s.admit_seq)
            for i, s in enumerate(self._slots) if s is not None)

    def _preempt(self, slot: int) -> None:
        """Evict a resident back to the WAITING queue (front, original
        request intact, partial tokens discarded) and free its blocks.
        Readmission recomputes the prompt and regenerates the same
        tokens (every pick is a function of seed, position and
        logits)."""
        st = self._slots[slot]
        self._slots[slot] = None
        self._done[slot] = True
        self._free.append(slot)
        self._release_slot_blocks(slot)
        self._preemptions += 1
        prefilling = st.state == "PREFILLING"
        if prefilling:
            self._prefill_preemptions += 1
        logger.warning("block pool dry: preempted %r (recompute on "
                       "readmission)", st.uri)
        with self._lock:
            self._waiting.appendleft(st.req)
        # TTFT keeps the original arrival; partial tokens are
        # discarded, so their stamps go too (telemetry mirrors both)
        self.telemetry.req_preempted(st.uri, slot, prefilling=prefilling)

    def _release_slot_blocks(self, slot: int) -> None:
        """Drop a finished/preempted row's block references (both
        tenants together) and point its table rows at the sink, so the
        frozen row's future writes can never touch a block the pool
        hands to someone else."""
        blocks = self._row_blocks[slot]
        self._row_blocks[slot] = []
        self._tables[slot, :] = SINK_BLOCK
        dblocks = []
        if self._dpool is not None:
            dblocks = self._drow_blocks[slot]
            self._drow_blocks[slot] = []
            self._dtables[slot, :] = SINK_BLOCK
        with self._pool_lock:
            for b in blocks:
                self._pool.release(b)
            for b in dblocks:
                self._dpool.release(b)

    # ---- prefill/decode handoff ---------------------------------------

    def _admit_handoff(self, req: _Req) -> str:
        """Adopt a prefill exported by another engine (the decode half
        of a handoff): allocate a same-length block chain
        (``adopt_chain``, carried prefix hashes republished, first
        writer wins), copy the shipped K/V into it (device to device
        when both engines share a card) and install the slot in DECODE
        at the donor's position; no prefill runs here.  A pool that
        cannot hold the chain yet blocks (requeue at the front); a
        later preemption requeues the same request with its immutable
        ``handoff_state``, so re-adoption rebuilds the identical row.
        Then acks the adoption (``on_adopt``, record-only): the source
        may drop what it retained."""
        state = req.handoff_state
        chain = state["chain"]
        n = int(chain["n"])
        err: Optional[Exception] = None
        with self._pool_lock:
            # +1 headroom, as monolithic admission: the first decode
            # tokens must not instantly preempt the adoption
            cap = self._pool.n_blocks - 1
            if n + 1 > cap:
                err = ValueError(
                    f"handoff chain needs {n} blocks + headroom but the "
                    f"pool holds {cap}")
            elif self._pool.allocatable() < n + 1:
                if self.n_active != 0:
                    return "blocked"
                err = RuntimeError(
                    f"pool dry with no residents: "
                    f"{self._pool.num_referenced()} of "
                    f"{self._pool.n_blocks} blocks are pinned (unregister "
                    f"a prefix or raise n_blocks)")
            else:
                blocks = self._pool.adopt_chain(chain)
                if blocks is None:
                    return "blocked"
        if err is not None:
            self._req_error(req.uri, req.on_error, err)
            return "error"
        # adoption may have evicted indexed blocks (spill pending), and
        # an adopted id may BE one: gather before the copy below
        self._drain_spills()
        idx = torch.as_tensor(blocks, device=self.device)
        _kv_scatter(self._pk, idx, state["k"])
        _kv_scatter(self._pv, idx, state["v"])
        slot = self._free.popleft()
        self._set_row_blocks(slot, blocks, None)
        self._slots[slot] = _Slot(
            uri=req.uri, max_new=req.max_new, tokens=list(state["tokens"]),
            on_done=req.on_done, on_token=req.on_token, req=req,
            admit_seq=self._admit_seq, plen=int(state["plen"]))
        self._admit_seq += 1
        # the donor already emitted token[0]; decode resumes from it
        self._tok[slot] = int(state["last_token"])
        self._pos[slot] = int(state["pos"])
        self._dpos[slot] = int(state["pos"])
        self._done[slot] = False
        self._handoffs_in += 1
        self.telemetry.req_admitted(req.uri, slot, priority=req.priority)
        ack = state.get("on_adopt")
        if ack is not None:
            try:
                ack(req.uri, self._replica_id)
            except Exception:
                logger.exception("handoff adoption ack failed for %r",
                                 req.uri)
        return "admitted"

    def _handoff_slot(self, slot: int, st: _Slot) -> None:
        """Export a just-prefilled row for adoption by another engine
        (the prefill half of a handoff), at first-token time: snapshot
        the block chain and its published hashes (``export_chain``),
        COPY the row's blocks out of the pools (``index_select`` makes
        new tensors: the ids are released below and the pools are
        written in place, so a view would change under the
        destination), then free the slot as a completion does.  The
        state dict is self-contained.  Under a mesh it names this
        engine's lane, and a follower parks its shard in its box instead
        of calling back: the leader's callback speaks for every rank,
        and the leader's state holds the :class:`_HandoffLease` that
        frees the followers' shards after its last copy."""
        blocks = list(self._row_blocks[slot])
        with self._pool_lock:
            chain = self._pool.export_chain(blocks)
        idx = torch.as_tensor(blocks, device=self.device)

        def gather(x):
            return x.index_select(1, idx)

        state = {
            "uri": st.uri,
            "prompt": np.asarray(self._full_prompt(st.req), np.int32),
            "plen": st.plen,
            "pos": int(self._pos[slot]),
            "tokens": list(st.tokens),
            "last_token": int(st.tokens[-1]),
            "max_new": st.max_new,
            "priority": st.req.priority,
            "tenant": st.req.tenant,
            "chain": chain,
            "k": _kv_map(gather, self._pk),
            "v": _kv_map(gather, self._pv),
            "on_done": st.on_done,
            "on_error": st.req.on_error,
            "on_token": st.on_token,
        }
        if self._lockstep is not None:
            state["lane"] = self._lockstep.lane
            if self._lockstep.leader:
                state["lease"] = _HandoffLease(st.uri,
                                               self._lockstep.released)
        self._slots[slot] = None
        self._done[slot] = True
        self._free.append(slot)
        self._release_slot_blocks(slot)
        self._handoffs_out += 1
        # this engine's part is over; the destination runs its own
        # enqueue -> admit -> finish lifecycle
        self.telemetry.req_finished(st.uri, slot, len(st.tokens))
        if st.req.park_handoff:
            self._lockstep.handoffs.put(st.uri, {"k": state["k"],
                                                 "v": state["v"]})
            return
        try:
            st.req.handoff_cb(state)
        except Exception as e:
            logger.exception("handoff callback failed for %r", st.uri)
            self._req_error(st.uri, st.req.on_error, e)

    # ---- tiered KV memory ---------------------------------------------

    def _store_evicted(self, hash_: int) -> None:
        """HostKVStore eviction callback: the host copy is gone, so
        retract the host-tier directory claim."""
        if self._prefix_directory is not None:
            self._prefix_directory.unpublish(self._replica_id, hash_,
                                             TIER_HOST)

    def _pool_index_event(self, kind: str, *, hash_: int,
                          block: int) -> None:
        """BlockPool ``index_cb``: mirror device-index membership into
        the fleet PrefixDirectory (under ``_pool_lock``; the directory
        has its own leaf lock and never calls back)."""
        if kind == "publish":
            self._prefix_directory.publish(self._replica_id, hash_,
                                           TIER_HBM)
        else:
            self._prefix_directory.unpublish(self._replica_id, hash_,
                                             TIER_HBM)

    def _spill_block(self, block: int, hash_: int) -> None:
        """BlockPool ``spill_cb``: an indexed CACHED block is being
        evicted.  Record only (it fires under ``_pool_lock``): the copy
        to the host happens in ``_drain_spills``, which every evicting
        path runs before its next pool write, so until then the pools
        still hold the bytes the hash describes."""
        self._pending_spills.append((int(block), hash_))

    def _drain_spills(self) -> None:
        """Copy the blocks ``_spill_block`` recorded to the host store:
        one ``index_select`` gather per pool part into new device
        tensors, packed into one byte buffer, and ONE synchronising D2H
        copy for the wave; then the store puts and the directory's
        host-tier claims, all outside ``_pool_lock``.  Runs before any
        write that could reuse an evicted id (admission, growth, a
        readmit or handoff copy, a shrink): the gather is enqueued
        ahead of those writes on the stream.  Pump thread only."""
        with self._pool_lock:
            pending, self._pending_spills = self._pending_spills, []
        if not pending:
            return
        idx = torch.as_tensor([b for b, _ in pending], device=self.device)
        parts = [x.index_select(1, idx) for pool in (self._pk, self._pv)
                 for x in _kv_parts(pool)]
        flat = torch.cat([x.reshape(-1).view(torch.uint8)
                          for x in parts]).cpu()
        host, off = [], 0
        for x in parts:
            nb = x.numel() * x.element_size()
            host.append(flat[off:off + nb].view(x.dtype).view(x.shape))
            off += nb
        if isinstance(self._pk, QuantKV):
            fetched = {"k": QuantKV(host[0], host[1]),
                       "v": QuantKV(host[2], host[3])}
        else:
            fetched = {"k": host[0], "v": host[1]}
        for i, (_, hash_) in enumerate(pending):
            payload = {key: _kv_map(lambda x: x[:, i:i + 1].clone(), kv)
                       for key, kv in fetched.items()}
            nbytes = self._per_block_bytes * self._kv_shards
            if self._kv_store.put(hash_, payload, nbytes):
                self._kv_spills += 1
                self._kv_spill_bytes += nbytes
                if self._prefix_directory is not None:
                    self._prefix_directory.publish(
                        self._replica_id, hash_, TIER_HOST)

    def _store_readmit(self, hashes, n_matched: int,
                       max_blocks: int) -> List[int]:
        """Extend a device-index prefix match from the host tier: probe
        the store past the device match, adopt the hit chain into the
        pool (all or nothing, carried hashes republished, first writer
        wins) and RECORD the host payloads for ``_apply_readmits`` to
        copy after the lock is released (no H2D under the pool lock).
        Admission applies every recorded copy before its prefill reads
        the blocks and before it could release them.  Returns the
        adopted block ids ([] on a miss or a dry pool; the store keeps
        its entries either way).  Caller holds ``_pool_lock`` and a
        reference on every device-matched block."""
        run = self._kv_store.probe(hashes[n_matched:max_blocks])
        if not run:
            return []
        chain = {"block_size": self._bs, "kv_dtype": self.kv_dtype,
                 "n": len(run), "hashes": [h for h, _ in run]}
        blocks = self._pool.adopt_chain(chain)
        if blocks is None:
            return []

        def cat(*leaves):
            return torch.cat(leaves, dim=1)

        kcat = _kv_map(cat, *[p["k"] for _, p in run])
        vcat = _kv_map(cat, *[p["v"] for _, p in run])
        self._pending_readmits.append((list(blocks), kcat, vcat))
        self._kv_readmits += 1
        self._kv_readmit_tokens_saved += len(blocks) * self._bs
        return blocks

    def _apply_readmits(self) -> None:
        """Copy the host payloads ``_store_readmit`` recorded into the
        device pool (H2D), outside ``_pool_lock``, AFTER
        ``_drain_spills`` (an adopted id may be a just-evicted one whose
        old bytes the spill must gather first) and before the
        admission's prefill reads the blocks."""
        pending, self._pending_readmits = self._pending_readmits, []
        for blocks, kcat, vcat in pending:
            idx = torch.as_tensor(blocks, device=self.device)
            _kv_scatter(self._pk, idx, kcat)
            _kv_scatter(self._pv, idx, vcat)

    # ---- elastic pool -------------------------------------------------

    def resize_pool(self, target: int) -> int:
        """Grow or shrink BOTH tenants' block pools toward ``target``
        blocks (clamped to [floor, ceiling]) and reallocate the device
        pools to match.  A shrink sheds only the contiguous unreferenced
        TAIL of the id space (``BlockPool.shrink`` stops at the first
        referenced block; cached tail blocks are evicted, and spilled to
        the host tier first), and a deeper request is clamped and
        counted, never raised; both tenants move by the same count.  A
        grow allocates the new pools before dropping the old ones (2x
        the pool at its peak); a shrink copies the kept prefix so the
        old storage is freed (to PyTorch's allocator cache, which
        ``torch.cuda.mem_get_info`` still counts as used).  Pump thread
        only, between ticks.  Returns the signed block delta
        applied."""
        if not self.paged:
            raise ValueError("resize_pool requires paged=True")
        if self._leads():
            return self._flush(("resize", int(target)))
        want = int(target)
        target = max(self._pool_floor,
                     min(want, self._pool_ceiling or want))
        clamped = target != want
        with self._pool_lock:
            n = self._pool.n_blocks
            if target > n:
                applied = self._pool.grow(target - n)
                if self._dpool is not None:
                    self._dpool.grow(target - n)
            elif target < n:
                m = min(n - target, self._pool.shrinkable())
                if self._dpool is not None:
                    m = min(m, self._dpool.shrinkable())
                if m < n - target:
                    clamped = True
                applied = -self._pool.shrink(m) if m else 0
                if m and self._dpool is not None:
                    self._dpool.shrink(m)
            else:
                applied = 0
        # a shrink evicts the cached tail: gather those blocks into the
        # host tier BEFORE the pools lose them
        self._drain_spills()
        if clamped:
            self._pool_resize_clamps += 1
        if applied == 0:
            return 0
        new_n = n + applied

        def fit(x):
            if applied > 0:
                # one new allocation (no separate pad tensor): the peak
                # is the old pool plus the new one
                out = x.new_zeros((x.shape[0], new_n) + x.shape[2:])
                out[:, :n] = x
                return out
            return x[:, :new_n].clone(memory_format=torch.contiguous_format)

        self._pk = _kv_map(fit, self._pk)
        self._pv = _kv_map(fit, self._pv)
        if self._dpool is not None:
            self._dpk = fit(self._dpk)
            self._dpv = fit(self._dpv)
        self._pool_resizes += 1
        logger.info("elastic pool resized %d -> %d blocks (%+d)",
                    n, new_n, applied)
        return applied

    def maybe_autoresize(self,
                         goodput: Optional[Dict[str, float]] = None
                         ) -> int:
        """One elastic-pool control step (pump thread): the pool's
        pressure (allocatable blocks, allocation failures since the
        last call) and the caller's per-class goodput go through
        ``policy.plan_pool_resize``, and a non-zero delta through
        ``resize_pool``.  Returns 0 unless built with
        ``elastic_pool=True``."""
        if not (self.paged and self.elastic_pool):
            return 0
        with self._pool_lock:
            n = self._pool.n_blocks
            alloc = self._pool.allocatable()
            fails = self._pool.alloc_failures
            if self._dpool is not None:
                alloc = min(alloc, self._dpool.allocatable())
                fails += self._dpool.alloc_failures
        streak = fails - self._autoresize_last_fails
        self._autoresize_last_fails = fails
        delta = scheduler_policy.plan_pool_resize(
            n_blocks=n, allocatable=alloc, alloc_fail_streak=streak,
            step=self._resize_step, floor=self._pool_floor,
            ceiling=self._pool_ceiling, goodput=goodput)
        if delta == 0:
            return 0
        return self.resize_pool(n + delta)

    def cache_metrics(self) -> dict:
        """Serving-visible cache counters: the ``mode`` (``"arena"`` or
        ``"paged"``), cumulative ``preemptions``, ``peak_resident``
        (running max); chunked: the budget, its mean utilization, the
        prefill queue, chunks in flight, stall ticks and prefill
        preemptions; speculative: ``speculation_k``, rounds, emitted,
        proposed and accepted tokens; paged: the pool's counters and
        gauges (``BlockPool.metrics``), the draft pool's prefixed
        ``draft_``."""
        with self._lock:
            out = {"mode": "paged" if self.paged else "arena",
                   "preemptions": self._preemptions,
                   "peak_resident": self._peak_resident,
                   "qos": self._qos is not None}
            if self._qos is not None:
                out["qos_waiting"] = {
                    f"{cls}/{tenant}": d for (cls, tenant), d in
                    self._waiting.depths().items()}
            if self.chunked:
                denom = self._budget_ticks * self.tick_token_budget
                out.update({
                    "chunked": True,
                    "tick_token_budget": self.tick_token_budget,
                    "budget_utilization": (
                        self._budget_tokens_used / denom if denom
                        else 0.0),
                    "prefill_queue_depth": len(self._waiting),
                    "chunks_in_flight": sum(
                        1 for s in self._slots
                        if s is not None and s.state == "PREFILLING"),
                    "prefill_stall_ticks": self._prefill_stall_ticks,
                    "prefill_preemptions": self._prefill_preemptions,
                })
            if self.draft_model is not None:
                out.update({
                    "speculation_k": self._spec_k,
                    "spec_rounds": self._spec_rounds,
                    "spec_emitted": self._spec_emitted,
                    "spec_proposed": self.telemetry.c_spec_proposed.value,
                    "spec_accepted": self.telemetry.c_spec_accepted.value,
                })
        if self.paged:
            with self._pool_lock:
                out.update(self._pool.metrics())
                if self._dpool is not None:
                    out.update({"draft_" + k: v for k, v in
                                self._dpool.metrics().items()})
            out.update({
                "pool_resizes": self._pool_resizes,
                "pool_resize_clamps": self._pool_resize_clamps,
                "pool_floor": self._pool_floor,
                "pool_ceiling": self._pool_ceiling,
                "handoffs_out": self._handoffs_out,
                "handoffs_in": self._handoffs_in,
                "kv_spills": self._kv_spills,
                "kv_spill_bytes": self._kv_spill_bytes,
                "kv_readmits": self._kv_readmits,
                "kv_readmit_tokens_saved": self._kv_readmit_tokens_saved,
                "kv_store_bytes": (self._kv_store.occupancy_bytes
                                   if self._kv_store is not None else 0),
            })
        return out

    def _install_slot(self, slot: int, req: _Req, plen: int,
                      first: int) -> None:
        """Shared slot-state installation of every monolithic admission
        path (the brownout token clamp's one choke point there)."""
        self._slots[slot] = _Slot(
            uri=req.uri, max_new=self._brownout_mn(req.priority,
                                                   req.max_new),
            on_done=req.on_done,
            on_token=req.on_token, temperature=req.temperature,
            rng_seed=req.rng_seed, top_p=req.top_p, req=req,
            admit_seq=self._admit_seq, plen=plen)
        self._admit_seq += 1
        self._tok[slot] = first
        self._pos[slot] = plen
        self._dpos[slot] = plen
        self._done[slot] = False
        self.telemetry.req_admitted(req.uri, slot, priority=req.priority)
        self._record_token(slot, int(first))

    @staticmethod
    def _sampling(rows) -> dict:
        """``pick_next``'s sampling keywords for rows carrying
        ``temperature``/``rng_seed``/``top_p`` (requests or slots, in
        batch order; ``None`` for an empty row): none when every row is
        greedy, so greedy batches stay one argmax, and no ``top_ps``
        unless some row asks for the nucleus filter."""
        live = [r for r in rows if r is not None]
        if not any(r.temperature > 0.0 for r in live):
            return {}
        temps = np.zeros(len(rows), np.float32)
        seeds = np.zeros(len(rows), np.int64)
        topps = np.zeros(len(rows), np.float32)
        for i, r in enumerate(rows):
            if r is not None:
                temps[i] = r.temperature
                seeds[i] = r.rng_seed or 0
                topps[i] = r.top_p
        out = dict(temps=temps, seeds=seeds)
        if any(r.top_p > 0.0 for r in live):
            out["top_ps"] = topps
        return out

    def _pick_first(self, last_logits, reqs, plens) -> np.ndarray:
        """First tokens of an admission group from its prefill's
        last-position logits ``[k, V]`` (on the device): the same
        ``pick_next`` as the decode ticks, at each row's last prompt
        position ``plen - 1``; one transfer to the host for the
        group."""
        samp = {k: torch.as_tensor(v, device=last_logits.device)
                for k, v in self._sampling(reqs).items()}
        pos = torch.as_tensor(np.asarray(plens, np.int64) - 1,
                              device=last_logits.device)
        return pick_next(last_logits, pos, **samp).cpu().numpy()

    def _record_token(self, slot: int, token: int):
        """Append one generated token; finish + free the slot when done."""
        st = self._slots[slot]
        st.tokens.append(token)
        self.telemetry.req_token(st.uri, slot)
        if st.on_token is not None:
            try:
                st.on_token(st.uri, token, len(st.tokens) - 1)
            except Exception:
                logger.exception("continuous-batching on_token callback "
                                 "failed for %r", st.uri)
        done = len(st.tokens) >= st.max_new or \
            (self.eos_id is not None and token == self.eos_id)
        if not done:
            if (len(st.tokens) == 1 and st.req is not None
                    and (st.req.handoff_cb is not None
                         or st.req.park_handoff)):
                # prefill role: the first token is this engine's last;
                # export the row instead of decoding it here
                self._handoff_slot(slot, st)
            return
        out = np.full(st.max_new,
                      self.eos_id if self.eos_id is not None else 0,
                      np.int32)
        out[:len(st.tokens)] = st.tokens      # frozen tail: eos padding
        self._slots[slot] = None
        self._done[slot] = True     # terminal state until readmission
        self._free.append(slot)
        if self.paged:
            # refcounts drop + table row -> sink BEFORE the next device
            # step, so a recycled block can never see this row's writes
            self._release_slot_blocks(slot)
        self.telemetry.req_finished(st.uri, slot, len(st.tokens))
        if st.on_done is not None:
            try:
                st.on_done(st.uri, out)
            except Exception:
                logger.exception("continuous-batching on_done callback "
                                 "failed for %r", st.uri)

    @torch.no_grad()
    def step(self) -> int:
        """One engine iteration: admit joiners, then advance every
        resident by up to ``ticks_per_step`` tokens (capped by the
        largest remaining token budget among residents; a slot's
        surplus tokens are dropped host-side, and EOS mid-step freezes
        the row like generate()'s frozen tail).  Returns the number of
        active slots afterwards (0 = idle).  Runs under
        ``torch.no_grad()`` itself: grad mode is per thread, and the
        server calls this from its pump thread.  Under a mesh the
        leader's call broadcasts the queued mutations and its clock
        reading first, and every rank runs the same tick."""
        if self._leads():
            if self.n_active == 0 and not self._waiting and \
                    not self._lockstep.outbox and \
                    not self._lockstep.released:
                return 0
            return self._flush(("step", time.monotonic()))
        if self.n_active == 0 and not self._waiting:
            return 0
        if self._fault is not None:
            self._fault_tick()
        t0 = time.monotonic()
        n = self._step_impl()
        dur = time.monotonic() - t0
        samples = self._tick_samples(n)
        self.telemetry.tick(t0, dur, samples)
        if self.flight is not None:
            self._flight_record(t0, dur, samples)
        return n

    def _fault_tick(self) -> None:
        """Apply the due engine-side fault actions for this busy tick
        (``serving/fault.py``): ``freeze_tick`` sleeps here, an
        ``alloc_storm`` tick records a pool allocation failure, and
        ``raise_step`` escapes as ``InjectedFault`` out of ``step()``."""
        acts = self._fault.tick_actions(self._replica_id)
        if not acts:
            return
        freeze = acts.get("freeze_s", 0.0)
        if freeze > 0:
            time.sleep(freeze)
        if acts.get("alloc_fail") and self._pool is not None:
            with self._pool_lock:
                self._pool.alloc_failures += 1
        msg = acts.get("raise_step")
        if msg:
            from analytics_zoo_tpu_torch.serving.fault import InjectedFault
            raise InjectedFault(msg)

    def _tick_samples(self, n_active: int) -> dict:
        """Post-tick residency mix and queue/pool pressure as host ints:
        the per-tick sample row of the telemetry event log."""
        decode = sum(1 for s in self._slots
                     if s is not None and s.state == "DECODE")
        samples = {"active": n_active, "decode_rows": decode,
                   "prefill_rows": n_active - decode,
                   "queue_depth": len(self._waiting)}
        if self._pool is not None:
            with self._pool_lock:
                samples["free_blocks"] = self._pool.allocatable()
                if self._dpool is not None:
                    samples["draft_free_blocks"] = \
                        self._dpool.allocatable()
        return samples

    def _flight_record(self, ts: float, dur: float,
                       samples: dict) -> None:
        """Append one tick snapshot to the flight ring: the telemetry
        samples, the resident rows by state, the tick kind and read
        path, and the per-tick deltas of the cumulative counters
        (preemptions, chunks and budget use, speculative proposals and
        acceptances, allocation failures of both pools), in the
        reference's schema."""
        last = self._flight_last

        def delta(key: str, cur: int) -> int:
            d = cur - last[key]
            last[key] = cur
            return d

        rec = dict(samples)
        rec["seq"] = self.flight.next_seq()
        rec["ts"] = round(ts, 6)
        rec["dur_ms"] = round(dur * 1e3, 3)
        rec["kind"] = self._tick_kind
        rec["kernel"] = self.kernel if self.paged else "dense"
        rec["kv_dtype"] = self.kv_dtype
        rec["kv_bytes_per_token"] = self._kv_bytes_per_token
        rec["decode_uris"] = [s.uri for s in self._slots
                              if s is not None and s.state == "DECODE"]
        rec["prefill_uris"] = [s.uri for s in self._slots
                               if s is not None and s.state != "DECODE"]
        rec["preempted"] = delta("preempt", self._preemptions)
        rec["compiles"] = 0     # eager PyTorch compiles nothing
        if self.chunked:
            rec["budget"] = self.tick_token_budget
            rec["budget_used"] = delta("budget_tokens",
                                       self._budget_tokens_used)
            rec["chunks"] = delta("chunks", self.telemetry.c_chunks.value)
        if self.draft_model is not None:
            rec["spec_proposed"] = delta(
                "spec_proposed", self.telemetry.c_spec_proposed.value)
            rec["spec_accepted"] = delta(
                "spec_accepted", self.telemetry.c_spec_accepted.value)
        if self._pool is not None:
            with self._pool_lock:
                af = self._pool.alloc_failures
                rec["used_blocks"] = self._pool.num_referenced()
                rec["n_blocks"] = self._pool.n_blocks
                daf = 0
                if self._dpool is not None:
                    rec["draft_used_blocks"] = \
                        self._dpool.num_referenced()
                    rec["draft_n_blocks"] = self._dpool.n_blocks
                    daf = self._dpool.alloc_failures
            for key, cur in (("pool_resizes", self._pool_resizes),
                             ("handoffs_out", self._handoffs_out),
                             ("handoffs_in", self._handoffs_in),
                             ("kv_spills", self._kv_spills),
                             ("kv_readmits", self._kv_readmits)):
                rec[key] = delta(key, cur)
            fails = delta("alloc_fail", af) \
                + delta("draft_alloc_fail", daf)
            rec["alloc_failures"] = fails
            # consecutive ticks with at least one failed allocation
            self._alloc_fail_streak = \
                self._alloc_fail_streak + 1 if fails else 0
            rec["alloc_fail_streak"] = self._alloc_fail_streak
        if self._qos is not None:
            rec["qos_depths"] = {f"{c}/{t}" if t else c: n
                                 for (c, t), n in
                                 self._waiting.depths().items()}
        # brownout and deadline fields appear only once the feature is
        # live, so records of untouched engines keep their schema
        if self._brownout_enabled:
            rec["brownout_level"] = self._brownout_level
        if self._deadline_seen:
            rec["deadline_sheds"] = delta("deadline_sheds",
                                          self._deadline_sheds)
        self.flight.record(rec)

    # ---- accessors the serving layer reads ---------------------------

    @property
    def record_timings(self) -> bool:
        """Whether per-request stamps are kept for
        ``pop_request_timings`` (the histograms are always on)."""
        return self.telemetry.keep_request_stamps

    @record_timings.setter
    def record_timings(self, v: bool) -> None:
        self.telemetry.keep_request_stamps = bool(v)

    def pop_request_timings(self) -> Dict[str, dict]:
        """Drain the per-request stamps kept under ``record_timings``:
        uri -> {"arrival": t, "token_times": [...]}
        (``time.monotonic()`` seconds)."""
        return self.telemetry.pop_request_stamps()

    @property
    def alloc_fail_streak(self) -> int:
        """Consecutive ticks whose flight record saw a block-pool
        allocation failure (0 when not paged or healthy)."""
        return self._alloc_fail_streak

    @property
    def brownout_level(self) -> int:
        return self._brownout_level

    @property
    def deadline_sheds(self) -> int:
        """Requests shed at admission because their deadline had
        passed (apart from the supervisor's in-flight give-ups)."""
        return self._deadline_sheds

    def set_brownout(self, level: int, standard_max_new: int = 0) -> None:
        """The broker controller's ladder level, read by the pump at
        tick boundaries (plain int stores, any thread): level >= 1
        defers batch admission, >= 2 clamps standard ``max_new`` to
        ``standard_max_new`` at slot install, >= 3 drops speculative
        rounds (the target decodes alone and the draft's pointer goes
        stale, which costs acceptance after recovery, never tokens: the
        verify picks them), >= 4 admits interactive only.  An engine
        nobody browns out decides as one without the ladder.  Under a
        mesh the leader applies the level at its next flush, on every
        rank."""
        if self._leads():
            op = ("brownout", int(level), int(standard_max_new))
            self._lockstep.post(op, op)
            return
        self._brownout_enabled = True
        self._brownout_level = max(
            0, min(int(level), scheduler_policy.BROWNOUT_MAX_LEVEL))
        self._brownout_clamp = max(0, int(standard_max_new))

    def _brownout_mn(self, priority: str, mn: int) -> int:
        """The level-2 token clamp at slot install (a handoff adoption
        is exempt: its tokens are already in flight)."""
        if self._brownout_level < 2:
            return mn
        return scheduler_policy.brownout_max_new(
            self._brownout_level, priority, mn, self._brownout_clamp)

    def spec_acceptance(self) -> Optional[dict]:
        """The recorded speculative-acceptance distribution (exact
        counts of accepted draft tokens per row per verify round,
        0..k, and ``k``), or None without a draft model."""
        if self.draft_model is None:
            return None
        section = self.telemetry.spec_acceptance()
        section["k"] = self._spec_k
        return section

    def _step_impl(self) -> int:
        self._tick_kind = "decode"
        self._admit()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return 0
        prefilling = self.chunked and any(
            self._slots[i].state == "PREFILLING" for i in active)
        # brownout level >= 3 drops speculative rounds: a draft engine
        # falls through to the target-only ticks below, whose growth
        # still covers pos + k writes in both tenants
        spec_on = self.draft_model is not None and \
            scheduler_policy.brownout_spec_enabled(self._brownout_level)
        if spec_on:
            if prefilling:
                self._tick_kind = "spec_chunked"
                return self._spec_chunked_tick(active)
            self._tick_kind = "spec"
            if self.paged:
                # grow BOTH tenants' tables to cover the round's k+1
                # verify writes; may preempt
                active = self._ensure_blocks(active)
                if not active:
                    self._admit()   # preemptions freed blocks
                    return self.n_active
            return self._spec_tick(active)
        if prefilling:
            self._tick_kind = "chunked"
            return self._chunked_tick(active)
        # a chunked engine with no prefill in flight decodes on the
        # plain multi-tick path below
        if self.paged:
            # grow block tables for the coming step; may preempt
            active = self._ensure_blocks(active)
            if not active:
                self._admit()   # preemptions freed blocks: retry now
                return self.n_active
        self._peak_resident = max(self._peak_resident, len(active))
        n_eff = max(1, min(
            self.ticks_per_step,
            max(self._slots[i].max_new - len(self._slots[i].tokens)
                for i in active)))
        if self.draft_model is not None:
            # only with speculation browned out: single-tick steps keep
            # the writes inside the pos + k the growth granted
            n_eff = 1
        toks = self._decode_ticks(n_eff, self._sampling(self._slots))
        for i in active:
            for j in range(n_eff):
                if self._slots[i] is None:
                    break       # finished mid-step; the rest is frozen
                self._record_token(i, int(toks[j, i]))
        self._admit()       # freed slots recycle on the SAME iteration
        return self.n_active

    def _decode_call(self, tok, pos, tables):
        """One target decode step over every slot (caches updated in
        place); returns logits ``[S, V]``."""
        if self.paged:
            return self.model.decode_step_paged(
                tok, self._pk, self._pv, tables, pos, kernel=self.kernel)
        return self.model.decode_step(tok, self._ck, self._cv, pos)

    def _decode_ticks(self, n_ticks: int, sampling: dict) -> np.ndarray:
        """Advance every slot ``n_ticks`` tokens.  Arena: each row writes
        and reads its own slot; a free or finished row writes garbage at
        its frozen position, which the next occupant overwrites before
        attending it.  Paged: rows holding no blocks (free/done slots —
        their table rows are all SINK) write and read only the sink
        block's garbage, which their frozen/ignored outputs never
        surface.  PREFILLING rows ride along frozen at their fill
        frontier, where their own next chunk overwrites the write.  A
        slot that hits EOS mid-step keeps stepping, fed eos.
        ``sampling``: ``pick_next``'s keywords over the ``S`` slots.
        Returns the tokens ``[n_ticks, S]`` in emission order and leaves
        the host-side tok/pos/done advanced."""
        dev = self.device
        samp = {k: torch.as_tensor(v, device=dev)
                for k, v in sampling.items()}
        tok = torch.as_tensor(self._tok, device=dev)
        pos = torch.as_tensor(self._pos, device=dev)
        done = torch.as_tensor(self._done, device=dev)
        tables = torch.as_tensor(self._tables, device=dev) \
            if self.paged else None
        out = []
        for _ in range(n_ticks):
            logits = self._decode_call(tok, pos, tables)
            self.decode_ticks += 1
            nxt = pick_next(logits, pos, **samp)
            if self.eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, self.eos_id),
                                  nxt)
                done = done | (nxt == self.eos_id)
            pos = torch.clamp(pos + 1, max=self._L - 1)
            tok = nxt
            out.append(nxt)
        self._tok = tok.cpu().numpy()
        self._pos = pos.cpu().numpy()
        self._done = done.cpu().numpy()
        return torch.stack(out).cpu().numpy()

    # ---- chunked ticks ------------------------------------------------

    def _rows_of(self, rows) -> list:
        """The slots at ``rows``, ``None`` elsewhere (``_sampling``'s
        batch-aligned argument over all S slots)."""
        keep = set(rows)
        return [s if i in keep else None for i, s in enumerate(self._slots)]

    def _grant_rank(self, slot: int):
        """Prefill-grant sort key (``policy.grant_rank``): QoS off, the
        admission sequence number, FIFO; QoS on, the aged priority
        class first and FIFO within a class."""
        st = self._slots[slot]
        req = st.req
        if req is None:
            return scheduler_policy.grant_rank(self._qos, None, 0.0,
                                               st.admit_seq)
        return scheduler_policy.grant_rank(
            self._qos, req.priority, self._now() - req.enq_t,
            st.admit_seq)

    def _reanchor_prefill(self) -> None:
        """Re-pin every still-PREFILLING row's decode-side state after a
        device step: frozen (done), fed pad, positioned at the fill
        frontier, so the decode part of the next tick writes its dead
        K/V entry exactly where the row's own next chunk overwrites
        it."""
        for i, st in enumerate(self._slots):
            if st is not None and st.state == "PREFILLING":
                self._done[i] = True
                self._pos[i] = st.fill_pos
                self._dpos[i] = st.fill_pos
                self._tok[i] = self.pad_id

    def _plan_tick(self, active, per_row: int):
        """Bill one chunked tick's budget (``policy.plan_chunks``:
        decode rows cost ``per_row`` positions each, the rest grants
        chunks FIFO by admission), grow the paged tables (which may
        preempt, PREFILLING rows first) and count the budget use.
        Returns (decode rows, chunks) still resident, or None when
        nothing is left to run."""
        decode_rows = [i for i in active
                       if self._slots[i].state == "DECODE"]
        prefill_rows = sorted(
            (i for i in active if self._slots[i].state == "PREFILLING"),
            key=self._grant_rank)
        chunks, stalled = scheduler_policy.plan_chunks(
            self.tick_token_budget, per_row, len(decode_rows),
            [(i, self._slots[i].plen - self._slots[i].fill_pos)
             for i in prefill_rows],
            self._chunk_buckets[-1])
        if stalled:
            # budget fully consumed by decode rows: prefill waits
            self._prefill_stall_ticks += 1
        if self.paged:
            self._grow_chunk_blocks(decode_rows, chunks)  # may preempt
            decode_rows = [i for i in decode_rows
                           if self._slots[i] is not None]
            chunks = [(i, c) for i, c in chunks
                      if self._slots[i] is not None]
        if not decode_rows and not chunks:
            return None
        self._peak_resident = max(self._peak_resident, len(active))
        self._budget_ticks += 1
        self._budget_tokens_used += per_row * len(decode_rows) \
            + sum(c for _, c in chunks)
        return decode_rows, chunks

    def _chunked_tick(self, active) -> int:
        """One budget-bounded tick: every DECODE row advances one token
        (a decode over every slot, PREFILLING rows frozen) and then the
        tick's chunks land in one chunk call; a prompt's final chunk
        picks its first token."""
        plan = self._plan_tick(active, 1)
        if plan is None:
            self._admit()       # preemptions may have freed blocks
            return self.n_active
        decode_rows, chunks = plan
        toks = None
        if decode_rows:
            toks = self._decode_ticks(
                1, self._sampling(self._rows_of(decode_rows)))
        if chunks:
            # target only: a draft engine gets here with speculation
            # browned out, and its cache then goes cold, as its pointer
            self._land_chunks(chunks, with_draft=False)
        self._reanchor_prefill()
        for i in decode_rows:
            if self._slots[i] is not None:
                self._record_token(i, int(toks[0, i]))
        self._admit()       # freed slots recycle on the SAME iteration
        return self.n_active

    def _chunk_grid(self, chunks):
        """A tick's chunk grid: rows padded to a power of two, width the
        smallest chunk bucket that holds the longest chunk (padding rows
        carry the out-of-range slot S), and the read window: the paged
        narrow table width or the arena's read length."""
        k = len(chunks)
        kb = 1 << (k - 1).bit_length()
        Cb = _next_bucket(max(c for _, c in chunks), self._chunk_buckets)
        ctoks = np.full((kb, Cb), self.pad_id, np.int32)
        cpos = np.zeros(kb, np.int32)
        clens = np.ones(kb, np.int32)
        cslots = np.full(kb, self._S, np.int32)
        for j, (i, clen) in enumerate(chunks):
            st = self._slots[i]
            off = st.fill_pos - st.base
            ctoks[j, :clen] = st.full[off:off + clen]
            cpos[j] = st.fill_pos
            clens[j] = clen
            cslots[j] = i
        need = int((cpos + clens).max())
        if self.paged:
            width = self._table_width(-(-need // self._bs))
        else:
            width = next(b for b in self._read_buckets if b >= need)
        return ctoks, cpos, clens, cslots, width

    def _run_chunk(self, ctoks, cpos, clens, cslots, width,
                   with_draft: bool = True):
        """One chunk call on the grid, in the target and, with a draft
        and ``with_draft``, in the draft: paged through each tenant's
        tables sliced to ``width`` blocks (built contiguous on the
        host; padding rows all sink) with writes limited to each
        chunk's length; arena on copies of the chunk rows' first
        ``width`` positions, written back for the real rows only.
        Returns the target's last-real-position logits ``[kb, V]``."""
        dev = self.device
        toks = torch.as_tensor(ctoks, device=dev)
        pos = torch.as_tensor(cpos, device=dev)
        lens = torch.as_tensor(clens, device=dev)
        S = self._S
        real = np.nonzero(cslots < S)[0]
        if self.paged:
            tenants = [(self.model, self._pk, self._pv, self._tables,
                        self.kernel)]
            if with_draft and self.draft_model is not None:
                tenants.append((self.draft_model, self._dpk, self._dpv,
                                self._dtables, self._dkernel))
        else:
            tenants = [(self.model, self._ck, self._cv, None, None)]
            if with_draft and self.draft_model is not None:
                tenants.append((self.draft_model, self._dck, self._dcv,
                                None, None))
            read = torch.as_tensor(np.minimum(cslots, S - 1), device=dev)
            dst = torch.as_tensor(cslots[real], device=dev)
            src = torch.as_tensor(real, device=dev)
        out = None
        for model, ck, cv, tables, kern in tenants:
            if self.paged:
                ctabs = np.full((len(cslots), width), SINK_BLOCK, np.int32)
                ctabs[real] = tables[cslots[real], :width]
                logits = model.prefill_chunk_paged(
                    toks, ck, cv, torch.as_tensor(ctabs, device=dev), pos,
                    lens, kernel=kern)
            else:
                rows_k = ck[:, read, :width]
                rows_v = cv[:, read, :width]
                logits = model.prefill_chunk(toks, rows_k, rows_v, pos,
                                             lens)
                if len(real):
                    ck[:, dst, :width] = rows_k[:, src]
                    cv[:, dst, :width] = rows_v[:, src]
            if out is None:
                out = logits
        return out

    def _land_chunks(self, chunks, with_draft: bool) -> None:
        """Land a tick's chunks (both models' caches with a draft and
        ``with_draft``) in one chunk call, advance each row's fill
        frontier, publish the blocks a chunk completed, and flip each
        prompt whose last chunk landed to DECODE with its first token
        (picked at position ``plen - 1`` from the target's logits, as
        monolithic admission picks it)."""
        ctoks, cpos, clens, cslots, width = self._chunk_grid(chunks)
        t0 = time.monotonic()
        logits = self._run_chunk(ctoks, cpos, clens, cslots, width,
                                 with_draft)
        self.chunk_calls += 1
        if with_draft and self.draft_model is not None:
            self.draft_chunk_calls += 1
        rows = [self._slots[i] for i, _ in chunks]
        rows += [None] * (len(cslots) - len(rows))
        samp = {k: torch.as_tensor(v, device=logits.device)
                for k, v in self._sampling(rows).items()}
        firsts = pick_next(logits, torch.as_tensor(
            cpos + clens - 1, device=logits.device), **samp).cpu().numpy()
        # all of a tick's chunks land in the one call: they share its span
        dur = time.monotonic() - t0
        for i, clen in chunks:
            self.telemetry.events.span(
                "prefill_chunk", t0, dur, i,
                {"uri": self._slots[i].uri, "tokens": int(clen),
                 "fill_pos": int(self._slots[i].fill_pos)})
        self.telemetry.c_chunks.inc(len(chunks))
        completed: List[Tuple[int, int]] = []
        for j, (i, clen) in enumerate(chunks):
            st = self._slots[i]
            st.fill_pos += clen
            if self.paged:
                self._publish_chunk_blocks(i, st)
            if st.fill_pos >= st.plen:
                completed.append((i, int(firsts[j])))
        for i, first in completed:
            st = self._slots[i]
            st.state = "DECODE"
            st.full = st.hashes = None
            self._tok[i] = first
            self._pos[i] = st.plen
            if with_draft:
                self._dpos[i] = st.plen
            self._done[i] = False
            self._record_token(i, first)    # the request's FIRST token

    # ---- speculative rounds -------------------------------------------

    def _spec_tick(self, active) -> int:
        """One speculative round for the whole batch: every resident
        advances by its own accepted count (1..k+1 tokens).  Paged
        dispatch already grew both tenants' tables."""
        self._peak_resident = max(self._peak_resident, len(active))
        self._spec_round(active)
        self._admit()       # freed slots recycle on the SAME iteration
        return self.n_active

    def _spec_call(self, tok, pos, dpos, done, tables, dtables):
        """The spec round on the device: k+1 greedy cached draft steps
        (the extra step writes d_{k-1}'s K/V, so a full-acceptance
        round leaves the draft cache complete), one target verify of
        [tok, d_0..d_{k-1}] at pos..pos+k, the shared acceptance rule,
        and the pointer advance — which IS the rollback: rejected
        entries stay written past the new pointer, unreachable, and the
        next round overwrites them.  Returns (t ``[S, k+1]``, n_emit,
        new tok, pos, dpos, done)."""
        k = self._spec_k
        t, p, props = tok, dpos, []
        for _ in range(k + 1):
            if self.paged:
                logits = self.draft_model.decode_step_paged(
                    t, self._dpk, self._dpv, dtables, p,
                    kernel=self._dkernel)
            else:
                logits = self.draft_model.decode_step(t, self._dck,
                                                      self._dcv, p)
            t = torch.argmax(logits, dim=-1).to(torch.int32)
            props.append(t)
            # live rows stay below L-k-1; a done or free row at L-1
            # keeps writing its own last position
            p = torch.clamp(p + 1, max=self._L - 1)
        d = torch.stack(props[:k], dim=1)                   # [S, k]
        inputs = torch.cat([tok[:, None], d], dim=1)
        if self.paged:
            logits = self.model.verify_step_paged(
                inputs, self._pk, self._pv, tables, pos, kernel=self.kernel)
        else:
            logits = self.model.verify_step(inputs, self._ck, self._cv, pos)
        t, n_emit, new_tok, done = accept_proposals(
            logits, d, tok, done, k=k, eos_id=self.eos_id)
        pos = torch.clamp(pos + n_emit, max=self._L - 1)
        dpos = torch.clamp(dpos + n_emit, max=self._L - 1)
        return t, n_emit, new_tok, pos, dpos, done

    def _spec_round(self, rows) -> None:
        """Run one spec round over every slot and record each row's
        emitted tokens, per slot in order, stopping when the slot
        finishes (budget surplus dropped host-side).  PREFILLING rows
        ride along frozen (done, so they emit nothing); their k+1
        garbage writes land at or past the fill frontier, where their
        own chunks overwrite them before anything attends that far."""
        dev = self.device
        S, k = self._S, self._spec_k
        tables = dtables = None
        if self.paged:
            tables = torch.as_tensor(self._tables, device=dev)
            dtables = torch.as_tensor(self._dtables, device=dev)
        t, n_emit, tok, pos, dpos, done = self._spec_call(
            torch.as_tensor(self._tok, device=dev),
            torch.as_tensor(self._pos, device=dev),
            torch.as_tensor(self._dpos, device=dev),
            torch.as_tensor(self._done, device=dev), tables, dtables)
        # one transfer to the host for the whole round
        host = torch.cat([t.reshape(-1), n_emit, tok, pos, dpos,
                          done.to(torch.int32)]).cpu().numpy()
        toks = host[:S * (k + 1)].reshape(S, k + 1).T       # [k+1, S]
        n_emit, self._tok, self._pos, self._dpos, done = (
            host[S * (k + 1) + j * S:S * (k + 1) + (j + 1) * S].copy()
            for j in range(5))
        self._done = done.astype(bool)
        self._spec_rounds += 1
        self._spec_emitted += int(n_emit[rows].sum())
        # acceptance accounting: every live row consumed k proposals;
        # n_emit-1 of them matched (eos clipping only shortens usage)
        emitting = [i for i in rows if int(n_emit[i]) > 0]
        lens = [int(n_emit[i]) - 1 for i in emitting]
        self.telemetry.spec_round(k * len(emitting), sum(lens), lens)
        for i in rows:
            for j in range(int(n_emit[i])):
                if self._slots[i] is None:
                    break       # finished mid-round; the rest is frozen
                self._record_token(i, int(toks[j, i]))

    def _spec_chunked_tick(self, active) -> int:
        """Chunked tick with a draft model: one token budget covers both
        work kinds — each DECODE row costs k+1 verify positions, the
        rest grants prefill chunks FIFO.  A spec round for the decode
        rows, then the chunk call that lands the chunks in both
        tenants."""
        plan = self._plan_tick(active, self._spec_k + 1)
        if plan is None:
            self._admit()       # preemptions may have freed blocks
            return self.n_active
        decode_rows, chunks = plan
        if decode_rows:
            self._spec_round(decode_rows)
        # a round finishes rows but never chunk rows (PREFILLING rows
        # are frozen in it); re-filter for safety
        chunks = [(i, c) for i, c in chunks if self._slots[i] is not None]
        if chunks:
            self._land_chunks(chunks, with_draft=True)
        self._reanchor_prefill()
        self._admit()       # freed slots recycle on the SAME iteration
        return self.n_active

    # ---- cold start ---------------------------------------------------

    def _chunk_grid_shapes(self, max_chunk_rows: Optional[int] = None):
        """Every (rows, width, read window) a chunked tick can reach,
        in the reference's order: rows powers of two up to
        ``max_chunk_rows`` (default ``max_slots``), widths the chunk
        buckets, and per width the windows that can hold a chunk
        longer than the previous bucket (paged narrow-table widths or
        arena read lengths, capped at the largest prompt)."""
        S = self._S
        kmax = min(max_chunk_rows or S, S)
        kbs, kb = [], 1
        while kb < kmax:
            kbs.append(kb)
            kb *= 2
        kbs.append(kb)
        max_prompt = self.prompt_buckets[-1]
        for ci, Cb in enumerate(self._chunk_buckets):
            prev = self._chunk_buckets[ci - 1] if ci else 0
            if self.paged:
                lo = self._table_width(-(-(prev + 1) // self._bs))
                hi = self._table_width(-(-max_prompt // self._bs))
                widths = []
                v = lo
                while v <= hi:
                    widths.append(v)
                    if v >= self._M:
                        break
                    v *= 2
            else:
                widths = [b for bi, b in enumerate(self._read_buckets)
                          if b > prev
                          and (self._read_buckets[bi - 1] if bi else 0)
                          < max_prompt]
            for kb in kbs:
                for width in widths:
                    yield kb, Cb, width

    @torch.no_grad()
    def precompile_chunked(self, sampled: bool = False,
                           use_topp: bool = False,
                           max_chunk_rows: Optional[int] = None) -> int:
        """Run the chunked scheduler's whole grid of tick shapes once, so
        that serving meets no first-launch cost: every kernel the ticks
        launch is built and loaded, and each shape's split choice is
        made.  The grid is the reference's (``_chunk_grid_shapes``):
        per shape the chunk call without and with the decode before it
        (speculative engines: the two-tenant chunk call, and one spec
        round).  ``sampled``/``use_topp`` run the decode pick with the
        sampler.  Runs on the live pools and caches without changing
        what any row attends: paged calls write and read only the sink
        block, arena chunks run on copies of the rows, and arena decodes
        write every row's last position, restored after.  Returns
        the number of (program, shape) variants visited, as the
        reference counts them."""
        if not self.chunked:
            raise ValueError("precompile_chunked requires chunked=True")
        if self._leads():
            return self._flush(("precompile", sampled, use_topp,
                                max_chunk_rows))
        dev, S = self.device, self._S
        tok = torch.zeros(S, dtype=torch.int32, device=dev)
        # paged: all-sink tables at position 0; arena: position L-1
        pos = torch.full((S,), 0 if self.paged else self._L - 1,
                         dtype=torch.int32, device=dev)
        arena = [] if self.paged else [self._ck, self._cv] + (
            [] if self.draft_model is None else [self._dck, self._dcv])
        saved = [c[:, :, -1].clone() for c in arena]
        done = torch.ones(S, dtype=torch.bool, device=dev)
        sink = torch.full((S, self._M), SINK_BLOCK, dtype=torch.int32,
                          device=dev) if self.paged else None
        samp = {}
        if sampled:
            samp = dict(temps=torch.zeros(S, device=dev),
                        seeds=torch.zeros(S, dtype=torch.int64, device=dev))
            if use_topp:
                samp["top_ps"] = torch.zeros(S, device=dev)
        count = 0
        for kb, Cb, width in self._chunk_grid_shapes(max_chunk_rows):
            grid = (np.full((kb, Cb), self.pad_id, np.int32),
                    np.zeros(kb, np.int32), np.ones(kb, np.int32),
                    np.full(kb, S, np.int32), width)
            if self.draft_model is not None:
                self._run_chunk(*grid)
                count += 1
                continue
            for with_decode in (False, True):
                if with_decode:
                    pick_next(self._decode_call(tok, pos, sink), pos,
                              **samp)
                self._run_chunk(*grid)
                count += 1
        if self.draft_model is not None:
            self._spec_call(tok, pos, pos, done, sink, sink)
            count += 1
        for c, col in zip(arena, saved):
            c[:, :, -1] = col
        return count

    @torch.no_grad()
    def drain(self, max_ticks: int = 100_000) -> None:
        """Run steps until every submitted request has finished."""
        for _ in range(max_ticks):
            if self.step() == 0 and self.n_waiting == 0:
                return
        raise RuntimeError("drain did not converge")
