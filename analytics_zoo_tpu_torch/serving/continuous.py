"""Continuous batching for generative serving, on a paged KV cache.

The port of ``analytics_zoo_tpu/serving/continuous.py`` in its paged
greedy mode.  K/V live in one flat pool of ``block_size``-token blocks
per layer (``[n_layers, N, kv_heads, bs, D]``, head-major); each
resident holds only the blocks it has filled, through a per-slot block
table kept on the host by :class:`BlockPool`.  Full prompt blocks are
hash-indexed, so a request sharing a prompt prefix attaches to the same
physical blocks and prefills only its suffix; when the pool runs dry
the latest admission is PREEMPTED back to the queue front and
regenerates the same tokens on readmission (greedy argmax).

The device work is two methods of the model: the admission prefill of
each suffix-bucket group (``prefill_chunk_paged``) and one
``decode_step_paged`` per decode tick, ``ticks_per_step`` ticks per
:meth:`ContinuousEngine.step` in a plain Python loop.  PyTorch runs
eagerly, so nothing is compiled per shape; the pools are updated in
place where the JAX engine donates its buffers.

The other engine modes (arena, chunked prefill, speculative decoding,
QoS and brownout, handoff, elastic pools, the host KV tier, tensor
parallelism) and sampled decoding raise ``NotImplementedError`` naming
their ROADMAP item.  Telemetry and the flight recorder come later; the
engine keeps plain counters meanwhile.
"""

from __future__ import annotations

import collections
import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.learn.inference_model import (
    _next_bucket, filter_prompt_buckets)
from analytics_zoo_tpu_torch.models.lm import TransformerLM
from analytics_zoo_tpu_torch.ops.flash_attention import (KV_SCALE_DTYPE,
                                                         QuantKV)
from analytics_zoo_tpu_torch.serving import policy as scheduler_policy
from analytics_zoo_tpu_torch.serving.paged_cache import (BlockPool,
                                                         SINK_BLOCK,
                                                         block_bytes)

logger = logging.getLogger("analytics_zoo_tpu_torch")

_KV_LABELS = {torch.bfloat16: "bf16", torch.float32: "f32",
              torch.float16: "f16", torch.float64: "f64"}


class _Req(NamedTuple):
    """One waiting-queue entry."""

    uri: str
    prompt: np.ndarray
    on_done: Optional[Callable]
    on_error: Optional[Callable]
    max_new: int
    on_token: Optional[Callable] = None


@dataclass
class _Slot:
    uri: str
    max_new: int
    tokens: List[int] = field(default_factory=list)
    on_done: Optional[Callable] = None
    on_token: Optional[Callable] = None
    # the original request (requeued verbatim on preemption) and an
    # admission sequence number (the preemption victim is always the
    # LATEST admission, so preemption can never livelock)
    req: Optional[_Req] = None
    admit_seq: int = 0


def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


class ContinuousEngine:
    """Paged continuous-batching engine over one ``TransformerLM``.

    Same constructor names as the JAX engine, minus the modes not ported
    yet.  ``variables``, when given, is a ``state_dict`` (for example
    from ``models.lm.params_from_flax``) loaded into ``model`` before
    serving; ``None`` serves the model's own weights.  ``device``:
    ``cuda`` unless the caller names another; without a CUDA device
    the caller must pass ``device="cpu"``.

    ``kernel`` picks the paged-attention read: ``"fused"`` (default) is
    the CUDA kernel on a CUDA device (the plain version on the CPU),
    ``"gather"`` the plain PyTorch version everywhere.  ``kv_dtype``
    picks the pool's storage: ``None`` follows ``cache_dtype`` (itself
    defaulting to the model dtype), ``"bf16"`` forces bfloat16,
    ``"int8"`` stores quantized rows with bfloat16 scales.

    Not thread-safe by itself: ``submit`` may be called from any
    thread, but ``step``/``drain``/``abort`` must run on ONE pump
    thread.
    """

    def __init__(self, model: TransformerLM,
                 variables: Optional[Dict[str, torch.Tensor]] = None, *,
                 max_new_tokens: int, max_slots: int = 8,
                 prompt_buckets: Sequence[int] = (16, 32, 64, 128),
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 ticks_per_step: int = 1,
                 cache_dtype: Optional[torch.dtype] = None,
                 kernel: str = "fused",
                 kv_dtype: Optional[str] = None,
                 mesh=None, draft_model=None,
                 paged: bool = True, block_size: int = 16,
                 n_blocks: Optional[int] = None,
                 enable_prefix_cache: bool = True,
                 elastic_pool: bool = False,
                 kv_host_store_bytes: int = 0,
                 chunked: bool = False, qos=None,
                 device=None):
        for on, what, item in (
                (not paged, "paged=False (the slot-arena engine)", "4.4"),
                (chunked, "chunked prefill", "4.2"),
                (draft_model is not None, "speculative decoding "
                 "(draft_model)", "4.3"),
                (qos is not None, "QoS scheduling", "4.5"),
                (elastic_pool, "elastic_pool", "4.6"),
                (kv_host_store_bytes, "the host KV tier "
                 "(kv_host_store_bytes)", "4.6"),
                (mesh is not None, "tensor-parallel serving (mesh)", "6")):
            if on:
                raise _later(what, item)
        if kernel not in ("gather", "fused"):
            raise ValueError(f"kernel must be 'gather' or 'fused', got "
                             f"{kernel!r}")
        if kv_dtype not in (None, "bf16", "int8"):
            raise ValueError(f"kv_dtype must be None, 'bf16' or "
                             f"'int8', got {kv_dtype!r}")
        self.device = resolve_device(device)
        if variables is not None:
            model.load_state_dict(variables)
        self.model = model.to(self.device).eval()
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.kernel = kernel
        self.prompt_buckets = filter_prompt_buckets(
            prompt_buckets, model.max_position, max_new_tokens)
        self.max_prompt_width = self.prompt_buckets[-1]
        S = int(max_slots)
        L = self.max_prompt_width + self.max_new_tokens
        self._S, self._L = S, L
        H = model.kv_heads
        D = model.hidden_size // model.num_heads
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
        # call of these went through the selected kernel
        self.decode_ticks = 0
        self.prefill_calls = 0
        bs = int(block_size)
        if bs < 1:
            raise ValueError(f"block_size must be >= 1, got {bs}")
        M = -(-L // bs)         # logical blocks per row, ceil(L/bs)
        if self._kv_int8:
            per_block = block_bytes(model.num_layers, bs, H, D, "int8")
        else:
            per_block = 2 * model.num_layers * bs * H * D \
                * cdtype.itemsize
        if n_blocks is None:
            # arena-equivalent capacity: every slot can run to full
            # length — paged still wins whenever real traffic doesn't
            n_blocks = S * M + 1
        n_blocks = int(n_blocks)
        if n_blocks < M + 1:
            raise ValueError(
                f"n_blocks={n_blocks} cannot hold one full-length "
                f"sequence: need >= {M + 1} ({M} logical blocks of "
                f"{bs} positions + the sink block 0)")
        self._bs, self._M = bs, M
        self._pool = BlockPool(n_blocks, bs, enable_prefix_cache,
                               name="target", kv_dtype=self.kv_dtype,
                               bytes_per_block=per_block)
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
        self.ticks_per_step = max(1, int(ticks_per_step))
        # host-side per-slot state (device copies travel per step)
        self._tok = np.zeros(S, np.int32)
        self._pos = np.zeros(S, np.int32)
        self._done = np.zeros(S, bool)
        self._slots: List[Optional[_Slot]] = [None] * S
        self._free = collections.deque(range(S))
        self._lock = threading.Lock()
        self._waiting: collections.deque = collections.deque()

    @property
    def n_active(self) -> int:
        return self._S - len(self._free)

    @property
    def n_waiting(self) -> int:
        with self._lock:
            return len(self._waiting)

    def abort(self, uri: str) -> bool:
        """Drop a request nobody will collect: remove it from the
        waiting queue, or free its resident slot and blocks.  Returns
        True if the uri was found.  No callback fires."""
        with self._lock:
            for req in self._waiting:
                if req.uri == uri:
                    self._waiting.remove(req)
                    return True
        for slot, st in enumerate(self._slots):
            if st is not None and st.uri == uri:
                self._slots[slot] = None
                self._done[slot] = True     # frozen until readmission
                self._free.append(slot)
                self._release_slot_blocks(slot)
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
               on_token: Optional[Callable] = None) -> None:
        """Queue one request.  ``prompt``: 1-D int32 token array.
        ``on_done(uri, tokens)`` fires from the pump thread when the
        request finishes (tokens: ``[max_new]`` int32, eos-padded frozen
        tail); ``on_error(uri, exc)`` fires if admission fails after the
        request left the waiting queue; ``on_token(uri, token, index)``
        streams every generated token.  ``max_new`` (default: the
        engine budget) caps THIS request's tokens.  Raises on bounds
        violations."""
        if temperature > 0.0 or top_p > 0.0:
            raise _later("sampled decoding (temperature/top_p)", "4.1")
        if prefix is not None:
            raise _later("register_prefix ids", "4.1")
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got {prompt.shape}")
        n = len(prompt)
        if n < 1 or n > self.max_prompt_width:
            raise ValueError(
                f"prompt length {n} outside [1, {self.max_prompt_width}]")
        mn = self.max_new_tokens if max_new is None else int(max_new)
        if not 1 <= mn <= self.max_new_tokens:
            raise ValueError(
                f"max_new {mn} outside [1, {self.max_new_tokens}]")
        with self._lock:
            self._waiting.append(_Req(uri, prompt, on_done, on_error, mn,
                                      on_token))

    # ---- pump ---------------------------------------------------------

    def _req_error(self, uri, on_error, exc):
        if on_error is None:
            return
        try:
            on_error(uri, exc)
        except Exception:
            logger.exception("on_error callback failed for %r", uri)

    def _full_prompt(self, req: _Req) -> np.ndarray:
        """The TRUE token sequence a paged request decodes (a
        ``register_prefix`` id would expand here; prefix ids are not
        ported yet, so it is the submitted prompt)."""
        return req.prompt

    def _admit(self) -> int:
        """Paged admission: per request, match leading FULL prompt
        blocks in the chain-hash index (copy-free sharing), allocate
        private blocks for the rest, and prefill only the unshared
        suffix — grouped by suffix bucket, one device call per bucket.
        A request the pool can't hold yet requeues at the FRONT (order
        preserved) and admission stops.  The match length is capped at
        ``(plen-1)//bs`` blocks so the LAST prompt token always
        recomputes: its forward yields the first-token logits."""
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
                full = self._full_prompt(req)
                plen = len(full)
                hashes = self._pool.block_hashes(full)
                total = -(-plen // self._bs)
                matched = self._pool.lookup(hashes[:(plen - 1) // self._bs])
                need = total - len(matched)
                # +1 headroom: the first decode tokens must not
                # instantly preempt what admission just built
                cap = self._pool.n_blocks - 1
                if need + 1 > cap:
                    self._req_error(req.uri, req.on_error, ValueError(
                        f"prompt needs {need} private blocks + headroom "
                        f"but the pool holds {cap}"))
                    continue
                if self._pool.allocatable() < need + 1:
                    if self.n_active == 0 and not plans and admitted == 0:
                        # nothing in flight will ever free blocks
                        self._req_error(req.uri, req.on_error, RuntimeError(
                            f"pool dry with no residents: "
                            f"{self._pool.num_referenced()} of "
                            f"{self._pool.n_blocks} blocks are held"))
                    else:
                        blocked.append(req)
                    continue
                for b in matched:
                    self._pool.acquire(b)
                blocks = list(matched)
                for _ in range(need):
                    blocks.append(self._pool.allocate())
                plans.append((req, full, hashes, len(matched), blocks))
            if blocked:
                with self._lock:
                    for req in reversed(blocked):
                        self._waiting.appendleft(req)
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
                    for _, _, _, _, blocks in plist:
                        for b in blocks:
                            self._pool.release(b)
                    for req, _, _, _, _ in plist:
                        self._req_error(req.uri, req.on_error, e)
            if blocked:
                break
        return admitted

    @torch.no_grad()
    def _admit_paged_group(self, sb: int, plans) -> int:
        """One paged-prefill device call for every planned request
        sharing a suffix bucket.  After the call each row's full private
        prompt blocks are published in the hash index, so the NEXT
        identical prompt shares them.  (The JAX engine also pads the row
        count to a power of two to bound its compile count; eager
        PyTorch compiles nothing, so rows are not padded.)"""
        n = len(plans)
        padded = np.full((n, sb), self.pad_id, np.int32)
        lens = np.ones(n, np.int32)
        pos = np.zeros(n, np.int32)
        tabs = np.full((n, self._M), SINK_BLOCK, np.int32)
        for i, (req, full, hashes, n_match, blocks) in enumerate(plans):
            sfx = full[n_match * self._bs:]
            padded[i, :len(sfx)] = sfx
            lens[i] = len(sfx)
            pos[i] = n_match * self._bs
            tabs[i, :len(blocks)] = blocks
        dev = self.device
        last = self.model.prefill_chunk_paged(
            torch.as_tensor(padded, device=dev), self._pk, self._pv,
            torch.as_tensor(tabs, device=dev),
            torch.as_tensor(pos, device=dev),
            torch.as_tensor(lens, device=dev), kernel=self.kernel)
        self.prefill_calls += 1
        last = last.cpu().numpy()       # one D2H for the whole group
        admitted = 0
        for i, (req, full, hashes, n_match, blocks) in enumerate(plans):
            plen = len(full)
            slot = self._free.popleft()
            self._row_blocks[slot] = blocks
            self._tables[slot, :] = SINK_BLOCK
            self._tables[slot, :len(blocks)] = blocks
            # publish BEFORE install: the prefill succeeded, so the
            # blocks' content is valid for sharing
            for j in range(n_match, plen // self._bs):
                self._pool.insert(hashes[j], blocks[j])
            try:
                self._install_slot(slot, req, plen,
                                   self._pick_first(last[i]))
                admitted += 1
            except Exception as e:
                self._free.append(slot)
                self._release_slot_blocks(slot)
                self._req_error(req.uri, req.on_error, e)
        return admitted

    def _ensure_blocks(self, active) -> list:
        """Grow each resident's block table to cover the positions the
        coming step will write.  When the pool is dry, PREEMPT the
        latest admission (never the oldest — earliest requests keep
        strict forward progress, so this terminates).  Returns the
        still-active subset."""
        for i in list(active):
            st = self._slots[i]
            if st is None:
                continue
            ticks = max(1, min(self.ticks_per_step,
                               st.max_new - len(st.tokens)))
            last_write = min(int(self._pos[i]) + ticks - 1, self._L - 1)
            self._grow_row(i, last_write // self._bs + 1)
        return [i for i in active if self._slots[i] is not None]

    def _grow_row(self, i: int, need: int) -> None:
        """Grow row ``i``'s block table to ``need`` blocks, preempting
        whenever the pool is dry — including row ``i`` itself, which
        ends the loop.  (The JAX engine splits this into
        ``_grow_tenant`` per pool tenant; the draft tenant comes with
        speculative decoding.)"""
        while (self._slots[i] is not None
               and len(self._row_blocks[i]) < need):
            b = self._pool.allocate()
            if b is None:
                self._preempt(self._pick_victim())
                continue
            self._tables[i, len(self._row_blocks[i])] = b
            self._row_blocks[i].append(b)

    def _pick_victim(self) -> int:
        # every resident of this engine decodes; PREFILLING rows come
        # with chunked prefill
        return scheduler_policy.pick_victim(
            (i, "DECODE", s.admit_seq)
            for i, s in enumerate(self._slots) if s is not None)

    def _preempt(self, slot: int) -> None:
        """Evict a resident back to the WAITING queue (front, original
        request intact, partial tokens discarded) and free its blocks.
        Readmission recomputes the prompt and regenerates the same
        tokens (greedy argmax)."""
        st = self._slots[slot]
        self._slots[slot] = None
        self._done[slot] = True
        self._free.append(slot)
        self._release_slot_blocks(slot)
        self._preemptions += 1
        logger.warning("block pool dry: preempted %r (recompute on "
                       "readmission)", st.uri)
        with self._lock:
            self._waiting.appendleft(st.req)

    def _release_slot_blocks(self, slot: int) -> None:
        """Drop a finished/preempted row's block references and point
        its whole table row at the sink, so the frozen row's future
        writes can never touch a block the pool hands to someone
        else."""
        blocks = self._row_blocks[slot]
        self._row_blocks[slot] = []
        self._tables[slot, :] = SINK_BLOCK
        for b in blocks:
            self._pool.release(b)

    def cache_metrics(self) -> dict:
        """Serving-visible cache counters: cumulative ``preemptions``,
        ``peak_resident`` (running max) and the pool's counters and
        gauges (``BlockPool.metrics``)."""
        with self._lock:
            out = {"mode": "paged", "preemptions": self._preemptions,
                   "peak_resident": self._peak_resident}
        out.update(self._pool.metrics())
        return out

    def _install_slot(self, slot: int, req: _Req, plen: int,
                      first: int) -> None:
        self._slots[slot] = _Slot(
            uri=req.uri, max_new=req.max_new, on_done=req.on_done,
            on_token=req.on_token, req=req, admit_seq=self._admit_seq)
        self._admit_seq += 1
        self._tok[slot] = first
        self._pos[slot] = plen
        self._done[slot] = False
        self._record_token(slot, int(first))

    def _pick_first(self, last_logits) -> int:
        """The prefill's last-position logits (host numpy) give the
        request's first token: greedy argmax."""
        return int(np.argmax(last_logits))

    def _record_token(self, slot: int, token: int):
        """Append one generated token; finish + free the slot when done."""
        st = self._slots[slot]
        st.tokens.append(token)
        if st.on_token is not None:
            try:
                st.on_token(st.uri, token, len(st.tokens) - 1)
            except Exception:
                logger.exception("continuous-batching on_token callback "
                                 "failed for %r", st.uri)
        done = len(st.tokens) >= st.max_new or \
            (self.eos_id is not None and token == self.eos_id)
        if not done:
            return
        out = np.full(st.max_new,
                      self.eos_id if self.eos_id is not None else 0,
                      np.int32)
        out[:len(st.tokens)] = st.tokens      # frozen tail: eos padding
        self._slots[slot] = None
        self._done[slot] = True     # terminal state until readmission
        self._free.append(slot)
        # refcounts drop + table row -> sink BEFORE the next device
        # step, so a recycled block can never see this row's writes
        self._release_slot_blocks(slot)
        if st.on_done is not None:
            try:
                st.on_done(st.uri, out)
            except Exception:
                logger.exception("continuous-batching on_done callback "
                                 "failed for %r", st.uri)

    def step(self) -> int:
        """One engine iteration: admit joiners, then advance every
        resident by up to ``ticks_per_step`` tokens (capped by the
        largest remaining token budget among residents; a slot's
        surplus tokens are dropped host-side, and EOS mid-step freezes
        the row like generate()'s frozen tail).  Returns the number of
        active slots afterwards (0 = idle)."""
        if self.n_active == 0 and not self._waiting:
            return 0
        return self._step_impl()

    def _step_impl(self) -> int:
        self._admit()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return 0
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
        toks = self._decode_ticks(n_eff)            # [n_eff, S]
        for i in active:
            for j in range(n_eff):
                if self._slots[i] is None:
                    break       # finished mid-step; the rest is frozen
                self._record_token(i, int(toks[j, i]))
        self._admit()       # freed slots recycle on the SAME iteration
        return self.n_active

    @torch.no_grad()
    def _decode_ticks(self, n_ticks: int) -> np.ndarray:
        """Advance every slot ``n_ticks`` tokens against the shared
        pool.  Rows holding no blocks (free/done slots — their table
        rows are all SINK) write and read only the sink block's
        garbage, which their frozen/ignored outputs never surface.  A
        slot that hits EOS mid-step keeps stepping, fed eos.  Returns
        the tokens ``[n_ticks, S]`` in emission order and leaves the
        host-side tok/pos/done advanced."""
        dev = self.device
        tok = torch.as_tensor(self._tok, device=dev)
        pos = torch.as_tensor(self._pos, device=dev)
        done = torch.as_tensor(self._done, device=dev)
        tables = torch.as_tensor(self._tables, device=dev)
        out = []
        for _ in range(n_ticks):
            logits = self.model.decode_step_paged(
                tok, self._pk, self._pv, tables, pos, kernel=self.kernel)
            self.decode_ticks += 1
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
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

    def drain(self, max_ticks: int = 100_000) -> None:
        """Run steps until every submitted request has finished."""
        for _ in range(max_ticks):
            if self.step() == 0 and self.n_waiting == 0:
                return
        raise RuntimeError("drain did not converge")
