#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``analytics_zoo_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100 and
the CUDA toolkit: ``python3 chip_smoke.py``.  It exits nonzero, and
prints no result, when no CUDA device is available or when any phase
fails.  Phases, in order:

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and a build of every kernel from ``ops/csrc``, one ``nvcc``
   per source started together (seconds and the ``ptxas`` register/spill
   report of each library).
2. Kernels against their plain versions on the card, on the same CUDA
   inputs, with stated tolerances: the paged-attention kernel against
   ``paged_attention_ref`` (f32, bf16 and int8 pools x (H, KH) in
   {(12, 12), (32, 4)} x S in {1, 5, 512} x full and sliced tables), and
   the flash-attention forward against ``flash_attention_ref`` on O and
   lse (causal or not x key mask or not, with a fully masked row x T in
   {1, 37, 512, 1000} x (H, D) in {(12, 64), (8, 128)} x f32 and bf16).
3. Engine parity at GPT-2 width, 2 layers, f32: the paged engine with
   ``kernel="fused"`` and ``"gather"``; the arena engine with
   ``use_flash=True`` and ``False``, and against the paged ``"gather"``
   engine.  Greedy tokens must be identical.
4. The paged main path: full GPT-2 small (12 layers, random weights
   from a seed) in bf16 served by ``ContinuousEngine(paged=True)`` — 16
   requests with prompts of 20-500 tokens, four sharing a 256-token
   prefix, 32 new tokens each.  Every request must come back whole, and
   the paged kernel's launch count must equal (prefill calls + decode
   ticks) x layers: every attention call of the run went through it.
5. The arena main path: the same model and request stream served by the
   default engine (the slot arena); the four sharers name a
   ``register_prefix`` id for their 256-token prefix.  Every request
   must come back whole, and the flash kernel's launch count must equal
   (prefill calls + prefix registrations) x layers.
6. Kernel timings at the main paths' shapes (paged decode and prefill;
   flash at the arena's two most frequent prefill shapes), with CUDA
   events, beside the plain version, the memory/compute bound and, for
   flash, PyTorch's ``scaled_dot_product_attention``; printed as one
   ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.models.lm import TransformerLM
from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine

# GPT-2 small, as analytics_zoo_tpu/net/hf_net.py builds it
GPT2 = dict(vocab_size=50257, hidden_size=768, num_heads=12,
            intermediate_size=3072, max_position=1024, ln_eps=1e-5)
PAGED_SOURCE = "analytics_zoo_tpu_torch/ops/csrc/paged_attention.cu"
PAGED_REPLACES = "analytics_zoo_tpu/ops/flash_attention.py:594"
FLASH_SOURCE = "analytics_zoo_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = "analytics_zoo_tpu/ops/flash_attention.py:83"
# H100 SXM data sheet: HBM bandwidth, dense bf16 tensor and f32 rates
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# paged kernel vs plain version on the card.  f32 and int8 pools: the
# same f32 arithmetic up to summation order.  bf16 pools: both round the
# attention weights to bf16 before p @ v, the kernel its unnormalised
# online-softmax p and the plain version the normalised weights, so
# they differ by about one bf16 ulp (2**-8) of each weight times |v|.
ATOL = {"f32": 1e-4, "int8": 1e-4, "bf16": 2e-2}
POOL_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}
# flash kernel vs plain version.  O: f32 up to summation order; bf16
# rounds p before p @ v relative to the running tile max (kernel) or the
# row's final max (plain), and O itself to bf16.  lse: f32 arithmetic on
# exact products in both types, so summation order only.
FLASH_ATOL = {"f32": 1e-4, "bf16": 2e-2}
LSE_ATOL = 1e-3
MAIN = dict(max_new_tokens=32, max_slots=8,
            prompt_buckets=(32, 64, 128, 256, 512))
SHARED = 256


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def attention_case(dev, kind, H, KH, S, B, pos, bs=16, M=None,
                   n_sets=1, seed=0):
    """Paged-attention inputs on ``dev``: a head-major pool holding
    ``n_sets`` disjoint table sets of B rows x M private blocks each
    (block 0 is the sink), q in the model dtype (f32 for f32 pools,
    bf16 otherwise).  Returns (q, pool_k, pool_v, [tables per set],
    pos)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    D = 64 if H == KH else 128
    pos = torch.as_tensor(pos, dtype=torch.int32)
    if M is None:
        M = (int(pos.max()) + S - 1) // bs + 1
    N = n_sets * B * M + 1

    def pool():
        x = torch.randn((N, KH, bs, D), generator=g).to(dev)
        if kind == "int8":
            return fa.QuantKV(*fa.quantize_kv(x))
        return x.to(POOL_DTYPE[kind])

    pk, pv = pool(), pool()
    qdt = torch.float32 if kind == "f32" else torch.bfloat16
    q = torch.randn((B, S, H, D), generator=g).to(dev, qdt)
    ids = 1 + torch.randperm(N - 1, generator=g).to(torch.int32)
    tables = [ids[i * B * M:(i + 1) * B * M].reshape(B, M).to(dev)
              for i in range(n_sets)]
    return q, pk, pv, tables, pos.to(dev)


def flash_case(dev, dtype, B, T, H, D, masked=False, seed=0):
    """q, k, v ``[B, T, H, D]`` on ``dev`` and, ``masked``, a random
    key mask whose last batch row masks every key."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev, dtype)
               for _ in range(3))
    mask = None
    if masked:
        mask = torch.rand((B, T), generator=g) > 0.3
        mask[0, 0] = True
        mask[-1] = False
        mask = mask.to(dev)
    return q, k, v, mask


def phase_kernel_vs_plain(dev):
    print("== phase 2: kernels vs plain versions on the card")
    print("-- paged attention")
    rng = np.random.default_rng(0)
    B, bs, M = 3, 16, 48
    for kind in ("f32", "bf16", "int8"):
        for H, KH in ((12, 12), (32, 4)):
            for S in (1, 5, 512):
                # ragged positions, row 0 at the furthest, two blocks
                # short of the full table so a sliced table is narrower
                hi = M * bs - S - 2 * bs
                pos = rng.integers(0, hi + 1, B)
                pos[0] = hi
                q, pk, pv, (tab,), p = attention_case(
                    dev, kind, H, KH, S, B, pos, bs=bs, M=M, seed=S)
                for sliced in (False, True):
                    t = tab
                    if sliced:
                        t = tab[:, :(hi + S - 1) // bs + 1].contiguous()
                    out = fa.paged_attention_fused(q, pk, pv, t, p)
                    ref = fa.paged_attention_ref(q, pk, pv, t, p)
                    torch.cuda.synchronize()
                    err = (out - ref).abs().max().item()
                    ok = bool(torch.isfinite(out).all()) and \
                        err <= ATOL[kind]
                    print(f"  pool={kind:4s} H={H:2d} KH={KH:2d} S={S:3d} "
                          f"table={'sliced' if sliced else 'full':6s} "
                          f"M={t.shape[1]:2d} max_abs_err={err:.3e} "
                          f"atol={ATOL[kind]:.0e} "
                          f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"kernel disagrees with the plain version: "
                            f"pool={kind} H={H} KH={KH} S={S} "
                            f"sliced={sliced} err={err}")
    print("-- flash attention forward (O and lse)")
    n = 0
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for H, D in ((12, 64), (8, 128)):
            for T in (1, 37, 512, 1000):
                for causal in (False, True):
                    for masked in (False, True):
                        q, k, v, mask = flash_case(dev, dtype, 2, T, H, D,
                                                   masked, seed=T + D)
                        o, lse = fa.flash_attention_fused(
                            q, k, v, mask, causal=causal)
                        ro, rlse = fa.flash_attention_ref(
                            q, k, v, mask, causal=causal)
                        torch.cuda.synchronize()
                        err = (o.float() - ro.float()).abs().max().item()
                        lerr = (lse - rlse).abs().max().item()
                        ok = (bool(torch.isfinite(o).all())
                              and err <= FLASH_ATOL[kind]
                              and lerr <= LSE_ATOL)
                        if masked:
                            # the last batch row masks every key
                            ok = ok and bool((o[-1] == 0).all()) and \
                                bool((lse[H:] == 1e30).all())
                        n += 1
                        print(f"  {kind:4s} H={H:2d} D={D:3d} T={T:4d} "
                              f"causal={int(causal)} mask={int(masked)} "
                              f"o_err={err:.3e} (atol "
                              f"{FLASH_ATOL[kind]:.0e}) lse_err="
                              f"{lerr:.3e} (atol {LSE_ATOL:.0e}) "
                              f"{'ok' if ok else 'FAIL'}")
                        if not ok:
                            raise AssertionError(
                                f"flash kernel disagrees with the plain "
                                f"version: {kind} H={H} D={D} T={T} "
                                f"causal={causal} masked={masked} "
                                f"o_err={err} lse_err={lerr}")
    print(f"  {n}/{n} flash cases agree")


def serve(model, dev, requests, shared=None, **kw):
    """Serve ``requests`` [(uri, prompt)] through a fresh engine.  With
    ``shared`` (a token array), the prefix is registered first and every
    prompt that starts with it is submitted as its suffix under the
    prefix id.  Returns (engine, tokens per uri, seconds, first-token
    latencies)."""
    eng = ContinuousEngine(model, device=dev, **kw)
    out, errors, first = {}, {}, {}
    t0 = time.monotonic()

    def on_token(uri, tok, idx):
        if idx == 0:
            first[uri] = time.monotonic() - t0

    pid = None if shared is None else eng.register_prefix(shared)
    for uri, prompt in requests:
        prefix = None
        if pid is not None and np.array_equal(prompt[:len(shared)],
                                              shared):
            prompt, prefix = prompt[len(shared):], pid
        eng.submit(uri, prompt, lambda u, t: out.__setitem__(u, t),
                   on_error=lambda u, e: errors.__setitem__(u, e),
                   on_token=on_token, prefix=prefix)
    eng.drain()
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    if errors:
        raise RuntimeError(f"requests failed: {errors}")
    return eng, out, secs, first


def prompts(rng, lengths, shared_len=0, sharers=()):
    """Random prompts of the given lengths; those at the ``sharers``
    indices start with one common ``shared_len``-token prefix.  Returns
    (requests, the shared prefix)."""
    vocab = GPT2["vocab_size"]
    shared = rng.integers(0, vocab, shared_len).astype(np.int32)
    reqs = []
    for i, n in enumerate(lengths):
        p = rng.integers(0, vocab, n)
        if i in sharers:
            p[:shared_len] = shared
        reqs.append((f"req{i}", p.astype(np.int32)))
    return reqs, shared


def main_stream():
    """The main paths' request stream, from one seed: a warm-up pair and
    16 requests of 20-500 tokens, four sharing a 256-token prefix.  The
    first admission wave takes 8 requests: one sharer goes in it and
    three in the next."""
    rng = np.random.default_rng(2)
    warm, _ = prompts(rng, [40, 300])
    lengths = list(rng.integers(20, 501, 16))
    lengths[0], lengths[8], lengths[9], lengths[10] = 300, 420, 280, 500
    reqs, shared = prompts(rng, lengths, SHARED, (0, 8, 9, 10))
    return warm, reqs, shared


def twin(model, use_flash):
    """A copy of ``model`` with the same weights and another
    ``use_flash``."""
    cfg = dict(GPT2, num_layers=model.num_layers, dtype=model.dtype)
    other = TransformerLM(**cfg, use_flash=use_flash)
    other.load_state_dict(model.state_dict())
    return other


def same_tokens(a, b, what):
    for uri in a:
        if not np.array_equal(a[uri], b[uri]):
            raise AssertionError(f"{uri}: {what}: {a[uri]} != {b[uri]}")


def phase_engine_parity(dev):
    print("== phase 3: engine parity, GPT-2 width, 2 layers, f32")
    torch.manual_seed(0)
    model = TransformerLM(**GPT2, num_layers=2, dtype=torch.float32)
    reqs, _ = prompts(np.random.default_rng(1),
                      [80, 70, 20, 45, 130, 200, 33, 250], 64, (0, 5))
    kw = dict(max_new_tokens=16, max_slots=4,
              prompt_buckets=(32, 64, 128, 256))
    results = {}
    for kernel in ("fused", "gather"):
        _, results[kernel], secs, _ = serve(
            model, dev, reqs, paged=True, block_size=16, kernel=kernel,
            **kw)
        print(f"  paged kernel={kernel}: {len(results[kernel])} requests "
              f"in {secs:.2f} s")
    same_tokens(results["fused"], results["gather"], "paged fused != gather")
    for use_flash in (True, False):
        fa.flash_attention_fused.launches = 0
        eng, results[use_flash], secs, _ = serve(
            twin(model, use_flash), dev, reqs, **kw)
        launches = fa.flash_attention_fused.launches
        want = eng.prefill_calls * model.num_layers if use_flash else 0
        print(f"  arena use_flash={use_flash}: {len(results[use_flash])} "
              f"requests in {secs:.2f} s, flash launches {launches}")
        if launches != want or (use_flash and launches == 0):
            raise AssertionError(f"flash launches {launches} != {want}")
    same_tokens(results[True], results[False],
                "arena use_flash=True != False")
    same_tokens(results[True], results["gather"],
                "arena != paged kernel=gather")
    print(f"  greedy tokens identical for all {len(reqs)} requests: "
          f"paged fused = paged gather = arena flash = arena plain")


def check_served(out, reqs):
    if sorted(out) != sorted(u for u, _ in reqs):
        raise AssertionError(f"missing results: {sorted(out)}")
    for uri, toks in out.items():
        if toks.shape != (MAIN["max_new_tokens"],) or toks.min() < 0 \
                or toks.max() >= GPT2["vocab_size"]:
            raise AssertionError(f"{uri}: bad tokens {toks}")


def report(card, eng, out, secs, first):
    n_tok = sum(len(t) for t in out.values())
    print(f"  [{card}] {len(out)} requests x {MAIN['max_new_tokens']} "
          f"tokens in {secs:.3f} s: {n_tok / secs:.1f} tokens/s, mean "
          f"time to first token {1e3 * np.mean(list(first.values())):.1f} "
          f"ms")
    print(f"  cache_metrics: {json.dumps(eng.cache_metrics())}")


def phase_paged_main_path(dev, card, model):
    print("== phase 4: paged main path, GPT-2 small (12 layers), bf16")
    kw = dict(MAIN, paged=True, block_size=16)
    warm, reqs, _ = main_stream()
    # warm-up: CUDA context, cuBLAS handles, the kernel's first load
    serve(model, dev, warm, **kw)
    fa.paged_attention_fused.launches = 0
    eng, out, secs, first = serve(model, dev, reqs, **kw)
    launches = fa.paged_attention_fused.launches
    expected = (eng.prefill_calls + eng.decode_ticks) * model.num_layers
    check_served(out, reqs)
    if launches == 0 or launches != expected:
        raise AssertionError(
            f"kernel launches {launches} != (prefill calls "
            f"{eng.prefill_calls} + decode ticks {eng.decode_ticks}) x "
            f"{model.num_layers} layers: the plain path ran")
    report(card, eng, out, secs, first)
    print(f"  paged kernel launches {launches} = (prefill calls "
          f"{eng.prefill_calls} + decode ticks {eng.decode_ticks}) x 12")
    if eng.cache_metrics()["prefix_hits"] < 3 * (SHARED // 16):
        raise AssertionError("the shared 256-token prefix was not reused")
    check_bf16_logits(model, dev)
    return launches


def phase_arena_main_path(dev, card, model):
    print("== phase 5: arena main path (the default engine), GPT-2 small "
          "(12 layers), bf16")
    warm, reqs, shared = main_stream()
    serve(model, dev, warm, **MAIN)
    fa.flash_attention_fused.launches = 0
    eng, out, secs, first = serve(model, dev, reqs, shared=shared, **MAIN)
    launches = fa.flash_attention_fused.launches
    # one prefill forward per admission bucket, one per registration
    expected = (eng.prefill_calls + 1) * model.num_layers
    check_served(out, reqs)
    if eng.cache_metrics()["mode"] != "arena":
        raise AssertionError("the default engine is not the arena")
    if launches == 0 or launches != expected:
        raise AssertionError(
            f"flash launches {launches} != (prefill calls "
            f"{eng.prefill_calls} + 1 prefix registration) x "
            f"{model.num_layers} layers: the plain path ran")
    report(card, eng, out, secs, first)
    print(f"  flash kernel launches {launches} = (prefill calls "
          f"{eng.prefill_calls} + 1 register_prefix) x 12; prefill "
          f"shapes (rows, width): {dict(eng.prefill_shapes)}; decode "
          f"ticks {eng.decode_ticks}")
    check_bf16_prefill(model, dev)
    return launches, eng.prefill_shapes


@torch.no_grad()
def check_bf16_logits(model, dev):
    """The 12-layer bf16 model's paged prefill logits through the kernel
    against the plain version: finite, and within 10% of the largest
    logit (bf16 p rounding at different points, through 12 bf16
    layers)."""
    D = model.hidden_size // model.num_heads
    shape = (model.num_layers, 40, model.kv_heads, 16, D)
    toks = torch.randint(0, GPT2["vocab_size"], (1, 512),
                         generator=torch.Generator().manual_seed(3))
    tables = torch.arange(1, 33, dtype=torch.int32)[None].to(dev)
    args = (toks.to(dev), tables, torch.zeros(1, dtype=torch.int32,
                                              device=dev),
            torch.full((1,), 512, dtype=torch.int32, device=dev))
    logits = {}
    for kernel in ("fused", "gather"):
        pk = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        pv = torch.zeros_like(pk)
        logits[kernel] = model.prefill_chunk_paged(
            args[0], pk, pv, *args[1:], kernel=kernel)
    compare_logits("paged prefill", logits["fused"], logits["gather"])


@torch.no_grad()
def check_bf16_prefill(model, dev):
    """The same check for the arena's ``prefill``: every position's
    logits with the flash kernel against plain full attention."""
    toks = torch.randint(0, GPT2["vocab_size"], (1, 512),
                         generator=torch.Generator().manual_seed(3))
    got = model.prefill(toks.to(dev))[0]
    ref = twin(model, False).to(dev).prefill(toks.to(dev))[0]
    compare_logits("arena prefill", got, ref)


def compare_logits(what, got, ref):
    err = (got - ref).abs().max().item()
    lim = 0.1 * ref.abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"  bf16 {what} logits, kernel vs plain: max_abs_err "
          f"{err:.4f} (limit {lim:.4f}), argmax agreement {agree:.4f}")
    if not (torch.isfinite(got).all() and err <= lim):
        raise AssertionError(f"bf16 {what} logits disagree with the "
                             f"plain path")


def time_ms(fn, n_sets, iters=100):
    """Mean milliseconds per call of fn(i) over ``iters`` calls that
    cycle through ``n_sets`` input sets, after a warm-up, by CUDA
    events."""
    for i in range(2 * n_sets):
        fn(i % n_sets)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def least_ms(nbytes, ops, dtype):
    """The roofline bound in ms and what sets it: bytes over the HBM
    rate, or operations over the peak rate of the operand type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def paged_bound(q, pk, tables, pos, S):
    """Least time (ms) for one paged call: live K/V bytes read once plus
    q, tables and pos read and the f32 output written; or the
    multiply-adds of q.k and p.v over live positions."""
    quant = isinstance(pk, fa.QuantKV)
    kd = pk.data if quant else pk
    _, KH, _, D = kd.shape
    B, _, H, _ = q.shape
    live = sum(int(p) * S + S * (S + 1) // 2 for p in pos.tolist())
    kv_rows = sum(int(p) + S for p in pos.tolist()) * KH
    row_bytes = D * kd.element_size() + (2 if quant else 0)
    nbytes = 2 * kv_rows * row_bytes + q.numel() * q.element_size() \
        + q.numel() * 4 + tables.numel() * 4 + pos.numel() * 4
    return least_ms(nbytes, 4 * D * H * live, q.dtype)


def flash_bound(q):
    """Least time (ms) for one causal flash call without a mask: q, k,
    v read once, o and lse written once; or the q.k and p.v
    multiply-adds (2 operations each) over the live (causal) pairs."""
    B, T, H, D = q.shape
    nbytes = 4 * q.numel() * q.element_size() + B * H * T * 4
    ops = 2 * 2 * D * B * H * T * (T + 1) // 2
    return least_ms(nbytes, ops, q.dtype)


def n_sets_for(nbytes):
    """Enough disjoint input sets (at most 64) that what a call reads
    (well over the 50 MB L2) comes from device memory."""
    return min(64, max(1, math.ceil(64e6 / nbytes)))


def phase_timings(dev, paged_launches, flash_launches, prefill_shapes):
    print("== phase 6: kernel timings at the main paths' shapes")
    rng = np.random.default_rng(5)
    entries = []
    shapes = (("decode", 8, 1, rng.integers(290, 311, 8)),
              ("prefill", 1, 512, [0]))
    for label, B, S, pos in shapes:
        n_sets = n_sets_for(sum(int(p) + S for p in pos) * 12 * 64 * 2 * 2)
        q, pk, pv, tabs, p = attention_case(
            dev, "bf16", 12, 12, S, B, pos, M=34, n_sets=n_sets, seed=7)
        err = (fa.paged_attention_fused(q, pk, pv, tabs[0], p)
               - fa.paged_attention_ref(q, pk, pv, tabs[0], p)
               ).abs().max().item()
        ms = time_ms(lambda i: fa.paged_attention_fused(q, pk, pv,
                                                        tabs[i], p), n_sets)
        plain = time_ms(lambda i: fa.paged_attention_ref(q, pk, pv,
                                                         tabs[i], p),
                        n_sets, iters=20)
        bms, by = paged_bound(q, pk, tabs[0], p, S)
        entries.append({
            "name": f"paged_attention[{label}]", "route": "cuda",
            "source": PAGED_SOURCE, "replaces": PAGED_REPLACES,
            "shape": f"B={B} S={S} H=12 KH=12 D=64 bs=16 M=34 bf16 "
                     f"pos={int(min(pos))}-{int(max(pos))}",
            "launches": paged_launches, "max_abs_err": err, "ms": ms,
            "kernel_ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by,
            # no single PyTorch call computes attention through block
            # tables, so there is no library yardstick
            "library_ms": None})
    for (B, T), calls in prefill_shapes.most_common(2):
        H, D = GPT2["num_heads"], GPT2["hidden_size"] // GPT2["num_heads"]
        n_sets = n_sets_for(3 * B * T * H * D * 2)
        sets = [flash_case(dev, torch.bfloat16, B, T, H, D, seed=11 + i)[:3]
                for i in range(n_sets)]
        q, k, v = sets[0]
        err = (fa.flash_attention_fused(q, k, v, causal=True)[0].float()
               - fa.flash_attention_ref(q, k, v, causal=True)[0].float()
               ).abs().max().item()
        ms = time_ms(lambda i: fa.flash_attention_fused(*sets[i],
                                                        causal=True),
                     n_sets)
        plain = time_ms(lambda i: fa.flash_attention_ref(*sets[i],
                                                         causal=True),
                        n_sets, iters=20)
        # the yardstick: one PyTorch call on the same inputs in its own
        # [B, H, T, D] layout (strided views, no copy); never on the path
        lib = [tuple(t.transpose(1, 2) for t in s) for s in sets]
        lib_ms = time_ms(lambda i: F.scaled_dot_product_attention(
            *lib[i], is_causal=True), n_sets)
        bms, by = flash_bound(q)
        entries.append({
            "name": f"flash_attention_fwd[B={B},T={T}]", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
            "shape": f"B={B} T={T} H={H} D={D} causal bf16 "
                     f"({calls} arena prefill calls at this shape)",
            "launches": flash_launches, "max_abs_err": err, "ms": ms,
            "kernel_ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms})
    for e in entries:
        lib = e["library_ms"]
        print(f"  {e['name']} {e['shape']}: kernel {e['ms']:.4f} ms, "
              f"plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.5f} ms "
              f"({e['bound_by']}), library "
              f"{'-' if lib is None else f'{lib:.4f} ms'}, max_abs_err "
              f"{e['max_abs_err']:.2e}")
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    # the plain versions are the reference: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print("== phase 1: build")
    t0 = time.monotonic()
    paths = _build.build_all()
    print(f"  built {sorted(paths)} in {time.monotonic() - t0:.1f} s")
    for name, path in sorted(paths.items()):
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
    phase_kernel_vs_plain(dev)
    phase_engine_parity(dev)
    torch.manual_seed(1234)
    model = TransformerLM(**GPT2, num_layers=12, dtype=torch.bfloat16)
    paged_launches = phase_paged_main_path(dev, card, model)
    flash_launches, shapes = phase_arena_main_path(dev, card, model)
    kernels = phase_timings(dev, paged_launches, flash_launches, shapes)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
