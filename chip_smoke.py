#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``analytics_zoo_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100 and
the CUDA toolkit: ``python3 chip_smoke.py``.  It exits nonzero, and
prints no result, when no CUDA device is available or when any phase
fails.  Phases, in order:

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and a build of every kernel from ``ops/csrc`` (seconds and
   ``ptxas`` register/spill report).
2. Kernel against plain version on the card: the paged-attention kernel
   against ``paged_attention_ref`` on the same CUDA inputs, for f32,
   bf16 and int8 pools x (H, KH) in {(12, 12), (32, 4)} x S in
   {1, 5, 512} x full and sliced tables, with stated tolerances.
3. Engine parity: GPT-2 width at 2 layers in f32, ``kernel="fused"``
   and ``kernel="gather"`` engines on the same requests; greedy tokens
   must be identical.
4. The main path: full GPT-2 small (12 layers, random weights from a
   seed) in bf16 served by ``ContinuousEngine`` — 16 requests with
   prompts of 20-500 tokens, four sharing a 256-token prefix, 32 new
   tokens each.  Every request must come back whole, and the kernel's
   launch count must equal (prefill calls + decode ticks) x layers:
   every attention call of the run went through the kernel.
5. Kernel timings at the main path's two shapes (decode and prefill),
   with CUDA events, beside the plain version and the memory/compute
   bound; printed as one ``{"kernels": [...]}`` line.

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

from analytics_zoo_tpu_torch.models.lm import TransformerLM
from analytics_zoo_tpu_torch.ops import _build
from analytics_zoo_tpu_torch.ops import flash_attention as fa
from analytics_zoo_tpu_torch.serving.continuous import ContinuousEngine

# GPT-2 small, as analytics_zoo_tpu/net/hf_net.py builds it
GPT2 = dict(vocab_size=50257, hidden_size=768, num_heads=12,
            intermediate_size=3072, max_position=1024, ln_eps=1e-5)
KERNEL_SOURCE = "analytics_zoo_tpu_torch/ops/csrc/paged_attention.cu"
REPLACES = "analytics_zoo_tpu/ops/flash_attention.py:594"
# H100 SXM data sheet: HBM bandwidth, dense bf16 tensor and f32 rates
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version on the card.  f32 and int8 pools: the same f32
# arithmetic up to summation order.  bf16 pools: both round the
# attention weights to bf16 before p @ v, the kernel its unnormalised
# online-softmax p and the plain version the normalised weights, so
# they differ by about one bf16 ulp (2**-8) of each weight times |v|.
ATOL = {"f32": 1e-4, "int8": 1e-4, "bf16": 2e-2}
POOL_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}


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


def phase_kernel_vs_plain(dev):
    print("== phase 2: kernel vs plain version on the card")
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


def serve(model, dev, requests, **kw):
    """Serve ``requests`` [(uri, prompt)] through a fresh engine;
    returns (engine, tokens per uri, seconds, first-token latencies)."""
    eng = ContinuousEngine(model, device=dev, **kw)
    out, errors, first = {}, {}, {}
    t0 = time.monotonic()

    def on_token(uri, tok, idx):
        if idx == 0:
            first[uri] = time.monotonic() - t0

    for uri, prompt in requests:
        eng.submit(uri, prompt, lambda u, t: out.__setitem__(u, t),
                   on_error=lambda u, e: errors.__setitem__(u, e),
                   on_token=on_token)
    eng.drain()
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    if errors:
        raise RuntimeError(f"requests failed: {errors}")
    return eng, out, secs, first


def prompts(rng, lengths, shared_len=0, sharers=()):
    """Random prompts of the given lengths; those at the ``sharers``
    indices start with one common ``shared_len``-token prefix."""
    vocab = GPT2["vocab_size"]
    shared = rng.integers(0, vocab, shared_len)
    reqs = []
    for i, n in enumerate(lengths):
        p = rng.integers(0, vocab, n)
        if i in sharers:
            p[:shared_len] = shared
        reqs.append((f"req{i}", p.astype(np.int32)))
    return reqs


def phase_engine_parity(dev):
    print("== phase 3: engine parity, GPT-2 width, 2 layers, f32")
    torch.manual_seed(0)
    model = TransformerLM(**GPT2, num_layers=2, dtype=torch.float32)
    reqs = prompts(np.random.default_rng(1),
                   [80, 70, 20, 45, 130, 200, 33, 250], 64, (0, 5))
    kw = dict(max_new_tokens=16, max_slots=4,
              prompt_buckets=(32, 64, 128, 256), block_size=16)
    results = {}
    for kernel in ("fused", "gather"):
        _, results[kernel], secs, _ = serve(model, dev, reqs,
                                            kernel=kernel, **kw)
        print(f"  kernel={kernel}: {len(results[kernel])} requests in "
              f"{secs:.2f} s")
    for uri, _ in reqs:
        if not np.array_equal(results["fused"][uri],
                              results["gather"][uri]):
            raise AssertionError(
                f"{uri}: fused {results['fused'][uri]} != gather "
                f"{results['gather'][uri]}")
    print(f"  greedy tokens identical for all {len(reqs)} requests")


def phase_main_path(dev, card):
    print("== phase 4: main path, GPT-2 small (12 layers), bf16")
    torch.manual_seed(1234)
    model = TransformerLM(**GPT2, num_layers=12, dtype=torch.bfloat16)
    kw = dict(max_new_tokens=32, max_slots=8, block_size=16,
              prompt_buckets=(32, 64, 128, 256, 512))
    rng = np.random.default_rng(2)
    # warm-up: CUDA context, cuBLAS handles, the kernel's first load
    serve(model, dev, prompts(rng, [40, 300]), **kw)
    # the first admission wave takes 8 requests: one sharer goes in it
    # and three in the next, which find its prefix blocks published
    lengths = list(rng.integers(20, 501, 16))
    lengths[0], lengths[8], lengths[9], lengths[10] = 300, 420, 280, 500
    reqs = prompts(rng, lengths, 256, (0, 8, 9, 10))
    fa.paged_attention_fused.launches = 0
    eng, out, secs, first = serve(model, dev, reqs, **kw)
    launches = fa.paged_attention_fused.launches
    expected = (eng.prefill_calls + eng.decode_ticks) * model.num_layers
    if sorted(out) != sorted(u for u, _ in reqs):
        raise AssertionError(f"missing results: {sorted(out)}")
    for uri, toks in out.items():
        if toks.shape != (32,) or toks.min() < 0 \
                or toks.max() >= GPT2["vocab_size"]:
            raise AssertionError(f"{uri}: bad tokens {toks}")
    if launches == 0 or launches != expected:
        raise AssertionError(
            f"kernel launches {launches} != (prefill calls "
            f"{eng.prefill_calls} + decode ticks {eng.decode_ticks}) x "
            f"{model.num_layers} layers: the plain path ran")
    metrics = eng.cache_metrics()
    n_tok = sum(len(t) for t in out.values())
    print(f"  [{card}] {len(out)} requests x 32 tokens in {secs:.3f} s: "
          f"{n_tok / secs:.1f} tokens/s, mean time to first token "
          f"{1e3 * np.mean(list(first.values())):.1f} ms")
    print(f"  kernel launches {launches} = (prefill calls "
          f"{eng.prefill_calls} + decode ticks {eng.decode_ticks}) x 12")
    print(f"  cache_metrics: {json.dumps(metrics)}")
    if metrics["prefix_hits"] < 3 * (256 // 16):
        raise AssertionError("the shared 256-token prefix was not reused")
    check_bf16_logits(model, dev)
    return model, launches


@torch.no_grad()
def check_bf16_logits(model, dev):
    """The 12-layer bf16 model's prefill logits through the kernel
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
    ref = logits["gather"]
    err = (logits["fused"] - ref).abs().max().item()
    lim = 0.1 * ref.abs().max().item()
    print(f"  bf16 prefill logits, kernel vs plain: max_abs_err "
          f"{err:.4f} (limit {lim:.4f}), argmax "
          f"{int(logits['fused'].argmax())} vs {int(ref.argmax())}")
    if not (torch.isfinite(logits["fused"]).all() and err <= lim):
        raise AssertionError("bf16 logits disagree with the plain path")


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


def bound(q, pk, tables, pos, S):
    """Least time (ms) for one call: live K/V bytes read once plus q,
    tables and pos read and the f32 output written, over the HBM rate;
    or the multiply-adds of q.k and p.v over live positions at the
    peak rate of the operand type — whichever is larger."""
    quant = isinstance(pk, fa.QuantKV)
    kd = pk.data if quant else pk
    _, KH, _, D = kd.shape
    B, _, H, _ = q.shape
    live = sum(int(p) * S + S * (S + 1) // 2 for p in pos.tolist())
    kv_rows = sum(int(p) + S for p in pos.tolist()) * KH
    row_bytes = D * kd.element_size() + (2 if quant else 0)
    nbytes = 2 * kv_rows * row_bytes + q.numel() * q.element_size() \
        + q.numel() * 4 + tables.numel() * 4 + pos.numel() * 4
    ops = 4 * D * H * live
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[q.dtype]
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def phase_timings(dev, launches):
    print("== phase 5: kernel timings at the main path's shapes")
    rng = np.random.default_rng(5)
    entries = []
    shapes = (("decode", 8, 1, rng.integers(290, 311, 8)),
              ("prefill", 1, 512, [0]))
    for label, B, S, pos in shapes:
        # enough disjoint table sets that the K/V they read (well over
        # the 50 MB L2) come from device memory, as in serving
        live = sum(int(p) + S for p in pos) * 12 * 64 * 2 * 2
        n_sets = max(1, math.ceil(64e6 / live))
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
        bms, by = bound(q, pk, tabs[0], p, S)
        entry = {
            "name": f"paged_attention[{label}]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "shape": f"B={B} S={S} H=12 KH=12 D=64 bs=16 M=34 bf16 "
                     f"pos={int(min(pos))}-{int(max(pos))}",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "kernel_ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": by,
            # no single PyTorch call computes attention through block
            # tables, so there is no library yardstick
            "library_ms": None}
        print(f"  {entry['name']} {entry['shape']}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), "
              f"max_abs_err {err:.2e}")
        entries.append(entry)
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
    for path in paths.values():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print("  " + line.strip())
    phase_kernel_vs_plain(dev)
    phase_engine_parity(dev)
    _, launches = phase_main_path(dev, card)
    kernels = phase_timings(dev, launches)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
