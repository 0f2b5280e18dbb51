"""Hold the port's bf16 flash kernels (forward, delta pass, dq, dk/dv) to
themselves over many launches on the card.

For each shape (the main paths' training, prefill and BERT shapes, the
128-row tile edges, Tq != Tk, an odd Tq, a grid of many waves) the
kernels run once, then ``ITERS`` more times into the same outputs: every
later output must equal the first bitwise (the kernels have no atomics,
so any difference is a race), every output must be finite and within
the bf16 tolerance of the plain version (the delta pass: bitwise equal
to it), and guard zones of ``GUARD`` elements on both sides of every
output must keep their sentinel (a stray write fails).

    python3 scripts/torch_flash_stress.py [ITERS]

Needs one CUDA card; prints a line a shape and ``stress ok`` or
``stress FAIL`` last, and exits 1 on a failure.
"""
import ctypes
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from analytics_zoo_tpu_torch.ops import _build  # noqa: E402
from analytics_zoo_tpu_torch.ops import flash_attention as fa  # noqa: E402

GUARD = 4096
SENTINEL = 7.0
BF16_ATOL = 2e-2   # chip_smoke.py's FLASH_ATOL["bf16"]
# (B, Tq, Tk, H, D, causal, masked)
CASES = [
    (4, 2048, 2048, 32, 64, True, False),    # TinyLlama training
    (8, 1024, 1024, 12, 64, True, False),    # GPT-2 training
    (3, 512, 512, 12, 64, True, False),      # arena prefills
    (4, 256, 256, 12, 64, True, False),
    (1, 37, 37, 12, 64, True, False),
    (2, 300, 300, 32, 64, True, False),
    (5, 129, 129, 32, 64, True, False),
    (32, 128, 128, 12, 64, False, True),     # BERT
    (16, 384, 384, 12, 64, False, True),
    (2, 383, 383, 8, 128, True, False),      # D = 128
    (2, 129, 129, 8, 128, False, True),
    (2, 383, 129, 12, 64, True, False),      # Tq != Tk
    (2, 129, 383, 12, 64, True, True),
    (150, 129, 129, 2, 64, True, False),     # B*H = 300, many waves
    (2, 201, 201, 8, 128, True, True),       # odd Tq (Tq % 4 = 1)
]


def guarded(shape, dtype, dev):
    """A tensor of ``shape`` inside a buffer whose GUARD elements on each
    side hold SENTINEL; returns (buffer, tensor)."""
    n = math.prod(shape)
    buf = torch.full((n + 2 * GUARD,), SENTINEL, dtype=dtype, device=dev)
    return buf, buf[GUARD:GUARD + n].view(shape)


def guards_ok(buf, n):
    s = torch.tensor(SENTINEL, dtype=buf.dtype, device=buf.device)
    return bool((buf[:GUARD] == s).all()) and bool(
        (buf[GUARD + n:] == s).all())


def repeat_equal(launch, outs, iters):
    """Launch ``iters`` more times; returns the count of output elements
    that differed from the first launch's, summed on the card."""
    launch()
    first = [o.clone() for o in outs]
    diffs = torch.zeros((), dtype=torch.int64, device=outs[0].device)
    for _ in range(iters):
        launch()
        for o, f in zip(outs, first):
            bits = torch.int16 if o.element_size() == 2 else torch.int32
            diffs += (o.view(bits) != f.view(bits)).sum()
    torch.cuda.synchronize()
    return int(diffs.item()), first


def case(dev, B, Tq, Tk, H, D, causal, masked, iters):
    g = torch.Generator().manual_seed(B * 1000 + Tq + Tk + D)
    q, do = (torch.randn((B, Tq, H, D), generator=g).to(dev, torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((B, Tk, H, D), generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    mask = None
    if masked:
        mask = torch.rand((B, Tk), generator=g) > 0.3
        mask[:, 0] = True
        mask = mask.to(dev)
    scale = 1.0 / math.sqrt(D)
    lib = _build.load("flash_attention")
    ob, o = guarded((B, Tq, H, D), torch.bfloat16, dev)
    lb, lse = guarded((B * H, Tq), torch.float32, dev)
    mptr = ctypes.c_void_p(0) if mask is None else fa._ptr(mask)

    def fwd():
        rc = lib.flash_attention_fwd(
            fa._ptr(q), fa._ptr(k), fa._ptr(v), mptr, fa._ptr(o),
            fa._ptr(lse), 1, B, Tq, Tk, H, D, int(causal), scale,
            fa._stream(q))
        if rc != 0:
            raise RuntimeError(f"forward launch failed: CUDA error {rc}")

    t0 = time.monotonic()
    fwd_diffs, (o0, lse0) = repeat_equal(fwd, (o, lse), iters)
    fwd_s = time.monotonic() - t0
    ref_o, _ = fa.flash_attention_ref(q, k, v, mask, causal=causal)
    fwd_err = (o0.float() - ref_o.float()).abs().max().item()
    fwd_guards = guards_ok(ob, o.numel()) and guards_ok(lb, lse.numel())

    db, delta = guarded((B * H, Tq), torch.float32, dev)
    t0 = time.monotonic()
    delta_diffs, (delta0,) = repeat_equal(
        lambda: fa.flash_attention_bwd_delta_launch(o0, do, delta), (delta,),
        iters)
    delta_s = time.monotonic() - t0
    # the plain version sums in the kernel's order: bitwise equal
    delta_err = (delta0 - fa.flash_attention_bwd_delta(o0, do)).abs().max(
        ).item()
    delta_guards = guards_ok(db, delta.numel())

    bufs, grads = zip(*(guarded(t.shape, torch.bfloat16, dev)
                        for t in (q, k, v)))
    args = (q, k, v, mask, do, lse0, delta)

    def bwd():
        fa.flash_attention_bwd_launch("dq", *args, grads[:1], causal, scale)
        fa.flash_attention_bwd_launch("dkv", *args, grads[1:], causal,
                                      scale)

    t0 = time.monotonic()
    bwd_diffs, firsts = repeat_equal(bwd, grads, iters)
    bwd_s = time.monotonic() - t0
    refs = fa.flash_attention_bwd_ref(q, k, v, mask, o0, lse0, do,
                                      causal=causal)
    bwd_err = max((a.float() - r.float()).abs().max().item()
                  for a, r in zip(firsts, refs))
    bwd_guards = all(guards_ok(b, t.numel()) for b, t in zip(bufs, grads))
    finite = all(bool(torch.isfinite(t).all()) for t in (o0, *firsts))
    ok = (fwd_diffs == 0 and bwd_diffs == 0 and delta_diffs == 0
          and fwd_guards and bwd_guards and delta_guards and finite
          and fwd_err <= BF16_ATOL and bwd_err <= BF16_ATOL
          and delta_err == 0)
    print(f"B={B} Tq={Tq} Tk={Tk} H={H} D={D} causal={int(causal)} "
          f"mask={int(masked)} x{iters + 1}: forward {fwd_diffs} differing "
          f"elements, guards {'kept' if fwd_guards else 'WRITTEN'}, err "
          f"{fwd_err:.3e} ({fwd_s:.2f} s); delta {delta_diffs} differing, "
          f"guards {'kept' if delta_guards else 'WRITTEN'}, err "
          f"{delta_err:.1e} ({delta_s:.2f} s); dq+dk/dv {bwd_diffs} "
          f"differing, "
          f"guards {'kept' if bwd_guards else 'WRITTEN'}, err {bwd_err:.3e} "
          f"({bwd_s:.2f} s); {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_stress: no CUDA device", file=sys.stderr)
        return 2
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 3000
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    ok = all([case(dev, *c, iters) for c in CASES])
    print("stress", "ok" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
