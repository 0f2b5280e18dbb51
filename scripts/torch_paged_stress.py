"""Hold the port's paged-attention kernel to itself over many launches on
the card, with poisoned block tables.

For each shape (the main paths' paged shapes: GPT-2 and TinyLlama decode,
TinyLlama verify and a chunked tick's grid, prefill groups; at block size
16, which takes the wgmma kernel, and at 12, which the C dispatch sends
to the earlier kernels up front; one D = 128 shape) every table entry
past a row's last live page holds a poison id, -1 or one past the pool
(the engine leaves stale or sentinel ids there).  The kernel runs once,
then ``ITERS`` more times into the same output: every later output must
equal the first bitwise (the splits are merged in a fixed order, with no
atomics, so any difference is a race), the output must be finite and
within the bf16 tolerance of the plain version on the same table with
the poison replaced by a real block (a poisoned entry that were read
would show there, or fault), and guard zones of ``GUARD`` floats on both
sides of the output must keep their sentinel (a stray write fails).

    python3 scripts/torch_paged_stress.py [ITERS]

Needs one CUDA card; prints a line a shape and ``stress ok`` or
``stress FAIL`` last, and exits 1 on a failure.
"""
import ctypes
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
BF16_ATOL = 2e-2   # chip_smoke.py's ATOL["bf16"]
# (label, B, S, H, KH, D, bs, positions, table width M)
DECODE_POS = [290, 306, 297, 301, 293, 304, 299, 295]
CASES = [
    ("GPT-2 decode", 8, 1, 12, 12, 64, 16, DECODE_POS, 34),
    ("TinyLlama decode", 8, 1, 32, 4, 64, 16, DECODE_POS, 34),
    ("TinyLlama verify", 8, 5, 32, 4, 64, 16, [p + 2 for p in DECODE_POS],
     34),
    ("TinyLlama chunk grid", 4, 32, 32, 4, 64, 16, [0, 96, 301, 0], 32),
    ("GPT-2 prefill", 1, 512, 12, 12, 64, 16, [0], 34),
    ("GPT-2 prefill", 2, 256, 12, 12, 64, 16, [256, 256], 34),
    ("TinyLlama prefill", 4, 512, 32, 4, 64, 16, [0, 0, 0, 0], 34),
    ("TinyLlama decode D=128", 8, 1, 16, 2, 128, 16, DECODE_POS, 34),
    ("GPT-2 decode bs=12", 8, 1, 12, 12, 64, 12, DECODE_POS, 46),
    ("TinyLlama verify bs=12", 8, 5, 32, 4, 64, 12,
     [p + 2 for p in DECODE_POS], 46),
    ("TinyLlama prefill bs=12", 4, 512, 32, 4, 64, 12, [0, 0, 0, 0], 46),
]


def case(dev, label, B, S, H, KH, D, bs, pos, M, iters):
    g = torch.Generator().manual_seed(B * 1000 + S + H + bs)
    N = B * M + 1
    pk, pv = (torch.randn((N, KH, bs, D), generator=g).to(dev, torch.bfloat16)
              for _ in range(2))
    q = torch.randn((B, S, H, D), generator=g).to(dev, torch.bfloat16)
    tables = (1 + torch.randperm(B * M, generator=g)).to(torch.int32)
    tables = tables.reshape(B, M)
    clean = tables.clone()
    for b, p in enumerate(pos):
        live = (p + S - 1) // bs + 1
        tables[b, live:] = torch.where(torch.arange(M - live) % 2 == 0, -1,
                                       N + 1000 * (b + 1))
        clean[b, live:] = 0
    tables, clean = tables.to(dev), clean.to(dev)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    splits = fa.paged_attention_splits(True, 1, B, S, H, KH, D, bs, M,
                                       dev.index or 0)
    wgmma = fa.paged_wgmma_takes(q.dtype, pk.dtype, D, bs)
    n = B * S * H * D
    buf = torch.full((n + 2 * GUARD,), SENTINEL, device=dev)
    out = buf[GUARD:GUARD + n].view(B, S, H, D)
    ws = None if wgmma or splits == 1 else torch.empty(
        splits * B * S * H * (D + 2), device=dev)
    lib = _build.load("paged_attention")
    none = ctypes.c_void_p(0)

    def launch():
        rc = lib.paged_attention_fwd(
            fa._ptr(q), 1, fa._ptr(pk), fa._ptr(pv), none, none, 1,
            fa._ptr(tables), fa._ptr(p), fa._ptr(out),
            none if ws is None else fa._ptr(ws), splits, B, S, H, KH, D,
            bs, M, N, fa._stream(q))
        if rc != 0:
            raise RuntimeError(f"paged launch failed: CUDA error {rc}")

    t0 = time.monotonic()
    launch()
    first = out.clone()
    diffs = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(iters):
        launch()
        diffs += (out.view(torch.int32) != first.view(torch.int32)).sum()
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    diffs = int(diffs.item())
    s = torch.tensor(SENTINEL, device=dev)
    guards = bool((buf[:GUARD] == s).all()) and bool(
        (buf[GUARD + n:] == s).all())
    ref = fa.paged_attention_ref(q, pk, pv, clean, p)
    err = (first - ref).abs().max().item()
    finite = bool(torch.isfinite(first).all())
    ok = diffs == 0 and guards and finite and err <= BF16_ATOL
    print(f"{label}: B={B} S={S} H={H} KH={KH} D={D} bs={bs} M={M} "
          f"{'wgmma' if wgmma else 'earlier kernels'}, {splits} splits, "
          f"x{iters + 1}: {diffs} differing elements, guards "
          f"{'kept' if guards else 'WRITTEN'}, err {err:.3e} "
          f"({secs:.2f} s); {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_paged_stress: no CUDA device", file=sys.stderr)
        return 2
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    dev = torch.device("cuda", torch.cuda.current_device())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    ok = all([case(dev, *c, iters) for c in CASES])
    print("stress", "ok" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
