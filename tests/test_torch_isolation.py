"""The port stands alone: no JAX, flax or ``analytics_zoo_tpu`` import.

``analytics_zoo_tpu_torch`` starts with the name ``analytics_zoo_tpu``,
so every check matches module names exactly, or with a ``.`` after
them.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from analytics_zoo_tpu_torch.ops import flash_attention as tfa

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "analytics_zoo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "analytics_zoo_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_scan_reaches_every_port_module():
    mods = {m for _, m in _port_modules()}
    assert {"analytics_zoo_tpu_torch.parallel.ring_attention",
            "analytics_zoo_tpu_torch.models.transformer",
            "analytics_zoo_tpu_torch.models.lm",
            "analytics_zoo_tpu_torch.serving.continuous",
            "analytics_zoo_tpu_torch.ops.flash_attention",
            "analytics_zoo_tpu_torch.common.config",
            "analytics_zoo_tpu_torch.data.loader",
            "analytics_zoo_tpu_torch.learn.objectives",
            "analytics_zoo_tpu_torch.learn.metrics",
            "analytics_zoo_tpu_torch.learn.estimator"} <= mods


def test_forbidden_name_check_is_exact():
    assert _forbidden("jax.numpy") and _forbidden("analytics_zoo_tpu")
    assert _forbidden("analytics_zoo_tpu.ops.flash_attention")
    assert not _forbidden("analytics_zoo_tpu_torch.ops.flash_attention")
    assert not _forbidden("jaxtyping")


def test_no_forbidden_import_in_port_or_chip_smoke():
    files = [p for p, _ in _port_modules()] + [ROOT / "chip_smoke.py"]
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            found += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert not found, found


def test_importing_every_port_module_loads_no_jax():
    mods = [m for _, m in _port_modules()]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + "
        f"'.') for f in {FORBIDDEN!r})]\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cpu_tensor_never_launches_the_kernel():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(
        np.float32))
    pool = torch.from_numpy(rng.standard_normal((5, 2, 16, 64)).astype(
        np.float32))
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([5, 20], dtype=torch.int32)
    before = tfa.paged_attention_fused.launches
    out = tfa.paged_attention(q, pool, pool, tables, pos, kernel="fused")
    assert out.shape == (2, 1, 4, 64) and torch.isfinite(out).all()
    assert tfa.paged_attention_fused.launches == before


def test_cpu_tensor_never_launches_the_flash_kernel():
    q = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 9, 4, 64)).astype(np.float32))
    before = tfa.flash_attention_fused.launches
    with torch.no_grad():
        out = tfa.flash_attention(q, q, q, torch.ones(2, 9, dtype=bool),
                                  causal=True)
    assert out.shape == q.shape and torch.isfinite(out).all()
    # with grad: the forward and both backward kernels stay unlaunched
    qg = q.clone().requires_grad_()
    out = tfa.flash_attention(qg, qg, qg, torch.ones(2, 9, dtype=bool),
                              causal=True)
    out.sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
    assert tfa.flash_attention_fused.launches == before == 0
    assert tfa.flash_attention_bwd_fused.launches == 0
