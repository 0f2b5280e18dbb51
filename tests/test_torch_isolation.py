"""The port stands alone: no JAX, flax, optax or ``analytics_zoo_tpu``
import.

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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "analytics_zoo_tpu")


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
            "analytics_zoo_tpu_torch.learn.estimator",
            "analytics_zoo_tpu_torch.net.hf_net",
            "analytics_zoo_tpu_torch.common.log",
            "analytics_zoo_tpu_torch.learn.inference_model",
            "analytics_zoo_tpu_torch.serving",
            "analytics_zoo_tpu_torch.serving.policy",
            "analytics_zoo_tpu_torch.serving.telemetry",
            "analytics_zoo_tpu_torch.serving.fault",
            "analytics_zoo_tpu_torch.serving.kv_store",
            "analytics_zoo_tpu_torch.serving.resp",
            "analytics_zoo_tpu_torch.serving.frontdoor",
            "analytics_zoo_tpu_torch.serving.flight",
            "analytics_zoo_tpu_torch.serving.queues",
            "analytics_zoo_tpu_torch.serving.server",
            "analytics_zoo_tpu_torch.serving.http_frontend",
            "analytics_zoo_tpu_torch.learn.triggers",
            "analytics_zoo_tpu_torch.utils.transform",
            "analytics_zoo_tpu_torch.data.shards",
            "analytics_zoo_tpu_torch.frames.nnframes",
            "analytics_zoo_tpu_torch.tfpark.text",
            "analytics_zoo_tpu_torch.models.layers",
            "analytics_zoo_tpu_torch.models.rnn",
            "analytics_zoo_tpu_torch.models.ncf",
            "analytics_zoo_tpu_torch.models.recommendation",
            "analytics_zoo_tpu_torch.models.forecast",
            "analytics_zoo_tpu_torch.common.context",
            "analytics_zoo_tpu_torch.zouwu",
            "analytics_zoo_tpu_torch.zouwu.preprocessing",
            "analytics_zoo_tpu_torch.zouwu.forecaster",
            "analytics_zoo_tpu_torch.zouwu.autots",
            "analytics_zoo_tpu_torch.automl",
            "analytics_zoo_tpu_torch.automl.hp",
            "analytics_zoo_tpu_torch.automl.search",
            "analytics_zoo_tpu_torch.automl.auto_estimator",
            "analytics_zoo_tpu_torch.models.image",
            "analytics_zoo_tpu_torch.zouwu.tcmf",
            "analytics_zoo_tpu_torch.common.fs",
            "analytics_zoo_tpu_torch.native",
            "analytics_zoo_tpu_torch.data.image",
            "analytics_zoo_tpu_torch.data.feature_set",
            "analytics_zoo_tpu_torch.data.readers",
            "analytics_zoo_tpu_torch.data.text",
            "analytics_zoo_tpu_torch.models.text",
            "analytics_zoo_tpu_torch.models.anomaly",
            "analytics_zoo_tpu_torch.models.seq2seq",
            "analytics_zoo_tpu_torch.models.detection",
            "analytics_zoo_tpu_torch.tfpark",
            "analytics_zoo_tpu_torch.tfpark.text.keras",
            "analytics_zoo_tpu_torch.tfpark.gan",
            "analytics_zoo_tpu_torch.tfpark.tf_dataset",
            "analytics_zoo_tpu_torch.keras",
            "analytics_zoo_tpu_torch.keras.activations",
            "analytics_zoo_tpu_torch.keras.initializers",
            "analytics_zoo_tpu_torch.keras.regularizers",
            "analytics_zoo_tpu_torch.keras.objectives",
            "analytics_zoo_tpu_torch.keras.optimizers",
            "analytics_zoo_tpu_torch.keras.engine",
            "analytics_zoo_tpu_torch.keras.layers",
            "analytics_zoo_tpu_torch.autograd",
            "analytics_zoo_tpu_torch.parallel",
            "analytics_zoo_tpu_torch.parallel.mesh",
            "analytics_zoo_tpu_torch.parallel.partition",
            "analytics_zoo_tpu_torch.parallel.data_parallel"} <= mods


def test_parallel_modules_import_no_jax_and_start_no_group():
    """The mesh layer imports torch.distributed only, and importing it
    starts no process group (a mesh is made at run time)."""
    code = (
        "import sys\n"
        "import analytics_zoo_tpu_torch.parallel as p\n"
        "import torch.distributed as dist\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + "
        f"'.') for f in {FORBIDDEN!r})]\n"
        "assert not bad, bad\n"
        "assert not dist.is_initialized()\n"
        "m = p.single_device_mesh(device='cpu')\n"
        "assert m.shape == {'dp': 1} and m.group('dp') is None\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


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
