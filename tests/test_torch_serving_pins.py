"""The port's copies of the framework-free modules (serving, the
training path's triggers, transforms and XShards, Zouwu's preprocessing
and AutoTS, AutoML's search, the host data plane: filesystem, native
bindings, images, feature sets and readers, and the text pipeline and
``TFDataset``), pinned to their reference sources.

Each module of ``analytics_zoo_tpu_torch`` that is a copy of a module of
``analytics_zoo_tpu`` must parse to the same syntax tree as its
reference once the package is renamed (``analytics_zoo_tpu`` ->
``analytics_zoo_tpu_torch``) and every docstring is dropped, apart from
a closed list of top-level functions or methods per module that the
port replaces, and of JAX imports a copy drops (``DROPPED``).  Each
listed name must exist in both files and really differ, so the list
cannot outgrow the port.  A copy that drifts from
its reference fails here with the names that differ.  A module the port
rewrites on torch may keep a numpy host half of the reference's: those
names alone are pinned (``PARTIAL_PINS``).
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "analytics_zoo_tpu", ROOT / "analytics_zoo_tpu_torch"

# module -> the names the port replaces (and why)
PINS = {
    # jax.profiler toggles; the port drives torch.profiler
    "common/log.py": ("start_profiler_trace", "stop_profiler_trace"),
    "serving/policy.py": (),
    "serving/telemetry.py": (),
    "serving/fault.py": (),
    "serving/kv_store.py": (),
    "serving/resp.py": (),
    "serving/frontdoor.py": (),
    "serving/flight.py": (),
    # a result later than the client's socket timeout: the port's query
    # blocks in slices of half that timeout (the reference's blocks the
    # whole wait, and a timed-out read's late reply desyncs the
    # connection; tests/test_torch_queues.py)
    "serving/queues.py": ("OutputQueue.query",),
    # the config entry (a device to load onto) and the paged read's
    # default: the engine picks the CUDA kernel by shape instead of the
    # reference's CPU-safe "gather"; a tensor-parallel engine runs one
    # process a rank, so start/stop also start and end the other
    # ranks' follow loop
    "serving/server.py": ("ClusterServing.from_config",
                          "ServingConfig.engine_kernel",
                          "ClusterServing.start", "ClusterServing.stop"),
    "serving/http_frontend.py": (),
    "serving/paged_cache.py": (),
    # the bundle renderer and the simulator: standard library only
    "serving/debug.py": (),
    "serving/sim/__init__.py": (),
    "serving/sim/trace.py": (),
    "serving/sim/model.py": (),
    "serving/sim/replay.py": (),
    "serving/sim/fleet.py": (),
    "serving/sim/__main__.py": (),
    # the training path's framework-free helpers
    "learn/triggers.py": (),
    "utils/transform.py": (),
    "data/shards.py": (),
    # Zouwu and AutoML: numpy-only modules, and AutoTS on the port's
    # forecasters
    "zouwu/preprocessing.py": (),
    "zouwu/autots.py": (),
    "automl/hp.py": (),
    # distributed trials (jax.process_count, process_allgather) are not
    # ported: distributed=True raises naming ROADMAP item 6
    "automl/search.py": ("SearchEngine.__init__", "SearchEngine._nprocs",
                         "SearchEngine._run_distributed"),
    # the host data plane: the scheme-dispatch filesystem, the native
    # bindings (beside a byte-equal dataplane.cpp), images, readers
    "common/fs.py": (),
    "native/__init__.py": (),
    "data/image.py": (),
    "data/readers.py": (),
    # a "{host}" path expands to the port's one process (the reference
    # asks jax.process_index); both device_streams are the reference's
    # text, through the port's own loader.device_prefetch
    "data/feature_set.py": ("_host_path",),
    # the text pipeline and the tfpark dataset adapter: numpy only
    "data/text.py": (),
    "tfpark/tf_dataset.py": (),
}

# modules the port rewrites on torch but for a numpy host half, which
# stays the reference's: module -> the names pinned (each must parse to
# the reference's tree after the rename, docstrings dropped)
PARTIAL_PINS = {
    "models/detection.py": ("DEFAULT_ASPECTS", "ssd_anchors",
                            "_decode_boxes", "_nms", "decode_detections"),
}

# reference statements a copy leaves out: imports of JAX it does not use
DROPPED = {"data/readers.py": ("import jax",)}


def _strip_docstrings(tree: ast.Module) -> ast.Module:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant) and isinstance(
                    body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _items(src: str) -> dict:
    """name -> ast dump of every top-level statement and of every
    statement of a top-level class (``Class.name``); an import is keyed
    by what it imports, other unnamed statements by their order among
    the unnamed ones."""
    tree = _strip_docstrings(ast.parse(src))
    out, unnamed = {}, 0

    def key(node, prefix, counter):
        if isinstance(node, ast.Import):
            return prefix + "import " + ", ".join(
                a.name for a in node.names), False
        if isinstance(node, ast.ImportFrom):
            return prefix + f"from {node.module} import " + ", ".join(
                a.name for a in node.names), False
        name = getattr(node, "name", None)
        if name is None and isinstance(node, ast.Assign) and all(
                isinstance(t, ast.Name) for t in node.targets):
            name = "=".join(t.id for t in node.targets)
        if name is None and isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            name = node.target.id
        return prefix + (name or f"#{counter}"), name is None

    for node in tree.body:
        k, anon = key(node, "", unnamed)
        unnamed += anon
        if isinstance(node, ast.ClassDef):
            sub_unnamed = 0
            for sub in node.body:
                sk, sanon = key(sub, node.name + ".", sub_unnamed)
                sub_unnamed += sanon
                out[sk] = ast.dump(sub)
            node = ast.ClassDef(node.name, node.bases, node.keywords, [],
                                node.decorator_list)
        out[k] = ast.dump(node)
    return out


def _renamed_reference(rel: str) -> str:
    return re.sub(r"\banalytics_zoo_tpu\b", "analytics_zoo_tpu_torch",
                  (REF / rel).read_text())


@pytest.mark.parametrize("rel", sorted(PINS))
def test_copy_matches_reference(rel):
    ref = _items(_renamed_reference(rel))
    port = _items((PORT / rel).read_text())
    allowed = set(PINS[rel])
    assert allowed <= set(ref) and allowed <= set(port), \
        f"{rel}: listed names missing: {sorted(allowed - set(ref) & set(port))}"
    dropped = set(DROPPED.get(rel, ()))
    assert dropped <= set(ref) - set(port) and all(
        re.match(r"(import|from) jax\b", d) for d in dropped), (rel, dropped)
    missing = sorted(set(ref) - set(port) - dropped)
    extra = sorted(set(port) - set(ref))
    assert not missing and not extra, (rel, missing, extra)
    differ = sorted(k for k in ref if k not in dropped and ref[k] != port[k])
    assert differ == sorted(allowed), (
        f"{rel}: names that differ from the reference {differ}, names "
        f"allowed to {sorted(allowed)}")


@pytest.mark.parametrize("rel", sorted(PARTIAL_PINS))
def test_host_half_matches_reference(rel):
    ref = _items(_renamed_reference(rel))
    port = _items((PORT / rel).read_text())
    names = PARTIAL_PINS[rel]
    missing = [n for n in names if n not in ref or n not in port]
    assert not missing, (rel, missing)
    differ = [n for n in names if ref[n] != port[n]]
    assert not differ, (rel, differ)


def test_every_copy_has_a_port_docstring():
    """Copied modules carry a docstring of their own that names the
    reference module they copy (the paged cache was copied verbatim
    earlier, docstring included)."""
    for rel in list(PINS) + list(PARTIAL_PINS):
        if rel == "serving/paged_cache.py":
            continue
        doc = ast.get_docstring(ast.parse((PORT / rel).read_text()))
        ref_doc = ast.get_docstring(ast.parse((REF / rel).read_text()))
        assert doc and doc != ref_doc, rel
        assert f"analytics_zoo_tpu/{rel}" in doc, rel


def test_pin_detects_a_drift():
    """The comparison sees a one-token change in a body, and ignores
    docstrings."""
    src = _renamed_reference("serving/policy.py")
    assert _items(src) == _items(src.replace(
        '"""Pure scheduler policy', '"""Another docstring', 1))
    drifted = src.replace("return max(pre or rows, key=lambda r: r[2])[0]",
                          "return min(pre or rows, key=lambda r: r[2])[0]")
    assert drifted != src
    a, b = _items(src), _items(drifted)
    assert [k for k in a if a[k] != b[k]] == ["pick_victim"]


def test_native_source_is_the_reference():
    """The port builds its host data plane from the reference's C++
    source, byte for byte."""
    assert (PORT / "native" / "dataplane.cpp").read_bytes() == \
        (REF / "native" / "dataplane.cpp").read_bytes()
