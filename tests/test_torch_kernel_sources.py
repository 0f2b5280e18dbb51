"""The CUDA sources of the port against their Python bindings, on the CPU.

The kernels in ``analytics_zoo_tpu_torch/ops/csrc`` build only on a
machine with ``nvcc`` and a card; what binds them to Python does not.
Each library's ``extern "C"`` entry points are loaded through ctypes
with the argument types in ``_build.SIGNATURES``, so a C parameter list
that drifts from that table shows up only as a bad pointer on the card.
These tests parse each source's entry points and hold them to the table
(same names, same number of parameters, pointer/int/float kinds in the
same order), check that each source's header names the TPU kernel it
replaces, and that no source includes a PyTorch header (the build links
against no PyTorch).  It also holds ``chip_smoke.py``'s SASS checks to
the sources: every kernel they require by name must be a ``__global__``
of some ``csrc/*.cu``, so a renamed kernel fails here and not only on
the card.
"""

import ctypes
import re
import shutil
from pathlib import Path

import pytest

from analytics_zoo_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]
TPU_OPS = REPO / "analytics_zoo_tpu" / "ops" / "flash_attention.py"
# the TPU kernels (functions of analytics_zoo_tpu/ops/flash_attention.py)
# each library replaces
REPLACES = {
    "paged_attention": ("_paged_fused_kernel",),
    "flash_attention": ("_fwd_kernel",),
    "flash_attention_bwd": ("_bwd_dq_kernel", "_bwd_dkv_kernel"),
}
_KINDS = {"int": ctypes.c_int, "float": ctypes.c_float}
_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def _strip_comments(src):
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.S)
    return re.sub(r"//[^\n]*", " ", src)


def _param_kind(param):
    """The ctypes type a C parameter is bound with: c_void_p for any
    pointer, c_int for int, c_float for float."""
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    ctype = " ".join(w for w in decl.split()[:-1] if w != "const")
    if ctype not in _KINDS:
        raise ValueError(f"parameter {param!r}: no ctypes kind for "
                         f"{ctype!r}")
    return _KINDS[ctype]


def entry_points(src):
    """``{name: (ctypes kinds...)}`` of the ``extern "C" int`` functions
    of a C/CUDA source."""
    return {name: tuple(_param_kind(p) for p in params.split(","))
            for name, params in _ENTRY.findall(_strip_comments(src))}


def signature_mismatches(src, table):
    """How the entry points of ``src`` disagree with ``table`` (a
    ``_build.SIGNATURES`` entry): one line per fault, empty if none."""
    found = entry_points(src)
    faults = [f"{n}: bound but not defined" for n in table if n not in found]
    faults += [f"{n}: defined but not bound" for n in found
               if n not in table]
    for name in sorted(set(found) & set(table)):
        got, want = found[name], tuple(table[name])
        if len(got) != len(want):
            faults.append(f"{name}: {len(got)} parameters, bound with "
                          f"{len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            if g is not w:
                faults.append(f"{name}: parameter {i} is {g.__name__}, "
                              f"bound as {w.__name__}")
    return faults


def _source(name):
    return (_build.CSRC / f"{name}.cu").read_text()


def test_every_source_is_bound():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) \
        == sorted(_build.SIGNATURES) == sorted(REPLACES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_entry_points_match_signatures(name):
    assert entry_points(_source(name))
    assert signature_mismatches(_source(name),
                                _build.SIGNATURES[name]) == []


# edits of flash_attention.cu's entry point that the check must catch
_DRIFTS = {
    "parameter dropped": ("int Tk, int H, int D,", "int Tk, int H,"),
    "int became float": ("int causal,", "float causal,"),
    "float became int": ("float scale,", "int scale,"),
    "pointer became int": ("void* lse,", "int lse,"),
    "parameters swapped": ("int causal,\n                                   "
                           "float scale,",
                           "float scale, int causal,"),
    "entry point renamed": ("int flash_attention_fwd(",
                            "int flash_attention_forward("),
}


@pytest.mark.parametrize("drift", sorted(_DRIFTS))
def test_signature_check_catches_drift(drift):
    src = _source("flash_attention")
    old, new = _DRIFTS[drift]
    assert old in src
    faults = signature_mismatches(src.replace(old, new),
                                  _build.SIGNATURES["flash_attention"])
    assert faults, drift


# the same for paged_attention.cu's split-K parameters and entry point,
# and the SM count its split policy reads
_PAGED_DRIFTS = {
    "workspace dropped": ("void* out, void* workspace,", "void* out,"),
    "splits became float": ("int splits,", "float splits,"),
    "splits query renamed": ("int paged_attention_splits(",
                             "int paged_attention_split_count("),
    "SM count dropped": ("int M,\n                                      "
                         "int sms)", "int M)"),
    "pool size dropped": ("int M, int N, void* stream)",
                          "int M, void* stream)"),
}


@pytest.mark.parametrize("drift", sorted(_PAGED_DRIFTS))
def test_paged_signature_check_catches_drift(drift):
    src = _source("paged_attention")
    old, new = _PAGED_DRIFTS[drift]
    assert old in src
    faults = signature_mismatches(src.replace(old, new),
                                  _build.SIGNATURES["paged_attention"])
    assert faults, drift


@pytest.mark.parametrize("name", sorted(REPLACES))
def test_source_header_names_the_tpu_kernel(name):
    lines = _source(name).splitlines()
    header = " ".join(ln[2:] for ln in
                      lines[:next(i for i, ln in enumerate(lines)
                                  if not ln.startswith("//"))])
    assert "analytics_zoo_tpu/ops/flash_attention.py" in header
    tpu = TPU_OPS.read_text()
    for fn in REPLACES[name]:
        assert re.search(rf"\b{fn}\b", header), fn
        assert re.search(rf"^def {fn}\(", tpu, flags=re.M), fn


@pytest.mark.parametrize("path", sorted(
    p.name for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh")))
def test_no_pytorch_header(path):
    includes = re.findall(r'#\s*include\s*[<"]([^>"]+)[>"]',
                          (_build.CSRC / path).read_text())
    assert includes
    for inc in includes:
        assert not re.match(r"(torch|ATen|c10|pybind11)[/.]|Python\.h$",
                            inc), inc


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """Editing a shared ``.cuh`` names (so builds) every library anew."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.SIGNATURES}
    header = next(csrc.glob("*.cuh"))
    header.write_text(header.read_text() + "\n")
    after = {n: _build.library_path(n) for n in _build.SIGNATURES}
    assert all(before[n] != after[n] for n in before)


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(")


def global_kernels(sources):
    """Names of the ``__global__`` functions of C/CUDA ``sources``."""
    return {name for src in sources
            for name in _GLOBAL.findall(_strip_comments(src))}


def sass_names(smoke):
    """The kernel names ``chip_smoke``'s phase 1 requires in the SASS:
    every ``SASS_MUST_EXIST`` instantiation and ``SASS_REQUIRED``
    prefix, without template arguments."""
    return ({k.split("<")[0] for k in smoke.SASS_MUST_EXIST}
            | {p.split("<")[0] for p in smoke.SASS_REQUIRED})


@pytest.fixture(scope="module")
def smoke():
    import sys
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def _sources():
    return [p.read_text() for p in sorted(_build.CSRC.glob("*.cu"))]


def test_sass_checked_kernels_are_globals(smoke):
    names = sass_names(smoke)
    assert {"flash_fwd_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
            "flash_fwd_bf16_kernel", "flash_bwd_dkv_bf16_kernel",
            "flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_bf16_kernel",
            "flash_bwd_delta_kernel"} <= names
    assert sorted(names - global_kernels(_sources())) == []


# renames of a kernel that phase 1 requires, which the check must catch
_RENAMES = {
    "wgmma forward": ("flash_fwd_wgmma_kernel(", "flash_fwd_tma_kernel("),
    "wgmma dk/dv": ("flash_bwd_dkv_wgmma_kernel(",
                    "flash_bwd_dkv_hopper_kernel("),
    "mma.sync forward": ("flash_fwd_bf16_kernel(", "flash_fwd_mma_kernel("),
    "wgmma dq": ("flash_bwd_dq_wgmma_kernel(", "flash_bwd_dq_hopper_kernel("),
    "delta pass": ("flash_bwd_delta_kernel(", "flash_bwd_rowsum_kernel("),
    "wgmma paged": ("paged_attention_wgmma_kernel(",
                    "paged_attention_tma_kernel("),
}


@pytest.mark.parametrize("rename", sorted(_RENAMES))
def test_sass_name_check_catches_rename(smoke, rename):
    old, new = _RENAMES[rename]
    sources = _sources()
    assert sum(src.count(old) for src in sources) == 1
    renamed = [src.replace(old, new) for src in sources]
    assert old[:-1] in sass_names(smoke) - global_kernels(renamed)


def test_paged_wgmma_kernel_is_sass_checked(smoke):
    """Phase 1 requires HGMMA and UTMALDG in the paged wgmma kernel, at
    both head dims the C dispatch sends to it."""
    assert smoke.SASS_REQUIRED["paged_attention_wgmma_kernel<"] \
        == ("HGMMA", "UTMALDG")
    assert {"paged_attention_wgmma_kernel<64>",
            "paged_attention_wgmma_kernel<128>"} \
        <= set(smoke.SASS_MUST_EXIST)
    assert "paged_attention_wgmma_kernel" in smoke.PAGED_KERNELS


def _c_body(src, name):
    """The text of C function ``name``'s body in ``src``."""
    src = _strip_comments(src)
    start = src.index("{", re.search(rf"\b{name}\(", src).end())
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start + 1:i]
    raise ValueError(name)


def test_paged_wgmma_rule_matches_the_dispatch():
    """``paged_wgmma_takes`` (which decides whether the wrapper allocates
    a split-K workspace) names the head dims and block sizes the C
    dispatch sends to the wgmma kernel."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    src = _source("paged_attention")
    blocks = {int(x) for x in
              re.findall(r"bs == (\d+)", _c_body(src, "wg_block"))}
    dims = {int(x) for x in
            re.findall(r"D == (\d+)", _c_body(src, "use_wgmma"))}
    assert blocks == set(fa.PAGED_WGMMA_BLOCKS)
    assert dims == set(fa.PAGED_WGMMA_HEAD_DIMS)
    import torch
    bf16 = torch.bfloat16
    assert fa.paged_wgmma_takes(bf16, bf16, 64, 16)
    assert not fa.paged_wgmma_takes(torch.float32, bf16, 64, 16)
    assert not fa.paged_wgmma_takes(bf16, torch.int8, 64, 16)
    assert not fa.paged_wgmma_takes(bf16, bf16, 96, 16)
    assert not fa.paged_wgmma_takes(bf16, bf16, 64, 12)
