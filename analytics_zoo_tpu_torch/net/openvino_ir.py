"""OpenVINO IR import: the ``.xml`` + ``.bin`` inference artifact as a
torch module.

The port of ``analytics_zoo_tpu/net/openvino_ir.py``.  No OpenVINO
toolchain is involved: the ``.xml`` graph (the opset-v10+ layer, port
and edge schema) parses with the standard library's ElementTree, each
``Const`` payload is sliced out of the ``.bin`` at its ``offset`` and
``size``, and the graph runs as one ``nn.Module`` whose ``forward``
takes the IR's inputs (``input_names``) and evaluates its layers in
topological order with plain torch ops (``F.conv2d``, ``torch.matmul``,
...), with OpenVINO's NCHW semantics.  The reference leaned on XLA here
and wrote no kernel, so neither does the port.

``OpenVINONet.params`` holds the tensor ``Const`` arrays under the
reference's keys (the layer name, ``name_<id>`` on a collision) and in
the IR's own layout, so ``quantize="int8"`` (``learn/quantize.py``)
gives the reference's int8 values and scales.  ``Const`` element types
read as the reference reads them with 64-bit types off: ``f64`` as
f32, ``i64`` as int32; ``u16``/``u32``/``u64``, which torch does not
compute in, read through numpy into the next signed type that holds
their values (int32, int64, int64).  Inputs given as f64 or int64 are
taken as f32 and int32, as the reference's ``jnp.asarray`` takes them.
Shape-like inputs (a reshape target, a permutation, reduction axes, a
gather axis) must be ``Const`` and resolve when the module is built.

Curated op set, as the reference's: Parameter, Const, Result,
Convolution, GroupConvolution, MatMul, Add, Subtract, Multiply, Divide,
Maximum, Minimum, ReLU, PReLU, Sigmoid, Tanh, Clamp, Gelu, Exp, Sqrt,
Softmax, MaxPool, AvgPool, ReduceMean, Reshape, Squeeze, Unsqueeze,
Transpose, Concat, Gather, BatchNormInference.  Any other layer, an
edge that reads a layer's second output port, and a ``Gather`` with
``batch_dims != 0`` raise ``NotImplementedError`` with the reference's
words, here when the module is built.  Two things the reference
refuses are taken here: ``auto_pad`` ``valid``/``same_upper``/
``same_lower`` on convolutions and pools, and ``rounding_type="ceil"``
on pools (the reference's window sums over explicit pads, with the
ragged last window's divisor as OpenVINO defines it).

Precision: f32 convolutions run in full f32 on the card (cuDNN's TF32
flag, which is the process's, off while a forward runs and restored
after), and matmuls at the process's own setting, full f32 by default;
so an IR meets the same f32 tolerance on the card as on the CPU.

Forward-only by design (an IR is an inference artifact).
"""

from __future__ import annotations

import contextlib
import heapq
import math
import os
import threading
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# element type -> (numpy type of the payload, torch dtype it runs as)
_ELEMENT_TYPES = {
    "f32": (np.float32, torch.float32), "f16": (np.float16, torch.float16),
    "f64": (np.float64, torch.float32), "i64": (np.int64, torch.int32),
    "i32": (np.int32, torch.int32), "i16": (np.int16, torch.int16),
    "i8": (np.int8, torch.int8), "u64": (np.uint64, torch.int64),
    "u32": (np.uint32, torch.int64), "u16": (np.uint16, torch.int32),
    "u8": (np.uint8, torch.uint8), "boolean": (np.bool_, torch.bool),
}

# ops whose listed input positions are SHAPE-LIKE: their producers must
# be Const and are resolved at build time
_STATIC_INPUTS = {
    "Reshape": (1,), "Transpose": (1,), "Squeeze": (1,),
    "Unsqueeze": (1,), "ReduceMean": (1,), "Gather": (2,),
}

_UNARY = {"ReLU": torch.relu, "Relu": torch.relu, "Sigmoid": torch.sigmoid,
          "Tanh": torch.tanh, "Exp": torch.exp, "Sqrt": torch.sqrt}
_BINARY = {"Add": torch.add, "Subtract": torch.sub, "Multiply": torch.mul,
           "Divide": torch.div, "Maximum": torch.maximum,
           "Minimum": torch.minimum}
_SUPPORTED = frozenset(_UNARY) | frozenset(_BINARY) | {
    "Parameter", "Const", "Result", "Gelu", "Clamp", "PReLU", "MatMul",
    "Softmax", "Convolution", "GroupConvolution", "MaxPool", "AvgPool",
    "ReduceMean", "Reshape", "Squeeze", "Unsqueeze", "Transpose", "Concat",
    "Gather", "BatchNormInference"}


def _ints(s: str) -> Tuple[int, ...]:
    s = (s or "").strip()
    return tuple(int(v) for v in s.split(",")) if s else ()


class _Layer:
    def __init__(self, el):
        self.id = el.get("id")
        self.type = el.get("type")
        self.name = el.get("name") or f"layer_{self.id}"
        d = el.find("data")
        self.attrs = dict(d.attrib) if d is not None else {}
        self.in_ports: List[str] = []
        self.out_ports: List[str] = []
        inp = el.find("input")
        if inp is not None:
            self.in_ports = [p.get("id") for p in inp.findall("port")]
        out = el.find("output")
        if out is not None:
            self.out_ports = [p.get("id") for p in out.findall("port")]


def _parse_ir(xml_path: str):
    root = ET.parse(xml_path).getroot()
    layers = {}
    order = []
    for el in root.find("layers").findall("layer"):
        ly = _Layer(el)
        layers[ly.id] = ly
        order.append(ly.id)
    producer: Dict[Tuple[str, str], Tuple[str, str]] = {}
    edges = root.find("edges")
    if edges is not None:
        for e in edges.findall("edge"):
            producer[(e.get("to-layer"), e.get("to-port"))] = (
                e.get("from-layer"), e.get("from-port"))
    return layers, order, producer


def _read_const(ly: _Layer, blob: bytes) -> np.ndarray:
    """The payload as the numpy type it runs as (see the module
    docstring)."""
    src, dst = _ELEMENT_TYPES[ly.attrs["element_type"]]
    shape = _ints(ly.attrs.get("shape", ""))
    off = int(ly.attrs["offset"])
    size = int(ly.attrs["size"])
    arr = np.frombuffer(blob[off:off + size], dtype=src)
    arr = arr.reshape(shape) if shape else arr.reshape(())
    return arr.astype(torch.empty((), dtype=dst).numpy().dtype)


def _topological(order: List[str], layers, producer) -> List[str]:
    """``order`` (the XML's) re-sorted so that each layer follows the
    layers it reads; a layer keeps its XML place where it can."""
    place = {lid: i for i, lid in enumerate(order)}
    waits = {lid: 0 for lid in order}
    readers: Dict[str, List[str]] = {lid: [] for lid in order}
    for lid in order:
        for src in {producer[(lid, p)][0] for p in layers[lid].in_ports
                    if (lid, p) in producer}:
            waits[lid] += 1
            readers[src].append(lid)
    ready = [place[lid] for lid in order if waits[lid] == 0]
    heapq.heapify(ready)
    out = []
    while ready:
        lid = order[heapq.heappop(ready)]
        out.append(lid)
        for r in readers[lid]:
            waits[r] -= 1
            if waits[r] == 0:
                heapq.heappush(ready, place[r])
    if len(out) < len(order):
        raise ValueError("the IR's edges form a cycle")
    return out


def _resolve_pads(ly: _Layer, spatial: Sequence[int],
                  kernel: Sequence[int], strides: Sequence[int],
                  dilations: Sequence[int], ceil: bool):
    """(pads_begin, pads_end) of a convolution or pool over ``spatial``,
    honouring ``auto_pad``; a ceil-rounded pool's ragged last window
    adds to the end pads (``extra``, returned apart: a window may
    read it but does not count it)."""
    ap = ly.attrs.get("auto_pad", "explicit").lower()
    n = len(spatial)
    if ap in ("explicit", "notset"):
        pb = _ints(ly.attrs.get("pads_begin", ",".join("0" * n)))
        pe = _ints(ly.attrs.get("pads_end", ",".join("0" * n)))
    elif ap == "valid":
        pb = pe = (0,) * n
    elif ap in ("same_upper", "same_lower"):
        pb, pe = [], []
        for size, k, s, d in zip(spatial, kernel, strides, dilations):
            total = max((-(-size // s) - 1) * s + (k - 1) * d + 1 - size, 0)
            small, large = total // 2, total - total // 2
            pb.append(small if ap == "same_upper" else large)
            pe.append(large if ap == "same_upper" else small)
        return tuple(pb), tuple(pe), (0,) * n
    else:
        raise NotImplementedError(
            f"{ly.type} '{ly.name}': auto_pad={ap!r} is not supported")
    extra = [0] * n
    if ceil:
        for i, (size, k, s) in enumerate(zip(spatial, kernel, strides)):
            span = size + pb[i] + pe[i] - k
            out = -(-span // s) + 1
            extra[i] = max((out - 1) * s + k - (size + pb[i] + pe[i]), 0)
    return tuple(pb), tuple(pe), tuple(extra)


def _torch_pads(pb, pe) -> List[int]:
    """``F.pad``'s order: last spatial dim first, (begin, end) each."""
    out = []
    for b, e in zip(reversed(pb), reversed(pe)):
        out += [b, e]
    return out


def _window_sum(x: torch.Tensor, kernel, strides) -> torch.Tensor:
    """Sum over each window (no padding), any of 1-3 spatial dims."""
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1,) + tuple(kernel),
                            (1,) + tuple(strides),
                            divisor_override=1).squeeze(-2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, tuple(kernel), tuple(strides), divisor_override=1)


def _pool(x, kernel, strides, pads_b, pads_e, extra, kind, exclude_pad):
    """NCHW pooling with explicit pads: the reference's ``_pool`` term
    for term (max over ``-inf`` pads; the window sum in f32 over zero
    pads, over the count of real elements under ``exclude_pad``, else
    over the window's extent within the pads), and ``extra`` positions
    past the end pads that a ceil-rounded last window reads but never
    counts."""
    pads = _torch_pads(pads_b, tuple(e + x_ for e, x_ in zip(pads_e, extra)))
    if kind == "max":
        fill = -math.inf if x.dtype.is_floating_point else \
            torch.iinfo(x.dtype).min
        xp = F.pad(x, pads, value=fill)
        pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[len(kernel) - 1]
        return pool(xp, tuple(kernel), tuple(strides))
    s = _window_sum(F.pad(x.float(), pads), kernel, strides)
    # 1 where a position counts: real elements, and the pads unless
    # they are excluded; never the ceil rounding's extra positions
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), device=x.device)
    inner = _torch_pads(pads_b, pads_e)
    mask = F.pad(ones, inner, value=0.0 if exclude_pad else 1.0)
    cnt = _window_sum(F.pad(mask, _torch_pads((0,) * len(extra), extra)),
                      kernel, strides)
    if exclude_pad:
        return (s / torch.clamp(cnt, min=1.0)).to(x.dtype)
    return (s / cnt).to(x.dtype)


def _take(data: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.take``: indices in [-n, n) wrap, others read as NaN (the
    type's lowest value for a signed int, highest for an unsigned one,
    True for bool)."""
    axis = axis % data.dim()
    n = data.shape[axis]
    idx = idx.long()
    valid = (idx >= -n) & (idx < n)
    safe = torch.where(valid, torch.where(idx < 0, idx + n, idx), 0)
    out = torch.index_select(data, axis, safe.reshape(-1)).reshape(
        data.shape[:axis] + idx.shape + data.shape[axis + 1:])
    if bool(valid.all()):
        return out
    if data.dtype.is_floating_point:
        fill = math.nan
    elif data.dtype == torch.bool:
        fill = True
    elif data.dtype == torch.uint8:
        fill = 255
    else:
        fill = torch.iinfo(data.dtype).min
    keep = valid.reshape((1,) * axis + tuple(idx.shape)
                         + (1,) * (data.dim() - axis - 1))
    return torch.where(keep, out, torch.full_like(out, fill))


_PRECISION_LOCK = threading.Lock()


@contextlib.contextmanager
def _full_f32(device):
    """On a CUDA device, cuDNN's TF32 off while the block runs (f32
    convolutions in full f32) and back on after, if it was on; one block
    at a time, so two forwards cannot leave it off.  The flag is the
    process's: while a forward runs, another thread's cuDNN convolutions
    run without TF32 too, and a change another thread makes to it then
    is undone.  Matmuls follow the process's own setting, which is full
    f32 unless its owner chose TF32 (``torch.backends.cuda.matmul``)."""
    if device is None or device.type != "cuda":
        yield
        return
    with _PRECISION_LOCK:
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = tf32


def _as_input(x, device) -> torch.Tensor:
    t = torch.as_tensor(x)
    if t.dtype == torch.float64:
        t = t.float()
    elif t.dtype == torch.int64:
        t = t.int()
    return t.to(device) if device is not None else t


class OpenVINONet(nn.Module):
    """An OpenVINO IR as a module: ``net(*inputs)`` runs the graph on the
    module's device and returns its one output (a tuple for several).

        net = OpenVINONet.from_ir("/models/m.xml")
        y = net(x)
        InferenceModel().load_openvino("/models/m.xml", quantize="int8")

    ``params`` maps the reference's keys to the tensor ``Const``
    arrays; ``forward(..., params=...)`` runs on other values for them
    (the quantized path's dequantized weights)."""

    def __init__(self, layers, order, producer, consts, pnames, static_vals,
                 inputs, results):
        super().__init__()
        self._layers, self._order, self._producer = layers, order, producer
        self._pnames = pnames               # layer id -> params key
        self._static = static_vals          # (layer id, slot) -> numpy
        self._inputs, self._results = inputs, results
        self._keys = list(consts)
        for i, key in enumerate(self._keys):
            self.register_buffer(f"const{i}", torch.from_numpy(consts[key]))
        self.input_names = [layers[i].name for i in inputs]
        self.output_names = [layers[i].name for i in results]

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, f"const{i}")
                for i, k in enumerate(self._keys)}

    def release(self, keys) -> None:
        """Drop the module's own copies of ``keys`` (a caller that keeps
        them elsewhere passes them to ``forward``)."""
        for i, k in enumerate(self._keys):
            if k in keys:
                setattr(self, f"const{i}", torch.empty(
                    0, dtype=getattr(self, f"const{i}").dtype,
                    device=getattr(self, f"const{i}").device))

    # -- importer --------------------------------------------------------
    @staticmethod
    def from_ir(xml_path: str,
                bin_path: Optional[str] = None) -> "OpenVINONet":
        if bin_path is None:
            bin_path = os.path.splitext(xml_path)[0] + ".bin"
        with open(bin_path, "rb") as f:
            blob = f.read()
        layers, order, producer = _parse_ir(xml_path)

        # only out_ports[0] of each layer is computed: an edge reading
        # any other output port (e.g. MaxPool-8's indices) fails here
        for (dst, _), (src, src_port) in producer.items():
            src_ly = layers.get(src)
            if src_ly is None or not src_ly.out_ports:
                continue
            if src_port != src_ly.out_ports[0]:
                dst_ly = layers.get(dst)
                dst_name = dst_ly.name if dst_ly is not None else dst
                raise NotImplementedError(
                    f"{src_ly.type} '{src_ly.name}': output port "
                    f"{src_port} is consumed by layer "
                    f"'{dst_name}', but only the first output "
                    f"port of a layer is supported")
        for lid in order:
            ly = layers[lid]
            if ly.type not in _SUPPORTED:
                raise NotImplementedError(
                    f"OpenVINO layer type {ly.type!r} ('{ly.name}') is "
                    f"outside the supported subset — see "
                    f"net/openvino_ir.py's module docstring for the "
                    f"curated op list")
            if ly.type == "Gather" and int(ly.attrs.get("batch_dims",
                                                         0)) != 0:
                raise NotImplementedError(
                    f"Gather '{ly.name}': batch_dims != 0 is not "
                    f"supported")

        const_vals: Dict[str, np.ndarray] = {}
        inputs: List[str] = []
        results: List[str] = []
        for lid in order:
            ly = layers[lid]
            if ly.type == "Const":
                const_vals[lid] = _read_const(ly, blob)
            elif ly.type == "Parameter":
                inputs.append(lid)
            elif ly.type == "Result":
                results.append(lid)

        # Consts read as tensors (not only as shape-like inputs) become
        # params, keyed as the reference keys them
        tensor_consts = set()
        for lid in order:
            ly = layers[lid]
            static_slots = _STATIC_INPUTS.get(ly.type, ())
            for slot, port in enumerate(ly.in_ports):
                src = producer.get((lid, port))
                if src and src[0] in const_vals and \
                        slot not in static_slots:
                    tensor_consts.add(src[0])
        pnames: Dict[str, str] = {}
        consts: Dict[str, np.ndarray] = {}
        for lid in sorted(tensor_consts, key=int):
            key = layers[lid].name
            if key in consts:       # name collision: disambiguate by id
                key = f"{key}_{lid}"
            pnames[lid] = key
            consts[key] = const_vals[lid].copy()

        static_vals: Dict[Tuple[str, int], np.ndarray] = {}
        for lid in order:
            ly = layers[lid]
            for slot in _STATIC_INPUTS.get(ly.type, ()):
                if slot >= len(ly.in_ports):
                    continue    # optional input omitted (axis-less Squeeze)
                src = producer.get((lid, ly.in_ports[slot]))
                if not src or src[0] not in const_vals:
                    raise NotImplementedError(
                        f"{ly.type} '{ly.name}': input {slot} must be a "
                        f"Const (shape-like inputs are resolved at load "
                        f"time)")
                static_vals[(lid, slot)] = const_vals[src[0]].copy()
        del const_vals, blob
        order = _topological(order, layers, producer)
        return OpenVINONet(layers, order, producer, consts, pnames,
                           static_vals, inputs, results)

    # -- forward ---------------------------------------------------------
    def forward(self, *xs, params: Optional[Dict[str, torch.Tensor]] = None):
        p = self.params if params is None else params
        dev = next(iter(p.values())).device if p else None
        env: Dict[Tuple[str, str], torch.Tensor] = {}
        for lid, x in zip(self._inputs, xs):
            env[(lid, self._layers[lid].out_ports[0])] = _as_input(x, dev)
        with _full_f32(dev):
            for lid in self._order:
                ly = self._layers[lid]
                if ly.type in ("Parameter", "Result"):
                    continue
                if ly.type == "Const":
                    if lid in self._pnames:
                        env[(lid, ly.out_ports[0])] = p[self._pnames[lid]]
                    continue
                static_slots = _STATIC_INPUTS.get(ly.type, ())
                ins = [None if slot in static_slots
                       else env[self._producer[(lid, port)]]
                       for slot, port in enumerate(ly.in_ports)]
                env[(lid, ly.out_ports[0])] = self._lower(ly, ins)
        outs = [env[self._producer[(lid, self._layers[lid].in_ports[0])]]
                for lid in self._results]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _static_in(self, lid, slot, default=None):
        return self._static.get((lid, slot), default)

    def _lower(self, ly: _Layer, ins: List[torch.Tensor]) -> torch.Tensor:
        t, a = ly.type, ly.attrs
        if t in _UNARY:
            return _UNARY[t](ins[0])
        if t in _BINARY:
            return _BINARY[t](ins[0], ins[1])
        if t == "Gelu":
            approx = a.get("approximation_mode", "ERF").upper()
            return F.gelu(ins[0], approximate="none" if approx == "ERF"
                          else "tanh")
        if t == "Clamp":
            return torch.clamp(ins[0], float(a["min"]), float(a["max"]))
        if t == "PReLU":
            x, slope = ins
            if slope.dim() == 1 and x.dim() > 1:
                # a 1-D slope of length C is per CHANNEL on NCHW data
                slope = slope.reshape((1, -1) + (1,) * (x.dim() - 2))
            return torch.where(x >= 0, x, x * slope)
        if t == "MatMul":
            x, w = ins
            if a.get("transpose_a", "false") == "true":
                x = x.transpose(-1, -2)
            if a.get("transpose_b", "false") == "true":
                w = w.transpose(-1, -2)
            return torch.matmul(x, w)
        if t == "Softmax":
            return torch.softmax(ins[0], dim=int(a.get("axis", 1)))
        if t in ("Convolution", "GroupConvolution"):
            x, w = ins
            groups = 1
            if t == "GroupConvolution":
                # IR group weights: [G, O/G, I/G, kH, kW] -> OIHW
                groups = w.shape[0]
                w = w.reshape((w.shape[0] * w.shape[1],) + w.shape[2:])
            strides = _ints(a.get("strides", "1,1"))
            dil = _ints(a.get("dilations", "1,1"))
            pb, pe, _ = _resolve_pads(ly, x.shape[2:], w.shape[2:], strides,
                                      dil, False)
            if any(pb) or any(pe):
                x = F.pad(x, _torch_pads(pb, pe))
            return F.conv2d(x, w, stride=strides, dilation=dil,
                            groups=groups)
        if t in ("MaxPool", "AvgPool"):
            x = ins[0]
            kernel = _ints(a["kernel"])
            strides = _ints(a.get("strides", ",".join("1" * len(kernel))))
            ceil = a.get("rounding_type", "floor").lower() == "ceil"
            pb, pe, extra = _resolve_pads(ly, x.shape[2:], kernel, strides,
                                          (1,) * len(kernel), ceil)
            if t == "MaxPool":
                return _pool(x, kernel, strides, pb, pe, extra, "max", True)
            return _pool(x, kernel, strides, pb, pe, extra, "avg",
                         a.get("exclude-pad",
                               a.get("exclude_pad", "true")) == "true")
        if t == "ReduceMean":
            axes = tuple(int(v) for v in np.ravel(self._static_in(ly.id, 1)))
            keep = a.get("keep_dims", "true") == "true"
            x = ins[0] if ins[0].is_floating_point() else ins[0].float()
            return torch.mean(x, dim=axes, keepdim=keep) if axes else x
        if t == "Reshape":
            target = [int(v) for v in np.ravel(self._static_in(ly.id, 1))]
            if a.get("special_zero", "true") == "true":
                target = [ins[0].shape[i] if v == 0 else v
                          for i, v in enumerate(target)]
            return torch.reshape(ins[0], target)
        if t == "Squeeze":
            ax_arr = self._static_in(ly.id, 1)
            if ax_arr is None:      # optional input: drop ALL 1-dims
                return torch.squeeze(ins[0])
            return torch.squeeze(ins[0], tuple(int(v)
                                               for v in np.ravel(ax_arr)))
        if t == "Unsqueeze":
            raw = [int(v) for v in np.ravel(self._static_in(ly.id, 1))]
            # axes are OUTPUT-rank positions and may be negative
            out_rank = ins[0].dim() + len(raw)
            out = ins[0]
            for ax in sorted(ax if ax >= 0 else ax + out_rank for ax in raw):
                out = out.unsqueeze(ax)
            return out
        if t == "Transpose":
            perm = tuple(int(v) for v in np.ravel(self._static_in(ly.id, 1)))
            return ins[0].permute(perm)
        if t == "Concat":
            return torch.cat(ins, dim=int(a.get("axis", 0)))
        if t == "Gather":
            axis = int(np.ravel(self._static_in(ly.id, 2,
                                                np.zeros(1, np.int64)))[0])
            return _take(ins[0], ins[1], axis)
        # BatchNormInference (the build checked the op set)
        x, gamma, beta, mean, var = ins
        eps = float(a.get("epsilon", a.get("eps", 1e-5)))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x - mean.reshape(shape)) * gamma.reshape(shape) \
            / torch.sqrt(var.reshape(shape) + eps) + beta.reshape(shape)
