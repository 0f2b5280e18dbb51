"""Keras engine: symbolic tensors, Sequential / functional Model, KerasNet.

The port of ``analytics_zoo_tpu/keras/engine.py``.  A layer is an
``nn.Module`` (:class:`Layer`) that builds its parameters from its first
input, as a flax module does; calling it on a :class:`KTensor` records a
graph node instead of computing, and :class:`Model` replays the recorded
graph in topological order (a layer called twice shares its parameters).
:class:`KerasNet` lowers ``compile/fit/evaluate/predict`` onto the
port's ``TorchEstimator`` with the layers' regularizer penalty as its
``param_loss``.

Every module names its parameters after the reference's tree: a
``Sequential``'s layers are ``layers_<i>``, a ``Model``'s distinct layers
``ops_<i>`` in topological order, and inside a layer the flax
submodules' names (``Dense_0``, ``Conv_0``, ``BatchNorm_0``,
``OptimizedLSTMCell_0``, ``forward``/``backward``, ...).  The tensors lay
out their leaves as the port's building blocks do (a Dense weight
``[out, in]``, a Conv weight ``[out, in, *k]``, a recurrent cell's gates
side by side, ``models/rnn.py``) or, in a layer of its own
(``flax_layout``), as the reference does.  :func:`flax_leaves` maps each
reference leaf to its port tensor, so :func:`set_variables` loads the
reference's ``{"params", "batch_stats"}`` tree, :func:`get_variables`
gives it back, and ``get_weights``/``set_weights`` list the parameters
in the reference's order (natural path order: ``layers_2`` before
``layers_10``) and layouts (kernels ``[in, out]``, ``[*k, in, out]``):
one list moves weights between the two packages.

``save`` writes the module itself (``torch.save``: topology, weights
and running statistics; the compile spec when it is plain names), so
``load`` needs no sample input.  The two packages' files are not
interchangeable.
"""

from __future__ import annotations

import inspect
import itertools
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.keras.regularizers import Regularizer
from analytics_zoo_tpu_torch.models import rnn
from analytics_zoo_tpu_torch.models.layers import BatchNorm
from analytics_zoo_tpu_torch.models.transformer import fold_in

__all__ = ["KTensor", "Input", "Layer", "Sequential", "Model", "KerasNet",
           "merge", "flax_leaves", "set_variables", "get_variables"]


def _natural_key(s: str):
    return tuple(int(t) if t.isdigit() else t
                 for t in re.split(r"(\d+)", s))


# ---------------------------------------------------------------------------
# symbolic graph
# ---------------------------------------------------------------------------

_ids = itertools.count()


class KTensor:
    """Symbolic tensor: a node output in a functional-API graph."""

    def __init__(self, layer: Optional[nn.Module], inputs: Sequence["KTensor"],
                 shape: Optional[Tuple[Optional[int], ...]] = None,
                 call_kwargs: Optional[dict] = None):
        self.layer = layer            # None for placeholders (Input)
        self.inputs = tuple(inputs)
        self.shape = shape
        self.call_kwargs = dict(call_kwargs or {})
        self.uid = next(_ids)

    def __repr__(self):
        who = type(self.layer).__name__ if self.layer is not None else "Input"
        return f"KTensor<{who}#{self.uid}>"


def Input(shape: Sequence[Optional[int]], name: Optional[str] = None,
          dtype=None) -> KTensor:
    """Placeholder for a functional-API input. ``shape`` EXCLUDES the
    batch dim (keras semantics)."""
    kt = KTensor(None, (), shape=tuple(shape))
    kt.name = name
    kt.dtype = dtype or torch.float32
    return kt


def _contains_ktensor(x) -> bool:
    if isinstance(x, KTensor):
        return True
    if isinstance(x, (list, tuple)):
        return any(isinstance(e, KTensor) for e in x)
    return False


def _toposort(outputs: Sequence[KTensor]) -> List[KTensor]:
    order, seen = [], set()

    def visit(t: KTensor):
        if t.uid in seen:
            return
        seen.add(t.uid)
        for i in t.inputs:
            visit(i)
        order.append(t)

    for o in outputs:
        visit(o)
    return order


def _fold(rng: Optional[int], i: int) -> Optional[int]:
    return None if rng is None else fold_in(rng, i)


class Layer(nn.Module):
    """Base of the port's Keras layers: ``forward(x, train=False,
    rng=None)`` builds the parameters from the first input
    (:meth:`build`, once) and then computes (:meth:`call`).  ``rng`` is
    the seed of a training forward's random draws (see
    ``models.transformer.fold_in``).  Tensors a layer owns itself are in
    the reference's layout (``flax_layout``)."""

    flax_layout = True
    _takes_list = False

    def __init__(self):
        super().__init__()
        self.built = False

    def __call__(self, *args, **kwargs):
        if args and _contains_ktensor(args[0]):
            ins = args[0] if isinstance(args[0], (list, tuple)) \
                else [args[0]]
            return KTensor(self, ins, call_kwargs=kwargs)
        return super().__call__(*args, **kwargs)

    def build(self, x) -> None:
        """Create the parameters for the first input ``x``."""

    def call(self, x, train: bool, rng: Optional[int]):
        raise NotImplementedError

    def forward(self, x, train: bool = False, rng: Optional[int] = None):
        if not self.built:
            with torch.no_grad():
                self.build(x)
            self.built = True
        return self.call(x, train, rng)


def _accepts(layer, kwarg: str) -> bool:
    try:
        return kwarg in inspect.signature(layer.forward).parameters
    except (TypeError, ValueError):
        return False


def _call_layer(layer, x, train: bool, rng: Optional[int],
                extra_kwargs: Optional[dict] = None):
    """Invoke a child layer, passing ``train`` and ``rng`` where its
    forward takes them; ``extra_kwargs`` replays kwargs recorded at
    symbolic-call time."""
    kw = dict(extra_kwargs or {})
    kw.pop("train", None)
    kw.pop("rng", None)
    if _accepts(layer, "train"):
        kw["train"] = train
    if _accepts(layer, "rng"):
        kw["rng"] = rng
    if isinstance(x, (list, tuple)):
        if getattr(layer, "_takes_list", False):
            return layer(list(x), **kw)
        if isinstance(layer, KerasNet):
            return layer(*x, **kw)
    return layer(x, **kw)


# ---------------------------------------------------------------------------
# the reference's leaves
# ---------------------------------------------------------------------------


@dataclass
class TreeLeaf:
    """One leaf of the reference's variables and the port tensor that
    holds it (``rows`` of it when the tensor fuses several leaves):
    ``kind`` "dense" is a transposed kernel, "conv" a kernel ``[out, in,
    *k]``, "as_is" the leaf's own layout.  ``module`` owns the tensor;
    ``cell`` is the recurrent cell it belongs to, if any."""
    collection: str
    path: Tuple[str, ...]
    tensor: torch.Tensor
    kind: str = "as_is"
    rows: Optional[slice] = None
    module: Optional[nn.Module] = None
    cell: Optional[nn.Module] = None

    def get(self) -> torch.Tensor:
        """The leaf in the reference's layout (a view where possible)."""
        t = self.tensor.detach()
        if self.rows is not None:
            t = t[self.rows]
        if self.kind == "dense":
            return t.t()
        if self.kind == "conv":
            n = t.dim()
            return t.permute(tuple(range(2, n)) + (1, 0))
        return t

    def port_value(self, v: torch.Tensor) -> torch.Tensor:
        """A value of the leaf (the reference's layout) in the port
        tensor's layout (a view)."""
        if self.kind == "dense":
            return v.t()
        if self.kind == "conv":
            n = v.dim()
            return v.permute((n - 1, n - 2) + tuple(range(n - 2)))
        return v

    def set(self, value) -> None:
        v = self.port_value(torch.as_tensor(np.array(value,
                                                     dtype=np.float32)))
        dst = self.tensor.data if self.rows is None \
            else self.tensor.data[self.rows]
        if tuple(dst.shape) != tuple(v.shape):
            raise ValueError(
                f"{'/'.join(self.path)}: the reference's leaf has shape "
                f"{tuple(np.shape(value))}, the model's "
                f"{tuple(self.get().shape)}")
        with torch.no_grad():
            dst.copy_(v.to(dst.dtype))


_LSTM_GATES = "ifgo"
_GRU_GATES = ("r", "z", "n")


def _cell_leaves(cell, path) -> List[TreeLeaf]:
    """A recurrent cell's leaves: each gate's kernels and biases, rows of
    the fused ``i``/``h`` tensors (``models/rnn.py``)."""
    H = cell.features

    def leaf(name, attr, mod, kind, g=None):
        rows = None if g is None else slice(g * H, (g + 1) * H)
        return TreeLeaf("params", path + (name, attr),
                        getattr(mod, "weight" if attr == "kernel" else
                                "bias"), kind, rows, mod, cell)

    if isinstance(cell, rnn.LSTMCell):
        return [lf for g, n in enumerate(_LSTM_GATES) for lf in (
            leaf("i" + n, "kernel", cell.i, "dense", g),
            leaf("h" + n, "kernel", cell.h, "dense", g),
            leaf("h" + n, "bias", cell.h, "as_is", g))]
    if isinstance(cell, rnn.GRUCell):
        out = [lf for g, n in enumerate(_GRU_GATES) for lf in (
            leaf("i" + n, "kernel", cell.i, "dense", g),
            leaf("i" + n, "bias", cell.i, "as_is", g),
            leaf("h" + n, "kernel", cell.h, "dense", g))]
        return out + [TreeLeaf("params", path + ("hn", "bias"),
                               cell.hn_bias, module=cell, cell=cell)]
    return [leaf("i", "kernel", cell.i, "dense"),
            leaf("i", "bias", cell.i, "as_is"),
            leaf("h", "kernel", cell.h, "dense")]


def flax_leaves(module: nn.Module, path: Tuple[str, ...] = ()
                ) -> List[TreeLeaf]:
    """Every leaf of the reference's variables for ``module`` (a built
    port Keras model or layer), with its port tensor."""
    out = _leaves(module, path)
    for lf in out:
        if lf.module is None:
            lf.module = module
    return out


def _leaves(module: nn.Module, path: Tuple[str, ...]) -> List[TreeLeaf]:
    kind = getattr(module, "flax_kind", None)
    if isinstance(module, rnn._Cell):
        return _cell_leaves(module, path)
    if isinstance(module, BatchNorm):
        return [TreeLeaf("params", path + ("scale",), module.weight),
                TreeLeaf("params", path + ("bias",), module.bias),
                TreeLeaf("batch_stats", path + ("mean",),
                         module.running_mean),
                TreeLeaf("batch_stats", path + ("var",), module.running_var)]
    if kind == "norm":
        return [TreeLeaf("params", path + ("scale",), module.weight),
                TreeLeaf("params", path + ("bias",), module.bias)]
    if isinstance(module, nn.Linear):
        out = [TreeLeaf("params", path + ("kernel",), module.weight,
                        "dense")]
    elif isinstance(module, nn.modules.conv._ConvNd) or kind == "conv":
        out = [TreeLeaf("params", path + ("kernel",), module.weight, "conv")]
    elif isinstance(module, nn.Embedding):
        return [TreeLeaf("params", path + ("embedding",), module.weight)]
    else:
        own = list(module.named_parameters(recurse=False))
        if own and not getattr(module, "flax_layout", False):
            raise TypeError(f"{type(module).__name__} at {'/'.join(path)} "
                            f"has no counterpart in the reference's tree")
        out = [TreeLeaf("params", path + (n,), p) for n, p in own]
        for name, child in module._modules.items():
            if child is not None:
                out += flax_leaves(child, path + (name,))
        return out
    if module.bias is not None:
        out.append(TreeLeaf("params", path + ("bias",), module.bias))
    return out


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def set_variables(module: nn.Module, variables) -> None:
    """Load the reference's ``{"params": ..., ["batch_stats": ...]}``
    tree (leaves as numpy arrays or anything ``np.asarray`` takes) into a
    built port Keras model or layer.  Every leaf the model has must be
    in the tree with its shape, and every leaf of the tree must be the
    model's: either mismatch raises ``ValueError``."""
    leaves = flax_leaves(module)
    want = {(lf.collection,) + lf.path for lf in leaves}
    have = set()

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            for k, v in node.items():
                walk(v, path + (str(k),))
        else:
            have.add(path)

    for coll in ("params", "batch_stats"):
        if coll in variables:
            walk(variables[coll], (coll,))
    if want != have:
        raise ValueError(
            f"the variables do not match the model: missing "
            f"{sorted('/'.join(p) for p in want - have)[:4]}, unexpected "
            f"{sorted('/'.join(p) for p in have - want)[:4]}")
    for lf in leaves:
        lf.set(_lookup(variables[lf.collection], lf.path))


def get_variables(module: nn.Module) -> Dict[str, dict]:
    """The model's variables as the reference's tree of numpy arrays:
    ``{"params": ..., "batch_stats": ...}`` (the latter only when the
    model has running statistics)."""
    out: Dict[str, dict] = {}
    for lf in flax_leaves(module):
        node = out.setdefault(lf.collection, {})
        for k in lf.path[:-1]:
            node = node.setdefault(k, {})
        node[lf.path[-1]] = lf.get().cpu().numpy().copy()
    return out


# ---------------------------------------------------------------------------
# regularization
# ---------------------------------------------------------------------------

_KERNEL_NAMES = ("kernel", "embedding")


def _layer_penalty(layer: nn.Module, device) -> torch.Tensor:
    pen = torch.zeros((), dtype=torch.float32, device=device)
    w_reg = getattr(layer, "W_regularizer", None)
    b_reg = getattr(layer, "b_regularizer", None)
    w_reg = w_reg if isinstance(w_reg, Regularizer) else None
    b_reg = b_reg if isinstance(b_reg, Regularizer) else None
    if w_reg is None and b_reg is None:
        return pen
    for lf in flax_leaves(layer):
        t = lf.tensor if lf.rows is None else lf.tensor[lf.rows]
        if w_reg is not None and lf.path[-1] in _KERNEL_NAMES:
            pen = pen + w_reg(t)
        if b_reg is not None and lf.path[-1] == "bias":
            pen = pen + b_reg(t)
    return pen


def collect_penalty(net: "KerasNet") -> torch.Tensor:
    """Sum of the L1/L2 penalties declared by any layer of ``net``
    (recursing into nested Sequential/Model), on the model's device."""
    device = next((p.device for p in net.parameters()),
                  torch.device("cpu"))
    pen = torch.zeros((), dtype=torch.float32, device=device)
    for _, layer in net._child_layers():
        if isinstance(layer, KerasNet):
            pen = pen + collect_penalty(layer)
        else:
            pen = pen + _layer_penalty(layer, device)
    return pen


# ---------------------------------------------------------------------------
# KerasNet: compile/fit/evaluate/predict
# ---------------------------------------------------------------------------


class KerasNet(Layer):
    """Base for Sequential/Model: the keras-style training surface
    lowered onto the port's ``TorchEstimator`` (built at the first
    ``fit``/``evaluate``/``predict``, after the model has built its
    parameters from the first rows of the data)."""

    def __init__(self):
        super().__init__()
        self._estimator = None

    def _child_layers(self) -> List[Tuple[str, nn.Module]]:
        raise NotImplementedError

    @property
    def n_inputs(self) -> int:
        return 1

    def forward(self, *xs, train: bool = False, rng: Optional[int] = None):
        self.built = True
        return self.call(xs, train, rng)

    # -- building ----------------------------------------------------------

    def _sample_inputs(self) -> Optional[List[torch.Tensor]]:
        """One zero row for each input whose shape the model knows, else
        None."""
        return None

    def build_on(self, *xs) -> "KerasNet":
        """Build every layer's parameters from inputs ``xs`` (arrays or
        tensors; their first rows are used), without training."""
        dev = next((p.device for p in self.parameters()),
                   torch.device("cpu"))

        def rows(x):
            if isinstance(x, (list, tuple)):
                return [rows(e) for e in x]
            return torch.as_tensor(x[:2] if torch.is_tensor(x)
                                   else np.asarray(x[:2]), device=dev)

        ins = [rows(x) for x in xs]
        was = self.training
        self.eval()
        with torch.no_grad():
            self(*ins, train=False)
        self.train(was)
        return self

    def ensure_built(self, sample=None) -> "KerasNet":
        """Build from ``sample`` (a list of inputs), else from the known
        input shapes; raise if neither is there."""
        if self.built and all(getattr(m, "built", True)
                              for m in self.modules()):
            return self
        if sample is None:
            sample = self._sample_inputs()
        if sample is None:
            raise ValueError(
                "the model has not built its parameters and knows no input "
                "shape: call build_on(sample) (or fit), or give the first "
                "layer input_shape")
        return self.build_on(*sample)

    # -- training surface ----------------------------------------------------

    def compile(self, optimizer="sgd", loss="mse", metrics=None, lr=None,
                device=None):
        """Record the training config; the Estimator is built at the
        first fit/evaluate/predict.  ``device``: where it trains (``cuda``
        unless the caller names another or a context sets one)."""
        self._compile_cfg = {"optimizer": optimizer, "lr": lr, "loss": loss,
                             "metrics": list(metrics or [])}
        self._device = device
        self._estimator = None
        return self

    def _feature_cols(self, n: int) -> Tuple[str, ...]:
        return tuple(f"x{i}" for i in range(n))

    def _as_dict(self, x, y=None) -> Dict[str, np.ndarray]:
        xs = list(x) if isinstance(x, (list, tuple)) else [x]
        d = {f"x{i}": np.asarray(a) for i, a in enumerate(xs)}
        if y is not None:
            d["y"] = np.asarray(y)
        return d

    def _get_estimator(self, data: Dict[str, np.ndarray]):
        if getattr(self, "_estimator", None) is not None:
            return self._estimator
        if not hasattr(self, "_compile_cfg"):
            raise RuntimeError("call compile(...) before fit/evaluate")
        from analytics_zoo_tpu_torch.keras.objectives import get_loss
        from analytics_zoo_tpu_torch.keras.optimizers import get_optimizer
        from analytics_zoo_tpu_torch.learn.estimator import TorchEstimator

        feats = [data[f"x{i}"] for i in range(len(data) - ("y" in data))]
        self.ensure_built(feats)
        cfg = self._compile_cfg
        est = TorchEstimator(
            self, get_loss(cfg["loss"]),
            get_optimizer(cfg["optimizer"], cfg.get("lr")),
            metrics=cfg["metrics"], feature_cols=self._feature_cols(
                len(feats)), label_cols=("y",),
            device=getattr(self, "_device", None),
            param_loss=collect_penalty)
        tb = getattr(self, "_tb_cfg", None)
        if tb is not None:
            est.set_tensorboard(*tb)
        self._estimator = est
        return est

    def fit(self, x, y, batch_size: int = 32, nb_epoch: int = 1,
            epochs: Optional[int] = None, validation_data=None, **kw):
        data = self._as_dict(x, y)
        est = self._get_estimator(data)
        val = None
        if validation_data is not None:
            val = self._as_dict(*validation_data)
        return est.fit(data, epochs=epochs or nb_epoch,
                       batch_size=batch_size, validation_data=val, **kw)

    def evaluate(self, x, y, batch_size: int = 32) -> Dict[str, float]:
        data = self._as_dict(x, y)
        return self._get_estimator(data).evaluate(data,
                                                  batch_size=batch_size)

    def predict(self, x, batch_size: int = 32,
                distributed: bool = False) -> np.ndarray:
        data = self._as_dict(x)
        return self._get_estimator(data).predict(data,
                                                 batch_size=batch_size)

    def predict_classes(self, x, batch_size: int = 32) -> np.ndarray:
        return np.argmax(self.predict(x, batch_size), axis=-1)

    # -- weights -------------------------------------------------------------

    def _param_leaves(self) -> List[TreeLeaf]:
        if not self.built:
            raise RuntimeError("model has no weights yet (fit/build first)")
        leaves = [lf for lf in flax_leaves(self) if lf.collection == "params"]
        leaves.sort(key=lambda lf: _natural_key("/".join(lf.path)))
        return leaves

    def get_weights(self) -> List[np.ndarray]:
        """The parameters as numpy arrays in the reference's order
        (natural path order) and layouts."""
        return [lf.get().cpu().numpy().copy() for lf in self._param_leaves()]

    def set_weights(self, weights: Sequence[np.ndarray]):
        leaves = self._param_leaves()
        if len(weights) != len(leaves):
            raise ValueError(f"expected {len(leaves)} arrays, got "
                             f"{len(weights)}")
        for lf, w in zip(leaves, weights):
            lf.set(np.asarray(w).reshape(tuple(lf.get().shape)))

    def set_tensorboard(self, log_dir: str, app_name: str = "zoo"):
        """ref-parity: KerasNet.set_tensorboard (the Estimator's
        ``set_tensorboard``)."""
        self._tb_cfg = (log_dir, app_name)
        est = getattr(self, "_estimator", None)
        if est is not None:
            est.set_tensorboard(log_dir, app_name)
        return self

    def summary(self) -> str:
        lines = [f"{type(self).__name__}"]
        for field, layer in self._child_layers():
            n = sum(p.numel() for p in layer.parameters())
            lines.append(f"  {field}: {type(layer).__name__} ({n} params)")
        s = "\n".join(lines)
        print(s)
        return s

    # -- persistence -------------------------------------------------------

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_estimator"] = None
        cfg = d.get("_compile_cfg")
        if cfg is not None and not (isinstance(cfg["optimizer"], str)
                                    and isinstance(cfg["loss"], str)
                                    and all(isinstance(m, str)
                                            for m in cfg["metrics"])):
            d.pop("_compile_cfg", None)
        return d

    def save(self, path: str):
        """Write the model (topology, weights, running statistics and a
        plain compile spec) to ``path/model.pt``."""
        os.makedirs(path, exist_ok=True)
        torch.save(self, os.path.join(path, "model.pt"))

    @staticmethod
    def load(path: str, sample_x=None) -> "KerasNet":
        """Read a :meth:`save`; ``sample_x`` is accepted for the
        reference's signature (the saved module carries its shapes)."""
        del sample_x
        return torch.load(os.path.join(path, "model.pt"), map_location="cpu",
                          weights_only=False)


# ---------------------------------------------------------------------------
# Sequential
# ---------------------------------------------------------------------------


class Sequential(KerasNet):
    """Linear layer stack (ref: keras-API Sequential); the layers are
    ``layers_<i>``."""

    def __init__(self, layers: Sequence[nn.Module] = ()):
        super().__init__()
        self.n_layers = 0
        for layer in layers:
            self.add(layer)

    def add(self, layer: nn.Module) -> "Sequential":
        self.add_module(f"layers_{self.n_layers}", layer)
        self.n_layers += 1
        return self

    def _child_layers(self):
        return [(f"layers_{i}", getattr(self, f"layers_{i}"))
                for i in range(self.n_layers)]

    def _sample_inputs(self):
        if not self.n_layers:
            return None
        shape = getattr(self.layers_0, "input_shape", None)
        if shape is None:
            return None
        return [torch.zeros((1,) + tuple(shape))]

    def call(self, xs, train, rng):
        x = xs[0] if len(xs) == 1 else list(xs)
        for i, (_, layer) in enumerate(self._child_layers()):
            x = _call_layer(layer, x, train, _fold(rng, i))
        return x


# ---------------------------------------------------------------------------
# functional Model
# ---------------------------------------------------------------------------


class Model(KerasNet):
    """Functional-API graph model (ref: keras Model): ``Model(input=...,
    output=...)`` from :func:`Input` placeholders and symbolic layer
    calls.  The recorded graph is kept by node ids, so a copy or a
    pickle of the model keeps it."""

    def __init__(self, input=None, output=None):
        super().__init__()
        ins = tuple(input) if isinstance(input, (list, tuple)) else (input,)
        outs = tuple(output) if isinstance(output, (list, tuple)) \
            else (output,)
        order = [t for t in _toposort(outs) if t.layer is not None]
        index: Dict[int, int] = {}
        layers = []
        for t in order:
            if id(t.layer) not in index:
                index[id(t.layer)] = len(layers)
                layers.append(t.layer)
        for i, layer in enumerate(layers):
            self.add_module(f"ops_{i}", layer)
        self.n_ops = len(layers)
        self._inputs = [t.uid for t in ins]
        self._input_specs = [(t.shape, getattr(t, "dtype", torch.float32))
                             for t in ins]
        self._outputs = [t.uid for t in outs]
        self._nodes = [(t.uid, index[id(t.layer)], [i.uid for i in t.inputs],
                        t.call_kwargs) for t in order]

    @property
    def n_inputs(self) -> int:
        return len(self._inputs)

    def _child_layers(self):
        return [(f"ops_{i}", getattr(self, f"ops_{i}"))
                for i in range(self.n_ops)]

    def _sample_inputs(self):
        if any(s is None for s, _ in self._input_specs):
            return None
        return [torch.zeros((1,) + tuple(d or 1 for d in s), dtype=dt)
                for s, dt in self._input_specs]

    def call(self, xs, train, rng):
        if len(xs) != len(self._inputs):
            raise ValueError(f"model takes {len(self._inputs)} inputs, "
                             f"got {len(xs)}")
        env: Dict[int, Any] = dict(zip(self._inputs, xs))
        for n, (uid, op, ins, kw) in enumerate(self._nodes):
            layer = getattr(self, f"ops_{op}")
            arg = env[ins[0]] if len(ins) == 1 else [env[i] for i in ins]
            env[uid] = _call_layer(layer, arg, train, _fold(rng, n), kw)
        outs = tuple(env[u] for u in self._outputs)
        return outs[0] if len(outs) == 1 else outs


def merge(inputs: Sequence[KTensor], mode: str = "sum",
          concat_axis: int = -1) -> KTensor:
    """Functional merge of symbolic tensors (ref: keras ``merge``)."""
    from analytics_zoo_tpu_torch.keras.layers import Merge
    return Merge(mode=mode, concat_axis=concat_axis)(list(inputs))
