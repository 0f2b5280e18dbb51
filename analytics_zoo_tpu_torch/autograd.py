"""Define-by-expression autograd API: the port of
``analytics_zoo_tpu/autograd.py``.

A :class:`Variable` composes a function ``env -> tensor`` out of torch
operations, so a :class:`CustomLoss` is a plain ``(preds, targets) ->
scalar`` torch expression the Estimator's backward differentiates, and a
:class:`CustomLayer` is a Keras-API layer whose :class:`Parameter`\\ s are
its ``nn.Parameter``\\ s (named as the reference names them,
``parameter_<n>`` unless given).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.keras.engine import Layer
from analytics_zoo_tpu_torch.keras.initializers import (variance_scaling,
                                                        zeros)

__all__ = [
    "Variable", "Parameter", "CustomLoss", "CustomLayer",
    "abs", "mean", "sum", "clip", "square", "sqrt", "exp", "log", "pow",
    "maximum", "minimum", "mm", "dot", "stack", "expand_dims", "squeeze",
    "softmax", "softsign", "softplus", "l2_normalize", "epsilon",
]


class Variable:
    """A symbolic tensor expression: composes a function env -> tensor."""

    def __init__(self, fn: Callable[[Dict[int, Any]], Any],
                 params: Tuple["Parameter", ...] = (),
                 name: Optional[str] = None):
        self._fn = fn
        self._params = tuple(params)
        self.name = name

    @staticmethod
    def placeholder(name: Optional[str] = None) -> "Variable":
        v = Variable(None, name=name)
        v._fn = lambda env: env[id(v)]
        return v

    # -- evaluation ------------------------------------------------------

    def eval(self, env: Dict["Variable", Any]) -> torch.Tensor:
        return self._fn({id(k): val for k, val in env.items()})

    def _lower(self, env_by_id):
        return self._fn(env_by_id)

    # -- operator algebra ------------------------------------------------

    @staticmethod
    def _lift(other) -> Tuple[Callable, tuple]:
        if isinstance(other, Variable):
            return other._fn, other._params
        return (lambda env: other), ()

    def _binop(self, other, op) -> "Variable":
        ofn, op_params = Variable._lift(other)
        return Variable(lambda env: op(self._fn(env), ofn(env)),
                        self._params + tuple(op_params))

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: b / a)

    def __pow__(self, o):
        return self._binop(o, lambda a, b: a ** b)

    def __neg__(self):
        return Variable(lambda env: -self._fn(env), self._params)

    def __getitem__(self, idx):
        return Variable(lambda env: self._fn(env)[idx], self._params)

    def _unary(self, op) -> "Variable":
        return Variable(lambda env: op(self._fn(env)), self._params)


class Parameter(Variable):
    """A trainable weight usable inside an expression (ref: autograd
    Parameter): a :class:`CustomLayer`'s ``nn.Parameter``, from
    ``init_weight`` or ``init(shape)`` (lecun-normal for two or more
    dims, zeros below)."""

    _count = 0

    def __init__(self, shape: Sequence[int], init_weight=None,
                 init: Callable = None, name: Optional[str] = None):
        Parameter._count += 1
        self.shape = tuple(shape)
        self.init_weight = init_weight
        self.initializer = init or (
            variance_scaling(1.0, "fan_in", "normal") if len(shape) >= 2
            else zeros)
        pname = name or f"parameter_{Parameter._count}"
        super().__init__(None, name=pname)
        self._params = (self,)
        self._fn = lambda env: env[id(self)]


# ---------------------------------------------------------------------------
# expression functions (module-level, numpy axis semantics)
# ---------------------------------------------------------------------------


def _wrap_unary(op):
    def f(v, *args, **kw):
        if not isinstance(v, Variable):
            return op(v, *args, **kw)
        return Variable(lambda env: op(v._fn(env), *args, **kw), v._params)
    return f


def _squeeze(a, axis=None):
    return torch.squeeze(a) if axis is None else torch.squeeze(a, axis)


abs = _wrap_unary(torch.abs)                      # noqa: A001
square = _wrap_unary(torch.square)
sqrt = _wrap_unary(torch.sqrt)
exp = _wrap_unary(torch.exp)
log = _wrap_unary(torch.log)
softmax = _wrap_unary(lambda a: torch.softmax(a, dim=-1))
softsign = _wrap_unary(F.softsign)
softplus = _wrap_unary(F.softplus)
expand_dims = _wrap_unary(torch.unsqueeze)
squeeze = _wrap_unary(_squeeze)


def _reduce(op, a, axis, keepdims):
    return op(a) if axis is None else op(a, dim=axis, keepdim=keepdims)


def mean(v: Variable, axis=None, keepdims: bool = False) -> Variable:
    return v._unary(lambda a: _reduce(torch.mean, a, axis, keepdims))


def sum(v: Variable, axis=None, keepdims: bool = False) -> Variable:  # noqa: A001
    return v._unary(lambda a: _reduce(torch.sum, a, axis, keepdims))


def clip(v: Variable, min_value, max_value) -> Variable:
    return v._unary(lambda a: torch.clamp(a, min_value, max_value))


def pow(v: Variable, p) -> Variable:  # noqa: A001
    return v._unary(lambda a: a ** p)


def _tensor_like(b, a):
    return b if torch.is_tensor(b) else torch.as_tensor(
        np.asarray(b), dtype=a.dtype, device=a.device)


def maximum(a: Variable, b) -> Variable:
    return a._binop(b, lambda x, y: torch.maximum(x, _tensor_like(y, x)))


def minimum(a: Variable, b) -> Variable:
    return a._binop(b, lambda x, y: torch.minimum(x, _tensor_like(y, x)))


def mm(a: Variable, b: Variable, axes: Optional[Sequence[int]] = None) \
        -> Variable:
    """Batched matmul (ref: autograd.mm).  ``axes`` follows the
    reference's batch-dot convention; by default the last axis of ``a``
    meets the first non-batch axis of ``b``."""
    if axes is not None:
        def op(x, y):
            return torch.matmul(x.movedim(axes[0], -1),
                                y.movedim(axes[1], -2))
    else:
        def op(x, y):
            return x @ y
    return a._binop(b, op)


def dot(a: Variable, b: Variable, axes=None) -> Variable:
    return mm(a, b, axes)


def stack(vs: Sequence[Variable], axis: int = 1) -> Variable:
    params: List[Parameter] = []
    for v in vs:
        params.extend(v._params)
    return Variable(
        lambda env: torch.stack([v._fn(env) for v in vs], dim=axis),
        tuple(params))


def l2_normalize(v: Variable, axis: int = -1) -> Variable:
    return v._unary(lambda a: a / (torch.linalg.vector_norm(
        a, dim=axis, keepdim=True) + 1e-12))


def epsilon() -> float:
    return 1e-7


# ---------------------------------------------------------------------------
# CustomLoss / CustomLayer
# ---------------------------------------------------------------------------


class CustomLoss:
    """Loss from a Variable expression (ref: autograd.CustomLoss):
    ``CustomLoss(loss_var, y_true, y_pred)`` or
    ``CustomLoss.from_function(fn)`` with ``fn(y_true, y_pred) ->
    Variable``.  Callable as ``(preds, targets) -> scalar``, the mean of
    a non-scalar result."""

    def __init__(self, loss_var: Variable, y_true: Variable,
                 y_pred: Variable):
        self.loss_var = loss_var
        self.y_true = y_true
        self.y_pred = y_pred

    @staticmethod
    def from_function(fn: Callable[[Variable, Variable], Variable]) \
            -> "CustomLoss":
        yt, yp = Variable.placeholder("y_true"), Variable.placeholder("y_pred")
        return CustomLoss(fn(yt, yp), yt, yp)

    def __call__(self, preds, targets):
        out = self.loss_var.eval({self.y_true: targets, self.y_pred: preds})
        return torch.mean(out)


def custom_loss(fn: Callable[[Variable, Variable], Variable]) -> CustomLoss:
    """``loss = custom_loss(lambda yt, yp: mean(abs(yt - yp)))``."""
    return CustomLoss.from_function(fn)


class CustomLayer(Layer):
    """Layer from a Variable expression with :class:`Parameter` weights
    (ref: autograd CustomLayer); usable in a Sequential/Model like any
    other layer."""

    def __init__(self, out_var: Variable = None,
                 in_vars: Tuple[Variable, ...] = ()):
        super().__init__()
        self.out_var = out_var
        self.in_vars = tuple(in_vars)

    def _unique(self):
        # a Parameter used twice in the expression registers once
        return {id(p): p for p in self.out_var._params}.values()

    def build(self, x):
        xs = x if isinstance(x, (list, tuple)) else [x]
        dev = xs[0].device
        for p in self._unique():
            w = torch.as_tensor(np.asarray(p.init_weight, np.float32)) \
                if p.init_weight is not None else p.initializer(p.shape)
            self.register_parameter(p.name, nn.Parameter(
                w.to(device=dev, dtype=torch.float32)))

    def call(self, x, train, rng):
        xs = x if isinstance(x, (list, tuple)) else [x]
        if len(xs) != len(self.in_vars):
            raise ValueError(f"CustomLayer takes {len(self.in_vars)} "
                             f"inputs, got {len(xs)}")
        env = {id(v): a for v, a in zip(self.in_vars, xs)}
        for p in self._unique():
            env[id(p)] = getattr(self, p.name)
        return self.out_var._lower(env)
