"""Optimizer strings: the port of ``analytics_zoo_tpu/keras/
optimizers.py``.

The reference lowers each name to an optax transform (optax 0.2.6).
:func:`get_optimizer` returns a callable ``params -> torch.optim.
Optimizer``, the form ``TorchEstimator`` takes, with the reference's
default rates.  ``torch.optim`` computes what optax computes for
``sgd``, ``momentum`` (``dampening`` 0), ``adam``, ``adamw`` (weight
decay 1e-4, optax's default), ``adamax`` (eps inside the max, as
``update_infinity_moment``) and ``adadelta`` (rho 0.9, eps 1e-6 under
both roots); four differ, and are written here as optax writes them:

- :class:`RMSprop`: decay 0.9, eps 1e-8 INSIDE the root
  (``scale_by_rms(eps_in_sqrt=True)``; torch: 0.99, eps outside);
- :class:`Adagrad`: accumulator from 0.1, ``rsqrt(acc + 1e-7)`` where
  the accumulator is above 0 (``scale_by_rss``);
- :class:`NAdam`: optax's ``adam(nesterov=True)`` (torch's NAdam
  decays its momentum by a schedule);
- :class:`Lamb`: ``scale_by_adam`` (eps 1e-6) then the trust ratio
  ``||w|| / ||u||`` (1 where either is 0); torch has no LAMB.

A trust ratio is a norm per reference leaf.  A port tensor that fuses
several leaves (a recurrent cell's gates side by side,
``models/rnn.py``) carries ``flax_chunks`` = the number of leaves along
its first dim, and :class:`Lamb` takes one norm a chunk.
"""

from __future__ import annotations

from typing import Callable, Union

import torch


class _Optax(torch.optim.Optimizer):
    """An optax chain over each parameter tensor: ``update(p, g, state,
    t)`` returns optax's update before the learning rate; the step adds
    ``-lr * update``, as ``scale_by_learning_rate`` then
    ``apply_updates``."""

    def __init__(self, params, lr: float, **defaults):
        super().__init__(params, dict(lr=lr, **defaults))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["t"] = 0
                    self.init_state(p, state, group)
                state["t"] += 1
                u = self.update(p, p.grad, state, group)
                p.add_(u * (-group["lr"]))
        return loss


class RMSprop(_Optax):
    """optax ``rmsprop(lr, decay=0.9, eps=1e-8)``: ``nu = 0.1 g^2 + 0.9
    nu``; the update ``g * rsqrt(nu + eps)``."""

    def __init__(self, params, lr: float = 1e-3, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, lr, decay=decay, eps=eps)

    def init_state(self, p, state, group):
        state["nu"] = torch.zeros_like(p)

    def update(self, p, g, state, group):
        d = group["decay"]
        nu = state["nu"] = (1 - d) * g ** 2 + d * state["nu"]
        return torch.rsqrt(nu + group["eps"]) * g


class Adagrad(_Optax):
    """optax ``adagrad(lr, initial_accumulator_value=0.1, eps=1e-7)``:
    ``acc = g^2 + acc``; the update ``g * rsqrt(acc + eps)`` where ``acc
    > 0``, else 0."""

    def __init__(self, params, lr: float = 1e-2,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, lr, initial=initial_accumulator_value,
                         eps=eps)

    def init_state(self, p, state, group):
        state["acc"] = torch.full_like(p, group["initial"])

    def update(self, p, g, state, group):
        acc = state["acc"] = g * g + state["acc"]
        inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]),
                          torch.zeros((), dtype=acc.dtype, device=acc.device))
        return inv * g


def _bias(decay: float, t: int, like: torch.Tensor) -> torch.Tensor:
    """optax's ``1 - decay**count`` in the moment's dtype."""
    return 1 - torch.tensor(decay, dtype=like.dtype, device=like.device) ** t


def _adam(g, state, group, nesterov: bool):
    """optax ``scale_by_adam``'s update (``eps_root`` 0)."""
    b1, b2, t = group["b1"], group["b2"], state["t"]
    mu = state["mu"] = (1 - b1) * g + b1 * state["mu"]
    nu = state["nu"] = (1 - b2) * g ** 2 + b2 * state["nu"]
    if nesterov:
        mu_hat = b1 * (mu / _bias(b1, t + 1, mu)) + \
            (1 - b1) * (g / _bias(b1, t, g))
    else:
        mu_hat = mu / _bias(b1, t, mu)
    nu_hat = nu / _bias(b2, t, nu)
    return mu_hat / (torch.sqrt(nu_hat) + group["eps"])


class NAdam(_Optax):
    """optax ``nadam(lr, b1=0.9, b2=0.999, eps=1e-8)``: Adam's update
    with the Nesterov first moment ``b1 mu / (1 - b1^(t+1)) + (1 - b1) g
    / (1 - b1^t)``."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps)

    def init_state(self, p, state, group):
        state["mu"] = torch.zeros_like(p)
        state["nu"] = torch.zeros_like(p)

    def update(self, p, g, state, group):
        return _adam(g, state, group, nesterov=True)


def _leaf_norms(x: torch.Tensor, chunks: int) -> torch.Tensor:
    """The 2-norm of each reference leaf in ``x``, broadcastable to it."""
    if chunks == 1:
        return torch.linalg.vector_norm(x)
    n = torch.linalg.vector_norm(x.reshape(chunks, -1), dim=1)
    return n.repeat_interleave(x.shape[0] // chunks).reshape(
        (-1,) + (1,) * (x.dim() - 1))


class Lamb(_Optax):
    """optax ``lamb(lr, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0)``:
    Adam's update ``u`` (plus ``weight_decay * w``) scaled by ``||w|| /
    ||u||`` per reference leaf, 1 where either norm is 0."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay)

    def init_state(self, p, state, group):
        state["mu"] = torch.zeros_like(p)
        state["nu"] = torch.zeros_like(p)

    def update(self, p, g, state, group):
        u = _adam(g, state, group, nesterov=False)
        u = u + group["weight_decay"] * p
        chunks = int(getattr(p, "flax_chunks", 1))
        pn, un = _leaf_norms(p, chunks), _leaf_norms(u, chunks)
        ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                            pn / un)
        return u * ratio


_FACTORIES = {
    "sgd": lambda lr: lambda ps: torch.optim.SGD(
        ps, lr=lr if lr is not None else 0.01),
    "momentum": lambda lr: lambda ps: torch.optim.SGD(
        ps, lr=lr if lr is not None else 0.01, momentum=0.9),
    "adam": lambda lr: lambda ps: torch.optim.Adam(
        ps, lr=lr if lr is not None else 1e-3),
    "adamw": lambda lr: lambda ps: torch.optim.AdamW(
        ps, lr=lr if lr is not None else 1e-3, weight_decay=1e-4),
    "adamax": lambda lr: lambda ps: torch.optim.Adamax(
        ps, lr=lr if lr is not None else 2e-3),
    "nadam": lambda lr: lambda ps: NAdam(
        ps, lr=lr if lr is not None else 1e-3),
    "adagrad": lambda lr: lambda ps: Adagrad(
        ps, lr=lr if lr is not None else 1e-2),
    "adadelta": lambda lr: lambda ps: torch.optim.Adadelta(
        ps, lr=lr if lr is not None else 1.0, rho=0.9, eps=1e-6),
    "rmsprop": lambda lr: lambda ps: RMSprop(
        ps, lr=lr if lr is not None else 1e-3),
    "lamb": lambda lr: lambda ps: Lamb(
        ps, lr=lr if lr is not None else 1e-3),
}


def get_optimizer(opt: Union[str, Callable], lr: float = None) -> Callable:
    """A name (with ``lr``, or the reference's default rate for it) as a
    callable ``params -> torch.optim.Optimizer``; anything else (such a
    callable, or a learning rate) passes through to the Estimator."""
    if isinstance(opt, str):
        try:
            return _FACTORIES[opt.lower()](lr)
        except KeyError:
            raise ValueError(
                f"unknown optimizer {opt!r}; one of {sorted(_FACTORIES)}")
    return opt
