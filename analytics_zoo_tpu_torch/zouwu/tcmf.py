"""TCMFForecaster: temporal-convolutional matrix factorisation, the port
of ``analytics_zoo_tpu/zouwu/tcmf.py``.

Many series ``Y [n, T]`` are factorised ``Y ~ F [n, k] @ X [k, T]``; a
temporal conv net (``models.forecast.TCN``, bf16 as in the reference)
learns to roll the basis ``X`` forward, and a forecast is ``F @ X̂``.

- ``fit``: the joint reconstruction of ``F`` and ``X`` (NaNs masked out
  of the loss, which is the masked squared error over the observed
  count and the series' variance, plus ``l2`` times the factors' mean
  squares) by Adam at ``lr`` for ``epochs`` full steps; then the TCN by
  Adam on every window of ``X`` for ``tcn_epochs`` full-batch steps.
  Adam is optax's ``adam(lr)`` written out (b1 0.9, b2 0.999, eps 1e-8,
  the same operations in the same order), not ``torch.optim.Adam``.
- ``series_block=B`` streams the reconstruction by blocks of ``B``
  series: ``F``, its Adam moments and ``Y`` stay in host memory, one
  block at a time goes to the device, every gradient is taken at the
  epoch's starting values (``dF`` of a block from that block alone,
  ``dX`` summed over the blocks) and X steps once an epoch, so it is
  the dense update up to the order of float sums.
- ``predict(horizon)``: the TCN rolls the last ``window`` columns of
  ``X`` forward step by step (a Python loop for the reference's
  ``lax.scan``), then ``F @ X̂`` in numpy.
- ``save``/``load``: the reference's ``tcmf.pkl`` (the config, ``F`` and
  ``X`` as numpy, the TCN's parameters as the reference's flax tree of
  numpy arrays), so each package reads the other's file.

After ``fit`` or ``load``, ``F`` and ``X`` are host numpy arrays.  The
reference draws the initial ``F``, ``X`` and TCN weights from
``jax.random``; the port draws them from ``torch`` seeded with
``seed``, and ``_fit`` takes them as they are (the tests feed it the
reference's draws).  ``device`` (the port's addition) is where it runs:
``cuda`` unless the caller names another or a context says so.
"""

from __future__ import annotations

import gc
import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.log import logger
from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.forecast import TCN
from analytics_zoo_tpu_torch.models.layers import params_from_flax

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _adam(p, g, m, v, count: int, lr: float):
    """optax ``adam(lr)``'s update of ``p`` by gradient ``g`` after
    ``count`` updates, with moments ``m`` and ``v``: returns the new
    ``(p, m, v)``."""
    m = (1 - _B1) * g + _B1 * m
    v = (1 - _B2) * (g * g) + _B2 * v
    # the bias corrections in f32, as optax computes them
    t = np.float32(count + 1)
    bc1 = float(np.float32(1) - np.float32(_B1) ** t)
    bc2 = float(np.float32(1) - np.float32(_B2) ** t)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + _EPS)
    return p + upd * (-lr), m, v


def _flax_tree(state: Dict[str, torch.Tensor]) -> Dict:
    """A TCN's ``state_dict`` as the reference's flax tree of numpy
    arrays (the inverse of ``params_from_flax`` for a TCN)."""
    tree: Dict = {}
    for key, t in state.items():
        *path, leaf = key.split(".")
        a = t.detach().float().cpu().numpy()
        if leaf == "weight":
            leaf, a = "kernel", a.T if a.ndim == 2 else a.transpose(2, 1, 0)
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


class TCMFForecaster:
    """The reference's ``TCMFForecaster`` (fit / predict / evaluate /
    save / load).

    Args:
      rank: the latent dimension k.
      window: the TCN's look-back over the basis X.
      l2: the factors' regularisation weight.
      tcn_channels, lr, seed: the TCN's widths, Adam's rate, the seed.
      series_block: stream the reconstruction by blocks of this many
        series (None: the whole matrix at once).
      collect_memory_stats: record ``peak_device_elems``, the largest
        single device tensor alive during a streamed fit that the fit
        made (a scan of live objects a block; costly, opt-in).
      device: where to run (None: ``cuda``, or the context's device).
    """

    def __init__(self, rank: int = 16, window: int = 24, l2: float = 1e-4,
                 tcn_channels=(32, 32), lr: float = 1e-2, seed: int = 0,
                 series_block: Optional[int] = None,
                 collect_memory_stats: bool = False, device=None):
        self.rank = rank
        self.window = window
        self.l2 = l2
        self.tcn_channels = tuple(tcn_channels)
        self.lr = lr
        self.seed = seed
        self.series_block = series_block
        self.device = resolve_device(device)
        self.F: Optional[np.ndarray] = None     # [n, k], host
        self.X: Optional[np.ndarray] = None     # [k, T], host
        self._tcn: Optional[TCN] = None
        self.collect_memory_stats = collect_memory_stats
        self.peak_device_elems: Optional[int] = None

    def _new_tcn(self) -> TCN:
        return TCN(output_dim=self.rank, horizon=1, dropout=0.0,
                   channels=self.tcn_channels, input_dim=self.rank)

    # ------------------------------------------------------------------

    def fit(self, y: np.ndarray, *, epochs: int = 300,
            tcn_epochs: int = 200, verbose: bool = False) -> Dict:
        """y: ``[n_series, T]`` (NaNs are left out of the
        reconstruction's loss).  Returns ``{"recon_loss", "tcn_loss"}``,
        each at the start of its last step."""
        y = np.asarray(y, np.float32)
        if y.ndim != 2:
            raise ValueError(f"y must be [n_series, T], got {y.shape}")
        n, T = y.shape
        if T <= self.window + 1:
            raise ValueError(f"series length {T} must exceed window+1="
                             f"{self.window + 1}")
        gen = torch.Generator().manual_seed(int(self.seed))
        F0 = torch.randn(n, self.rank, generator=gen) * 0.1
        X0 = torch.randn(self.rank, T, generator=gen) * 0.1
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(self.seed))
            tcn_state = self._new_tcn().state_dict()
        return self._fit(y, F0.numpy(), X0.numpy(), tcn_state, epochs,
                         tcn_epochs, verbose)

    def _fit(self, y, F0, X0, tcn_state, epochs, tcn_epochs,
             verbose=False) -> Dict:
        """``fit`` from the initial ``F0 [n, k]``, ``X0 [k, T]`` and TCN
        ``state_dict`` given."""
        y = np.asarray(y, np.float32)
        scale = float(np.nanstd(y) or 1.0)
        X0 = torch.as_tensor(np.array(X0, np.float32), device=self.device)
        F0 = np.array(F0, np.float32)
        if self.series_block:
            recon = self._fit_recon_streamed(y, X0, F0, epochs, scale,
                                             verbose)
        else:
            recon = self._fit_recon_dense(y, X0, F0, epochs, scale,
                                          verbose)

        # ---- dynamics: the TCN over the basis ------------------------
        from analytics_zoo_tpu_torch.zouwu.preprocessing import roll

        tcn = self._new_tcn()
        tcn.load_state_dict(tcn_state)
        self._tcn = tcn.to(self.device)
        xs, ys = roll(self.X.T, lookback=self.window, horizon=1)
        xb = torch.as_tensor(xs, device=self.device)
        yb = torch.as_tensor(ys, device=self.device)
        params = list(tcn.parameters())
        moments = [(torch.zeros_like(p), torch.zeros_like(p))
                   for p in params]
        tloss = None
        for ep in range(tcn_epochs):
            loss = torch.mean((tcn(xb) - yb) ** 2)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for i, (p, g) in enumerate(zip(params, grads)):
                    new, m, v = _adam(p, g, *moments[i], ep, self.lr)
                    p.copy_(new)
                    moments[i] = (m, v)
            tloss = loss.detach()
        stats = {"recon_loss": recon,
                 "tcn_loss": None if tloss is None else float(tloss)}
        logger.info("TCMF fit done: %s", stats)
        return stats

    # ------------------------------------------------------------------
    # reconstruction backends
    # ------------------------------------------------------------------

    def _fit_recon_dense(self, y, X, F0, epochs, scale, verbose) -> float:
        """The whole matrix on the device, gradients by autograd."""
        dev = self.device
        mask = torch.as_tensor(~np.isnan(y), device=dev)
        yj = torch.as_tensor(np.nan_to_num(y), device=dev)
        denom = max(1, int(mask.sum()))
        F = torch.as_tensor(F0, device=dev)
        state = [(torch.zeros_like(F), torch.zeros_like(F)),
                 (torch.zeros_like(X), torch.zeros_like(X))]
        loss = None
        for ep in range(epochs):
            F.requires_grad_(True)
            X.requires_grad_(True)
            err = torch.where(mask, yj - F @ X, 0.0)
            loss = (torch.sum(err * err) / denom / (scale * scale)
                    + self.l2 * (torch.mean(F * F) + torch.mean(X * X)))
            gF, gX = torch.autograd.grad(loss, (F, X))
            with torch.no_grad():
                F, mF, vF = _adam(F.detach(), gF, *state[0], ep, self.lr)
                X, mX, vX = _adam(X.detach(), gX, *state[1], ep, self.lr)
            state = [(mF, vF), (mX, vX)]
            if verbose and (ep + 1) % 50 == 0:
                logger.info("tcmf recon %d: %.5f", ep + 1, float(loss))
        self.F = F.detach().cpu().numpy()
        self.X = X.detach().cpu().numpy()
        return float(loss.detach())

    def _fit_recon_streamed(self, y, X, F0, epochs, scale,
                            verbose) -> float:
        """The same update by row blocks: ``Y``, ``F`` and ``F``'s Adam
        moments in host memory, one block of each on the device at a
        time, ``dX`` summed over the blocks and ``X`` stepped once an
        epoch.  The gradients are the dense loss's, written out."""
        n, T = y.shape
        k, B = self.rank, int(self.series_block)
        dev = self.device
        mask_np = ~np.isnan(y)
        denom = float(max(1, mask_np.sum()))
        y = np.nan_to_num(y)
        sc2 = scale * scale
        F = F0.copy()
        mF = np.zeros((n, k), np.float32)
        vF = np.zeros((n, k), np.float32)
        mX, vX = torch.zeros_like(X), torch.zeros_like(X)
        baseline = set()
        peak = 0
        if self.collect_memory_stats:
            baseline = {id(t) for t in _device_tensors(dev)}
        loss = None
        for ep in range(epochs):
            gX = torch.zeros_like(X)
            total = torch.zeros((), device=dev)
            for lo in range(0, n, B):
                hi = min(lo + B, n)
                Fb = torch.as_tensor(F[lo:hi], device=dev)
                yb = torch.as_tensor(y[lo:hi], device=dev)
                maskb = torch.as_tensor(mask_np[lo:hi], device=dev)
                err = torch.where(maskb, yb - Fb @ X, 0.0)
                total = total + (torch.sum(err * err) / denom / sc2
                                 + self.l2 * torch.sum(Fb * Fb) / (n * k))
                gFb = (-2.0 / denom / sc2) * (err @ X.T) \
                    + self.l2 * 2.0 * Fb / (n * k)
                gX = gX + (-2.0 / denom / sc2) * (Fb.T @ err)
                Fb, mb, vb = _adam(
                    Fb, gFb, torch.as_tensor(mF[lo:hi], device=dev),
                    torch.as_tensor(vF[lo:hi], device=dev), ep, self.lr)
                if self.collect_memory_stats:
                    peak = max(peak, max(
                        (t.numel() for t in _device_tensors(dev)
                         if id(t) not in baseline), default=0))
                F[lo:hi] = Fb.cpu().numpy()
                mF[lo:hi] = mb.cpu().numpy()
                vF[lo:hi] = vb.cpu().numpy()
            # the loss at the epoch's starting values, X's l2 term added
            # before X steps
            loss = total + self.l2 * torch.mean(X * X)
            gX = gX + self.l2 * 2.0 * X / (k * T)
            X, mX, vX = _adam(X, gX, mX, vX, ep, self.lr)
            if verbose and (ep + 1) % 50 == 0:
                logger.info("tcmf recon %d (streamed): %.5f", ep + 1,
                            float(loss))
        self.F, self.X = F, X.cpu().numpy()
        if self.collect_memory_stats:
            self.peak_device_elems = int(peak)
        return float(loss)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def predict(self, horizon: int = 24) -> np.ndarray:
        """Roll the basis forward ``horizon`` steps; returns ``[n,
        horizon]``."""
        if self.F is None:
            raise RuntimeError("fit first")
        window = torch.as_tensor(np.ascontiguousarray(
            self.X.T[-self.window:]), device=self.device)     # [w, k]
        steps = []
        for _ in range(horizon):
            nxt = self._tcn(window[None])[0, -1]             # [k]
            window = torch.cat([window[1:], nxt[None]])
            steps.append(nxt)
        xs = torch.stack(steps).cpu().numpy()                # [h, k]
        return np.asarray(self.F) @ xs.T                     # [n, h]

    def evaluate(self, y_true: np.ndarray,
                 metrics=("mse",)) -> Dict[str, float]:
        pred = self.predict(y_true.shape[1])
        out = {}
        for m in metrics:
            if m == "mse":
                out[m] = float(np.mean((pred - y_true) ** 2))
            elif m == "mae":
                out[m] = float(np.mean(np.abs(pred - y_true)))
            elif m == "smape":
                out[m] = float(np.mean(
                    2 * np.abs(pred - y_true)
                    / (np.abs(pred) + np.abs(y_true) + 1e-8)))
            else:
                raise ValueError(f"unknown metric {m}")
        return out

    # ------------------------------------------------------------------

    def save(self, path: str):
        """Write ``path/tcmf.pkl`` in the reference's layout."""
        os.makedirs(path, exist_ok=True)
        blob = {"cfg": (self.rank, self.window, self.l2, self.tcn_channels,
                        self.lr, self.seed, self.series_block),
                "F": np.asarray(self.F), "X": np.asarray(self.X),
                "tcn_params": _flax_tree(self._tcn.state_dict())}
        with open(os.path.join(path, "tcmf.pkl"), "wb") as f:
            pickle.dump(blob, f)

    @staticmethod
    def load(path: str, device=None) -> "TCMFForecaster":
        """Read a ``tcmf.pkl``, the port's or the reference's."""
        with open(os.path.join(path, "tcmf.pkl"), "rb") as f:
            blob = pickle.load(f)
        cfg = blob["cfg"]
        sb = cfg[6] if len(cfg) > 6 else None   # files from before
        rank, window, l2, chans, lr, seed = cfg[:6]
        fc = TCMFForecaster(rank=rank, window=window, l2=l2,
                            tcn_channels=chans, lr=lr, seed=seed,
                            series_block=sb, device=device)
        fc.F = np.asarray(blob["F"], np.float32)
        fc.X = np.asarray(blob["X"], np.float32)
        tcn = fc._new_tcn()
        tcn.load_state_dict(params_from_flax(blob["tcn_params"]))
        fc._tcn = tcn.to(fc.device)
        return fc


def _device_tensors(dev: torch.device):
    """Every live tensor on ``dev`` that the garbage collector tracks."""
    for obj in gc.get_objects():
        if issubclass(type(obj), torch.Tensor) and obj.device == dev:
            yield obj
