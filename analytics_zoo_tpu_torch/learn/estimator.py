"""Estimator: fit / evaluate / predict of a torch module on one device.

The port of ``analytics_zoo_tpu/learn/estimator.py`` (``FlaxEstimator``
and the ``Estimator`` facade) for a single device.  A torch
``nn.Module`` is native here, so ``Estimator.from_torch`` trains it as
it is, with no conversion.  The contract follows the reference:

- ``fit`` over a dict of numpy arrays: the batches of
  :class:`~analytics_zoo_tpu_torch.data.loader.NumpyBatchIterator`
  (shuffled with ``config.seed`` unless ``config.deterministic``,
  remainder dropped), one step ``loss_fn(model(*feats, train=True),
  labels)`` -> backward -> optimizer step (the reference's
  ``_train_step`` without the mesh), and a per-epoch history with the
  reference's keys: ``loss`` and the metrics (sample-weighted means),
  ``num_samples``, ``samples_per_sec`` and ``val_*`` for validation
  data.  Only callbacks that carry ``requests_stop`` may stop a fit.
- ``evaluate``: fixed-order chunks, the last padded with weight-0 rows;
  loss and metrics per sample (each row alone), weighted, under
  ``torch.no_grad()`` with ``train=False``.
- ``predict``: the concatenated outputs as numpy, padding rows dropped.

Metrics stay on the device through an epoch and come to the host once
at its end, so the step loop never waits on the card.  The estimator
moves the model to its device (``nn.Module.to``, in place).  Not ported
yet (ROADMAP Queue 1 item 7): ``save``/``load`` and checkpoints, LoRA,
``initial_variables`` (load weights into the model before handing it
over), XShards and DiskFeatureSet inputs, meshes and multi-host.
"""

from __future__ import annotations

import inspect
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.data.loader import NumpyBatchIterator
from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.learn.metrics import (EpochAccumulator,
                                                   resolve_metrics)
from analytics_zoo_tpu_torch.learn.objectives import get_loss

_DEFAULT_BATCH = 32     # the reference's batch size when none is given

# TrainConfig fields whose features are not ported yet, with the value
# that leaves them off: any other value would change a result or an
# output, so it raises rather than be ignored
_NOT_PORTED = {"checkpoint_dir": None, "tensorboard_dir": None,
               "metrics_jsonl": None, "profile": None,
               "fault_inject_step": 0, "debug_nans": False}


def _check_config(config: TrainConfig) -> None:
    bad = {n: getattr(config, n) for n, off in _NOT_PORTED.items()
           if getattr(config, n) != off}
    if int(config.accum_steps or 1) > 1:
        bad["accum_steps"] = config.accum_steps
    if bad:
        raise NotImplementedError(
            f"TrainConfig {bad} is not ported yet (ROADMAP Queue 1 item "
            f"7: gradient accumulation, checkpoints, summaries, profiling "
            f"and fault injection)")


def _model_accepts(model, kwarg: str) -> bool:
    try:
        return kwarg in inspect.signature(model.forward).parameters
    except (TypeError, ValueError):
        return False


def _to_arrays(data) -> Dict[str, np.ndarray]:
    if not isinstance(data, dict):
        raise TypeError(
            f"the port's Estimator takes a dict of numpy arrays, got "
            f"{type(data).__name__} (XShards, FeatureSet and creator "
            f"inputs are ROADMAP Queue 1 item 7)")
    return {k: np.asarray(v) for k, v in data.items()}


def _pad_batch(batch: Dict[str, np.ndarray], to: int):
    """Pad a chunk to ``to`` rows with zeros; weights 1 for its real
    rows and 0 for the padding."""
    n = len(next(iter(batch.values())))
    w = np.zeros(to, np.float32)
    w[:n] = 1.0
    if n == to:
        return batch, w
    out = {}
    for k, v in batch.items():
        pad = np.zeros((to - n,) + v.shape[1:], v.dtype)
        out[k] = np.concatenate([v, pad])
    return out, w


def _chunks(arrays: Dict[str, np.ndarray], size: int):
    n = len(next(iter(arrays.values())))
    for lo in range(0, n, size):
        yield {k: v[lo:lo + size] for k, v in arrays.items()}


def _fetch_stacked(mets_list) -> Dict[str, np.ndarray]:
    """Per-step scalar-metric dicts as one ``(n,)`` numpy array per
    metric: one device-to-host copy each."""
    return {k: torch.stack([m[k] for m in mets_list]).float().cpu().numpy()
            for k in mets_list[0]}


def _route_train_config(config, kw):
    """``config`` on the facade is the reference's model-creator config
    dict; a TrainConfig passed there is meant for the estimator."""
    if isinstance(config, TrainConfig):
        kw.setdefault("config", config)
        return None
    return config


class TorchEstimator:
    """Train/eval/predict a torch module on one device.

    Args:
      model: torch ``nn.Module``; its ``forward`` takes the feature
        columns positionally (and ``train`` if it declares it).
      loss: name or callable ``(preds, labels) -> scalar``.
      optimizer: a learning-rate float (``torch.optim.Adam(params, lr)``,
        as the reference's float means ``optax.adam(lr)``: both b1 0.9,
        b2 0.999, eps 1e-8), or a callable ``params -> Optimizer``.
      metrics: names or callables evaluated on (preds, labels).
      feature_cols / label_cols: which batch keys feed the model / loss.
      config: :class:`TrainConfig`.
      device: where to train; ``None`` means CUDA and raises without it
        (:func:`~analytics_zoo_tpu_torch.device.resolve_device`).
    """

    def __init__(self, model, loss: Union[str, Callable], optimizer, *,
                 metrics: Sequence[Union[str, Callable]] = (),
                 feature_cols: Sequence[str] = ("x",),
                 label_cols: Sequence[str] = ("y",),
                 config: Optional[TrainConfig] = None, device=None):
        self.config = config or TrainConfig()
        _check_config(self.config)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = get_loss(loss)
        params = list(self.model.parameters())
        if isinstance(optimizer, (int, float)):
            self.optimizer = torch.optim.Adam(params, lr=float(optimizer))
        elif callable(optimizer):
            self.optimizer = optimizer(params)
        else:
            raise TypeError(f"optimizer must be a learning rate or a "
                            f"callable params -> torch.optim.Optimizer, "
                            f"got {type(optimizer).__name__}")
        self.metric_fns = resolve_metrics(metrics)
        self.feature_cols = tuple(feature_cols)
        self.label_cols = tuple(label_cols)
        self._takes_train = _model_accepts(self.model, "train")
        self._epoch = 0
        self._global_step = 0

    def _set_cols(self, feature_cols, label_cols):
        if feature_cols:
            self.feature_cols = tuple(feature_cols)
        if label_cols:
            self.label_cols = tuple(label_cols)

    def _on_device(self, batch: Dict[str, np.ndarray]):
        return {k: torch.as_tensor(np.ascontiguousarray(v),
                                   device=self.device)
                for k, v in batch.items()}

    def _forward(self, batch, train: bool):
        kw = {"train": train} if self._takes_train else {}
        return self.model(*[batch[c] for c in self.feature_cols], **kw)

    def _labels(self, batch):
        ys = [batch[c] for c in self.label_cols]
        return ys[0] if len(ys) == 1 else tuple(ys)

    def _train_step(self, batch) -> Dict[str, torch.Tensor]:
        labels = self._labels(batch)
        self.optimizer.zero_grad(set_to_none=True)
        preds = self._forward(batch, train=True)
        loss = self.loss_fn(preds, labels)
        loss.backward()
        self.optimizer.step()
        with torch.no_grad():
            mets = {"loss": loss.detach()}
            for name, fn in self.metric_fns:
                mets[name] = fn(preds.detach(), labels)
        return mets

    @torch.no_grad()
    def _eval_step(self, batch, weights) -> Dict[str, torch.Tensor]:
        """Per-sample losses and metrics (each row alone, as the
        reference's singleton-batch vmap), weighted by ``weights`` (0 for
        padding rows)."""
        preds = self._forward(batch, train=False)
        labels = self._labels(batch)

        def per_sample(fn):
            rows = []
            for i in range(preds.shape[0]):
                lab = tuple(x[i:i + 1] for x in labels) \
                    if isinstance(labels, tuple) else labels[i:i + 1]
                rows.append(fn(preds[i:i + 1], lab))
            return torch.stack(rows).float()

        denom = torch.clamp(weights.sum(), min=1.0)
        mets = {"loss": (per_sample(self.loss_fn) * weights).sum() / denom}
        for name, fn in self.metric_fns:
            mets[name] = (per_sample(fn) * weights).sum() / denom
        return mets

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None,
            validation_data=None,
            feature_cols: Optional[Sequence[str]] = None,
            label_cols: Optional[Sequence[str]] = None,
            callbacks: Sequence[Callable[[Dict], object]] = ()
            ) -> List[Dict[str, float]]:
        """Train for ``epochs`` epochs of ``batch_size`` rows; returns
        the per-epoch stats dicts."""
        _check_config(self.config)
        batch_size = batch_size or _DEFAULT_BATCH
        self._set_cols(feature_cols, label_cols)
        it = NumpyBatchIterator(
            _to_arrays(data), batch_size,
            shuffle=not self.config.deterministic, drop_remainder=True,
            seed=self.config.seed)
        for cb in callbacks:
            # stop-requesting callbacks restart fresh per fit
            if getattr(cb, "requests_stop", False):
                getattr(cb, "reset", lambda: None)()
        history: List[Dict[str, float]] = []
        for _ in range(epochs):
            self.model.train()
            t0 = time.perf_counter()
            step_mets = [self._train_step(self._on_device(b))
                         for b in it.epoch_batches()]
            self._global_step += len(step_mets)
            acc = EpochAccumulator()
            if step_mets:
                # the epoch barrier: one fetch per metric, which waits
                # for the last step to finish on the card
                fetched = _fetch_stacked(step_mets)
                for i in range(len(step_mets)):
                    acc.add({k: float(v[i]) for k, v in fetched.items()},
                            batch_size)
            dt = time.perf_counter() - t0
            self._epoch += 1
            n = len(step_mets) * batch_size
            stats = acc.result()
            stats["num_samples"] = float(n)
            stats["samples_per_sec"] = n / dt if dt else 0
            if validation_data is not None:
                val = self.evaluate(validation_data, batch_size=batch_size)
                stats.update({f"val_{k}": v for k, v in val.items()})
            stop = False
            for cb in callbacks:
                ret = cb({"epoch": self._epoch, **stats})
                # only callbacks that opt in (requests_stop) may stop
                # training through their return value
                if getattr(cb, "requests_stop", False):
                    stop = bool(ret) or stop
            history.append(stats)
            if stop:
                break
        return history

    def evaluate(self, data, batch_size: Optional[int] = None,
                 feature_cols=None, label_cols=None) -> Dict[str, float]:
        """Loss and metrics over every row of ``data``, sample-weighted."""
        _check_config(self.config)
        batch_size = batch_size or _DEFAULT_BATCH
        self._set_cols(feature_cols, label_cols)
        self.model.eval()
        mets_list, counts = [], []
        for chunk in _chunks(_to_arrays(data), batch_size):
            counts.append(len(next(iter(chunk.values()))))
            chunk, w = _pad_batch(chunk, batch_size)
            mets_list.append(self._eval_step(
                self._on_device(chunk),
                torch.as_tensor(w, device=self.device)))
        acc = EpochAccumulator()
        if mets_list:
            fetched = _fetch_stacked(mets_list)
            for i, cnt in enumerate(counts):
                acc.add({k: float(v[i]) for k, v in fetched.items()}, cnt)
        return acc.result()

    @torch.no_grad()
    def predict(self, data, batch_size: Optional[int] = None,
                feature_cols=None) -> np.ndarray:
        """The model's outputs for every row of ``data``, as numpy (a
        bf16 output comes back as f32: numpy has no bf16)."""
        _check_config(self.config)
        batch_size = batch_size or _DEFAULT_BATCH
        self._set_cols(feature_cols, None)
        arrays = _to_arrays(data)
        for c in self.feature_cols:
            if c not in arrays:
                raise KeyError(f"feature col {c!r} missing from predict "
                               f"data")
        self.model.eval()
        outs = []
        for chunk in _chunks({c: arrays[c] for c in self.feature_cols},
                             batch_size):
            real = len(next(iter(chunk.values())))
            chunk, _ = _pad_batch(chunk, batch_size)
            preds = self._forward(self._on_device(chunk), train=False)
            if preds.dtype == torch.bfloat16:
                preds = preds.float()
            outs.append(preds[:real].cpu())
        return torch.cat(outs).numpy()


class Estimator:
    """Constructor facade: the reference's ``Estimator.from_torch``."""

    @staticmethod
    def from_torch(*, model=None, model_creator=None, loss=None,
                   optimizer=None, config: Optional[dict] = None,
                   **kw) -> TorchEstimator:
        """A :class:`TorchEstimator` for ``model`` (or
        ``model_creator(config)``).  ``optimizer`` defaults to Adam at
        1e-3 and ``loss`` to ``"mse"``, as in the reference; a
        :class:`TrainConfig` passed as ``config`` goes to the
        estimator."""
        config = _route_train_config(config, kw)
        if model is None:
            if model_creator is None:
                raise ValueError("need model or model_creator")
            model = model_creator(config or {})
        if optimizer is None:
            optimizer = 1e-3
        return TorchEstimator(model, loss or "mse", optimizer, **kw)
