"""Estimator: fit / evaluate / predict of a torch module on one device.

The port of ``analytics_zoo_tpu/learn/estimator.py`` (``FlaxEstimator``
and the ``Estimator`` facade) for a single device.  A torch
``nn.Module`` is native here, so ``Estimator.from_torch`` trains it as
it is, with no conversion.  The contract follows the reference:

- Inputs: what the reference's take, normalised by
  :class:`~analytics_zoo_tpu_torch.data.loader.DataCreator`: a dict of
  numpy arrays, an ``(x, y)`` pair, an ``XShards``, a ``FeatureSet``, a
  callable ``config -> one of those``, or a ``DiskFeatureSet``, which
  ``fit`` streams by shuffled row blocks through the native prefetch
  thread and ``evaluate``/``predict`` read block by block in order.
- ``fit``: the batches of
  :class:`~analytics_zoo_tpu_torch.data.loader.NumpyBatchIterator`
  (shuffled with ``config.seed`` unless ``config.deterministic``,
  remainder dropped), one step ``loss_fn(model(*feats, train=True),
  labels)`` -> backward -> optimizer step (the reference's
  ``_train_step`` without the mesh), and a per-epoch history with the
  reference's keys: ``loss`` and the metrics (sample-weighted means),
  ``num_samples``, ``samples_per_sec`` and ``val_*`` for validation
  data.  Only callbacks that carry ``requests_stop`` may stop a fit.
- ``config.accum_steps = n`` (the reference's ``_train_step_accum``):
  a batch runs as ``n`` micro-batches of ``batch / n`` rows in order,
  each forward and backward on the same parameters, the summed
  gradients divided by ``n`` feed one optimizer step; the loss is the
  micro-batches' mean and the metrics see every row.  A batch ``n``
  does not divide raises.
- BatchNorm state (the reference's ``batch_stats``) lives in the
  model's buffers: a training forward (``train=True``) updates them, in
  order micro-batch by micro-batch; ``evaluate`` and ``predict`` call
  ``train=False`` and leave them as they are; checkpoints and exports
  carry them with the ``state_dict``.
- ``evaluate``: fixed-order chunks, the last padded with weight-0 rows;
  loss and metrics per sample (each row alone), weighted, under
  ``torch.no_grad()`` with ``train=False``.
- ``predict``: the concatenated outputs as numpy, padding rows dropped.

- Dropout: a model whose ``forward`` takes ``rng`` gets the step's seed
  ``fold_in(seed, step)`` in a training step (``seed`` is
  ``config.seed``, ``step`` the global step before the update), the
  reference's ``fold_in(rng, step)``; see ``models.transformer``.
- Checkpoints (``config.checkpoint_dir``): ``checkpoint_trigger``
  (default ``EveryEpoch``, or every ``checkpoint_every_steps`` steps as
  well when that is above 0) saves after a step or an epoch;
  ``keep_checkpoints`` newest are kept; ``fit(auto_resume=True)``
  restores the newest and trains the remaining epochs, continuing the
  shuffle schedule (epoch-granular, as in the reference);
  ``save``/``load`` export and restore the model's weights alone.

The checkpoint format is the port's own, not orbax's: one directory
``ckpt_<step>`` a checkpoint, holding ``state.pt``, a ``torch.save`` of
the model's and the optimizer's ``state_dict``s, the step, the epoch
and the dropout seed; ``save`` writes ``model.pt`` (the model's
``state_dict``) into its directory.  The two packages' checkpoints are
not interchangeable: weights cross from the reference only through
``params_from_flax``.

- ``initial_variables``: a port ``state_dict`` (or ``{"params":
  state_dict, ...}``, whose other entries, such as running statistics,
  join it) loaded into the model before it moves to its device.  The
  keys and shapes must be the model's, and a model with buffers
  (BatchNorm's running statistics) must get them: either mismatch
  raises ``ValueError``, as the reference's seeding does.  Adapter
  entries of a LoRA export (``"__lora__"``) are dropped.
- ``lora=LoRAConfig(...)`` (``learn/lora.py``): the optimizer (a
  learning rate, or the callable) gets the adapters alone, and every
  forward and backward runs on the merged weights with the base frozen
  for its length; the module's own ``requires_grad`` flags are left as
  they were.  :meth:`TorchEstimator.lora_params` returns the
  adapters, :meth:`TorchEstimator.merged_params` a plain
  ``state_dict`` with them folded in; checkpoints, exports and
  ``get_model`` carry the adapters under ``"__lora__"``.
- Observability (the reference's ``fit``): ``metrics_jsonl`` and
  ``tensorboard_dir`` (:meth:`TorchEstimator.set_tensorboard`) receive
  the step's metrics every ``log_every_steps`` steps, fetched to the
  host in one copy there and never between; ``profile = (logdir,
  start_step, n_steps)`` (:meth:`TorchEstimator.set_profile`) traces
  ``n_steps`` steps from global step ``start_step`` with
  ``torch.profiler`` (``common/log.py``), and a fault stops the trace;
  ``fault_inject_step = N`` raises ``RuntimeError`` right after step
  N, before that step's checkpoint trigger; ``debug_nans`` checks the
  loss and the gradients of every step before the optimizer steps and
  raises ``FloatingPointError`` naming the step, so the parameters
  stay those of the step before (one sync a step, in this mode only).

Metrics stay on the device through an epoch and come to the host once
at its end and at the log points, so the step loop never waits on the
card otherwise.  The estimator moves the model to its device
(``nn.Module.to``, in place).

Data-parallel training (the reference's dp mesh): ``mesh`` (default:
the running context's, ``init_orca_context("distributed",
mesh_axes={"dp": -1})`` under ``torchrun``) with a ``dp`` axis above 1
runs one process a rank, every rank with the same data, seed and
model.  The ranks start from rank 0's parameters and buffers
(broadcast); each takes its rows of every global batch (a global batch
the data-shard groups do not divide raises the reference's message);
the gradients are all-reduced and averaged before the optimizer steps
(one coalesced ``all_reduce``; buffers are never broadcast again);
losses and metrics are global means.  Dropout draws the global batch's
mask from the step's generator and each rank keeps its rows, and
``BatchNorm`` all-reduces its statistics' sums, so dp=N trains what
dp=1 trains.  ``evaluate`` splits each padded chunk over the ranks and
adds their weighted sums; ``predict`` gathers every rank's rows and
returns them in global order on every rank.  Rank 0 writes checkpoints
and exports (the others wait for it), and every rank restores them.  A
``DiskFeatureSet`` is host-local: each rank streams its own shard (a
``{host}`` path), as many steps as the smallest shard gives, and
evaluates and predicts its own rows.

Tensor- and sequence-parallel training (the reference's ``tp`` and
``sp`` axes, with or without ``dp``): ``partition_rules`` (the
reference's rules over its parameter tree, ``DP_RULES`` by default; a
``lora`` config puts ``LORA_RULES`` ahead of them, so the adapters
replicate) cut the model's parameters to each rank's shards
(``parallel.partition.shard_module``) after every rank has taken rank
0's weights; the model's own layers run the collectives, with the
conjugate gradients of ``parallel.collectives`` (BERT and
``TransformerLM`` in Megatron's layout, vocab-parallel embedding
tables elsewhere), and a model built with ``mesh=`` splits the
sequence over ``sp``.  The ranks that share a dp coordinate take the
same rows.  Gradients are averaged over dp x sp (the sp convention of
``parallel.collectives``); a tp rank's gradients are its shards' and
replicated parameters' own, equal on every tp rank.  Checkpoints and
exports hold whole tensors in the tp=1 layout, the optimizer's state
included (rank 0 writes what the ranks gather), so a checkpoint
restores onto any mesh, and ``get_model``/``merged_params`` return
whole tensors.  FSDP (item 6.1), pipeline and expert axes (item 9)
raise.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import re
import shutil
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.config import TrainConfig
from analytics_zoo_tpu_torch.common.log import (MetricLogger, logger,
                                             start_profiler_trace,
                                             stop_profiler_trace)
from analytics_zoo_tpu_torch.data.feature_set import DiskFeatureSet
from analytics_zoo_tpu_torch.data.loader import (DataCreator,
                                                 NumpyBatchIterator)
from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.learn.lora import (LORA_KEY, LORA_RULES,
                                                LoRAConfig, adapter_params,
                                                init_lora, merged_state,
                                                merged_weights)
from analytics_zoo_tpu_torch.learn.metrics import (EpochAccumulator,
                                                   resolve_metrics)
from analytics_zoo_tpu_torch.learn.objectives import get_loss
from analytics_zoo_tpu_torch.learn.triggers import (EveryEpoch,
                                                    SeveralIteration, Trigger)
from analytics_zoo_tpu_torch.models.layers import flax_leaf
from analytics_zoo_tpu_torch.models.transformer import fold_in
from analytics_zoo_tpu_torch.parallel import data_parallel as dp
from analytics_zoo_tpu_torch.parallel.partition import (
    DP_RULES, P, check_rules, gather_state, gather_tensor, shard_module,
    shard_state, shard_tensor)

def _resolve_batch(batch_size, data, attr: str) -> int:
    """Explicit batch_size wins; otherwise the data container's own
    metadata (TFDataset carries the reference's batch_size /
    batch_per_thread); otherwise the historical default of 32."""
    if batch_size is not None:
        return batch_size
    meta = getattr(data, attr, None)
    if isinstance(meta, int) and meta > 0:
        return meta
    return 32

_CKPT_DIR = re.compile(r"^ckpt_(\d+)$")
_CKPT_FILE = "state.pt"
_MODEL_FILE = "model.pt"


def _accum_steps(config: TrainConfig) -> int:
    return max(1, int(config.accum_steps or 1))


def _model_accepts(model, kwarg: str) -> bool:
    try:
        return kwarg in inspect.signature(model.forward).parameters
    except (TypeError, ValueError):
        return False


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


def _chunks(data, size: int):
    """``data``'s rows in order, ``size`` at a time (the last chunk
    short): a ``DiskFeatureSet`` block by block, anything else through
    ``DataCreator``."""
    if isinstance(data, DiskFeatureSet):
        yield from data.batches(size, shuffle=False, drop_remainder=False)
        return
    arrays = DataCreator.to_arrays(data)
    n = len(next(iter(arrays.values())))
    for lo in range(0, n, size):
        yield {k: v[lo:lo + size] for k, v in arrays.items()}


class _MinSteps:
    """An epoch iterator cut to ``steps`` batches an epoch (host-local
    shards: every rank runs the smallest shard's step count)."""

    def __init__(self, it, steps: int):
        self.it, self.steps = it, int(steps)

    @property
    def epoch(self):
        return self.it.epoch

    @epoch.setter
    def epoch(self, v):
        self.it.epoch = v

    def steps_per_epoch(self) -> int:
        return self.steps

    def epoch_batches(self):
        for i, b in enumerate(self.it.epoch_batches()):
            if i >= self.steps:
                return
            yield b


def _fetch_stacked(mets_list) -> Dict[str, np.ndarray]:
    """Per-step scalar-metric dicts as one ``(n,)`` numpy array per
    metric: one device-to-host copy each."""
    return {k: torch.stack([m[k] for m in mets_list]).float().cpu().numpy()
            for k in mets_list[0]}


def _fetch_one(mets: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One step's scalar metrics as floats: one device-to-host copy."""
    names = list(mets)
    vals = torch.stack([mets[k].detach().float().reshape(())
                        for k in names]).cpu().tolist()
    return dict(zip(names, vals))


def load_initial_variables(model, variables) -> None:
    """Load ``variables`` (a port ``state_dict``, or ``{"params":
    state_dict, ...}`` whose other mapping entries join it) into
    ``model``, failing loud as the reference's seeding does: a key or
    shape mismatch raises ``ValueError``, and so does a source without
    the model's buffers (BatchNorm's running statistics).  An adapter
    entry (``"__lora__"``) is dropped."""
    src = dict(variables)
    if isinstance(src.get("params"), Mapping):
        extra = {k: v for k, v in src.items() if k != "params"}
        src = dict(src["params"])
        for k, v in extra.items():
            if k != LORA_KEY and isinstance(v, Mapping):
                src.update(v)
    src.pop(LORA_KEY, None)
    want = model.state_dict()
    buffers = {n for n, _ in model.named_buffers() if n in want}
    missing, unexpected = set(want) - set(src), set(src) - set(want)
    if unexpected or missing - buffers or any(
            tuple(np.shape(src[k])) != tuple(want[k].shape)
            for k in set(want) & set(src)):
        raise ValueError(
            f"initial_variables do not match the model's parameters "
            f"(missing {sorted(missing)[:4]}, unexpected "
            f"{sorted(unexpected)[:4]}, or shapes differ): wrong "
            f"checkpoint for this architecture?")
    if missing:
        raise ValueError(
            f"this model carries batch_stats (BatchNorm running "
            f"statistics {sorted(missing)[:4]}); initial_variables must "
            f"include them (pass the full state_dict, not just the "
            f"parameters): fresh statistics under pretrained weights "
            f"would silently corrupt inference")
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           if not isinstance(v, torch.Tensor) else v
                           for k, v in src.items()})


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
      lora: a :class:`~analytics_zoo_tpu_torch.learn.lora.LoRAConfig` to
        train rank-r adapters on the frozen model.
      initial_variables: weights loaded into the model before training
        (see the module docstring).
      param_loss: a callable ``model -> scalar`` added to the training
        loss of every step (each micro-batch's) and to ``evaluate``'s
        loss, as the reference adds its ``param_loss(params)`` (the
        Keras API's regularizer penalty).
      partition_rules: the reference's ``(path regex, placement)`` rules
        for a mesh with a ``tp`` axis (see the module docstring).
      mesh: the training mesh (default: the running context's).

    The optimizer receives the parameters that train: the adapters under
    ``lora``, else the model's parameters that require a gradient.
    """

    def __init__(self, model, loss: Union[str, Callable], optimizer, *,
                 metrics: Sequence[Union[str, Callable]] = (),
                 feature_cols: Sequence[str] = ("x",),
                 label_cols: Sequence[str] = ("y",),
                 config: Optional[TrainConfig] = None, device=None,
                 lora: Optional[LoRAConfig] = None,
                 initial_variables=None,
                 param_loss: Optional[Callable] = None, mesh=None,
                 partition_rules=None):
        self.config = config or TrainConfig()
        self.param_loss = param_loss
        self._init_mesh(mesh, device)
        self.device = resolve_device(
            device if device is not None or self.mesh is None
            else self.mesh.device)
        if initial_variables is not None:
            # before the move, so the device holds one copy
            load_initial_variables(model, initial_variables)
        self.model = model.to(self.device)
        if self.mesh is not None and self.mesh.devices > 1:
            self._sync_start()
        self.loss_fn = get_loss(loss)
        self.lora = lora
        self._lora = None
        self._lora_leaves = None
        if lora is not None:
            # on the whole weights, before any shard is cut
            self._lora = init_lora(self.model, lora,
                                   fold_in(self.config.seed, 2))
            self._lora_leaves = {n: flax_leaf(self.model, n)
                                 for n in self._lora}
        self.rules = tuple(partition_rules) if partition_rules is not None \
            else DP_RULES
        if lora is not None:
            self.rules = tuple(LORA_RULES) + self.rules
        # the placement of every parameter cut to this rank's shard
        self._placements: Dict[str, P] = {}
        if self.mesh is not None and self.mesh.size("tp") > 1:
            self._placements = shard_module(self.model, self.mesh,
                                            self.rules)
        else:
            check_rules(self.rules)
        if lora is not None:
            params = adapter_params(self._lora)
        else:
            params = [p for p in self.model.parameters() if p.requires_grad]
        self._trainable = params
        names = {id(p): n for n, p in self.model.named_parameters()}
        self._trainable_names = [names.get(id(p)) for p in params]
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
        self._takes_rng = _model_accepts(self.model, "rng")
        self._epoch = 0
        self._global_step = 0
        # the dropout seed; a restored checkpoint brings its own
        self._seed = int(self.config.seed)
        self._prof_active = False

    def _init_mesh(self, mesh, device) -> None:
        """The data-parallel layout: ``mesh`` or the context's; dp = the
        data-shard group count of its batch axes."""
        from analytics_zoo_tpu_torch.common.context import context_mesh
        from analytics_zoo_tpu_torch.parallel.partition import (
            data_process_groups, data_sharding)

        if mesh is None and device is None:
            mesh = context_mesh()
        self.mesh = mesh
        self._dp, self._dp_index, self._dp_group = 1, 0, None
        self._sp_group, self._grad_div = None, 1
        if mesh is None:
            return
        items = {"fsdp": "item 6.1 (FSDP)", "pp": "item 9 (pipeline)",
                 "ep": "item 9 (expert parallelism)"}
        other = {a: n for a, n in mesh.shape.items()
                 if a not in ("dp", "tp", "sp") and n > 1}
        if other:
            named = sorted({items.get(a, "item 9") for a in other})
            raise NotImplementedError(
                f"training on a mesh with {other}: the port trains over "
                f"dp, tp and sp; the rest is ROADMAP Queue 1 "
                f"{' and '.join(named)}")
        n_groups, my_group, _ = data_process_groups(data_sharding(mesh))
        self._dp, self._dp_index = n_groups, my_group
        self._dp_group = mesh.group("dp")
        self._sp_group = mesh.group("sp")
        self._grad_div = self._dp * mesh.size("sp")

    def _sync_start(self) -> None:
        """Every rank starts from rank 0's parameters and buffers (the
        whole tensors, before any shard is cut)."""
        dp.broadcast_start(list(self.model.parameters())
                           + list(self.model.buffers()))

    def _rows(self):
        """This rank's share of a global batch, for the layers."""
        return dp.rows_of_global(self._dp_index, self._dp, self._dp_group)

    def _local(self, batch: Dict[str, np.ndarray], accum: int = 1):
        """This rank's rows of a global host batch: with ``accum``
        micro-batches, its share of each in order, so local micro-batch
        i is its rows of global micro-batch i."""
        if self._dp == 1:
            return batch
        n = len(next(iter(batch.values())))
        if n % (self._dp * accum):
            raise ValueError(
                f"global batch {n} must be positive and divisible by "
                f"data-shard group count {self._dp}"
                + (f" x accum_steps={accum}" if accum > 1 else ""))
        size = n // accum
        per = size // self._dp
        idx = np.concatenate([np.arange(i * size + self._dp_index * per,
                                        i * size + (self._dp_index + 1)
                                        * per) for i in range(accum)])
        return {k: v[idx] for k, v in batch.items()}

    def _all_mean(self, values: Dict[str, torch.Tensor]):
        """Each scalar's mean over the ranks (one all_reduce)."""
        if self._dp == 1 or not values:
            return values
        return dp.mean_over(values, self._dp_group, self._dp)

    def _all_reduce_grads(self) -> None:
        """Average the trainable gradients over dp x sp (one coalesced
        all_reduce a line).  A tp line's ranks hold the gradients of
        their own shards and equal ones of replicated parameters."""
        dp.average_grads(self._trainable, (self._dp_group, self._sp_group),
                         self._grad_div)

    def _leader(self) -> bool:
        """Whether this rank writes files (rank 0 of the process group)."""
        from analytics_zoo_tpu_torch.parallel.mesh import world

        return world()[0] == 0

    def _barrier(self) -> None:
        from analytics_zoo_tpu_torch.parallel.mesh import world

        if world()[1] > 1:
            import torch.distributed as dist

            dist.barrier()

    def _set_cols(self, feature_cols, label_cols):
        if feature_cols:
            self.feature_cols = tuple(feature_cols)
        if label_cols:
            self.label_cols = tuple(label_cols)

    def _on_device(self, batch: Dict[str, np.ndarray]):
        return {k: torch.as_tensor(np.ascontiguousarray(v),
                                   device=self.device)
                for k, v in batch.items()}

    def _forward(self, batch, train: bool, micro: Optional[int] = None):
        """The model on ``batch``; a training forward's dropout seed is
        ``fold_in(seed, step)``, and micro-batch ``micro``'s
        ``fold_in`` of that with ``micro`` (the reference's
        ``fold_in(rng, i)``)."""
        kw = {"train": train} if self._takes_train else {}
        if train and self._takes_rng:
            rng = fold_in(self._seed, self._global_step)
            kw["rng"] = rng if micro is None else fold_in(rng, micro)
        return self.model(*[batch[c] for c in self.feature_cols], **kw)

    def _labels(self, batch):
        ys = [batch[c] for c in self.label_cols]
        return ys[0] if len(ys) == 1 else tuple(ys)

    def _weights(self):
        """The block runs on the merged weights under LoRA (forward and
        backward, so a remat recompute reads them too)."""
        if self._lora is None:
            return contextlib.nullcontext()
        return merged_weights(self.model, self._lora, self.lora,
                              self._lora_leaves, self._placements,
                              self.mesh)

    def _train_step(self, batch) -> Dict[str, torch.Tensor]:
        labels = self._labels(batch)
        self.optimizer.zero_grad(set_to_none=True)
        accum = _accum_steps(self.config)
        with self._rows():
            if accum > 1:
                loss, preds = self._accumulate(batch, accum)
            else:
                with self._weights():
                    preds = self._forward(batch, train=True)
                    loss = self._loss(preds, labels)
                    loss.backward()
        if self._grad_div > 1:
            self._all_reduce_grads()
        if self.config.debug_nans:
            self._check_finite(loss)
        self.optimizer.step()
        with torch.no_grad():
            mets = {"loss": loss.detach()}
            for name, fn in self.metric_fns:
                mets[name] = fn(preds.detach(), labels)
        return self._all_mean(mets)

    def _accumulate(self, batch, accum: int):
        """``accum`` micro-batches' forwards and backwards in order; the
        summed gradients divided by ``accum``.  Returns the mean loss and
        every row's predictions."""
        n = len(next(iter(batch.values())))
        size = n // accum
        losses, outs = [], []
        for i in range(accum):
            part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            with self._weights():
                preds = self._forward(part, train=True, micro=i)
                loss = self._loss(preds, self._labels(part))
                loss.backward()
            losses.append(loss.detach())
            outs.append(preds)
        with torch.no_grad():
            for p in self._trainable:
                if p.grad is not None:
                    p.grad.div_(accum)
            # a model may return a tuple of outputs (a QA head's start,
            # end)
            preds = torch.cat(outs) if isinstance(outs[0], torch.Tensor) \
                else tuple(map(torch.cat, zip(*outs)))
        return sum(losses) / accum, preds

    def _loss(self, preds, labels):
        """The training loss: ``loss_fn`` plus ``param_loss``."""
        loss = self.loss_fn(preds, labels)
        if self.param_loss is not None:
            loss = loss + self.param_loss(self.model)
        return loss

    def _check_finite(self, loss) -> None:
        """``debug_nans``: the step's loss and gradients must be finite
        before the optimizer steps (one sync)."""
        checks = [torch.isfinite(loss.detach()).all()] + [
            torch.isfinite(p.grad).all() for p in self._trainable
            if p.grad is not None]
        if not bool(torch.stack(checks).all()):
            raise FloatingPointError(
                f"NaN or Inf in the loss or the gradients at step "
                f"{self._global_step + 1} (TrainConfig.debug_nans); the "
                f"optimizer did not step")

    @torch.no_grad()
    def _eval_step(self, batch, weights, across_ranks: bool = True
                   ) -> Dict[str, torch.Tensor]:
        """Per-sample losses and metrics (each row alone, as the
        reference's singleton-batch vmap), weighted by ``weights`` (0 for
        padding rows)."""
        with self._weights():
            preds = self._forward(batch, train=False)
        labels = self._labels(batch)

        def per_sample(fn):
            rows = []
            for i in range(preds.shape[0]):
                lab = tuple(x[i:i + 1] for x in labels) \
                    if isinstance(labels, tuple) else labels[i:i + 1]
                rows.append(fn(preds[i:i + 1], lab))
            return torch.stack(rows).float()

        sums = {"loss": (per_sample(self.loss_fn) * weights).sum()}
        for name, fn in self.metric_fns:
            sums[name] = (per_sample(fn) * weights).sum()
        count = weights.sum()
        if self._dp > 1 and across_ranks:
            # every rank's rows of the chunk: weighted sums added
            import torch.distributed as dist

            names = list(sums)
            flat = torch.stack([sums[k].float() for k in names] + [count])
            dist.all_reduce(flat, group=self._dp_group)
            sums, count = dict(zip(names, flat[:-1])), flat[-1]
        denom = torch.clamp(count, min=1.0)
        mets = {k: v / denom for k, v in sums.items()}
        if self.param_loss is not None:
            # keras includes the penalty in evaluate's loss
            mets["loss"] = mets["loss"] + self.param_loss(self.model)
        return mets

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None,
            validation_data=None,
            feature_cols: Optional[Sequence[str]] = None,
            label_cols: Optional[Sequence[str]] = None,
            checkpoint_trigger: Optional[Trigger] = None,
            callbacks: Sequence[Callable[[Dict], object]] = (),
            auto_resume: bool = False) -> List[Dict[str, float]]:
        """Train for ``epochs`` epochs of ``batch_size`` rows; returns
        the per-epoch stats dicts.

        ``checkpoint_trigger`` is called after every step with
        ``{"step", "epoch"}`` and at every epoch end with ``{"step",
        "epoch", "epoch_end": True, "metrics"}``; when it fires, a
        checkpoint goes to ``config.checkpoint_dir``.  With a
        ``checkpoint_dir`` and no trigger, every epoch end saves (and
        every ``checkpoint_every_steps`` steps, when that is above 0).
        ``auto_resume=True`` restores the newest checkpoint under
        ``checkpoint_dir``, if there is one, and trains only the epochs
        that remain of ``epochs``, continuing the shuffle schedule: a
        restarted process goes on where the stopped one saved.  Resume
        is epoch-granular, as in the reference: a mid-epoch checkpoint
        trains its epoch's leading batches again."""
        batch_size = _resolve_batch(batch_size, data, "batch_size")
        if validation_data is None:
            validation_data = getattr(data, "val", None)
        accum = _accum_steps(self.config)
        if batch_size % accum:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"accum_steps={accum}")
        if batch_size < 1 or batch_size % self._dp:
            raise ValueError(f"global batch {batch_size} must be positive "
                             f"and divisible by data-shard group count "
                             f"{self._dp}")
        self._set_cols(feature_cols, label_cols)
        shuffle = not self.config.deterministic
        if isinstance(data, DiskFeatureSet):
            # host-local: this rank's shard feeds its rows of each step
            it = data.batch_iterator(batch_size // self._dp, shuffle=shuffle,
                                     seed=self.config.seed)
            if self._dp > 1:
                it = _MinSteps(it, self._min_over_ranks(
                    it.steps_per_epoch()))
        else:
            it = NumpyBatchIterator(
                DataCreator.to_arrays(data), batch_size, shuffle=shuffle,
                drop_remainder=True, seed=self.config.seed)
        if auto_resume:
            if not self.config.checkpoint_dir:
                raise ValueError(
                    "fit(auto_resume=True) needs config.checkpoint_dir: "
                    "there is nowhere to resume from")
            if latest_checkpoint(self.config.checkpoint_dir) is not None:
                self.load_checkpoint(self.config.checkpoint_dir)
                logger.info("auto-resume: restored step %d (epoch %d) "
                            "from %s", self._global_step, self._epoch,
                            self.config.checkpoint_dir)
                if self._global_step % max(1, it.steps_per_epoch()):
                    logger.warning(
                        "auto-resume: restored step %d is mid-epoch "
                        "(steps_per_epoch=%d); resume is epoch-granular, "
                        "so the partial epoch's leading batches are "
                        "trained again", self._global_step,
                        it.steps_per_epoch())
            if self._epoch >= epochs:
                logger.info("auto-resume: %d epochs already complete",
                            self._epoch)
                return []
            epochs -= self._epoch
            # continue the shuffle-seed schedule where the stopped run
            # left it
            it.epoch = self._epoch
        trigger = checkpoint_trigger or self._default_trigger()
        for cb in callbacks:
            # stop-requesting callbacks restart fresh per fit
            if getattr(cb, "requests_stop", False):
                getattr(cb, "reset", lambda: None)()
        mlog = MetricLogger(jsonl_path=self.config.metrics_jsonl,
                            tensorboard_dir=self.config.tensorboard_dir,
                            log_every=self.config.log_every_steps)
        try:
            return self._fit_epochs(epochs, it, batch_size, validation_data,
                                    trigger, callbacks, mlog,
                                    isinstance(data, DiskFeatureSet))
        finally:
            # a fault must not leak a running trace (the next start would
            # raise) or an open metrics file
            if self._prof_active:
                self._prof_active = False
                stop_profiler_trace()
            mlog.close()

    def _fit_epochs(self, epochs, it, batch_size, validation_data, trigger,
                    callbacks, mlog, host_local: bool
                    ) -> List[Dict[str, float]]:
        """The epochs of :meth:`fit`; ``host_local`` batches (a
        ``DiskFeatureSet``'s) are this rank's rows already."""
        cfg = self.config
        prof = cfg.profile          # (logdir, start_step, n_steps)
        log_every = max(1, int(cfg.log_every_steps))
        on_card = self.device.type == "cuda"
        history: List[Dict[str, float]] = []
        for _ in range(epochs):
            self.model.train()
            t0 = time.perf_counter()
            step_mets = []
            for b in it.epoch_batches():
                # the hot loop never waits on the card, but at log points
                # (and at a trace's end, so the trace holds its steps)
                if prof and not self._prof_active and \
                        self._global_step >= prof[1]:
                    start_profiler_trace(prof[0], cuda=on_card)
                    self._prof_active = True
                if not host_local:
                    b = self._local(b, _accum_steps(cfg))
                mets = self._train_step(self._on_device(b))
                step_mets.append(mets)
                self._global_step += 1
                if self._prof_active and \
                        self._global_step >= prof[1] + prof[2]:
                    if on_card:
                        torch.cuda.synchronize(self.device)
                    self._prof_active = False
                    stop_profiler_trace()
                    prof = None
                if cfg.fault_inject_step and \
                        self._global_step == cfg.fault_inject_step:
                    raise RuntimeError(
                        f"injected fault at step {self._global_step} "
                        f"(TrainConfig.fault_inject_step)")
                if len(step_mets) % log_every == 0:
                    mlog.log(self._global_step, _fetch_one(mets),
                             n_samples=batch_size * log_every)
                if trigger and trigger({"step": self._global_step,
                                        "epoch": self._epoch}):
                    self._maybe_checkpoint()
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
            if trigger and trigger({"step": self._global_step,
                                    "epoch": self._epoch, "epoch_end": True,
                                    "metrics": stats}):
                self._maybe_checkpoint()
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

    def set_tensorboard(self, log_dir: str, app_name: str = "zoo"):
        """Metrics every ``log_every_steps`` steps to TensorBoard under
        ``log_dir/app_name/train`` and to ``log_dir/app_name/
        train.jsonl``, as the reference's ``set_tensorboard``."""
        self.config.tensorboard_dir = os.path.join(log_dir, app_name,
                                                   "train")
        self.config.metrics_jsonl = os.path.join(log_dir, app_name,
                                                 "train.jsonl")
        os.makedirs(self.config.tensorboard_dir, exist_ok=True)
        return self

    def set_profile(self, logdir: str, start_step: int = 5,
                    n_steps: int = 5):
        """Trace ``n_steps`` training steps with ``torch.profiler`` once
        the global step reaches ``start_step`` (past the warm-up); the
        trace is a gzipped Chrome trace under ``logdir``."""
        self.config.profile = (logdir, start_step, n_steps)
        return self

    def _default_trigger(self) -> Optional[Trigger]:
        if not self.config.checkpoint_dir:
            return None
        every = int(self.config.checkpoint_every_steps or 0)
        return EveryEpoch() | SeveralIteration(every) if every > 0 \
            else EveryEpoch()

    def evaluate(self, data, batch_size: Optional[int] = None,
                 feature_cols=None, label_cols=None) -> Dict[str, float]:
        """Loss and metrics over every row of ``data``, sample-weighted."""
        batch_size = _resolve_batch(batch_size, data, "batch_per_thread")
        self._set_cols(feature_cols, label_cols)
        self.model.eval()
        local = self._dp > 1 and isinstance(data, DiskFeatureSet)
        if self._dp > 1 and not local and batch_size % self._dp:
            raise ValueError(f"global batch {batch_size} must be positive "
                             f"and divisible by data-shard group count "
                             f"{self._dp}")
        mets_list, counts = [], []
        for chunk in _chunks(data, batch_size):
            counts.append(len(next(iter(chunk.values()))))
            chunk, w = _pad_batch(chunk, batch_size)
            if not local:
                chunk = self._local(chunk)
                w = self._local({"w": w})["w"]
            mets_list.append(self._eval_step(
                self._on_device(chunk),
                torch.as_tensor(w, device=self.device), not local))
        acc = EpochAccumulator()
        if mets_list:
            fetched = _fetch_stacked(mets_list)
            for i, cnt in enumerate(counts):
                acc.add({k: float(v[i]) for k, v in fetched.items()}, cnt)
        result = acc.result()
        if local:
            result = self._weighted_over_ranks(result, sum(counts))
        return result

    @torch.no_grad()
    def predict(self, data, batch_size: Optional[int] = None,
                feature_cols=None) -> np.ndarray:
        """The model's outputs for every row of ``data``, as numpy (a
        bf16 output comes back as f32: numpy has no bf16); a model that
        returns a tuple (SSD's locations and class logits) gives a tuple
        of arrays."""
        batch_size = _resolve_batch(batch_size, data, "batch_per_thread")
        self._set_cols(feature_cols, None)
        self.model.eval()
        outs = []

        def host(t, real):
            if t.dtype == torch.bfloat16:
                t = t.float()
            return t[:real].cpu()

        for chunk in _chunks(data, batch_size):
            for c in self.feature_cols:
                if c not in chunk:
                    raise KeyError(f"feature col {c!r} missing from "
                                   f"predict data")
            chunk = {c: chunk[c] for c in self.feature_cols}
            real = len(next(iter(chunk.values())))
            chunk, _ = _pad_batch(chunk, batch_size)
            gather = self._dp > 1 and not isinstance(data, DiskFeatureSet)
            if gather:
                chunk = self._local(chunk)
            with self._weights():
                preds = self._forward(self._on_device(chunk), train=False)
            if gather:
                # every rank's rows, in global order, on every rank
                preds = tuple(map(self._gather_rows, preds)) \
                    if isinstance(preds, tuple) else \
                    self._gather_rows(preds)
            outs.append(tuple(host(t, real) for t in preds)
                        if isinstance(preds, tuple) else host(preds, real))
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts).numpy() for parts in zip(*outs))
        return torch.cat(outs).numpy()

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        parts = [torch.empty_like(t) for _ in range(self._dp)]
        dist.all_gather(parts, t.contiguous(), group=self._dp_group)
        return torch.cat(parts)

    def _min_over_ranks(self, n: int) -> int:
        """The least of every rank's ``n`` (host-local shards train as
        many steps as the smallest gives: every rank must run the same
        collectives)."""
        import torch.distributed as dist

        t = torch.tensor([n], dtype=torch.int64)
        if dist.get_backend(self._dp_group) != "gloo":
            t = t.to(self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self._dp_group)
        return int(t.item())

    def _weighted_over_ranks(self, result: Dict[str, float], n: int
                             ) -> Dict[str, float]:
        """Per-rank means over ``n`` rows each, as the mean over every
        rank's rows (each row once)."""
        import torch.distributed as dist

        names = sorted(result)
        t = torch.tensor([result[k] * n for k in names] + [float(n)],
                         dtype=torch.float64)
        if dist.get_backend(self._dp_group) != "gloo":
            t = t.to(self.device)
        dist.all_reduce(t, group=self._dp_group)
        total = max(float(t[-1]), 1.0)
        return {k: float(t[i]) / total for i, k in enumerate(names)}

    # ---- checkpoints and exports ------------------------------------

    def _maybe_checkpoint(self):
        if self.config.checkpoint_dir:
            self.save_checkpoint(self.config.checkpoint_dir)

    def save_checkpoint(self, path: str):
        """Save the model, the optimizer, the step, the epoch and the
        dropout seed as ``path/ckpt_<step>/state.pt``, then drop all but
        the ``config.keep_checkpoints`` newest checkpoints."""
        # every rank joins the gathers of its shards
        model, opt = self._exported(), self._optimizer_state()
        if not self._leader():
            # rank 0 writes; the others wait until it has
            self._barrier()
            return
        path = os.path.abspath(path)
        final = os.path.join(path, f"ckpt_{self._global_step}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"model": model, "optimizer": opt,
                    "step": self._global_step, "epoch": self._epoch,
                    "seed": self._seed}, os.path.join(tmp, _CKPT_FILE))
        # a checkpoint appears whole or not at all
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        keep = max(1, int(self.config.keep_checkpoints))
        for step in checkpoint_steps(path)[:-keep]:
            shutil.rmtree(os.path.join(path, f"ckpt_{step}"))
        self._barrier()

    def load_checkpoint(self, path: str, step: Optional[int] = None):
        """Restore a :meth:`save_checkpoint` (the newest under ``path``,
        or ``step``'s): model and optimizer state, step, epoch and the
        dropout seed."""
        step = latest_checkpoint(path) if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        state = torch.load(
            os.path.join(os.path.abspath(path), f"ckpt_{step}", _CKPT_FILE),
            map_location=self.device, weights_only=True)
        self._restore(state["model"])
        self.optimizer.load_state_dict(self._optimizer_shards(
            state["optimizer"]))
        self._global_step = int(state["step"])
        self._epoch = int(state["epoch"])
        self._seed = int(state["seed"])

    def save(self, path: str):
        """Export the trained weights (the model's ``state_dict``) as
        ``path/model.pt``, replacing an earlier export: the reference's
        ``Estimator.save``, which ``InferenceModel.load`` serves."""
        state = self._exported()
        if self._leader():
            os.makedirs(path, exist_ok=True)
            torch.save(state, os.path.join(path, _MODEL_FILE))
        self._barrier()

    def load(self, path: str, sample_data=None):
        """Restore a :meth:`save` export into the model.
        ``sample_data`` is accepted for the reference's signature (it
        builds its state from it); a torch module has its own."""
        del sample_data
        self._restore(load_export(path, self.device))

    def _whole_state(self):
        """The model's ``state_dict`` as whole tensors (each rank's
        shards gathered: a collective over the mesh under tp)."""
        state = self.model.state_dict()
        if self._placements:
            state = gather_state(state, self._placements, self.mesh)
        return state

    def _optimizer_state(self):
        """The optimizer's ``state_dict`` with every per-parameter
        tensor of a cut parameter's shape gathered whole (Adam's
        moments), so it restores onto any mesh."""
        state = self.optimizer.state_dict()
        if not self._placements:
            return state
        return self._map_optimizer(state, lambda t, spec: gather_tensor(
            t, spec, self.mesh))

    def _optimizer_shards(self, state):
        """A saved optimizer state (whole tensors) cut to this rank's
        shards."""
        if not self._placements:
            return state
        return self._map_optimizer(state, lambda t, spec: shard_tensor(
            t, spec, self.mesh))

    def _map_optimizer(self, state, fn):
        out = dict(state)
        out["state"] = {}
        for idx, st in state["state"].items():
            name = self._trainable_names[int(idx)]
            spec = self._placements.get(name)
            out["state"][idx] = {
                k: fn(v.to(self.device), spec)
                if spec is not None and isinstance(v, torch.Tensor)
                and v.dim() > 0 else v for k, v in st.items()}
        return out

    def _exported(self):
        """The model's ``state_dict`` (whole tensors), and under LoRA
        the adapters under ``"__lora__"`` (the reference's params tree
        carries them)."""
        state = self._whole_state()
        if self._lora is not None:
            state[LORA_KEY] = {n: {k: t.detach() for k, t in ab.items()}
                               for n, ab in self._lora.items()}
        return state

    def _restore(self, state):
        state = dict(state)
        lora = state.pop(LORA_KEY, None)
        if self._placements:
            state = shard_state(state, self._placements, self.mesh)
        self.model.load_state_dict(state)
        if self._lora is not None:
            if lora is None:
                raise ValueError("this estimator trains LoRA adapters, but "
                                 "the saved state carries none")
            with torch.no_grad():
                for name, ab in self._lora.items():
                    for k, t in ab.items():
                        t.copy_(lora[name][k])

    def get_model(self):
        """``(model, state_dict)``: the reference's ``(model, params)``
        (under LoRA with the adapters under ``"__lora__"``)."""
        return self.model, self._exported()

    def lora_params(self):
        """The adapters alone, ``{name: {"a", "b"}}`` on the host: what a
        fine-tune ships."""
        if self._lora is None:
            raise RuntimeError("no LoRA state: pass lora=LoRAConfig(...)")
        return {n: {k: t.detach().cpu() for k, t in ab.items()}
                for n, ab in self._lora.items()}

    def merged_params(self):
        """The base weights with the adapters folded in (``W +
        scale·a@b`` in W's layout), a plain ``state_dict`` on the host
        that the base model loads and
        ``InferenceModel.load_torch_generator`` serves."""
        if self._lora is None:
            raise RuntimeError("no LoRA state: pass lora=LoRAConfig(...)")
        return {k: v.detach().cpu() for k, v in merged_state(
            self.model, self._lora, self.lora, self._whole_state(),
            self._lora_leaves).items()}


def checkpoint_steps(path: str) -> List[int]:
    """The steps of the checkpoints under ``path``, oldest first."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT_DIR.match,
                                               os.listdir(path))
                  if m and os.path.isfile(os.path.join(path, m.group(0),
                                                       _CKPT_FILE)))


def latest_checkpoint(path: str) -> Optional[int]:
    """The newest checkpoint's step under ``path``, or ``None``."""
    steps = checkpoint_steps(path)
    return steps[-1] if steps else None


def load_export(path: str, device=None) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` an :meth:`TorchEstimator.save` export holds."""
    return torch.load(os.path.join(os.path.abspath(path), _MODEL_FILE),
                      map_location=device, weights_only=True)


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

    # The reference's ``from_keras`` is its ``from_flax``, which takes
    # its Keras-API models; here they are torch modules.
    from_keras = from_torch

    @staticmethod
    def from_openvino(*, model_path: Optional[str] = None,
                      bin_path: Optional[str] = None,
                      **kw) -> TorchEstimator:
        """The reference's ``Estimator.from_openvino``: an OpenVINO IR
        (``net/openvino_ir.py``) behind the Estimator's ``predict`` and
        ``evaluate`` (``loss`` defaults to ``"mse"``; ``device`` and the
        column keywords as for :meth:`from_torch`).  Inference-only, as
        the reference's: ``fit`` raises."""
        from analytics_zoo_tpu_torch.net.openvino_ir import OpenVINONet

        if not model_path:
            raise ValueError("from_openvino needs model_path=<model.xml>")
        net = OpenVINONet.from_ir(model_path, bin_path)
        # an IR has no parameters, so nothing to optimise
        est = TorchEstimator(net, kw.pop("loss", None) or "mse",
                             lambda params: None, **kw)

        def _no_fit(*a, **k):
            raise NotImplementedError(
                "OpenVINO estimators are inference-only (the IR is a "
                "frozen artifact — ref parity with "
                "zoo.orca.learn.openvino); use predict/evaluate, or "
                "train the original model via from_torch")

        est.fit = _no_fit
        return est
