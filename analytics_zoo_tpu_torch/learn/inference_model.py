"""InferenceModel: the serving handle ``ClusterServing`` drives.

The port of ``analytics_zoo_tpu/learn/inference_model.py`` for the
generative path.  :meth:`InferenceModel.load_torch_generator` (the
counterpart of the reference's ``load_flax_generator``) serves a port
``TransformerLM``: ``predict`` takes right-padded prompts ``[B, P]``
(and optional per-row lengths) and returns ``[B, max_new_tokens]``
token ids through ``models.lm.generate``, and
:meth:`InferenceModel.make_continuous_engine` builds the
``ContinuousEngine`` the server's continuous mode pumps.  Prompt widths
are padded up to ``prompt_buckets`` and batches up to the batch buckets,
as in the reference; eager PyTorch compiles nothing per shape, so the
buckets only keep the two packages' serving bounds identical.

With a draft model (``load_torch_generator(draft_model=...,
draft_variables=...)``) ``predict`` decodes speculatively
(``models.speculative.speculative_generate``: the same greedy tokens,
cumulative statistics in ``spec_stats``) and the continuous engine is a
speculative one.

:meth:`InferenceModel.load_torch` serves a plain ``nn.Module`` (a
fine-tuned ``BERTForSequenceClassification``, say): moved to the card,
in ``eval()``, each micro-batch run under ``torch.inference_mode()``
with ``train=False`` where the forward takes it.  It is the port's
counterpart of the reference's ``load_torch``, which converted a torch
module into flax; here the module runs as it is.  :meth:`load` serves
an ``Estimator.save`` export.  Rows ``predict_async`` pads a batch with
are all zeros (for BERT, a fully masked row, which the model keeps
finite) and never reach the result.

``load_torch_generator(quantize="int8" | "bf16")`` serves weight-only
quantized weights (``learn/quantize.py``; ``quant_stats`` reports the
reference's byte counts): the model's own copies of the quantized
weights are released, the handle keeps the quantized ones on the
device, and each ``predict`` dequantizes them for its generation, as
the reference dequantizes inside its jitted ``generate``.  The
speculative path dequantizes once at load and
:meth:`InferenceModel.make_continuous_engine` once at build, into the
model, as the reference does; the handle then serves those weights.
``"int8_mxu"`` raises ``ValueError``, as the reference's generator
does.

:meth:`InferenceModel.load_openvino` serves an OpenVINO IR through the
port's translator (``net/openvino_ir.py``); ``quantize="int8"`` or
``"bf16"`` quantizes the IR's ``params`` as the reference does (the
same int8 values, scales and ``quant_stats``), and each ``predict``
dequantizes them.  ``load_torch`` also takes a path that ``torch.load``
reads.  ``load_tf`` (the TensorFlow importer, Queue 1 item 4) raises
``NotImplementedError``.

:meth:`InferenceModel.load_flax` serves a port model with the
reference's variables tree, a Keras-API model first, with ``quantize``
``None``, ``"int8"``, ``"bf16"`` or ``"int8_mxu"`` (int8 x int8 -> int32
Dense and Conv products; the one loader that takes it, as in the
reference: the others raise its ``ValueError``).
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def filter_prompt_buckets(prompt_buckets: Sequence[int],
                          max_position: int,
                          max_new_tokens: int) -> Tuple[int, ...]:
    """Prompt buckets usable by a generator: a bucket only counts if the
    padded prompt + generation still fits the model's position table.
    Shared by load_torch_generator and ContinuousEngine so the two entry
    paths can never disagree about which prompts are servable."""
    limit = int(max_position) - int(max_new_tokens)
    out = tuple(b for b in sorted(set(int(b) for b in prompt_buckets))
                if b <= limit)
    if not out:
        raise ValueError(
            f"no prompt bucket fits: max_position {max_position} - "
            f"max_new_tokens {max_new_tokens} = {limit} < smallest "
            f"bucket {min(prompt_buckets)}")
    return out


def _tree_items(tree, path=()):
    """``(path, leaf)`` of a nested dict."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _tree_items(v, path + (str(k),))
    else:
        yield path, tree


def _unflatten(flat: dict) -> dict:
    """``{(k1, k2, ...): leaf}`` as the nested dict."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _attach_int8(leaf, q: dict) -> bool:
    """Put the int8 kernel ``q`` (the reference's layout, on the card:
    ``learn.quantize``'s ``{"q", "scale", "view"}``) on
    the port module that computes the reference's ``nn.Dense``/``nn.Conv``
    of ``leaf``, as its interceptor would take it; False where the
    reference keeps the float path (an ``OptimizedLSTMCell``'s gates,
    whose kernels are not ``nn.Dense`` calls, a ``ConvTranspose``)."""
    from torch import nn

    from analytics_zoo_tpu_torch.models import rnn

    mod, cell = leaf.module, leaf.cell
    if cell is not None:
        if isinstance(cell, rnn.LSTMCell):
            return False
        g = 0 if leaf.rows is None else leaf.rows.start // cell.features
        gates = getattr(mod, "int8_gates", None) or [None] * cell.gates
        gates[g] = q
        mod.int8_gates = gates
        return True
    if isinstance(mod, (nn.Linear, nn.modules.conv._ConvNd)):
        mod.int8 = q
        # the int8 kernel serves: release the float one
        mod.weight.data = torch.empty(0, device=mod.weight.device)
        return True
    return False


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    """A cache dtype given as a torch dtype or by name ("bfloat16",
    "float32", ...; ``ServingConfig.engine_cache_dtype``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"cache_dtype {dtype!r} names no torch dtype")
    return out


def _host(out, n: int):
    """The first ``n`` rows of a forward's output (a tensor, or a tuple
    of them) as numpy; bf16 comes back as f32."""
    if isinstance(out, tuple):
        return tuple(_host(o, n) for o in out)
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out[:n].cpu().numpy()


class InferenceModel:
    """One serving handle: load a module or a generator, then
    ``predict``, or build a continuous-batching engine from a
    generator.

    Args:
      concurrent_num: caps concurrent ``predict`` calls (the reference
        sizes its host-staging semaphore with it).
      batch_buckets: batch sizes ``predict`` pads its rows up to.
    """

    def __init__(self, concurrent_num: int = 4,
                 batch_buckets: Sequence[int] = (1, 8, 32, 128)):
        self._apply_fn: Optional[Callable] = None
        self._buckets = tuple(sorted(batch_buckets))
        self._sem = threading.Semaphore(max(1, concurrent_num))
        # host-side input normaliser (generator prompt padding)
        self._pre_pad: Optional[Callable] = None
        self.model = None
        self.device: Optional[torch.device] = None
        # generator-only serving bounds (load_torch_generator sets them)
        self.max_prompt_width: Optional[int] = None
        self.prompt_pad_id: Optional[int] = None
        self._gen_max_new_tokens: Optional[int] = None
        self._gen_prompt_buckets: Optional[Tuple[int, ...]] = None
        # speculative decoding (load_torch_generator's draft branch)
        self.spec_stats: Optional[dict] = None
        self._spec_stats_lock = threading.Lock()
        self._spec_draft = None     # (draft model, variables, k)
        # weight-only quantization: the quantized weights at rest, the
        # lock the dequantized swap is made under, the byte counts
        self._qstate: Optional[dict] = None
        self._quant_lock = threading.Lock()
        self.quant_stats: Optional[dict] = None
        # load_flax(quantize="int8_mxu"): the layers on int8 products
        self.int8_layers = 0

    # ---- loading -----------------------------------------------------

    def load_torch_generator(self, model, variables=None,
                             max_new_tokens: Optional[int] = None,
                             prompt_buckets: Sequence[int] = (16, 32, 64,
                                                              128),
                             pad_id: int = 0, device=None,
                             quantize: Optional[str] = None,
                             draft_model=None, draft_variables=None,
                             speculation_k: int = 4
                             ) -> "InferenceModel":
        """Serve autoregressive generation from a port ``TransformerLM``:
        ``predict`` takes right-padded prompts ``[B, P]`` (+ optional
        per-row lengths ``[B]``) and returns ``[B, max_new_tokens]``
        int32 token ids.  ``variables``: a ``state_dict`` loaded into
        ``model`` first (``None`` keeps its weights).  ``device``:
        ``cuda`` unless the caller names another.  Prompt widths pad up
        to the usable ``prompt_buckets``; missing lengths are inferred
        as the non-``pad_id`` width of each row.

        ``draft_model``/``draft_variables`` (together or neither; the
        variables a ``state_dict``, as ``variables``) switch decoding
        to SPECULATIVE: the draft proposes ``speculation_k`` tokens a
        round and the target verifies them in one cached forward, with
        the same greedy tokens.  The prompt buckets then leave room for
        the k+1 verify positions in both models' position tables.
        Cumulative statistics land in ``spec_stats``.

        ``quantize``: ``None``, ``"int8"`` or ``"bf16"``, the target's
        weights only (see the module docstring); ``quant_stats`` then
        holds the weight-bytes compression."""
        from analytics_zoo_tpu_torch.device import resolve_device
        from analytics_zoo_tpu_torch.models.lm import generate
        from analytics_zoo_tpu_torch.models.speculative import (
            load_draft, speculative_generate)

        if max_new_tokens is None or int(max_new_tokens) < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens!r}")
        max_new_tokens = int(max_new_tokens)
        if quantize == "int8_mxu":
            raise ValueError(
                "quantize='int8_mxu' is only supported by load_flax "
                "(flax-linen models); use 'int8' (weight-only) here")
        if (draft_model is None) != (draft_variables is None):
            raise ValueError("pass draft_model and draft_variables "
                             "together (or neither)")
        dev = resolve_device(device)
        if variables is not None:
            model.load_state_dict(variables)
        self.model = model.to(dev).eval()
        self.device = dev
        self._qstate, self.quant_stats = None, None
        if quantize:
            self._quantize(quantize)
        # speculative decoding needs k+1 cache positions of slack and
        # must fit BOTH position tables: checked here, so a request the
        # serving bounds check admits cannot fail at predict time
        eff_max_pos, eff_new = model.max_position, max_new_tokens
        if draft_model is not None:
            eff_max_pos = min(model.max_position, draft_model.max_position)
            eff_new = max_new_tokens + int(speculation_k) + 1
        pbuckets = filter_prompt_buckets(prompt_buckets, eff_max_pos,
                                         eff_new)
        # the serving batcher bounds-checks ragged prompts with these
        # and cross-checks its pad id against the generator's
        self.max_prompt_width = pbuckets[-1]
        self.prompt_pad_id = int(pad_id)
        # continuous-batching serving builds its engine from these
        self._gen_max_new_tokens = int(max_new_tokens)
        self._gen_prompt_buckets = pbuckets

        self.spec_stats = None
        self._spec_draft = None
        if draft_model is not None:
            # the host-side speculative loop would dequantize once a
            # round: dequantize once here instead
            self._dequantize_into_model()
            load_draft(model, draft_model, draft_variables)
            draft_model.to(dev).eval()
            k = int(speculation_k)
            self._spec_draft = (draft_model, draft_variables, k)

            def apply_fn(prompts, lengths):
                toks, stats = speculative_generate(
                    self.model, None, draft_model, None, prompts,
                    max_new_tokens, k=k, prompt_len=lengths, device=dev)
                # cumulative since load; batch-bucket padding rows have
                # length 0, so only real rows count
                real = np.asarray(lengths) > 0
                with self._spec_stats_lock:
                    agg = self.spec_stats or {
                        "rounds": 0, "emitted_tokens": 0, "row_rounds": 0}
                    agg["rounds"] += stats["rounds"]
                    agg["emitted_tokens"] += int(
                        stats["per_row_emitted"][real].sum())
                    agg["row_rounds"] += stats["rounds"] * int(real.sum())
                    agg["mean_accepted_per_round"] = (
                        agg["emitted_tokens"] / max(1, agg["row_rounds"]))
                    self.spec_stats = agg
                return toks
        else:
            def apply_fn(prompts, lengths):
                with self._dequantized():
                    return generate(self.model, None, prompts,
                                    max_new_tokens, prompt_len=lengths,
                                    device=dev)

        def pre_pad(inputs):
            prompts = np.asarray(inputs[0])
            if len(inputs) > 1:
                lengths = np.asarray(inputs[1], np.int32)
            else:
                nonpad = prompts != pad_id
                # length = index of last non-pad + 1 (right padding)
                lengths = np.where(
                    nonpad.any(axis=1),
                    prompts.shape[1] - np.argmax(nonpad[:, ::-1], axis=1),
                    0).astype(np.int32)
            if (lengths <= 0).any():
                raise ValueError(
                    "empty prompt (length 0) — generation needs at least "
                    "one real token per row")
            pb = _next_bucket(prompts.shape[1], pbuckets)
            if prompts.shape[1] < pb:
                prompts = np.concatenate(
                    [prompts, np.full((len(prompts), pb - prompts.shape[1]),
                                      pad_id, prompts.dtype)], axis=1)
            elif prompts.shape[1] > pb:
                raise ValueError(
                    f"prompt length {prompts.shape[1]} exceeds the largest "
                    f"usable prompt bucket {pb}")
            return prompts, lengths

        self._apply_fn = apply_fn
        self._pre_pad = pre_pad
        return self

    def _quantize(self, mode: str) -> None:
        """Quantize the model's weights (``learn/quantize.py``), keep the
        quantized ones and release the model's own copies of them."""
        from analytics_zoo_tpu_torch.learn.quantize import quantize_params

        params = {n: p.detach() for n, p in self.model.named_parameters()}
        new, self.quant_stats = quantize_params(params, mode,
                                                model=self.model)
        self._qstate = {n: v for n, v in new.items() if v is not params[n]}
        for name in self._qstate:
            p = self.model.get_parameter(name)
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    @contextlib.contextmanager
    def _dequantized(self):
        """The block runs on the dequantized weights (none to swap in
        when nothing is quantized); predicts take turns."""
        if self._qstate is None:
            yield
            return
        from analytics_zoo_tpu_torch.learn.lora import swapped_weights
        from analytics_zoo_tpu_torch.learn.quantize import dequantize

        with self._quant_lock, swapped_weights(self.model,
                                               dequantize(self._qstate)):
            yield

    def _dequantize_into_model(self) -> None:
        """Dequantize once, into the model's parameters (the speculative
        path and a continuous engine read them there)."""
        if self._qstate is None:
            return
        from analytics_zoo_tpu_torch.learn.quantize import dequantize

        with self._quant_lock:
            for name, t in dequantize(self._qstate).items():
                self.model.get_parameter(name).data = t
            self._qstate = None

    def make_continuous_engine(self, max_slots: int = 8,
                               eos_id: Optional[int] = None,
                               ticks_per_step: int = 1,
                               cache_dtype=None,
                               kernel: Optional[str] = None,
                               kv_dtype: Optional[str] = None,
                               mesh=None, partition_rules=None,
                               paged: bool = False,
                               block_size: int = 16,
                               n_blocks: Optional[int] = None,
                               hbm_fraction: Optional[float] = None,
                               enable_prefix_cache: bool = True,
                               chunked: bool = False,
                               tick_token_budget: Optional[int] = None,
                               speculation_k: Optional[int] = None,
                               elastic_pool: bool = False,
                               kv_host_store_bytes: int = 0,
                               prefix_directory=None,
                               replica_id: int = 0,
                               fault_injector=None,
                               record_timings: bool = False,
                               telemetry=None, qos=None,
                               flight=None, flight_capacity: int = 2048):
        """Build a ``serving.continuous.ContinuousEngine`` on the loaded
        generator's model, weights, device, token budget, prompt buckets
        and pad id, with the reference's keywords.  ``cache_dtype`` may
        name a dtype ("bfloat16", "float32").  ``kernel`` (paged only)
        is the paged-attention read: ``None`` (the default) lets the
        engine choose by shape, "fused" wherever the CUDA kernel takes
        the model's head dim and block size; "gather" forces the plain
        version.  A draft-loaded handle builds a speculative engine;
        ``speculation_k`` overrides the depth stored at load (``None``
        keeps it) and is refused without a draft.  ``qos``,
        ``elastic_pool``, ``kv_host_store_bytes`` and
        ``prefix_directory`` pass through to the engine, and so do
        ``mesh`` and ``partition_rules`` (tensor parallelism: build it on
        every rank of the mesh, with this handle's device the rank's;
        engines of one handle share its sharded model, each on the lane
        of the mesh its ``replica_id`` names)."""
        from analytics_zoo_tpu_torch.serving.continuous import (
            ContinuousEngine)

        if self._gen_max_new_tokens is None:
            raise ValueError("continuous batching needs a model loaded "
                             "via load_torch_generator")
        # quantized weights dequantize once, at build
        self._dequantize_into_model()
        spec = {}
        if self._spec_draft is not None:
            draft, dvars, k = self._spec_draft
            spec = dict(draft_model=draft, draft_variables=dvars,
                        speculation_k=(k if speculation_k is None
                                       else int(speculation_k)))
        elif speculation_k is not None:
            raise ValueError(
                "speculation_k needs a draft model: load one via "
                "load_torch_generator(draft_model=..., "
                "draft_variables=...)")
        return ContinuousEngine(
            self.model, None,
            max_new_tokens=self._gen_max_new_tokens,
            max_slots=max_slots,
            prompt_buckets=self._gen_prompt_buckets,
            eos_id=eos_id, pad_id=self.prompt_pad_id,
            ticks_per_step=ticks_per_step,
            cache_dtype=_torch_dtype(cache_dtype),
            kernel=kernel,
            kv_dtype=kv_dtype,
            mesh=mesh, partition_rules=partition_rules,
            paged=paged, block_size=block_size, n_blocks=n_blocks,
            hbm_fraction=hbm_fraction,
            enable_prefix_cache=enable_prefix_cache,
            chunked=chunked, tick_token_budget=tick_token_budget,
            elastic_pool=elastic_pool,
            kv_host_store_bytes=kv_host_store_bytes,
            prefix_directory=prefix_directory, replica_id=replica_id,
            fault_injector=fault_injector,
            record_timings=record_timings, telemetry=telemetry,
            qos=qos, flight=flight, flight_capacity=flight_capacity,
            device=self.device, **spec)

    def load_flax(self, model, variables, quantize: Optional[str] = None,
                  device=None) -> "InferenceModel":
        """Serve a port model that has a reference counterpart with the
        reference's variables tree ``{"params": ..., ["batch_stats":
        ...]}`` (numpy leaves), on ``device`` (``cuda`` unless the caller
        names another), as :meth:`load_torch` serves a module.

        ``model``: a Keras-API model (``keras.Sequential``/``Model``, or
        one layer), built from the tree through
        ``keras.engine.set_variables`` (an unbuilt model builds from its
        known input shapes first), or any port module whose weights its
        own module's ``params_from_flax`` (``models.lm``'s,
        ``models.transformer``'s), else ``models.layers.params_from_flax``
        (and ``batch_stats_from_flax``), carries.

        ``quantize``: ``None``, ``"int8"`` (weight-only, per-channel
        symmetric int8), ``"bf16"`` (bf16 weights, f32 compute, as the
        reference promotes) or ``"int8_mxu"``: the reference's tree is
        quantized as the reference quantizes it
        (``learn.quantize.quantize_tree``; ``quant_stats`` its byte
        counts).  A Keras model keeps the quantized leaves on the device
        and each ``predict`` dequantizes them into its weights (a leaf
        that shares a tensor with others, a recurrent cell's gate, is
        dequantized once at load); another module is loaded with the
        dequantized weights.  ``"int8_mxu"`` additionally runs every
        plain Dense and Conv whose kernel was quantized (the reference
        interceptor's set, by flax path: not an ``OptimizedLSTMCell``'s
        gates, a ``ConvTranspose``, a ``DenseGeneral`` such as the
        attention projections, a locally connected or embedding table,
        which stay on the dequantized weights) as int8 x int8 -> int32
        products with dynamic per-tensor activation scales, in a Keras
        model and in any other module (a ``TransformerLM``, a
        ``ResNet``); ``int8_layers`` counts them."""
        from analytics_zoo_tpu_torch.device import resolve_device
        from analytics_zoo_tpu_torch.keras.engine import (KerasNet, Layer,
                                                         flax_leaves,
                                                         set_variables)
        from analytics_zoo_tpu_torch.learn.quantize import (dequantize,
                                                            quantize_params)
        from analytics_zoo_tpu_torch.models.layers import (
            batch_stats_from_flax, params_from_flax)

        if quantize not in (None, "int8", "bf16", "int8_mxu"):
            raise ValueError(f"unknown quantize mode {quantize!r} "
                             f"(int8|bf16|int8_mxu)")
        keras = isinstance(model, Layer)
        dev = resolve_device(device)
        # the reference's leaves, keyed by (collection, *path)
        flat = {path: torch.as_tensor(np.array(leaf)) for path, leaf in
                _tree_items({k: variables[k] for k in ("params",
                                                        "batch_stats")
                             if k in variables})}
        new, stats = flat, None
        if quantize:
            new, stats = quantize_params(
                flat, "int8" if quantize == "int8_mxu" else quantize,
                model=None)
        deq = _unflatten(dequantize(new))
        if isinstance(model, KerasNet):
            model.ensure_built()
        if keras:
            set_variables(model, deq)
        else:
            # the model's own module's converter where it has one (the
            # LM's, BERT's), else the generic one
            convert = getattr(sys.modules.get(type(model).__module__),
                              "params_from_flax", params_from_flax)
            model.load_state_dict({
                **convert(deq["params"]),
                **batch_stats_from_flax(deq.get("batch_stats", {}))})
        self.load_torch(model, device=dev)
        self.quant_stats = stats
        self.int8_layers = 0
        if quantize == "int8_mxu" and not keras:
            return self._int8_sites(model, {
                k: v for k, v in new.items() if v is not flat[k]}, dev)
        if not (quantize and keras):
            return self
        leaves = {lf.path: lf for lf in flax_leaves(model)
                  if lf.collection == "params"}
        rest = []   # (leaf, its quantized value on the card), at rest
        for key, v in new.items():
            if v is flat[key]:
                continue            # not quantized
            path = key[1:]
            lf = leaves[path]
            v = ({k: t.to(dev) if torch.is_tensor(t) else t
                  for k, t in v.items()} if isinstance(v, dict)
                 else v.to(dev))
            if quantize == "int8_mxu" and path[-1] == "kernel" and \
                    _attach_int8(lf, v):
                self.int8_layers += 1
            elif lf.rows is None:
                rest.append((lf, v))
                lf.tensor.data = torch.empty(0, device=dev)
        inner = self._apply_fn

        def apply_fn(*feats):
            with self._quant_lock:
                for lf, v in rest:
                    w = dequantize({"w": v})["w"]
                    lf.tensor.data = lf.port_value(w).contiguous()
                try:
                    return inner(*feats)
                finally:
                    for lf, _ in rest:
                        lf.tensor.data = torch.empty(0, device=dev)

        self._apply_fn = apply_fn
        return self

    def _int8_sites(self, model, quantized: dict, dev) -> "InferenceModel":
        """``load_flax(quantize="int8_mxu")`` of a module outside the
        Keras API: the layers the reference's interceptor takes
        (``learn.quantize.int8_sites``, keyed by flax path) keep their
        int8 kernels on the device, their float weights released, and
        every forward of ``predict`` runs them as int8 products
        (``models.layers.int8_scope``); every other quantized leaf
        serves its dequantized weights."""
        from analytics_zoo_tpu_torch.learn.quantize import int8_sites
        from analytics_zoo_tpu_torch.models.layers import int8_scope

        sites = {}
        for mod, q in int8_sites(model, quantized).items():
            sites[mod] = {k: t.to(dev) if torch.is_tensor(t) else t
                          for k, t in q.items()}
            mod.weight.data = torch.empty(0, device=dev)
        self.int8_layers = len(sites)
        inner = self._apply_fn

        def apply_fn(*feats):
            with int8_scope(sites):
                return inner(*feats)

        self._apply_fn = apply_fn
        return self

    def load_openvino(self, xml_path: str, bin_path: str = None,
                      quantize: Optional[str] = None,
                      device=None) -> "InferenceModel":
        """Serve an OpenVINO IR (``.xml`` + ``.bin``) through
        ``net/openvino_ir.py`` on ``device`` (``cuda`` unless the caller
        names another).  ``quantize``: ``None``, ``"int8"`` (weight-only
        symmetric int8, one scale per output channel, the reference's
        IR int8 role; no calibration set) or ``"bf16"``; the weights
        stay quantized on the device and each ``predict`` dequantizes
        them, and ``quant_stats`` reports the compression."""
        from analytics_zoo_tpu_torch.learn.quantize import (
            dequantize, quantize_params)
        from analytics_zoo_tpu_torch.net import Net

        if quantize == "int8_mxu":
            raise ValueError(
                "quantize='int8_mxu' is only supported by load_flax "
                "(flax-linen models); use 'int8' (weight-only) here")
        net = Net.load_openvino(xml_path, bin_path)
        self.load_torch(net, device=device)
        if not quantize:
            return self
        params = net.params
        new, self.quant_stats = quantize_params(params, quantize, model=None)
        self._qstate = {k: v for k, v in new.items() if v is not params[k]}
        net.release(self._qstate)
        dev = self.device

        def apply_fn(*feats):
            with torch.inference_mode():
                return net(*[torch.as_tensor(np.ascontiguousarray(f),
                                             device=dev) for f in feats],
                           params={**net.params,
                                   **dequantize(self._qstate)})

        self._apply_fn = apply_fn
        return self

    def load_tf(self, path_or_fn, signature: str = "serving_default",
                quantize: Optional[str] = None):
        from analytics_zoo_tpu_torch.net import _tf_later

        raise _tf_later("InferenceModel.load_tf")

    def load_torch(self, module, device=None) -> "InferenceModel":
        """Serve a torch ``nn.Module``, or one at a path ``torch.load``
        reads (``Net.load_torch``): ``predict(*inputs)`` feeds the
        host arrays to the module's forward positionally, as tensors on
        ``device`` (``cuda`` unless the caller names another), with
        ``train=False`` where the forward takes it, under
        ``torch.inference_mode()``, and returns its output as numpy (a
        tuple of outputs as a tuple; bf16 as f32)."""
        import inspect

        from analytics_zoo_tpu_torch.device import resolve_device
        from analytics_zoo_tpu_torch.net import Net

        module = Net.load_torch(module)
        dev = resolve_device(device)
        self.model = module.to(dev).eval()
        self.device = dev
        try:
            takes_train = "train" in inspect.signature(
                module.forward).parameters
        except (TypeError, ValueError):
            takes_train = False
        kw = {"train": False} if takes_train else {}

        def apply_fn(*feats):
            with torch.inference_mode():
                return self.model(*[torch.as_tensor(
                    np.ascontiguousarray(f), device=dev) for f in feats],
                    **kw)

        self._apply_fn = apply_fn
        # a stale generator's hooks and bounds would corrupt plain inputs
        self._pre_pad = None
        self.max_prompt_width = None
        self.prompt_pad_id = None
        self._gen_max_new_tokens = None
        self._gen_prompt_buckets = None
        self.spec_stats = None
        self._spec_draft = None
        self._qstate, self.quant_stats = None, None
        return self

    def load(self, path: str, model, device=None) -> "InferenceModel":
        """Serve an ``Estimator.save`` export at ``path`` (the port's
        ``model.pt``, not the reference's orbax payload) with ``model``,
        the module it was trained as: its weights are loaded, then
        :meth:`load_torch`."""
        from analytics_zoo_tpu_torch.learn.estimator import load_export

        model.load_state_dict(load_export(path))
        return self.load_torch(model, device=device)

    # ---- predict -----------------------------------------------------

    def predict(self, *inputs: np.ndarray) -> np.ndarray:
        """Batched forward; inputs are ``[N, ...]`` host arrays.  N is
        padded up to the next batch bucket."""
        return self.predict_async(*inputs)()

    def predict_async(self, *inputs: np.ndarray) -> Callable[[], np.ndarray]:
        """Launch the forward and return a zero-argument callable that
        waits for it and yields the numpy output (the serving loop's
        pipelining hook: CUDA launches are asynchronous, and only the
        copy to the host waits)."""
        if self._apply_fn is None:
            raise RuntimeError("load a model first")
        if self._pre_pad is not None:
            inputs = self._pre_pad(inputs)
        n = len(inputs[0])
        bucket = _next_bucket(n, self._buckets)
        if n > bucket:          # n above the largest bucket: chunk
            return lambda: self._predict_chunked(inputs, bucket)
        padded = []
        for a in inputs:
            a = np.asarray(a)
            if len(a) < bucket:
                pad = np.zeros((bucket - len(a),) + a.shape[1:], a.dtype)
                a = np.concatenate([a, pad])
            padded.append(a)
        # padding rows carry length 0 (generate clamps them to 1) or an
        # all-zero mask; they are sliced off the result
        with self._sem:
            out = self._apply_fn(*padded)
        return lambda: _host(out, n)

    def _predict_chunked(self, inputs, bucket: int):
        n = len(inputs[0])
        outs = []
        for lo in range(0, n, bucket):
            outs.append(self.predict(*[np.asarray(a)[lo:lo + bucket]
                                       for a in inputs]))
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate(xs) for xs in zip(*outs))
        return np.concatenate(outs)

    def set_concurrency(self, n: int) -> "InferenceModel":
        """Resize the predict semaphore (ServingConfig.core_number)."""
        self._sem = threading.Semaphore(max(1, n))
        return self
