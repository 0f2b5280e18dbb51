"""Draft-model distillation, the companion of speculative decoding.

The port of ``analytics_zoo_tpu/models/distill.py``.  Speculation pays
only when the draft guesses like the target, and a draft trained to
match the target's token distribution does.  :class:`DistillLM` holds a
frozen ``target`` and the ``draft`` it teaches; one Estimator fit trains
the draft alone:

    draft_state, history = distill_draft(target, target_state, draft,
                                         data)

The target's forward runs under ``torch.no_grad()`` with ``train=False``:
no dropout, no activations kept and no backward through it.  A
:class:`DistillLM` sets the target's parameters to
``requires_grad=False``, and that flag is how the optimizer tells them
from the draft's (:func:`freeze_target_optimizer`), so no optimizer
state exists for the target.  The flags stay set on the module handed
in; :func:`distill_draft` gives them back when it is done.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.models.lm import TransformerLM


class DistillLM(nn.Module):
    """Train-time pair: the frozen ``target`` teaches ``draft``.

    ``forward(tokens, train=False, *, rng=None)`` returns the per-sample
    loss ``[B]``: ``kl_weight * T² * KL(target_T || draft_T) + ce_weight
    * CE(draft, next token)``, each a mean over positions, where ``_T``
    is softened by ``temperature`` and position t teaches token t+1.  Use
    ``loss=distill_loss`` and :func:`freeze_target_optimizer`.  The
    target's parameters are set to ``requires_grad=False`` here and left
    so."""

    def __init__(self, draft: TransformerLM, target: TransformerLM,
                 temperature: float = 1.0, kl_weight: float = 1.0,
                 ce_weight: float = 0.0):
        super().__init__()
        if draft.vocab_size != target.vocab_size:
            raise ValueError(f"draft vocab {draft.vocab_size} != target "
                             f"vocab {target.vocab_size}")
        self.draft = draft
        self.target = target.requires_grad_(False)
        self.temperature = float(temperature)
        self.kl_weight = float(kl_weight)
        self.ce_weight = float(ce_weight)

    def forward(self, tokens, train: bool = False, *,
                rng: Optional[int] = None):
        with torch.no_grad():
            t_logits = self.target(tokens, False).float()[:, :-1]
        d_logits = self.draft(tokens, train, rng=rng).float()[:, :-1]
        inv_t = 1.0 / self.temperature
        t_logp = F.log_softmax(t_logits * inv_t, dim=-1)
        d_logp = F.log_softmax(d_logits * inv_t, dim=-1)
        # forward KL, mean over positions; T² keeps the gradient's scale
        # comparable across temperatures
        kl = torch.sum(torch.exp(t_logp) * (t_logp - d_logp), dim=-1)
        loss = self.kl_weight * self.temperature ** 2 * kl.mean(dim=-1)
        if self.ce_weight:
            V = d_logits.shape[-1]
            ce = F.cross_entropy(d_logits.reshape(-1, V),
                                 tokens[:, 1:].reshape(-1).long(),
                                 reduction="none").view(d_logits.shape[:2])
            loss = loss + self.ce_weight * ce.mean(dim=-1)
        return loss


def distill_loss(per_sample, _tokens):
    """Estimator loss for :class:`DistillLM`: the model's output is the
    loss of each row, so this is their mean."""
    return per_sample.mean()


def freeze_target_optimizer(tx):
    """The optimizer of a :class:`DistillLM` fit: ``tx`` (a learning rate,
    for AdamW as the reference's default ``optax.adamw``, or a callable
    ``params -> Optimizer``) over the parameters that train, which leaves
    out the frozen target's.  Returns the callable the Estimator takes."""
    def make(params):
        params = [p for p in params if p.requires_grad]
        if isinstance(tx, (int, float)):
            return _adamw(params, float(tx))
        return tx(params)
    return make


def _adamw(params, lr: float):
    """``optax.adamw(lr)``'s defaults: b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def distill_draft(target: TransformerLM, target_state,
                  draft: TransformerLM, data, *,
                  epochs: int = 3, batch_size: int = 8,
                  optimizer=None, temperature: float = 2.0,
                  ce_weight: float = 0.1, device=None,
                  estimator_kwargs: Optional[dict] = None):
    """One-call distillation: fit ``draft`` to match ``target`` (whose
    weights are ``target_state``, a ``state_dict``, or ``None`` for its
    own) on ``data`` (a dict with a ``tokens`` ``[N, T]`` int32 column),
    on ``device`` (``cuda`` unless the caller names another).
    ``optimizer`` defaults to AdamW at 3e-3, the reference's.  Returns
    ``(draft_state_dict, history)``: the state dict goes to
    ``speculative_generate`` or ``load_torch_generator(draft_model=...,
    draft_variables=...)`` as it is.  A target state of other shapes
    raises ``ValueError``, and so does a draft of another vocabulary.
    The target's ``requires_grad`` flags are as they were on return."""
    from analytics_zoo_tpu_torch.learn.estimator import Estimator

    if target_state is not None:
        want = target.state_dict()
        if set(want) != set(target_state) or any(
                tuple(target_state[k].shape) != tuple(want[k].shape)
                for k in want):
            raise ValueError(
                "target_state's shapes do not match the target model's: "
                "wrong checkpoint?")
        target.load_state_dict(target_state)
    live = [p for p in target.parameters() if p.requires_grad]
    try:
        pair = DistillLM(draft, target, temperature=temperature,
                         ce_weight=ce_weight)
        est = Estimator.from_torch(
            model=pair, loss=distill_loss,
            optimizer=freeze_target_optimizer(
                optimizer if optimizer is not None else 3e-3),
            feature_cols=("tokens",), label_cols=("tokens",),
            device=device, **(estimator_kwargs or {}))
        hist = est.fit(data, epochs=epochs, batch_size=batch_size)
    finally:
        for p in live:
            p.requires_grad_(True)
    return {k: v.detach() for k, v in draft.state_dict().items()}, hist
