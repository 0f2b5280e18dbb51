"""tfpark.text.keras: the named NLP models, the port of
``analytics_zoo_tpu/tfpark/text/keras.py``.

A word embedding and a bidirectional GRU (:class:`BiRNN`) feed
per-token and per-utterance heads:

- :class:`NER`: entity logits ``[B, T, num_entities]``;
- :class:`POSTagger`: part-of-speech logits ``[B, T, num_pos_tags]``;
- :class:`IntentEntity`: ``(intent [B, num_intents], entity [B, T,
  num_entities])``; the utterance is the max over time of the encoder's
  states where the token is not padding (``where(mask, h, -1e9)``, so a
  fully padded row pools to -1e9, as in the reference);
- :func:`intent_entity_loss`: the mean intent cross-entropy plus the
  mean entity cross-entropy over all ``B x T`` tokens, padding included.

:class:`BiRNN` is flax's pair of ``nn.RNN``: the forward cell over the
sequence, and the backward cell over it reversed with the outputs put
back in input order (``reverse=True, keep_order=True``, no
``seq_lengths``), so the backward pass runs over the whole padded
length, padding first.  Its cells are ``GRUCell_0`` (forward) and
``GRUCell_1`` (backward), as the reference's tree names them, so
``models.layers.params_from_flax`` loads its weights.  Cast points: the
embedding rows cast to ``dtype`` (bf16 by default), the cells' gates in
``dtype`` and their carries in f32, the heads in f32.  Dropout (0.25
after the encoder) draws from ``rng`` in a training forward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.models.layers import Dense, dense
from analytics_zoo_tpu_torch.models.rnn import make_cell, scan
from analytics_zoo_tpu_torch.models.text import _embedding
from analytics_zoo_tpu_torch.models.transformer import dropout, site_seed


class BiRNN(nn.Module):
    """Bidirectional recurrent encoder over ``[B, T, F] -> [B, T, 2H]``."""

    def __init__(self, in_features: int, hidden: int,
                 rnn_type: str = "gru",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cells = [make_cell(rnn_type, in_features, hidden, dtype)
                 for _ in range(2)]
        self.names = [f"{type(c).__name__}_{i}" for i, c in enumerate(cells)]
        for name, cell in zip(self.names, cells):
            self.add_module(name, cell)

    def forward(self, x):
        fwd, bwd = (getattr(self, n) for n in self.names)
        _, yf = scan(fwd, x)
        _, yb = scan(bwd, x.flip(1))
        return torch.cat([yf, yb.flip(1)], dim=-1)


class TextModel(nn.Module):
    """Shared encoder: word embedding -> BiGRU -> dropout."""

    def __init__(self, vocab_size: int, embed_dim: int = 100,
                 hidden: int = 100, dropout: float = 0.25,
                 embed_weights: Optional[np.ndarray] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dropout, self.dtype = float(dropout), dtype
        self.word_embedding = _embedding(vocab_size, embed_dim,
                                         embed_weights)
        self.birnn = BiRNN(embed_dim, hidden, dtype=dtype)

    def encode(self, tokens, train: bool, rng: Optional[int]):
        x = self.word_embedding(tokens.long()).to(self.dtype)
        h = self.birnn(x)
        return dropout(h, self.dropout, site_seed(rng, 0), train)


class NER(TextModel):
    """Named-entity tagger: per-token entity logits ``[B, T,
    num_entities]``."""

    def __init__(self, vocab_size: int, num_entities: int = 9, **kw):
        super().__init__(vocab_size, **kw)
        self.entity_head = Dense(2 * self.birnn.GRUCell_0.features,
                                 num_entities)

    def forward(self, tokens, train: bool = False,
                rng: Optional[int] = None):
        h = self.encode(tokens, train, rng)
        return dense(self.entity_head, h, torch.float32)


class POSTagger(TextModel):
    """Part-of-speech tagger: per-token tag logits ``[B, T,
    num_pos_tags]``."""

    def __init__(self, vocab_size: int, num_pos_tags: int = 45, **kw):
        super().__init__(vocab_size, **kw)
        self.pos_head = Dense(2 * self.birnn.GRUCell_0.features,
                              num_pos_tags)

    def forward(self, tokens, train: bool = False,
                rng: Optional[int] = None):
        h = self.encode(tokens, train, rng)
        return dense(self.pos_head, h, torch.float32)


class IntentEntity(TextModel):
    """Joint intent classification and entity tagging: ``(intent_logits
    [B, I], entity_logits [B, T, E])``."""

    def __init__(self, vocab_size: int, num_intents: int = 8,
                 num_entities: int = 9, **kw):
        super().__init__(vocab_size, **kw)
        width = 2 * self.birnn.GRUCell_0.features
        self.intent_head = Dense(width, num_intents)
        self.entity_head = Dense(width, num_entities)

    def forward(self, tokens, train: bool = False,
                rng: Optional[int] = None):
        h = self.encode(tokens, train, rng)              # [B, T, 2H]
        mask = (tokens > 0)[:, :, None]
        pooled = torch.where(mask, h, torch.full((), -1e9, dtype=h.dtype,
                                                 device=h.device)
                             ).amax(dim=1)
        return (dense(self.intent_head, pooled, torch.float32),
                dense(self.entity_head, h, torch.float32))


def intent_entity_loss(preds, labels):
    """Joint loss for IntentEntity: CE(intent) + per-token CE(entity)."""
    intent_logits, entity_logits = preds
    intent_y, entity_y = labels
    li = F.cross_entropy(intent_logits.float(), intent_y.long())
    le = F.cross_entropy(
        entity_logits.float().reshape(-1, entity_logits.shape[-1]),
        entity_y.reshape(-1).long())
    return li + le


__all__ = ["TextModel", "BiRNN", "NER", "POSTagger", "IntentEntity",
           "intent_entity_loss"]
