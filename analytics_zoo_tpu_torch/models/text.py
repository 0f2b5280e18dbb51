"""Text models: ``TextClassifier`` and ``KNRM``, the port of
``analytics_zoo_tpu/models/text.py``.

- :class:`TextClassifier`: a word embedding, then a CNN, LSTM or GRU
  encoder, dropout 0.2, ``Dense(128)`` + ReLU and an f32 head.  The CNN
  is flax's ``nn.Conv(kernel_size=(5,))``, which pads ``SAME`` (2 and
  2), so the sequence keeps its length before the max over time; the
  recurrent encoders are an :class:`~analytics_zoo_tpu_torch.models.
  rnn.RNNStack` of one layer that returns the last step.
- :class:`KNRM`: kernel-pooled text matching.  Both texts' embeddings
  are l2-normalised in f32 (``max(norm, 1e-6)``), their cosine
  interaction is one batched product in the model dtype, read back in
  f32; RBF kernels (the exact-match kernel first, at ``exact_sigma``)
  are masked by the query/doc pair mask, summed over the doc, taken
  through ``log1p``, masked by the query mask and summed over the query;
  a ``ranking`` head gives ``[B, 1]``, ``classification`` ``[B, 2]``.
  The kernels stay in f32: at ``exact_sigma = 0.001`` an exponent
  reaches -5e5.

Cast points follow the reference: the embedding table is f32 and its
rows are cast to ``dtype`` (bf16 by default); the conv and the hidden
Dense run in ``dtype``, the heads in f32.  ``embed_weights`` (a numpy
``[vocab, dim]`` table, GloVe's from ``data.text.load_glove``) is
copied into the embedding, which trains (flax has no freeze); a table
of another shape raises the reference's ``ValueError``.  Without it
the table starts normal with std 0.02.  The modules name their
parameters as the reference's tree does (``word_embedding``, ``conv``
or ``rnn.<Cell>_0``, ``Dense_0``, ``head``), so ``models.layers.
params_from_flax`` loads its weights.  A training forward with dropout
takes ``rng`` (the Estimator passes ``fold_in(seed, step)``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.models.layers import (Conv, Dense, Embed, conv,
                                                   dense, same_padding)
from analytics_zoo_tpu_torch.models.rnn import RNNStack
from analytics_zoo_tpu_torch.models.transformer import dropout, site_seed


def _embedding(vocab_size: int, embed_dim: int,
               weights: Optional[np.ndarray]) -> Embed:
    """flax ``nn.Embed``, normal(0.02) or a copy of ``weights``."""
    emb = Embed(vocab_size, embed_dim, std=0.02)
    if weights is not None:
        w = np.asarray(weights, np.float32)
        if w.shape != (vocab_size, embed_dim):
            raise ValueError(
                f"pretrained embedding shape {w.shape} != expected "
                f"{(vocab_size, embed_dim)} (vocab_size x embed_dim)")
        with torch.no_grad():
            emb.weight.copy_(torch.from_numpy(w))
    return emb


class TextClassifier(nn.Module):
    """ref-parity ctor: class_num, token_length (the embedding width),
    sequence_length, encoder (cnn|lstm|gru), encoder_output_dim.
    ``forward(tokens [B, T]) -> [B, class_num]`` f32 logits."""

    def __init__(self, class_num: int, vocab_size: int,
                 token_length: int = 200, sequence_length: int = 500,
                 encoder: str = "cnn", encoder_output_dim: int = 256,
                 embed_weights: Optional[np.ndarray] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.encoder, self.dtype = encoder.lower(), dtype
        self.word_embedding = _embedding(vocab_size, token_length,
                                         embed_weights)
        if self.encoder == "cnn":
            self.conv = Conv(token_length, encoder_output_dim, 5)
        elif self.encoder in ("lstm", "gru"):
            self.rnn = RNNStack([encoder_output_dim], rnn_type=self.encoder,
                                dtype=dtype, in_features=token_length)
        else:
            raise ValueError(f"unknown encoder {encoder!r}")
        self.Dense_0 = Dense(encoder_output_dim, 128)
        self.head = Dense(128, class_num)

    def forward(self, tokens, train: bool = False,
                rng: Optional[int] = None):
        dt = self.dtype
        x = self.word_embedding(tokens.long()).to(dt)
        if self.encoder == "cnn":
            h = torch.relu(conv(self.conv, x, dt, same_padding(5)))
            h = h.amax(dim=1)
        else:
            h = self.rnn(x, train)
        h = dropout(h, 0.2, site_seed(rng, 0), train)
        h = torch.relu(dense(self.Dense_0, h, dt))
        return dense(self.head, h, torch.float32)


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


class KNRM(nn.Module):
    """ref-parity ctor: text1_length, text2_length, embed_dim,
    kernel_num, sigma, exact_sigma, target_mode (ranking|classification).

    ``forward(text1 [B, T1], text2 [B, T2])`` (id 0 pads) -> ``[B, 1]``
    ranking logits or ``[B, 2]`` classification logits, f32."""

    def __init__(self, vocab_size: int, text1_length: int = 10,
                 text2_length: int = 40, embed_dim: int = 300,
                 kernel_num: int = 21, sigma: float = 0.1,
                 exact_sigma: float = 0.001, target_mode: str = "ranking",
                 embed_weights: Optional[np.ndarray] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.target_mode, self.dtype = target_mode, dtype
        self.word_embedding = _embedding(vocab_size, embed_dim,
                                         embed_weights)
        # kernel centres: the exact-match kernel (mu 1, exact_sigma)
        # first, then K - 1 spaced over [-1, 1]
        mus, sigmas = [1.0], [exact_sigma]
        if kernel_num > 1:
            step = 2.0 / (kernel_num - 1)
            mus += [1.0 - step / 2 - i * step for i in range(kernel_num - 1)]
            sigmas += [sigma] * (kernel_num - 1)
        self.register_buffer("mu", torch.tensor(mus, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("sigma", torch.tensor(sigmas,
                                                   dtype=torch.float32),
                             persistent=False)
        self.head = Dense(kernel_num,
                          2 if target_mode == "classification" else 1)

    def forward(self, text1, text2, train: bool = False):
        q = self.word_embedding(text1.long())               # [B, T1, E]
        d = self.word_embedding(text2.long())               # [B, T2, E]
        inter = torch.bmm(_l2norm(q).to(self.dtype),
                          _l2norm(d).to(self.dtype).transpose(1, 2)
                          ).float()                         # [B, T1, T2]
        qmask = (text1 > 0).float()[:, :, None]             # [B, T1, 1]
        dmask = (text2 > 0).float()[:, None, :]             # [B, 1, T2]
        pair_mask = qmask * dmask
        sg = self.sigma
        kv = torch.exp(-torch.square(inter[..., None] - self.mu)
                       / (2 * sg * sg))
        kv = (kv * pair_mask[..., None]).sum(dim=2)         # [B, T1, K]
        phi = (torch.log1p(kv) * qmask).sum(dim=1)          # [B, K]
        return dense(self.head, phi, None)


__all__ = ["TextClassifier", "KNRM"]
