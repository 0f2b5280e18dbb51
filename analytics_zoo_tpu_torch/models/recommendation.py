"""Recommendation models — WideAndDeep, SessionRecommender, DIEN (the
north star's config #5).

The port of ``analytics_zoo_tpu/models/recommendation.py``:

- :class:`ColumnFeatureInfo`, the input schema, copied;
- :class:`WideAndDeep`: the wide branch is a gather-sum over one table
  (``wide_embedding``, zeros at start) whose rows at id 0 are masked on
  the output, so padding neither shifts a logit nor trains row 0 (its
  gradient is exactly 0); the deep branch concatenates one-hot rows of
  ``eye(d + 1)`` for the indicator columns, the embeddings of the
  embedding columns and the continuous columns, all in the model dtype,
  then the MLP and an f32 head.  Inputs come positionally in
  :meth:`WideAndDeep.feature_groups` order, or as keywords;
- :class:`SessionRecommender`: a GRU stack over the session's item
  embeddings and, with ``include_history``, a masked mean of the
  history's embeddings through an MLP; logits over the catalog;
- :class:`AUGRUCell` and :class:`DIEN`: an interest GRU over the
  behaviour sequence, target attention (f32 scores, masked to -1e9,
  soft-maxed, then multiplied by the mask), and an AUGRU over the
  extracted interests whose update gate the attention scales.  Unlike
  the GRU's, the AUGRU's carry is in the model dtype: it starts as
  zeros in that dtype and each new state is cast back to it, as the
  reference does.  The MLP reads ``[final, target, (final * q).sum]``
  in f32.

Cast points follow the reference: f32 tables, towers in the model dtype
(bf16 by default), f32 heads.  Ids may arrive as int32.
``WND_PARTITION_RULES`` (the reference's) split every embedding table on
its rows over ``tp`` under the Estimator's ``partition_rules=``
(vocab-parallel lookups, ``parallel.partition.vocab_split``); a table
whose rows do not divide tp stays whole.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# params_from_flax: the reference WideAndDeep's, SessionRecommender's or
# DIEN's variables["params"] as this module's state_dict
from analytics_zoo_tpu_torch.models.layers import (  # noqa: F401
    Dense, Embed, dense, params_from_flax)
from analytics_zoo_tpu_torch.models.rnn import RNNStack
from analytics_zoo_tpu_torch.parallel.partition import P

WND_PARTITION_RULES = (
    (r"embedding", P("tp", None)),
    (r".*", P()),
)


@dataclasses.dataclass
class ColumnFeatureInfo:
    """Schema for WideAndDeep inputs (ref-parity field names).

    Batch keys expected by the model:
      - ``wide_cols``:  int [B, n_wide]  — multi-hot bucket ids, already
        offset per-column (use ``wide_offsets()``; pad with 0 = no-op id).
      - ``indicator_cols``: int [B, n_ind] — one id per indicator column.
      - ``embed_cols``: int [B, n_embed] — one id per embedding column.
      - ``continuous_cols``: float [B, n_cont].
    """

    wide_base_cols: Sequence[str] = ()
    wide_base_dims: Sequence[int] = ()
    wide_cross_cols: Sequence[str] = ()
    wide_cross_dims: Sequence[int] = ()
    indicator_cols: Sequence[str] = ()
    indicator_dims: Sequence[int] = ()
    embed_cols: Sequence[str] = ()
    embed_in_dims: Sequence[int] = ()
    embed_out_dims: Sequence[int] = ()
    continuous_cols: Sequence[str] = ()

    @property
    def wide_dims(self) -> Sequence[int]:
        return tuple(self.wide_base_dims) + tuple(self.wide_cross_dims)

    @property
    def wide_dim_total(self) -> int:
        return int(sum(self.wide_dims))

    def wide_offsets(self):
        """Per-column offsets into the flattened wide id space (id 0 of the
        flattened space is reserved as padding/no-op)."""
        offs, acc = [], 1
        for d in self.wide_dims:
            offs.append(acc)
            acc += int(d)
        return offs


def _mlp(module: nn.Module, width: int, hidden: Sequence[int]) -> int:
    """``Dense_0 .. Dense_{n-1}`` on ``module``; returns the last width."""
    for i, h in enumerate(hidden):
        setattr(module, f"Dense_{i}", Dense(width, int(h)))
        width = int(h)
    return width


def _run_mlp(module: nn.Module, n: int, x, dtype):
    for i in range(n):
        x = torch.relu(dense(getattr(module, f"Dense_{i}"), x, dtype))
    return x


class WideAndDeep(nn.Module):
    """ref-parity ctor: class_num, column_info, model_type,
    hidden_layers."""

    def __init__(self, class_num: int, column_info: ColumnFeatureInfo,
                 model_type: str = "wide_n_deep",
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.class_num = class_num
        self.column_info = info = column_info
        self.model_type = model_type
        self.dtype = dtype
        self.n_hidden = len(hidden_layers)
        if model_type in ("wide", "wide_n_deep"):
            self.wide_embedding = Embed(info.wide_dim_total + 1, class_num,
                                        std=0.0)
        if model_type in ("deep", "wide_n_deep"):
            width = sum(int(d) + 1 for _, d in zip(info.indicator_cols,
                                                   info.indicator_dims))
            for name, din, dout in zip(info.embed_cols, info.embed_in_dims,
                                       info.embed_out_dims):
                setattr(self, f"deep_embedding_{name}",
                        Embed(int(din) + 1, int(dout)))
                width += int(dout)
            width += len(info.continuous_cols)
            width = _mlp(self, width, hidden_layers)
            self.deep_head = Dense(width, class_num)

    def feature_groups(self):
        """Input groups this schema actually uses, in positional order —
        the estimator's ``feature_cols`` should name batch keys in this
        order (absent groups are skipped, so schemas without e.g.
        indicator columns don't misalign positional features)."""
        info = self.column_info
        groups = []
        if self.model_type in ("wide", "wide_n_deep") and info.wide_dims:
            groups.append("wide_cols")
        if self.model_type in ("deep", "wide_n_deep"):
            if info.indicator_cols:
                groups.append("indicator_cols")
            if info.embed_cols:
                groups.append("embed_cols")
            if info.continuous_cols:
                groups.append("continuous_cols")
        return groups

    def forward(self, *cols, train: bool = False, **named):
        info = self.column_info
        groups = self.feature_groups()
        feats = dict(zip(groups, cols))
        feats.update({k: v for k, v in named.items() if v is not None})
        missing = [g for g in groups if g not in feats]
        if missing:
            raise ValueError(f"WideAndDeep missing inputs {missing}; "
                             f"expected positional order {groups}")
        wide_cols = feats.get("wide_cols")
        logits = []
        if self.model_type in ("wide", "wide_n_deep") and \
                wide_cols is not None:
            # the padding id's rows are masked on the output: row 0
            # never trains and padding cannot shift a logit
            valid = (wide_cols > 0).to(torch.float32)[..., None]
            logits.append((self.wide_embedding(wide_cols) * valid).sum(1))
        if self.model_type in ("deep", "wide_n_deep"):
            parts = []
            ind = feats.get("indicator_cols")
            for j, (_, d) in enumerate(zip(info.indicator_cols,
                                           info.indicator_dims)):
                parts.append(F.one_hot(ind[:, j].long(), int(d) + 1)
                             .to(self.dtype))
            emb = feats.get("embed_cols")
            for j, name in enumerate(info.embed_cols):
                table = getattr(self, f"deep_embedding_{name}")
                parts.append(table(emb[:, j]).to(self.dtype))
            if info.continuous_cols:
                parts.append(feats["continuous_cols"].to(self.dtype))
            x = _run_mlp(self, self.n_hidden, torch.cat(parts, -1),
                         self.dtype)
            logits.append(dense(self.deep_head, x, torch.float32))
        out = logits[0] if len(logits) == 1 else logits[0] + logits[1]
        return out.to(torch.float32)


class SessionRecommender(nn.Module):
    """ref-parity ctor: item_count, item_embed, rnn_hidden_layers,
    session_length, include_history, mlp_hidden_layers, history_length.

    Inputs: ``session`` int [B, session_length] (0 = padding) and, when
    ``include_history``, ``history`` int [B, history_length]. Output:
    logits over the item catalog [B, item_count + 1].
    """

    def __init__(self, item_count: int, item_embed: int = 100,
                 rnn_hidden_layers: Sequence[int] = (40, 20),
                 session_length: int = 0, include_history: bool = False,
                 mlp_hidden_layers: Sequence[int] = (40, 20),
                 history_length: int = 0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.include_history = include_history
        self.item_embedding = Embed(item_count + 1, item_embed)
        self.session_gru = RNNStack(rnn_hidden_layers, rnn_type="gru",
                                    dtype=dtype, in_features=item_embed)
        width = int(rnn_hidden_layers[-1])
        self.n_hidden = 0
        if include_history:
            self.n_hidden = len(mlp_hidden_layers)
            width += _mlp(self, item_embed, mlp_hidden_layers)
        self.head = Dense(width, item_count + 1)

    def forward(self, session, history=None, train: bool = False):
        x = self.session_gru(self.item_embedding(session).to(self.dtype),
                             train)
        if self.include_history:
            if history is None:
                raise ValueError("include_history=True needs `history`")
            # mean-pool the history's embeddings (padding id 0 masked)
            h = self.item_embedding(history).to(self.dtype)
            mask = (history > 0).to(self.dtype)[..., None]
            h = (h * mask).sum(1) / torch.clamp(mask.sum(1), min=1.0)
            h = _run_mlp(self, self.n_hidden, h, self.dtype)
            x = torch.cat([x, h.to(x.dtype)], -1)
        return dense(self.head, x, torch.float32)


class AUGRUCell(nn.Module):
    """A GRU cell whose update gate an attention score scales (DIEN's
    interest-evolution unit): ``r_x``, ``u_x``, ``c_x`` side by side in
    ``x``, ``r_h`` and ``u_h`` in ``h``, and ``c_h`` on ``r * h``; every
    one with a bias."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.features = features
        self.dtype = dtype
        self.x = Dense(in_features, 3 * features)
        self.h = Dense(features, 2 * features)
        self.c_h = Dense(features, features)

    def forward(self, carry, x, att):
        """One step: ``x [B, F]``, ``att [B]``; ``(new_h, new_h)``."""
        w = self.step_weights()
        return self.step(carry, dense(self.x, x, self.dtype), att, w)

    def step_weights(self):
        dt = self.dtype
        return (self.h.weight.to(dt), self.h.bias.to(dt),
                self.c_h.weight.to(dt), self.c_h.bias.to(dt))

    def step(self, h, xp, att, weights):
        wh, bh, wc, bc = weights
        xr, xu, xc = xp.chunk(3, dim=-1)
        hr, hu = F.linear(h.to(self.dtype), wh, bh).chunk(2, dim=-1)
        r = torch.sigmoid(xr + hr)
        u = torch.sigmoid(xu + hu)
        u = u * att[:, None].to(u.dtype)      # attention gates the update
        c = torch.tanh(xc + F.linear((r * h).to(self.dtype), wc, bc))
        new_h = ((1.0 - u) * h + u * c).to(h.dtype)
        return new_h, new_h


class DIEN(nn.Module):
    """Deep Interest Evolution Network.

    Inputs: ``item`` int [B] (target), ``history`` int [B, T]
    (behaviour sequence, 0 = padding).  Output: [B, 2] click logits.
    """

    def __init__(self, item_count: int, item_embed: int = 32,
                 gru_hidden: int = 32, mlp_hidden: Sequence[int] = (64, 32),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.gru_hidden = gru_hidden
        self.item_embedding = Embed(item_count + 1, item_embed, std=0.05)
        self.interest_gru = RNNStack((gru_hidden,), rnn_type="gru",
                                     return_sequences=True, dtype=dtype,
                                     in_features=item_embed)
        self.att_proj = Dense(item_embed, gru_hidden)
        self.augru = AUGRUCell(gru_hidden, gru_hidden, dtype)
        self.n_hidden = len(mlp_hidden)
        width = _mlp(self, gru_hidden + item_embed + 1, mlp_hidden)
        self.head = Dense(width, 2)

    def forward(self, item, history, train: bool = False):
        tgt = self.item_embedding(item).to(self.dtype)          # [B, E]
        hist = self.item_embedding(history).to(self.dtype)      # [B, T, E]
        mask = (history > 0).to(torch.float32)                  # [B, T]
        interests = self.interest_gru(hist)                     # [B, T, H]
        q = dense(self.att_proj, tgt, self.dtype)               # [B, H]
        scores = torch.einsum("bth,bh->bt", interests.float(), q.float())
        scores = scores / math.sqrt(self.gru_hidden)
        scores = torch.where(mask > 0, scores,
                             torch.full_like(scores, -1e9))
        att = torch.softmax(scores, dim=-1) * mask              # [B, T]
        # interest evolution over the EXTRACTED interests
        xs = interests.to(self.dtype)
        xp = dense(self.augru.x, xs, self.dtype)
        att = att.to(self.dtype)
        weights = self.augru.step_weights()
        h = torch.zeros(item.shape[0], self.gru_hidden, dtype=self.dtype,
                        device=xs.device)
        for t in range(xs.shape[1]):
            h, _ = self.augru.step(h, xp[:, t], att[:, t], weights)
        x = torch.cat([h.float(), tgt.float(),
                       (h * q).sum(-1, keepdim=True).float()], -1)
        x = _run_mlp(self, self.n_hidden, x, self.dtype)
        return dense(self.head, x.float(), torch.float32)
