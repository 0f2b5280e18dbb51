"""NeuralCF — neural collaborative filtering (the north star's config #1).

The port of ``analytics_zoo_tpu/models/ncf.py``: a GMF branch (the
elementwise product of user and item embeddings) beside an MLP tower
over the concatenated embeddings, merged into an f32 head.  Every table
has one row more than its count, so 0-based and 1-based ids both fit.
The embeddings are f32, the tower runs in the model dtype (bf16 by
default) and the head in f32, the reference's cast points.  Ids may
arrive as int32.  ``NCF_PARTITION_RULES`` (the reference's) split every
embedding table on its rows over ``tp`` when the Estimator gets them
(``partition_rules=``): each rank looks ids up in its rows and the
lookups are summed (``parallel.partition.vocab_split``); a table whose
rows do not divide tp (65 rows on tp=2) stays whole on every rank.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

# params_from_flax: the reference NeuralCF's variables["params"] as
# this module's state_dict
from analytics_zoo_tpu_torch.models.layers import (  # noqa: F401
    Dense, Embed, dense, params_from_flax)
from analytics_zoo_tpu_torch.parallel.partition import P

# vocab-dim sharding for the embedding tables; replicated dense tower
NCF_PARTITION_RULES = (
    (r"embedding", P("tp", None)),
    (r".*", P()),
)


class NeuralCF(nn.Module):
    """ref-parity ctor args: user_count, item_count, class_num,
    user_embed, item_embed, hidden_layers, include_mf, mf_embed."""

    def __init__(self, user_count: int, item_count: int, class_num: int = 2,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.include_mf = include_mf
        self.mlp_user_embedding = Embed(user_count + 1, user_embed)
        self.mlp_item_embedding = Embed(item_count + 1, item_embed)
        width = user_embed + item_embed
        self.n_hidden = len(hidden_layers)
        for i, h in enumerate(hidden_layers):
            setattr(self, f"Dense_{i}", Dense(width, int(h)))
            width = int(h)
        if include_mf:
            self.mf_user_embedding = Embed(user_count + 1, mf_embed)
            self.mf_item_embedding = Embed(item_count + 1, mf_embed)
            width += mf_embed
        self.head = Dense(width, class_num)

    def forward(self, user_ids, item_ids, train: bool = False):
        x = torch.cat([self.mlp_user_embedding(user_ids),
                       self.mlp_item_embedding(item_ids)], -1).to(self.dtype)
        for i in range(self.n_hidden):
            x = torch.relu(dense(getattr(self, f"Dense_{i}"), x, self.dtype))
        if self.include_mf:
            mf = (self.mf_user_embedding(user_ids)
                  * self.mf_item_embedding(item_ids)).to(self.dtype)
            x = torch.cat([x, mf], -1)
        return dense(self.head, x, torch.float32)
