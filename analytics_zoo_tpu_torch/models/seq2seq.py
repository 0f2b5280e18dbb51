"""Seq2Seq: an RNN encoder/decoder, the port of
``analytics_zoo_tpu/models/seq2seq.py``.

:class:`Seq2Seq` embeds the encoder's tokens, runs a stack of recurrent
layers (``enc_rnn_<i>``) and hands each layer's final carry through the
bridge to the decoder layer of the same depth (``dec_rnn_<i>``), which
runs teacher-forced over the decoder's tokens; an f32 ``generator``
head gives ``[B, T_dec, vocab]``.  The ``copy`` bridge passes the
carries on; the ``dense`` bridge applies one ``bridge_<i>`` Dense to
every leaf of a carry, both ``c`` and ``h`` of an LSTM's (the
reference's ``jax.tree.map``).  The embedding is shared by both sides.
Each layer holds its cell as ``cell`` (the reference's ``nn.RNN`` scope),
so ``models.layers.params_from_flax`` loads the reference's tree.

:func:`greedy_generate` encodes once, then runs ``decode_step`` (a
length-1 sequence through the decoder stack) ``max_len`` times in a
Python loop from ``bos_id``, feeding back the argmax; it returns int32
``[B, max_len]``, and once a row emits ``eos_id`` it stays at it.

Cast points follow the reference: embedding rows cast to ``dtype`` (bf16
by default), the cells' gates in ``dtype`` and their carries in f32, the
bridges and the head in f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.layers import Dense, Embed, dense
from analytics_zoo_tpu_torch.models.rnn import make_cell, scan


class _RNN(nn.Module):
    """flax ``nn.RNN(cell, return_carry=True)``: its cell is ``cell``."""

    def __init__(self, cell: nn.Module):
        super().__init__()
        self.cell = cell

    def forward(self, x, carry=None):
        return scan(self.cell, x, carry)


def _tree_map(fn, carry):
    if isinstance(carry, tuple):
        return tuple(_tree_map(fn, c) for c in carry)
    return fn(carry)


class Seq2Seq(nn.Module):
    """ref-parity ctor (re-shaped): rnn_type, hidden_sizes, vocab_size,
    embed_dim, bridge (copy|dense)."""

    def __init__(self, vocab_size: int, embed_dim: int = 128,
                 hidden_sizes: Sequence[int] = (128,),
                 rnn_type: str = "gru", bridge: str = "copy",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.vocab_size, self.bridge, self.dtype = vocab_size, bridge, dtype
        self.hidden_sizes = [int(h) for h in hidden_sizes]
        self.embedding = Embed(vocab_size, embed_dim)
        for side in ("enc", "dec"):
            width = embed_dim
            for i, h in enumerate(self.hidden_sizes):
                setattr(self, f"{side}_rnn_{i}",
                        _RNN(make_cell(rnn_type, width, h, dtype)))
                width = h
        if bridge == "dense":
            for i, h in enumerate(self.hidden_sizes):
                setattr(self, f"bridge_{i}", Dense(h, h))
        self.generator = Dense(self.hidden_sizes[-1], vocab_size)

    def _layers(self, side: str):
        return [getattr(self, f"{side}_rnn_{i}")
                for i in range(len(self.hidden_sizes))]

    def _bridge(self, carries):
        if self.bridge == "copy":
            return carries
        return [_tree_map(lambda t, i=i: dense(getattr(self, f"bridge_{i}"),
                                               t, None), c)
                for i, c in enumerate(carries)]

    def encode(self, enc_tokens):
        """The decoder's initial carries (after the bridge)."""
        x = self.embedding(enc_tokens.long()).to(self.dtype)
        carries = []
        for rnn in self._layers("enc"):
            carry, x = rnn(x)
            carries.append(carry)
        return self._bridge(carries)

    def decode_step(self, tok, carries):
        """One greedy step: tok [B] -> (logits [B, V], new carries)."""
        x = self.embedding(tok.long())[:, None].to(self.dtype)
        new = []
        for rnn, c in zip(self._layers("dec"), carries):
            c2, x = rnn(x, c)
            new.append(c2)
        return dense(self.generator, x[:, 0].float(), torch.float32), new

    def forward(self, enc_tokens, dec_tokens, train: bool = False):
        """Teacher-forced: logits [B, T_dec, vocab] for next-token CE."""
        carries = self.encode(enc_tokens)
        x = self.embedding(dec_tokens.long()).to(self.dtype)
        for rnn, c in zip(self._layers("dec"), carries):
            _, x = rnn(x, c)
        return dense(self.generator, x.float(), torch.float32)


@torch.no_grad()
def greedy_generate(model: Seq2Seq, variables, enc_tokens, max_len: int,
                    bos_id: int = 1, eos_id: Optional[int] = None,
                    device=None) -> torch.Tensor:
    """Greedy decoding (ref-parity: Seq2seq.infer): ``max_len`` steps
    from ``bos_id``.  ``variables``: a ``state_dict`` loaded into
    ``model`` first, or ``None`` for its own weights.  Runs on
    ``device`` (``cuda`` unless the caller names another).  Returns int32
    ``[B, max_len]`` on that device; positions after ``eos_id`` are
    frozen at it."""
    dev = resolve_device(device)
    if variables is not None:
        model.load_state_dict(variables)
    model.to(dev)
    enc = torch.as_tensor(np.asarray(enc_tokens) if not isinstance(
        enc_tokens, torch.Tensor) else enc_tokens, device=dev)
    carries = model.encode(enc)
    B = enc.shape[0]
    tok = torch.full((B,), bos_id, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out = []
    for _ in range(max_len):
        logits, carries = model.decode_step(tok, carries)
        nxt = torch.argmax(logits, -1).to(torch.int32)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)


__all__ = ["Seq2Seq", "greedy_generate"]
