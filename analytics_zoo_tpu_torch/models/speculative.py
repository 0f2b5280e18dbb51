"""Speculative decoding: a small draft model proposes k tokens, the
target model verifies all of them in ONE cached forward.

The port of ``analytics_zoo_tpu/models/speculative.py``.  Greedy
contract: the emitted sequence is exactly what greedy decoding of the
target alone produces (a draft token is accepted iff it equals the
target's argmax given the accepted prefix, so every emitted token is
the target's argmax; held to :func:`models.lm.generate`).

Mechanics per round, per row (pointer ``ptr`` = number of durable cache
entries, starting at prompt_len - 1):

  draft   : k+1 greedy cached steps from ``last`` -> proposals
            d_0..d_{k-1} (the extra step writes d_{k-1}'s K/V, so a
            full-acceptance round leaves the draft cache complete)
  verify  : target ``verify_step`` on [last, d_0..d_{k-1}] at positions
            ptr..ptr+k (k+1 logits in one forward)
  accept  : a = longest prefix with argmax_j == d_j; emit argmaxes
            t_0..t_a (a accepted tokens + 1 free target token)
  advance : both pointers += a+1.  Entries written past the new pointer
            are dead: the mask never reaches them and the next round
            overwrites them.

Rows advance at different rates (per-row pointers, as in the continuous
engine); finished rows re-verify their frozen ``last`` and emit nothing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.device import resolve_device
from analytics_zoo_tpu_torch.models.lm import TransformerLM


def accept_proposals(logits, d, last, done, *, k: int,
                     eos_id: Optional[int], budget=None):
    """The speculative acceptance rule: ONE definition shared by batch
    :func:`speculative_generate` and the continuous engine's spec
    rounds (arena and paged), so the greedy contract cannot drift
    between them.

    ``logits`` ``[B, k+1, V]`` are the target's verify outputs for
    inputs [last, d_0..d_{k-1}]; ``d`` ``[B, k]`` the draft proposals;
    ``last`` ``[B]`` each row's previous emitted token; ``done`` ``[B]``
    bool, frozen rows.  ``budget`` (optional ``[B]``) clips emission to
    each row's remaining token allowance (batch generation; the engine
    drops surplus host-side).

    Returns ``(t, n_emit, new_last, done)``: ``t`` ``[B, k+1]`` int32,
    the target argmaxes with everything after a row's first in-window
    eos frozen AT eos; ``n_emit`` ``[B]`` int32 in 0..k+1 (0 only for
    done rows or an exhausted budget); ``new_last`` the last emitted
    token (the old ``last`` where nothing emitted)."""
    t = torch.argmax(logits, dim=-1).to(torch.int32)        # [B, k+1]
    match = (t[:, :k] == d).to(torch.int32)                 # [B, k]
    a = torch.cumprod(match, dim=1).sum(dim=1)
    n_emit = (a + 1).to(torch.int32)                        # t_0..t_a
    if budget is not None:
        n_emit = torch.minimum(n_emit, budget.to(torch.int32))
    if eos_id is not None:
        js = torch.arange(k + 1, device=t.device)[None, :]
        is_eos = (t == eos_id) & (js < n_emit[:, None])
        first_eos = torch.where(
            is_eos.any(dim=1), torch.argmax(is_eos.to(torch.int32), dim=1),
            torch.full_like(n_emit, k + 1, dtype=torch.int64))
        n_emit = torch.minimum(n_emit, (first_eos + 1).to(torch.int32))
        # frozen tail: everything after a row's first eos reads as eos
        # (emitted entries sit at js <= first_eos, so no emitted value
        # changes)
        t = torch.where(js > first_eos[:, None],
                        torch.full_like(t, eos_id), t)
    n_emit = torch.where(done, torch.zeros_like(n_emit), n_emit)
    picked = torch.gather(t, 1, torch.clamp(n_emit - 1, min=0)
                          .long()[:, None])[:, 0]
    new_last = torch.where(n_emit > 0, picked, last.to(torch.int32))
    if eos_id is not None:
        done = done | ((n_emit > 0) & (new_last == eos_id))
    return t, n_emit, new_last, done


def load_draft(model, draft_model, draft_variables) -> None:
    """Load ``draft_variables`` into the draft.  A draft that IS the
    target module (self-drafting) shares the target's weights, so its
    variables must be those weights: loading others would change the
    target."""
    if draft_model is not model:
        draft_model.load_state_dict(draft_variables)
        return
    state = model.state_dict()
    if set(draft_variables) != set(state) or not all(
            torch.equal(torch.as_tensor(draft_variables[k]).to(
                state[k].device), state[k]) for k in state):
        raise ValueError(
            "a draft that is the target module itself shares its "
            "weights: draft_variables must be the target's; build a "
            "second module for a draft with other weights")


def _prefill_caches(model: TransformerLM, prompt, L: int):
    """One batched causal forward (``TransformerLM.prefill``) padded
    into an L-long cache, in the model dtype.  Ragged rows' entries past
    their true length are dead until the advancing pointer overwrites
    them."""
    _, ks, vs = model._prefill_hidden(prompt)
    pad = L - ks.shape[2]
    shape = ks.shape[:2] + (pad,) + ks.shape[3:]
    ks = torch.cat([ks, ks.new_zeros(shape)], dim=2)
    vs = torch.cat([vs, vs.new_zeros(shape)], dim=2)
    return ks.to(model.dtype), vs.to(model.dtype)


def _spec_round(model: TransformerLM, draft_model: TransformerLM, carry,
                *, k: int, max_new: int, eos_id: Optional[int]):
    """One speculative round over the batch; returns (carry, n_emit)."""
    (last, tck, tcv, ptr, dck, dcv, dptr, out, gen_len, done) = carry

    # draft: k proposals via k+1 greedy cached steps
    tok, p, props = last, dptr, []
    for _ in range(k + 1):
        logits = draft_model.decode_step(tok, dck, dcv, p)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        props.append(tok)
        p = p + 1
    d = torch.stack(props[:k], dim=1)                       # [B, k]

    # verify: one (k+1)-token cached forward of the target
    inputs = torch.cat([last[:, None], d], dim=1)           # [B, k+1]
    logits = model.verify_step(inputs, tck, tcv, ptr)

    t, n_emit, new_last, done = accept_proposals(
        logits, d, last, done, k=k, eos_id=eos_id,
        budget=max_new - gen_len)

    # scatter the emitted tokens into the output buffer
    js = torch.arange(k + 1, device=t.device)[None, :]
    dest = gen_len[:, None] + js                            # [B, k+1]
    live = js < n_emit[:, None]
    hit = (torch.arange(max_new, device=t.device)[None, None, :]
           == dest[:, :, None]) & live[:, :, None]          # [B, k+1, N]
    out = torch.where(hit.any(dim=1),
                      (hit.to(torch.int32) * t[:, :, None]).sum(dim=1)
                      .to(torch.int32), out)

    # advance: the next round's first input is the last EMITTED token,
    # whose K/V is not durable yet (the pointer stops just before it)
    ptr = ptr + n_emit
    dptr = dptr + n_emit
    gen_len = gen_len + n_emit
    done = done | (gen_len >= max_new)
    return ((new_last, tck, tcv, ptr, dck, dcv, dptr, out, gen_len, done),
            n_emit)


@torch.no_grad()
def speculative_generate(model: TransformerLM, variables,
                         draft_model: TransformerLM, draft_variables,
                         prompt, max_new_tokens: int, *, k: int = 4,
                         eos_id: Optional[int] = None, prompt_len=None,
                         device=None):
    """Greedy generation of ``max_new_tokens`` with draft-model
    speculation.  Returns (tokens ``[B, max_new_tokens]`` int32 on the
    device, stats dict) where stats reports rounds and mean emitted
    tokens per row and round.  Output rows equal
    :func:`models.lm.generate` (greedy) on the target exactly, including
    the eos contract: after a row's first ``eos_id`` the row freezes at
    eos.  ``variables``/``draft_variables``: ``state_dict``\\ s loaded
    into the models first, or ``None`` for their own weights.  Runs on
    ``device`` (``cuda`` unless the caller names another)."""
    if model.vocab_size != draft_model.vocab_size:
        raise ValueError(
            f"draft vocab {draft_model.vocab_size} != target vocab "
            f"{model.vocab_size}: speculative tokens must share one id "
            f"space")
    dev = resolve_device(device)
    for m, v in ((model, variables), (draft_model, draft_variables)):
        if v is not None:
            m.load_state_dict(v)
        m.to(dev).eval()
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32,
                             device=dev)
    B, Pn = prompt.shape
    L = Pn + max_new_tokens + k + 1
    for m, which in ((model, "target"), (draft_model, "draft")):
        if L > m.max_position:
            raise ValueError(
                f"prompt+new+k = {L} exceeds {which} max_position "
                f"{m.max_position}")
    plen = torch.full((B,), Pn, dtype=torch.int32, device=dev) \
        if prompt_len is None else torch.clamp(
            torch.as_tensor(np.asarray(prompt_len), dtype=torch.int32,
                            device=dev), 1, Pn)

    tck, tcv = _prefill_caches(model, prompt, L)
    dck, dcv = _prefill_caches(draft_model, prompt, L)
    last = torch.gather(prompt, 1, (plen - 1).long()[:, None])[:, 0]
    carry = (last, tck, tcv, plen - 1, dck, dcv, plen - 1,
             torch.zeros((B, max_new_tokens), dtype=torch.int32,
                         device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev))
    rounds = emitted = 0
    # worst case every round emits 1 token (all rejections)
    for _ in range(max_new_tokens):
        carry, n_emit = _spec_round(model, draft_model, carry, k=k,
                                    max_new=max_new_tokens, eos_id=eos_id)
        rounds += 1
        # one fetch a round for both loop controls
        n_round, all_done = torch.stack(
            [n_emit.sum().to(torch.int64),
             carry[-1].all().to(torch.int64)]).tolist()
        emitted += int(n_round)
        if all_done:
            break
    out = carry[7]
    if eos_id is not None:
        # generate() parity: after a row's first eos the row freezes
        o = out.cpu().numpy()
        m = np.cumsum(o == eos_id, axis=1)
        o = np.where((m - (o == eos_id)) > 0, eos_id, o)
        out = torch.as_tensor(o, dtype=torch.int32, device=dev)
    stats = {"rounds": rounds,
             "emitted_tokens": emitted,
             "batch": B,
             # per-row totals let callers exclude padding rows
             "per_row_emitted": carry[8].cpu().numpy(),
             "mean_accepted_per_round": emitted / max(1, rounds * B)}
    return out, stats
