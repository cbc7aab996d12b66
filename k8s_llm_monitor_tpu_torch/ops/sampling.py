"""Token sampling: greedy / temperature / top-k / top-p.

All parameters are per-lane tensors so one batched call mixes greedy and
sampled requests.  Top-k and top-p are rank cutoffs over one stable
descending sort: ranks are unique even when logits tie, so a tied
distribution cannot defeat the nucleus mask.  Random numbers come from an
explicit ``torch.Generator``; they differ from ``jax.random``'s for the same
seed, so sampled lanes are checked for reproducibility and bounds, greedy
lanes for exact ids.

``sample_tokens_bounded`` samples the same distribution from the top
``k_cap`` logits (one ``torch.topk``) instead of sorting the whole
vocabulary, exact whenever every sampling lane has ``0 < top_k <= k_cap``.
``fsm_mask_logits`` / ``fsm_advance`` apply a grammar's token FSM
(diagnosis/grammar.py:TokenFSM) per lane: state 0 is FREE, so one call
serves batches mixing constrained and unconstrained lanes.
"""

from __future__ import annotations

import torch


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax, [B, V] -> [B] int32 (first maximal index on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def filtered_scaled_logits(logits: torch.Tensor, *, temperature: torch.Tensor,
                           top_k: torch.Tensor,
                           top_p: torch.Tensor) -> torch.Tensor:
    """Temperature-scale then top-k/top-p-mask logits: the one definition of
    the sampling distribution.  logits [B, V]; temperature/top_k/top_p [B]
    (top_k <= 0 and top_p >= 1 disable).  Returns [B, V] f32, filtered
    entries -inf."""
    B, V = logits.shape
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = logits.float() / temp
    sorted_vals, order = torch.sort(scaled, dim=-1, descending=True,
                                    stable=True)
    ar = torch.arange(V, dtype=torch.int64, device=logits.device)
    rank = torch.empty_like(order).scatter_(1, order, ar.expand(B, V))
    k = torch.where(top_k > 0, top_k.long().clamp(1, V),
                    torch.full_like(top_k, V, dtype=torch.int64))[:, None]
    sorted_masked = torch.where(ar[None, :] < k, sorted_vals, -torch.inf)
    probs_sorted = torch.softmax(sorted_masked, dim=-1)
    cum_before = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
    n_keep = torch.sum(cum_before < top_p.float()[:, None], dim=-1)
    n_keep = torch.where(top_p < 1.0, n_keep.clamp(min=1),
                         torch.full_like(n_keep, V))[:, None]
    keep = rank < torch.minimum(k, n_keep)
    return torch.where(keep, scaled, -torch.inf)


def sample_tokens_bounded(generator: torch.Generator, logits: torch.Tensor, *,
                          temperature: torch.Tensor, top_k: torch.Tensor,
                          top_p: torch.Tensor, k_cap: int) -> torch.Tensor:
    """``sample_tokens`` restricted to the top ``k_cap`` logits per lane.

    The exact ``filtered_scaled_logits`` distribution whenever every
    sampling lane has ``0 < top_k <= k_cap`` (the engine checks this before
    choosing it): top-k keeps at most ``k_cap`` tokens and top-p filters
    within the top-k distribution, so no token past the top ``k_cap``
    carries probability.  One ``torch.topk`` over ``k_cap`` lanes replaces
    the full-vocabulary sort; the Gumbel-max draw is over ``[B, k_cap]``.
    Greedy lanes (temperature <= 0) take the argmax.  Returns [B] int32.
    """
    logits = logits.float()
    greedy = greedy_tokens(logits)
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    vals, idx = torch.topk(logits / temp, k_cap, dim=-1)   # sorted
    ranks = torch.arange(k_cap, device=logits.device)[None, :]
    k = top_k.long().clamp(1, k_cap)[:, None]
    masked = torch.where(ranks < k, vals, -torch.inf)
    probs = torch.softmax(masked, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    n_keep = torch.sum(cum_before < top_p.float()[:, None], dim=-1)
    n_keep = torch.where(top_p < 1.0, n_keep.clamp(min=1),
                         torch.full_like(n_keep, k_cap))[:, None]
    filtered = torch.where(ranks < torch.minimum(k, n_keep), masked,
                           -torch.inf)
    u = torch.rand(filtered.shape, generator=generator,
                   device=logits.device).clamp_(min=1e-20, max=1.0 - 1e-7)
    choice = torch.argmax(filtered - torch.log(-torch.log(u)), dim=-1)
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled.to(torch.int32))


# Large negative instead of -inf for grammar-disallowed entries: a fully
# finite row keeps softmax and the Gumbel draw NaN-free, and survives the
# /temperature scaling of both samplers (1e9 / 1e-6 = 1e15 << f32 max).
_FSM_NEG = -1e9


def fsm_allowed_mask(fsm_state: torch.Tensor, fsm_trans: torch.Tensor,
                     vocab: int, pad: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Per-lane allowed-token mask [B, V] bool from a grammar FSM.

    ``fsm_state`` [B] int32, 0 the FREE state (everything allowed);
    ``fsm_trans`` [S, Vg] int32, entries >= 0 allowed; ``vocab`` the model
    vocab V >= Vg, whose tokens past the grammar vocab are disallowed for
    constrained lanes.  ``pad``, a [>= B, V - Vg] all-False tensor, lets a
    caller that masks every step build that block once.
    """
    rows = fsm_trans[fsm_state.clamp(0, fsm_trans.shape[0] - 1).long()]
    allowed = rows >= 0
    extra = vocab - fsm_trans.shape[1]
    if extra > 0:
        if pad is None:
            pad = torch.zeros((allowed.shape[0], extra), dtype=torch.bool,
                              device=allowed.device)
        allowed = torch.cat([allowed, pad[:allowed.shape[0]]], dim=-1)
    return allowed | (fsm_state <= 0)[:, None]


def fsm_mask_logits(logits: torch.Tensor, fsm_state: torch.Tensor,
                    fsm_trans: torch.Tensor,
                    pad: torch.Tensor | None = None) -> torch.Tensor:
    """Mask grammar-disallowed tokens to ``_FSM_NEG`` before sampling, in
    float32.  Greedy lanes then take the argmax of the masked logits, so a
    constrained greedy lane is exact too."""
    allowed = fsm_allowed_mask(fsm_state, fsm_trans, logits.shape[-1], pad)
    return torch.where(allowed, logits.float(), _FSM_NEG)


def fsm_advance(fsm_state: torch.Tensor, fsm_trans: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
    """Next per-lane FSM state after ``tokens`` ([B] int32).  FREE lanes stay
    at 0 (row 0 is all zero); token ids past the grammar vocab are clipped,
    which only a FREE lane can produce."""
    state = fsm_state.clamp(0, fsm_trans.shape[0] - 1).long()
    tok = tokens.clamp(0, fsm_trans.shape[1] - 1).long()
    return fsm_trans[state, tok].to(torch.int32)


def sample_tokens(generator: torch.Generator, logits: torch.Tensor, *,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Sample next tokens from final-position logits [B, V] (Gumbel-max over
    the filtered distribution); lanes with temperature <= 0 take the
    argmax.  Returns [B] int32."""
    greedy = greedy_tokens(logits)
    filtered = filtered_scaled_logits(logits, temperature=temperature,
                                      top_k=top_k, top_p=top_p)
    u = torch.rand(filtered.shape, generator=generator,
                   device=logits.device).clamp_(min=1e-20, max=1.0 - 1e-7)
    sampled = torch.argmax(filtered - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled.to(torch.int32))
