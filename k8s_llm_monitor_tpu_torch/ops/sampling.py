"""Token sampling: greedy / temperature / top-k / top-p.

All parameters are per-lane tensors so one batched call mixes greedy and
sampled requests.  Top-k and top-p are rank cutoffs over one stable
descending sort: ranks are unique even when logits tie, so a tied
distribution cannot defeat the nucleus mask.  Random numbers come from an
explicit ``torch.Generator``; they differ from ``jax.random``'s for the same
seed, so sampled lanes are checked for reproducibility and bounds, greedy
lanes for exact ids.
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
