"""Prompt-lookup speculative decoding: draft proposal and acceptance on the
device, in PyTorch (the JAX package's ``serving/spec.py``).

Diagnosis answers quote the evidence that dominates their prompt (pod
names, event messages, metric lines), so the next tokens of an output are
often a verbatim continuation of an n-gram already in its context.  The
engine matches the tail of each lane's history against the history itself,
proposes the ``k`` tokens that followed the match, verifies all ``k + 1``
positions in one forward pass (models/llama.py:verify_step) and accepts a
draft prefix plus the model's own next token:

  * ``accept_greedy`` -- argmax verification: the accepted tokens are the
    ones sequential greedy decode would emit, for any draft;
  * ``accept_sampled`` -- exact speculative sampling for sampled lanes.  A
    prompt-lookup draft is a delta distribution q = 1{x}, so the accept
    rule min(1, p(x) / q(x)) is "accept x with probability p(x)" and the
    rejection residual norm((p - q)+) is p with x zeroed, renormalized;
    every position's output is distributed as the target p (the
    temperature-scaled, top-k/top-p-filtered distribution of
    ops/sampling.py:filtered_scaled_logits).  Greedy lanes in the same call
    take the argmax rule.

Every function here is a fixed-shape tensor function with no host
round-trip, so the engine captures whole rounds into a CUDA graph.  Random
numbers come from an explicit ``torch.Generator``: they differ from
``jax.random``'s, so sampled acceptance is checked by its distribution.
"""

from __future__ import annotations

import dataclasses

import torch

from k8s_llm_monitor_tpu_torch.ops.sampling import filtered_scaled_logits


@dataclasses.dataclass
class AcceptanceEMA:
    """Per-request-class EMA of tokens emitted per lane-round, with an
    auto-disable floor.

    Drafting pays only while verify forwards emit enough tokens to beat the
    plain decode path.  The engine folds every reconciled spec call's
    acceptance in here, keyed by request class (greedy and sampled traffic
    accept at very different rates), and asks ``should_draft`` before each
    dispatch.  A class under the floor still re-probes every
    ``probe_every`` dispatches, so a recovery is observed.  Host-side
    bookkeeping only.
    """

    floor: float = 1.2
    probe_every: int = 32
    alpha: float = 0.2  # EMA weight of the newest measurement

    _ema: dict = dataclasses.field(default_factory=dict)
    _since_probe: dict = dataclasses.field(default_factory=dict)

    def update(self, klass: str, accepted: int, lane_rounds: int) -> None:
        """Fold one reconciled spec call's acceptance into the class EMA."""
        if lane_rounds <= 0:
            return
        rate = float(accepted) / float(lane_rounds)
        prev = self._ema.get(klass)
        self._ema[klass] = (rate if prev is None
                            else (1.0 - self.alpha) * prev + self.alpha * rate)

    def drafting_disabled(self, klass: str) -> bool:
        """True when the class EMA is measured and below the floor."""
        ema = self._ema.get(klass)
        return ema is not None and ema < self.floor

    def should_draft(self, klass: str) -> bool:
        """Gate one dispatch: True while the class EMA is unmeasured or at
        or above the floor; below it, True only for the periodic probe."""
        if not self.drafting_disabled(klass):
            self._since_probe[klass] = 0
            return True
        count = self._since_probe.get(klass, 0) + 1
        if count >= self.probe_every:
            self._since_probe[klass] = 0
            return True
        self._since_probe[klass] = count
        return False

    def snapshot(self) -> dict:
        """{class: ema}."""
        return dict(self._ema)


def propose_drafts(hist: torch.Tensor, ctx: torch.Tensor,
                   cur_tok: torch.Tensor, k: int) -> torch.Tensor:
    """Propose ``k`` draft tokens per lane by n-gram lookup over ``hist``.

    hist [B, H] int32 token history, positions ``0..ctx`` valid
    (``hist[b, ctx[b]]`` already holds ``cur_tok[b]``; the rest is stale
    and masked out); ctx [B] the current token's position; cur_tok [B].
    Returns [B, k] int32.  The latest position whose last three tokens
    match the lane's is preferred, then the latest 2-gram match; a lane
    with none proposes what follows position 0, a garbage draft that
    acceptance scores as rejected.  The -1 history padding is returned as
    token 0: fed to the embedding it would index past the vocabulary, and
    sampled acceptance could emit it.
    """
    B, H = hist.shape
    pos = torch.arange(H, dtype=torch.int32, device=hist.device)[None, :]

    def at(i):
        return torch.gather(hist, 1, i.clamp(0, H - 1).long()[:, None])[:, 0]

    prev1, prev2 = at(ctx - 1), at(ctx - 2)
    # A match must end strictly before ctx, so its continuation is history.
    in_range = (pos >= 1) & (pos < ctx[:, None])
    m2 = in_range & (hist == cur_tok[:, None])
    m2 = m2 & (torch.roll(hist, 1, dims=1) == prev1[:, None])
    m3 = m2 & (pos >= 2) & (torch.roll(hist, 2, dims=1) == prev2[:, None])
    m3 = m3 & (ctx[:, None] >= 2)
    zero = torch.zeros_like(pos)
    p3 = torch.where(m3, pos, zero).amax(dim=1)
    p2 = torch.where(m2, pos, zero).amax(dim=1)
    p = torch.where(p3 > 0, p3, p2)
    offs = torch.arange(k, dtype=torch.int32, device=hist.device)[None, :]
    idx = (p[:, None] + 1 + offs).clamp(0, H - 1).long()
    return torch.gather(hist, 1, idx).clamp(min=0)


def _truncate(toks: torch.Tensor, emit: torch.Tensor, active: torch.Tensor,
              eos_id, valid: torch.Tensor | None = None):
    """Cut each lane's emission after the first EOS inside it, zero it for
    inactive lanes, and left-pack the tokens with -1 padding."""
    K1 = toks.shape[1]
    iot = torch.arange(K1, dtype=torch.int32, device=toks.device)[None, :]
    is_eos = (toks == eos_id) & (iot < emit[:, None])
    if valid is not None:
        is_eos = is_eos & valid
    any_eos = is_eos.any(dim=1)
    first_eos = torch.argmax(is_eos.to(torch.int32), dim=1).to(torch.int32)
    emit = torch.where(any_eos, first_eos + 1, emit)
    emit = torch.where(active, emit, torch.zeros_like(emit))
    out = torch.where((iot < emit[:, None]) & active[:, None], toks,
                      torch.full_like(toks, -1))
    return emit, out


def accept_greedy(greedy: torch.Tensor, drafts: torch.Tensor,
                  quota: torch.Tensor, active: torch.Tensor, eos_id):
    """Greedy acceptance over one verify pass.

    greedy [B, K+1] int32 argmax of the verify logits (``greedy[:, i]`` is
    the model's token after fed position ``i``); drafts [B, K] the tokens
    fed at positions 1..K; quota [B] tokens a lane may still emit; active
    [B] bool; eos_id the EOS id (-1: none).

    Returns (emit [B] int32, out [B, K+1] int32): the accepted draft prefix
    (where ``greedy[:, i] == drafts[:, i]``) plus the model's correction or
    bonus token, cut at the quota and after the first EOS, left-packed
    with -1 padding; 0 and all -1 for inactive lanes.
    """
    K = drafts.shape[1]
    matched = (greedy[:, :K] == drafts).to(torch.int32)
    n_acc = torch.cumprod(matched, dim=1).sum(dim=1).to(torch.int32)
    emit = torch.minimum(n_acc + 1, quota.to(torch.int32))
    return _truncate(greedy, emit, active, eos_id)


def accept_sampled(generator: torch.Generator, logits: torch.Tensor,
                   drafts: torch.Tensor, quota: torch.Tensor,
                   active: torch.Tensor, eos_id, temperature: torch.Tensor,
                   top_k: torch.Tensor | None = None,
                   top_p: torch.Tensor | None = None):
    """Distribution-exact acceptance for sampled lanes (the delta-draft
    rule of the module docstring), with greedy lanes (temperature <= 0)
    on the argmax rule in the same call.

    logits [B, K+1, V] float verify logits; drafts [B, K]; quota, active,
    eos_id as in ``accept_greedy``; temperature [B]; top_k / top_p [B]
    per-lane filters, None when no lane of the call filters (a plain
    temperature softmax is then the same distribution without the sort).
    Draws (B, K) uniforms, then one Gumbel-max draw over [B, V], from
    ``generator``.  Returns (emit [B] int32, out [B, K+1] int32).
    """
    B, K1, V = logits.shape
    K = K1 - 1
    dev = logits.device
    iot = torch.arange(K1, dtype=torch.int32, device=dev)[None, :]
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)        # [B, K+1]
    is_greedy = temperature <= 0.0
    if top_k is None and top_p is None:
        temp3 = torch.clamp(temperature.float(), min=1e-6)[:, None, None]
        p = torch.softmax(logits / temp3, dim=-1)
    else:
        if top_k is None:
            top_k = torch.zeros(B, dtype=torch.int32, device=dev)
        if top_p is None:
            top_p = torch.ones(B, dtype=torch.float32, device=dev)
        # Each lane's filters for its K + 1 positions (expand, not
        # repeat_interleave: no output size for the host to wait on).
        def rep(a):
            return a[:, None].expand(B, K1).reshape(B * K1)

        filtered = filtered_scaled_logits(
            logits.reshape(B * K1, V), temperature=rep(temperature),
            top_k=rep(top_k), top_p=rep(top_p))
        p = torch.softmax(filtered, dim=-1).reshape(B, K1, V)
    # Accept draft i with probability p_i(draft i); greedy lanes on argmax.
    p_draft = torch.gather(p[:, :K, :], 2, drafts.long()[..., None])[..., 0]
    u = torch.rand((B, K), generator=generator, device=dev)
    acc = torch.where(is_greedy[:, None], greedy[:, :K] == drafts,
                      u < p_draft)
    n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32)
    # The boundary token at index n_acc: the correction (resampled from p
    # with the rejected draft zeroed) or the bonus sample (n_acc == K).
    bnd = n_acc.clamp(0, K).long()[:, None]
    p_bnd = torch.gather(p, 1, bnd[..., None].expand(B, 1, V))[:, 0, :]
    draft_bnd = torch.gather(drafts, 1, bnd.clamp(max=K - 1))[:, 0]
    rejected = n_acc < K
    vocab = torch.arange(V, dtype=torch.int32, device=dev)[None, :]
    zero_mask = (vocab == draft_bnd[:, None]) & rejected[:, None]
    p_res = torch.where(zero_mask, torch.zeros_like(p_bnd), p_bnd)
    g = torch.rand((B, V), generator=generator, device=dev).clamp_(
        min=1e-20, max=1.0 - 1e-7)
    scores = torch.where(p_res > 0, torch.log(p_res),
                         torch.full_like(p_res, -torch.inf))
    corr = torch.argmax(scores - torch.log(-torch.log(g)), dim=-1).to(
        torch.int32)
    greedy_bnd = torch.gather(greedy, 1, bnd)[:, 0]
    boundary = torch.where(is_greedy, greedy_bnd, corr)
    # Emitted row: the accepted drafts, then the boundary token.
    base = torch.cat([drafts.to(torch.int32),
                      torch.zeros(B, 1, dtype=torch.int32, device=dev)], 1)
    toks = torch.where(iot < n_acc[:, None], base,
                       torch.where(iot == n_acc[:, None], boundary[:, None],
                                   torch.zeros_like(base)))
    emit = torch.minimum(n_acc + 1, quota.to(torch.int32))
    return _truncate(toks, emit, active, eos_id, valid=toks >= 0)
