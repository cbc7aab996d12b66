"""The port's sampling ops against the JAX package's ops/sampling.py.

The grammar FSM ops (``fsm_allowed_mask``, ``fsm_mask_logits``,
``fsm_advance``) are equal exactly, over the verdict grammar's table with
FREE lanes, a model vocab past the grammar vocab and tokens past it.
``sample_tokens_bounded``: greedy lanes equal JAX's argmax; every sampled
draw lies in its lane's kept set of JAX's ``filtered_scaled_logits``; and
over 4,000 seeded draws at V = 300 the bounded and the full sampler's
token counts pass a chi-square two-sample test at p > 0.001.  Random
streams differ from ``jax.random``, so sampled ids are never compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2_contingency

from k8s_llm_monitor_tpu.diagnosis.grammar import verdict_fsm
from k8s_llm_monitor_tpu.ops import sampling as jsampling
from k8s_llm_monitor_tpu_torch.ops import sampling as tsampling

V = 300                      # model vocab > the grammar's 259


def _fsm_inputs(seed=0, B=9):
    fsm = verdict_fsm(eos_id=2)
    rng = np.random.default_rng(seed)
    # FREE lanes (0), the start state, random states, and an out-of-range
    # state (clipped like JAX).
    states = np.concatenate([[0, 0, 1, fsm.n_states - 1, fsm.n_states + 5],
                             rng.integers(1, fsm.n_states, size=B - 5)])
    logits = rng.normal(size=(B, V)).astype(np.float32) * 4
    # Tokens: allowed ones, random ones (some past the grammar vocab and
    # the model vocab), -1 (an idle lane's marker).
    toks = rng.integers(0, V + 10, size=B)
    toks[0], toks[1] = 290, -1
    return fsm, states.astype(np.int32), logits, toks.astype(np.int32)


def test_fsm_allowed_mask_equals_jax():
    fsm, states, _, _ = _fsm_inputs()
    want = np.asarray(jsampling.fsm_allowed_mask(
        jnp.asarray(states), jnp.asarray(fsm.trans), V))
    trans = torch.from_numpy(fsm.trans)
    got = tsampling.fsm_allowed_mask(torch.from_numpy(states), trans, V)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    pad = torch.zeros((16, V - fsm.vocab_size), dtype=torch.bool)
    got_pad = tsampling.fsm_allowed_mask(torch.from_numpy(states), trans, V,
                                         pad)
    assert np.array_equal(got_pad.numpy(), want)
    # FREE lanes allow everything; constrained lanes nothing past 259.
    assert want[0].all() and not want[2:, 259:].any()


def test_fsm_mask_logits_equals_jax():
    fsm, states, logits, _ = _fsm_inputs(1)
    want = np.asarray(jsampling.fsm_mask_logits(
        jnp.asarray(logits), jnp.asarray(states), jnp.asarray(fsm.trans)))
    got = tsampling.fsm_mask_logits(torch.from_numpy(logits),
                                    torch.from_numpy(states),
                                    torch.from_numpy(fsm.trans))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert (want == np.float32(-1e9)).any() and np.isfinite(want).all()
    # bf16 logits are masked in float32, as JAX casts.
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    got_b = tsampling.fsm_mask_logits(lb, torch.from_numpy(states),
                                      torch.from_numpy(fsm.trans))
    assert got_b.dtype == torch.float32


def test_fsm_advance_equals_jax():
    fsm, states, logits, toks = _fsm_inputs(2)
    want = np.asarray(jsampling.fsm_advance(
        jnp.asarray(states), jnp.asarray(fsm.trans), jnp.asarray(toks)))
    got = tsampling.fsm_advance(torch.from_numpy(states),
                                torch.from_numpy(fsm.trans),
                                torch.from_numpy(toks))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert got[0] == 0          # a FREE lane stays FREE
    # The greedy token of each masked row advances to a live state.
    masked = tsampling.fsm_mask_logits(torch.from_numpy(logits),
                                       torch.from_numpy(states),
                                       torch.from_numpy(fsm.trans))
    nxt = tsampling.greedy_tokens(masked)
    live = tsampling.fsm_advance(torch.from_numpy(states),
                                 torch.from_numpy(fsm.trans), nxt)
    assert (live[(torch.from_numpy(states) > 0)
                 & (torch.from_numpy(states) < fsm.n_states)] > 0).all()


def _lanes(seed, B):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    temp = np.where(np.arange(B) % 4 == 0, 0.0,
                    rng.uniform(0.3, 2.0, size=B)).astype(np.float32)
    topk = rng.integers(1, 65, size=B).astype(np.int32)
    topp = np.where(np.arange(B) % 3 == 0, 1.0,
                    rng.uniform(0.2, 0.99, size=B)).astype(np.float32)
    return logits, temp, topk, topp


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bounded_sampler_support_and_greedy(seed):
    B = 16
    logits, temp, topk, topp = _lanes(seed, B)
    filt = np.asarray(jsampling.filtered_scaled_logits(
        jnp.asarray(logits), temperature=jnp.asarray(temp),
        top_k=jnp.asarray(topk), top_p=jnp.asarray(topp)))
    greedy = np.asarray(jsampling.greedy_tokens(jnp.asarray(logits)))
    gen = torch.Generator().manual_seed(seed)
    lt, tt, kt, pt = _t(logits, temp, topk, topp)
    for _ in range(50):
        got = tsampling.sample_tokens_bounded(
            gen, lt, temperature=tt, top_k=kt, top_p=pt, k_cap=64).numpy()
        assert got.dtype == np.int32
        for b in range(B):
            if temp[b] <= 0:
                assert got[b] == greedy[b]
            else:
                assert np.isfinite(filt[b, got[b]]), (b, got[b])


def test_bounded_sampler_is_reproducible():
    logits, temp, topk, topp = _t(*_lanes(3, 8))
    draws = [tsampling.sample_tokens_bounded(
        torch.Generator().manual_seed(11), logits, temperature=temp,
        top_k=topk, top_p=topp, k_cap=64) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])


@pytest.mark.parametrize("top_k,top_p", [(20, 1.0), (40, 0.9), (64, 0.5)])
def test_bounded_and_full_samplers_agree_in_distribution(top_k, top_p):
    """One row of logits repeated over 4,000 lanes: the two samplers'
    token counts pass a chi-square two-sample test (p > 0.001), and each
    puts no draw outside the kept set."""
    N = 4000
    rng = np.random.default_rng(top_k)
    row = (rng.normal(size=V) * 2).astype(np.float32)
    logits = torch.from_numpy(np.tile(row, (N, 1)))
    kw = dict(temperature=torch.full((N,), 0.8),
              top_k=torch.full((N,), top_k, dtype=torch.int32),
              top_p=torch.full((N,), top_p))
    full = tsampling.sample_tokens(torch.Generator().manual_seed(1), logits,
                                   **kw).numpy()
    bounded = tsampling.sample_tokens_bounded(
        torch.Generator().manual_seed(2), logits, k_cap=64, **kw).numpy()
    kept = np.isfinite(np.asarray(jsampling.filtered_scaled_logits(
        jnp.asarray(row[None]), temperature=jnp.asarray([0.8]),
        top_k=jnp.asarray([top_k]), top_p=jnp.asarray([top_p])))[0])
    assert kept[full].all() and kept[bounded].all()
    cats = np.flatnonzero(kept)
    table = np.stack([np.bincount(full, minlength=V)[cats],
                      np.bincount(bounded, minlength=V)[cats]])
    table = table[:, table.sum(0) > 0]
    if table.shape[1] > 1:
        assert chi2_contingency(table).pvalue > 1e-3
