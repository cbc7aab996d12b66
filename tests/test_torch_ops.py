"""PyTorch port ops against the JAX reference on the CPU.

Inputs are made from a seed with numpy and handed to both frameworks;
float32 throughout, compared at atol=rtol=1e-5 unless a test says
otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.ops import attention as jattn
from k8s_llm_monitor_tpu.ops import norms as jnorms
from k8s_llm_monitor_tpu.ops import rope as jrope
from k8s_llm_monitor_tpu_torch.ops import attention as tattn
from k8s_llm_monitor_tpu_torch.ops import norms as tnorms
from k8s_llm_monitor_tpu_torch.ops import rope as trope

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("unit_offset", [False, True])
def test_rms_norm(unit_offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, unit_offset)
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5,
                          unit_offset)
    _close(got, want)


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    {"type": "linear", "factor": 4.0},
])
def test_rope_angles_and_apply(scaling):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 8000, size=(2, 7)).astype(np.int32)
    jc, js = jrope.rope_angles(jnp.asarray(pos), 128, 500_000.0, scaling)
    tc, ts = trope.rope_angles(torch.from_numpy(pos), 128, 500_000.0, scaling)
    # Angles up to 8000 rad: cos/sin of arguments that large lose ~1e-4
    # absolute to argument rounding alone, identically in both frameworks,
    # but the two libm implementations round differently; 2e-5 absolute.
    _close(tc, jc, atol=2e-5, rtol=0)
    _close(ts, js, atol=2e-5, rtol=0)
    x = rng.standard_normal((2, 7, 4, 128)).astype(np.float32)
    want = jrope.apply_rope(jnp.asarray(x), jc, js)
    got = trope.apply_rope(*_t(x, jc, js))
    _close(got, want)


def _paged(seed, B, S, KVH, D, qpk, bs, max_blocks, num_blocks):
    rng = np.random.default_rng(seed)
    H = KVH * qpk
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((num_blocks, bs, KVH * D)).astype(np.float32)
    v = rng.standard_normal((num_blocks, bs, KVH * D)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, num_blocks))[:max_blocks]
                       for _ in range(B)]).astype(np.int32)
    return q, k, v, tables


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("kv_len", [None, [9, 5, 12]])
def test_causal_attention(kv_len):
    rng = np.random.default_rng(2)
    B, S, T, H, KVH, D = 3, 5, 12, 4, 2, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, D)).astype(np.float32)
    qpos = (np.arange(S)[None] + np.array([[0], [3], [7]])).astype(np.int32)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = jattn.causal_attention(
        *_j(q, k, v), q_positions=jnp.asarray(qpos),
        kv_len=None if kl is None else jnp.asarray(kl))
    got = tattn.causal_attention(
        *_t(q, k, v), q_positions=torch.from_numpy(qpos),
        kv_len=None if kl is None else torch.from_numpy(kl))
    _close(got, want)


def test_gather_pages():
    _, k, _, tables = _paged(3, B=3, S=1, KVH=2, D=8, qpk=1, bs=4,
                             max_blocks=5, num_blocks=20)
    tables[1, 3:] = -1           # garbage past the sequence reads block 0
    _close(tattn.gather_pages(*_t(k, tables)),
           jattn.gather_pages(*_j(k, tables)), atol=0, rtol=0)


def test_paged_decode_attention_ragged():
    q, k, v, tables = _paged(4, B=4, S=1, KVH=2, D=16, qpk=2, bs=8,
                             max_blocks=6, num_blocks=30)
    lengths = np.array([1, 8, 9, 48], np.int32)   # block edges, full table
    want = jattn.paged_decode_attention(*_j(q, k, v, tables, lengths))
    got = tattn.paged_decode_attention(*_t(q, k, v, tables, lengths))
    _close(got, want)


@pytest.mark.parametrize("starts,lengths", [
    ([0, 17, 33, 15], [16, 16, 0, 16]),   # fresh, chunk, inactive, 31 = 4*8-1
    ([0, 9, 31, 2], [5, 16, 3, 1]),
])
def test_paged_verify_attention_ragged(starts, lengths):
    q, k, v, tables = _paged(5, B=4, S=16, KVH=2, D=16, qpk=2, bs=8,
                             max_blocks=8, num_blocks=40)
    st, ln = np.asarray(starts, np.int32), np.asarray(lengths, np.int32)
    want = np.asarray(jattn.paged_verify_attention(*_j(q, k, v, tables, st, ln)))
    got = tattn.paged_verify_attention(*_t(q, k, v, tables, st, ln)).numpy()
    for b, n in enumerate(lengths):   # only valid query rows are defined
        _close(got[b, :n], want[b, :n])
