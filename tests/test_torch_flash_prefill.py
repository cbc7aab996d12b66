"""The flash prefill kernel's plain version against the JAX Pallas kernel.

``flash_prefill_attention_plain`` is what ``chip_smoke.py`` phase 1 holds
the CUDA kernel (csrc/flash_prefill.cu) to on the card, so here it meets
JAX ``flash_prefill_attention`` in interpret mode, as the JAX package's own
tests run it on the CPU, on the geometries the kernel's design has to get
right: one and eight query heads per kv head, a continuation chunk that
starts inside a 64-key tile and crosses several, and int8 / fp8 pools at
eight heads per group.  float32, atol = rtol = 2e-5 (the online softmax
sums in another order than the dense plain version).  Last, the work that
``chip_smoke.py`` divides by the card's peaks to get a kernel's bound, on
hand-counted cases.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.ops.pallas_attention import (
    flash_prefill_attention as j_flash,
)
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa

TOL = dict(rtol=2e-5, atol=2e-5)
J_DTYPE = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _case(seed, B, S, KVH, D, qpk, bs, max_blocks, num_blocks):
    """Random queries, pool and distinct-block tables (numpy float32)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, KVH * qpk, D)).astype(np.float32)
    k = rng.standard_normal((num_blocks, bs, KVH * D)).astype(np.float32)
    v = rng.standard_normal((num_blocks, bs, KVH * D)).astype(np.float32)
    tables = np.stack([rng.permutation(np.arange(1, num_blocks))[:max_blocks]
                       for _ in range(B)]).astype(np.int32)
    return q, k, v, tables


def _run_both(q, k, v, tables, starts, lengths, scales=None):
    """(port plain version, JAX interpret) on the same inputs; ``scales`` =
    (torch k codes, torch v codes, torch k scale, torch v scale) replaces
    k and v with a quantized pool."""
    st, ln = np.asarray(starts, np.int32), np.asarray(lengths, np.int32)
    if scales is None:
        got = pa.flash_prefill_attention(*[torch.from_numpy(a) for a in (
            q, k, v, tables, st, ln)])
        want = j_flash(*[jnp.asarray(a) for a in (q, k, v, tables, st, ln)],
                       interpret=True)
        return got.numpy(), np.asarray(want)
    kq, vq, ks, vs = scales
    jdt = J_DTYPE["int8" if kq.dtype == torch.int8 else "fp8"]
    got = pa.flash_prefill_attention(
        torch.from_numpy(q), kq, vq, torch.from_numpy(tables),
        torch.from_numpy(st), torch.from_numpy(ln), k_scale=ks, v_scale=vs)
    want = j_flash(jnp.asarray(q), jnp.asarray(kq.float().numpy()).astype(jdt),
                   jnp.asarray(vq.float().numpy()).astype(jdt),
                   jnp.asarray(tables), jnp.asarray(st), jnp.asarray(ln),
                   k_scale=jnp.asarray(ks.numpy()),
                   v_scale=jnp.asarray(vs.numpy()), interpret=True)
    return got.numpy(), np.asarray(want)


def _assert_valid_rows_close(got, want, lengths):
    for b, n in enumerate(lengths):          # rows past lengths are garbage
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)


@pytest.mark.parametrize("qpk", [1, 2, 8])
def test_flash_plain_matches_pallas_heads_per_group(qpk):
    # One, two and eight query heads per kv head (the kernel's block holds
    # 128 / qpk positions of all qpk heads): fresh, a continuation at a
    # ragged start, an inactive lane.
    starts, lengths = [0, 19, 5], [16, 9, 0]
    q, k, v, tables = _case(qpk, B=3, S=16, KVH=2, D=16, qpk=qpk, bs=8,
                            max_blocks=5, num_blocks=20)
    got, want = _run_both(q, k, v, tables, starts, lengths)
    _assert_valid_rows_close(got, want, lengths)


def test_flash_plain_matches_pallas_continuation_across_key_tiles():
    # A chunk that starts inside a 64-key tile (start 100) and whose keys
    # run through three of them (up to position 163), beside a fresh lane
    # and a lane ending one below block alignment.
    starts, lengths = [100, 0, 49], [64, 40, 14]
    q, k, v, tables = _case(11, B=3, S=64, KVH=2, D=16, qpk=4, bs=16,
                            max_blocks=11, num_blocks=40)
    got, want = _run_both(q, k, v, tables, starts, lengths)
    _assert_valid_rows_close(got, want, lengths)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_flash_quant_plain_matches_pallas_qpk8(kv_quant):
    # The int8 / fp8 pool at eight query heads per kv head (the Qwen2-72B
    # grouping), ragged starts and lengths: K scales multiply the scores,
    # V scales the probabilities after the row sum.
    starts, lengths = [0, 21, 3], [16, 11, 0]
    B, S, KVH, D, bs, max_blocks, num_blocks = 3, 16, 2, 16, 8, 5, 20
    q, k, v, tables = _case(5, B, S, KVH, D, 8, bs, max_blocks, num_blocks)
    tdt, qmax = tllama.kv_quant_spec(kv_quant)
    kq, ks = tllama.quantize_kv(torch.from_numpy(k), KVH, tdt, qmax)
    vq, vs = tllama.quantize_kv(torch.from_numpy(v), KVH, tdt, qmax)
    got, want = _run_both(q, k, v, tables, starts, lengths,
                          scales=(kq, vq, ks, vs))
    _assert_valid_rows_close(got, want, lengths)


# ------------------------------------------- the work behind the bound


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kv_quant,want_bytes", [("", 73752), ("int8", 61848)])
def test_prefill_work_counts_valid_rows_and_causal_pairs(kv_quant, want_bytes):
    # Two lanes in a bucket of S = 4 at the Llama-3-8B heads (32 query, 8
    # kv, D = 128, block 16): lane 0 fresh with 2 valid rows, lane 1 one
    # row at start 3.  q in + out: 2 * 3 valid rows * 32 heads * 128 * 2 B
    # = 49152 (the 5 padded rows count nothing).  K + V: (2 + 4) positions
    # * 8 kv heads * 2 planes * (256 B bf16 | 128 codes + 4 B scale) =
    # 24576 | 12672.  Table, starts, lengths: 4 B * 2 lanes * (1 block + 2)
    # = 24.  Causal pairs: lane 0 1 + 2, lane 1 4 keys: 7; flops 4 * 128 *
    # 32 * 7.
    cs = _chip_smoke()
    b, f = cs.prefill_work([0, 3], [2, 1], 4, kv_quant)
    assert (b, f) == (want_bytes, 114688)
    ms, by = cs.bound(b, f)
    assert by == "bytes" and ms == pytest.approx(want_bytes / 3.35e12 * 1e3)


def test_prefill_bound_of_the_chunk_shape_is_operations():
    # One fresh 2048-token chunk at the Llama-3-8B heads: 2048 * 2049 / 2
    # causal pairs * 4 * 128 * 32 flops against 41,943,560 bytes.
    cs = _chip_smoke()
    b, f = cs.prefill_work([0], [2048], 2048)
    assert b == 2 * 2048 * 32 * 128 * 2 + 2048 * 8 * 256 * 2 + 4 * (2 + 128)
    assert f == 4 * 128 * 32 * (2048 * 2049 // 2)
    ms, by = cs.bound(b, f)
    assert by == "operations" and ms == pytest.approx(f / 989e12 * 1e3)
