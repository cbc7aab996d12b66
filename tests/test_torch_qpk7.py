"""Seven query heads per kv head (Qwen2-7B's 28 / 4) on the CPU.

The kernels' plain versions at 14 query heads over 2 kv heads, head_dim 64
(a fused page row of 128 lanes), against the JAX Pallas kernels in
interpret mode on the same inputs made from a numpy seed: flash prefill
over a float32 and an int8 pool, fused decode over float32, int8 and fp8
pools (the appended codes exactly), and split paged attention at 1, 5 and 8
query tokens per lane.  float32, atol = rtol = 2e-5 (the sums run in
another order).  Odd lane counts keep the Pallas interpreter at one lane
per program.  Then a tiny Qwen2-shaped engine at 7 query heads per kv head
gives the JAX engine's greedy ids on the port's default paths and on the
kernel paths forced (whose plain versions run on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.models.config import ModelConfig as JModelConfig
from k8s_llm_monitor_tpu.ops.pallas_attention import (
    flash_prefill_attention as j_flash,
)
from k8s_llm_monitor_tpu.ops.pallas_attention import (
    paged_decode_attention_fused as j_fused,
)
from k8s_llm_monitor_tpu.ops.pallas_attention import (
    paged_decode_attention_fused_quant as j_fused_quant,
)
from k8s_llm_monitor_tpu.ops.pallas_attention import (
    paged_decode_attention_pallas as j_paged_decode,
)
from k8s_llm_monitor_tpu.ops.pallas_attention import (
    paged_verify_attention_pallas as j_paged_verify,
)
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
from k8s_llm_monitor_tpu_torch.ops.rope import rope_angles as t_rope_angles
from k8s_llm_monitor_tpu_torch.serving import engine as tengine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny engines run fastest on one intra-op thread, and many threads
    per test worker crowd the other workers out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-5, atol=2e-5)
THETA = 1e6
D, H, KVH, BS = 64, 14, 2, 8
J_DTYPE = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _pool(rng, nb, kind):
    """A float32 pool, or one quantized by the port (codes, scales)."""
    kp, vp = (torch.from_numpy(rng.standard_normal((nb, BS, KVH * D))
                               .astype(np.float32)) for _ in range(2))
    if kind == "f32":
        return kp, vp, ()
    qdt, qmax = tllama.kv_quant_spec(kind)
    (kp, ks), (vp, vs) = (tllama.quantize_kv(x, KVH, qdt, qmax)
                          for x in (kp, vp))
    return kp, vp, (ks, vs)


def _jcodes(x, kind):
    return jnp.asarray(x.float().numpy()).astype(J_DTYPE[kind])


def _tables(rng, lanes_live, max_blocks):
    table = np.zeros((len(lanes_live), max_blocks), np.int32)
    perm = rng.permutation(np.arange(1, len(lanes_live) * max_blocks + 2))
    for b, live in enumerate(lanes_live):
        if live:
            table[b] = perm[b * max_blocks:(b + 1) * max_blocks]
    return table


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_flash_plain_matches_pallas_qpk7(kind):
    # Fresh, a continuation at a ragged start, an inactive lane.
    starts, lengths = [0, 19, 5], [16, 9, 0]
    max_blocks = 5
    rng = np.random.default_rng(70 + len(kind))
    q = rng.standard_normal((3, 16, H, D)).astype(np.float32)
    kp, vp, scales = _pool(rng, 3 * max_blocks + 2, kind)
    table = _tables(rng, [True] * 3, max_blocks)
    st, ln = np.asarray(starts, np.int32), np.asarray(lengths, np.int32)
    got = pa.flash_prefill_attention(
        torch.from_numpy(q), kp, vp, torch.from_numpy(table),
        torch.from_numpy(st), torch.from_numpy(ln),
        **(dict(k_scale=scales[0], v_scale=scales[1]) if scales else {}))
    if scales:
        jpool = dict(k_scale=jnp.asarray(scales[0].numpy()),
                     v_scale=jnp.asarray(scales[1].numpy()))
        jk, jv = _jcodes(kp, kind), _jcodes(vp, kind)
    else:
        jpool = {}
        jk, jv = jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy())
    want = np.asarray(j_flash(jnp.asarray(q), jk, jv, jnp.asarray(table),
                              jnp.asarray(st), jnp.asarray(ln), **jpool,
                              interpret=True))
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got.numpy()[b, :n], want[b, :n], **TOL)


@pytest.mark.parametrize("kind", ["f32", "int8", "fp8"])
def test_fused_decode_plain_equals_pallas_qpk7(kind):
    # An inactive lane, one cached row, both sides of a block boundary,
    # the table's last row.
    positions = np.asarray([0, 1, 7, 8, 23], np.int32)
    max_blocks = 3
    rng = np.random.default_rng(77 + len(kind))
    B = len(positions)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k_new, v_new = ((rng.standard_normal((B, 1, KVH, D)) * 2)
                    .astype(np.float32) for _ in range(2))
    kp, vp, scales = _pool(rng, B * max_blocks + 2, kind)
    table = _tables(rng, positions > 0, max_blocks)
    tpos, ttab = torch.from_numpy(positions), torch.from_numpy(table)
    cos, sin = t_rope_angles(tpos[:, None], D, THETA)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k_new, v_new))
    pool = [t.clone() for t in (kp, vp, *scales)]
    jargs = (jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
             jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()))
    if kind == "f32":
        got = pa.paged_decode_attention_fused(tq, tk, tv, cos, sin, *pool,
                                              ttab, tpos)
        want = j_fused(*jargs, jnp.asarray(kp.numpy()),
                       jnp.asarray(vp.numpy()), jnp.asarray(table),
                       jnp.asarray(positions), interpret=True)
    else:
        got = pa.paged_decode_attention_fused_quant(tq, tk, tv, cos, sin,
                                                    *pool, ttab, tpos)
        want = j_fused_quant(*jargs, _jcodes(kp, kind), _jcodes(vp, kind),
                             *(jnp.asarray(s.numpy()) for s in scales),
                             jnp.asarray(table), jnp.asarray(positions),
                             interpret=True)
    act = positions > 0
    np.testing.assert_allclose(got[0].numpy()[act],
                               np.asarray(want[0])[act], **TOL)
    # The appended rows: pages; on a quantized pool the codes exactly and
    # the scales to one float32 ulp (XLA on the CPU divides by qmax as a
    # reciprocal multiply; on the card chip_smoke.py holds the kernel to
    # the plain version bit for bit).
    for b in np.flatnonzero(act):
        blk, off = table[b, positions[b] // BS], positions[b] % BS
        for i, (mine, theirs) in enumerate(zip(got[1:], want[1:])):
            m = mine[blk, off].float().numpy()
            t = np.asarray(theirs[blk, off]).astype(np.float32)
            if kind == "f32":
                np.testing.assert_allclose(m, t, **TOL)
            elif i < 2:
                np.testing.assert_array_equal(m, t)
            else:
                np.testing.assert_allclose(m, t, rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("QS", [1, 5, 8])
def test_paged_attention_plain_equals_pallas_qpk7(QS):
    # Seven lanes: a lane inside the first block, block boundaries, an
    # empty lane, rows past qlens, the table's last rows.
    starts = [0, 3, 7, 8, 5, 13, 15]
    qlens = [min(QS, 3), QS, QS, QS, 0, max(QS - 2, 1), QS]
    max_blocks = 3
    rng = np.random.default_rng(700 + QS)
    B = len(starts)
    q = rng.standard_normal((B, QS, H, D)).astype(np.float32)
    kp, vp, _ = _pool(rng, B * max_blocks + 2, "f32")
    table = _tables(rng, np.asarray(qlens) > 0, max_blocks)
    st, ql = (np.asarray(x, np.int32) for x in (starts, qlens))
    tq, ttab = torch.from_numpy(q), torch.from_numpy(table)
    jk, jv = jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy())
    if QS == 1:
        lengths = st + ql            # decode: starts = lengths - 1
        got = pa.paged_decode_attention_pallas(
            tq, kp, vp, ttab, torch.from_numpy(lengths)).numpy()
        want = np.asarray(j_paged_decode(
            jnp.asarray(q), jk, jv, jnp.asarray(table),
            jnp.asarray(lengths), interpret=True))
    else:
        got = pa.paged_verify_attention_pallas(
            tq, kp, vp, ttab, torch.from_numpy(st),
            torch.from_numpy(ql)).numpy()
        want = np.asarray(j_paged_verify(
            jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(st),
            jnp.asarray(ql), interpret=True))
    for b, n in enumerate(qlens):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL)


# A Qwen2-shaped toy: 14 query heads over 2 kv heads, QKV biases.
CFG_KW = dict(name="t-qpk7", vocab_size=300, hidden_size=112,
              intermediate_size=128, num_layers=2, num_heads=14,
              num_kv_heads=2, dtype="float32", rope_theta=THETA,
              qkv_bias=True)
ECFG_KW = dict(max_slots=3, num_blocks=64, block_size=8,
               max_blocks_per_seq=16, prefill_buckets=(16,),
               prefix_cache_entries=0)


def _prompts():
    rng = np.random.default_rng(7)
    return [[int(t) for t in rng.integers(3, 300, size=n)]
            for n in (5, 13, 40)]


@pytest.fixture(scope="module")
def qpk7_weights():
    tree = jax.tree.map(np.asarray, jllama.init_params(
        jax.random.PRNGKey(7), JModelConfig(**CFG_KW)))
    rng = np.random.default_rng(7)
    for layer in tree["layers"]:           # init_params zero-inits biases
        for name in ("q", "k", "v"):
            layer[name]["bias"] = (rng.standard_normal(
                layer[name]["bias"].shape) * 0.1).astype(np.float32)
    jids = [r.token_ids for r in jengine.InferenceEngine(
        JModelConfig(**CFG_KW), jax.tree.map(jnp.asarray, tree),
        jengine.EngineConfig(**ECFG_KW), eos_id=-1).generate(
        _prompts(), jengine.SamplingParams(max_tokens=6))]
    return params_from_jax(tree, ModelConfig(**CFG_KW), device="cpu"), jids


@pytest.mark.parametrize("paths", [
    {}, {"prefill_path": "flash", "decode_path": "fused"},
    {"prefill_path": "flash", "decode_path": "pallas", "spec_k": 4,
     "spec_min_accept": 0.0}],
    ids=["auto", "flash-fused", "flash-pallas-spec"])
def test_qpk7_engine_greedy_ids_match_jax_engine(qpk7_weights, paths):
    model, jids = qpk7_weights
    eng = tengine.InferenceEngine(
        ModelConfig(**CFG_KW), model,
        tengine.EngineConfig(**ECFG_KW, **paths), eos_id=-1, device="cpu")
    got = eng.generate(_prompts(), tengine.SamplingParams(max_tokens=6))
    assert [r.token_ids for r in got] == jids
    if paths:
        assert (eng.prefill_path, eng.decode_path) == (
            paths["prefill_path"], paths["decode_path"])
