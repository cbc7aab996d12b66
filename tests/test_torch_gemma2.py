"""Gemma-2's extras in the port (ROADMAP A9) against the JAX package on the
CPU: GeGLU, sandwich norms, the unit-offset RMSNorm, ``embed_scale``, the
attention logit cap, a query scale, per-layer sliding windows and the final
logit cap.

The tiny config is ``tests/test_model_parity.py``'s Gemma one (window 8,
alternating sliding and full layers, head_dim 8), float32:

  * the port's engine gives the JAX engine's greedy ids with spec on and
    off, over the model-dtype pool and an int8 pool, through a chunked
    prompt (past the 16 bucket, longer than the window) and a prefix hit;
    both engines take JAX's paths for such a model (prefill dense, decode
    on the gather, verify on the gather);
  * the plain attention's cap, scale and window match JAX's within 1e-6:
    dense causal, contiguous decode, paged decode (bf16-free float32 and
    an int8 pool) and paged verify;
  * ``_mlp_act``'s tanh GELU within 1e-6 of ``jax.nn.gelu``; the
    unit-offset RMSNorm bit for bit in float32 where the mean square sums
    exactly (rows of quarters), within 1e-6 elsewhere (summation order);
    ``embed_scale`` bit for bit in float32 and bfloat16 (sqrt(H) rounded
    to the dtype first);
  * ``config_from_hf`` of a Gemma-2 ``config.json`` equals JAX's, class
    defaults included, and the loaded weights of a ``transformers``
    Gemma-2 checkpoint equal the JAX loader's through ``params_from_jax``
    (the sandwich norms' key map), bf16 and int8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.models import config as jconfig
from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.ops import attention as jattn
from k8s_llm_monitor_tpu.ops.norms import rms_norm as j_rms_norm
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu.utils import checkpoint as jckpt
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models import config as tconfig
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.ops import attention as tattn
from k8s_llm_monitor_tpu_torch.ops.norms import rms_norm as t_rms_norm
from k8s_llm_monitor_tpu_torch.serving import engine as tengine
from k8s_llm_monitor_tpu_torch.utils import checkpoint as tckpt


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny engines run fastest on one intra-op thread, and many threads
    per test worker crowd the other workers out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG_KW = dict(
    name="tiny-gemma", vocab_size=160, hidden_size=32, intermediate_size=64,
    num_layers=4, num_heads=4, num_kv_heads=2, head_dim=8, dtype="float32",
    rope_theta=10_000.0, tie_embeddings=True, mlp_activation="gelu_tanh",
    sandwich_norms=True, rmsnorm_unit_offset=True, attn_logit_softcap=50.0,
    final_logit_softcap=30.0, query_pre_attn_scalar=12.0, embed_scale=True,
    sliding_window=8,
    layer_types=("sliding_attention", "full_attention") * 2)
JCFG = jconfig.ModelConfig(**CFG_KW)
TCFG = tconfig.ModelConfig(**CFG_KW)
_FIELDS = [f.name for f in dataclasses.fields(tconfig.ModelConfig)]
ECFG = dict(max_slots=2, num_blocks=64, block_size=4, max_blocks_per_seq=16,
            prefill_buckets=(16,), spec_rounds_per_iter=2,
            spec_min_accept=0.0)


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jax.random.PRNGKey(3), JCFG)
    # Norm deltas off zero, so the unit offset and the sandwich norms
    # change the numbers.
    rng = np.random.default_rng(1)
    for layer in params["layers"]:
        for name in ("input_norm", "post_norm", "post_attn_norm",
                     "post_mlp_norm"):
            layer[name] = jnp.asarray(rng.normal(0.0, 0.2, 32), jnp.float32)
    return params, params_from_jax(jax.tree.map(np.asarray, params), TCFG,
                                   device="cpu")


def test_config_fields_match_jax():
    assert {f: getattr(TCFG, f) for f in _FIELDS} == {
        f: getattr(JCFG, f) for f in _FIELDS}
    assert TCFG.attn_scale == JCFG.attn_scale
    assert [TCFG.layer_window(i) for i in range(4)] == [8, 0, 8, 0]
    for name in ("gemma2-2b", "gemma2-9b"):
        t, j = tconfig.PRESETS[name], jconfig.PRESETS[name]
        assert {f: getattr(t, f) for f in _FIELDS} == {
            f: getattr(j, f) for f in _FIELDS}
        assert t.has_attn_extras


def _rounds(pkg, eng, rounds, max_tokens):
    """Each round's prompts submitted together and run to completion."""
    out = []
    for prompts in rounds:
        res = eng.generate(prompts, pkg.SamplingParams(max_tokens=max_tokens))
        out.append([r.token_ids for r in res])
    return out


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("spec_k", [0, 4])
def test_engine_ids_match_jax(weights, monkeypatch, spec_k, kv):
    """Greedy ids equal the JAX engine's: a round of three prompts (one
    chunked past the bucket and past the window), then one that extends
    the first prompt (a prefix hit in both engines)."""
    monkeypatch.setattr(
        jengine.InferenceEngine, "_call_ready",
        staticmethod(lambda call: not isinstance(call.arr,
                                                 jengine._StuckPayload)))
    params, model = weights
    rng = np.random.default_rng(5)
    first = [[int(t) for t in rng.integers(2, 160, size=n)]
             for n in (13, 6, 27)]
    hit = first[0] + [int(t) for t in rng.integers(2, 160, size=5)]
    rounds = [first, [hit]]
    ec = dict(ECFG, spec_k=spec_k, kv_dtype=kv)
    jeng = jengine.InferenceEngine(JCFG, params, jengine.EngineConfig(**ec),
                                   eos_id=-1)
    teng = tengine.InferenceEngine(TCFG, model, tengine.EngineConfig(**ec),
                                   eos_id=-1, device="cpu")
    assert (teng.prefill_path, teng.decode_path) == ("dense", "gather")
    assert teng._verify_attn is None
    want = _rounds(jengine, jeng, rounds, 12)
    got = _rounds(tengine, teng, rounds, 12)
    assert got == want
    assert teng.prefix_cache.hits == jeng.prefix_cache.hits > 0
    if spec_k:
        assert teng.spec_verify_steps == jeng.spec_verify_steps > 0


def _attn_inputs(rng, B=3, S=6, T=21, H=4, KVH=2, D=8):
    q = rng.standard_normal((B, S, H, D)).astype(np.float32) * 2.0
    k = rng.standard_normal((B, T, KVH, D)).astype(np.float32) * 2.0
    v = rng.standard_normal((B, T, KVH, D)).astype(np.float32)
    return q, k, v


EXTRAS = [dict(), dict(scale=12.0 ** -0.5, logit_softcap=50.0, window=8),
          dict(logit_softcap=3.0, window=4), dict(window=1)]


@pytest.mark.parametrize("extras", EXTRAS, ids=["none", "gemma", "tight",
                                                "window1"])
def test_plain_attention_extras_match_jax(extras):
    rng = np.random.default_rng(0)
    q, k, v = _attn_inputs(rng)
    B, S, T = q.shape[0], q.shape[1], k.shape[1]
    pos = np.asarray([[p + i for i in range(S)] for p in (0, 7, 15)],
                     np.int32)
    kv_len = pos[:, -1] + 1
    t = torch.from_numpy

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)

    close(tattn.causal_attention(t(q), t(k), t(v), q_positions=t(pos),
                                 kv_len=t(kv_len), **extras),
          jattn.causal_attention(q, k, v, q_positions=pos, kv_len=kv_len,
                                 **extras))
    lengths = np.asarray([1, 9, T], np.int32)
    close(tattn.decode_attention(t(q[:, :1]), t(k), t(v), t(lengths),
                                 **extras),
          jattn.decode_attention(q[:, :1], k, v, lengths, **extras))
    # Paged: 7 lanes' worth of 3-token blocks, shuffled ids, block 0 null.
    bs, nb = 3, T // 3
    ids = 1 + rng.permutation(B * nb).reshape(B, nb).astype(np.int32)
    pk = np.zeros((1 + B * nb, bs, 16), np.float32)
    pv = np.zeros_like(pk)
    pk[ids] = k.reshape(B, nb, bs, 16)
    pv[ids] = v.reshape(B, nb, bs, 16)
    close(tattn.paged_decode_attention(t(q[:, :1]), t(pk), t(pv), t(ids),
                                       t(lengths), **extras),
          jattn.paged_decode_attention(q[:, :1], pk, pv, ids, lengths,
                                       **extras))
    ks = np.abs(pk).reshape(*pk.shape[:2], 2, 8).max(-1) / 127 + 1e-3
    vs = np.abs(pv).reshape(*pv.shape[:2], 2, 8).max(-1) / 127 + 1e-3
    kq = np.round(pk.reshape(*pk.shape[:2], 2, 8) / ks[..., None]).reshape(
        pk.shape).astype(np.int8)
    vq = np.round(pv.reshape(*pv.shape[:2], 2, 8) / vs[..., None]).reshape(
        pv.shape).astype(np.int8)
    ks, vs = ks.astype(np.float32), vs.astype(np.float32)
    close(tattn.paged_decode_attention_quant(
              t(q[:, :1]), t(kq), t(vq), t(ks), t(vs), t(ids), t(lengths),
              **extras),
          jattn.paged_decode_attention_quant(q[:, :1], kq, vq, ks, vs, ids,
                                             lengths, **extras))
    # Verify: JAX's gather reference takes no extras; its dense attention
    # over the gathered pages does.
    start, qlens = pos[:, 0], np.asarray([S, 2, 0], np.int32)
    kk = np.asarray(jattn.gather_pages(pk, ids)).reshape(B, -1, 2, 8)
    vv = np.asarray(jattn.gather_pages(pv, ids)).reshape(B, -1, 2, 8)
    got = tattn.paged_verify_attention(t(q), t(pk), t(pv), t(ids), t(start),
                                       t(qlens), **extras)
    want = jattn.causal_attention(q, kk, vv, q_positions=pos,
                                  kv_len=start + qlens, **extras)
    close(got[:2, :2], np.asarray(want)[:2, :2])


def test_gelu_norm_and_embed_scale_match_jax(weights):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 9, 32)) * 3).astype(np.float32)
    got = tllama._mlp_act(TCFG, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x,
                                                           approximate=True)),
                               rtol=1e-6, atol=1e-6)
    # The unit offset bit for bit: on rows of quarters every sum of
    # squares is exact in any order, so only the norm's own float32 steps
    # remain; on random rows the mean's summation order (torch's against
    # XLA's) moves the last bit.
    w = rng.normal(0.0, 0.3, 32).astype(np.float32)
    quarters = (rng.integers(-8, 9, (4, 9, 32)) / 4).astype(np.float32)
    for rows, exact in ((quarters, True), (x, False)):
        got = t_rms_norm(torch.from_numpy(rows), torch.from_numpy(w), 1e-6,
                         unit_offset=True).numpy()
        want = np.asarray(j_rms_norm(rows, w, 1e-6, unit_offset=True))
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    params, model = weights
    tokens = rng.integers(0, 160, (2, 7)).astype(np.int32)
    got = tllama._embed_lookup(model, torch.from_numpy(tokens)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jllama._embed_lookup(params, JCFG, tokens)))
    # bf16: sqrt(32) rounded to bf16 before the multiply, as in JAX.
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    tb = params_from_jax(jax.tree.map(np.asarray, params),
                         dataclasses.replace(TCFG, dtype="bfloat16"),
                         device="cpu")
    got = tllama._embed_lookup(tb, torch.from_numpy(tokens)).float().numpy()
    want = np.asarray(jllama._embed_lookup(
        jb, dataclasses.replace(JCFG, dtype="bfloat16"), tokens),
        np.float32)
    np.testing.assert_array_equal(got, want)


def test_forward_and_quantized_forward_match_jax(weights):
    """``forward_full`` logits, float32 and int8 weights (the sandwich
    norms kept as they are), within 2e-5 of JAX's."""
    from k8s_llm_monitor_tpu.utils.quantize import quantize_params as jq
    from k8s_llm_monitor_tpu_torch.utils.quantize import quantize_params

    params, model = weights
    tokens = np.random.default_rng(4).integers(0, 160, (2, 20)).astype(
        np.int32)
    want = np.asarray(jllama.forward_full(params, JCFG, tokens))
    got = tllama.forward_full(model, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert np.abs(want).max() < 30.0            # the final cap holds
    q = quantize_params(model)
    jtree = jax.tree.map(np.asarray, jq(params))
    ref = params_from_jax(jtree, TCFG, device="cpu")
    for (n, a), (m, b) in zip(q.state_dict().items(),
                              ref.state_dict().items(), strict=True):
        assert n == m and torch.equal(a, b), n
    want = np.asarray(jllama.forward_full(jq(params), JCFG, tokens))
    got = tllama.forward_full(q, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


GEMMA_HF = dict(model_type="gemma2", vocab_size=160, hidden_size=32,
                intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=8,
                rms_norm_eps=1e-6, max_position_embeddings=256)


@pytest.mark.parametrize("extra", [
    dict(),
    dict(sliding_window=16, query_pre_attn_scalar=12.0,
         attn_logit_softcapping=20.0, final_logit_softcapping=None,
         layer_types=["full_attention", "sliding_attention"],
         tie_word_embeddings=False)], ids=["defaults", "explicit"])
def test_config_from_hf_matches_jax(extra):
    hf = dict(GEMMA_HF, **extra)
    got = tckpt.config_from_hf(hf, name="g")
    want = jckpt.config_from_hf(hf, name="g")
    assert {f: getattr(got, f) for f in _FIELDS} == {
        f: getattr(want, f) for f in _FIELDS}
    assert got.has_attn_extras and got.sandwich_norms


@pytest.fixture(scope="module")
def gemma_checkpoint(tmp_path_factory):
    import transformers

    path = tmp_path_factory.mktemp("gemma2")
    hf = transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
        **{k: v for k, v in GEMMA_HF.items() if k != "model_type"},
        attn_implementation="eager")).eval()
    torch.manual_seed(0)
    with torch.no_grad():
        for p in hf.parameters():
            p.copy_(torch.randn_like(p) * 0.05)
    hf.save_pretrained(path, safe_serialization=True)
    return path


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_gemma2_key_map_matches_jax(gemma_checkpoint, quantize):
    jcfg, tree = jckpt.load_hf_checkpoint(gemma_checkpoint, quantize=quantize)
    cfg, model = tckpt.load_hf_checkpoint(gemma_checkpoint,
                                          quantize=quantize, device="cpu")
    assert {f: getattr(cfg, f) for f in _FIELDS} == {
        f: getattr(jcfg, f) for f in _FIELDS}
    assert cfg.tie_embeddings and model.lm_head is None
    want = params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                           device="cpu").state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert "layers.1.post_mlp_norm" in got
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
