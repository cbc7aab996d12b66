"""The monitor's default model on the port's kernel path: head_dim 64.

  * The split-KV wrappers' plain versions at head_dim 64 (fused rows of 2
    kv heads x 64 = 128 lanes, 4 query heads per kv head) against the JAX
    Pallas kernels in interpret mode, on the same inputs made from a numpy
    seed: fused decode over a float32 pool and over int8 / fp8 pools (the
    appended codes and scales included), and split paged attention at 1
    and 5 query tokens per lane.  Tolerance: float32, atol = rtol = 2e-5
    (the sums run in another order); the appended codes and scales exactly.
  * Path selection per preset: the port's ``select_decode_impl``,
    ``select_prefill_impl`` and ``select_verify_impl`` with
    ``torch.device("cuda")`` name the path the JAX package picks with
    ``platform="tpu"`` (the selectors
    launch nothing, so no card is needed), for tiny, llama-1b, llama3-8b,
    mistral-7b and qwen2-7b (7 query heads per kv head); a forced
    ``decode_path="pallas"`` or speculative verify on a geometry the kernel
    cannot take (tiny) raises in the port where the JAX package gives way
    to the gather; and the port verifies on the kernel at every table
    width, where the JAX package keeps the gather under 2,048 tokens.
  * ``act_quant`` (W8A8) on unquantized weights raises in the port, where
    the JAX package warns and runs the bf16 matmuls.
  * ``K8SLLM_KV_DTYPE``, ``K8SLLM_PREFILL_PATH`` and ``K8SLLM_DECODE_PATH``
    override the EngineConfig in both engines alike.
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
from k8s_llm_monitor_tpu_torch.models import config as tconfig
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.ops import attention as tattn
from k8s_llm_monitor_tpu_torch.ops import paged_attention as pa
from k8s_llm_monitor_tpu_torch.ops.rope import rope_angles as t_rope_angles
from k8s_llm_monitor_tpu_torch.serving import engine as tengine

TOL = dict(rtol=2e-5, atol=2e-5)
THETA = 10_000.0
D, H, KVH, BS = 64, 8, 2, 4
J_DTYPE = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _pool(rng, nb, kind):
    """A float32 pool, or one quantized by the port (codes, scales)."""
    kp, vp = (torch.from_numpy(rng.standard_normal((nb, BS, KVH * D))
                               .astype(np.float32)) for _ in range(2))
    if kind == "bf16":
        return kp, vp, ()
    qdt, qmax = tllama.kv_quant_spec(kind)
    (kp, ks), (vp, vs) = (tllama.quantize_kv(x, KVH, qdt, qmax)
                          for x in (kp, vp))
    return kp, vp, (ks, vs)


def _tables(rng, lanes_live, max_blocks):
    table = np.zeros((len(lanes_live), max_blocks), np.int32)
    perm = rng.permutation(np.arange(1, len(lanes_live) * max_blocks + 2))
    for b, live in enumerate(lanes_live):
        if live:
            table[b] = perm[b * max_blocks:(b + 1) * max_blocks]
    return table


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_fused_decode_plain_equals_pallas(kind):
    # Positions: an inactive lane, one cached row, both sides of a block
    # boundary, the table's last row.
    positions = np.asarray([0, 1, 7, 8, 23], np.int32)
    max_blocks = 6
    rng = np.random.default_rng(64 + len(kind))
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
    if kind == "bf16":
        got = pa.paged_decode_attention_fused(tq, tk, tv, cos, sin, *pool,
                                              ttab, tpos)
        want = j_fused(*jargs, jnp.asarray(kp.numpy()),
                       jnp.asarray(vp.numpy()), jnp.asarray(table),
                       jnp.asarray(positions), interpret=True)
    else:
        got = pa.paged_decode_attention_fused_quant(tq, tk, tv, cos, sin,
                                                    *pool, ttab, tpos)
        codes = [jnp.asarray(x.float().numpy()).astype(J_DTYPE[kind])
                 for x in (kp, vp)]
        want = j_fused_quant(*jargs, *codes,
                             *(jnp.asarray(s.numpy()) for s in scales),
                             jnp.asarray(table), jnp.asarray(positions),
                             interpret=True)
    act = positions > 0
    np.testing.assert_allclose(got[0].numpy()[act],
                               np.asarray(want[0])[act], **TOL)
    # The appended rows: pages, and on a quantized pool the codes exactly
    # and the scales to one float32 ulp (XLA on the CPU turns the division
    # by qmax into a multiply by its reciprocal; on the card the kernel and
    # the port's plain version divide alike and chip_smoke.py holds them
    # bit for bit).
    for b in np.flatnonzero(act):
        blk, off = table[b, positions[b] // BS], positions[b] % BS
        for i, (mine, theirs) in enumerate(zip(got[1:], want[1:])):
            m = mine[blk, off].float().numpy()
            t = np.asarray(theirs[blk, off]).astype(np.float32)
            if kind == "bf16":
                np.testing.assert_allclose(m, t, **TOL)
            elif i < 2:
                np.testing.assert_array_equal(m, t)
            else:
                np.testing.assert_allclose(m, t, rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("QS", [1, 5])
def test_paged_attention_plain_equals_pallas(QS):
    # Seven lanes (the Pallas interpreter runs an odd batch one lane per
    # program): a lane inside the first block, block boundaries, an empty
    # lane, rows past qlens, the table's last rows.
    starts = [0, 3, 7, 8, 5, 13, 19]
    qlens = [min(QS, 3), QS, QS, QS, 0, max(QS - 2, 1), QS]
    max_blocks = 6
    rng = np.random.default_rng(640 + QS)
    B = len(starts)
    q = rng.standard_normal((B, QS, H, D)).astype(np.float32)
    kp, vp, _ = _pool(rng, B * max_blocks + 2, "bf16")
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


# ---------------------------------------------------------------------------
# Path selection per preset
# ---------------------------------------------------------------------------

CUDA = torch.device("cuda")


def _name(impl) -> str:
    if impl is None:
        return "none"
    fn = getattr(impl, "func", impl)        # the JAX selectors' partials
    return fn.__name__


def _outcome(select, *args, **kw) -> str:
    try:
        return _name(select(*args, **kw))
    except ValueError:
        return "raises"


def _port_cfg(name):
    """The port's preset, held to the JAX preset's fields."""
    t, j = tconfig.PRESETS[name], jconfig.PRESETS[name]
    assert all(getattr(t, f.name) == getattr(j, f.name)
               for f in dataclasses.fields(tconfig.ModelConfig)), name
    return t


PRESETS = ("tiny", "llama-1b", "llama3-8b", "mistral-7b")


@pytest.mark.parametrize("preset", PRESETS + ("qwen2-7b",))
def test_path_selection_matches_jax_per_preset(preset):
    jcfg, tcfg = jconfig.PRESETS[preset], _port_cfg(preset)
    got, want = {}, {}
    for kv in ("", "int8"):
        for mode in ("auto", "fused", "pallas", "gather"):
            want["decode", kv, mode] = _outcome(
                jattn.select_decode_impl, "tpu", cfg=jcfg, mode=mode,
                kv_quant=kv)
            got["decode", kv, mode] = _outcome(
                tattn.select_decode_impl, CUDA, tcfg, mode, kv_quant=kv)
    for mode in ("auto", "flash", "dense"):
        want["prefill", mode] = _outcome(jattn.select_prefill_impl, "tpu",
                                         cfg=jcfg, mode=mode)
        got["prefill", mode] = _outcome(tattn.select_prefill_impl, CUDA,
                                        tcfg, mode)
    # The unscaled fp8 pool (ModelConfig.kv_dtype, B8): no selector of
    # either package looks at the page dtype, so each picks what it picks
    # for the model-dtype pool (kv_quant stays "").
    jcfg8 = dataclasses.replace(jcfg, kv_dtype="float8_e4m3fn")
    tcfg8 = dataclasses.replace(tcfg, kv_dtype="float8_e4m3fn")
    for mode in ("auto", "fused", "pallas", "gather"):
        want["decode", "fp8 pool", mode] = _outcome(
            jattn.select_decode_impl, "tpu", cfg=jcfg8, mode=mode)
        got["decode", "fp8 pool", mode] = _outcome(
            tattn.select_decode_impl, CUDA, tcfg8, mode)
    for mode in ("auto", "flash", "dense"):
        want["prefill", "fp8 pool", mode] = _outcome(
            jattn.select_prefill_impl, "tpu", cfg=jcfg8, mode=mode)
        got["prefill", "fp8 pool", mode] = _outcome(
            tattn.select_prefill_impl, CUDA, tcfg8, mode)
    want["verify", "fp8 pool"] = _outcome(
        jattn.select_verify_impl, "tpu", cfg=jcfg8, max_table_tokens=4096)
    got["verify", "fp8 pool"] = _outcome(tattn.select_verify_impl, CUDA,
                                         tcfg8)
    for mode in ("auto", "fused", "pallas", "gather"):
        assert got["decode", "fp8 pool", mode] == got["decode", "", mode]
    # A listed divergence: the JAX package keeps the gather under a
    # 2,048-token table (a TPU measurement); the port takes the kernel at
    # every width (it is the faster on the H100 at 1,024 tokens, PERF.md
    # section 7), so it is held against JAX's long-table choice.
    assert _outcome(jattn.select_verify_impl, "tpu", cfg=jcfg,
                    max_table_tokens=1024) == "paged_verify_attention"
    want["verify",] = _outcome(jattn.select_verify_impl, "tpu", cfg=jcfg,
                               max_table_tokens=4096)
    got["verify",] = _outcome(tattn.select_verify_impl, CUDA, tcfg)
    if preset == "llama-1b":
        # The default model decodes on the split-KV kernels at head_dim 64
        # and prefills densely (flash keeps head_dim 128, as on the TPU).
        assert got["decode", "", "auto"] == "paged_decode_attention_fused"
        assert got["decode", "int8", "auto"] == (
            "paged_decode_attention_fused_quant")
        assert got["decode", "", "pallas"] == "paged_decode_attention_pallas"
        assert got["prefill", "auto"] == "none"
        assert got["verify",] == "paged_verify_attention_pallas"
    if preset == "qwen2-7b":
        # 7 query heads per kv head, head_dim 128: every kernel (B7).
        assert got["decode", "", "auto"] == "paged_decode_attention_fused"
        assert got["prefill", "auto"] == "flash_prefill_attention"
        assert got["verify",] == "paged_verify_attention_pallas"
    if preset == "tiny":
        # fp32: the port's kernels take bf16 only, and the port refuses
        # where the JAX package gathers.
        want["decode", "", "pallas"] = "raises"
        want["verify",] = "raises"
        want["decode", "fp8 pool", "pallas"] = "raises"
        want["verify", "fp8 pool"] = "raises"
    assert got == want


def test_act_quant_on_unquantized_weights_raises():
    """A listed difference (ROADMAP section C): the JAX package warns and
    runs the bf16 matmuls; the port refuses to build such a model."""
    jcfg = dataclasses.replace(jconfig.TINY, dtype="float32", act_quant=True)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    with pytest.warns(UserWarning, match="act_quant"):
        jllama.forward_full(params, jcfg, jnp.zeros((1, 4), jnp.int32))
    tcfg = dataclasses.replace(tconfig.TINY, dtype="float32", act_quant=True)
    with pytest.raises(ValueError, match="act_quant"):
        tllama.LlamaModel(tcfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="act_quant"):
        params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")


# ---------------------------------------------------------------------------
# The environment overrides
# ---------------------------------------------------------------------------

CFG_KW = dict(name="t", vocab_size=300, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=1e4)
ECFG_KW = dict(max_slots=2, num_blocks=16, block_size=8, max_blocks_per_seq=4,
               prefill_buckets=(16,))


@pytest.fixture(scope="module")
def weights():
    params = jllama.init_params(jax.random.PRNGKey(0),
                                jconfig.ModelConfig(**CFG_KW))
    model = params_from_jax(jax.tree.map(np.asarray, params),
                            tconfig.ModelConfig(**CFG_KW), device="cpu")
    return params, model


@pytest.mark.parametrize("env,ecfg", [
    ({"K8SLLM_KV_DTYPE": "int8"}, {}),
    ({"K8SLLM_KV_DTYPE": "fp8", "K8SLLM_DECODE_PATH": "gather"}, {}),
    ({"K8SLLM_PREFILL_PATH": "flash"}, {}),
    # The environment wins over the config in both directions.
    ({"K8SLLM_KV_DTYPE": "auto", "K8SLLM_PREFILL_PATH": "dense"},
     {"kv_dtype": "int8", "prefill_path": "flash"}),
])
def test_environment_overrides_engine_config(weights, monkeypatch, env, ecfg):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(ECFG_KW, **ecfg)
    j = jengine.InferenceEngine(jconfig.ModelConfig(**CFG_KW), weights[0],
                                jengine.EngineConfig(**kw), eos_id=-1)
    t = tengine.InferenceEngine(tconfig.ModelConfig(**CFG_KW), weights[1],
                                tengine.EngineConfig(**kw), eos_id=-1,
                                device="cpu")
    assert (t.kv_quant, t.prefill_path, t.decode_path) == (
        j.kv_quant, j.prefill_path, j.decode_path)
    want_kv = env.get("K8SLLM_KV_DTYPE", "auto").replace("auto", "")
    assert t.kv_quant == want_kv
    assert t.pages.k[0].element_size() == (1 if want_kv else 4)
    if "K8SLLM_PREFILL_PATH" in env:
        assert t.prefill_path == env["K8SLLM_PREFILL_PATH"]
