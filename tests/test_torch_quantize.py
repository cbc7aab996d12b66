"""The port's int8 weights and W8A8 against the JAX package on the CPU.

  * ``quantize_array``, ``quantize_params`` and ``_quant_act`` give the JAX
    package's codes and scales bit for bit (the same numpy, and the same
    float32 division and rounding in torch);
  * ``_linear`` on one quantized tree: the W8A8 int32 product exactly, the
    outputs (weight-only and W8A8) within float32 atol = rtol = 1e-6 (the
    sums of the weight-only product run in another order);
  * ``forward_full`` logits of ``quantize_params`` on ``tiny`` and
    ``tiny-qwen``, weight-only and W8A8, within atol = rtol = 1e-4 (float32
    activations, four matmuls deep);
  * greedy ids of the int8 and W8A8 engines equal the JAX engines' on
    ``tests/test_quantize.py``'s W8A8 scenario;
  * ``init_params_quantized`` builds JAX's shapes, dtypes and scales (its
    codes come from a torch generator), and ``param_bytes`` about halves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.models import config as jconfig
from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu.utils import quantize as jqz
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models import config as tconfig
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.serving import engine as tengine
from k8s_llm_monitor_tpu_torch.utils import quantize as tqz

LIN_TOL = dict(atol=1e-6, rtol=1e-6)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CFG_KW = dict(name="t", vocab_size=256, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
              rope_theta=10_000.0)
_FIELDS = [f.name for f in dataclasses.fields(tconfig.ModelConfig)]


def _port_cfg(jcfg):
    return tconfig.ModelConfig(**{f: getattr(jcfg, f) for f in _FIELDS})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_array_matches_jax(axis):
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.05, size=(96, 48)).astype(np.float32)
    w[3, :] = 0.0                      # an all-zero row / column: the floor
    w[:, 5] = 0.0
    got = tqz.quantize_array(w, axis=axis)
    want = jqz.quantize_array(w, axis=axis)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)


def test_quantize_params_matches_jax():
    jcfg = dataclasses.replace(jconfig.TINY_QWEN, dtype="float32")
    tree = _np(jllama.init_params(jax.random.PRNGKey(0), jcfg))
    model = params_from_jax(tree, _port_cfg(jcfg), device="cpu")
    q = tqz.quantize_params(model)
    want = _np(jqz.quantize_params(jax.tree.map(jnp.asarray, tree)))
    assert q.quantized and q.embed.weight_q.dtype == torch.int8
    np.testing.assert_array_equal(q.embed.weight_q.numpy(),
                                  want["embed"]["weight_q"])
    np.testing.assert_array_equal(q.embed.scale.numpy(),
                                  want["embed"]["scale"])
    np.testing.assert_array_equal(q.lm_head.weight_q.numpy().T,
                                  want["lm_head"]["kernel_q"])
    for layer, src in zip(q.layers, want["layers"]):
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            lin = getattr(layer, name)
            np.testing.assert_array_equal(lin.weight_q.numpy().T,
                                          src[name]["kernel_q"])
            np.testing.assert_array_equal(lin.scale.numpy(),
                                          src[name]["scale"])
        np.testing.assert_array_equal(layer.q.bias.numpy(),
                                      src["q"]["bias"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_act_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 64)) * 2.0).astype(np.float32)
    x[0, 0] = 0.0                      # the 1e-8 floor
    x[1, 2, :4] = [127.0, -127.0, 63.5, 0.5]   # ties at the rounding
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jllama._quant_act(jx)
    tq, ts = tllama._quant_act(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("rows", [3, 40])
def test_linear_matches_jax(rows):
    """Weight-only and W8A8 ``_linear`` on one quantized tree; 3 rows take
    the padded int8 product (16 rows or fewer), 40 the plain one."""
    jcfg = jconfig.ModelConfig(**CFG_KW)
    tree = _np(jqz.quantize_params(jllama.init_params(
        jax.random.PRNGKey(0), jcfg)))
    model = params_from_jax(tree, _port_cfg(jcfg), device="cpu")
    x = np.random.default_rng(2).standard_normal(
        (rows, 64)).astype(np.float32)
    jp, lin = tree["layers"][0]["gate"], model.layers[0].gate
    tx = torch.from_numpy(x)
    jq, _ = jllama._quant_act(jnp.asarray(x))
    y32 = jax.lax.dot_general(jq, jnp.asarray(jp["kernel_q"]),
                              (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    got32 = tllama._int8_matmul(tllama._quant_act(tx)[0], lin.weight_q)
    assert got32.dtype == torch.int32 and got32.shape == (rows, 128)
    np.testing.assert_array_equal(got32.numpy(), np.asarray(y32))
    jp_j = jax.tree.map(jnp.asarray, jp)
    for aq in (False, True):
        want = np.asarray(jllama._linear(jp_j, jnp.asarray(x), aq))
        got = tllama._linear(lin, tx, aq).numpy()
        np.testing.assert_allclose(got, want, **LIN_TOL)


@pytest.mark.parametrize("act_quant", [False, True], ids=["int8", "w8a8"])
@pytest.mark.parametrize("preset", ["tiny", "tiny-qwen"])
def test_forward_full_quantized_matches_jax(preset, act_quant):
    jcfg = dataclasses.replace(jconfig.PRESETS[preset], dtype="float32",
                               act_quant=act_quant)
    tree = _np(jqz.quantize_params(jllama.init_params(
        jax.random.PRNGKey(0), dataclasses.replace(jcfg, act_quant=False))))
    if jcfg.qkv_bias:                  # init_params zero-inits biases
        rng = np.random.default_rng(3)
        for layer in tree["layers"]:
            for name in ("q", "k", "v"):
                layer[name]["bias"] = (rng.standard_normal(
                    layer[name]["bias"].shape) * 0.1).astype(np.float32)
    model = params_from_jax(tree, _port_cfg(jcfg), device="cpu")
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 12))
    want = np.asarray(jllama.forward_full(jax.tree.map(jnp.asarray, tree),
                                          jcfg, jnp.asarray(tokens)))
    got = tllama.forward_full(model, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


@pytest.fixture(scope="module")
def quant_tree():
    return _np(jqz.quantize_params(jllama.init_params(
        jax.random.PRNGKey(0), jconfig.ModelConfig(**CFG_KW))))


@pytest.mark.parametrize("act_quant", [False, True], ids=["int8", "w8a8"])
def test_quantized_engine_greedy_ids_match_jax_engine(quant_tree, act_quant):
    """tests/test_quantize.py's W8A8 engine scenario on both engines."""
    jcfg = jconfig.ModelConfig(**CFG_KW, act_quant=act_quant)
    tcfg = tconfig.ModelConfig(**CFG_KW, act_quant=act_quant)
    ekw = dict(max_slots=2, num_blocks=64, block_size=8,
               max_blocks_per_seq=16, prefill_buckets=(16, 32))
    rng = np.random.default_rng(6)
    prompts = [[int(t) for t in rng.integers(3, 250, size=n)]
               for n in (6, 11, 40)]
    want = jengine.InferenceEngine(
        jcfg, jax.tree.map(jnp.asarray, quant_tree),
        jengine.EngineConfig(**ekw), eos_id=-1).generate(
        prompts, jengine.SamplingParams(max_tokens=5))
    model = params_from_jax(quant_tree, tcfg, device="cpu")
    got = tengine.InferenceEngine(
        tcfg, model, tengine.EngineConfig(**ekw), eos_id=-1,
        device="cpu").generate(prompts, tengine.SamplingParams(max_tokens=5))
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert all(len(r.token_ids) == 5 for r in got)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_init_params_quantized_matches_jax_layout(tie):
    jcfg = dataclasses.replace(jconfig.TINY_QWEN, tie_embeddings=tie)
    want = _np(jqz.init_params_quantized(jax.random.PRNGKey(0), jcfg))
    model = tqz.init_params_quantized(_port_cfg(jcfg), seed=0, device="cpu")
    again = tqz.init_params_quantized(_port_cfg(jcfg), seed=0, device="cpu")
    assert model.quantized and (model.lm_head is None) == tie
    pairs = [(model.embed, want["embed"], False)]
    if not tie:
        pairs.append((model.lm_head, want["lm_head"], True))
    for layer, src in zip(model.layers, want["layers"]):
        pairs += [(getattr(layer, n), src[n], True)
                  for n in ("q", "k", "v", "o", "gate", "up", "down")]
        assert layer.input_norm.dtype == torch.bfloat16
        assert bool((layer.input_norm == 1).all())
        if tie is False:
            assert bool((layer.q.bias == 0).all())
    for mod, src, linear in pairs:
        codes = mod.weight_q.numpy()
        want_codes = src["kernel_q"].T if linear else src["weight_q"]
        assert codes.dtype == want_codes.dtype == np.int8
        assert codes.shape == want_codes.shape
        assert codes.min() >= -127 and codes.max() <= 127
        np.testing.assert_array_equal(mod.scale.numpy(), src["scale"])
    np.testing.assert_array_equal(model.embed.weight_q.numpy(),
                                  again.embed.weight_q.numpy())


def test_param_bytes_about_halve():
    cfg = dataclasses.replace(tconfig.TINY_QWEN)
    dense = tllama.LlamaModel(cfg, device="cpu", seed=0)
    quant = tqz.quantize_params(dense)
    assert tqz.param_bytes(quant) < 0.75 * tqz.param_bytes(dense)
    assert tqz.param_bytes(dense) == sum(
        p.numel() * 2 for p in dense.parameters())
