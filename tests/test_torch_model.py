"""The port's model against the JAX reference on the CPU, float32.

One set of weights: ``init_params`` builds the JAX tree, ``params_from_jax``
converts it.  Logits and updated pages are compared at atol=rtol=1e-5
(pages exclude the null block 0, whose contents are whatever the last
masked write left there -- no reader depends on them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.models import config as jconfig
from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.ops.attention import (
    select_decode_impl as j_select_decode,
)
from k8s_llm_monitor_tpu.ops.attention import (
    select_prefill_impl as j_select_prefill,
)
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models import config as tconfig
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.ops.attention import (
    select_decode_impl as t_select_decode,
)
from k8s_llm_monitor_tpu_torch.ops.attention import (
    select_prefill_impl as t_select_prefill,
)
from k8s_llm_monitor_tpu_torch.ops.attention import (
    paged_decode_attention as t_gather,
)
from k8s_llm_monitor_tpu_torch.ops.attention import (
    select_verify_impl as t_select_verify,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny engines run fastest on one intra-op thread, and many threads
    per test worker crowd the other workers out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-5, rtol=1e-5)
CPU = torch.device("cpu")
_FIELDS = [f.name for f in dataclasses.fields(tconfig.ModelConfig)]


def _port_cfg(jcfg):
    return tconfig.ModelConfig(**{f: getattr(jcfg, f) for f in _FIELDS})


def _weights(jcfg, seed=0, random_bias=False):
    """(JAX params, port model) holding the same float32 weights."""
    tree = jax.tree.map(np.asarray, jllama.init_params(
        jax.random.PRNGKey(seed), jcfg))
    if random_bias:                       # init_params zero-inits biases
        rng = np.random.default_rng(seed)
        for layer in tree["layers"]:
            for name in ("q", "k", "v"):
                b = layer[name]["bias"]
                layer[name]["bias"] = rng.standard_normal(b.shape).astype(
                    np.float32) * 0.1
    params = jax.tree.map(jnp.asarray, tree)
    return params, params_from_jax(tree, _port_cfg(jcfg), device="cpu")


def test_params_from_jax_shapes():
    jcfg = dataclasses.replace(jconfig.TINY_QWEN, dtype="float32")
    params, model = _weights(jcfg)
    assert model.device == CPU
    assert model.embed.weight.shape == params["embed"]["weight"].shape
    assert model.lm_head.weight.shape == params["lm_head"]["kernel"].shape[::-1]
    for layer, src in zip(model.layers, params["layers"]):
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            lin = getattr(layer, name)
            assert tuple(lin.weight.shape) == src[name]["kernel"].shape[::-1]
            np.testing.assert_array_equal(lin.weight.numpy(),
                                          np.asarray(src[name]["kernel"]).T)
        assert layer.q.bias is not None and layer.o.bias is None
    n_jax = sum(x.size for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("preset", ["tiny", "tiny-qwen"])
def test_forward_full_matches_jax(preset):
    jcfg = dataclasses.replace(jconfig.PRESETS[preset], dtype="float32")
    params, model = _weights(jcfg, random_bias=jcfg.qkv_bias)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 12))
    want = jllama.forward_full(params, jcfg, jnp.asarray(tokens, jnp.int32))
    got = tllama.forward_full(model, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# Fused-capable geometry (tests/test_fused_decode.py:54): KVH * D = 128.
JCFG = jconfig.ModelConfig(name="g", vocab_size=128, hidden_size=256,
                           intermediate_size=256, num_layers=1, num_heads=4,
                           num_kv_heads=2, dtype="float32", rope_theta=10_000.0)
NB, BS, MAXB = 16, 8, 4


@pytest.mark.parametrize("path", ["kernel", "plain"])
def test_prefill_chunk_decode_match_jax(path):
    """prefill -> prefill_chunk -> decode_step through both frameworks.
    ``kernel``: the port's flash/fused wrappers (their plain versions on the
    CPU) against JAX's forced flash/fused Pallas kernels in interpret mode;
    ``plain``: dense/gather against dense/gather.  Lane 2 is inactive."""
    tcfg = _port_cfg(JCFG)
    params, model = _weights(JCFG, seed=3)
    if path == "kernel":
        jp = j_select_prefill(platform="cpu", cfg=JCFG, mode="flash")
        jd = j_select_decode(platform="cpu", cfg=JCFG, mode="fused")
        tp = t_select_prefill(CPU, tcfg, "flash")
        td = t_select_decode(CPU, tcfg, "fused")
    else:
        jp = j_select_prefill(platform="cpu", cfg=JCFG, mode="dense")
        jd = j_select_decode(platform="cpu", cfg=JCFG, mode="gather")
        tp = t_select_prefill(CPU, tcfg, "dense")
        td = t_select_decode(CPU, tcfg, "gather")
    rng = np.random.default_rng(4)
    tables = np.zeros((3, MAXB), np.int32)
    tables[0] = [1, 2, 3, 4]
    tables[1] = [7, 5, 9, 6]
    jpages = jllama.init_kv_pages(JCFG, NB, BS)
    tpages = tllama.init_kv_pages(tcfg, NB, BS, CPU)

    def check(jl, tl):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for li in range(JCFG.num_layers):
            for jx, tx in ((jpages.k[li], tpages.k[li]),
                           (jpages.v[li], tpages.v[li])):
                np.testing.assert_allclose(tx.numpy()[1:],
                                           np.asarray(jx)[1:], **TOL)

    def i32(x):
        return np.asarray(x, np.int32)

    # fresh prefill (lane 1 one token below block alignment: 15 = 2*8 - 1)
    toks = i32(rng.integers(0, 128, (3, 16)))
    lens = i32([16, 15, 0])
    jl, jpages = jllama.prefill(params, JCFG, jnp.asarray(toks),
                                jnp.asarray(lens), jpages,
                                jnp.asarray(tables), attn_impl=jp)
    tl, _ = tllama.prefill(model, torch.from_numpy(toks),
                           torch.from_numpy(lens), tpages,
                           torch.from_numpy(tables), attn_impl=tp)
    check(jl[:2], tl[:2])

    # continuation chunk at start = prompt length
    toks = i32(rng.integers(0, 128, (3, 8)))
    start, lens2 = i32([16, 15, 0]), i32([8, 5, 0])
    jl, jpages = jllama.prefill_chunk(
        params, JCFG, jnp.asarray(toks), jnp.asarray(start), jnp.asarray(lens2),
        jpages, jnp.asarray(tables), attn_impl=jp)
    tl, _ = tllama.prefill_chunk(
        model, torch.from_numpy(toks), torch.from_numpy(start),
        torch.from_numpy(lens2), tpages, torch.from_numpy(tables), attn_impl=tp)
    check(jl[:2], tl[:2])

    # two decode steps; lane 0 crosses into its last block (position 24)
    ctx = start + lens2
    for _ in range(2):
        tok = i32(rng.integers(0, 128, (3,)))
        jl, jpages = jllama.decode_step(params, JCFG, jnp.asarray(tok),
                                        jnp.asarray(ctx), jpages,
                                        jnp.asarray(tables), attn_impl=jd)
        tl, _ = tllama.decode_step(model, torch.from_numpy(tok),
                                   torch.from_numpy(ctx), tpages,
                                   torch.from_numpy(tables), attn_impl=td)
        check(jl[:2], tl[:2])
        ctx = ctx + i32([1, 1, 0])


def test_selection_modes():
    tcfg = _port_cfg(JCFG)
    assert t_select_prefill(CPU, tcfg, "auto") is None       # CPU: dense
    assert t_select_prefill(CPU, tcfg, "dense") is None
    assert tllama.is_flash_prefill_impl(t_select_prefill(CPU, tcfg, "flash"))
    assert not tllama.is_fused_decode_impl(t_select_decode(CPU, tcfg, "auto"))
    assert tllama.is_fused_decode_impl(t_select_decode(CPU, tcfg, "fused"))
    gemma_like = dataclasses.replace(tcfg, attn_logit_softcap=50.0)
    with pytest.raises(ValueError):
        t_select_prefill(CPU, gemma_like, "flash")
    with pytest.raises(ValueError):
        t_select_decode(CPU, gemma_like, "fused")
    # An extras model builds and takes JAX's paths: dense prefill, the
    # gather on "auto" and on "pallas", no verify kernel.
    assert tllama.LlamaModel(gemma_like, device="cpu").cfg.has_attn_extras
    assert t_select_prefill(CPU, gemma_like, "auto") is None
    assert t_select_decode(CPU, gemma_like, "auto") is t_gather
    assert t_select_decode(torch.device("cuda", 0), gemma_like,
                           "pallas") is t_gather
    assert t_select_verify(CPU, gemma_like) is None
    # "pallas" is the split path (the paged-attention wrapper); unknown
    # modes raise.
    split = t_select_decode(CPU, tcfg, "pallas")
    assert split.__name__ == "paged_decode_attention_pallas"
    assert not tllama.is_fused_decode_impl(split)
    with pytest.raises(ValueError):
        t_select_decode(CPU, tcfg, "split")
    # On a CUDA device the kernels take bf16 at head_dim 128 only.
    cuda = torch.device("cuda", 0)
    with pytest.raises(ValueError):
        t_select_decode(cuda, tcfg, "fused")                 # float32, D=64
    assert t_select_prefill(cuda, tcfg, "auto") is None
    bf16_128 = dataclasses.replace(tcfg, dtype="bfloat16", head_dim=128)
    assert tllama.is_flash_prefill_impl(t_select_prefill(cuda, bf16_128, "auto"))
    assert tllama.is_fused_decode_impl(t_select_decode(cuda, bf16_128, "auto"))


def test_entry_points_default_to_cuda(monkeypatch):
    # Without a GPU an entry point that was not asked for the CPU raises.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.LlamaModel(tconfig.TINY)
    assert tllama.resolve_device("cpu") == CPU
