"""Mixtral's mixture of experts in the port (ROADMAP A9) against the JAX
package on the CPU, float32, one set of weights from ``params_from_jax``:

  * ``_moe_mlp_dropless`` within 1e-5 of JAX's on ``tiny-moe`` (8 experts,
    top 2) and on ``tests/test_moe.py``'s ``CFG`` (4 experts over a 48-wide
    FFN), and batch independent (a token's output does not depend on what
    shares its batch);
  * the port's engine gives the JAX engine's greedy ids, spec on and off;
  * int8 and W8A8 experts: the port's ``quantize_params`` gives JAX's codes
    and scales bit for bit (the router kept in the model dtype), and the
    quantized MLP stays within 1e-5 of JAX's (W8A8: the index loop over the
    experts with per-token activation scales, against JAX's einsum);
  * ``init_params_quantized`` of an MoE config is the int8 twin of the
    port's own seeded bf16 model, code for code (JAX's
    ``quantize_expert_stack`` of its expert stacks), built one tensor at a
    time (the deliberate difference: JAX quantizes a whole bf16 tree);
  * the Mixtral HF key map (``tests/test_moe.py``'s state, written as
    safetensors in ``tmp_path``) equals JAX's ``convert_hf_state_dict``,
    bf16 and int8;
  * each weight's spec and each rank's slice at TP 2 and TP 8 equal JAX's
    (the expert axis over ``model``, the router replicated);
  * on a two-rank gloo mesh (four experts of eight a rank) the logits and
    greedy ids equal JAX's TP-2 engine's;
  * ``LocalEngineBackend.from_config`` serves the ``tiny-moe`` preset
    under every ``quantize`` mode.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from k8s_llm_monitor_tpu.models import config as jconfig
from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.parallel import mesh as jmesh
from k8s_llm_monitor_tpu.parallel import sharding as jsharding
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu.utils import checkpoint as jckpt
from k8s_llm_monitor_tpu.utils import quantize as jquant
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models import config as tconfig
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.parallel import mesh as tmesh
from k8s_llm_monitor_tpu_torch.parallel import sharding as tsharding
from k8s_llm_monitor_tpu_torch.serving import engine as tengine
from k8s_llm_monitor_tpu_torch.utils import checkpoint as tckpt
from k8s_llm_monitor_tpu_torch.utils import quantize as tquant


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny engines run fastest on one intra-op thread, and many threads
    per test worker crowd the other workers out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_FIELDS = [f.name for f in dataclasses.fields(tconfig.ModelConfig)]
# tests/test_moe.py's CFG.
MOE_KW = dict(name="tm", vocab_size=200, hidden_size=32,
              intermediate_size=48, num_layers=2, num_heads=4,
              num_kv_heads=2, dtype="float32", rope_theta=10_000.0,
              num_experts=4, num_experts_per_tok=2, capacity_factor=8.0)
TOL = dict(rtol=1e-5, atol=1e-5)
ECFG = dict(max_slots=4, num_blocks=96, block_size=8, max_blocks_per_seq=16,
            prefill_buckets=(16,), spec_rounds_per_iter=2,
            spec_min_accept=0.0)


def _cfgs(name="tiny-moe", **kw):
    if name == "tm":
        return (jconfig.ModelConfig(**dict(MOE_KW, **kw)),
                tconfig.ModelConfig(**dict(MOE_KW, **kw)))
    j = dataclasses.replace(jconfig.PRESETS[name], dtype="float32", **kw)
    t = dataclasses.replace(tconfig.PRESETS[name], dtype="float32", **kw)
    assert {f: getattr(t, f) for f in _FIELDS} == {
        f: getattr(j, f) for f in _FIELDS}
    return j, t


def _tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _cfgs()
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, params_from_jax(_tree(params), tcfg,
                                               device="cpu")


def _x(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("name", ["tiny-moe", "tm"])
def test_moe_mlp_dropless_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    params = jllama.init_params(jax.random.PRNGKey(1), jcfg)
    model = params_from_jax(_tree(params), tcfg, device="cpu")
    x = _x((2, 5, jcfg.hidden_size))
    for li in range(jcfg.num_layers):
        want = np.asarray(jllama._moe_mlp_dropless(params["layers"][li],
                                                   jcfg, x))
        got = tllama._moe_mlp_dropless(model, model.layers[li],
                                       torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    assert not hasattr(model.layers[0], "gate")


def test_moe_dropless_is_batch_independent(tiny):
    _, _, _, model = tiny
    layer = model.layers[0]
    x = torch.from_numpy(_x((3, 7, 64), seed=2))
    full = tllama._moe_mlp_dropless(model, layer, x)
    for b in range(3):
        alone = tllama._moe_mlp_dropless(model, layer, x[b:b + 1])
        np.testing.assert_allclose(full[b:b + 1].numpy(), alone.numpy(),
                                   rtol=1e-6, atol=1e-6)
    one = tllama._moe_mlp_dropless(model, layer, x[1:2, 3:4])
    np.testing.assert_allclose(full[1:2, 3:4].numpy(), one.numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spec_k", [0, 4])
def test_engine_ids_match_jax(tiny, monkeypatch, spec_k):
    """Greedy ids of a chunked prompt and two short ones equal the JAX
    engine's; forward_full logits too."""
    monkeypatch.setattr(
        jengine.InferenceEngine, "_call_ready",
        staticmethod(lambda call: not isinstance(call.arr,
                                                 jengine._StuckPayload)))
    jcfg, tcfg, params, model = tiny
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(3, 256, size=n)]
               for n in (23, 6, 9)]
    ec = dict(ECFG, spec_k=spec_k)
    jres = jengine.InferenceEngine(jcfg, params, jengine.EngineConfig(**ec),
                                   eos_id=-1).generate(
        prompts, jengine.SamplingParams(max_tokens=10))
    eng = tengine.InferenceEngine(tcfg, model, tengine.EngineConfig(**ec),
                                  eos_id=-1, device="cpu")
    tres = eng.generate(prompts, tengine.SamplingParams(max_tokens=10))
    assert [r.token_ids for r in tres] == [r.token_ids for r in jres]
    if spec_k:
        assert eng.spec_verify_steps > 0
    tokens = np.asarray([prompts[0][:20]], np.int32)
    np.testing.assert_allclose(
        tllama.forward_full(model, torch.from_numpy(tokens)).numpy(),
        np.asarray(jllama.forward_full(params, jcfg, tokens)), **TOL)


def test_int8_and_w8a8_experts_match_jax(tiny):
    jcfg, tcfg, params, model = tiny
    jq = jquant.quantize_params(params)
    q = tquant.quantize_params(model)
    ref = params_from_jax(_tree(jq), tcfg, device="cpu")
    got, want = q.state_dict(), ref.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    assert q.layers[0].router.weight.dtype == torch.float32
    assert q.layers[0].gate_e.kernel_q.dtype == torch.int8
    assert tuple(q.layers[0].down_e.scale.shape) == (8, 64)
    x = _x((2, 6, 64), seed=4)
    for aq in (False, True):
        jc = dataclasses.replace(jcfg, act_quant=aq)
        q.cfg = dataclasses.replace(tcfg, act_quant=aq)
        for li in range(2):
            want = np.asarray(jllama._moe_mlp_dropless(jq["layers"][li], jc,
                                                       x))
            got = tllama._moe_mlp_dropless(q, q.layers[li],
                                           torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(got, want, **TOL)


def test_init_params_quantized_is_the_seeded_models_twin():
    """The per-tensor MoE init equals the int8 twin of the port's own
    seeded bf16 model: ``quantize_params`` of it, and JAX's
    ``quantize_expert_stack`` of its expert stacks, code for code."""
    cfg = dataclasses.replace(tconfig.PRESETS["tiny-moe"], num_layers=1)
    seeded = tllama.LlamaModel(cfg, device="cpu", seed=7)
    built = tquant.init_params_quantized(cfg, seed=7, device="cpu")
    want = tquant.quantize_params(seeded).state_dict()
    got = built.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    for name in ("gate_e", "up_e", "down_e"):
        ref = jquant.quantize_expert_stack({"kernel": getattr(
            seeded.layers[0], name).kernel.float().numpy()})
        stack = getattr(built.layers[0], name)
        np.testing.assert_array_equal(stack.kernel_q.numpy(),
                                      np.asarray(ref["kernel_q"]))
        np.testing.assert_array_equal(stack.scale.numpy(),
                                      np.asarray(ref["scale"]))


def _mixtral_state():
    """tests/test_moe.py:test_mixtral_hf_key_map_loads's state, float32."""
    rng = np.random.default_rng(7)
    f32 = np.float32
    state = {
        "model.embed_tokens.weight": rng.standard_normal((64, 16)).astype(f32),
        "model.norm.weight": np.ones(16, f32),
        "lm_head.weight": rng.standard_normal((64, 16)).astype(f32),
    }
    pre = "model.layers.0."
    state[pre + "input_layernorm.weight"] = np.ones(16, f32)
    state[pre + "post_attention_layernorm.weight"] = np.ones(16, f32)
    for ours, theirs in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                         ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj")):
        d = 8 if ours in ("k", "v") else 16
        state[f"{pre}{theirs}.weight"] = rng.standard_normal((d, 16)).astype(
            f32)
    state[pre + "block_sparse_moe.gate.weight"] = rng.standard_normal(
        (4, 16)).astype(f32)
    for e in range(4):
        for w, shape in (("w1", (24, 16)), ("w3", (24, 16)),
                         ("w2", (16, 24))):
            state[f"{pre}block_sparse_moe.experts.{e}.{w}.weight"] = \
                rng.standard_normal(shape).astype(f32)
    return state


@pytest.fixture(scope="module")
def mixtral_dir(tmp_path_factory):
    from safetensors.numpy import save_file

    path = tmp_path_factory.mktemp("mixtral")
    save_file(_mixtral_state(), str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "vocab_size": 64, "hidden_size": 16, "intermediate_size": 24,
        "num_hidden_layers": 1, "num_attention_heads": 4,
        "num_key_value_heads": 2, "rope_theta": 1e6,
        "model_type": "mixtral", "num_local_experts": 4,
        "num_experts_per_tok": 2}))
    return path


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_mixtral_key_map_matches_jax(mixtral_dir, quantize):
    jcfg, tree = jckpt.load_hf_checkpoint(mixtral_dir, quantize=quantize)
    cfg, model = tckpt.load_hf_checkpoint(mixtral_dir, quantize=quantize,
                                          device="cpu")
    assert {f: getattr(cfg, f) for f in _FIELDS} == {
        f: getattr(jcfg, f) for f in _FIELDS}
    assert cfg.num_experts == 4 and cfg.num_experts_per_tok == 2
    want = params_from_jax(_tree(tree), cfg, device="cpu").state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    logits = tllama.forward_full(model, torch.tensor([[1, 2, 3, 4]]))
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("tp", [2, 8])
def test_expert_specs_and_slices_match_jax(tiny, tp, quantized):
    """Each weight's spec is JAX's (transposed for the [out, in] linears,
    as it is for the [E, in, out] stacks), and rank r's slice equals the
    JAX NamedSharding's shard on device r."""
    jcfg, tcfg, params, model = tiny
    if quantized:
        params = jquant.quantize_params(params)
        model = params_from_jax(_tree(params), tcfg, device="cpu")
    state = dict(model.named_parameters()) | dict(model.named_buffers())
    tspecs = tsharding.param_partition_specs(model)
    jspecs = jsharding.param_partition_specs(params)
    mesh = jmesh.create_mesh(jmesh.MeshConfig(model=tp),
                             devices=jax.devices()[:tp])
    seen = set()
    for name, t in state.items():
        parts = name.split(".")
        node, jspec = params, jspecs
        if parts[0] == "layers":
            node = params["layers"][int(parts[1])]
            jspec = jspecs["layers"][int(parts[1])]
            parts = parts[2:]
        stack = parts[0] in ("gate_e", "up_e", "down_e")
        key = parts[-1] if stack or parts[0] == "embed" else {
            "weight": "kernel", "weight_q": "kernel_q"}.get(parts[-1],
                                                           parts[-1])
        if len(parts) == 1:
            jx, js = node[parts[0]], jspec[parts[0]]
        else:
            jx, js = node[parts[0]][key], jspec[parts[0]][key]
        flip = not (t.dim() == 1 or stack or parts[0] == "embed")
        assert tuple(tspecs[name]) == (tuple(js)[::-1] if flip
                                       else tuple(js)), name
        sharded = jax.device_put(jx, NamedSharding(mesh, js))
        for r in range(tp):
            shard = next(s for s in sharded.addressable_shards
                         if s.device == jax.devices()[r])
            ref = np.asarray(shard.data)
            mine = tsharding.shard_tensor(t, tspecs[name], r, tp)
            np.testing.assert_array_equal(
                mine.float().numpy(), (ref.T if flip else ref).astype(
                    np.float32))
        seen.add(parts[0])
    assert {"gate_e", "up_e", "down_e", "router"} <= seen
    k = "kernel_q" if quantized else "kernel"
    assert tspecs[f"layers.0.gate_e.{k}"] == ("model", None, None)
    assert tspecs["layers.0.router.weight"] == (None,)
    if quantized:
        assert tspecs["layers.0.down_e.scale"] == ("model", None)


@pytest.fixture(scope="module")
def mesh():
    m = tmesh.create_mesh(tmesh.MeshConfig(model=2), backend="gloo",
                          device="cpu")
    yield m
    m.close()


def test_tp2_logits_and_ids_match_jax(mesh, monkeypatch):
    """Each rank runs its four experts of eight on the replicated
    activations and the partial sums meet in the all-reduce: logits
    within 2e-5 of JAX's TP-2 forward, greedy ids equal JAX's TP-2
    engine's (gather decode there; the split path per shard here)."""
    monkeypatch.setattr(
        jengine.InferenceEngine, "_call_ready",
        staticmethod(lambda call: not isinstance(call.arr,
                                                 jengine._StuckPayload)))
    jcfg, tcfg = _cfgs(vocab_size=300)
    params = jllama.init_params(jax.random.PRNGKey(4), jcfg)
    model = params_from_jax(_tree(params), tcfg, device="cpu", mesh=mesh)
    assert model.layers[0].gate_e.num_experts == 4
    jm = jmesh.create_mesh(jmesh.MeshConfig(model=2),
                           devices=jax.devices()[:2])
    tokens = np.random.default_rng(0).integers(0, 300, size=(2, 12),
                                               dtype=np.int32)
    want = np.asarray(jax.jit(lambda p, t: jllama.forward_full(p, jcfg, t))(
        jsharding.shard_params(params, jm), tokens))
    got = tllama.forward_full(model, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    rng = np.random.default_rng(6)
    prompts = [[int(t) for t in rng.integers(3, 300, size=n)]
               for n in (21, 7)]
    ec = dict(ECFG, decode_steps_per_iter=4)
    jids = [r.token_ids for r in jengine.InferenceEngine(
        jcfg, params, jengine.EngineConfig(**ec, decode_path="gather"),
        eos_id=-1, mesh=jm).generate(
            prompts, jengine.SamplingParams(max_tokens=8))]
    eng = tengine.InferenceEngine(tcfg, model, tengine.EngineConfig(**ec),
                                  eos_id=-1)
    assert eng.mesh_axes()["model"] == 2
    assert [r.token_ids for r in eng.generate(
        prompts, tengine.SamplingParams(max_tokens=8))] == jids


@pytest.mark.parametrize("quantize", ["", "int8", "w8a8"])
def test_from_config_serves_the_moe_preset(quantize):
    """``LocalEngineBackend.from_config`` with ``llm.tpu.model`` an MoE
    preset builds it under every ``quantize`` mode (the int8 modes through
    the per-tensor ``init_params_quantized``) and answers ``generate``."""
    from k8s_llm_monitor_tpu_torch.monitor import analysis
    from k8s_llm_monitor_tpu_torch.monitor.config import TPULLMConfig

    tc = TPULLMConfig(model="tiny-moe", quantize=quantize, spec_k=0,
                      kv_blocks=64, max_batch=2)
    backend = analysis.LocalEngineBackend.from_config(tc, device="cpu")
    try:
        eng = backend.engine
        assert eng.cfg.num_experts == 8
        assert eng.model.quantized == bool(quantize)
        assert eng.cfg.act_quant == (quantize == "w8a8")
        assert isinstance(backend.generate("why?", max_tokens=4,
                                           temperature=0.0), str)
    finally:
        backend.supervisor.shutdown(grace_s=1.0)
