"""Tensor parallelism over the model axis (parallel/*, the TP paths of
models/llama.py, ops/attention.py and serving/engine.py) against the JAX
package on its 8-device CPU mesh.

The port's mesh is one process per rank over gloo (``backend="gloo"``,
spawned workers); the JAX reference is ``create_mesh(MeshConfig(model=2),
devices=jax.devices()[:2])``.  One port mesh serves the whole module
(``mesh`` fixture: spawned once) and every engine and model of it in turn;
``test_server_serves_mesh_shape`` builds its own through ``from_config``
and runs first, before the fixture's mesh exists (one process group per
process).  The JAX TP engines decode on the gather path (its CPU default is
the Pallas interpreter per shard, about 7x slower, same ids); the port's
take their TP path (the split paged attention wrapper per shard, its plain
version on the CPU).  fp32 tiny configs; logits at rtol/atol 2e-5 (the JAX
package's TP tolerance, tests/test_sharding.py:57).
"""

import dataclasses
import json
import time
import types
import urllib.request

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from k8s_llm_monitor_tpu.diagnosis.grammar import compile_schema as j_compile
from k8s_llm_monitor_tpu.diagnosis.grammar import token_fsm as j_token_fsm
from k8s_llm_monitor_tpu.models import config as jconfig
from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.parallel import mesh as jmesh
from k8s_llm_monitor_tpu.parallel import overlap as joverlap
from k8s_llm_monitor_tpu.parallel import sharding as jsharding
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu.utils.quantize import quantize_params as j_quantize
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.diagnosis.grammar import compile_schema, token_fsm
from k8s_llm_monitor_tpu_torch.models import config as tconfig
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.parallel import mesh as tmesh
from k8s_llm_monitor_tpu_torch.parallel import overlap as toverlap
from k8s_llm_monitor_tpu_torch.parallel import sharding as tsharding
from k8s_llm_monitor_tpu_torch.serving import engine as tengine
from k8s_llm_monitor_tpu_torch.utils.tokenizer import ByteTokenizer

TOL = dict(rtol=2e-5, atol=2e-5)
TOK = ByteTokenizer()
# One kv head per rank at TP 2 (tiny), Qwen2's biases (tiny-qwen), and a
# single kv head that TP 2 cannot split (the pages replicate).
PRESETS = ("tiny", "tiny-qwen")
SMALL_SCHEMA = {"type": "object",
                "properties": {"ok": {"enum": ["yes", "no"]}},
                "required": ["ok"]}
ECFG = dict(max_slots=4, num_blocks=128, block_size=8, max_blocks_per_seq=32,
            prefill_buckets=(16,), decode_steps_per_iter=4,
            prefix_cache_entries=0)


def _cfgs(name, **kw):
    j = dataclasses.replace(jconfig.PRESETS[name], dtype="float32", **kw)
    t = dataclasses.replace(tconfig.PRESETS[name], dtype="float32", **kw)
    return j, t


def _jmesh(tp=2):
    return jmesh.create_mesh(jmesh.MeshConfig(model=tp),
                             devices=jax.devices()[:tp])


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _requests(vocab, constrained):
    """A mixed wave: a chunked long prompt (> the 16 bucket), two short
    ones of uneven budgets, and a grammar-constrained lane."""
    rng = np.random.default_rng(5)
    reqs = [("long", [int(t) for t in rng.integers(3, vocab, size=40)], 8),
            ("short-a", [int(t) for t in rng.integers(3, vocab, size=7)], 8),
            ("short-b", [int(t) for t in rng.integers(3, vocab, size=5)], 12)]
    if constrained:
        reqs.append(("verdict", TOK.encode("why is web crashlooping?"), 1))
    return reqs


def _run(eng, pkg, reqs, constrained):
    if constrained:
        build = (j_token_fsm, j_compile) if pkg is jengine else (
            token_fsm, compile_schema)
        eng.set_grammar(build[0](build[1](SMALL_SCHEMA), eos_id=TOK.eos_id))
    for rid, prompt, n in reqs:
        eng.submit(pkg.GenerationRequest(
            request_id=rid, prompt_ids=list(prompt),
            sampling=pkg.SamplingParams(max_tokens=n,
                                        constrained=rid == "verdict")))
    while eng.has_work:
        eng.step()
    out = {}
    for rid, _, _ in reqs:
        res = eng.poll(rid)
        assert res is not None and res.finish_reason != "error", res
        out[rid] = list(res.token_ids)
    return out


# ---------------------------------------------------------------------------
# Specs and slices (no process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
def test_partition_specs_and_slices_match_jax(quantized):
    """Role by role, the port's spec of each weight is JAX's (transposed for
    the [out, in] kernels), and each rank's slice of it is bit-equal to the
    JAX NamedSharding's shard on the device of the same index."""
    jcfg, tcfg = _cfgs("tiny-qwen")
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    if quantized:
        params = j_quantize(params)
    full = params_from_jax(_tree(params), tcfg, device="cpu")
    state = dict(full.named_parameters()) | dict(full.named_buffers())
    tspecs = tsharding.param_partition_specs(full)
    jspecs = jsharding.param_partition_specs(params)
    mesh = _jmesh()
    for name, t in state.items():
        parts = name.split(".")
        node, jspec = params, jspecs
        if parts[0] == "layers":
            node = params["layers"][int(parts[1])]
            jspec = jspecs["layers"][int(parts[1])]
            parts = parts[2:]
        key = {"weight": "kernel", "weight_q": "kernel_q"}.get(parts[-1],
                                                               parts[-1])
        if parts[0] == "embed":
            key = parts[-1]
        if len(parts) == 1:
            jx, js = node[parts[0]], jspec[parts[0]]
        else:
            jx, js = node[parts[0]][key], jspec[parts[0]][key]
        want = tuple(js) if t.dim() == 1 or parts[0] == "embed" else \
            tuple(js)[::-1]
        assert tuple(tspecs[name]) == want, name
        sharded = jax.device_put(jx, NamedSharding(mesh, js))
        for r in range(2):
            shard = next(s for s in sharded.addressable_shards
                         if s.device == jax.devices()[r])
            mine = tsharding.shard_tensor(t, tspecs[name], r, 2)
            ref = np.asarray(shard.data)
            ref = ref if t.dim() == 1 or parts[0] == "embed" else ref.T
            np.testing.assert_array_equal(mine.float().numpy(),
                                          ref.astype(np.float32))
    w = "weight_q" if quantized else "weight"
    assert tspecs[f"layers.0.q.{w}"] == ("model", None)
    assert tspecs[f"layers.0.o.{w}"] == (None, "model")
    assert tspecs[f"embed.{w}"] == ("model", None)
    assert tspecs["layers.0.k.bias"] == ("model",)
    assert tspecs["final_norm"] == (None,)


def test_more_ranks_than_cards_raise_unless_gloo(monkeypatch):
    """NCCL needs a card per rank: two ranks on one card raise, as JAX's
    create_mesh does with too few devices (the check runs before any
    process starts; gloo, asked for by name, would share the card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.create_mesh(tmesh.MeshConfig(model=2))
    with pytest.raises(ValueError, match="a card per rank"):
        tmesh.create_mesh(tmesh.MeshConfig(model=2),
                          devices=["cuda:0", "cuda:0"])


def test_kv_specs_replicate_where_tp_does_not_divide_and_axes_raise():
    """Pages split on kv-head boundaries, or replicate, as JAX's layout
    says; a data or seq mesh is refused only where any mesh is (NCCL
    needs a card per rank and CUDA; gloo is asked for by name; a device
    list must name every rank; an axis below 1), before any process
    starts (the seq bucket check: tests/test_torch_seq.py)."""
    tl, jl = tsharding.DEFAULT_LAYOUT, jsharding.DEFAULT_LAYOUT
    for kvh in (1, 2, 4, 8):
        for tp in (1, 2, 3, 4, 8, 16):
            assert tuple(tl.kv_pages(kvh, tp)) == tuple(jl.kv_pages(kvh, tp))
            assert tuple(tl.kv_scales(kvh, tp)) == tuple(jl.kv_scales(kvh, tp))
    assert tsharding.local_kv_heads(8, 2) == 4
    assert tsharding.local_kv_heads(8, 16) == 8
    jcfg, tcfg = _cfgs("tiny")
    for tp, kv in ((2, "auto"), (4, "int8")):
        jpages = jllama.init_kv_pages(jcfg, 4, 8, kv_quant=kv if kv != "auto"
                                      else "")
        want = jsharding.kv_pages_partition_specs(
            jpages, types.SimpleNamespace(shape={"model": tp}),
            jcfg.num_kv_heads)
        got = tsharding.kv_pages_partition_specs(
            jcfg.num_layers, types.SimpleNamespace(shape={"model": tp}),
            tcfg.num_kv_heads, quantized=kv == "int8")
        for leaf in ("k", "v", "k_scale", "v_scale"):
            assert [tuple(x) for x in got[leaf]] == [
                tuple(x) for x in getattr(want, leaf)], (tp, leaf)
    for grid in (tmesh.MeshConfig(seq=2), tmesh.MeshConfig(data=2, model=2)):
        with pytest.raises(ValueError, match="gloo"):
            tmesh.create_mesh(grid, device="cpu")
        with pytest.raises(ValueError, match=f"needs {grid.size} devices"):
            tmesh.create_mesh(grid, devices=["cpu"] * 2 * grid.size,
                              backend="gloo")
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.create_mesh(tmesh.MeshConfig(seq=0), backend="gloo",
                          device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        tmesh.create_mesh(tmesh.MeshConfig(model=2), device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.create_mesh(tmesh.MeshConfig(model=2), devices=["cpu"],
                          backend="gloo")
    assert tmesh.parse_mesh_shape("1,1,4").shape == {"data": 1, "seq": 1,
                                                    "model": 4}


def test_overlap_supported_reasons_match_jax():
    """``overlap_supported``'s reason per preset and degree is JAX's, and
    the engine's tp_overlap switch is read as JAX's is (``on`` raises with
    no mesh, the environment wins, an unknown value raises)."""
    for name in tconfig.PRESETS:
        for tp in (1, 2, 4, 8, 16):
            shape = types.SimpleNamespace(shape={"model": tp})
            assert (toverlap.overlap_supported(tconfig.PRESETS[name], shape)
                    == joverlap.overlap_supported(jconfig.PRESETS[name],
                                                  shape)), (name, tp)
    assert toverlap.overlap_supported(tconfig.TINY, None) == "no mesh"
    _, tcfg = _cfgs("tiny")
    model = tllama.LlamaModel(tcfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="tp_overlap"):
        tengine.InferenceEngine(tcfg, model, tengine.EngineConfig(
            **ECFG, tp_overlap="on"), device="cpu")


def test_tp_overlap_environment_overrides(monkeypatch):
    _, tcfg = _cfgs("tiny")
    model = tllama.LlamaModel(tcfg, device="cpu", seed=0)
    monkeypatch.setenv("K8SLLM_TP_OVERLAP", "off")
    eng = tengine.InferenceEngine(tcfg, model, tengine.EngineConfig(
        **ECFG, tp_overlap="on"), device="cpu")
    assert not eng.tp_overlap and eng.mesh_axes() == {}
    monkeypatch.setenv("K8SLLM_TP_OVERLAP", "bogus")
    with pytest.raises(ValueError, match="tp_overlap"):
        tengine.InferenceEngine(tcfg, model, tengine.EngineConfig(**ECFG),
                                device="cpu")


# ---------------------------------------------------------------------------
# The front door (its own mesh, through from_config)
# ---------------------------------------------------------------------------


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        return r.read().decode()


def test_server_serves_mesh_shape():
    """``load_config(None)`` with ``llm.tpu.mesh_shape "1,1,2"`` (tiny, on
    the CPU over gloo) through build_server: queries answer 200, /metrics
    reads the mesh's model axis, /api/v1/stats states the mesh, and a
    step-loop kill rebuilds the engine on the workers and serves again.
    Then a decode call that fails on rank 0 after the workers were sent
    it, and a worker killed while requests are in flight, each break the
    mesh for good (the step loop dies; nothing retries on it): the
    supervisor's factory kills the workers, builds a new mesh and the
    model on it, and every request completes with the greedy ids of an
    undisturbed run."""
    from k8s_llm_monitor_tpu_torch.monitor.cluster import (
        FakeCluster,
        seed_demo_cluster,
    )
    from k8s_llm_monitor_tpu_torch.monitor.config import load_config
    from k8s_llm_monitor_tpu_torch.monitor.server import build_server
    from k8s_llm_monitor_tpu_torch.resilience.faults import get_injector

    c = load_config(None)
    c.server.port = 0
    c.llm.provider = "tpu"
    c.llm.tpu.model = "tiny"
    c.llm.tpu.mesh_shape = "1,1,2"
    c.llm.max_tokens = 8
    c.telemetry.enabled = False
    c.lifecycle.restart_backoff_s = 0.05    # three rebuilds follow
    srv = build_server(c, backend=seed_demo_cluster(FakeCluster()),
                       device="cpu", mesh_backend="gloo")
    srv.start()
    sup = srv.engine_supervisor()
    backend = srv.analysis.backend
    mesh = backend.mesh
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(3, 250, size=n)]
               for n in (5, 20, 40)]
    sp = tengine.SamplingParams(max_tokens=10, temperature=0.0)

    def query():
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/api/v1/query",
            data=json.dumps({"question": "why crashloop?"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())

    def submit():
        return [sup.submit(p, sp) for p in prompts]

    def ids(handles):
        out = [h.result(timeout=120) for h in handles]
        assert all(r.finish_reason != "error" for r in out), out
        return [list(r.token_ids) for r in out]

    try:
        assert query()[0] == 200
        metrics = _get(srv.port, "/metrics")
        assert 'k8s_llm_monitor_mesh_axes{axis="model"} 2' in metrics
        # The shares are finite on a mesh (0.0 until a decode profile), and
        # the all-reduce's rate was measured on the mesh.
        for gauge in ("decode_collective_share",
                      "decode_collective_hidden_share"):
            line = next(x for x in metrics.splitlines() if x.startswith(
                f"k8s_llm_monitor_engine_{gauge} "))
            assert 0.0 <= float(line.split()[-1]) <= 1.0, line
        assert backend.engine.collective_bus_gbs > 0.0
        stats = json.loads(_get(srv.port, "/api/v1/stats"))
        assert stats["engine"]["mesh"] == {
            "data": 1, "seq": 1, "model": 2, "backend": "gloo",
            "decode_graphs": False, "tp_overlap": False,
            "decode_path": "pallas", "prefill_path": "dense"}
        get_injector().arm("step_loop_crash", rate=1.0, times=1)
        deadline = 60
        t0 = time.monotonic()
        while sup.restarts < 1 and time.monotonic() - t0 < deadline:
            time.sleep(0.05)
        while sup.state != "serving" and time.monotonic() - t0 < deadline:
            time.sleep(0.05)
        assert sup.restarts == 1 and sup.state == "serving"
        assert backend.mesh is mesh
        assert query()[0] == 200

        want = ids(submit())
        get_injector().arm("decode_dispatch", rate=1.0, times=1)
        assert ids(submit()) == want
        assert sup.restarts == 2 and backend.mesh is not mesh
        assert "'decode' call failed after the workers were sent it" in (
            mesh.broken)
        assert not any(p.is_alive() for p in mesh._procs)
        with pytest.raises(tmesh.MeshBroken):
            mesh.check()
        second = backend.mesh
        handles = submit()
        second._procs[0].kill()
        assert ids(handles) == want
        assert sup.restarts == 3 and backend.mesh not in (mesh, second)
        assert "mesh rank 1" in second.broken
        assert backend.mesh.healthy()
    finally:
        get_injector().disarm("step_loop_crash")
        get_injector().disarm("decode_dispatch")
        live = backend.mesh
        sup.shutdown(grace_s=5.0)
        srv.stop()
        live.close()


# ---------------------------------------------------------------------------
# One mesh for the rest
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    m = tmesh.create_mesh(tmesh.MeshConfig(model=2), backend="gloo",
                          device="cpu")
    yield m
    m.close()


@pytest.mark.parametrize("preset", PRESETS)
def test_tp2_forward_slices_and_engine_match_jax(mesh, preset):
    """TP-2 ``forward_full`` logits against JAX TP-2 and the port's TP-1;
    the worker's parameters bit-equal to JAX's shard on device 1; greedy
    ids of mixed traffic with a constrained lane equal to JAX's TP-2
    engine, with tp_overlap on and off."""
    jcfg, tcfg = _cfgs(preset, vocab_size=300)
    params = jllama.init_params(jax.random.PRNGKey(4), jcfg)
    tree = _tree(params)
    model = params_from_jax(tree, tcfg, device="cpu", mesh=mesh)
    ref = params_from_jax(tree, tcfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, 300, size=(2, 12),
                                               dtype=np.int32)
    jm = _jmesh()
    want = np.asarray(jax.jit(lambda p, t: jllama.forward_full(p, jcfg, t))(
        jsharding.shard_params(params, jm), tokens))
    got = tllama.forward_full(model, torch.from_numpy(tokens)).numpy()
    one = tllama.forward_full(ref, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, one, **TOL)

    worker = mesh.worker_states()[0]
    full = dict(ref.named_parameters())
    specs = tsharding.param_partition_specs(ref)
    for name, t in worker.items():
        np.testing.assert_array_equal(
            t.numpy(), tsharding.shard_tensor(full[name], specs[name], 1,
                                              2).numpy())

    reqs = _requests(300, constrained=True)
    jids = _run(jengine.InferenceEngine(
        jcfg, params, jengine.EngineConfig(**ECFG, decode_path="gather",
                                           tp_overlap="off"),
        tokenizer=None, eos_id=TOK.eos_id, mesh=jm), jengine, reqs, True)
    assert len(jids["verdict"]) > 0
    for overlap in ("on", "off"):
        eng = tengine.InferenceEngine(
            tcfg, model, tengine.EngineConfig(**ECFG, tp_overlap=overlap),
            eos_id=TOK.eos_id)
        assert eng.tp_overlap == (overlap == "on")
        assert eng.decode_path == "pallas" and eng.mesh_axes()["model"] == 2
        assert _run(eng, tengine, reqs, True) == jids, overlap


def test_tp2_w8a8_partials_and_ids_match_jax(mesh):
    """W8A8 under TP: each rank's int32 partial of a row-parallel
    projection (the global amax, its slice of the contraction) equals
    JAX's ``row_parallel_partial`` on that shard, and the TP-2 engine's ids
    equal the JAX TP-2 engine's (int8 weights, int8 activations)."""
    jcfg, tcfg = _cfgs("tiny", vocab_size=300, act_quant=True)
    params = j_quantize(jllama.init_params(jax.random.PRNGKey(6),
                                           dataclasses.replace(
                                               jcfg, act_quant=False)))
    tree = _tree(params)
    full = params_from_jax(tree, tcfg, device="cpu")
    x = np.random.default_rng(1).standard_normal((3, 1, 64)).astype(
        np.float32)
    o = params["layers"][0]["o"]
    jm = _jmesh()
    from jax.sharding import PartitionSpec as P

    jparts = jmesh.shard_map_compat(
        lambda p, xx: jllama.row_parallel_partial(p, xx, True, "model")[0][
            None],
        mesh=jm, in_specs=({"kernel_q": P("model", None), "scale": P(None)},
                           P(None, None, "model")),
        out_specs=P("model"), check_replication=False)(o, x)
    amax = np.abs(x).max(axis=-1, keepdims=True)
    for r in range(2):
        stub = types.SimpleNamespace(
            rank=r, all_reduce=lambda a, op: torch.from_numpy(amax))
        lin = tllama.QuantLinear(32, 64, False, device="cpu",
                                 dtype=torch.float32)
        lin.weight_q.copy_(full.layers[0].o.weight_q[:, r * 32:(r + 1) * 32])
        lin.scale.copy_(full.layers[0].o.scale)
        part, _ = tllama.row_parallel_partial(
            lin, torch.from_numpy(x[..., r * 32:(r + 1) * 32]), True, stub)
        np.testing.assert_array_equal(part.numpy(), np.asarray(jparts[r]))

    model = params_from_jax(tree, tcfg, device="cpu", mesh=mesh)
    prompts = [[5, 6, 7, 8, 9, 10, 11], [9, 8, 7, 6, 5], [11, 12, 13]]
    jids = [r.token_ids for r in jengine.InferenceEngine(
        jcfg, params, jengine.EngineConfig(**ECFG, decode_path="gather"),
        eos_id=-1, mesh=jm).generate(prompts, jengine.SamplingParams(
            max_tokens=10))]
    for overlap in ("on", "off"):
        eng = tengine.InferenceEngine(
            tcfg, model, tengine.EngineConfig(**ECFG, tp_overlap=overlap),
            eos_id=-1)
        got = [r.token_ids for r in eng.generate(
            prompts, tengine.SamplingParams(max_tokens=10))]
        assert got == jids, overlap


def test_tp2_replicated_pages_and_int8_pool_match_jax(mesh):
    """One kv head at TP 2: the pages replicate (each rank's pool holds
    every head), decode and prefill take the gather and the ids equal
    JAX's TP-2 engine; an int8 KV pool under the mesh decodes on the
    gather/dequant as in JAX."""
    jcfg, tcfg = _cfgs("tiny", vocab_size=300, num_kv_heads=1)
    params = jllama.init_params(jax.random.PRNGKey(2), jcfg)
    model = params_from_jax(_tree(params), tcfg, device="cpu", mesh=mesh)
    assert model.kv_gather and model.n_kv_heads == 1
    prompts = [[5, 6, 7, 8, 9, 10, 11] * 3, [9, 8, 7, 6, 5]]
    jm = _jmesh()
    for kv in ("auto", "int8"):
        jids = [r.token_ids for r in jengine.InferenceEngine(
            jcfg, params, jengine.EngineConfig(**ECFG, kv_dtype=kv),
            eos_id=-1, mesh=jm).generate(prompts, jengine.SamplingParams(
                max_tokens=8))]
        eng = tengine.InferenceEngine(tcfg, model, tengine.EngineConfig(
            **ECFG, kv_dtype=kv), eos_id=-1)
        assert eng.decode_path == "gather" and not eng.tp_overlap
        assert eng.pages.k[0].shape[-1] == tcfg.head_dim_
        got = [r.token_ids for r in eng.generate(
            prompts, tengine.SamplingParams(max_tokens=8))]
        assert got == jids, kv


def test_engine_replay_guards_and_refusals(mesh):
    """A model or engine the workers no longer hold raises when used (a
    dispatch that raises fails its requests with the cause); the host
    tier and KVX1 blobs are served under a mesh; the pool is allocated at
    the rank's width."""
    _, tcfg = _cfgs("tiny")
    old = tllama.LlamaModel(tcfg, seed=1, mesh=mesh)
    new = tllama.LlamaModel(tcfg, seed=2, mesh=mesh)
    with pytest.raises(RuntimeError, match="another model"):
        tengine.InferenceEngine(tcfg, old, tengine.EngineConfig(**ECFG))
    first = tengine.InferenceEngine(tcfg, new, tengine.EngineConfig(**ECFG))
    assert first.pages.k[0].shape[-1] == tcfg.head_dim_       # 1 of 2 heads
    assert first.pool_bytes * 2 == first.kv_tier_stats()["device_bytes"]
    second = tengine.InferenceEngine(tcfg, new, tengine.EngineConfig(**ECFG))
    # The dispatch's rollback catches it: the request fails with the cause.
    res, = first.generate([[1, 2, 3]], tengine.SamplingParams(max_tokens=2))
    assert res.finish_reason == "error" and "another engine" in res.error
    assert [len(r.token_ids) for r in second.generate(
        [[1, 2, 3]], tengine.SamplingParams(max_tokens=3))] == [3]
    # KVX1 blobs and the host tier are served under a mesh (whole rows,
    # tests/test_torch_tp_checkpoint.py): with no prefix cache an export
    # is a miss, and an engine with a host tier builds and serves.
    assert second.export_prefix([1, 2, 3], tenant="default") is None
    tiered = tengine.InferenceEngine(tcfg, new, tengine.EngineConfig(
        **ECFG, host_spill_bytes=1 << 20))
    assert tiered.host_kv_tier is not None
    assert [len(r.token_ids) for r in tiered.generate(
        [[1, 2, 3]], tengine.SamplingParams(max_tokens=3))] == [3]
