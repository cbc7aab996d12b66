"""A checkpoint served on a tensor-parallel mesh (utils/checkpoint.py and
utils/quantize.py under ``mesh=``, the host KV tier and KVX1 blobs of
serving/engine.py under a mesh, the decode collective shares,
cmd/preflight.py, and the mesh's close and watcher) against the JAX
package on the CPU.

A tiny Llama checkpoint is written by ``transformers.save_pretrained``
(float32 safetensors, index-sharded, with a word-level tokenizer).  The
port's mesh is two processes over gloo; the JAX reference is its TP-2
engine on two of the CPU's eight devices, decoding on the gather path.
``test_from_config_serves_checkpoint_on_mesh_and_rebuilds`` builds its own
mesh through ``from_config`` and runs first, before the module's ``mesh``
exists (one process group per process).  Tolerances: fp32 ids exact,
shard tensors and blob bytes bit for bit, fp32 page rows at rtol/atol
2e-5 (the TP tests').
"""

import dataclasses
import functools
import logging
import threading
import time

import jax
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.cmd import preflight as jpreflight
from k8s_llm_monitor_tpu.models import config as jconfig
from k8s_llm_monitor_tpu.parallel import mesh as jmesh
from k8s_llm_monitor_tpu.parallel import sharding as jsharding
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu.utils import checkpoint as jckpt
from k8s_llm_monitor_tpu.utils.quantize import quantize_params as j_quantize
from k8s_llm_monitor_tpu_torch.cmd import preflight as tpreflight
from k8s_llm_monitor_tpu_torch.models import config as tconfig
from k8s_llm_monitor_tpu_torch.monitor import analysis
from k8s_llm_monitor_tpu_torch.monitor.config import (
    LifecycleConfig, TPULLMConfig)
from k8s_llm_monitor_tpu_torch.parallel import mesh as tmesh
from k8s_llm_monitor_tpu_torch.resilience.faults import get_injector
from k8s_llm_monitor_tpu_torch.serving import engine as tengine
from k8s_llm_monitor_tpu_torch.utils import checkpoint as tckpt
from k8s_llm_monitor_tpu_torch.utils.quantize import quantize_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny engines run fastest on one intra-op thread, and many threads
    per test worker crowd the other workers out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-5, atol=2e-5)
T = tengine.DEFAULT_TENANT
ECFG = dict(max_slots=2, num_blocks=64, block_size=8, max_blocks_per_seq=16,
            prefill_buckets=(16,), decode_steps_per_iter=4)
PROMPT = [int(t) for t in np.random.default_rng(3).integers(3, 128, size=37)]
WORDS = "pod node event warning error restart oom dns web db api".split()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A float32 Llama (4 / 2 heads: one kv head per rank at TP 2) as
    index-sharded safetensors, beside a word-level tokenizer."""
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers

    path = tmp_path_factory.mktemp("tp_ckpt") / "llama"
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=5e5,
        tie_word_embeddings=False, bos_token_id=1, eos_token_id=2)).eval()
    torch.manual_seed(0)
    with torch.no_grad():
        for p in hf.parameters():
            p.copy_(torch.randn_like(p) * 0.05)
    hf.save_pretrained(path, max_shard_size="40KB", safe_serialization=True)
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for w in WORDS:
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
        eos_token="</s>").save_pretrained(path)
    return path


def _jmesh():
    return jmesh.create_mesh(jmesh.MeshConfig(model=2),
                             devices=jax.devices()[:2])


def _jax_engine(ckpt, **kw):
    cfg, tree = jckpt.load_hf_checkpoint(ckpt, dtype="float32")
    return jengine.InferenceEngine(
        cfg, tree, jengine.EngineConfig(**dict(ECFG, **kw),
                                        decode_path="gather"),
        eos_id=-1, mesh=_jmesh())


def _greedy(n):
    return tengine.SamplingParams(max_tokens=n, temperature=0.0)


# ---------------------------------------------------------------------------
# The front door: its own mesh, through from_config
# ---------------------------------------------------------------------------


def test_from_config_serves_checkpoint_on_mesh_and_rebuilds(ckpt,
                                                            monkeypatch):
    """``from_config`` with a checkpoint and ``mesh_shape "1,1,2"``: fp32
    greedy ids equal the JAX TP-2 engine's on the same checkpoint; a
    decode call failing after its send breaks the mesh, the factory loads
    the checkpoint's shards on a new one (not seed-0 weights), and the
    ids equal the undisturbed run's; the mesh closes in under 5 s."""
    loads = []

    def load(*args, **kw):
        loads.append(kw["mesh"])
        return tckpt.load_hf_checkpoint(*args, dtype="float32", **kw)

    monkeypatch.setattr(analysis, "load_hf_checkpoint", load)
    tc = TPULLMConfig(checkpoint=str(ckpt), mesh_shape="1,1,2", quantize="",
                      spec_k=0, kv_blocks=64, max_batch=2)
    backend = analysis.LocalEngineBackend.from_config(
        tc, lifecycle=LifecycleConfig(restart_backoff_s=0.05), device="cpu",
        mesh_backend="gloo")
    sup = backend.supervisor
    first = backend.mesh
    prompts = [PROMPT[:n] for n in (5, 20, 37)]

    def ids():
        out = [h.result(timeout=120) for h in
               [sup.submit(p, _greedy(8)) for p in prompts]]
        assert all(r.finish_reason != "error" for r in out), out
        return [list(r.token_ids) for r in out]

    try:
        assert backend.engine.mesh_axes()["model"] == 2
        assert backend.engine.model.cfg.dtype == "float32"
        want = ids()
        jeng = _jax_engine(ckpt)
        assert [r.token_ids for r in jeng.generate(
            prompts, jengine.SamplingParams(max_tokens=8))] == want
        get_injector().arm("decode_dispatch", rate=1.0, times=1)
        assert ids() == want
        assert sup.restarts == 1 and backend.mesh is not first
        assert first.broken is not None and len(loads) == 2
        assert loads[1] is backend.mesh
    finally:
        get_injector().disarm("decode_dispatch")
        live = backend.mesh
        sup.shutdown(grace_s=5.0)
        t0 = time.monotonic()
        live.close()
        closed_s = time.monotonic() - t0
    assert closed_s < 5.0 and not any(p.is_alive() for p in live._procs)


# ---------------------------------------------------------------------------
# One mesh for the rest
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    m = tmesh.create_mesh(tmesh.MeshConfig(model=2), backend="gloo",
                          device="cpu")
    yield m
    m.close()


def _jax_slice(tree, specs, name, rank):
    """The JAX leaf of port parameter ``name`` sliced to ``rank``'s
    contiguous chunk by JAX's spec, in the port's [out, in] layout."""
    parts = name.split(".")
    node, spec = tree, specs
    if parts[0] == "layers":
        node, spec = tree["layers"][int(parts[1])], specs["layers"][
            int(parts[1])]
        parts = parts[2:]
    if len(parts) == 1:
        leaf, js = node[parts[0]], spec[parts[0]]
    else:
        key = {"weight": "kernel", "weight_q": "kernel_q"}.get(parts[-1],
                                                               parts[-1])
        if parts[0] == "embed":
            key = parts[-1]
        leaf, js = node[parts[0]][key], spec[parts[0]][key]
    arr = np.asarray(leaf)
    for dim, ax in enumerate(js):
        if ax == "model":
            c = arr.shape[dim] // 2
            arr = np.take(arr, range(rank * c, (rank + 1) * c), axis=dim)
    transpose = arr.ndim == 2 and parts[0] != "embed"
    return arr.T if transpose else arr


@pytest.mark.parametrize("mode", ["bf16", "int8", "w8a8"])
def test_shards_equal_jax_loader_sliced(ckpt, mesh, mode):
    """Each rank's loaded tensors equal the JAX loader's tree sliced by
    JAX's ``param_partition_specs``, bit for bit (int8 codes and scales;
    a row-parallel scale spans both ranks' columns); W8A8 loads the int8
    shard with int8 activations; ``quantize_params`` of a bf16 shard
    equals JAX's ``quantize_params`` of the full tree, sliced."""
    quantize = mode != "bf16"
    jcfg, tree = jckpt.load_hf_checkpoint(ckpt, quantize=quantize)
    specs = jsharding.param_partition_specs(tree)
    cfg, model = tckpt.load_hf_checkpoint(ckpt, quantize=quantize,
                                          device="cpu", mesh=mesh,
                                          act_quant=mode == "w8a8")
    assert cfg.act_quant == (mode == "w8a8") and model.tp == 2
    if mode == "bf16":
        model = quantize_params(model)
        tree = j_quantize(tree)
        specs = jsharding.param_partition_specs(tree)
    ranks = [dict(model.named_parameters()) | dict(model.named_buffers())]
    ranks += mesh.worker_states()
    assert ranks[0].keys() == ranks[1].keys()
    for rank, state in enumerate(ranks):
        for name, t in state.items():
            want = _jax_slice(tree, specs, name, rank)
            got = t.float().numpy() if t.dtype == torch.bfloat16 else \
                t.numpy()
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=f"{name} rank {rank}")
    assert ranks[1]["layers.0.o.weight_q"].shape == (64, 32)
    assert ranks[1]["layers.0.o.scale"].shape == (64,)


@pytest.fixture(scope="module")
def f32(ckpt, mesh):
    """The checkpoint in float32 at TP 2 (on the mesh) and at TP 1."""
    tp2 = tckpt.load_hf_checkpoint(ckpt, dtype="float32", device="cpu",
                                   mesh=mesh)[1]
    tp1 = tckpt.load_hf_checkpoint(ckpt, dtype="float32", device="cpu")[1]
    return tp2, tp1


def _engine(model, **kw):
    return tengine.InferenceEngine(model.cfg, model, tengine.EngineConfig(
        **dict(ECFG, **kw)), eos_id=-1, device=model.device)


def _cached_rows(eng, prompt):
    shared, _ = eng.prefix_cache.lookup(prompt, tenant=tengine.DEFAULT_TENANT)
    try:
        return list(shared), eng._fetch_rows(shared)
    finally:
        eng.allocator.free(shared)


def test_host_tier_rows_match_jax_and_round_trip(ckpt, f32):
    """Under the mesh a spill holds whole rows: ``_fetch_rows`` of the
    prompt's cached blocks equals JAX's TP-2 ``_fetch_rows`` (fp32 rows at
    the TP tolerance, same shapes and dtypes), JAX's rows written into the
    TP-2 pool read back bit for bit, a spill and a restore give the
    device hit's ids, and the tier counts TP 1's bytes."""
    tp2, tp1 = f32
    jeng = _jax_engine(ckpt)
    jids = [r.token_ids for r in jeng.generate(
        [PROMPT], jengine.SamplingParams(max_tokens=6))]
    jshared, _ = jeng.prefix_cache.lookup(PROMPT, tenant=tengine.DEFAULT_TENANT)
    jrows = jeng._fetch_rows(jshared)
    eng = _engine(tp2, host_spill_bytes=1 << 24)
    assert [r.token_ids for r in eng.generate([PROMPT], _greedy(6))] == jids
    shared, rows = _cached_rows(eng, PROMPT)
    assert rows.n_blocks == jrows.n_blocks == len(shared) == 4
    for got, want in zip(rows.layers, jrows.layers, strict=True):
        for g, w in zip(got, want, strict=True):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, **TOL)
    eng._write_rows(shared, jrows.layers)
    again = eng._fetch_rows(shared)
    for got, want in zip(again.layers, jrows.layers, strict=True):
        for g, w in zip(got, want, strict=True):
            assert g.tobytes() == np.asarray(w).tobytes()
    hit = [r.token_ids for r in eng.generate([PROMPT], _greedy(6))]
    while eng._evict_prefix_lru():
        pass
    spilled = eng.kv_tier_stats()
    assert spilled["spills"] > 0
    assert [r.token_ids for r in eng.generate([PROMPT], _greedy(6))] == hit
    assert eng.kv_tier_stats()["restores"] == 1
    one = _engine(tp1, host_spill_bytes=1 << 24)
    one.generate([PROMPT], _greedy(6))
    while one._evict_prefix_lru():
        pass
    want = one.kv_tier_stats()
    assert (spilled["host_bytes"], spilled["spills"]) == (
        want["host_bytes"], want["spills"])


def test_kvx1_blob_matches_jax_and_moves_across_tp(ckpt, f32):
    """KVX1 under the mesh keeps JAX's layout (every kv head in each
    leaf): JAX's TP-2 blob installed on the port's TP-2 engine exports
    again byte for byte; a TP-2 blob installs on TP 1 and a TP-1 blob on
    TP 2, each exporting the same bytes and giving the same hit ids."""
    tp2, tp1 = f32
    jeng = _jax_engine(ckpt)
    jeng.generate([PROMPT], jengine.SamplingParams(max_tokens=2))
    jblob = jeng.export_prefix(PROMPT, tenant=T)
    two = _engine(tp2)
    assert two.install_prefix(jblob, expected_tenant=T) == "installed"
    assert two.export_prefix(PROMPT, tenant=T) == jblob
    one = _engine(tp1)
    assert one.install_prefix(jblob, expected_tenant=T) == "installed"
    assert one.export_prefix(PROMPT, tenant=T) == jblob
    want = [r.token_ids for r in one.generate([PROMPT], _greedy(6))]
    assert [r.token_ids for r in two.generate([PROMPT], _greedy(6))] == want
    # A prefill's own blob, each way.
    one = _engine(tp1)
    one.generate([PROMPT], _greedy(2))
    blob1 = one.export_prefix(PROMPT, tenant=T)
    two = _engine(tp2)
    assert two.install_prefix(blob1, expected_tenant=T) == "installed"
    assert two.export_prefix(PROMPT, tenant=T) == blob1
    fresh = _engine(tp2)
    fresh.generate([PROMPT], _greedy(2))
    blob2 = fresh.export_prefix(PROMPT, tenant=T)
    one = _engine(tp1)
    assert one.install_prefix(blob2, expected_tenant=T) == "installed"
    assert one.export_prefix(PROMPT, tenant=T) == blob2


def test_collective_shares_match_jax_byte_model(ckpt, f32, monkeypatch):
    """The wire time and the share equal JAX's byte model at the same
    rate; on the mesh the rate is measured (``Mesh.bus_gbs``), a decode
    profile fills the share in [0, 1], nothing counts as hidden (the
    collectives block the stream), and off a mesh both read 0."""
    tp2, tp1 = f32
    eng = _engine(tp2)
    assert eng.collective_bus_gbs > 0.0
    assert eng.decode_collective_share == 0.0
    jeng = _jax_engine(ckpt)
    monkeypatch.setattr(jmesh, "ici_bandwidth_gbs", lambda kind: 37.5)
    eng.collective_bus_gbs = 37.5
    assert eng._ring_wire_ms() == pytest.approx(jeng._ring_ici_ms(),
                                                rel=1e-12)
    for step_ms in (1e-4, 0.5, 40.0):
        assert eng._estimate_collective_share(step_ms) == pytest.approx(
            jeng._estimate_collective_share(step_ms), rel=1e-12)
    eng.collective_bus_gbs = tp2.mesh.bus_gbs(eng._collective_payload())
    phases = eng.profile_decode_phases(reps=1)
    share = phases["decode_collective_share"]
    assert np.isfinite(share) and 0.0 < share <= 1.0
    assert eng.decode_collective_hidden_share == 0.0
    off = _engine(tp1)
    assert off._ring_wire_ms() == 0.0
    assert off.profile_decode_phases(reps=1)[
        "decode_collective_share"] == 0.0


# ---------------------------------------------------------------------------
# The preflight (no process)
# ---------------------------------------------------------------------------

_JAX_SHAPES: dict = {}


def _cached_eval_shape(fn):
    """``jax.eval_shape`` memoized on the closure, W8A8 on int8's shapes
    (the JAX preflight traces the same config's init once per call; the
    port's ``weight_bytes`` is memoized alike)."""
    key = (fn.__code__, tuple(
        dataclasses.replace(c.cell_contents, act_quant=False)
        if isinstance(c.cell_contents, jconfig.ModelConfig)
        else c.cell_contents for c in fn.__closure__ or ()))
    if key not in _JAX_SHAPES:
        _JAX_SHAPES[key] = _EVAL_SHAPE(fn)
    return _JAX_SHAPES[key]


_EVAL_SHAPE = jax.eval_shape
_WEIGHT_BYTES = tpreflight.weight_bytes


def _quiet(fn, argv):
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(argv)


@pytest.mark.parametrize("preset", ["tiny", "tiny-qwen", "llama-1b",
                                    "llama3-8b", "qwen2-72b"])
def test_preflight_matches_jax(preset, monkeypatch):
    """Exit code, FAILs and WARNs equal JAX's ``check()`` over quantize x
    mesh x per-card memory (and none: the CPU's kind, unknown), the
    host's device count made JAX's."""
    monkeypatch.setattr(jax, "eval_shape", _cached_eval_shape)
    monkeypatch.setattr(tpreflight, "weight_bytes", functools.cache(
        lambda cfg, quantized, model: _WEIGHT_BYTES(cfg, quantized, model)))
    monkeypatch.setattr(tpreflight, "_devices",
                        lambda: (len(jax.devices()), "cpu"))
    for quant in ("none", "int8", "w8a8"):
        for tp in (1, 2, 4, 8, 3):
            for hbm in ("80", "16", None):
                argv = ["--model", preset, "--quantize", quant, "--mesh",
                        f"1,1,{tp}", "--kv-blocks", "2048"]
                if hbm:
                    argv += ["--per-chip-hbm-gib", hbm]
                assert _quiet(tpreflight.check, argv) == _quiet(
                    jpreflight.check, argv), argv


def test_preflight_experts_join_the_divisibility_list():
    """Deliberate difference (a): an expert axis that TP does not divide
    fails the port's mesh check; JAX's passes it."""
    jcfg = dataclasses.replace(jconfig.PRESETS["tiny-moe"], num_experts=6)
    r = jpreflight._Report()
    tpreflight.check_mesh(r, jcfg, 1, 1, 4, 4)
    assert r.fail_msgs == ["num_experts=6 not divisible by model=4"]
    r = jpreflight._Report()
    tpreflight.check_mesh(r, jcfg, 1, 1, 2, 2)
    assert r.fail_msgs == []
    jcfg = dataclasses.replace(jcfg, name="moe6")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jconfig.PRESETS, "moe6", jcfg)
        rc, fails, _ = _quiet(jpreflight.check, [
            "--model", "moe6", "--quantize", "none", "--mesh", "1,1,4"])
    assert rc == 0 and not any("num_experts" in f for f in fails)


def test_preflight_tree_bytes_zip_strict():
    """Deliberate difference (b): tensors and specs of other lengths
    raise, where JAX's zip stops at the shorter."""
    t = torch.empty((4, 4), device="meta")
    assert tpreflight._tree_bytes([t, t], [("model", None), (None,)], 2) == (
        128, 96)
    with pytest.raises(ValueError):
        tpreflight._tree_bytes([t, t], [("model", None)], 2)


def test_boot_preflight_workload_from_engine_config(monkeypatch, caplog):
    """Deliberate difference (c): ``from_config``'s boot preflight sizes
    its workload from the engine's ``max_blocks_per_seq * block_size``
    (JAX hard-codes 768 + 256) and logs a FAIL as a warning; boot goes
    on."""
    seen = []

    def check(argv):
        seen.append(argv)
        return 1, ["too big"], ["a warning"]

    monkeypatch.setattr(tpreflight, "check", check)
    monkeypatch.setattr(analysis, "EngineConfig", functools.partial(
        tengine.EngineConfig, max_blocks_per_seq=24, block_size=8))
    tc = TPULLMConfig(model="tiny", quantize="", spec_k=0, kv_blocks=64,
                      max_batch=2)
    with caplog.at_level(logging.INFO, logger="monitor.analysis"):
        backend = analysis.LocalEngineBackend.from_config(tc, device="cpu")
    try:
        argv = seen[0]
        flag = dict(zip(argv[::2], argv[1::2]))
        assert (flag["--prompt-len"], flag["--max-tokens"],
                flag["--block-size"]) == ("192", "0", "8")
        assert flag["--model"] == "tiny" and flag["--quantize"] == "none"
        assert backend.engine.ecfg.max_blocks_per_seq == 24
        assert any("preflight FAILED" in r.message and "too big" in
                   r.message and r.levelno == logging.WARNING
                   for r in caplog.records)
    finally:
        backend.supervisor.shutdown(grace_s=1.0)


# ---------------------------------------------------------------------------
# The mesh's close (C1) and watcher (C3), with fakes
# ---------------------------------------------------------------------------


class _FakeConn:
    def __init__(self, log):
        self.log, self.inbox = log, []

    def send(self, msg):
        self.log.append(("send", msg[0]))
        if msg[0] == "ping":
            self.inbox.append(("ok", 1))

    def poll(self, timeout=None):
        return bool(self.inbox)

    def recv(self):
        return self.inbox.pop(0)


class _FakeProc:
    def __init__(self, log):
        self.log = log

    def join(self, timeout=None):
        self.log.append(("join",))

    def is_alive(self):
        return False


def test_close_joins_workers_before_leaving_the_group(monkeypatch):
    """C1: the close pings, sends "close", joins every worker (each exits
    without leaving the group: test_a_closed_worker_exits_at_once) and only
    then leaves the group on rank 0."""
    monkeypatch.setattr(tmesh.Mesh, "_watch", lambda self: None)
    log = []
    mesh = tmesh.Mesh(tmesh.MeshConfig(model=3), 0, ["cpu"] * 3, "gloo",
                      conns=[_FakeConn(log), _FakeConn(log)],
                      procs=[_FakeProc(log), _FakeProc(log)])
    monkeypatch.setattr(mesh, "_abort_group",
                        lambda: log.append(("abort",)))
    mesh.close()
    assert log == [("send", "ping"), ("send", "ping"), ("send", "close"),
                   ("send", "close"), ("join",), ("join",), ("abort",)]


def test_a_closed_worker_exits_at_once(monkeypatch):
    """C1 over NCCL: a worker told to close exits at once, without an abort
    of the group of its own, which waits for its peers' (a TP-4 mesh's
    close waited out each worker's 30 s join on four H100s); rank 0 leaves
    the group after the joins, its peers gone."""
    calls = []

    class Exited(Exception):
        pass

    def exit_(code):
        calls.append(("exit", code))
        raise Exited

    monkeypatch.setattr(tmesh, "_init_group", lambda *a: None)
    monkeypatch.setattr(tmesh.torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(tmesh.os, "_exit", exit_)
    monkeypatch.setattr(tmesh.Mesh, "_abort_group",
                        lambda self: calls.append(("abort",)))
    conn = _FakeConn([])
    conn.inbox.append(("close",))
    with pytest.raises(Exited):
        tmesh._worker_main(tmesh.MeshConfig(model=2), 1, ["cpu", "cpu"],
                           "gloo", "tcp://127.0.0.1:1", conn)
    assert calls == [("exit", 0)]


def test_watcher_aborts_only_after_the_launch(monkeypatch):
    """C3: a worker's exit breaks the mesh at once, but over NCCL the
    group is aborted only once the call that is launching returns (or,
    held past ``LAUNCH_WAIT_S`` behind the dead rank, under it); that call
    then raises ``MeshBroken``, and no call launches after the break.  A
    call that holds the mesh without launching does not hold the abort
    back."""
    events = []
    mesh = tmesh.Mesh(tmesh.MeshConfig(model=2), 0, ["cpu"] * 2, "nccl")
    monkeypatch.setattr(mesh, "_abort_group",
                        lambda: events.append("abort"))
    inside, release = threading.Event(), threading.Event()
    raised = []

    def call(m):
        try:
            with m.launching():
                inside.set()
                release.wait(10)
                events.append("launched")
        except tmesh.MeshBroken as exc:
            raised.append(str(exc))

    caller = threading.Thread(target=call, args=(mesh,))
    caller.start()
    assert inside.wait(10)
    watcher = threading.Thread(target=mesh._worker_exited, args=(1, -9))
    watcher.start()
    deadline = time.monotonic() + 10
    while mesh.broken is None and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    assert mesh.broken == "mesh rank 1 exited (code -9)" and events == []
    release.set()
    caller.join(10)
    watcher.join(10)
    assert events == ["launched", "abort"]
    assert raised == ["mesh rank 1 exited (code -9)"]
    with pytest.raises(tmesh.MeshBroken):
        with mesh.launching():
            events.append("launched after the break")
    assert events == ["launched", "abort"]
    # A launch that does not return in LAUNCH_WAIT_S is held behind the
    # dead rank: the group is aborted under it, and it raises on return.
    stuck = tmesh.Mesh(tmesh.MeshConfig(model=2), 0, ["cpu"] * 2, "nccl")
    stuck.LAUNCH_WAIT_S = 0.2
    monkeypatch.setattr(stuck, "_abort_group",
                        lambda: events.append("abort under the launch"))
    inside.clear()
    release.clear()
    raised.clear()
    caller = threading.Thread(target=call, args=(stuck,))
    caller.start()
    assert inside.wait(10)
    stuck._worker_exited(1, -9)
    assert events[-1] == "abort under the launch"
    release.set()
    caller.join(10)
    assert events[-1] == "launched" and raised == [
        "mesh rank 1 exited (code -9)"]
    # Holding the calls lock alone (a request to the workers) is no launch.
    held = tmesh.Mesh(tmesh.MeshConfig(model=2), 0, ["cpu"] * 2, "nccl")
    monkeypatch.setattr(held, "_abort_group",
                        lambda: events.append("abort 2"))
    with held._calls:
        t = threading.Thread(target=held._worker_exited, args=(1, 1))
        t.start()
        t.join(10)
        assert events[-1] == "abort 2"
    # gloo's collectives raise by themselves: no abort.
    gloo = tmesh.Mesh(tmesh.MeshConfig(model=2), 0, ["cpu"] * 2, "gloo")
    monkeypatch.setattr(gloo, "_abort_group",
                        lambda: events.append("abort 3"))
    gloo._worker_exited(1, 1)
    assert gloo.broken and events[-1] == "abort 2"



def test_an_abort_that_does_not_return_marks_the_process_unusable(
        monkeypatch):
    """C4: leaving the process group may hang (over NCCL, the close of a
    mesh built after two breaks).  The abort is waited for at most
    ``ABORT_WAIT_S``; then the close and the watcher return instead of
    raising, the process is marked unusable, and a later ``create_mesh``
    raises ``MeshUnusable`` at once (it spawns no rank), so a supervisor's
    rebuild ends and the process's restart policy replaces it."""
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d

    release = threading.Event()
    aborts = []

    def blocked_abort(group=None):
        aborts.append(threading.current_thread().name)
        release.wait(30)

    monkeypatch.setattr(tmesh, "_STUCK", None)
    monkeypatch.setattr(tmesh.Mesh, "_watch", lambda self: None)
    monkeypatch.setattr(tmesh.Mesh, "ABORT_WAIT_S", 0.2)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(c10d, "_abort_process_group", blocked_abort)
    spawned = []
    monkeypatch.setattr(tmesh, "_init_group",
                        lambda *a: spawned.append(a) or (None, None))
    try:
        log = []
        mesh = tmesh.Mesh(tmesh.MeshConfig(seq=2, model=2), 0, ["cpu"] * 4,
                          "gloo", conns=[_FakeConn(log) for _ in range(3)],
                          procs=[_FakeProc(log) for _ in range(3)])
        assert tmesh.unusable() is None
        t0 = time.monotonic()
        mesh.close()                    # returns: no raise into the caller
        assert time.monotonic() - t0 < 10 and mesh.closed
        assert aborts == ["mesh-abort"] and log[-1] == ("join",)
        assert tmesh.unusable() == ("leaving the process group took more "
                                    "than 0 s (rank 0)")
        with pytest.raises(tmesh.MeshUnusable, match="restart it"):
            tmesh.create_mesh(tmesh.MeshConfig(seq=2, model=2),
                              device="cpu", backend="gloo")
        assert spawned == []
        # The watcher's path over NCCL returns too, the mesh broken.
        nccl = tmesh.Mesh(tmesh.MeshConfig(model=2), 0, ["cpu"] * 2, "nccl")
        nccl.LAUNCH_WAIT_S = 0.0
        nccl._worker_exited(1, -9)
        assert nccl.broken == "mesh rank 1 exited (code -9)"
        assert aborts == ["mesh-abort"] * 2
        # A mesh of one rank has no process group: it is still built.
        assert tmesh.create_mesh(device="cpu", backend="gloo").size == 1
    finally:
        release.set()


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_launch_watch_under_lockcheck(monkeypatch, backend):
    """With ``K8SLLM_LOCKCHECK=1`` the mesh's locks are instrumented: a
    launch still notifies the watcher, and the watcher still waits for it
    and re-enters the launch lock through ``_abort_group``."""
    monkeypatch.setenv("K8SLLM_LOCKCHECK", "1")
    mesh = tmesh.Mesh(tmesh.MeshConfig(model=2), 0, ["cpu"] * 2, backend)
    inside, release = threading.Event(), threading.Event()
    raised = []

    def call():
        try:
            with mesh._calls, mesh.launching():
                inside.set()
                release.wait(10)
        except tmesh.MeshBroken as exc:
            raised.append(str(exc))

    with mesh.launching():
        pass
    caller = threading.Thread(target=call)
    caller.start()
    assert inside.wait(10)
    watcher = threading.Thread(target=mesh._worker_exited, args=(1, -9))
    watcher.start()
    release.set()
    caller.join(10)
    watcher.join(10)
    assert not caller.is_alive() and not watcher.is_alive()
    assert raised == ["mesh rank 1 exited (code -9)"]
    mesh._abort_group()
    with pytest.raises(tmesh.MeshBroken):
        with mesh.launching():
            pass
