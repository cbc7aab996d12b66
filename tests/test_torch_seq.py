"""Sequence-sharded prefill and the data axis on the port's mesh
(parallel/mesh.py's grid, models/llama.py's seq slices) against the JAX
package's engine on the same mesh shape, and the break of a rank under a
seq mesh.

The port's mesh is one process per rank over gloo (``backend="gloo"``); the
JAX reference is ``create_mesh(MeshConfig(data, seq, model))`` on the first
``data * seq * model`` of the 8 virtual CPU devices, as
tests/test_engine_stress.py:246 builds its seq mesh.  One process group
lives in a process at a time, so the module keeps one port mesh alive and
closes it before the next shape (``meshes``).  The config and prompts are
tests/test_sharding.py:74-95's: a 40-token prompt chunked in rounds of the
16 bucket and a 12-token one admitted densely; fp32, weights from
``convert.py:params_from_jax``.  The JAX engines decode on the gather path
(their CPU default under a mesh is the Pallas interpreter, same ids, about
7x slower; tests/test_torch_tp.py).  Logits at rtol/atol 2e-5, the JAX
package's TP tolerance (tests/test_sharding.py:57).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_llm_monitor_tpu.models import llama as jllama
from k8s_llm_monitor_tpu.models.config import ModelConfig as JConfig
from k8s_llm_monitor_tpu.parallel import mesh as jmesh
from k8s_llm_monitor_tpu.serving import engine as jengine
from k8s_llm_monitor_tpu_torch.convert import params_from_jax
from k8s_llm_monitor_tpu_torch.models import llama as tllama
from k8s_llm_monitor_tpu_torch.models.config import ModelConfig as TConfig
from k8s_llm_monitor_tpu_torch.parallel import mesh as tmesh
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
_CFG = dict(name="t", vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=8, num_kv_heads=8, dtype="float32",
            rope_theta=10_000.0)
JCFG, TCFG = JConfig(**_CFG), TConfig(**_CFG)
ECFG = dict(max_slots=2, num_blocks=32, block_size=8, max_blocks_per_seq=8,
            prefill_buckets=(16,))
MAX_TOKENS = 5


def _prompts():
    rng = np.random.default_rng(3)
    return [[int(t) for t in rng.integers(2, 500, size=40)],    # chunked
            [int(t) for t in rng.integers(2, 500, size=12)]]    # dense


@pytest.fixture(scope="module")
def params():
    return jllama.init_params(jax.random.PRNGKey(2), JCFG)


@pytest.fixture(scope="module")
def tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def slices():
    """Prefill rounds of 16 over 4 lanes whose last tokens lie in seq
    slice 0 and 1 of the first round and of the second, and JAX's
    unsharded logits of them."""
    lengths = np.asarray([5, 13, 20, 30], np.int32)
    tokens = np.random.default_rng(9).integers(
        2, 500, size=(4, 32)).astype(np.int32)
    params = jllama.init_params(jax.random.PRNGKey(2), JCFG)
    return tokens, lengths, _jax_prefill_logits(params, tokens, lengths, 16)


@pytest.fixture(scope="module")
def meshes():
    """``get("d,s,m")``: the port's gloo mesh of that shape, the one open
    mesh of the module (the previous shape's is closed first)."""
    live = {}

    def get(shape):
        if shape not in live:
            for m in live.values():
                m.close()
            live.clear()
            live[shape] = tmesh.create_mesh(tmesh.parse_mesh_shape(shape),
                                            backend="gloo", device="cpu")
        return live[shape]

    yield get
    for m in live.values():
        m.close()


def _jax_ids(params, shape, prompts, **ecfg):
    d, s, m = (int(x) for x in shape.split(","))
    mesh = jmesh.create_mesh(jmesh.MeshConfig(data=d, seq=s, model=m),
                             devices=jax.devices()[:d * s * m])
    eng = jengine.InferenceEngine(
        JCFG, params, jengine.EngineConfig(**ECFG, decode_path="gather",
                                           **ecfg),
        eos_id=-1, mesh=mesh)
    if s > 1:
        assert eng._tok_sharding is not None
    return [list(r.token_ids) for r in eng.generate(
        prompts, jengine.SamplingParams(max_tokens=MAX_TOKENS))]


def _port_ids(model, prompts, **ecfg):
    eng = tengine.InferenceEngine(TCFG, model,
                                  tengine.EngineConfig(**ECFG, **ecfg),
                                  eos_id=-1)
    return eng, [list(r.token_ids) for r in eng.generate(
        prompts, tengine.SamplingParams(max_tokens=MAX_TOKENS))]


def _jax_prefill_logits(params, tokens, lengths, bucket, bs=8):
    """JAX's unsharded ``prefill`` / ``prefill_chunk`` in rounds of
    ``bucket``: each lane's last-token logits (``llama.prefill_logits``'s
    rounds)."""
    B, T = tokens.shape
    nb = -(-T // bs)
    pages = jllama.init_kv_pages(JCFG, B * nb + 1, bs)
    tables = jnp.asarray(1 + np.arange(B * nb, dtype=np.int32).reshape(B, nb))
    out = None
    for start in range(0, T, bucket):
        n = np.clip(lengths - start, 0, bucket).astype(np.int32)
        chunk = jnp.asarray(tokens[:, start:start + bucket])
        if start == 0:
            logits, pages = jllama.prefill(params, JCFG, chunk,
                                           jnp.asarray(n), pages, tables)
            out = np.asarray(logits)
        else:
            logits, pages = jllama.prefill_chunk(
                params, JCFG, chunk, jnp.full((B,), start, jnp.int32),
                jnp.asarray(n), pages, tables)
            out = np.where((n > 0)[:, None], np.asarray(logits), out)
    return out


# ---------------------------------------------------------------------------
# The grid (no process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["1,2,1", "1,2,2", "2,1,2", "2,2,2"])
def test_grid_coords_and_groups_match_jax_device_array(shape):
    """Rank r sits where device r sits in JAX's ``(data, seq, model)``
    device array; a model group is a row of the model axis, a seq group a
    column of the seq axis (groups of one rank, or the whole world, left
    to the default group)."""
    d, s, m = (int(x) for x in shape.split(","))
    cfg = tmesh.parse_mesh_shape(shape)
    jm = jmesh.create_mesh(jmesh.MeshConfig(data=d, seq=s, model=m),
                           devices=jax.devices()[:cfg.size])
    ids = np.vectorize(lambda dev: dev.id)(jm.devices)
    for r in range(cfg.size):
        assert tuple(int(i) for i in np.argwhere(ids == r)[0]) == \
            cfg.coords(r)
    model_groups, seq_groups = cfg.groups()
    want_model = [list(ids[a, b, :]) for a in range(d) for b in range(s)]
    want_seq = [list(ids[a, :, c]) for a in range(d) for c in range(m)]
    n = cfg.size
    assert model_groups == [g for g in want_model if 1 < len(g) < n]
    assert seq_groups == [g for g in want_seq if 1 < len(g) < n]


def test_launch_pacer_polls_and_ends_on_a_broken_mesh(monkeypatch):
    """Over NCCL rank 0 is paced: each mark records an event and waits,
    by polling, for the device to pass the one before; a wait whose event
    never completes (a kernel queued behind a dead rank's collective)
    ends with ``MeshBroken`` as soon as the watcher marks the mesh
    broken, with no blocking CUDA call."""
    class Event:
        def __init__(self):
            self.done = False

        def record(self):
            pass

        def query(self):
            return self.done

        def synchronize(self):
            raise AssertionError("a paced wait must not block")

    made = []

    def event():
        made.append(Event())
        return made[-1]

    monkeypatch.setattr(torch.cuda, "Event", event)
    mesh = tmesh.Mesh(tmesh.MeshConfig(seq=2), 0, ["cpu", "cpu"], "nccl")
    assert mesh.is_leader and not mesh.paced      # paced on the card only
    gloo = tmesh.Mesh(tmesh.MeshConfig(model=2), 0, ["cpu", "cpu"], "gloo")
    assert not gloo.paced
    pacer = tmesh.LaunchPacer(mesh)
    pacer()                     # the first mark: nothing to wait for
    made[0].done = True
    pacer()                     # waits on mark 0, done
    assert pacer.last is made[1]
    threading.Timer(0.2, mesh.mark_broken, ("mesh rank 1 exited",)).start()
    t0 = time.monotonic()
    with pytest.raises(tmesh.MeshBroken, match="rank 1 exited"):
        pacer()                 # mark 1 never completes
    assert 0.15 < time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# Meshes (one at a time)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["1,2,1", "1,2,2"])
def test_seq_mesh_ids_and_slice_logits_match_jax(meshes, params, tree,
                                                 slices, shape):
    """fp32 greedy ids of the port's engine on a seq mesh equal the JAX
    engine's on the same mesh shape; each lane's last-token prefill logits
    (rounds of 16: a lane whose last token lies in seq slice 0, one in
    slice 1, one in a later chunk round's slice 0 and one in its slice 1)
    are JAX's unsharded prefill's within the TP tolerance, on the dense
    path and on the flash wrapper's plain version (whose ids, at 1,2,2,
    equal JAX's too)."""
    mesh = meshes(shape)
    assert (mesh.sp, mesh.size) == (2, 2 * mesh.tp)
    model = params_from_jax(tree, TCFG, mesh=mesh)
    assert model.sp == 2 and model.mesh is mesh
    prompts = _prompts()
    want = _jax_ids(params, shape, prompts)
    eng, got = _port_ids(model, prompts)
    assert eng.mesh_axes() == {"data": 1, "seq": 2, "model": mesh.tp}
    assert got == want
    tokens, lengths, ref = slices
    for path in ("auto", "flash"):
        out = tllama.prefill_logits(model, torch.from_numpy(tokens),
                                    torch.from_numpy(lengths), 16,
                                    prefill_path=path, block_size=8)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
    if mesh.tp > 1:
        _, flash = _port_ids(model, prompts, prefill_path="flash")
        assert flash == want


def test_seq_mesh_rejects_indivisible_buckets(meshes, params, tree):
    """A prefill bucket the seq degree does not divide raises at engine
    build, naming the seq axis, as the JAX engine does
    (tests/test_sharding.py:97); the mesh serves on after it."""
    mesh = meshes("1,2,2")
    model = params_from_jax(tree, TCFG, mesh=mesh)
    jm = jmesh.create_mesh(jmesh.MeshConfig(data=1, seq=2, model=2),
                           devices=jax.devices()[:4])
    bad = dict(ECFG, prefill_buckets=(15,))
    with pytest.raises(ValueError, match="seq"):
        jengine.InferenceEngine(JCFG, params, jengine.EngineConfig(**bad),
                                eos_id=-1, mesh=jm)
    with pytest.raises(ValueError, match="seq"):
        tengine.InferenceEngine(TCFG, model, tengine.EngineConfig(**bad),
                                eos_id=-1)
    assert mesh.healthy()
    _, ids = _port_ids(model, [[5, 6, 7]])
    assert len(ids[0]) == MAX_TOKENS


def test_killed_rank_under_seq_mesh_rebuilds(meshes, params, tree):
    """The gloo form of C3: rank 1 of a ``"1,2,2"`` mesh is killed with a
    chunked prompt's rounds in flight; the step raises ``MeshBroken``,
    ``abort`` leaves the default group and every sub-group, and a mesh of
    the same shape built anew serves the ids of the undisturbed run."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    mesh = meshes("1,2,2")
    model = params_from_jax(tree, TCFG, mesh=mesh)
    prompts = _prompts()
    _, want = _port_ids(model, prompts)
    # The default group, rank 0's model group and its seq group.
    assert len(c10d._world.pg_map) == 3
    eng = tengine.InferenceEngine(TCFG, model, tengine.EngineConfig(**ECFG),
                                  eos_id=-1)
    for i, p in enumerate(prompts):
        eng.submit(tengine.GenerationRequest(
            f"r{i}", list(p), tengine.SamplingParams(max_tokens=MAX_TOKENS)))
    eng.step()
    mesh._procs[0].kill()
    mesh._procs[0].join()
    with pytest.raises(tmesh.MeshBroken):
        for _ in range(50):
            eng.step()
    mesh.abort()
    assert not dist.is_initialized() and not c10d._world.pg_map
    new = tmesh.create_mesh(tmesh.parse_mesh_shape("1,2,2"),
                            backend="gloo", device="cpu")
    try:
        _, got = _port_ids(params_from_jax(tree, TCFG, mesh=new), prompts)
        assert got == want
    finally:
        new.close()


def test_data_replicas_ids_match_jax(meshes, params, tree):
    """``"2,1,2"``: two data replicas of a TP-2 group; the ids equal the
    JAX engine's at TP 2; rank 2 holds rank 0's shard, rank 3 rank
    1's."""
    mesh = meshes("2,1,2")
    model = params_from_jax(tree, TCFG, mesh=mesh)
    prompts = _prompts()
    want = _jax_ids(params, "1,1,2", prompts)
    _, got = _port_ids(model, prompts)
    assert got == want
    states = mesh.worker_states()
    mine = dict(model.named_parameters()) | dict(model.named_buffers())
    for name, t in states[1].items():           # rank 2: data 1, model 0
        np.testing.assert_array_equal(t.numpy(), mine[name].numpy())
    for name, t in states[2].items():           # rank 3: data 1, model 1
        np.testing.assert_array_equal(t.numpy(), states[0][name].numpy())
