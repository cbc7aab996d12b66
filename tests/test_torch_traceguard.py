"""The port's run-time engine guards (k8s_llm_monitor_tpu_torch/devtools/
traceguard.py) on the CPU, the counterparts of the JAX package's
traceguard tests: the kernels run as their plain versions, decode programs
run eagerly (no graphs off the card), and the sync-debug replays are the
card's (chip_smoke.py phase 14); here the static capture-hazard pass
stands in for them.
"""

from __future__ import annotations

import pytest
import torch

from k8s_llm_monitor_tpu_torch.devtools import graftcheck, traceguard


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The guard's engines are tiny: one intra-op thread runs them fastest,
    and many threads per worker crowd the other test workers out."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", traceguard.DEFAULT_PATHS)
def test_same_bucket_repeat_builds_nothing_and_buffers_stay_live(path):
    """The acceptance gate: warm every decode program (greedy, sampled,
    constrained; the K ladder; chunked admissions), rerun same-shaped
    requests with other content: no new program.  Then a pipeline reset,
    a preemption, a host-tier restore and a grammar swap leave every
    program's inputs on the engine's live tensors."""
    report = traceguard.check_path(path, device="cpu")
    assert report.warm_programs > 0             # the warm pass built some
    assert report.repeat_programs == 0, report.as_dict()
    assert report.repeat_captures == report.warm_captures == 0   # no card
    assert report.live == {"reset": True, "preemption": True,
                           "restore": True, "grammar_swap": True}
    if path == "quant":
        assert report.kv_quant == "int8"
    if path == "flash_prefill":
        assert report.prefill_path == "flash"
    if path in ("fused", "pallas"):
        assert report.decode_path == path
    assert report.ok


def test_a_new_decode_program_is_counted():
    """Control for the zero above: a decode call at a K the warm pass never
    ran builds a program, so the counter sees new work.  The port's
    prefill runs eagerly, so a prompt in the next bucket alone (the JAX
    package's control) builds nothing."""
    engine = traceguard.build_engine("gather", device="cpu")
    warm, _ = traceguard.count_new_programs(
        engine, lambda: traceguard._drive(engine, 12, greedy=True, tag=1))
    assert warm > 0
    bucket, _ = traceguard.count_new_programs(
        engine, lambda: traceguard._drive(engine, 20, greedy=True, tag=2))
    assert bucket == 0
    k4, _ = traceguard.count_new_programs(
        engine, lambda: traceguard._drive(engine, 20, greedy=True, tag=3,
                                          max_tokens=8))
    assert k4 == 1
    assert (4, "greedy", False, 0) in engine._programs


def test_a_rebound_buffer_is_caught():
    """Control for the live-buffer check: a program's inputs rebound after
    its first call (what a graph would replay on) are reported."""
    engine = traceguard.build_engine("gather", device="cpu")
    traceguard._drive(engine, 12, greedy=True, tag=1)
    assert traceguard.stale_programs(engine) == []
    engine._tok_state = engine._tok_state.clone()
    stale = traceguard.stale_programs(engine)
    assert stale and all(s.endswith("_tok_state") for s in stale)


def test_program_state_reports_bound_and_stale_programs():
    """What a mesh worker answers rank 0's ``programs`` request with: every
    program bound at its first call, none stale, and a rebound buffer
    reported."""
    engine = traceguard.build_engine("gather", device="cpu")
    assert traceguard.program_state(engine) == {
        "programs": 0, "bound": 0, "captures": 0, "stale": []}
    traceguard._drive(engine, 12, greedy=True, tag=1)
    state = traceguard.program_state(engine)
    assert state["programs"] > 0 and state["bound"] == state["programs"]
    assert state["stale"] == [] and state["captures"] == 0
    engine._dec_in = engine._dec_in.clone()
    state = traceguard.program_state(engine)
    assert len(state["stale"]) == state["programs"]
    assert all(s.endswith("_dec_in") for s in state["stale"])


def test_grammar_table_regrown_drops_the_constrained_programs():
    """A taller grammar gets a new table buffer; the constrained programs
    that read the old one are dropped with it, never left stale."""
    import numpy as np

    from k8s_llm_monitor_tpu_torch.diagnosis.grammar import TokenFSM

    engine = traceguard.build_engine("gather", device="cpu")
    traceguard._drive(engine, 12, greedy=False, tag=1, constrained=True)
    assert any(p.constrained for p in engine._programs.values())
    trans = np.full((5, 16), -1, dtype=np.int32)
    trans[0, :] = 0
    trans[1:, 3:11] = 2
    engine.set_grammar(TokenFSM.from_table(
        trans, start=1, accept=np.ones(5, bool), eos_id=-1))
    assert not any(p.constrained for p in engine._programs.values())
    assert traceguard.stale_programs(engine) == []
    new, _ = traceguard.count_new_programs(
        engine, lambda: traceguard._drive(engine, 12, greedy=False, tag=2,
                                          constrained=True))
    # the K ladder of a 4-token constrained request, built anew
    assert new == sum(p.constrained for p in engine._programs.values()) > 0


def test_sync_guard_is_a_no_op_off_the_card():
    engine = traceguard.build_engine("gather", device="cpu")
    with traceguard.SyncGuard(engine) as guard:
        traceguard._drive(engine, 12, greedy=True, tag=1)
    assert guard.replays == 0
    assert "_op_decode" not in vars(engine)


def test_the_graph_roots_have_no_capture_hazard():
    assert traceguard.capture_hazards() == []


def test_mesh_path_needs_a_mesh_model():
    with pytest.raises(ValueError, match="mesh"):
        traceguard.build_engine("mesh", device="cpu")


def test_mesh_path_binds_every_rank_programs():
    """The mesh path on a two-rank gloo mesh of the CPU: rank 0's report
    holds, and each worker's decode programs (its ``programs`` answer)
    are bound to its own engine's live tensors after the live-buffer
    events."""
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.parallel.mesh import (
        MeshConfig, create_mesh)

    mesh = create_mesh(MeshConfig(model=2), backend="gloo", device="cpu")
    try:
        model = llama.LlamaModel(traceguard._tiny_cfg(fused=False),
                                 device="cpu", seed=0, mesh=mesh)
        report = traceguard.check_path("mesh", device="cpu", model=model)
        assert report.ok, report.as_dict()
        assert report.decode_path == "pallas"
        (worker,) = mesh.request("programs")
    finally:
        mesh.close()
    assert worker["programs"] >= report.warm_programs
    assert worker["bound"] == worker["programs"]
    assert worker["stale"] == [] and worker["captures"] == 0


def test_report_and_cli_on_the_cpu(capsys):
    report = traceguard.run_traceguard(("gather", "spec"), device="cpu")
    assert report["ok"] and report["capture_hazards"] == []
    assert set(report["paths"]) == {"gather", "spec"}
    assert graftcheck.main(["--trace", "--device", "cpu", "--trace-paths",
                            "quant"]) == 0
    out = capsys.readouterr().out
    assert "graftcheck traceguard[quant]: ok (cpu:" in out


def test_the_trace_pass_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graftcheck.main(["--trace", "--trace-paths", "gather"])
