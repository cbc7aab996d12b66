"""Run-time guards over the serving engine's decode programs.

The JAX package's traceguard counts jit compiles; the port's counterpart
of a compiled program is a decode program (``serving/engine.py:
_DecodeProgram`` / ``_SpecProgram``, one per (K, sampler, constrained,
top-k cap) or spec key), captured into a CUDA graph at its first call on
the card.  Three guarantees, asserted by *running* the engine on a tiny
model (or, on the card, the model the caller hands in):

  1. **Stability** — after a warm pass, a same-bucket repeat with other
     content adds no entry to ``InferenceEngine._programs`` and, on the
     card with ``decode_graphs``, captures no graph (``graph_captures``).
     A capture costs a warm-up run and the capture itself on the decode
     path; this turns a silent recapture into a red gate.  The prefill
     runs eagerly: a prompt in another bucket has nothing to compile, so
     the control (:func:`count_new_programs` seeing new work at all) is a
     decode call at a K the warm pass never ran.
  2. **No host sync inside a captured program** — on the card every
     replay (the decode op: its inputs copied in from the pinned stage,
     then the graph) runs under ``torch.cuda.set_sync_debug_mode("error")``,
     so a device->host sync there raises.  That covers the copy-in and the
     replay only: a sync inside ``_run`` already fails its capture, and
     the eager work (the warm-up run before a capture, prefill rounds,
     decode with ``decode_graphs`` off, a gloo mesh's host-staged
     programs) runs unguarded.  The static ``capture-hazard`` pass
     (devtools/dataflow.py) runs over the graph roots on the CPU and the
     card.
  3. **Live buffers** — the counterpart of JAX's donated-buffer rebinding:
     a graph replays on the addresses it was captured on, so after a
     pipeline reset, a preemption, a host-tier restore and a grammar swap
     every program's captured inputs (``_DecodeProgram.bound``) must be
     the engine's live tensors (``InferenceEngine.live_buffers``: pages,
     ``_dec_in``, ``_tok_state``, ``_fsm_state``, the grammar table, the
     spec history), compared by ``data_ptr``.

The report is machine-readable (dict / JSON) and consumed by
tests/test_torch_traceguard.py, ``chip_smoke.py``'s phase 14 and the
graftcheck CLI (``--trace``).  ``device`` defaults to ``cuda`` and raises
without a card; on the CPU the kernels run as their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

#: The engine paths the guard runs by default, the counterparts of the JAX
#: package's: "gather" (the numerics oracle's decode), "fused" (B2), "quant"
#: (an int8 pool: B4 on the card), "flash_prefill" (B1 for every prefill,
#: chunk and verify), "grammar_swap" (the gather engine with a same-shape
#: ``set_grammar`` swap between and inside the passes: a swap is a copy
#: into the grammar buffer, never a new program), and two of the port's
#: own: "pallas" (the split decode path, B3) and "spec" (the speculative
#: ``_SpecProgram``, prefill dense, so on the card it verifies through B3
#: at QS = k + 1).  "mesh" (the JAX package's "mesh") takes a model built
#: on a mesh of two or more ranks, which its caller builds (a process per
#: rank): ``chip_smoke.py`` on the card, one CPU test on two gloo ranks.
DEFAULT_PATHS = ("gather", "fused", "quant", "flash_prefill", "grammar_swap",
                 "pallas", "spec")

#: What every decode program reads in place; constrained programs also read
#: the FSM state and table, spec programs the history.
_READS = ("pages", "_dec_in", "_tok_state")


def _tiny_cfg(fused: bool):
    """The JAX package's guard configs (float32): one narrow (head_dim 8),
    one at head_dim 64 for the fused path."""
    from k8s_llm_monitor_tpu_torch.models.config import ModelConfig

    if fused:
        return ModelConfig(name="tg-fused", vocab_size=128, hidden_size=256,
                           intermediate_size=256, num_layers=1, num_heads=4,
                           num_kv_heads=2, dtype="float32",
                           rope_theta=10_000.0)
    return ModelConfig(name="tg", vocab_size=256, hidden_size=32,
                       intermediate_size=64, num_layers=2, num_heads=4,
                       num_kv_heads=2, dtype="float32", rope_theta=10_000.0)


def _toy_fsm(variant: int = 0):
    """A hand-built 2-state cycling grammar over a 16-token vocab: states 1
    and 2 allow tokens 3..10 and alternate forever (constrained drives end
    by budget).  ``variant=1`` allows a shifted window (5..12) in the same
    table shape: the grammar_swap path installs it mid-run."""
    import numpy as np

    from k8s_llm_monitor_tpu_torch.diagnosis.grammar import TokenFSM

    lo, hi = (5, 13) if variant else (3, 11)
    trans = np.full((3, 16), -1, dtype=np.int32)
    trans[0, :] = 0
    trans[1, lo:hi] = 2
    trans[2, lo:hi] = 1
    return TokenFSM.from_table(trans, start=1,
                               accept=np.array([False, True, True]),
                               eos_id=-1)


def build_engine(path: str = "gather", device: Any = "cuda", seed: int = 0,
                 model=None, block_size: int = 8):
    """A tiny engine for ``path``: prefix cache and a host KV tier on (the
    restore check needs both; the guard's prompts never share a prefix),
    two buckets, a toy grammar installed so the constrained programs join
    the gated set.  ``model`` (any ``LlamaModel`` on ``device``) replaces
    the tiny float32 model: ``chip_smoke.py`` hands in Llama-3-8B's
    width in bf16, which the kernels take."""
    from k8s_llm_monitor_tpu_torch.models import llama
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine)

    device = llama.resolve_device(device)
    over: dict = {}
    if path == "fused":
        over["decode_path"] = "fused"
    elif path == "quant":
        over["kv_dtype"] = "int8"
    elif path == "flash_prefill":
        over["prefill_path"] = "flash"
    elif path == "pallas":
        over["decode_path"] = "pallas"
    elif path == "spec":
        over.update(spec_k=4, spec_min_accept=0.0, prefill_path="dense")
    elif path in ("gather", "grammar_swap"):
        over["decode_path"] = "gather"
    elif path == "mesh":
        if getattr(model, "mesh", None) is None:
            raise ValueError("the mesh path takes a model built on a mesh "
                             "of two or more ranks")
    else:
        raise ValueError(f"unknown traceguard path {path!r} "
                         f"(one of {DEFAULT_PATHS + ('mesh',)})")
    if model is None:
        model = llama.LlamaModel(_tiny_cfg(fused=path == "fused"),
                                 device=device, seed=seed)
    ec = EngineConfig(
        max_slots=4, num_blocks=64, block_size=block_size,
        max_blocks_per_seq=8, prefill_buckets=(16, 32),
        max_prefills_per_step=2, max_admission_rounds=2,
        decode_steps_per_iter=4, max_inflight=2, sample_topk_cap=8,
        prefix_cache_entries=64, host_spill_bytes=64 << 20, **over)
    engine = InferenceEngine(model.cfg, model, engine_cfg=ec, eos_id=-1,
                             device=device)
    engine.set_grammar(_toy_fsm())
    return engine


# ---------------------------------------------------------------------------
# program accounting
# ---------------------------------------------------------------------------

def count_new_programs(engine, fn: Callable[[], Any]) -> tuple[int, int]:
    """Run ``fn``; return (decode programs it built, graphs it captured).
    A program dropped and rebuilt (a wider grammar) counts again."""
    before = {id(p) for p in engine._programs.values()}
    captures = engine.graph_captures
    fn()
    new = sum(id(p) not in before for p in engine._programs.values())
    return new, engine.graph_captures - captures


def _program_reads(prog) -> tuple[str, ...]:
    reads = _READS
    if prog.constrained:
        reads += ("_fsm_state", "_fsm_trans")
    if hasattr(prog, "rounds"):         # _SpecProgram
        reads += ("_hist",)
    return reads


def program_state(engine) -> dict:
    """What a rank reports of its decode programs: how many, how many
    bound their inputs, its graph captures, and the stale ones.  A mesh
    worker answers rank 0's ``programs`` request with it."""
    progs = list(engine._programs.values())
    return {"programs": len(progs),
            "bound": sum(p.bound is not None for p in progs),
            "captures": engine.graph_captures,
            "stale": stale_programs(engine)}


def stale_programs(engine) -> list[str]:
    """Programs whose captured inputs are not the engine's live tensors:
    ``"<key>: <buffer>"`` for each mismatch."""
    live = engine.live_buffers()
    out = []
    for key, prog in engine._programs.items():
        if prog.bound is None:
            continue
        for name in _program_reads(prog):
            if prog.bound.get(name) != live.get(name):
                out.append(f"{key}: {name}")
    return out


class SyncGuard:
    """On the card, run each replay of a captured decode program (the
    engine's decode op: the copy-in and the graph) under
    ``torch.cuda.set_sync_debug_mode("error")``; counts the replays it
    guarded.  Eager calls pass unguarded; a no-op off the card or with
    ``decode_graphs`` off."""

    def __init__(self, engine):
        self.engine = engine
        self.replays = 0
        self._orig = None

    def __enter__(self) -> "SyncGuard":
        import torch

        eng = self.engine
        if eng.device.type != "cuda" or not eng.decode_graphs:
            return self
        orig = self._orig = eng._op_decode

        def op_decode(inp, key):
            prog = eng._programs.get(key)
            if prog is None or prog.graph is None:
                return orig(inp, key)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = orig(inp, key)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            self.replays += 1
            return out

        eng._op_decode = op_decode
        return self

    def __exit__(self, *exc) -> None:
        if self._orig is not None:
            del self.engine._op_decode      # back to the class's method


# ---------------------------------------------------------------------------
# drives
# ---------------------------------------------------------------------------

def _prompt(n: int, tag: int) -> list[int]:
    return [(tag * 7 + i) % 100 + 1 for i in range(n)]


def _drive(engine, prompt_len: int, greedy: bool, tag: int,
           constrained: bool = False, max_tokens: int = 4) -> None:
    """One generation: distinct prompt content per ``tag`` (same shapes,
    different values: content must never matter to the program count)."""
    from k8s_llm_monitor_tpu_torch.serving.engine import SamplingParams

    sampling = (SamplingParams(max_tokens=max_tokens, constrained=constrained)
                if greedy
                else SamplingParams(max_tokens=max_tokens, temperature=0.7,
                                    top_k=4, constrained=constrained))
    res = engine.generate([_prompt(prompt_len, tag)], sampling)[0]
    assert res.finish_reason in ("eos", "length"), res


def _run_all(engine, reqs) -> dict:
    """Submit every request, step to the end, return the results."""
    for r in reqs:
        engine.submit(r)
    while engine.has_work:
        engine.step()
    return {r.request_id: engine.poll(r.request_id) for r in reqs}


def _live_events(engine, tag: int) -> dict[str, bool]:
    """A pipeline reset, a preemption, a host-tier restore and a grammar
    swap, each driven through the engine's own code; after each, every
    program's captured inputs must be the live tensors and no buffer may
    have been rebound.  Returns event -> held."""
    from k8s_llm_monitor_tpu_torch.serving.engine import (
        GenerationRequest, SamplingParams)

    want = engine.live_buffers()
    out: dict[str, bool] = {}

    def held() -> bool:
        return not stale_programs(engine) and engine.live_buffers() == want

    def reqs(n: int, max_tokens: int, base: int):
        return [GenerationRequest(f"tg-{base + i}",
                                  _prompt(12, base + i),
                                  SamplingParams(max_tokens=max_tokens))
                for i in range(n)]

    # A reset with calls in flight: the lanes requeue by recompute.
    rs = reqs(2, 8, tag)
    for r in rs:
        engine.submit(r)
    for _ in range(3):
        engine.step()
    engine._reset_pipeline("traceguard")
    while engine.has_work:
        engine.step()
    done = [engine.poll(r.request_id) for r in rs]
    out["reset"] = held() and all(
        d is not None and d.finish_reason == "length" for d in done)

    # A preemption of a decoding lane.
    rs = reqs(2, 12, tag + 10)
    for r in rs:
        engine.submit(r)
    while not any(s is not None and s.generated for s in engine._slots):
        engine.step()
    engine._reconcile_all()
    before = engine.preemptions
    engine._preempt(next(i for i, s in enumerate(engine._slots)
                         if s is not None))
    while engine.has_work:
        engine.step()
    done = [engine.poll(r.request_id) for r in rs]
    out["preemption"] = held() and engine.preemptions == before + 1 and all(
        d is not None and d.finish_reason == "length" for d in done)

    # A host-tier restore: a cached prefix spilled, then hit again.
    tier = engine.host_kv_tier
    prompt = _prompt(40, tag + 20)
    engine.generate([prompt], SamplingParams(max_tokens=4))
    while engine._evict_prefix_lru():
        pass
    restores = tier.restores
    engine.generate([prompt], SamplingParams(max_tokens=4))
    out["restore"] = held() and tier.restores > restores

    # A same-shape grammar swap, a constrained drive on it, and back.
    engine.set_grammar(_toy_fsm(variant=1))
    _drive(engine, 12, greedy=False, tag=tag + 30, constrained=True)
    engine.set_grammar(_toy_fsm(variant=0))
    out["grammar_swap"] = held()
    return out


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PathReport:
    path: str
    device: str
    warm_programs: int
    warm_captures: int
    repeat_programs: int
    repeat_captures: int
    replays_checked: int
    live: dict[str, bool]
    launches: dict[str, int]
    kv_quant: str = ""
    prefill_path: str = "dense"
    decode_path: str = "gather"

    @property
    def ok(self) -> bool:
        return (self.repeat_programs == 0 and self.repeat_captures == 0
                and all(self.live.values()))

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def check_path(path: str, device: Any = "cuda", model=None,
               block_size: int = 8) -> PathReport:
    """Warm pass, same-bucket repeat (counted, replays sync-guarded on the
    card), then the live-buffer events."""
    from k8s_llm_monitor_tpu_torch.ops.paged_attention import (
        KERNEL_WRAPPERS)

    engine = build_engine(path, device=device, model=model,
                          block_size=block_size)
    swap = path == "grammar_swap"
    counts0 = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}

    # prompt_len 40 > the top bucket (32): the chunk rounds join the pass.
    def warm():
        _drive(engine, 12, greedy=True, tag=1)
        _drive(engine, 12, greedy=False, tag=2)
        _drive(engine, 12, greedy=False, tag=5, constrained=True)
        _drive(engine, 40, greedy=True, tag=7)
        _drive(engine, 40, greedy=False, tag=8, constrained=True)

    def repeat():
        if swap:
            engine.set_grammar(_toy_fsm(variant=1))
        _drive(engine, 12, greedy=True, tag=3)
        _drive(engine, 12, greedy=False, tag=4)
        _drive(engine, 12, greedy=False, tag=6, constrained=True)
        if swap:
            engine.set_grammar(_toy_fsm(variant=0))
        _drive(engine, 40, greedy=True, tag=9)
        _drive(engine, 40, greedy=False, tag=10, constrained=True)

    warm_p, warm_c = count_new_programs(engine, warm)
    with SyncGuard(engine) as guard:
        repeat_p, repeat_c = count_new_programs(engine, repeat)
        live = _live_events(engine, tag=100)
    return PathReport(
        path=path, device=str(engine.device),
        warm_programs=warm_p, warm_captures=warm_c,
        repeat_programs=repeat_p, repeat_captures=repeat_c,
        replays_checked=guard.replays, live=live,
        launches={fn.__name__: fn.launches - counts0[fn.__name__]
                  for fn in KERNEL_WRAPPERS},
        kv_quant=engine.kv_quant, prefill_path=engine.prefill_path,
        decode_path=engine.decode_path)


def capture_hazards() -> list[str]:
    """The static half of guarantee 2: ``capture-hazard`` over the port's
    package (every graph root and what it calls)."""
    from pathlib import Path

    from k8s_llm_monitor_tpu_torch.devtools import dataflow

    pkg = Path(__file__).resolve().parents[1]
    return [f.human() for f in dataflow.analyze_paths(
        [pkg], rules=["capture-hazard"])]


def run_traceguard(paths=DEFAULT_PATHS, device: Any = "cuda") -> dict:
    """The full gate; returns the machine-readable report the CLI prints
    and the tests and ``chip_smoke.py`` consume."""
    reports = {p: check_path(p, device=device) for p in paths}
    hazards = capture_hazards()
    return {
        "paths": {p: r.as_dict() for p, r in reports.items()},
        "capture_hazards": hazards,
        "ok": all(r.ok for r in reports.values()) and not hazards,
    }


def render(report: dict) -> str:
    lines = []
    for path, rep in report["paths"].items():
        lines.append(
            f"graftcheck traceguard[{path}]: "
            f"{'ok' if rep['ok'] else 'FAIL'} ({rep['device']}: warm "
            f"programs={rep['warm_programs']} captures="
            f"{rep['warm_captures']}, repeat programs="
            f"{rep['repeat_programs']} captures={rep['repeat_captures']}, "
            f"replays sync-checked={rep['replays_checked']}, live buffers "
            f"{'held' if all(rep['live'].values()) else rep['live']})")
    lines.append(f"graftcheck traceguard: capture hazards "
                 f"{len(report['capture_hazards'])}")
    return "\n".join(lines + report["capture_hazards"])
