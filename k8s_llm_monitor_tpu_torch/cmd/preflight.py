"""Serving preflight: will this model, quantization and mesh fit and shard
on the cards you have, before you boot the server?

The port of the JAX package's ``cmd/preflight.py``.  Everything comes from
shapes: the model is built on ``torch.device("meta")``, so no weight
exists, and checking a 70B config takes seconds on a host with no card.

Usage::

    python -m k8s_llm_monitor_tpu_torch.cmd.preflight --model llama3-8b \\
        --quantize w8a8 --mesh 1,1,2
    python -m k8s_llm_monitor_tpu_torch.cmd.preflight --config config.yaml
    python -m k8s_llm_monitor_tpu_torch.cmd.preflight --model qwen2-72b \\
        --quantize int8 --mesh 1,1,4 --per-chip-hbm-gib 80

Exit code 0 = every check passed (warnings allowed), 1 = at least one
FAIL.

The per-card memory is, in order: ``--per-chip-hbm-gib``, the total of
``torch.cuda.mem_get_info`` when a card is present, a table by device name
(``HBM_BY_KIND``).  Besides the JAX package's checks it takes the port's
page dtypes (``--kv-dtype``: int8 / fp8 pages with their scale planes,
e5m2, fp16).  Three deliberate differences from the JAX version:

  * ``num_experts`` joins the TP divisibility list (an expert axis that
    does not divide would shard unevenly);
  * the weight and spec lists are zipped ``strict=True``, so a layout the
    specs do not mirror fails loudly instead of undercounting;
  * the boot check (monitor/analysis.py) takes its workload from the
    engine's ``max_blocks_per_seq * block_size``, not a fixed 768 + 256.
"""

from __future__ import annotations

import argparse
import sys

GIB = 1 << 30

# Per-card memory by device name, when no card reports it (preflighting a
# deployment from a host without one).  Sources: NVIDIA's data sheets.
HBM_BY_KIND = {
    "NVIDIA H100 80GB HBM3": 80 * GIB,
    "NVIDIA H100 PCIe": 80 * GIB,
    "NVIDIA H100 NVL": 94 * GIB,
    "NVIDIA H200": 141 * GIB,
    "NVIDIA A100-SXM4-80GB": 80 * GIB,
    "NVIDIA A100-SXM4-40GB": 40 * GIB,
}

# Headroom for activations, the caching allocator's workspace and the
# dispatch buffers at serving batch sizes: an estimate, conservative (the
# JAX package's figure).
_WORKSPACE_BYTES = int(1.5 * GIB)

_DTYPE_BYTES = {"bfloat16": 2, "float32": 4, "float16": 2,
                "float8_e4m3fn": 1, "float8_e5m2": 1, "int8": 1}

# --kv-dtype: the engine's ``kv_dtype`` (auto | int8 | fp8, scaled pools
# with one f32 scale per kv head and token) or an unscaled page dtype.
_KV_DTYPES = ("auto", "int8", "fp8", "float8_e4m3fn", "float8_e5m2",
              "float16")


class _Report:
    """Collects verdicts as structured lists (consumed by ``check()``)
    while printing the human report."""

    def __init__(self) -> None:
        self.failed = 0
        self.warned = 0
        self.fail_msgs: list[str] = []
        self.warn_msgs: list[str] = []

    def ok(self, msg: str) -> None:
        print(f"  PASS {msg}")

    def warn(self, msg: str) -> None:
        self.warned += 1
        self.warn_msgs.append(msg)
        print(f"  WARN {msg}")

    def fail(self, msg: str) -> None:
        self.failed += 1
        self.fail_msgs.append(msg)
        print(f"  FAIL {msg}")


def _devices() -> tuple[int, str]:
    """(count, name of the first) of the cards this host sees, or one
    ``cpu``."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.device_count(), torch.cuda.get_device_name(0)
    return 1, "cpu"


def _card_bytes() -> int | None:
    """The first card's total memory, when one is present."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.mem_get_info(0)[1]
    return None


def _tree_bytes(tensors, specs, model_axis: int) -> tuple[int, int]:
    """(total_bytes, per_chip_bytes) of ``tensors`` under their ``specs``
    at TP ``model_axis``: a tensor with a ``model`` axis divides across
    the ranks, every other one is replicated on each."""
    total = per_chip = 0
    for t, spec in zip(tensors, specs, strict=True):
        nbytes = t.numel() * t.element_size()
        total += nbytes
        per_chip += nbytes // (model_axis if "model" in spec else 1)
    return total, per_chip


def _split_dims(cfg) -> list[tuple[str, int]]:
    """The dims TP splits: query heads, the FFN, the vocab, and the expert
    axis of a mixture of experts."""
    dims = [("num_heads", cfg.num_heads),
            ("intermediate_size", cfg.intermediate_size),
            ("vocab_size", cfg.vocab_size)]
    experts = getattr(cfg, "num_experts", 0)
    if experts:
        dims.append(("num_experts", experts))
    return dims


def check_mesh(r: _Report, cfg, data: int, seq: int, model: int,
               n_devices: int) -> None:
    """Section 3: the mesh against the cards and the model's split
    dims."""
    n_mesh = data * seq * model
    if n_mesh == n_devices:
        r.ok(f"mesh data={data} seq={seq} model={model} "
             f"matches {n_devices} local device(s)")
    else:
        r.warn(f"mesh needs {n_mesh} device(s), this host sees "
               f"{n_devices} - fine if deploying elsewhere or "
               "multi-host")
    if model > 1:
        bad = [(nm, dim) for nm, dim in _split_dims(cfg) if dim % model]
        for nm, dim in bad:
            r.fail(f"{nm}={dim} not divisible by model={model}")
        if not bad:
            r.ok(f"q-heads/FFN/vocab all divide model={model}")
        if cfg.num_kv_heads % model == 0:
            r.ok(f"kv_heads={cfg.num_kv_heads} shard {model}-way "
                 "(KV pages split on head boundaries)")
        else:
            r.warn(f"kv_heads={cfg.num_kv_heads} not divisible by "
                   f"model={model} - KV pages replicate per chip "
                   "(parallel/sharding.py kv_pages_partition_specs)")
    if seq > 1:
        r.ok(f"seq={seq}: engine shards prefill chunks (buckets must "
             f"divide by {seq}; checked at boot)")


def weight_bytes(cfg, quantized: bool, model: int) -> tuple[int, int]:
    """(total, per-card) weight bytes of ``cfg`` at TP ``model``, from a
    model built on the meta device (no weight exists)."""
    from k8s_llm_monitor_tpu_torch.models.llama import LlamaModel
    from k8s_llm_monitor_tpu_torch.parallel.sharding import (
        param_partition_specs)

    meta = LlamaModel(cfg, device="meta", seed=None, quantized=quantized)
    named = list(meta.named_parameters()) + list(meta.named_buffers())
    specs = param_partition_specs([n for n, _ in named])
    return _tree_bytes([t for _, t in named], list(specs.values()), model)


def _kv_bytes(cfg, kv_dtype: str) -> tuple[float, str]:
    """(bytes per kv head element, the pool's name) of ``--kv-dtype``:
    scaled pools add one f32 scale per kv head and token."""
    head_dim = cfg.head_dim or cfg.hidden_size // cfg.num_heads
    if kv_dtype in ("int8", "fp8"):
        return 1 + 4 / head_dim, f"{kv_dtype} (scaled)"
    name = cfg.kv_dtype or cfg.dtype if kv_dtype == "auto" else kv_dtype
    return _DTYPE_BYTES.get(name, 2), name


def run_preflight(args: argparse.Namespace,
                  r: _Report | None = None) -> int:
    import torch

    from k8s_llm_monitor_tpu_torch.models.config import PRESETS

    r = r if r is not None else _Report()

    def finish() -> int:
        # One verdict trailer, printed on early bail-outs too.
        print(f"\npreflight: {'FAIL' if r.failed else 'PASS'} "
              f"({r.failed} failed, {r.warned} warnings)")
        return 1 if r.failed else 0

    # -- 1. runtime -----------------------------------------------------
    print("== 1. runtime ==")
    n_devices, kind = _devices()
    r.ok(f"torch {torch.__version__}, {n_devices} x {kind}")
    hbm = None
    if args.per_chip_hbm_gib:
        hbm = int(args.per_chip_hbm_gib * GIB)
    else:
        hbm = _card_bytes() or HBM_BY_KIND.get(kind)
    if hbm:
        r.ok(f"per-chip HBM budget {hbm / GIB:.0f} GiB"
             + ("" if args.per_chip_hbm_gib else f" (from {kind!r})"))
    else:
        r.warn(f"unknown HBM for device kind {kind!r} - fit checks "
               "skipped (pass --per-chip-hbm-gib)")

    # -- 2. model geometry ----------------------------------------------
    print("== 2. model ==")
    if args.checkpoint:
        import json
        import os

        cfg_path = os.path.join(args.checkpoint, "config.json")
        try:
            from k8s_llm_monitor_tpu_torch.utils.checkpoint import (
                config_from_hf)

            with open(cfg_path, encoding="utf-8") as fh:
                cfg = config_from_hf(json.load(fh))
            r.ok(f"checkpoint config {cfg_path}: {cfg.name}")
        except Exception as exc:  # noqa: BLE001 -- reported as a FAIL
            r.fail(f"cannot read checkpoint config {cfg_path}: {exc}")
            return finish()
    else:
        if args.model not in PRESETS:
            r.fail(f"unknown preset {args.model!r}; have "
                   f"{', '.join(sorted(PRESETS))}")
            return finish()
        cfg = PRESETS[args.model]
    if args.quantize == "w8a8":
        import dataclasses

        cfg = dataclasses.replace(cfg, act_quant=True)
    head_dim = cfg.head_dim or cfg.hidden_size // cfg.num_heads
    if cfg.num_heads % cfg.num_kv_heads == 0:
        r.ok(f"{cfg.num_layers}L hidden={cfg.hidden_size} "
             f"heads={cfg.num_heads}/{cfg.num_kv_heads}kv "
             f"head_dim={head_dim} vocab={cfg.vocab_size}")
    else:
        r.fail(f"num_heads {cfg.num_heads} not a multiple of "
               f"num_kv_heads {cfg.num_kv_heads}")

    # -- 3. mesh --------------------------------------------------------
    print("== 3. mesh ==")
    try:
        data, seq, model = (int(x) for x in args.mesh.split(","))
        if data < 1 or seq < 1 or model < 1:
            raise ValueError("mesh dims must be >= 1")
    except ValueError:
        r.fail(f"bad --mesh {args.mesh!r}; expected data,seq,model")
        return finish()
    check_mesh(r, cfg, data, seq, model, n_devices)

    # -- 4. weights -----------------------------------------------------
    print("== 4. weights ==")
    quantized = args.quantize in ("int8", "w8a8")
    total_b, chip_b = weight_bytes(cfg, quantized, model)
    r.ok(f"{args.quantize or 'bf16'} weights {total_b / GIB:.2f} GiB total"
         + (f", {chip_b / GIB:.2f} GiB/chip at TP-{model}"
            if model > 1 else ""))

    # -- 5. KV cache ----------------------------------------------------
    print("== 5. kv cache ==")
    kv_bytes_per, kv_name = _kv_bytes(cfg, args.kv_dtype)
    kv_heads_chip = (cfg.num_kv_heads // model
                     if model > 1 and cfg.num_kv_heads % model == 0
                     else cfg.num_kv_heads)
    kv_chip = int(args.kv_blocks * args.block_size * cfg.num_layers * 2
                  * kv_heads_chip * head_dim * kv_bytes_per)
    cap_tokens = args.kv_blocks * args.block_size
    r.ok(f"{args.kv_blocks} blocks x {args.block_size} = "
         f"{cap_tokens} tokens capacity, {kv_chip / GIB:.2f} GiB/chip "
         f"({kv_name} KV)")
    per_seq = args.prompt_len + args.max_tokens
    if per_seq > 0:
        fit = cap_tokens // per_seq
        msg = (f"~{fit} concurrent sequences at prompt {args.prompt_len} "
               f"+ gen {args.max_tokens}")
        (r.ok if fit >= 1 else r.fail)(
            msg if fit >= 1 else msg + " - raise --kv-blocks")

    # -- 6. fit verdict -------------------------------------------------
    print("== 6. fit ==")
    if hbm:
        need = chip_b + kv_chip + _WORKSPACE_BYTES
        line = (f"per-chip: weights {chip_b / GIB:.2f} + kv "
                f"{kv_chip / GIB:.2f} + workspace "
                f"{_WORKSPACE_BYTES / GIB:.1f} = {need / GIB:.2f} GiB "
                f"of {hbm / GIB:.0f} GiB")
        if need <= 0.92 * hbm:
            r.ok(line)
        elif need <= hbm:
            r.warn(line + " - under 8% headroom")
        else:
            r.fail(line + " - does not fit; shrink --kv-blocks, raise "
                   "TP, or quantize")
    else:
        r.warn("no HBM budget known - skipped")

    # -- 7. optional compile smoke --------------------------------------
    if args.compile:
        print("== 7. compile ==")
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        a = torch.ones((256, 256), dtype=torch.bfloat16, device=dev)
        (a @ a).sum().item()
        r.ok(f"matmul on {dev} ok")

    return finish()


def _build_args(argv: list[str] | None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="serving preflight (no weights materialized)")
    ap.add_argument("--config", default="",
                    help="server YAML; fills any flag not given "
                         "explicitly from llm.tpu.* (explicit flags win)")
    ap.add_argument("--model", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="HF checkpoint dir (overrides --model)")
    ap.add_argument("--quantize", default=None,
                    choices=["", "none", "int8", "w8a8"])
    ap.add_argument("--mesh", default=None,
                    help="data,seq,model (llm.tpu.mesh_shape)")
    ap.add_argument("--kv-blocks", type=int, default=None)
    ap.add_argument("--kv-dtype", default="auto", choices=_KV_DTYPES,
                    help="the KV pool: auto (the model's page dtype), "
                         "int8 / fp8 (scaled), or an unscaled page dtype")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=192)
    ap.add_argument("--max-tokens", type=int, default=256)
    ap.add_argument("--per-chip-hbm-gib", type=float, default=0.0)
    ap.add_argument("--compile", action="store_true",
                    help="run a tiny matmul on the card")
    args = ap.parse_args(argv)
    if args.config:
        # Only flags not passed (still None) come from the YAML.
        from k8s_llm_monitor_tpu_torch.monitor.config import load_config

        c = load_config(args.config)
        if args.model is None:
            args.model = c.llm.tpu.model or None
        if args.checkpoint is None:
            args.checkpoint = c.llm.tpu.checkpoint or None
        if args.quantize is None:
            args.quantize = getattr(c.llm.tpu, "quantize", None)
        if args.mesh is None:
            args.mesh = c.llm.tpu.mesh_shape or None
        if args.kv_blocks is None:
            args.kv_blocks = c.llm.tpu.kv_blocks or None
    # Defaults for anything neither flag nor config set.
    if args.model is None:
        args.model = "llama3-8b"
    args.checkpoint = args.checkpoint or ""
    args.quantize = args.quantize if args.quantize is not None else "w8a8"
    if args.quantize == "none":
        args.quantize = ""
    args.mesh = args.mesh or "1,1,1"
    args.kv_blocks = args.kv_blocks or 512
    return args


def check(argv: list[str] | None = None) -> tuple[int, list[str], list[str]]:
    """Programmatic preflight: (exit_code, fail_msgs, warn_msgs), from the
    CLI's arguments (monitor/analysis.py reads the lists at boot)."""
    r = _Report()
    rc = run_preflight(_build_args(argv), r)
    return rc, r.fail_msgs, r.warn_msgs


def main(argv: list[str] | None = None) -> int:
    return run_preflight(_build_args(argv))


if __name__ == "__main__":
    sys.exit(main())
