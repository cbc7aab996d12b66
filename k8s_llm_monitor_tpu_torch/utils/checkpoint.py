"""Checkpoint IO: HuggingFace safetensors -> a ``LlamaModel``, plus a
torch-native save/restore.

HF stores ``nn.Linear`` weights ``[out, in]``, which is this port's layout,
so nothing is transposed (the JAX package transposes here, once).
Supports the checkpoint families of the JAX package's loader: Llama (no
biases), Mistral (a live sliding window in v0.1), Qwen2 (QKV biases),
Mixtral (``block_sparse_moe``: the router and per-expert ``w1`` / ``w3``
/ ``w2``, stacked into ``[E, in, out]``) and Gemma-2 (sandwich norms,
tied embeddings), in single-file or index-sharded safetensors form.  The safetensors files are
read by this module itself (an 8-byte little-endian header length, a JSON
header, then the raw bytes), mapped with ``mmap`` and viewed with
``torch.frombuffer``: it needs no ``safetensors`` package, and bf16
tensors, which numpy cannot hold, arrive as torch tensors.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import pathlib
import struct
from typing import Any, Iterator, Mapping, Optional

import numpy as np
import torch

from k8s_llm_monitor_tpu_torch.models.config import (
    ModelConfig, gemma2_layer_types)
from k8s_llm_monitor_tpu_torch.models.llama import LlamaModel
from k8s_llm_monitor_tpu_torch.parallel.sharding import (
    param_partition_specs, shard_tensor)

_DTYPES = {"F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I8": torch.int8}


def config_from_hf(hf: Mapping[str, Any], name: str = "hf-model") -> ModelConfig:
    """Translate a HF ``config.json`` dict (Llama, Mistral, Qwen2, Mixtral,
    Gemma-2) to ours, as the JAX package's ``config_from_hf`` does.

    Keys equal to a HF class default are omitted from a saved config.json,
    so family defaults are reproduced here.  Qwen2 ships a
    ``sliding_window`` beside ``use_sliding_window: false``: the raw value
    alone does not turn windows on.  Gemma-2's class defaults (a 4,096
    window, caps 50 and 30, ``query_pre_attn_scalar`` 256, tied
    embeddings) apply when its keys are absent, and its layers alternate
    sliding and full attention when the config lists no ``layer_types``."""
    num_heads = hf["num_attention_heads"]
    gemma2 = hf.get("model_type") == "gemma2"
    n_layers = hf["num_hidden_layers"]
    sliding = hf.get("sliding_window", 4096 if gemma2 else 0) or 0
    if hf.get("use_sliding_window") is False:
        sliding = 0
    layer_types = tuple(hf["layer_types"]) if hf.get("layer_types") else None
    if gemma2 and sliding and layer_types is None:
        layer_types = gemma2_layer_types(n_layers)
    return ModelConfig(
        name=name,
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=num_heads,
        num_kv_heads=hf.get("num_key_value_heads", num_heads),
        head_dim=hf.get("head_dim"),
        rope_theta=hf.get("rope_theta", 10_000.0),
        rope_scaling=hf.get("rope_scaling"),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_seq_len=hf.get("max_position_embeddings", 8192),
        qkv_bias=hf.get("model_type") == "qwen2",
        tie_embeddings=hf.get("tie_word_embeddings", gemma2),
        num_experts=hf.get("num_local_experts", 0),
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        mlp_activation=("gelu_tanh" if gemma2 or hf.get("hidden_activation")
                        == "gelu_pytorch_tanh" else "silu"),
        sandwich_norms=gemma2,
        rmsnorm_unit_offset=gemma2,
        attn_logit_softcap=hf.get(
            "attn_logit_softcapping", 50.0 if gemma2 else 0.0) or 0.0,
        final_logit_softcap=hf.get(
            "final_logit_softcapping", 30.0 if gemma2 else 0.0) or 0.0,
        query_pre_attn_scalar=(hf.get("query_pre_attn_scalar", 256.0)
                               if gemma2 else None),
        embed_scale=gemma2,
        sliding_window=sliding,
        layer_types=layer_types,
    )


_LINEAR_MAP = {
    "q": "self_attn.q_proj",
    "k": "self_attn.k_proj",
    "v": "self_attn.v_proj",
    "o": "self_attn.o_proj",
    "gate": "mlp.gate_proj",
    "up": "mlp.up_proj",
    "down": "mlp.down_proj",
}

# Gemma-2's norms: post_attention_layernorm applies to the attention
# output, pre_/post_feedforward_layernorm sandwich the MLP (post_norm plays
# the pre-feedforward role).
_NORM_MAP = {"input_norm": "input_layernorm",
             "post_norm": "post_attention_layernorm"}
_SANDWICH_NORM_MAP = {"input_norm": "input_layernorm",
                      "post_attn_norm": "post_attention_layernorm",
                      "post_norm": "pre_feedforward_layernorm",
                      "post_mlp_norm": "post_feedforward_layernorm"}

# Mixtral's experts: w1 is the gate, w3 the up, w2 the down projection.
_EXPERT_MAP = {"gate_e": "w1", "up_e": "w3", "down_e": "w2"}


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


@torch.no_grad()
def convert_hf_state_dict(state: Mapping[str, Any], cfg: ModelConfig,
                          dtype: Optional[str] = None, quantize: bool = False,
                          device=None, mesh=None) -> LlamaModel:
    """Fill a ``LlamaModel`` on ``device`` (default ``cuda``) from a HF
    Llama/Mistral/Qwen2/Mixtral/Gemma-2 state dict (torch tensors or numpy
    arrays), tensor by tensor.  A Mixtral expert stack is filled one
    expert at a time (``w.T`` into ``[in, out]``; int8 quantized per
    expert on load), and under a mesh a rank reads only its own experts;
    the router stays in the model dtype.

    ``dtype`` (a torch dtype name, default ``cfg.dtype``) is the model's.
    With ``quantize=True`` every linear and the embedding are int8: each
    tensor is quantized alone (``utils/quantize.fill_quantized`` over its
    ``in`` axis, on the model's device, one tensor's float32 copy at a
    time), so the device never holds the bf16 model.  A
    checkpoint without ``lm_head.weight`` whose config does not tie the
    embeddings takes the embedding as its head.

    ``mesh``: the rank's shard (parallel/sharding.py's specs).  Each
    tensor is sliced on the host before it is read (a view of the mapped
    file: column-parallel rows, row-parallel columns), so only the rank's
    bytes reach its device; int8 of a row-parallel weight takes its row
    scales over every rank's columns (a MAX all-reduce).  Every rank
    runs it on the same checkpoint.
    """
    from k8s_llm_monitor_tpu_torch.utils.quantize import fill_quantized

    dt = getattr(torch, dtype) if dtype else cfg.torch_dtype
    model = LlamaModel(cfg, device=device, dtype=dt, seed=None,
                       quantized=quantize, mesh=mesh)
    specs = param_partition_specs(model)

    def piece(name: str, key: str) -> torch.Tensor:
        return shard_tensor(_tensor(state[key]), specs[name], model.rank,
                            model.tp)

    def weight(name: str, key: str, row: bool = False) -> None:
        dst = model.get_submodule(name)
        if quantize:
            fill_quantized(dst.weight_q, dst.scale,
                           piece(name + ".weight_q", key),
                           mesh=model.mesh if row else None)
        else:
            dst.weight.copy_(piece(name + ".weight", key))

    def vector(name: str, key: str) -> None:
        model.get_parameter(name).copy_(piece(name, key))

    def experts(stack, pre: str, hf_name: str) -> None:
        n = stack.num_experts
        for j in range(n):
            w = _tensor(state[f"{pre}block_sparse_moe.experts."
                              f"{model.rank * n + j}.{hf_name}.weight"])
            if quantize:
                # Expert j's codes [in, out] filled through their
                # transpose, per output channel as a linear's.
                fill_quantized(stack.kernel_q[j].t(), stack.scale[j], w)
            else:
                stack.kernel[j].copy_(w.t())

    weight("embed", "model.embed_tokens.weight")
    vector("final_norm", "model.norm.weight")
    if model.lm_head is not None:
        weight("lm_head", "lm_head.weight" if "lm_head.weight" in state
               else "model.embed_tokens.weight")
    norms = _SANDWICH_NORM_MAP if cfg.sandwich_norms else _NORM_MAP
    moe = cfg.num_experts > 0
    for i, layer in enumerate(model.layers):
        pre, ours = f"model.layers.{i}.", f"layers.{i}."
        for name, theirs in norms.items():
            vector(ours + name, f"{pre}{theirs}.weight")
        for name, theirs in _LINEAR_MAP.items():
            if moe and name in ("gate", "up", "down"):
                continue
            weight(ours + name, f"{pre}{theirs}.weight",
                   row=name in ("o", "down"))
            if (getattr(layer, name).bias is not None
                    and f"{pre}{theirs}.bias" in state):
                vector(f"{ours}{name}.bias", f"{pre}{theirs}.bias")
        if moe:
            layer.router.weight.copy_(
                _tensor(state[f"{pre}block_sparse_moe.gate.weight"]))
            for name, theirs in _EXPERT_MAP.items():
                experts(getattr(layer, name), pre, theirs)
    return model


class _SafetensorsFile:
    """One safetensors file: its header, and its bytes mapped copy-on-write
    (writable for ``torch.frombuffer``, never written)."""

    def __init__(self, path: pathlib.Path):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self.header = header
        self._base = 8 + n

    def get(self, key: str) -> torch.Tensor:
        """The tensor ``key``, a view of the mapped file (it keeps the map
        alive)."""
        meta = self.header[key]
        dtype = _DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{key}: safetensors dtype {meta['dtype']} is "
                             f"not read (one of {sorted(_DTYPES)})")
        start, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{key}: {end - start} bytes for shape {shape} "
                             f"of {meta['dtype']}")
        if end == start:
            return torch.empty(shape, dtype=dtype)
        flat = torch.frombuffer(self._map, dtype=dtype,
                                count=(end - start) // itemsize,
                                offset=self._base + start)
        return flat.reshape(shape)


class _SafetensorsDict(Mapping[str, torch.Tensor]):
    """Lazy mapping over (possibly index-sharded) safetensors files: the
    weight map of ``model.safetensors.index.json``, else every
    ``*.safetensors`` file of the directory."""

    def __init__(self, model_dir: pathlib.Path):
        self._files: dict[str, pathlib.Path] = {}
        self._open: dict[pathlib.Path, _SafetensorsFile] = {}
        index = model_dir / "model.safetensors.index.json"
        if index.exists():
            weight_map = json.loads(index.read_text())["weight_map"]
            for key, fname in weight_map.items():
                self._files[key] = model_dir / fname
        else:
            for f in sorted(model_dir.glob("*.safetensors")):
                for key in self._file(f).header:
                    self._files[key] = f

    def _file(self, path: pathlib.Path) -> _SafetensorsFile:
        sf = self._open.get(path)
        if sf is None:
            sf = self._open[path] = _SafetensorsFile(path)
        return sf

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._file(self._files[key]).get(key)

    def __iter__(self) -> Iterator[str]:
        return iter(self._files)

    def __len__(self) -> int:
        return len(self._files)

    def __contains__(self, key: object) -> bool:
        return key in self._files


def load_hf_checkpoint(model_dir: str | pathlib.Path,
                       dtype: Optional[str] = None, quantize: bool = False,
                       device=None, mesh=None, act_quant: bool = False
                       ) -> tuple[ModelConfig, LlamaModel]:
    """Load a HF-format model directory (config.json + safetensors) onto
    ``device`` (default ``cuda``).  ``quantize=True`` quantizes each
    tensor to int8 on its own (``convert_hf_state_dict``): the model
    holds only the int8 weights; ``act_quant`` (W8A8, int8 weights
    only) goes into the config before the model is built.

    ``mesh`` (parallel/mesh.py) loads the rank's shard; on rank 0 every
    worker is sent the same load first and reads its own shard from the
    same directory (no weight crosses the pipe to it)."""
    model_dir = pathlib.Path(model_dir)
    if mesh is not None and mesh.is_leader:
        run = lambda: load_hf_shard(model_dir, dtype, quantize, act_quant,  # noqa: E731
                                    mesh=mesh, device=device)
        token, model = mesh.build_alongside(
            run, "checkpoint", str(model_dir), dtype, quantize, act_quant)
        model.mesh_token = token
        return model.cfg, model
    model = load_hf_shard(model_dir, dtype, quantize, act_quant, mesh=mesh,
                          device=device)
    return model.cfg, model


def load_hf_shard(model_dir: str | pathlib.Path, dtype: Optional[str] = None,
                  quantize: bool = False, act_quant: bool = False, *,
                  mesh=None, device=None) -> LlamaModel:
    """This rank's model of ``load_hf_checkpoint`` (a mesh worker's
    builder)."""
    model_dir = pathlib.Path(model_dir)
    hf_cfg = json.loads((model_dir / "config.json").read_text())
    cfg = config_from_hf(hf_cfg, name=model_dir.name)
    if dtype or act_quant:
        cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype,
                                  act_quant=act_quant)
    state = _SafetensorsDict(model_dir)
    return convert_hf_state_dict(state, cfg, dtype=dtype, quantize=quantize,
                                 device=device, mesh=mesh)


# ---------------------------------------------------------------------------
# Torch-native checkpoints (snapshot persistence; the JAX package uses Orbax)
# ---------------------------------------------------------------------------


def save_checkpoint(path: str | pathlib.Path, model: LlamaModel) -> None:
    """Write ``model``'s state dict (weights, int8 codes and scales) to the
    file ``path``."""
    torch.save(model.state_dict(), pathlib.Path(path))


def restore_checkpoint(path: str | pathlib.Path,
                       like: Optional[LlamaModel] = None):
    """Read a ``save_checkpoint`` file (tensors only: ``weights_only``).
    With ``like``, a model of the same configuration, its tensors are
    overwritten in place and it is returned; else the state dict, on the
    CPU."""
    state = torch.load(pathlib.Path(path), map_location="cpu",
                       weights_only=True)
    if like is None:
        return state
    like.load_state_dict(state)
    return like
