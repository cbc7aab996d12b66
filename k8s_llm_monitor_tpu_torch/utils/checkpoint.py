"""Checkpoint IO: HuggingFace safetensors -> a ``LlamaModel``, plus a
torch-native save/restore.

HF stores ``nn.Linear`` weights ``[out, in]``, which is this port's layout,
so nothing is transposed (the JAX package transposes here, once).
Supports the dense checkpoint families of the JAX package's loader: Llama
(no biases), Mistral (v0.3+: no sliding window) and Qwen2 (QKV biases), in
single-file or index-sharded safetensors form.  The safetensors files are
read by this module itself (an 8-byte little-endian header length, a JSON
header, then the raw bytes), mapped with ``mmap`` and viewed with
``torch.frombuffer``: it needs no ``safetensors`` package, and bf16
tensors, which numpy cannot hold, arrive as torch tensors.
"""

from __future__ import annotations

import json
import mmap
import pathlib
import struct
from typing import Any, Iterator, Mapping, Optional

import numpy as np
import torch

from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.models.llama import LlamaModel

_DTYPES = {"F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I8": torch.int8}


def config_from_hf(hf: Mapping[str, Any], name: str = "hf-model") -> ModelConfig:
    """Translate a HF ``config.json`` dict (Llama, Mistral, Qwen2) to ours.

    Keys equal to a HF class default are omitted from a saved config.json,
    so family defaults are reproduced here.  Qwen2 ships a
    ``sliding_window`` beside ``use_sliding_window: false``: the raw value
    alone does not turn windows on.  What the port's ``ModelConfig`` cannot
    hold raises ``NotImplementedError`` naming ROADMAP A9: Gemma-2, a
    mixture of experts (``num_local_experts``), a live sliding window
    (Mistral v0.1) and logit soft caps."""
    if hf.get("model_type") == "gemma2":
        raise NotImplementedError(
            "Gemma-2 checkpoints are not ported (ROADMAP A9)")
    if hf.get("num_local_experts", 0):
        raise NotImplementedError(
            "mixture-of-experts checkpoints are not ported (ROADMAP A9)")
    sliding = hf.get("sliding_window", 0) or 0
    if hf.get("use_sliding_window") is False:
        sliding = 0
    if sliding:
        raise NotImplementedError(
            f"sliding-window attention (sliding_window={sliding}) is not "
            "ported (ROADMAP A9)")
    if hf.get("attn_logit_softcapping") or hf.get("final_logit_softcapping"):
        raise NotImplementedError(
            "logit soft caps are not ported (ROADMAP A9)")
    num_heads = hf["num_attention_heads"]
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
        tie_embeddings=hf.get("tie_word_embeddings", False),
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


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


@torch.no_grad()
def convert_hf_state_dict(state: Mapping[str, Any], cfg: ModelConfig,
                          dtype: Optional[str] = None, quantize: bool = False,
                          device=None) -> LlamaModel:
    """Fill a ``LlamaModel`` on ``device`` (default ``cuda``) from a HF
    Llama/Mistral/Qwen2 state dict (torch tensors or numpy arrays), tensor
    by tensor.

    ``dtype`` (a torch dtype name, default ``cfg.dtype``) is the model's.
    With ``quantize=True`` every linear and the embedding are int8: each
    tensor is quantized on the host (``utils/quantize.quantize_array`` over
    its ``in`` axis) before it moves to the device, so the device never
    holds the bf16 weights.  A checkpoint without ``lm_head.weight`` whose
    config does not tie the embeddings takes the embedding as its head.
    """
    from k8s_llm_monitor_tpu_torch.utils.quantize import fill_quantized

    dt = getattr(torch, dtype) if dtype else cfg.torch_dtype
    model = LlamaModel(cfg, device=device, dtype=dt, seed=None,
                       quantized=quantize)

    def weight(dst, key: str) -> None:
        w = _tensor(state[key])
        if quantize:
            fill_quantized(dst.weight_q, dst.scale, w.float().numpy())
        else:
            dst.weight.copy_(w)

    def vector(dst: torch.Tensor, key: str) -> None:
        dst.copy_(_tensor(state[key]))

    weight(model.embed, "model.embed_tokens.weight")
    vector(model.final_norm, "model.norm.weight")
    if model.lm_head is not None:
        weight(model.lm_head, "lm_head.weight" if "lm_head.weight" in state
               else "model.embed_tokens.weight")
    for i, layer in enumerate(model.layers):
        pre = f"model.layers.{i}."
        vector(layer.input_norm, pre + "input_layernorm.weight")
        vector(layer.post_norm, pre + "post_attention_layernorm.weight")
        for ours, theirs in _LINEAR_MAP.items():
            lin = getattr(layer, ours)
            weight(lin, f"{pre}{theirs}.weight")
            if lin.bias is not None and f"{pre}{theirs}.bias" in state:
                vector(lin.bias, f"{pre}{theirs}.bias")
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
                       device=None) -> tuple[ModelConfig, LlamaModel]:
    """Load a HF-format model directory (config.json + safetensors) onto
    ``device`` (default ``cuda``).  ``quantize=True`` streams each tensor
    through host-side int8 quantization (``convert_hf_state_dict``): the
    device holds only the int8 weights."""
    model_dir = pathlib.Path(model_dir)
    hf_cfg = json.loads((model_dir / "config.json").read_text())
    cfg = config_from_hf(hf_cfg, name=model_dir.name)
    if dtype:
        cfg = ModelConfig(**{**cfg.__dict__, "dtype": dtype})
    state = _SafetensorsDict(model_dir)
    return cfg, convert_hf_state_dict(state, cfg, dtype=dtype,
                                      quantize=quantize, device=device)


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
