"""Model configurations for the Llama/Qwen2-family decoder.

A copy of the JAX package's ``models/config.py`` restricted to what this
port runs: dense Llama-3 / Mistral / Qwen2 decoders.  ``dtype`` stays a
string (``"bfloat16"`` / ``"float32"``); ``torch_dtype`` maps it.  The Gemma-2
knobs survive only as far as ``has_attn_extras`` needs them, so a config
asking for them is refused (models/llama.py:LlamaModel) instead of
silently served without them.  ``kv_dtype`` takes ``""``, the model's own
dtype, ``"float8_e4m3fn"`` (the unscaled fp8 pool, ROADMAP B8),
``"float8_e5m2"`` or ``"float16"`` (ROADMAP B9); the rest of B9 --
``float32`` pages, ``bfloat16`` pages under a float32 model -- raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


# Page dtypes of an unscaled pool other than the model's own: the kernels
# have an instance for each (csrc/*.cu, symbol suffixes e4m3 / e5m2 / f16).
UNSCALED_KV_DTYPES = ("float8_e4m3fn", "float8_e5m2", "float16")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a Llama/Qwen2-family decoder LM.

    Llama-3: GQA, RoPE (high theta), SwiGLU MLP, RMSNorm, no biases.
    Qwen2: the same skeleton plus QKV projection biases.
    """

    name: str = "tiny"
    vocab_size: int = 256
    hidden_size: int = 64
    intermediate_size: int = 128
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    rope_theta: float = 500_000.0
    # HF-style rope_scaling dict ({"rope_type": "llama3", "factor": 8.0, ...}
    # or {"rope_type": "linear", "factor": f}); None = unscaled.
    rope_scaling: Optional[dict] = None
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 8192
    qkv_bias: bool = False          # True for Qwen2
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # KV cache dtype ('' = same as dtype).  "float8_e4m3fn" (or
    # "float8_e5m2") halves the KV pool and the decode-attention DMA
    # traffic; "float16" pages keep bf16's bytes; Q stays bf16 and the
    # kernel/softmax run f32, so logits track the bf16-KV model closely
    # (tested).  Opt-in: accuracy headroom is workload-dependent.
    kv_dtype: str = ""
    # W8A8: dynamically quantize activations (per-token symmetric int8) at
    # every linear so the matmul runs s8 x s8 with int32 sums
    # (models/llama.py:_linear, torch._int_mm).  Requires int8 weights
    # (utils/quantize.py); a model built with it on bf16 weights raises.
    # Attention, norms, residuals and the vocab projection stay in dtype.
    act_quant: bool = False
    # Gemma RMSNorm convention (effective scale = 1 + w); ops/norms.py.
    rmsnorm_unit_offset: bool = False
    # Gemma-2 attention extras; not served by this port (has_attn_extras).
    attn_logit_softcap: float = 0.0
    query_pre_attn_scalar: Optional[float] = None
    sliding_window: int = 0

    def __post_init__(self):
        if self.kv_dtype not in ("", self.dtype) + UNSCALED_KV_DTYPES:
            raise NotImplementedError(
                f"{self.name}: kv_dtype {self.kv_dtype!r} is not ported "
                "(ROADMAP B9: float32 pages, and bfloat16 pages under a "
                "float32 model); the port takes '', the model dtype "
                f"{self.dtype!r} or one of {UNSCALED_KV_DTYPES}")

    @property
    def has_attn_extras(self) -> bool:
        """True when attention needs non-Llama parameters (query scale,
        logit softcap, sliding window); the kernel selection refuses such
        models (ops/attention.py)."""
        return bool(self.attn_logit_softcap or self.sliding_window
                    or self.query_pre_attn_scalar is not None)

    @property
    def head_dim_(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.hidden_size // self.num_heads)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def torch_kv_dtype(self) -> torch.dtype:
        """The unquantized pool's page dtype: ``kv_dtype`` or the model's."""
        return getattr(torch, self.kv_dtype or self.dtype)


TINY = ModelConfig(name="tiny")

TINY_QWEN = ModelConfig(name="tiny-qwen", qkv_bias=True)

LLAMA3_8B = ModelConfig(
    name="llama3-8b",
    vocab_size=128_256,
    hidden_size=4096,
    intermediate_size=14_336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    rope_theta=500_000.0,
    max_seq_len=8192,
)

# ~1.1B single-chip benchmark config (head_dim 64).
LLAMA_1B = ModelConfig(
    name="llama-1b",
    vocab_size=128_256,
    hidden_size=2048,
    intermediate_size=8192,
    num_layers=16,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    rope_theta=500_000.0,
    max_seq_len=8192,
)

# Mistral-7B (v0.3+: no sliding window, full GQA): the Llama-3 skeleton
# with a 32k vocab and theta 1e6; loads from HF safetensors through the
# same key map (utils/checkpoint.py).
MISTRAL_7B = ModelConfig(
    name="mistral-7b",
    vocab_size=32_768,
    hidden_size=4096,
    intermediate_size=14_336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
)

# Qwen2-7B: 28 query heads over 4 kv heads (7 per kv head), QKV biases.
QWEN2_7B = ModelConfig(
    name="qwen2-7b",
    vocab_size=152_064,
    hidden_size=3584,
    intermediate_size=18_944,
    num_layers=28,
    num_heads=28,
    num_kv_heads=4,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
    qkv_bias=True,
)

# The 70B-class presets (A7): neither fits one 80 GB card in bf16, so they
# are served on a mesh (parallel/mesh.py).
LLAMA3_70B = ModelConfig(
    name="llama3-70b",
    vocab_size=128_256,
    hidden_size=8192,
    intermediate_size=28_672,
    num_layers=80,
    num_heads=64,
    num_kv_heads=8,
    rope_theta=500_000.0,
    max_seq_len=8192,
)

QWEN2_72B = ModelConfig(
    name="qwen2-72b",
    vocab_size=152_064,
    hidden_size=8192,
    intermediate_size=29_568,
    num_layers=80,
    num_heads=64,
    num_kv_heads=8,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
    qkv_bias=True,
)

PRESETS = {c.name: c for c in [TINY, TINY_QWEN, LLAMA3_8B, LLAMA3_70B,
                               MISTRAL_7B, QWEN2_7B, QWEN2_72B, LLAMA_1B]}
