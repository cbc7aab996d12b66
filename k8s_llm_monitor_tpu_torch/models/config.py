"""Model configurations for the decoder family.

A copy of the JAX package's ``models/config.py`` for what this port
serves: dense Llama-3 / Mistral / Qwen2 decoders, Mixtral's mixture of
experts (``num_experts``: dropless top-k routing at inference,
models/llama.py:_moe_mlp_dropless) and Gemma-2's extras (GeGLU, sandwich
norms, the unit-offset RMSNorm, attention and final logit soft caps, a
query scale, ``embed_scale`` and per-layer sliding windows).  ``dtype``
stays a string (``"bfloat16"`` / ``"float32"``); ``torch_dtype`` maps it.
``kv_dtype`` takes ``""``, the model's own dtype, ``"float8_e4m3fn"`` (the
unscaled fp8 pool, ROADMAP B8), ``"float8_e5m2"`` or ``"float16"``
(ROADMAP B9); the rest of B9 -- ``float32`` pages, ``bfloat16`` pages under
a float32 model -- raises ``NotImplementedError``.
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
    # Mixture-of-experts MLP (Mixtral family): > 0 replaces every layer's
    # SwiGLU with num_experts expert FFNs behind a top-k router.  Serving
    # runs every expert on every token and weighs them by the renormalized
    # top-k router probabilities (dropless, models/llama.py:
    # _moe_mlp_dropless); under a mesh each rank holds E/tp whole experts
    # (the expert axis rides ``model``, parallel/sharding.py).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # Per-expert token capacity of the JAX package's training dispatch
    # (``_moe_mlp``, ROADMAP A11); kept so the configs compare equal.
    capacity_factor: float = 1.25
    # --- Gemma-2 family knobs (defaults = Llama conventions) -----------
    # MLP activation: "silu" (SwiGLU) or "gelu_tanh" (Gemma GeGLU).
    mlp_activation: str = "silu"
    # Sandwich norms: an RMSNorm on the attention and MLP outputs
    # (post_attn_norm / post_mlp_norm) before each residual add; post_norm
    # plays Gemma's pre_feedforward role.
    sandwich_norms: bool = False
    # Gemma RMSNorm convention (effective scale = 1 + w); ops/norms.py.
    rmsnorm_unit_offset: bool = False
    # tanh soft caps (0 = off): attention logits and final logits.
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    # Query scale = query_pre_attn_scalar**-0.5 (None = head_dim**-0.5).
    query_pre_attn_scalar: Optional[float] = None
    # Multiply embeddings by sqrt(hidden_size), rounded to the dtype.
    embed_scale: bool = False
    # Sliding-window attention: the window (0 = global) and the per-layer
    # pattern ("sliding_attention" / "full_attention"; None = every layer
    # slides when sliding_window > 0).
    sliding_window: int = 0
    layer_types: Optional[tuple] = None

    def __post_init__(self):
        if self.kv_dtype not in ("", self.dtype) + UNSCALED_KV_DTYPES:
            raise NotImplementedError(
                f"{self.name}: kv_dtype {self.kv_dtype!r} is not ported "
                "(ROADMAP B9: float32 pages, and bfloat16 pages under a "
                "float32 model); the port takes '', the model dtype "
                f"{self.dtype!r} or one of {UNSCALED_KV_DTYPES}")

    @property
    def attn_scale(self) -> Optional[float]:
        """Explicit query scale, or None for the default head_dim**-0.5."""
        if self.query_pre_attn_scalar is not None:
            return float(self.query_pre_attn_scalar) ** -0.5
        return None

    def layer_window(self, i: int) -> int:
        """Sliding-window size of layer ``i`` (0 = global attention)."""
        if self.sliding_window <= 0:
            return 0
        if self.layer_types is not None:
            return (self.sliding_window
                    if self.layer_types[i] == "sliding_attention" else 0)
        return self.sliding_window

    @property
    def has_attn_extras(self) -> bool:
        """True when attention needs non-Llama parameters (query scale,
        logit softcap, sliding window): such models prefill dense and
        decode through the gather, as the JAX package selects
        (ops/attention.py)."""
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

# 8 experts so the expert axis divides TP-8 like the production MoE preset.
TINY_MOE = ModelConfig(name="tiny-moe", num_experts=8, num_experts_per_tok=2)

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

# Mixtral-8x7B: Mistral-7B's attention (32/8 heads, head_dim 128) over 8
# SwiGLU experts a layer, 2 routed per token; 46.7 B parameters, more than
# one 80 GB card holds in bf16.
MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b",
    vocab_size=32_000,
    hidden_size=4096,
    intermediate_size=14_336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
    num_experts=8,
    num_experts_per_tok=2,
)


def gemma2_layer_types(n_layers: int) -> tuple:
    """Gemma-2's attention pattern: alternating sliding/full, sliding
    first; shared by the presets and the HF-config fallback
    (utils/checkpoint.py)."""
    return tuple("sliding_attention" if i % 2 == 0 else "full_attention"
                 for i in range(n_layers))


def _gemma2(name: str, *, hidden: int, inter: int, layers: int, heads: int,
            kv: int, qpas: float) -> ModelConfig:
    return ModelConfig(
        name=name,
        vocab_size=256_000,
        hidden_size=hidden,
        intermediate_size=inter,
        num_layers=layers,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=256,
        rope_theta=10_000.0,
        rms_norm_eps=1e-6,
        max_seq_len=8192,
        tie_embeddings=True,
        mlp_activation="gelu_tanh",
        sandwich_norms=True,
        rmsnorm_unit_offset=True,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        query_pre_attn_scalar=qpas,
        embed_scale=True,
        sliding_window=4096,
        layer_types=gemma2_layer_types(layers),
    )


GEMMA2_2B = _gemma2("gemma2-2b", hidden=2304, inter=9216, layers=26,
                    heads=8, kv=4, qpas=256.0)
GEMMA2_9B = _gemma2("gemma2-9b", hidden=3584, inter=14_336, layers=42,
                    heads=16, kv=8, qpas=256.0)

PRESETS = {c.name: c for c in [TINY, TINY_QWEN, TINY_MOE, LLAMA3_8B,
                               LLAMA3_70B, MISTRAL_7B, MIXTRAL_8X7B, QWEN2_7B,
                               QWEN2_72B, GEMMA2_2B, GEMMA2_9B, LLAMA_1B]}
