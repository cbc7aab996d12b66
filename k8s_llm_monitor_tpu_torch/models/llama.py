"""Llama-3 / Qwen2 / Mixtral / Gemma-2-family decoder LM in PyTorch.

``LlamaModel`` is an ``nn.Module`` holding the weights; the forward passes
are module-level functions named as in the JAX package
(``forward_full``, ``prefill``, ``prefill_chunk``, ``verify_step``,
``decode_step``) so each
has an obvious counterpart.  Weights follow ``nn.Linear``'s ``[out, in]``
convention; convert.py is the one place the JAX ``[in, out]`` kernels are
transposed.  An int8 model (``LlamaModel(quantized=True)``) holds
``QuantLinear`` / ``QuantEmbedding`` codes and scales in the same layout;
``_linear`` runs them weight-only or, under ``cfg.act_quant``, as W8A8.

A mixture-of-experts layer (``cfg.num_experts``, Mixtral) holds a bf16
``router`` and stacked expert kernels ``gate_e`` / ``up_e`` / ``down_e``
(``ExpertStack``: ``[E, in, out]``, the JAX package's layout) and serves
dropless (``_moe_mlp_dropless``).  Gemma-2's extras (a query scale, the
attention logit cap, per-layer sliding windows) reach the plain attention
of the dense and gather paths, the only paths such a model takes, as in
the JAX package; its GeGLU, sandwich norms, ``embed_scale`` and final
logit cap live in ``_mlp_act``, ``_residual_tail``, ``_embed_lookup`` and
``_unembed``.

Tensor parallelism (``LlamaModel(..., mesh=)``, parallel/mesh.py): each
rank holds its shard of the weights (parallel/sharding.py: column-parallel
q/k/v/gate/up/lm_head, row-parallel o/down, a vocab-parallel embedding) and
runs the same forward on its local heads.  The forward passes run the
collectives the JAX package leaves to GSPMD: an all-reduce after o and
down (``row_parallel_partial``: under W8A8 a max of the activation amax
over the ranks and a sum of the int32 partials before the float scales, so
the product is TP-1's exactly), a masked embedding lookup summed over the
ranks, and an all-gather of the vocab-parallel logits, which end
replicated.  A mixture of experts shards its expert axis instead of the
FFN: each rank runs the dropless MLP of its ``E / tp`` whole experts on
the replicated activations, and the combine over E is a partial sum
all-reduced like a row projection's.  When the degree does not divide the kv heads the pages
replicate: k/v are all-gathered after their (column-parallel) projection
and each local query head reads its kv head of the full pool.

Sequence-sharded prefill (a mesh with ``seq`` > 1; the JAX engine places
prefill token batches sharded over ``seq`` and GSPMD splits the work):
in each fresh, chunk or prefix-hit round of ``[B, S]`` tokens, seq rank
``j`` embeds, projects and ropes its slice of positions ``[j S/s, (j+1)
S/s)``; each layer's chunk K/V is all-gathered over the seq group before
the scatter, so every seq rank's pages hold the whole chunk (pages are
seq-replicated and model-sharded, as JAX's kv specs are); attention runs
on the slice's queries (flash prefill with the slice's start and clamped
lengths); the row-parallel o and down run over the model group; the last
valid token's hidden row comes from the seq rank that holds it through a
masked sum over the seq group, so the logits end replicated.  Decode and
verify stay replicated over ``seq`` (and ``data``).

The paged KV cache is one ``[num_blocks, block_size, kv_heads * head_dim]``
tensor per layer for K and for V (kv-head-major fused rows), block 0 the
null block that masked lanes write to.  Where the JAX package donates the
page arrays to a jitted program and gets new ones back, this port updates
them in place: ``_scatter_pages``, ``_scatter_pages_quant`` and the fused
decode kernels write into the tensors they are given (pages, and scale
planes of an int8/fp8 pool) and return the same tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.ops.attention import (
    causal_attention,
    gather_dequant,
    gather_pages,
    paged_decode_attention_quant,
    widen_pages,
)
from k8s_llm_monitor_tpu_torch.ops.norms import rms_norm
from k8s_llm_monitor_tpu_torch.ops.rope import apply_rope, rope_angles
from k8s_llm_monitor_tpu_torch.parallel.sharding import (
    check_tp,
    local_kv_heads,
    param_partition_specs,
    shard_tensor,
)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    one.  Without a GPU the caller must ask for the CPU explicitly."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass
class KVPages:
    """Paged KV cache: per-layer page tensors
    ``k[i], v[i]: [num_blocks, block_size, kv_heads * head_dim]``.

    A quantized pool (``kv_quant`` "int8"/"fp8") holds 1-byte codes in the
    pages plus per-(token, head) float32 scales
    ``k_scale[i], v_scale[i]: [num_blocks, block_size, kv_heads]``; an
    unquantized pool leaves the scale lists empty."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    k_scale: list[torch.Tensor] = dataclasses.field(default_factory=list)
    v_scale: list[torch.Tensor] = dataclasses.field(default_factory=list)

    @property
    def num_blocks(self) -> int:
        return self.k[0].shape[0]

    @property
    def block_size(self) -> int:
        return self.k[0].shape[1]

    @property
    def quantized(self) -> bool:
        return len(self.k_scale) > 0

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.k + self.v + self.k_scale + self.v_scale)


# e4m3fn's largest finite value is 448; the next code up is NaN, so values
# past the midpoint 464 round to NaN.
_E4M3_ROUND_MAX = 464.0


def cast_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float8_e4m3fn with ``jnp.astype``'s semantics: round to
    nearest even from ``x``'s own dtype, and NaN (with ``x``'s sign) past
    +-464, for infinities and for NaN.  ``.to(torch.float8_e4m3fn)``
    saturates to +-448 there instead.  The codes are made through a uint8
    view, with no host round trip, so the cast can run inside a captured
    CUDA graph."""
    xf = x.float()
    ok = xf.abs() <= _E4M3_ROUND_MAX          # False for NaN
    codes = torch.where(ok, xf, 0.0).to(torch.float8_e4m3fn).view(torch.uint8)
    nan = (torch.signbit(xf).to(torch.uint8) << 7) | 0x7F
    return torch.where(ok, codes, nan).view(torch.float8_e4m3fn)


def cast_e5m2(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float8_e5m2 with ``jnp.astype``'s semantics from float32:
    round to nearest even, 0x7B (57344) up to 61439, infinity from 61440
    on (``.to(torch.float8_e5m2)`` agrees there), and NaN as 0x7E with
    ``x``'s sign, where torch writes 0x7F.  (XLA's CPU conversion from
    bfloat16 writes 0x7F for every NaN; this cast, like the kernels,
    converts through float32.)  Made through a uint8 view, as
    ``cast_e4m3``."""
    xf = x.float()
    codes = xf.to(torch.float8_e5m2).view(torch.uint8)
    nan = (torch.signbit(xf).to(torch.uint8) << 7) | 0x7E
    return torch.where(torch.isnan(xf), nan, codes).view(torch.float8_e5m2)


# The page writes that need jnp's conversion rather than torch's.
_JNP_CASTS = {torch.float8_e4m3fn: cast_e4m3, torch.float8_e5m2: cast_e5m2}


def kv_quant_spec(kv_quant: str) -> tuple[torch.dtype, float]:
    """(storage dtype, qmax) of a KV quantization mode: ``int8`` codes
    round and clip at 127, ``fp8`` (float8_e4m3fn) saturates at 448."""
    if kv_quant == "fp8":
        return torch.float8_e4m3fn, 448.0
    if kv_quant == "int8":
        return torch.int8, 127.0
    raise ValueError(f"unknown kv_quant {kv_quant!r} (int8 | fp8)")


def _qmax_for(dtype: torch.dtype) -> float:
    return 127.0 if dtype == torch.int8 else 448.0


def _quantize_heads(xf: torch.Tensor, qmax: float, is_int8: bool):
    """Symmetric per-head quantization of float32 ``xf [..., D]``: returns
    (codes as float32 before the storage cast, scale [...]).

    Division by the scale, not a reciprocal multiply, and round half to
    even, as the JAX package does: either change moves codes at ties.
    ``qmax`` divides as a tensor on ``amax``'s device: PyTorch on CUDA
    turns division by a Python number (or a CPU scalar) into a multiply by
    its reciprocal, one ulp off the quotient for some amax.  ``new_full``
    fills it on the device, with no host-to-device copy to wait for."""
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / amax.new_full((), qmax), min=1e-8)
    xq = xf / scale[..., None]
    if is_int8:
        xq = torch.clamp(torch.round(xq), -qmax, qmax)
    return xq, scale


def quantize_kv(x: torch.Tensor, num_kv_heads: int, qdtype: torch.dtype,
                qmax: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric quantization of fused-lane KV rows.

    x [..., KVH*D] -> (x_q [..., KVH*D] qdtype, scale [..., KVH] float32).
    int8 rounds and clips; fp8 casts (torch's cast saturates).
    """
    shp = x.shape
    xr = x.float().reshape(*shp[:-1], num_kv_heads, shp[-1] // num_kv_heads)
    xq, scale = _quantize_heads(xr, qmax, qdtype == torch.int8)
    return xq.to(qdtype).reshape(shp), scale


def dequantize_kv(x_q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_kv``: x_q [..., KVH*D] + scale [..., KVH]
    -> float rows [..., KVH*D]."""
    shp = x_q.shape
    KVH = scale.shape[-1]
    xr = x_q.float().reshape(*shp[:-1], KVH, shp[-1] // KVH)
    return (xr * scale[..., None]).reshape(shp).to(dtype)


def init_kv_pages(cfg: ModelConfig, num_blocks: int, block_size: int,
                  device, dtype: Optional[torch.dtype] = None,
                  kv_quant: str = "", tp: int = 1) -> KVPages:
    """Allocate the paged KV pool.  ``kv_quant`` ("int8"/"fp8") selects the
    quantized tier: pages in the storage dtype plus float32 scale planes,
    whatever ``cfg.kv_dtype`` says.  "" keeps pages in ``cfg.kv_dtype``
    when it is set (float8_e4m3fn / float8_e5m2 / float16: an unscaled
    pool other than the model dtype), else in
    ``dtype`` (default: the model's).  At TP degree ``tp`` a rank's pool
    holds its kv-head slice of every page (all heads when the degree does
    not divide them: parallel/sharding.py)."""
    kvh = local_kv_heads(cfg.num_kv_heads, tp)
    shape = (num_blocks, block_size, kvh * cfg.head_dim_)

    def planes(shp, dt):
        return [torch.zeros(shp, dtype=dt, device=device)
                for _ in range(cfg.num_layers)]

    if kv_quant:
        qdtype, _ = kv_quant_spec(kv_quant)
        sshape = (num_blocks, block_size, kvh)
        return KVPages(k=planes(shape, qdtype), v=planes(shape, qdtype),
                       k_scale=planes(sshape, torch.float32),
                       v_scale=planes(sshape, torch.float32))
    dtype = cfg.torch_kv_dtype if cfg.kv_dtype else (dtype or cfg.torch_dtype)
    return KVPages(k=planes(shape, dtype), v=planes(shape, dtype))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


class QuantLinear(nn.Module):
    """Weight-only int8 linear in ``nn.Linear``'s layout: codes ``weight_q``
    int8 [out, in] and float32 per-output-channel scales ``scale`` [out]
    (utils/quantize.py), with an optional ``bias`` [out] in the model
    dtype.  The counterpart of the JAX package's ``{"kernel_q", "scale"}``
    leaves, transposed."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 device, dtype):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight_q", torch.zeros(
            out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if bias else None)


class QuantEmbedding(nn.Module):
    """int8 embedding table: codes ``weight_q`` [vocab, H] and float32
    per-row scales ``scale`` [vocab]."""

    def __init__(self, num_embeddings: int, embedding_dim: int, device):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(
            num_embeddings, embedding_dim, dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            num_embeddings, dtype=torch.float32, device=device))


def _linear_module(quantized: bool, in_f: int, out_f: int, bias: bool, kw):
    if quantized:
        return QuantLinear(in_f, out_f, bias, **kw)
    return nn.Linear(in_f, out_f, bias=bias, **kw)


class ExpertStack(nn.Module):
    """Stacked expert kernels of one projection in the JAX package's
    ``[E, in, out]`` layout (``E`` the rank's local experts): ``kernel`` in
    the model dtype, or the int8 twin's codes ``kernel_q`` [E, in, out] and
    float32 per-(expert, out-channel) scales ``scale`` [E, out]
    (utils/quantize.py:fill_quantized_experts).  The codes are stored
    ``in``-contiguous (an [E, out, in] tensor transposed): each expert's
    ``kernel_q[e].t()`` is then the [out, in] operand ``torch._int_mm``
    takes without a copy, as ``QuantLinear.weight_q`` is."""

    def __init__(self, num_experts: int, in_features: int,
                 out_features: int, quantized: bool, device, dtype):
        super().__init__()
        self.num_experts = num_experts
        self.in_features, self.out_features = in_features, out_features
        if quantized:
            self.register_buffer("kernel_q", torch.zeros(
                num_experts, out_features, in_features, dtype=torch.int8,
                device=device).transpose(1, 2))
            self.register_buffer("scale", torch.ones(
                num_experts, out_features, dtype=torch.float32,
                device=device))
        else:
            self.kernel = nn.Parameter(torch.empty(
                num_experts, in_features, out_features, device=device,
                dtype=dtype))

    @property
    def quantized(self) -> bool:
        return hasattr(self, "kernel_q")


class LlamaLayer(nn.Module):
    """One decoder layer's weights; at TP degree ``tp`` the rank's shard
    (out_features of q/k/v/gate/up and in_features of o/down split; a
    mixture of experts splits its expert axis, the router replicated).
    Sandwich norms add ``post_attn_norm`` and ``post_mlp_norm``.  Norms
    start at the identity: ones, or zeros under the unit-offset
    convention."""

    def __init__(self, cfg: ModelConfig, device, dtype,
                 quantized: bool = False, tp: int = 1):
        super().__init__()
        H, D = cfg.hidden_size, cfg.head_dim_
        nH, inter = cfg.num_heads // tp, cfg.intermediate_size // tp
        kw = dict(device=device, dtype=dtype)
        norm = torch.zeros if cfg.rmsnorm_unit_offset else torch.ones
        self.input_norm = nn.Parameter(norm(H, **kw))
        self.post_norm = nn.Parameter(norm(H, **kw))
        if cfg.sandwich_norms:
            self.post_attn_norm = nn.Parameter(norm(H, **kw))
            self.post_mlp_norm = nn.Parameter(norm(H, **kw))

        def lin(in_f, out_f, bias=False):
            return _linear_module(quantized, in_f, out_f, bias, kw)

        self.q = lin(H, nH * D, cfg.qkv_bias)
        kv_out = cfg.num_kv_heads * D // tp
        self.k = lin(H, kv_out, cfg.qkv_bias)
        self.v = lin(H, kv_out, cfg.qkv_bias)
        self.o = lin(nH * D, H)
        if cfg.num_experts > 0:
            # The router stays in the model dtype under int8 (the JAX
            # package's rule: tiny, and routing decisions are sensitive).
            E, I = cfg.num_experts // tp, cfg.intermediate_size
            self.router = nn.Linear(H, cfg.num_experts, bias=False, **kw)
            self.gate_e = ExpertStack(E, H, I, quantized, **kw)
            self.up_e = ExpertStack(E, H, I, quantized, **kw)
            self.down_e = ExpertStack(E, I, H, quantized, **kw)
        else:
            self.gate = lin(H, inter)
            self.up = lin(H, inter)
            self.down = lin(inter, H)


class LlamaModel(nn.Module):
    """Decoder weights on ``device`` (default ``cuda``; see
    ``resolve_device``) in ``dtype`` (default ``cfg.dtype``), the dtype of
    the activations.

    ``seed`` draws random weights from a ``torch.Generator`` on the device,
    with the JAX package's ``init_params`` distribution (normals scaled by
    ``in_features**-0.5``, embeddings by 0.02, unit norms, zero biases);
    ``seed=None`` leaves the weights for the caller to fill
    (convert.py:params_from_jax, utils/checkpoint.py).

    ``quantized=True`` builds the int8 twin: ``QuantLinear`` and
    ``QuantEmbedding`` in place of ``nn.Linear`` and ``nn.Embedding``,
    filled by utils/quantize.py (``quantize_params``,
    ``init_params_quantized``) or a checkpoint, never from ``seed``.
    ``cfg.act_quant`` (W8A8) needs it: where the JAX package warns and runs
    the bf16 matmuls, this raises.

    ``mesh`` (parallel/mesh.py) builds the rank's shard on the mesh's
    device.  The seeded draws are TP-1's: each full tensor is drawn and the
    rank keeps its slice, so a TP-N model holds the TP-1 model's weights.
    On rank 0 a seeded build is sent to the workers, which build theirs.
    """

    def __init__(self, cfg: ModelConfig, device=None,
                 dtype: Optional[torch.dtype] = None, seed: Optional[int] = 0,
                 quantized: bool = False, mesh=None):
        super().__init__()
        tp = mesh.tp if mesh is not None else 1
        why = check_tp(cfg, tp)
        if why:
            raise ValueError(f"{cfg.name}: {why}")
        if cfg.act_quant and not quantized:
            raise ValueError(f"{cfg.name}: act_quant (W8A8) needs int8 "
                             "weights (utils/quantize.py)")
        if quantized and seed is not None:
            raise ValueError("a quantized model is filled by "
                             "utils/quantize.py or a checkpoint: pass "
                             "seed=None")
        if mesh is not None and device is None:
            device = mesh.device
        # "meta": the TP-1 shapes of full_meta(), nothing allocated.
        device = (torch.device("meta") if str(device) == "meta"
                  else resolve_device(device))
        if mesh is not None and device != mesh.device:
            raise ValueError(f"the mesh's rank {mesh.rank} runs on "
                             f"{mesh.device}, not {device}")
        dtype = dtype or cfg.torch_dtype
        self.cfg = cfg
        self.dtype = dtype
        self.quantized = quantized
        # A mesh of more than one rank; ``tp`` is its model degree, ``rank``
        # this rank's model coordinate (the shard it holds), ``sp`` the seq
        # degree its prefill rounds split over.
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.tp = tp
        self.rank = mesh.model_rank if self.mesh is not None else 0
        self.sp = mesh.sp if self.mesh is not None else 1
        self.seq_rank = mesh.seq_rank if self.mesh is not None else 0
        # Local heads; with the pages replicated, the kv head each local
        # query head reads.
        self.n_heads = cfg.num_heads // tp
        self.n_kv_heads = local_kv_heads(cfg.num_kv_heads, tp)
        self.kv_gather = tp > 1 and self.n_kv_heads == cfg.num_kv_heads
        self.kv_index = None
        if self.kv_gather:
            self.kv_index = ((self.rank * self.n_heads + torch.arange(
                self.n_heads)) // cfg.q_per_kv).to(device)
        kw = dict(device=device, dtype=dtype)
        V = cfg.vocab_size // tp
        self.embed = (QuantEmbedding(V, cfg.hidden_size, device)
                      if quantized else
                      nn.Embedding(V, cfg.hidden_size, **kw))
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, device, dtype, quantized, tp)
            for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(
            (torch.zeros if cfg.rmsnorm_unit_offset else torch.ones)(
                cfg.hidden_size, **kw))
        self.lm_head = (None if cfg.tie_embeddings else _linear_module(
            quantized, cfg.hidden_size, V, False, kw))
        self.requires_grad_(False)
        # The workers' copy of this model (rank 0 of a mesh).
        self.mesh_token = 0
        if seed is not None:
            self.init_weights(seed)
            if self.mesh is not None and mesh.is_leader:
                self.mesh_token = mesh.build_on_workers(
                    "llama", cfg, dtype=dtype, seed=seed)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def check_current(self) -> None:
        """Raise unless the mesh's workers hold this model (rank 0)."""
        if (self.mesh is not None and self.mesh.is_leader
                and self.mesh_token != self.mesh.model_token):
            raise RuntimeError(
                f"{self.cfg.name}: the mesh's workers hold another model "
                "(one model lives on a mesh at a time)")

    def full_meta(self) -> "LlamaModel":
        """The TP-1 model's shapes, on the meta device."""
        return LlamaModel(self.cfg, device="meta", dtype=self.dtype,
                          seed=None, quantized=self.quantized)

    @torch.no_grad()
    def fill_from_full(self, make_full) -> None:
        """Fill every parameter and buffer with the rank's slice of the TP-1
        tensor ``make_full(name, meta_tensor)`` returns (None leaves it),
        one full tensor at a time and in ``named_parameters`` order, then
        ``named_buffers`` order."""
        meta = self.full_meta()
        specs = param_partition_specs(meta)
        local = dict(self.named_parameters()) | dict(self.named_buffers())
        for name, t in (list(meta.named_parameters())
                        + list(meta.named_buffers())):
            full = make_full(name, t)
            if full is not None:
                local[name].copy_(shard_tensor(full, specs[name], self.rank,
                                               self.tp))

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """The seeded draws: the embedding (std 0.02), then every linear
        (the router included) and expert stack in module order, each a
        normal of std ``in_features**-0.5``; zero biases; norms at the
        identity (``norm_fill``)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.tp > 1:
            # TP-1's draws in TP-1's order, each full tensor sliced.
            meta = self.full_meta()
            fan_in = {n + suffix: m.in_features
                      for n, m in meta.named_modules()
                      for suffix, kind in ((".weight", nn.Linear),
                                           (".kernel", ExpertStack))
                      if isinstance(m, kind)}

            def draw(name, t):
                if name == "embed.weight":
                    std = 0.02
                elif name in fan_in:
                    std = fan_in[name] ** -0.5
                elif name.endswith("bias"):
                    return torch.zeros(t.shape, dtype=t.dtype,
                                       device=self.device)
                else:
                    return torch.full(t.shape, self.norm_fill(),
                                      dtype=t.dtype, device=self.device)
                return torch.empty(t.shape, dtype=t.dtype,
                                   device=self.device).normal_(
                    0.0, std, generator=gen)

            self.fill_from_full(draw)
            return
        self.embed.weight.normal_(0.0, 0.02, generator=gen)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, ExpertStack):
                m.kernel.normal_(0.0, m.in_features ** -0.5, generator=gen)
        for name, p in self.named_parameters():
            if name.endswith("norm"):
                p.fill_(self.norm_fill())

    def norm_fill(self) -> float:
        """A norm weight's identity: 1, or 0 under the unit offset."""
        return 0.0 if self.cfg.rmsnorm_unit_offset else 1.0

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward_full(self, tokens)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


# cuBLASLt's int8 GEMM behind torch._int_mm on CUDA takes more than 16 rows.
_INT_MM_MIN_ROWS = 17


def _quant_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric int8: (x_q int8, scale f32 [..., 1]).

    Division by the scale, and of amax by 127 as a tensor on its device
    (PyTorch on CUDA turns division by a Python number into a multiply by
    the reciprocal, see ``_quantize_heads``); round half to even, clip at
    127, as the JAX package's ``_quant_act``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / amax.new_full((), 127.0), min=1e-8)
    x_q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_q, scale


def _int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """x_q [..., in] int8 times w_q [out, in] int8 transposed, summed in
    int32 (exact): ``torch._int_mm``, the counterpart of the JAX package's
    ``dot_general(..., preferred_element_type=int32)``.  Calls of 16 rows
    or fewer (decode at small batch) are padded with zero rows to the 17
    the CUDA kernel takes, and sliced back."""
    lead, k = x_q.shape[:-1], x_q.shape[-1]
    rows = x_q.reshape(-1, k)
    m = rows.shape[0]
    if m < _INT_MM_MIN_ROWS:
        rows = F.pad(rows, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    y = torch._int_mm(rows, w_q.t())
    return y[:m].reshape(*lead, w_q.shape[0])


def _linear(lin: nn.Module, x: torch.Tensor,
            act_quant: bool = False) -> torch.Tensor:
    """x @ W^T (+ bias) for an ``nn.Linear`` or a ``QuantLinear``.

    Weight-only int8: the per-output-channel scale commutes with the
    contraction, so it multiplies the [.., out] result, in x's dtype.  W8A8
    (``act_quant``, int8 weights only): per-token int8 activations, an
    int32 product, then ``(y32 * x_scale) * w_scale`` in float32, cast to
    x's dtype, the JAX package's order."""
    if isinstance(lin, nn.Linear):
        return F.linear(x, lin.weight, lin.bias)
    if act_quant:
        x_q, xs = _quant_act(x)
        y32 = _int8_matmul(x_q, lin.weight_q)
        y = ((y32.float() * xs) * lin.scale).to(x.dtype)
    else:
        y = F.linear(x, lin.weight_q.to(x.dtype)) * lin.scale.to(x.dtype)
    if lin.bias is not None:
        y = y + lin.bias
    return y


def row_parallel_partial(lin: nn.Module, x: torch.Tensor, act_quant: bool,
                         mesh):
    """The rank's half of a row-parallel ``_linear`` (the JAX package's
    ``row_parallel_partial``): returns ``(partial, finish)``, the rank's
    un-reduced [..., out] contribution and the map from the reduced (or
    reduce-scattered: the rank's chunk of the out dim) sum back to x's
    dtype.

    W8A8: the per-token amax is the max over the ranks' slices of the
    contraction dim (max is exact in any order), and the int32 partials
    are summed before the float scales apply, in ``_linear``'s order, so
    the result is TP-1's bit for bit.  Weight-only int8: the per-out-channel
    scale commutes with the sum and applies after it.  Row projections
    carry no bias in the supported families: one would be added once per
    rank."""
    if lin.bias is not None:
        raise ValueError("a row-parallel projection with a bias")
    if isinstance(lin, nn.Linear):
        return F.linear(x, lin.weight), lambda y: y

    def chunk(vec, n):
        return vec if vec.shape[0] == n else vec.narrow(
            0, mesh.model_rank * n, n)

    if act_quant:
        xf = x.float()
        amax = mesh.all_reduce(xf.abs().amax(dim=-1, keepdim=True), "max")
        scale = torch.clamp(amax / amax.new_full((), 127.0), min=1e-8)
        x_q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        part = _int8_matmul(x_q, lin.weight_q)

        def finish(y):
            ws = chunk(lin.scale, y.shape[-1])
            return ((y.float() * scale) * ws).to(x.dtype)
        return part, finish
    part = F.linear(x, lin.weight_q.to(x.dtype))
    return part, lambda y: y * chunk(lin.scale, y.shape[-1]).to(y.dtype)


def _row(model: LlamaModel, lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel projection (o, down): ``_linear`` on one rank, the
    partial summed over the ranks under a mesh (the reference schedule)."""
    aq = model.cfg.act_quant
    if model.tp == 1:
        return _linear(lin, x, aq)
    part, finish = row_parallel_partial(lin, x, aq, model.mesh)
    return finish(model.mesh.all_reduce(part))


def _embed_lookup(model: LlamaModel, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup; an int8 table's rows are dequantized in the
    model dtype (codes, then times the row scale), as the JAX package
    does.  Vocab-parallel under a mesh: each rank looks up the tokens of
    its vocab slice, zeros the rest, and the rows are summed over the
    ranks (exact: one rank contributes each row)."""
    t = tokens.long()
    mesh = model.mesh if model.tp > 1 else None
    if mesh is not None:
        V = model.embed.weight_q.shape[0] if model.quantized else \
            model.embed.weight.shape[0]
        t = t - model.rank * V
        mine = (t >= 0) & (t < V)
        t = torch.where(mine, t, torch.zeros_like(t))
    emb = model.embed
    if isinstance(emb, QuantEmbedding):
        dt = model.dtype
        rows = emb.weight_q[t].to(dt) * emb.scale[t][..., None].to(dt)
    else:
        rows = emb.weight[t]
    if mesh is not None:
        rows = mesh.all_reduce(torch.where(mine[..., None], rows,
                                           torch.zeros_like(rows)))
    if model.cfg.embed_scale:
        # Gemma: sqrt(H), rounded to the dtype first as the JAX package
        # does; ``torch.full`` fills it on the device (no host copy in a
        # captured graph).
        rows = rows * torch.full((), model.cfg.hidden_size ** 0.5,
                                 dtype=rows.dtype, device=rows.device)
    return rows


def _qkv_proj(model: LlamaModel, layer: LlamaLayer, x: torch.Tensor):
    """Projections only (no rope).  x [B, S, H] -> q [B, S, nH, D],
    k/v [B, S, nKV, D] over the rank's heads (k/v all-gathered to every
    head when the pages replicate).  The fused decode kernel ropes
    in-kernel."""
    cfg = model.cfg
    B, S, _ = x.shape
    D = cfg.head_dim_
    aq = cfg.act_quant
    q = _linear(layer.q, x, aq).reshape(B, S, model.n_heads, D)
    k = _linear(layer.k, x, aq)
    v = _linear(layer.v, x, aq)
    if model.kv_gather:
        k, v = model.mesh.all_gather(k), model.mesh.all_gather(v)
    return (q, k.reshape(B, S, model.n_kv_heads, D),
            v.reshape(B, S, model.n_kv_heads, D))


def _qkv(model: LlamaModel, layer: LlamaLayer, x: torch.Tensor, cos, sin):
    """Project + rope (ops/rope.py, f32)."""
    q, k, v = _qkv_proj(model, layer, x)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mlp_act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The gated MLP's activation: SiLU (SwiGLU) or Gemma's tanh GELU."""
    if cfg.mlp_activation == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def _expert_weights(stack: ExpertStack, e: int, dtype):
    """Expert ``e``'s kernel [in, out] for the weight-only product: the
    model-dtype kernel, or the int8 codes cast to ``dtype`` with their
    [out] scales (applied to the result: they commute with the
    contraction)."""
    if stack.quantized:
        return stack.kernel_q[e].to(dtype), stack.scale[e]
    return stack.kernel[e], None


def _expert_w8a8(x_q: torch.Tensor, x_s: torch.Tensor, stack: ExpertStack,
                 e: int, dtype) -> torch.Tensor:
    """Expert ``e``'s s8 x s8 product of per-token int8 activations
    (``_quant_act``), int32 sums, then ``(y32 * x_s) * w_scale`` in float32,
    cast to ``dtype``: ``_linear``'s W8A8 order with the (expert,
    out-channel) scale."""
    y32 = _int8_matmul(x_q, stack.kernel_q[e].t())
    return ((y32.float() * x_s) * stack.scale[e]).to(dtype)


def _moe_mlp_dropless(model: LlamaModel, layer: LlamaLayer,
                      x: torch.Tensor) -> torch.Tensor:
    """Dropless mixture of experts (the JAX package's
    ``_moe_mlp_dropless``): every token gets its full top-k experts.

    Softmax router (float32), top-k, the top-k weights renormalized and
    scattered back to [B, S, E] (zero for unchosen experts); every expert's
    SwiGLU runs on every token and the results are summed weighted by
    them, in float32, then cast to x's dtype.  The JAX package keeps E as
    an einsum axis; here an index loop runs each local expert in turn (a
    transient of one expert's [B, S, I], not E of them).  Under a mesh a
    rank holds ``E / tp`` whole experts: its loop covers them, on the
    replicated activations, and the float32 partial sum is all-reduced
    over the ranks like a row projection's.  An expert's int8 scale is
    per (expert, out channel), so a rank's scales are the whole model's
    sliced: no MAX all-reduce, unlike a row-parallel weight.  W8A8 (int8
    experts under ``cfg.act_quant``) quantizes the tokens once per layer
    and each expert's SwiGLU output per token, as the JAX package does."""
    cfg = model.cfg
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    dtype = x.dtype
    logits = _linear(layer.router, x)
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.topk(probs, K, dim=-1)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    w = torch.zeros_like(probs).scatter_(-1, topi, topv).to(dtype)
    n_local = layer.gate_e.num_experts
    first = model.rank * n_local
    w8a8 = cfg.act_quant and layer.gate_e.quantized
    if w8a8:
        x_q, x_s = _quant_act(x)
    y = None
    for e in range(n_local):
        if w8a8:
            gate = _expert_w8a8(x_q, x_s, layer.gate_e, e, dtype)
            up = _expert_w8a8(x_q, x_s, layer.up_e, e, dtype)
            h_q, h_s = _quant_act(F.silu(gate) * up)
            ys = _expert_w8a8(h_q, h_s, layer.down_e, e, dtype)
        else:
            gk, gs = _expert_weights(layer.gate_e, e, dtype)
            uk, us = _expert_weights(layer.up_e, e, dtype)
            dk, ds = _expert_weights(layer.down_e, e, dtype)
            gate, up = x @ gk, x @ uk
            if gs is not None:
                gate, up = gate * gs.to(dtype), up * us.to(dtype)
            ys = (F.silu(gate) * up) @ dk
            if ds is not None:
                ys = ys * ds.to(dtype)
        part = ys.float() * w[..., first + e:first + e + 1].float()
        y = part if y is None else y + part
    if model.tp > 1:
        y = model.mesh.all_reduce(y)
    return y.to(dtype)


def _mlp(model: LlamaModel, layer: LlamaLayer,
         x: torch.Tensor) -> torch.Tensor:
    """The gated MLP (gate/up column-parallel, down row-parallel), or the
    dropless mixture of experts."""
    cfg = model.cfg
    if cfg.num_experts > 0:
        return _moe_mlp_dropless(model, layer, x)
    aq = cfg.act_quant
    return _row(model, layer.down, _mlp_act(cfg, _linear(layer.gate, x, aq))
                * _linear(layer.up, x, aq))


def _residual_tail(model: LlamaModel, layer: LlamaLayer, x: torch.Tensor,
                   o: torch.Tensor) -> torch.Tensor:
    """The (sandwich-normed, under ``cfg.sandwich_norms``) attention
    residual, the pre-MLP norm, the MLP, and the (sandwich-normed) MLP
    residual: the one definition shared by layer_block, _prefill_impl and
    decode_step."""
    cfg = model.cfg
    eps, uo = cfg.rms_norm_eps, cfg.rmsnorm_unit_offset
    if cfg.sandwich_norms:
        o = rms_norm(o, layer.post_attn_norm, eps, uo)
    x = x + o
    y = _mlp(model, layer, rms_norm(x, layer.post_norm, eps, uo))
    if cfg.sandwich_norms:
        y = rms_norm(y, layer.post_mlp_norm, eps, uo)
    return x + y


def _attn_extras(cfg: ModelConfig, layer_idx: int) -> dict:
    """Layer ``layer_idx``'s attention kwargs for a Gemma-style model (the
    query scale, the logit cap, the window); {} for the Llama conventions,
    so the kernel wrappers never see them."""
    if not cfg.has_attn_extras:
        return {}
    return {"scale": cfg.attn_scale,
            "logit_softcap": cfg.attn_logit_softcap,
            "window": cfg.layer_window(layer_idx)}


def _unembed(model: LlamaModel, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the vocab projection, float32 logits.  The projection
    stays weight-only under ``act_quant``, tied or not: int8 noise on the
    pre-logits hidden state flips near-tied argmax (the JAX package's
    rule).  Under a mesh each rank projects onto its vocab slice and the
    logits are all-gathered (replicated on every rank).  Gemma's final
    soft cap ``cap * tanh(logits / cap)`` applies last, in float32."""
    cfg = model.cfg
    x = rms_norm(x, model.final_norm, cfg.rms_norm_eps,
                 cfg.rmsnorm_unit_offset)
    emb = model.embed
    if not cfg.tie_embeddings:
        logits = _linear(model.lm_head, x).float()
    elif isinstance(emb, QuantEmbedding):
        logits = (F.linear(x, emb.weight_q.to(x.dtype))
                  * emb.scale.to(x.dtype)).float()
    else:
        logits = F.linear(x, emb.weight).float()
    if model.tp > 1:
        logits = model.mesh.all_gather(logits, dim=-1)
    cap = cfg.final_logit_softcap
    if cap:
        logits = cap * torch.tanh(logits / cap)
    return logits


def _replicated_attention(model: LlamaModel, q, kk, vv, q_positions,
                          kv_len, **extras) -> torch.Tensor:
    """Attention of the rank's query heads over every kv head's K/V
    [B, T, KVH, D] (pages replicated): each local head reads its own kv
    head, then dense causal attention with one query head per kv head."""
    idx = model.kv_index
    return causal_attention(q, kk.index_select(2, idx), vv.index_select(2, idx),
                            q_positions=q_positions, kv_len=kv_len, **extras)


def is_fused_decode_impl(attn_impl) -> bool:
    """True for the fused decode calling convention (raw q/k/v + angles in,
    attention + updated pages out)."""
    return bool(getattr(attn_impl, "fused_decode", False))


def is_fused_quant_decode_impl(attn_impl) -> bool:
    """True for the quantized-pool fused decode kernel (takes and updates
    the scale planes).  A fused impl without this marker never touches a
    quantized pool: decode_step takes its gather/dequant branch instead."""
    return bool(getattr(attn_impl, "quant_kv", False))


def is_flash_prefill_impl(attn_impl) -> bool:
    """True for the flash paged-prefill calling convention."""
    return bool(getattr(attn_impl, "flash_prefill", False))


# ---------------------------------------------------------------------------
# Dense forward
# ---------------------------------------------------------------------------


def layer_block(model: LlamaModel, layer: LlamaLayer, x: torch.Tensor, cos,
                sin, positions: torch.Tensor,
                layer_idx: int = 0) -> torch.Tensor:
    """One transformer layer with dense causal attention; ``layer_idx``
    picks its sliding window (Gemma-2 alternates local and global)."""
    cfg = model.cfg
    B, S = x.shape[:2]
    h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps, cfg.rmsnorm_unit_offset)
    q, k, v = _qkv(model, layer, h, cos, sin)
    extras = _attn_extras(cfg, layer_idx)
    if model.kv_gather:
        attn = _replicated_attention(model, q, k, v, positions, None,
                                     **extras)
    else:
        attn = causal_attention(q, k, v, q_positions=positions, **extras)
    o = _row(model, layer.o, attn.reshape(B, S, -1))
    return _residual_tail(model, layer, x, o)


@torch.no_grad()
def forward_full(model: LlamaModel, tokens: torch.Tensor, *,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense causal forward.  tokens [B, S] -> logits [B, S, V] float32.
    On rank 0 of a mesh the workers run it too (sent first)."""
    cfg = model.cfg
    B, S = tokens.shape
    if model.mesh is not None and model.mesh.is_leader:
        model.check_current()
        model.mesh.send("forward", tokens.cpu().numpy(),
                        None if positions is None
                        else positions.cpu().numpy())
    x = _embed_lookup(model, tokens)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    cos, sin = rope_angles(positions, cfg.head_dim_, cfg.rope_theta,
                           scaling=cfg.rope_scaling)
    for li, layer in enumerate(model.layers):
        x = layer_block(model, layer, x, cos, sin, positions, li)
    return _unembed(model, x)


# ---------------------------------------------------------------------------
# Paged-cache scatter
# ---------------------------------------------------------------------------


def _scatter_pages(pages: torch.Tensor, vals: torch.Tensor,
                   block_table: torch.Tensor, positions: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Write vals[b, s] to pages[block_table[b, pos//bs], pos%bs], in place.

    Invalid lanes, and positions past the table, are redirected to the null
    block 0 rather than clipped into the lane's last real block (a clip
    would overwrite live cache).  fp8 pages take ``cast_e4m3`` (or
    ``cast_e5m2``) of ``vals`` as they come (the model dtype on the
    XLA-scatter paths, as the JAX package rounds them), written through a
    byte view.

    pages [num_blocks, bs, KVH*D]; vals [B, S, KVH, D]; block_table
    [B, max_blocks]; positions/valid [B, S].  Returns ``pages``.
    """
    bs = pages.shape[1]
    B, S = positions.shape
    nb = block_table.shape[1]
    raw_blk = torch.div(positions, bs, rounding_mode="floor")
    blk_idx = raw_blk.clamp(0, nb - 1).long()
    block_ids = torch.gather(block_table, 1, blk_idx)
    block_ids = torch.where(valid & (raw_blk < nb), block_ids,
                            torch.zeros_like(block_ids))
    offs = positions % bs
    idx = (block_ids.reshape(-1).long(), offs.reshape(-1).long())
    rows = vals.reshape(B * S, -1)
    cast = _JNP_CASTS.get(pages.dtype)
    if cast is not None:
        pages.view(torch.uint8)[idx] = cast(rows).view(torch.uint8)
    else:
        pages[idx] = rows.to(pages.dtype)
    return pages


def _scatter_pages_quant(pages: torch.Tensor, spages: torch.Tensor,
                         vals: torch.Tensor, block_table: torch.Tensor,
                         positions: torch.Tensor, valid: torch.Tensor):
    """Quantize-on-append twin of ``_scatter_pages``: per-(token, head)
    quantization of ``vals`` [B, S, KVH, D] into the 1-byte ``pages`` and a
    scatter of the float32 scales into ``spages`` [num_blocks, bs, KVH],
    both in place with the same null-block redirect.  Returns (pages,
    spages)."""
    xq, scale = _quantize_heads(vals.float(), _qmax_for(pages.dtype),
                                pages.dtype == torch.int8)
    return (_scatter_pages(pages, xq, block_table, positions, valid),
            _scatter_pages(spages, scale, block_table, positions, valid))


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _gathered_kv(model: LlamaModel, k, v, pk, pv, psk, psv, block_tables,
                 attend_to_pages: bool):
    """The K/V a gather-path attention reads, [B, T, KVH, D]: the gathered
    pages (dequantized with the scale planes ``psk``/``psv`` of a quantized
    pool, widened on an unscaled fp8/fp16 one), or the in-flight ``k``/``v``
    of a fresh dense prefill."""
    if not attend_to_pages:
        return k, v
    D = model.cfg.head_dim_
    if psk is not None:
        return (gather_dequant(pk, psk, block_tables, D).to(k.dtype),
                gather_dequant(pv, psv, block_tables, D).to(v.dtype))
    B = block_tables.shape[0]
    return (widen_pages(gather_pages(pk, block_tables)).reshape(
                B, -1, model.n_kv_heads, D),
            widen_pages(gather_pages(pv, block_tables)).reshape(
                B, -1, model.n_kv_heads, D))


def _prefill_impl(model: LlamaModel, tokens, positions, valid, lengths,
                  kv_len, pages: KVPages, block_tables, attend_to_pages: bool,
                  paged_attn_fn=None, on_layer=None,
                  return_all_logits: bool = False, seq_shard: bool = False):
    """Shared prefill layer loop: embed, qkv+rope, scatter into the pages,
    attention, residual/MLP, last-valid-token unembed (every position's
    with ``return_all_logits``, for the verify pass).

    Attention source: the flash kernel reads the pages (the scatter above
    already wrote this chunk's K/V, so fresh prefill and continuation
    chunks are the same call); a paged multi-query impl (the verify path,
    ops/attention.py:select_verify_impl) reads them over a bf16 pool;
    otherwise ``attend_to_pages`` gathers the paged prefix (chunks) or uses
    the in-flight k/v (fresh prefill).  That gather branch is the one a
    model with attention extras takes (the selectors give it no kernel),
    with each layer's scale, cap and window (``_attn_extras``); it also
    serves such a model's verify pass.

    A quantized pool quantizes on scatter; the flash kernel takes the
    scale planes and dequantizes inside, a chunk's gather dequantizes the
    gathered prefix, and fresh dense prefill attends to the unquantized
    in-flight k/v (so it differs from flash by quantization noise).

    ``on_layer``, when given, is called after each layer's launches: the
    host may act on earlier work the device has finished while it waits
    for room in the launch queue.

    ``seq_shard`` (prefill and chunk rounds) on a mesh with a seq axis:
    this rank computes the queries of its slice of the round's positions
    (module docstring); ``positions`` / ``valid`` stay the round's, for
    the scatter of the gathered K/V.
    """
    cfg = model.cfg
    B, S = tokens.shape
    sp = model.sp if seq_shard else 1
    q_pos, q_len, off, Sq = positions, lengths, 0, S
    if sp > 1:
        if S % sp:
            raise ValueError(f"a prefill round of {S} tokens does not "
                             f"divide over the mesh's seq axis ({sp})")
        Sq = S // sp
        off = model.seq_rank * Sq
        tokens = tokens[:, off:off + Sq]
        q_pos = positions[:, off:off + Sq]
        q_len = (lengths - off).clamp(0, Sq)
    cos, sin = rope_angles(q_pos, cfg.head_dim_, cfg.rope_theta,
                           scaling=cfg.rope_scaling)
    flash = paged_attn_fn is not None and is_flash_prefill_impl(paged_attn_fn)
    quant = pages.quantized
    x = _embed_lookup(model, tokens)
    uo = cfg.rmsnorm_unit_offset
    for li, layer in enumerate(model.layers):
        h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps, uo)
        q, k, v = _qkv(model, layer, h, cos, sin)
        if sp > 1:
            k = model.mesh.seq_all_gather(k, dim=1)
            v = model.mesh.seq_all_gather(v, dim=1)
        if quant:
            pk, psk = _scatter_pages_quant(pages.k[li], pages.k_scale[li], k,
                                           block_tables, positions, valid)
            pv, psv = _scatter_pages_quant(pages.v[li], pages.v_scale[li], v,
                                           block_tables, positions, valid)
        else:
            pk = _scatter_pages(pages.k[li], k, block_tables, positions, valid)
            pv = _scatter_pages(pages.v[li], v, block_tables, positions, valid)
        if flash:
            scales = dict(k_scale=psk, v_scale=psv) if quant else {}
            attn = paged_attn_fn(q, pk, pv, block_tables, q_pos[:, 0],
                                 q_len, **scales)
        elif (attend_to_pages and paged_attn_fn is not None and not quant
              and not model.kv_gather):
            # Queries are contiguous at positions[:, 0] + i (verify_step
            # and prefill_chunk guarantee it); a quantized pool takes the
            # gather/dequant branch below, as in the JAX package.
            attn = paged_attn_fn(q, pk, pv, block_tables, q_pos[:, 0],
                                 q_len)
        else:
            kk, vv = _gathered_kv(model, k, v, pk, pv,
                                  psk if quant else None,
                                  psv if quant else None, block_tables,
                                  attend_to_pages)
            extras = _attn_extras(cfg, li)
            if model.kv_gather:
                attn = _replicated_attention(model, q, kk, vv, q_pos,
                                             kv_len, **extras)
            else:
                attn = causal_attention(q, kk, vv, q_positions=q_pos,
                                        kv_len=kv_len, **extras)
        o = _row(model, layer.o, attn.reshape(B, Sq, -1))
        x = _residual_tail(model, layer, x, o)
        if on_layer is not None:
            on_layer()
    if return_all_logits:
        return _unembed(model, x), pages
    last_idx = (lengths - 1).clamp(min=0).long() - off
    x_last = x[torch.arange(B, device=x.device),
               last_idx.clamp(0, Sq - 1)][:, None, :]
    if sp > 1:
        # The seq rank that holds each lane's last token gives its row
        # (the others add zeros: exact).
        mine = (last_idx >= 0) & (last_idx < Sq)
        x_last = model.mesh.seq_all_reduce(torch.where(
            mine[:, None, None], x_last, torch.zeros_like(x_last)))
    return _unembed(model, x_last)[:, 0, :], pages


@torch.no_grad()
def prefill(model: LlamaModel, tokens, lengths, pages: KVPages, block_tables,
            *, attn_impl=None, on_layer=None):
    """Ingest right-padded prompts, writing K/V into the paged cache.

    tokens [B, S_pad]; lengths [B] (0 = inactive lane); ``attn_impl``: the
    flash paged-prefill wrapper (ops/attention.py:select_prefill_impl) or
    None for dense in-flight attention.  Returns (last-token logits [B, V]
    float32, pages updated in place).  On a mesh with a seq axis each seq
    rank computes its slice of the positions (``S_pad`` must divide).
    """
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    valid = positions < lengths[:, None]
    return _prefill_impl(model, tokens, positions, valid, lengths, lengths,
                         pages, block_tables, attend_to_pages=False,
                         paged_attn_fn=attn_impl, on_layer=on_layer,
                         seq_shard=True)


@torch.no_grad()
def prefill_chunk(model: LlamaModel, tokens, start, lengths, pages: KVPages,
                  block_tables, *, attn_impl=None, on_layer=None):
    """Continuation prefill: a chunk of a prompt whose first ``start``
    tokens are already cached; attention runs against the paged prefix +
    the chunk, masked causally by absolute position.

    tokens [B, S]; start, lengths [B] (0 = inactive lane).  Returns
    (last-chunk-token logits [B, V] float32, pages updated in place).
    Sequence-sharded on a mesh with a seq axis, as ``prefill``.
    """
    B, S = tokens.shape
    offs = torch.arange(S, dtype=torch.int32, device=tokens.device)
    positions = start[:, None] + offs[None, :]
    valid = offs[None, :] < lengths[:, None]
    return _prefill_impl(model, tokens, positions, valid, lengths,
                         start + lengths, pages, block_tables,
                         attend_to_pages=True, paged_attn_fn=attn_impl,
                         on_layer=on_layer, seq_shard=True)


@torch.no_grad()
def verify_step(model: LlamaModel, tokens, start, lengths, pages: KVPages,
                block_tables, *, attn_impl=None):
    """Speculative-decode verify pass: score ``S`` candidate tokens at once.

    The cache semantics of ``prefill_chunk`` (tokens land at positions
    ``start .. start + lengths - 1`` and attend to the paged prefix and the
    chunk) with the logits of every position, [B, S, V] float32: position
    ``i``'s are the distribution of the token after ``tokens[:, i]``.  K/V
    written for rejected positions stays beyond the accepted context, is
    masked out of every later read and overwritten when real tokens
    arrive, so rejection needs no rollback.

    ``attn_impl``: the flash prefill wrapper (any pool; its scale planes
    ride as kwargs), a paged multi-query impl (ops/attention.py:
    select_verify_impl; a quantized pool then takes the gather/dequant
    branch) or None (the gather).  Pages are updated in place.
    """
    B, S = tokens.shape
    offs = torch.arange(S, dtype=torch.int32, device=tokens.device)
    positions = start[:, None] + offs[None, :]
    valid = offs[None, :] < lengths[:, None]
    return _prefill_impl(model, tokens, positions, valid, lengths,
                         start + lengths, pages, block_tables,
                         attend_to_pages=True, paged_attn_fn=attn_impl,
                         return_all_logits=True)


@torch.no_grad()
def prefill_logits(model: LlamaModel, tokens, lengths, bucket: int, *,
                   prefill_path: str = "auto", block_size: int = 16):
    """Each lane's last-token logits from prompts ingested in rounds of
    ``bucket`` tokens, as the engine's admission and chunk rounds ingest
    them: ``prefill`` for the first round, then ``prefill_chunk`` over the
    paged prefix.  tokens [B, T] (T a multiple of ``bucket``); lengths
    [B] (at least 1).  A pool of its own, ``prefill_path`` as the engine
    reads it (ops/attention.py:select_prefill_impl).  Returns [B, V]
    float32.  On rank 0 of a mesh the workers run it too (sent first), so
    a seq mesh's rounds are split as the engine's are."""
    from k8s_llm_monitor_tpu_torch.ops.attention import select_prefill_impl

    cfg = model.cfg
    if model.mesh is not None and model.mesh.is_leader:
        model.check_current()
        model.mesh.send("prefill_logits", tokens.cpu().numpy(),
                        lengths.cpu().numpy(), bucket,
                        dict(prefill_path=prefill_path,
                             block_size=block_size))
    B, T = tokens.shape
    if T % bucket:
        raise ValueError(f"{T} tokens are not rounds of {bucket}")
    dev = model.device
    tokens, lengths = tokens.to(dev), lengths.to(dev, torch.int32)
    nb = -(-T // block_size)
    pages = init_kv_pages(cfg, B * nb + 1, block_size, dev, model.dtype,
                          tp=model.tp)
    tables = (1 + torch.arange(B * nb, dtype=torch.int32,
                               device=dev)).reshape(B, nb)
    impl = select_prefill_impl(dev, cfg, prefill_path, tp=model.tp)
    out = None
    for start in range(0, T, bucket):
        chunk = tokens[:, start:start + bucket]
        n = (lengths - start).clamp(0, bucket).to(torch.int32)
        if start == 0:
            logits, _ = prefill(model, chunk, n, pages, tables,
                                attn_impl=impl)
            out = logits
        else:
            logits, _ = prefill_chunk(
                model, chunk, torch.full_like(n, start), n, pages, tables,
                attn_impl=impl)
            out = torch.where((n > 0)[:, None], logits, out)
    return out


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step(model: LlamaModel, tokens, context_lens, pages: KVPages,
                block_tables, *, attn_impl):
    """One decode step for a batch of slots.

    tokens [B]: the token fed per slot.  context_lens [B]: tokens already
    cached, i.e. the new token's position; 0 marks an inactive slot whose
    writes go to the null block.  ``attn_impl``: a fused wrapper (RoPE +
    append + attention in one kernel; the ``quant_kv`` one for a quantized
    pool), the split paged-attention wrapper or ``paged_decode_attention``.
    A quantized pool without the fused quant wrapper runs the gather/
    dequant branch whatever impl is handed in.
    Returns (logits [B, V] float32, pages updated in place).
    """
    cfg = model.cfg
    B = tokens.shape[0]
    positions = context_lens[:, None]
    active = (context_lens > 0)[:, None]
    cos, sin = rope_angles(positions, cfg.head_dim_, cfg.rope_theta,
                           scaling=cfg.rope_scaling)
    quant = pages.quantized
    fused_q = quant and is_fused_quant_decode_impl(attn_impl)
    # A fused impl without scale support never touches a quantized pool.
    fused = is_fused_decode_impl(attn_impl) and (fused_q or not quant)
    x = _embed_lookup(model, tokens)[:, None, :]
    uo = cfg.rmsnorm_unit_offset
    new_lens = context_lens + 1
    for li, layer in enumerate(model.layers):
        h = rms_norm(x, layer.input_norm, cfg.rms_norm_eps, uo)
        if fused_q:
            q, k, v = _qkv_proj(model, layer, h)
            attn = attn_impl(q, k, v, cos, sin, pages.k[li], pages.v[li],
                             pages.k_scale[li], pages.v_scale[li],
                             block_tables, context_lens)[0]
        elif fused:
            q, k, v = _qkv_proj(model, layer, h)
            attn, _, _ = attn_impl(q, k, v, cos, sin, pages.k[li],
                                   pages.v[li], block_tables, context_lens)
        else:
            attn = decode_attention_split(model, layer, li, h, cos, sin,
                                          positions, active, new_lens, pages,
                                          block_tables, attn_impl)
        o = _row(model, layer.o, attn.reshape(B, 1, -1))
        x = _residual_tail(model, layer, x, o)
    return _unembed(model, x)[:, 0, :], pages


def decode_attention_split(model: LlamaModel, layer: LlamaLayer, li: int, h,
                           cos, sin, positions, active, new_lens,
                           pages: KVPages, block_tables, attn_impl):
    """One layer's decode attention on the split path: q/k/v and RoPE in
    PyTorch, the new token's K/V scattered into the pages, then the paged
    attention ``attn_impl`` (the split kernel wrapper or the gather); a
    quantized pool, or replicated pages under a mesh, take the gather
    (and dequant).  A model with attention extras is handed the gather,
    which takes layer ``li``'s scale, cap and window (``_attn_extras``).
    Shared with parallel/overlap.py."""
    q, k, v = _qkv(model, layer, h, cos, sin)
    extras = _attn_extras(model.cfg, li)
    if pages.quantized:
        pk, psk = _scatter_pages_quant(pages.k[li], pages.k_scale[li], k,
                                       block_tables, positions, active)
        pv, psv = _scatter_pages_quant(pages.v[li], pages.v_scale[li], v,
                                       block_tables, positions, active)
        if not model.kv_gather:
            return paged_decode_attention_quant(q, pk, pv, psk, psv,
                                                block_tables, new_lens,
                                                **extras)
    else:
        pk = _scatter_pages(pages.k[li], k, block_tables, positions, active)
        pv = _scatter_pages(pages.v[li], v, block_tables, positions, active)
        psk = psv = None
        if not model.kv_gather:
            return attn_impl(q, pk, pv, block_tables, new_lens, **extras)
    kk, vv = _gathered_kv(model, k, v, pk, pv, psk, psv, block_tables, True)
    return _replicated_attention(model, q, kk, vv, positions, new_lens,
                                 **extras)
