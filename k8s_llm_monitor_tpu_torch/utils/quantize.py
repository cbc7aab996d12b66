"""Weight-only int8 quantization for the decoder LM (the JAX package's
``utils/quantize.py``).

Scheme: symmetric per-output-channel int8 in ``nn.Linear``'s layout,

    w_q[o, i] = round(w[o, i] / scale[o]),  scale[o] = max_i |w[o, i]| / 127

which is the JAX package's ``[in, out]`` scheme transposed.  The scale
commutes with the contraction, so ``models/llama.py:_linear`` multiplies
the [.., out] result by it and never builds a dequantized matrix.  The
embedding is quantized per vocab row, a mixture of experts' stacked
kernels ``[E, in, out]`` per (expert, out channel) (the JAX package's
``quantize_expert_stack``).  Norms (sandwich norms too), biases and an
MoE router stay in the model dtype.  int8 halves the weight bytes decode streams per step, and under
``ModelConfig.act_quant`` (W8A8) the linears run s8 x s8 with int32 sums.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from k8s_llm_monitor_tpu_torch.models.config import ModelConfig
from k8s_llm_monitor_tpu_torch.models.llama import (
    ExpertStack, LlamaModel, QuantLinear)
from k8s_llm_monitor_tpu_torch.parallel.sharding import (
    param_partition_specs, shard_tensor)

_EPS = 1e-12


def quantize_array(w: np.ndarray, axis: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization of ``w`` with scales over ``axis``.

    Host-side numpy (streaming checkpoint load must not touch the device).
    Returns (w_q int8 same shape, scale float32 with ``axis`` reduced).
    """
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=axis)
    scale = np.maximum(amax / 127.0, _EPS).astype(np.float32)
    w_q = np.rint(w / np.expand_dims(scale, axis)).astype(np.int8)
    return w_q, scale


@torch.no_grad()
def fill_quantized(codes: torch.Tensor, scale: torch.Tensor,
                   w, mesh=None) -> None:
    """Quantize ``w`` [rows, cols] (a numpy array or a tensor on any
    device) per row as ``quantize_array(w, axis=1)`` does and copy the
    codes and scales into ``codes`` and ``scale``.

    It runs on ``codes``' device, one tensor at a time, with
    ``quantize_array``'s float32 operations in the same order: ``|w|``'s
    row max, a division of it by 127 (a tensor on the device: PyTorch on
    CUDA turns division by a Python number into a reciprocal multiply),
    the floor at ``_EPS``, the division of ``w`` by the scale and round
    half to even; the codes and scales equal ``quantize_array``'s bit for
    bit (the CPU tests and chip_smoke.py phase 13a hold them so).

    ``mesh``: ``w`` is the rank's slice of the columns of a row-parallel
    weight (o, down), whose row scale spans every rank's columns.  Each
    rank's amax is reduced by a MAX all-reduce (max is exact in any order,
    and the vector is small), so the scale and the codes equal those of
    the whole row, bit for bit.  Every rank of the mesh calls it for the
    same weights in the same order."""
    c, s = _quantize_rows(torch.as_tensor(w).to(codes.device), mesh)
    codes.copy_(c)
    scale.copy_(s)


def _quantize_rows(w: torch.Tensor, mesh=None):
    """(codes int8, scale float32 [rows]) of ``w`` [rows, cols] quantized
    per row on its device (``fill_quantized``'s arithmetic)."""
    wt = w.float()
    amax = wt.abs().amax(dim=1)
    if mesh is not None:
        amax = mesh.all_reduce(amax, "max")
    s = torch.clamp(amax / amax.new_full((), 127.0), min=_EPS)
    return torch.round(wt / s[:, None]).to(torch.int8), s


def _quantize_experts(w: torch.Tensor):
    """(codes int8 [E, in, out], scale float32 [E, out]) of a stacked
    expert kernel ``w`` [E, in, out], quantized over ``in`` per (expert,
    out channel): ``quantize_array(w, axis=1)``, bit for bit."""
    E, n_in, n_out = w.shape
    c, s = _quantize_rows(w.transpose(1, 2).reshape(E * n_out, n_in))
    return (c.reshape(E, n_out, n_in).transpose(1, 2),
            s.reshape(E, n_out))


@torch.no_grad()
def fill_quantized_experts(stack: ExpertStack, w) -> None:
    """Quantize the expert kernels ``w`` [E, in, out] (the rank's experts,
    a numpy array or a tensor on any device) into the int8 ``stack``'s
    codes and scales, on its device.  An expert's scale spans its own
    ``in`` axis only, so a rank's experts need no collective (unlike a
    row-parallel weight's, ``fill_quantized``)."""
    c, s = _quantize_experts(torch.as_tensor(w).to(stack.kernel_q.device))
    stack.kernel_q.copy_(c)
    stack.scale.copy_(s)


def quantize_params(model: LlamaModel) -> LlamaModel:
    """The int8 twin of ``model`` on its device: every linear and the
    embedding quantized by ``fill_quantized`` (``quantize_array``'s
    scheme, so the codes and scales equal the JAX package's bit for bit;
    on the card it runs there); norms and
    biases copied in the model dtype.  Of a mesh's shard, each rank
    quantizes its slice (a row-parallel weight's scales through a MAX
    all-reduce, ``fill_quantized``): the codes and scales are the TP-1
    twin's sliced.  On rank 0 the workers quantize theirs alongside."""
    mesh = model.mesh
    if mesh is not None and mesh.is_leader:
        model.check_current()
        token, q = mesh.build_alongside(lambda: _quantized(model),
                                        "quantize")
        q.mesh_token = token
        return q
    return _quantized(model)


@torch.no_grad()
def _quantized(model: LlamaModel) -> LlamaModel:
    q = LlamaModel(model.cfg, device=model.device, dtype=model.dtype,
                   seed=None, quantized=True, mesh=model.mesh)
    fill_quantized(q.embed.weight_q, q.embed.scale, model.embed.weight)
    q.final_norm.copy_(model.final_norm)
    pairs = [(model.lm_head, q.lm_head)] if q.lm_head is not None else []
    moe = model.cfg.num_experts > 0
    mlp = ("router",) if moe else ("gate", "up", "down")
    for src, dst in zip(model.layers, q.layers, strict=True):
        for name, p in src.named_parameters():
            if name.endswith("norm"):
                dst.get_parameter(name).copy_(p)
        pairs += [(getattr(src, n), getattr(dst, n))
                  for n in ("q", "k", "v", "o") + mlp]
        if moe:
            for n in ("gate_e", "up_e", "down_e"):
                fill_quantized_experts(getattr(dst, n),
                                       getattr(src, n).kernel)
    row = {id(layer.o) for layer in q.layers} | {
        id(layer.down) for layer in q.layers if not moe}
    for src, dst in pairs:
        if isinstance(dst, nn.Linear):      # the router stays as it is
            dst.weight.copy_(src.weight)
            continue
        fill_quantized(dst.weight_q, dst.scale, src.weight,
                       mesh=model.mesh if id(dst) in row else None)
        if src.bias is not None:
            dst.bias.copy_(src.bias)
    return q


@torch.no_grad()
def init_params_quantized(cfg: ModelConfig, seed: int = 0,
                          device=None, mesh=None) -> LlamaModel:
    """Random int8 weights drawn directly on ``device`` (default ``cuda``)
    from a seeded ``torch.Generator``, so an 8B-class model never exists in
    bf16 there.  Codes uniform in [-127, 127]; scales as the JAX package
    sets them, the magnitude ``LlamaModel``'s bf16 init would give (kernel
    std ``in**-0.5``, embed std 0.02, amax about 3 std): ``3 * in**-0.5 /
    127`` per linear and ``3 * 0.02 / 127`` for the embedding.  Unit norms,
    zero biases.  The draws differ from the JAX package's ``PRNGKey``.
    Under ``mesh`` the rank keeps its slice of each full draw (TP-1's
    draws), and rank 0 sends the build to the workers.

    A mixture of experts is the int8 twin of the seeded bf16 model,
    ``quantize_params(LlamaModel(cfg, seed=seed))`` code for code, built
    one tensor at a time (``_quantized_draws``): the JAX package
    quantizes a whole bf16 tree it builds first, which for Mixtral-8x7B
    is about 93 GB, more than a card holds."""
    model = LlamaModel(cfg, device=device, seed=None, quantized=True,
                       mesh=mesh)
    if cfg.num_experts > 0:
        _quantized_draws(model, seed)
        if model.mesh is not None and mesh.is_leader:
            model.mesh_token = mesh.build_on_workers("quantized", cfg,
                                                     seed=seed)
        return model
    gen = torch.Generator(device=model.device).manual_seed(seed)
    if model.mesh is not None:
        meta = model.full_meta()
        fan_in = {n + ".scale": m.in_features for n, m in meta.named_modules()
                  if isinstance(m, QuantLinear)}

        def draw(name, t):
            if name.endswith("weight_q"):
                return torch.empty(t.shape, dtype=t.dtype,
                                   device=model.device).random_(
                    -127, 128, generator=gen)
            if name == "embed.scale":
                val = 3.0 * 0.02 / 127.0
            elif name in fan_in:
                val = 3.0 * (fan_in[name] ** -0.5) / 127.0
            else:
                return None          # norms stay 1, biases 0
            return torch.full(t.shape, val, dtype=t.dtype,
                              device=model.device)

        # named_buffers order draws the codes in TP-1's order: the
        # embedding, then each linear in module order.
        model.fill_from_full(draw)
        if mesh.is_leader:
            model.mesh_token = mesh.build_on_workers("quantized", cfg,
                                                     seed=seed)
        return model
    model.embed.weight_q.random_(-127, 128, generator=gen)
    model.embed.scale.fill_(3.0 * 0.02 / 127.0)
    for lin in model.modules():
        if isinstance(lin, QuantLinear):
            lin.weight_q.random_(-127, 128, generator=gen)
            lin.scale.fill_(3.0 * (lin.in_features ** -0.5) / 127.0)
    return model


@torch.no_grad()
def _quantized_draws(model: LlamaModel, seed: int) -> None:
    """Fill the int8 ``model`` with the seeded bf16 model's weights,
    quantized: each tensor of ``LlamaModel.init_weights`` drawn in its
    order, dtype and full (TP-1) shape from a generator seeded alike, on
    the model's device, quantized there (``_quantize_rows`` per output
    row, ``_quantize_experts`` per expert and output channel), the rank's
    slice kept, and the draw freed before the next; the router is kept
    as drawn.  Norms stay at the identity, biases at zero."""
    cfg, dev = model.cfg, model.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    full = LlamaModel(dataclasses.replace(cfg, act_quant=False),
                      device="meta", dtype=model.dtype, seed=None)
    specs = param_partition_specs(model)
    local = dict(model.named_parameters()) | dict(model.named_buffers())
    fan_in = {n + suffix: m.in_features for n, m in full.named_modules()
              for suffix, kind in ((".weight", nn.Linear),
                                   (".kernel", ExpertStack))
              if isinstance(m, kind)}

    def keep(name, t):
        local[name].copy_(shard_tensor(t, specs[name], model.rank, model.tp))

    for name, t in full.named_parameters():
        if name == "embed.weight":
            std = 0.02
        elif name in fan_in:
            std = fan_in[name] ** -0.5
        else:
            continue
        w = torch.empty(t.shape, dtype=t.dtype, device=dev).normal_(
            0.0, std, generator=gen)
        base = name.rsplit(".", 1)[0]
        if name in local:                   # the router
            keep(name, w)
        elif name.endswith(".kernel"):
            codes, scale = _quantize_experts(w)
            keep(base + ".kernel_q", codes)
            keep(base + ".scale", scale)
        else:
            codes, scale = _quantize_rows(w)
            keep(base + ".weight_q", codes)
            keep(base + ".scale", scale)
        del w


def param_bytes(model: nn.Module) -> int:
    """Total weight bytes as stored (int8 codes count 1 byte each)."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))
