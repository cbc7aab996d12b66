// Pieces of the split-KV (flash-decoding) kernels for Hopper that
// csrc/fused_decode.cu and csrc/paged_attn.cu share: the block geometry,
// warp reductions, 16-byte cp.async, division of positions by the block
// size, the launch-argument check, and the log-sum-exp merge of the
// splits' partial states.  Each kernel library includes it once.
//
// The kernels are templates over the head dim D (64 or 128, the extern "C"
// functions dispatch on it): a block has D threads, thread d owns output
// dim d, and warp w scores (lane = key) or owns dims [32w, 32w + 32), so
// D / 32 warps cover a row and every per-warp piece keeps its shape.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int PART = 32;            // dims a warp scores or owns
constexpr int TILE = 32;            // keys per tile
constexpr int STAGES = 2;           // tiles in the cp.async ring
constexpr int MAX_SPLITS = 64;      // ops/paged_attention.py:DECODE_MAX_SPLITS

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// QPK consecutive floats from shared memory, 16 bytes at a time (QPK 1, 2
// and 7: one at a time, their rows are not 16-byte multiples).
template <int QPK>
__device__ __forceinline__ void load_heads(const float* p, float out[QPK]) {
  if constexpr (QPK % 4 == 0) {
#pragma unroll
    for (int j = 0; j < QPK; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + j);
      out[j] = f.x; out[j + 1] = f.y; out[j + 2] = f.z; out[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < QPK; ++j) out[j] = p[j];
  }
}

// pos / bs == __umulhi(pos, mul) >> shr for pos < 2^31, with mul =
// ceil(2^p / bs), p = 31 + ceil(log2 bs); mul = 0 marks bs == 1.  Made on
// the host: per-key division was the largest single cost of the kernels.
struct BlockDiv {
  unsigned mul = 0, shr = 0;
};

inline BlockDiv block_div(int bs) {
  BlockDiv v;
  if (bs > 1) {
    int lg = 31 - __builtin_clz(static_cast<unsigned>(bs));
    lg += (bs & (bs - 1)) != 0;
    v.mul = static_cast<unsigned>(((1ull << (31 + lg)) + bs - 1) / bs);
    v.shr = static_cast<unsigned>(lg - 1);
  }
  return v;
}

__device__ __forceinline__ int div_block(int t, unsigned mul, unsigned shr) {
  return mul ? static_cast<int>(__umulhi(static_cast<unsigned>(t), mul) >> shr) : t;
}

template <int V>
using Int = std::integral_constant<int, V>;

template <int D, typename F>
int with_qpk(int qpk, F&& f) {
  switch (qpk) {
    case 1: return f(Int<D>{}, Int<1>{});
    case 2: return f(Int<D>{}, Int<2>{});
    case 4: return f(Int<D>{}, Int<4>{});
    case 7: return f(Int<D>{}, Int<7>{});
    case 8: return f(Int<D>{}, Int<8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The template instances of the split kernels: f(Int<D>{}, Int<QPK>{}) for
// head dim D in {64, 128} and QPK in {1, 2, 4, 7, 8} query heads per kv
// head (7: Qwen2-7B's 28 over 4), cudaErrorInvalidValue for any other.  At
// QPK 7 a warp of the softmax and the merge may own a head past the group
// (HPW = ceil(QPK / WARPS)): every per-head loop over jj tests j < QPK.  A head dim is added here and in
// ops/paged_attention.py:SPLIT_KV_HEAD_DIMS.
template <typename F>
int with_geometry(int D, int qpk, F&& f) {
  switch (D) {
    case 64: return with_qpk<64>(qpk, f);
    case 128: return with_qpk<128>(qpk, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// What a split kernel takes: chunks of whole tiles that cover the table,
// at most MAX_SPLITS of them (ops/paged_attention.py:decode_splits).
inline bool splits_ok(int bs, int NB, int nsplit, int chunk) {
  return bs >= 1 && NB >= 1 && chunk >= TILE && chunk % TILE == 0 &&
         nsplit >= 1 && nsplit <= MAX_SPLITS &&
         (long)nsplit * chunk >= (long)NB * bs;
}

// Merge the first n split partials (m, l, acc[D]) of one (group, lane,
// token) by log-sum-exp and write its QPK heads in bf16 at o_row[j * D]
// (o_row: this thread's dim of head 0; the block has D threads).  Row
// (split s, head j) of the workspace is base + s * stride + j; each of
// the n splits has a real m for every head.  Warp w takes the weights exp(m_s - M) and L of heads
// w, w + WARPS, ... (lane = split); thread d then sums its dim of every
// head over the splits, in split order, with independent loads.  Every
// sum has a fixed order: a rerun gives the same bits.
template <int D, int QPK>
__device__ __forceinline__ void merge_splits(const float* __restrict__ ws_acc,
                                             const float* __restrict__ ws_ml,
                                             long base, int stride, int n,
                                             __nv_bfloat16* __restrict__ o_row) {
  constexpr int THREADS = D, WARPS = D / PART;
  constexpr int HPW = (QPK + WARPS - 1) / WARPS;
  __shared__ float sm_ml[MAX_SPLITS * QPK * 2];
  __shared__ __align__(16) float sm_f[MAX_SPLITS * QPK];
  __shared__ float sm_l[QPK];
  const int d = threadIdx.x;
  const int warp = d / 32;
  const int lane = d % 32;
  for (int i = d; i < n * QPK; i += THREADS) {
    const long row = base + (long)(i / QPK) * stride + i % QPK;
    sm_ml[i * 2] = ws_ml[row * 2];
    sm_ml[i * 2 + 1] = ws_ml[row * 2 + 1];
  }
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < HPW; ++jj) {
    const int j = warp + jj * WARPS;
    if (j < QPK) {
      float M = -3.402823466e38f;
      for (int s = lane; s < n; s += 32) M = fmaxf(M, sm_ml[(s * QPK + j) * 2]);
      M = warp_max(M);
      float L = 0.f;
      for (int s = lane; s < n; s += 32) {
        const float f = __expf(sm_ml[(s * QPK + j) * 2] - M);
        sm_f[s * QPK + j] = f;
        L += f * sm_ml[(s * QPK + j) * 2 + 1];
      }
      L = warp_sum(L);
      if (lane == 0) sm_l[j] = L;
    }
  }
  __syncthreads();
  float o[QPK];
#pragma unroll
  for (int j = 0; j < QPK; ++j) o[j] = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    float f[QPK];
    load_heads<QPK>(sm_f + s * QPK, f);
#pragma unroll
    for (int j = 0; j < QPK; ++j)
      o[j] += f[j] * ws_acc[(base + (long)s * stride + j) * D + d];
  }
#pragma unroll
  for (int j = 0; j < QPK; ++j) o_row[j * D] = __float2bfloat16_rn(o[j] / sm_l[j]);
}

}  // namespace
