// Paged attention for Hopper (sm_90a): QS query tokens per lane over a
// bf16 paged pool that already holds them -- no append, no RoPE.
//
// Replaces: k8s_llm_monitor_tpu/ops/pallas_attention.py:_run_paged_attn
//           (_paged_attn_kernel), behind paged_decode_attention_pallas
//           (QS = 1, the split decode path) and paged_verify_attention_pallas
//           (QS > 1, speculative verify).
//
// Query i of lane b sits at starts[b] + i and sees keys at positions
// <= starts[b] + i (pallas_attention.py:149); qlens[b] counts its valid
// query tokens.  Decode calls it with starts = lengths - 1, qlens = 1.
//
// What bounds it on this card: the bytes of the KV read, as for the fused
// decode kernel (about 2 * qpk * QS flops per byte of K/V), so the design is
// csrc/fused_decode.cu's without RoPE and append:
//   * one block per (kv group, lane, chunk of QC query tokens); the block's
//     QC * qpk rows (at most 8, so each thread keeps 8 rows of state in
//     registers) share every K/V row slice it reads (D = 128 contiguous
//     bf16, 256 bytes).  QC = 1 for decode; for verify QC = 8 / qpk, so a
//     lane's context is streamed ceil(QS / QC) times (from L2 after the
//     first) -- verify is not on the main path yet, and staging all
//     QS * qpk rows of one block is later work;
//   * four warps stride over the positions, one 8-byte load per lane per
//     row slice (coalesced 256 B), each with its own online-softmax state
//     (m, l, acc) per row; the four partial states merge through shared
//     memory at the end.  The loop is latency-bound (a 5-shuffle warp sum
//     per row and position), so the rows' chains must interleave: a row
//     whose causal horizon is below a position takes it with weight 0
//     through selects, never a branch (a per-row branch serialised the
//     chains; see PERF.md), and decode (QC = 1) needs no test at all.
// Lanes with qlens == 0, chunks past qlens and rows past qlens write zeros
// (the TPU kernel leaves garbage there; no caller reads them).  Every live
// row sees position 0, so its softmax sum is positive.
//
// Trap: q arrives already scaled by D**-0.5 in bf16 (the wrapper does it,
// as pallas_attention.py:208 does), so the kernel applies no scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // head_dim (the wrapper checks)
constexpr int WARPS = 4;
constexpr int PER_LANE = D / 32;  // 4 dims per lane
constexpr int MAX_ROWS = 8;       // query rows per block
// Finite, so that a row which has seen no position yet rescales by
// exp(0) = 1 instead of exp(-inf + inf) = NaN.
constexpr float NEG_INF = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float2 a = __bfloat1622float2(h[0]);
  float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Row r of a block: token i0 + r / QPK, head g * QPK + r % QPK.
template <int QPK, int QC>
__global__ void __launch_bounds__(WARPS * 32)
paged_attn_kernel(const __nv_bfloat16* __restrict__ q,    // [B, QS, H, D], pre-scaled
                  const __nv_bfloat16* __restrict__ kp,   // [nb, bs, KVH*D]
                  const __nv_bfloat16* __restrict__ vp,
                  const int* __restrict__ table,          // [B, NB]
                  const int* __restrict__ starts,         // [B]
                  const int* __restrict__ qlens,          // [B]
                  __nv_bfloat16* __restrict__ out,        // [B, QS, H, D]
                  int QS, int KVH, int bs, int NB) {
  constexpr int R = QC * QPK;
  static_assert(R <= MAX_ROWS, "rows per block");
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.z * QC;   // first query token of this block
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = lane * PER_LANE;
  const int H = KVH * QPK;
  const long F = (long)KVH * D;
  const int start = starts[b];
  const int qlen = qlens[b];
  const int n_tok = max(0, min(QC, qlen - i0));   // live tokens of the block

  auto out_row = [&](int r) {
    return out + (((long)b * QS + i0 + r / QPK) * H + g * QPK + r % QPK) * D + d0;
  };
  if (n_tok == 0) {                 // dead lane or dead chunk
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = warp; r < R; r += WARPS)
      if (i0 + r / QPK < QS) store4(out_row(r), zero);
    return;
  }

  float qf[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r / QPK < n_tok)
      load4(q + (((long)b * QS + i0 + r / QPK) * H + g * QPK + r % QPK) * D + d0,
            qf[r]);
    else
      qf[r][0] = qf[r][1] = qf[r][2] = qf[r][3] = 0.f;
  }
  float m[R], l[R], acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  }

  const int horizon = start + i0;            // token i sees keys <= horizon + i
  const int kv_end = horizon + n_tok;        // keys [0, kv_end)
  for (int t = warp; t < kv_end; t += WARPS) {
    const int bi = min(t / bs, NB - 1);
    const int blk = table[(long)b * NB + bi];
    const long row = ((long)blk * bs + t % bs) * F + (long)g * D + d0;
    float kv[4], vv[4];
    load4(kp + row, kv);
    load4(vp + row, vv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // Decode: t < kv_end = horizon + 1, always visible.
      const bool see =
          QC == 1 || (r / QPK < n_tok && t <= horizon + r / QPK);
      float sc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) sc += qf[r][i] * kv[i];
      sc = warp_sum(sc);
      const float m_new = see ? fmaxf(m[r], sc) : m[r];
      const float alpha = __expf(m[r] - m_new);
      const float p = see ? __expf(sc - m_new) : 0.f;
      l[r] = alpha * l[r] + p;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] = alpha * acc[r][i] + p * vv[i];
      m[r] = m_new;
    }
  }

  __shared__ float sm_m[WARPS][R];
  __shared__ float sm_l[WARPS][R];
  __shared__ float sm_acc[WARPS][R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sm_acc[warp][r][d0 + i] = acc[r][i];
  }
  __syncthreads();

  // Warp w finalizes rows w, w + WARPS, ...  A live row saw position 0, so
  // its M is a real score and warps that saw nothing (m = NEG_INF, l = 0)
  // contribute exp(NEG_INF - M) = 0.
  for (int r = warp; r < R; r += WARPS) {
    if (i0 + r / QPK >= QS) continue;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    if (r / QPK < n_tok) {
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][r]);
      float L = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float f = __expf(sm_m[w][r] - M);
        L += f * sm_l[w][r];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] += f * sm_acc[w][r][d0 + i];
      }
      const float inv = 1.f / L;
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] *= inv;
    }
    store4(out_row(r), o);
  }
}

template <int QPK, int QC>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* table, const void* starts, const void* qlens,
                   void* out, int B, int QS, int KVH, int bs, int NB,
                   cudaStream_t stream) {
  dim3 grid(KVH, B, (QS + QC - 1) / QC);
  paged_attn_kernel<QPK, QC><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(starts), static_cast<const int*>(qlens),
      static_cast<__nv_bfloat16*>(out), QS, KVH, bs, NB);
  return cudaGetLastError();
}

// One query token per block for decode; 8 / qpk tokens (8 rows) for verify.
template <int QPK>
cudaError_t launch_qpk(const void* q, const void* kp, const void* vp,
                       const void* table, const void* starts,
                       const void* qlens, void* out, int B, int QS, int KVH,
                       int bs, int NB, cudaStream_t stream) {
  if (QS == 1 || QPK == MAX_ROWS)
    return launch<QPK, 1>(q, kp, vp, table, starts, qlens, out, B, QS, KVH, bs, NB, stream);
  return launch<QPK, MAX_ROWS / QPK>(q, kp, vp, table, starts, qlens, out, B, QS, KVH, bs, NB, stream);
}

}  // namespace

extern "C" int paged_attn_bf16(const void* q, const void* k_pages,
                               const void* v_pages, const void* table,
                               const void* starts, const void* qlens,
                               void* out, int B, int QS, int H, int KVH,
                               int bs, int NB, void* stream) {
  if (B == 0 || QS == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / KVH) {
    case 1: return launch_qpk<1>(q, k_pages, v_pages, table, starts, qlens, out, B, QS, KVH, bs, NB, st);
    case 2: return launch_qpk<2>(q, k_pages, v_pages, table, starts, qlens, out, B, QS, KVH, bs, NB, st);
    case 4: return launch_qpk<4>(q, k_pages, v_pages, table, starts, qlens, out, B, QS, KVH, bs, NB, st);
    case 8: return launch_qpk<8>(q, k_pages, v_pages, table, starts, qlens, out, B, QS, KVH, bs, NB, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
