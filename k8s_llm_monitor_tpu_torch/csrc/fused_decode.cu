// Fused decode attention for Hopper (sm_90a): RoPE + KV append + paged
// attention for one new token per lane, in one kernel.
//
// Replaces: k8s_llm_monitor_tpu/ops/pallas_attention.py:
//           paged_decode_attention_fused (_fused_decode_kernel).
//
// What bounds it on this card: the bytes of the KV read.  Each lane reads
// pos * KVH * D * 2 (K and V) bf16 values once and does 4 * H * D flops per
// cached position -- about 2 * qpk flops per byte, far below the ~295
// flops/byte where an H100's bf16 tensor cores become the limit.  So the
// design moves each byte once and does the arithmetic in CUDA cores:
//   * one block per (kv group, lane): every K/V row slice it reads (D = 128
//     contiguous bf16, 256 bytes) serves all qpk query heads of the group
//     (the TPU kernel's block-diagonal query matrix is an MXU workaround
//     and is not carried over);
//   * four warps stride over the cached positions; a warp reads one row
//     slice per position as one 8-byte load per lane (coalesced 256 B) and
//     keeps its own online-softmax state (m, l, acc) in registers; the four
//     partial states merge through shared memory at the end;
//   * RoPE runs in f32 in registers (the concatenated-halves rotation: the
//     partner of dim d is d +- 64, held by lane l ^ 16), the roped k and the
//     raw v row are written straight into the page, and the current token
//     is folded into the softmax from registers, never read back.
// Splitting one lane's KV over several blocks (flash-decoding), for batches
// too small to fill 132 SMs, is later work.
//
// Safety of the in-place append: a block writes only row `pos` of its own
// lane, and only its group's D-slice of that row; it reads only rows
// `< pos` of its own lane's blocks.  Lanes own disjoint blocks (the
// allocator hands out distinct tail blocks), so no block reads a row that
// another block writes.  The one shared target is the null block 0, which
// inactive lanes (pos == 0) and positions past the table write and no
// active lane ever reads.
//
// Traps mirrored from the TPU kernel:
//   * q is scaled by D**-0.5 in bf16 *before* RoPE (pallas_attention.py:521);
//   * RoPE runs in f32, and only the page copy of k is rounded to bf16
//     (:373-382, :390) -- the current token's score uses the f32 roped k;
//   * `positions` is the new token's position; 0 marks an inactive lane,
//     whose output is v_new (only the current token is visible).
//
// fused_decode_quant_kernel, below, is the same kernel on an int8 / fp8
// (e4m3) pool with per-(token, head) float32 scale planes.
// Replaces: pallas_attention.py:paged_decode_attention_fused_quant
//           (_fused_decode_quant_kernel).
// It moves half the page bytes plus 8 bytes of scales per cached position
// and group, so the same byte bound applies at about 0.53x the bf16 time.
// Quantize-on-append: the group's D-slice of the roped k (and of the raw v)
// is one warp's 4 x 32 values, so the per-head amax is a warp max; then
// scale = max(amax / qmax, 1e-8), codes = x / scale rounded half to even
// and clipped at 127 (int8) or converted saturating at 448 (fp8), and the
// code row and its scale go to the lane's block at `pos` (block 0 for
// inactive lanes and past the table, pallas_attention.py:716-719).  Cached
// rows score as (q . codes) * k_scale and accumulate p * v_scale * codes,
// with the row sum l of the unscaled p.  Trap mirrored from the TPU kernel
// (:657-660): the current token is folded from registers as codes * scale,
// where the int8 codes are rounded but the fp8 ones are NOT -- the pages
// get the fp8 value, the softmax the unrounded quotient x / scale.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // head_dim (the wrapper checks)
constexpr int WARPS = 4;
constexpr int PER_LANE = D / 32;  // 4 dims per lane
#define kNegInf __int_as_float(0xff800000)  // -inf

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

// x * cos + rotate_half(x) * sin for this lane's four dims; the partner
// dims (d +- 64) live in lane ^ 16.
__device__ __forceinline__ void rope4(float x[4], const float c[4],
                                      const float s[4], int lane) {
  float rot[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float partner = __shfl_xor_sync(0xffffffffu, x[i], 16);
    rot[i] = lane < 16 ? -partner : partner;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = x[i] * c[i] + rot[i] * s[i];
}

template <int QPK>
__global__ void __launch_bounds__(WARPS * 32)
fused_decode_kernel(const __nv_bfloat16* __restrict__ q,      // [B, H, D]
                    const __nv_bfloat16* __restrict__ k_new,  // [B, KVH, D]
                    const __nv_bfloat16* __restrict__ v_new,  // [B, KVH, D]
                    const float* __restrict__ cos_t,          // [B, D]
                    const float* __restrict__ sin_t,          // [B, D]
                    __nv_bfloat16* k_pages,                   // [nb, bs, KVH*D]
                    __nv_bfloat16* v_pages,
                    const int* __restrict__ table,            // [B, NB]
                    const int* __restrict__ positions,        // [B]
                    __nv_bfloat16* __restrict__ out,          // [B, H, D]
                    int KVH, int bs, int NB, float scale) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = lane * PER_LANE;
  const int H = KVH * QPK;
  const long F = (long)KVH * D;
  const int pos = positions[b];

  float c[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[i] = cos_t[(long)b * D + d0 + i];
    s[i] = sin_t[(long)b * D + d0 + i];
  }

  // Queries of this group's heads: scaled in bf16, then roped in f32.
  float qf[QPK][4];
#pragma unroll
  for (int j = 0; j < QPK; ++j) {
    load4(q + ((long)b * H + g * QPK + j) * D + d0, qf[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qf[j][i] = __bfloat162float(__float2bfloat16_rn(qf[j][i] * scale));
    rope4(qf[j], c, s, lane);
  }
  float kf[4], vc[4];
  load4(k_new + ((long)b * KVH + g) * D + d0, kf);
  rope4(kf, c, s, lane);
  load4(v_new + ((long)b * KVH + g) * D + d0, vc);

  // Append the roped k and the raw v row (warp 0 owns the write).
  if (warp == 0) {
    const int raw_blk = pos / bs;
    const int blk = (pos > 0 && raw_blk < NB) ? table[(long)b * NB + raw_blk] : 0;
    const long row = ((long)blk * bs + pos % bs) * F + (long)g * D + d0;
    store4(k_pages + row, kf);
    store4(v_pages + row, vc);
  }

  // Cached positions < pos, strided over the warps, online softmax.
  float m[QPK], l[QPK], acc[QPK][4];
#pragma unroll
  for (int j = 0; j < QPK; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }
  for (int t = warp; t < pos; t += WARPS) {
    // Clamp the table index like the TPU kernel (positions past the table
    // never reach here from the engine, which caps every request).
    const int bi = min(t / bs, NB - 1);
    const int blk = table[(long)b * NB + bi];
    const long row = ((long)blk * bs + t % bs) * F + (long)g * D + d0;
    float kv[4], vv[4];
    load4(k_pages + row, kv);
    load4(v_pages + row, vv);
#pragma unroll
    for (int j = 0; j < QPK; ++j) {
      float sc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) sc += qf[j][i] * kv[i];
      sc = warp_sum(sc);
      const float m_new = fmaxf(m[j], sc);
      const float alpha = __expf(m[j] - m_new);
      const float p = __expf(sc - m_new);
      l[j] = alpha * l[j] + p;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = alpha * acc[j][i] + p * vv[i];
      m[j] = m_new;
    }
  }

  // Current token's score, from registers (every warp computes it).
  float s_cur[QPK];
#pragma unroll
  for (int j = 0; j < QPK; ++j) {
    float sc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) sc += qf[j][i] * kf[i];
    s_cur[j] = warp_sum(sc);
  }

  __shared__ float sm_m[WARPS][QPK];
  __shared__ float sm_l[WARPS][QPK];
  __shared__ float sm_acc[WARPS][QPK][D];
#pragma unroll
  for (int j = 0; j < QPK; ++j) {
    if (lane == 0) {
      sm_m[warp][j] = m[j];
      sm_l[warp][j] = l[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sm_acc[warp][j][d0 + i] = acc[j][i];
  }
  __syncthreads();

  // Merge the warps' partial states and the current token; warp w
  // finalizes heads w, w + WARPS, ...  M is finite (s_cur is), so warps
  // that saw no position (m = -inf) contribute exp(-inf) = 0.
  for (int j = warp; j < QPK; j += WARPS) {
    float M = s_cur[j];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][j]);
    const float pc = __expf(s_cur[j] - M);
    float L = pc;
    float o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = pc * vc[i];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = __expf(sm_m[w][j] - M);
      L += f * sm_l[w][j];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] += f * sm_acc[w][j][d0 + i];
    }
    const float inv = 1.f / L;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] *= inv;
    store4(out + ((long)b * H + g * QPK + j) * D + d0, o);
  }
}

// int8 / e4m3 codes: four consecutive ones in one 32-bit word.
template <typename T>
struct Code;

template <>
struct Code<int8_t> {
  static constexpr float kQmax = 127.f;
  static __device__ __forceinline__ float quantize(float x) {
    return fminf(fmaxf(rintf(x), -kQmax), kQmax);   // rounded, for the fold
  }
  static __device__ __forceinline__ uint32_t to_bits(float xq) {
    return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(xq)));
  }
  static __device__ __forceinline__ void load4(const int8_t* p, float out[4]) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
  }
};

template <>
struct Code<__nv_fp8_e4m3> {
  static constexpr float kQmax = 448.f;
  static __device__ __forceinline__ float quantize(float x) {
    return x;   // not rounded: the TPU kernel folds the unrounded quotient
  }
  static __device__ __forceinline__ uint32_t to_bits(float xq) {
    return static_cast<uint32_t>(
        __nv_cvt_float_to_fp8(xq, __NV_SATFINITE, __NV_E4M3));
  }
  static __device__ __forceinline__ void load4(const __nv_fp8_e4m3* p,
                                               float out[4]) {
    const __nv_fp8x2_e4m3* h = reinterpret_cast<const __nv_fp8x2_e4m3*>(p);
    const float2 a = static_cast<float2>(h[0]);
    const float2 b = static_cast<float2>(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Quantize this warp's copy of one head's D-slice (4 values per lane):
// returns the scale; `bits` gets the four codes packed for one 32-bit
// store and `deq` the values the softmax folds in (codes * scale).
template <typename T>
__device__ __forceinline__ float quantize4(const float x[4], uint32_t& bits,
                                           float deq[4]) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(x[i]));
  const float scale = fmaxf(warp_max(amax) / Code<T>::kQmax, 1e-8f);
  bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float xq = Code<T>::quantize(x[i] / scale);
    bits |= Code<T>::to_bits(xq) << (8 * i);
    deq[i] = xq * scale;
  }
  return scale;
}

template <int QPK, typename T>
__global__ void __launch_bounds__(WARPS * 32)
fused_decode_quant_kernel(const __nv_bfloat16* __restrict__ q,      // [B, H, D]
                          const __nv_bfloat16* __restrict__ k_new,  // [B, KVH, D]
                          const __nv_bfloat16* __restrict__ v_new,  // [B, KVH, D]
                          const float* __restrict__ cos_t,          // [B, D]
                          const float* __restrict__ sin_t,          // [B, D]
                          T* k_pages,                               // [nb, bs, KVH*D]
                          T* v_pages,
                          float* k_scale,                           // [nb, bs, KVH]
                          float* v_scale,
                          const int* __restrict__ table,            // [B, NB]
                          const int* __restrict__ positions,        // [B]
                          __nv_bfloat16* __restrict__ out,          // [B, H, D]
                          int KVH, int bs, int NB, float scale) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d0 = lane * PER_LANE;
  const int H = KVH * QPK;
  const long F = (long)KVH * D;
  const int pos = positions[b];

  float c[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[i] = cos_t[(long)b * D + d0 + i];
    s[i] = sin_t[(long)b * D + d0 + i];
  }
  float qf[QPK][4];
#pragma unroll
  for (int j = 0; j < QPK; ++j) {
    load4(q + ((long)b * H + g * QPK + j) * D + d0, qf[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qf[j][i] = __bfloat162float(__float2bfloat16_rn(qf[j][i] * scale));
    rope4(qf[j], c, s, lane);
  }
  float kf[4], vf[4];
  load4(k_new + ((long)b * KVH + g) * D + d0, kf);
  rope4(kf, c, s, lane);
  load4(v_new + ((long)b * KVH + g) * D + d0, vf);

  // Quantize-on-append (every warp computes it; warp 0 writes).
  uint32_t kbits, vbits;
  float kdeq[4], vdeq[4];
  const float ks_cur = quantize4<T>(kf, kbits, kdeq);
  const float vs_cur = quantize4<T>(vf, vbits, vdeq);
  if (warp == 0) {
    const int raw_blk = pos / bs;
    const int blk = (pos > 0 && raw_blk < NB) ? table[(long)b * NB + raw_blk] : 0;
    const long slot = (long)blk * bs + pos % bs;
    *reinterpret_cast<uint32_t*>(k_pages + slot * F + (long)g * D + d0) = kbits;
    *reinterpret_cast<uint32_t*>(v_pages + slot * F + (long)g * D + d0) = vbits;
    if (lane == 0) {
      k_scale[slot * KVH + g] = ks_cur;
      v_scale[slot * KVH + g] = vs_cur;
    }
  }

  // Cached positions < pos, strided over the warps, online softmax.
  float m[QPK], l[QPK], acc[QPK][4];
#pragma unroll
  for (int j = 0; j < QPK; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }
  for (int t = warp; t < pos; t += WARPS) {
    const int bi = min(t / bs, NB - 1);
    const int blk = table[(long)b * NB + bi];
    const long slot = (long)blk * bs + t % bs;
    float kv[4], vv[4];
    Code<T>::load4(k_pages + slot * F + (long)g * D + d0, kv);
    Code<T>::load4(v_pages + slot * F + (long)g * D + d0, vv);
    const float ks_t = k_scale[slot * KVH + g];
    const float vs_t = v_scale[slot * KVH + g];
#pragma unroll
    for (int j = 0; j < QPK; ++j) {
      float sc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) sc += qf[j][i] * kv[i];
      sc = warp_sum(sc) * ks_t;
      const float m_new = fmaxf(m[j], sc);
      const float alpha = __expf(m[j] - m_new);
      const float p = __expf(sc - m_new);
      l[j] = alpha * l[j] + p;
      const float pv = p * vs_t;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = alpha * acc[j][i] + pv * vv[i];
      m[j] = m_new;
    }
  }

  // Current token's score, from registers: q . (codes * scale).
  float s_cur[QPK];
#pragma unroll
  for (int j = 0; j < QPK; ++j) {
    float sc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) sc += qf[j][i] * kdeq[i];
    s_cur[j] = warp_sum(sc);
  }

  __shared__ float sm_m[WARPS][QPK];
  __shared__ float sm_l[WARPS][QPK];
  __shared__ float sm_acc[WARPS][QPK][D];
#pragma unroll
  for (int j = 0; j < QPK; ++j) {
    if (lane == 0) {
      sm_m[warp][j] = m[j];
      sm_l[warp][j] = l[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sm_acc[warp][j][d0 + i] = acc[j][i];
  }
  __syncthreads();

  for (int j = warp; j < QPK; j += WARPS) {
    float M = s_cur[j];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][j]);
    const float pc = __expf(s_cur[j] - M);
    float L = pc;
    float o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = pc * vdeq[i];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = __expf(sm_m[w][j] - M);
      L += f * sm_l[w][j];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i] += f * sm_acc[w][j][d0 + i];
    }
    const float inv = 1.f / L;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] *= inv;
    store4(out + ((long)b * H + g * QPK + j) * D + d0, o);
  }
}

template <int QPK>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* cos_t, const void* sin_t, void* k_pages,
                   void* v_pages, const void* table, const void* positions,
                   void* out, int B, int KVH, int bs, int NB, float scale,
                   cudaStream_t stream) {
  dim3 grid(KVH, B);
  fused_decode_kernel<QPK><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<__nv_bfloat16*>(k_pages), static_cast<__nv_bfloat16*>(v_pages),
      static_cast<const int*>(table), static_cast<const int*>(positions),
      static_cast<__nv_bfloat16*>(out), KVH, bs, NB, scale);
  return cudaGetLastError();
}

template <int QPK, typename T>
cudaError_t launch_quant(const void* q, const void* k_new, const void* v_new,
                         const void* cos_t, const void* sin_t, void* k_pages,
                         void* v_pages, void* k_scale, void* v_scale,
                         const void* table, const void* positions, void* out,
                         int B, int KVH, int bs, int NB, float scale,
                         cudaStream_t stream) {
  dim3 grid(KVH, B);
  fused_decode_quant_kernel<QPK, T><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<T*>(k_pages), static_cast<T*>(v_pages),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const int*>(table), static_cast<const int*>(positions),
      static_cast<__nv_bfloat16*>(out), KVH, bs, NB, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_quant(const void* q, const void* k_new, const void* v_new,
                   const void* cos_t, const void* sin_t, void* k_pages,
                   void* v_pages, void* k_scale, void* v_scale,
                   const void* table, const void* positions, void* out, int B,
                   int H, int KVH, int bs, int NB, float scale, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / KVH) {
    case 1: return launch_quant<1, T>(q, k_new, v_new, cos_t, sin_t, k_pages, v_pages, k_scale, v_scale, table, positions, out, B, KVH, bs, NB, scale, st);
    case 2: return launch_quant<2, T>(q, k_new, v_new, cos_t, sin_t, k_pages, v_pages, k_scale, v_scale, table, positions, out, B, KVH, bs, NB, scale, st);
    case 4: return launch_quant<4, T>(q, k_new, v_new, cos_t, sin_t, k_pages, v_pages, k_scale, v_scale, table, positions, out, B, KVH, bs, NB, scale, st);
    case 8: return launch_quant<8, T>(q, k_new, v_new, cos_t, sin_t, k_pages, v_pages, k_scale, v_scale, table, positions, out, B, KVH, bs, NB, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int fused_decode_bf16(const void* q, const void* k_new,
                                 const void* v_new, const void* cos_t,
                                 const void* sin_t, void* k_pages,
                                 void* v_pages, const void* table,
                                 const void* positions, void* out, int B,
                                 int H, int KVH, int bs, int NB, float scale,
                                 void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / KVH) {
    case 1: return launch<1>(q, k_new, v_new, cos_t, sin_t, k_pages, v_pages, table, positions, out, B, KVH, bs, NB, scale, st);
    case 2: return launch<2>(q, k_new, v_new, cos_t, sin_t, k_pages, v_pages, table, positions, out, B, KVH, bs, NB, scale, st);
    case 4: return launch<4>(q, k_new, v_new, cos_t, sin_t, k_pages, v_pages, table, positions, out, B, KVH, bs, NB, scale, st);
    case 8: return launch<8>(q, k_new, v_new, cos_t, sin_t, k_pages, v_pages, table, positions, out, B, KVH, bs, NB, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fused_decode_int8(const void* q, const void* k_new,
                                 const void* v_new, const void* cos_t,
                                 const void* sin_t, void* k_pages,
                                 void* v_pages, void* k_scale, void* v_scale,
                                 const void* table, const void* positions,
                                 void* out, int B, int H, int KVH, int bs,
                                 int NB, float scale, void* stream) {
  return dispatch_quant<int8_t>(q, k_new, v_new, cos_t, sin_t, k_pages,
                                v_pages, k_scale, v_scale, table, positions,
                                out, B, H, KVH, bs, NB, scale, stream);
}

extern "C" int fused_decode_fp8(const void* q, const void* k_new,
                                const void* v_new, const void* cos_t,
                                const void* sin_t, void* k_pages,
                                void* v_pages, void* k_scale, void* v_scale,
                                const void* table, const void* positions,
                                void* out, int B, int H, int KVH, int bs,
                                int NB, float scale, void* stream) {
  return dispatch_quant<__nv_fp8_e4m3>(q, k_new, v_new, cos_t, sin_t, k_pages,
                                       v_pages, k_scale, v_scale, table,
                                       positions, out, B, H, KVH, bs, NB,
                                       scale, stream);
}
