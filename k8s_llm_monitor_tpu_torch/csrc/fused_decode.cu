// Fused decode attention for Hopper (sm_90a): RoPE + KV append + paged
// attention for one new token per lane, as split-KV flash-decoding.  One
// template over the page element type and whether the pool has scale
// planes serves the bf16 pool, the unscaled e4m3 pool
// (ModelConfig.kv_dtype = "float8_e4m3fn") and the int8 / fp8 (e4m3) pools
// with per-(token, head) float32 scale planes.
//
// Replaces: k8s_llm_monitor_tpu/ops/pallas_attention.py:
//   paged_decode_attention_fused (_fused_decode_kernel), bf16 or unscaled
//   e4m3 pages, and paged_decode_attention_fused_quant
//   (_fused_decode_quant_kernel), int8 / fp8 pages with quantize-on-append.
//
// What bounds it on this card: the bytes of the KV read.  Each lane reads
// pos * KVH * D page elements of K and of V once (plus two 4-byte scales
// per position and group on a quantized pool) and does 4 * H * D flops per
// cached position: about 2 * qpk flops per byte, far below the ~295
// flops/byte where the tensor cores become the limit.  So the arithmetic
// runs in f32 on CUDA cores and the design is about keeping enough bytes in
// flight.  The earlier design (one block of four warps per (group, lane),
// each warp walking one cached row at a time: a table load, then a
// dependent row load, then a warp sum and a rescale per key) left most SMs
// idle at small batch and ran at 4% of the card's bandwidth.  Now:
//   * the grid is (KVH, B, NSPLIT): each lane's context is cut into chunks
//     of `chunk` keys, one block each (NSPLIT = ceil(NB * bs / chunk) from
//     the table width, a host integer; a split that starts at or past the
//     lane's position exits at once), so a small batch still fills the SMs
//     and the grid depends on the table width only;
//   * a block loads its chunk's block-table entries into shared memory
//     once, divides positions by the block size by multiply and shift, and
//     stages K and V tiles of 32 keys with 16-byte cp.async in a ring of
//     STAGES tiles (rows past the context are zero-filled);
//   * a tile is scored for all qpk heads of the group at once: warp w
//     takes dims [32w, 32w + 32) of every key (lane = key, K rows padded by
//     16 bytes so the lanes' reads hit distinct banks, q broadcast from
//     shared memory), the D / 32 partial sums meet in shared memory;
//   * one max, one exp per key and one rescale per tile and head; PV from
//     shared memory with thread d owning output dim d of every head;
//   * each split writes its f32 partial (m, l, acc) to a workspace; a
//     second small kernel on the same stream merges the live splits by
//     log-sum-exp in a fixed order (no atomics: a rerun gives the same
//     bits) and writes the bf16 output.
// RoPE runs in f32 (the concatenated-halves rotation, the partner of dim d
// is d +- D/2), and split 0 alone ropes k, appends the new row and folds
// the current token into its partial from registers, never from the page.
// One template over the head dim D (64: llama-1b; 128: Llama-3-8B): a block
// has D threads (split_kv.cuh), so at D = 64 two warps score a tile's 32
// keys over 32 dims each, take four heads each in the softmax, and the
// partial scores still fit the q staging (2 warps x 32 keys = D floats per
// head).
//
// Safety of the in-place append: split 0 of (group, lane) writes only row
// `pos` of its lane, and only its group's D-slice of that row; every split
// reads only rows `< pos` of its own lane's blocks.  Lanes own disjoint
// blocks (the allocator hands out distinct tail blocks), so no block reads
// a row that another block writes.  The one shared target is the null
// block 0, which inactive lanes (pos == 0) and positions past the table
// write and no active lane ever reads.
//
// Traps mirrored from the TPU kernels:
//   * q is scaled by D**-0.5 in bf16 *before* RoPE (pallas_attention.py:521);
//   * RoPE runs in f32, and only the page copy of k is rounded to bf16
//     (:373-382, :390) -- the current token's score uses the f32 roped k;
//   * `positions` is the new token's position; 0 marks an inactive lane,
//     whose output is v_new (only the current token is visible);
//   * the table index is clamped, min(t / bs, NB - 1); keys past
//     NSPLIT * chunk (only a lane past the table has them) are not read.
// Unscaled e4m3 pool: loads widen e4m3 -> f32 with no scale; the appended
// row converts the f32 roped k and the raw v to e4m3 with jnp's semantics
// (round to nearest even, NaN with the sign past +-464: __NV_NOSAT, where
// __NV_SATFINITE would clamp to 448, pallas_attention.py:390-391), and the
// current token folds in unrounded, from the f32 row (:445-454).
// Quantized pools: the group's D-slice of the roped k (and of the raw v)
// is quantized per head, scale = max(amax / qmax, 1e-8), codes = x / scale
// rounded half to even and clipped at 127 (int8) or converted saturating
// at 448 (fp8), and the code row and its scale go to the lane's block at
// `pos` (block 0 for inactive lanes and past the table,
// pallas_attention.py:716-719).  Cached rows score as (q . codes) * k_scale
// and accumulate p * v_scale * codes, with the row sum l of the unscaled p.
// The current token is folded as codes * scale, where the int8 codes are
// rounded but the fp8 ones are NOT (:657-660): the pages get the fp8 value,
// the softmax the unrounded quotient x / scale.

#include <cuda_fp8.h>

#include "split_kv.cuh"

namespace {

#define kNegInf __int_as_float(0xff800000)  // -inf

__device__ __forceinline__ void cp_async4(void* dst, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// Page element types: widening 16 bytes of a row, one element, the store of
// an appended f32 value into a pool without scales, and (for the 1-byte
// types) quantize-on-append into a pool with scales.  Whether the pool has
// scale planes is the kernel's SCALED parameter, not the element type's:
// e4m3 pages come with scales (B4) or without (B8); int8 only with them.
template <typename T>
struct Page;

template <>
struct Page<__nv_bfloat16> {
  static __device__ __forceinline__ void widen(const uint4& raw, float out[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Page<int8_t> {
  static constexpr float kQmax = 127.f;
  static __device__ __forceinline__ void widen(const uint4& raw, float out[16]) {
    const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[4 * i] = c[i].x;
      out[4 * i + 1] = c[i].y;
      out[4 * i + 2] = c[i].z;
      out[4 * i + 3] = c[i].w;
    }
  }
  static __device__ __forceinline__ float one(const int8_t* p) { return *p; }
  static __device__ __forceinline__ float quantize(float x) {
    return fminf(fmaxf(rintf(x), -kQmax), kQmax);   // rounded, for the fold
  }
  static __device__ __forceinline__ int8_t code(float xq) {
    return static_cast<int8_t>(xq);
  }
};

template <>
struct Page<__nv_fp8_e4m3> {
  static constexpr float kQmax = 448.f;
  static __device__ __forceinline__ void widen(const uint4& raw, float out[16]) {
    const __nv_fp8x2_e4m3* h = reinterpret_cast<const __nv_fp8x2_e4m3*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 f = static_cast<float2>(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float one(const __nv_fp8_e4m3* p) {
    return static_cast<float>(*p);
  }
  static __device__ __forceinline__ float quantize(float x) {
    return x;   // not rounded: the TPU kernel folds the unrounded quotient
  }
  static __device__ __forceinline__ __nv_fp8_e4m3 code(float xq) {
    __nv_fp8_e4m3 c;
    c.__x = __nv_cvt_float_to_fp8(xq, __NV_SATFINITE, __NV_E4M3);
    return c;
  }
  // The unscaled pool: jnp's astype, NaN past +-464 (no saturation).
  static __device__ __forceinline__ __nv_fp8_e4m3 store(float x) {
    __nv_fp8_e4m3 c;
    c.__x = __nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3);
    return c;
  }
};

// x[d] * cos + rotate_half(x)[d] * sin, the partner of dim d at d +- D/2.
// Each product and the sum rounded on its own, as the plain version's
// separate PyTorch ops round them, so the roped k and the codes appended
// from it match the plain version bit for bit (a fused multiply-add may
// differ by an ulp).
template <int D>
__device__ __forceinline__ float rope(const float* x, int d, float c, float sn) {
  const float partner = x[d ^ (D / 2)];
  const float rot = d < D / 2 ? -partner : partner;
  return __fadd_rn(__fmul_rn(x[d], c), __fmul_rn(rot, sn));
}

// Shared-memory layout of the split kernel (bytes, 16-aligned pieces).
template <int D, int QPK, typename T, bool SCALED>
struct Smem {
  static constexpr int WARPS = D / PART;
  static constexpr int kRow = D * sizeof(T);        // page row slice
  static constexpr int kKRow = kRow + 16;           // padded: lanes on banks
  static constexpr int kK = 0;
  static constexpr int kV = TILE * kKRow;
  static constexpr int kScales = kV + TILE * kRow;  // k_scale[TILE], v_scale[TILE]
  static constexpr int kStage = kScales + (SCALED ? 2 * TILE * 4 : 0);
  static constexpr int kQ = STAGES * kStage;                // f32 [QPK][D]
  static constexpr int kS = kQ + QPK * D * 4;               // f32 [WARPS][QPK][TILE]
  static constexpr int kP = kS + WARPS * QPK * TILE * 4;    // f32 [TILE][QPK]
  static constexpr int kCur = kP + TILE * QPK * 4;          // f32 k, v, raw k [D]
  static constexpr int kHead = kCur + 3 * D * 4;            // f32 alpha, p_cur [8]
  static constexpr int kRed = kHead + 2 * 8 * 4;            // f32 [2][WARPS]
  static constexpr int kTable = kRed + 2 * WARPS * 4;       // int [table_n]
  static_assert(WARPS * TILE == D, "the partial scores reuse the q staging");
};

template <int D, int QPK, typename T, bool SCALED>
__global__ void __launch_bounds__(D)
fused_decode_split_kernel(const __nv_bfloat16* __restrict__ q,      // [B, H, D]
                          const __nv_bfloat16* __restrict__ k_new,  // [B, KVH, D]
                          const __nv_bfloat16* __restrict__ v_new,  // [B, KVH, D]
                          const float* __restrict__ cos_t,          // [B, D]
                          const float* __restrict__ sin_t,          // [B, D]
                          T* k_pages,                               // [nb, bs, KVH*D]
                          T* v_pages,
                          float* k_scale,                           // [nb, bs, KVH]
                          float* v_scale,                           // (quant only)
                          const int* __restrict__ table,            // [B, NB]
                          const int* __restrict__ positions,        // [B]
                          float* __restrict__ ws_acc,  // [B, KVH, NSPLIT, QPK, D]
                          float* __restrict__ ws_ml,   // [B, KVH, NSPLIT, QPK, 2]
                          int KVH, int bs, int NB, int nsplit, int chunk,
                          unsigned bs_mul, unsigned bs_shr, float scale) {
  using L = Smem<D, QPK, T, SCALED>;
  using P = Page<T>;
  static_assert(SCALED || !std::is_same<T, int8_t>::value,
                "int8 pages need scale planes");
  constexpr int THREADS = D, WARPS = L::WARPS;
  constexpr int HPW = (QPK + WARPS - 1) / WARPS;   // heads per warp (softmax)
  constexpr int E = 16 / sizeof(T);                // elements per 16 bytes
  constexpr int CPR = L::kRow / 16;                // 16-byte chunks per row
  static_assert(TILE * CPR % THREADS == 0, "a tile is whole 16-byte loads");
  extern __shared__ __align__(16) unsigned char smem[];

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int d = threadIdx.x;
  const int warp = d / 32;
  const int lane = d % 32;
  const int H = KVH * QPK;
  const long F = (long)KVH * D;
  const int pos = positions[b];
  const int k0 = s * chunk;
  if (s > 0 && k0 >= pos) return;        // no key: the merge never reads it
  const int k1 = min(k0 + chunk, pos);   // keys [k0, k1) of this split

  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  float* sp = reinterpret_cast<float*>(smem + L::kS);
  float* pt = reinterpret_cast<float*>(smem + L::kP);
  float* kcur = reinterpret_cast<float*>(smem + L::kCur);
  float* vcur = kcur + D;
  float* kraw = vcur + D;
  float* alpha_s = reinterpret_cast<float*>(smem + L::kHead);
  float* pcur = alpha_s + 8;
  float* red = reinterpret_cast<float*>(smem + L::kRed);
  int* tbl = reinterpret_cast<int*>(smem + L::kTable);

  auto div_bs = [&](int t) { return div_block(t, bs_mul, bs_shr); };

  // Stage the bf16-scaled q (in the partial-score buffer), split 0's raw
  // k, and the table entries this split's keys use.
  const float c = cos_t[(long)b * D + d];
  const float sn = sin_t[(long)b * D + d];
#pragma unroll
  for (int j = 0; j < QPK; ++j) {
    const float x = __bfloat162float(q[((long)b * H + g * QPK + j) * D + d]);
    sp[j * D + d] = __bfloat162float(__float2bfloat16_rn(x * scale));
  }
  float kx = 0.f, vx = 0.f;
  if (s == 0) {
    kx = __bfloat162float(k_new[((long)b * KVH + g) * D + d]);
    vx = __bfloat162float(v_new[((long)b * KVH + g) * D + d]);
    kraw[d] = kx;
  }
  const int fb = min(div_bs(k0), NB - 1);
  if (k1 > k0) {
    const int nt = min(div_bs(k1 - 1), NB - 1) - fb + 1;
    for (int i = d; i < nt; i += THREADS) tbl[i] = table[(long)b * NB + fb + i];
  }
  __syncthreads();

  // RoPE: x * cos + rotate_half(x) * sin, partner dim d +- D/2.
#pragma unroll
  for (int j = 0; j < QPK; ++j) qs[j * D + d] = rope<D>(sp + j * D, d, c, sn);
  if (s == 0) {
    const float kf = rope<D>(kraw, d, c, sn);
    // Append the roped k and the raw v row at `pos` (quantized per head on
    // a pool with scales), and keep what the current token folds in.
    const int raw_blk = pos / bs;
    const int blk = (pos > 0 && raw_blk < NB) ? table[(long)b * NB + raw_blk] : 0;
    const long slot = (long)blk * bs + pos % bs;
    const long at = slot * F + (long)g * D + d;
    if constexpr (SCALED) {
      const float ka = warp_max(fabsf(kf));
      const float va = warp_max(fabsf(vx));
      if (lane == 0) {
        red[warp] = ka;
        red[WARPS + warp] = va;
      }
      __syncthreads();
      float kam = red[0], vam = red[WARPS];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) {
        kam = fmaxf(kam, red[w]);
        vam = fmaxf(vam, red[WARPS + w]);
      }
      const float ks_cur = fmaxf(kam / P::kQmax, 1e-8f);
      const float vs_cur = fmaxf(vam / P::kQmax, 1e-8f);
      const float kq = P::quantize(kf / ks_cur);
      const float vq = P::quantize(vx / vs_cur);
      k_pages[at] = P::code(kq);
      v_pages[at] = P::code(vq);
      if (d == 0) {
        k_scale[slot * KVH + g] = ks_cur;
        v_scale[slot * KVH + g] = vs_cur;
      }
      kcur[d] = kq * ks_cur;
      vcur[d] = vq * vs_cur;
    } else {
      k_pages[at] = P::store(kf);
      v_pages[at] = P::store(vx);
      kcur[d] = kf;
      vcur[d] = vx;
    }
  }

  // Online softmax state: m, l per head (warp w owns heads w, w + WARPS,
  // ...; its lanes hold copies), acc[j] = output dim d of head j.
  float m[HPW], l[HPW], acc[QPK];
#pragma unroll
  for (int jj = 0; jj < HPW; ++jj) {
    m[jj] = kNegInf;
    l[jj] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < QPK; ++j) acc[j] = 0.f;

  // Copy tile i (keys k0 + 32 i ...) into ring stage st; rows past k1 are
  // zero-filled (src-size 0), so no stale value meets a zero weight.
  auto load_tile = [&](int i, int st) {
    unsigned char* base = smem + st * L::kStage;
    const int t0 = k0 + i * TILE;
#pragma unroll
    for (int it = 0; it < TILE * CPR / THREADS; ++it) {
      const int idx = d + it * THREADS;
      const int r = idx / CPR, ch = idx % CPR;
      const int t = t0 + r;
      const bool ok = t < k1;
      const int q_ = div_bs(t);
      const int blk = ok ? tbl[min(q_, NB - 1) - fb] : 0;
      const long off = ((long)blk * bs + (t - q_ * bs)) * F + (long)g * D;
      const unsigned char* kp = reinterpret_cast<const unsigned char*>(k_pages);
      const unsigned char* vp = reinterpret_cast<const unsigned char*>(v_pages);
      const long bo = off * (long)sizeof(T) + ch * 16;
      cp_async16(base + L::kK + r * L::kKRow + ch * 16, ok ? kp + bo : kp, ok ? 16 : 0);
      cp_async16(base + L::kV + r * L::kRow + ch * 16, ok ? vp + bo : vp, ok ? 16 : 0);
    }
    if constexpr (SCALED) {
      if (d < 2 * TILE) {
        const int r = d % TILE;
        const int t = t0 + r;
        const bool ok = t < k1;
        const int q_ = div_bs(t);
        const int blk = ok ? tbl[min(q_, NB - 1) - fb] : 0;
        const long at = ((long)blk * bs + (t - q_ * bs)) * KVH + g;
        const float* src = d < TILE ? k_scale : v_scale;
        cp_async4(base + L::kScales + d * 4, ok ? src + at : src, ok ? 4 : 0);
      }
    }
  };

  const int ntiles = k1 > k0 ? (k1 - k0 + TILE - 1) / TILE : 0;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) load_tile(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();          // tile i landed for all; stage (i-1) is free
    {
      const int nx = i + STAGES - 1;
      if (nx < ntiles) load_tile(nx, nx % STAGES);
      cp_async_commit();
    }
    const unsigned char* base = smem + (i % STAGES) * L::kStage;

    // Scores: warp w, lane = key, dims [32w, 32w + 32), every head.
    {
      float sc[QPK];
#pragma unroll
      for (int j = 0; j < QPK; ++j) sc[j] = 0.f;
      const unsigned char* krow = base + L::kK + lane * L::kKRow + warp * PART * sizeof(T);
#pragma unroll
      for (int ch = 0; ch < PART * (int)sizeof(T) / 16; ++ch) {
        float kv[E];
        P::widen(*reinterpret_cast<const uint4*>(krow + ch * 16), kv);
        const int d0 = warp * PART + ch * E;
#pragma unroll
        for (int j = 0; j < QPK; ++j) {
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + j * D + d0 + e);
            sc[j] += qv.x * kv[e] + qv.y * kv[e + 1] + qv.z * kv[e + 2] + qv.w * kv[e + 3];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < QPK; ++j) sp[(warp * QPK + j) * TILE + lane] = sc[j];
    }
    __syncthreads();

    // Softmax: warp w takes heads w, w + WARPS, ...; lane = key.
    {
      const int t = k0 + i * TILE + lane;
      const bool ok = t < k1;
      const float* scl = reinterpret_cast<const float*>(base + L::kScales);
#pragma unroll
      for (int jj = 0; jj < HPW; ++jj) {
        const int j = warp + jj * WARPS;
        if (j < QPK) {
          float x = sp[(0 * QPK + j) * TILE + lane];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) x += sp[(w * QPK + j) * TILE + lane];
          if constexpr (SCALED) x *= scl[lane];
          x = ok ? x : kNegInf;
          const float m_new = fmaxf(m[jj], warp_max(x));   // key 0 is live
          const float alpha = __expf(m[jj] - m_new);
          const float p = ok ? __expf(x - m_new) : 0.f;
          l[jj] = alpha * l[jj] + warp_sum(p);
          m[jj] = m_new;
          float pv = p;
          if constexpr (SCALED) pv *= scl[TILE + lane];
          pt[lane * QPK + j] = pv;
          if (lane == 0) alpha_s[j] = alpha;
        }
      }
    }
    __syncthreads();

    // PV: thread d, every head, every key of the tile.
    {
      float al[QPK];
#pragma unroll
      for (int j = 0; j < QPK; ++j) {
        al[j] = alpha_s[j];
        acc[j] *= al[j];
      }
      const T* vcol = reinterpret_cast<const T*>(base + L::kV) + d;
#pragma unroll 8
      for (int k = 0; k < TILE; ++k) {
        const float v = P::one(vcol + k * D);
        float pk[QPK];
        load_heads<QPK>(pt + k * QPK, pk);
#pragma unroll
        for (int j = 0; j < QPK; ++j) acc[j] += pk[j] * v;
      }
    }
  }

  // Split 0 folds the current token in, from registers and shared memory
  // (never from the page): q . k_cur in the lanes' D / 32 dims, warp sum.
  if (s == 0) {
    constexpr int EPL = D / 32;
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < HPW; ++jj) {
      const int j = warp + jj * WARPS;
      if (j < QPK) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) x += qs[j * D + lane * EPL + e] * kcur[lane * EPL + e];
        x = warp_sum(x);
        const float m_new = fmaxf(m[jj], x);
        const float alpha = __expf(m[jj] - m_new);
        const float pc = __expf(x - m_new);
        l[jj] = alpha * l[jj] + pc;
        m[jj] = m_new;
        if (lane == 0) {
          alpha_s[j] = alpha;
          pcur[j] = pc;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < QPK; ++j) acc[j] = alpha_s[j] * acc[j] + pcur[j] * vcur[d];
  }

  // The split's partial state.
  const long base = (((long)b * KVH + g) * nsplit + s) * QPK;
#pragma unroll
  for (int j = 0; j < QPK; ++j) ws_acc[(base + j) * D + d] = acc[j];
#pragma unroll
  for (int jj = 0; jj < HPW; ++jj) {
    const int j = warp + jj * WARPS;
    if (j < QPK && lane == 0) {
      ws_ml[(base + j) * 2] = m[jj];
      ws_ml[(base + j) * 2 + 1] = l[jj];
    }
  }
}

// Merge the live splits of (group, lane) by log-sum-exp (split_kv.cuh).
// Split 0 always holds the current token, so its m is real; splits past
// the lane's position wrote nothing and are not read.
template <int D, int QPK>
__global__ void __launch_bounds__(D)
fused_decode_merge_kernel(const float* __restrict__ ws_acc,
                          const float* __restrict__ ws_ml,
                          const int* __restrict__ positions,
                          __nv_bfloat16* __restrict__ out,   // [B, H, D]
                          int KVH, int nsplit, int chunk) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int pos = positions[b];
  const int n = min(nsplit, max(1, (pos + chunk - 1) / chunk));
  merge_splits<D, QPK>(ws_acc, ws_ml, ((long)b * KVH + g) * nsplit * QPK, QPK, n,
                    out + ((long)b * KVH + g) * QPK * D + threadIdx.x);
}

template <int D, int QPK, typename T, bool SCALED>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   const void* cos_t, const void* sin_t, void* k_pages,
                   void* v_pages, void* k_scale, void* v_scale,
                   const void* table, const void* positions, void* out,
                   void* ws, int B, int KVH, int bs, int NB, int nsplit,
                   int chunk, float scale, cudaStream_t stream) {
  using L = Smem<D, QPK, T, SCALED>;
  if (!splits_ok(bs, NB, nsplit, chunk)) return cudaErrorInvalidValue;
  const int table_n = (chunk - 1) / bs + 2;
  const size_t smem = L::kTable + 4 * (size_t)table_n;
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_decode_split_kernel<D, QPK, T, SCALED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const BlockDiv div = block_div(bs);
  float* acc = static_cast<float*>(ws);
  float* ml = acc + (size_t)B * KVH * nsplit * QPK * D;
  fused_decode_split_kernel<D, QPK, T, SCALED><<<dim3(KVH, B, nsplit), D, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<T*>(k_pages), static_cast<T*>(v_pages),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const int*>(table), static_cast<const int*>(positions), acc,
      ml, KVH, bs, NB, nsplit, chunk, div.mul, div.shr, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fused_decode_merge_kernel<D, QPK><<<dim3(KVH, B), D, 0, stream>>>(
      acc, ml, static_cast<const int*>(positions),
      static_cast<__nv_bfloat16*>(out), KVH, nsplit, chunk);
  return cudaGetLastError();
}

template <typename T, bool SCALED>
int dispatch(const void* q, const void* k_new, const void* v_new,
             const void* cos_t, const void* sin_t, void* k_pages,
             void* v_pages, void* k_scale, void* v_scale, const void* table,
             const void* positions, void* out, void* ws, int B, int H,
             int KVH, int D, int bs, int NB, int nsplit, int chunk,
             float scale, void* stream) {
  if (B == 0) return 0;
  if (KVH < 1 || H % KVH != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_geometry(D, H / KVH, [&](auto d, auto qpk) {
    return launch<decltype(d)::value, decltype(qpk)::value, T, SCALED>(
        q, k_new, v_new, cos_t, sin_t, k_pages, v_pages, k_scale, v_scale,
        table, positions, out, ws, B, KVH, bs, NB, nsplit, chunk, scale, st);
  });
}

}  // namespace

// `workspace` holds B * KVH * nsplit * qpk * (D + 2) floats; nsplit and
// chunk (a multiple of 32, nsplit * chunk >= NB * bs) come from
// ops/paged_attention.py:decode_splits.  D is 64 or 128.
extern "C" int fused_decode_bf16(const void* q, const void* k_new,
                                 const void* v_new, const void* cos_t,
                                 const void* sin_t, void* k_pages,
                                 void* v_pages, const void* table,
                                 const void* positions, void* out,
                                 void* workspace, int B, int H, int KVH,
                                 int D, int bs, int NB, int nsplit,
                                 int chunk, float scale, void* stream) {
  return dispatch<__nv_bfloat16, false>(q, k_new, v_new, cos_t, sin_t,
                                        k_pages, v_pages, nullptr, nullptr,
                                        table, positions, out, workspace, B,
                                        H, KVH, D, bs, NB, nsplit, chunk,
                                        scale, stream);
}

// The unscaled e4m3 pool: the bf16 symbol's arguments.
extern "C" int fused_decode_e4m3(const void* q, const void* k_new,
                                 const void* v_new, const void* cos_t,
                                 const void* sin_t, void* k_pages,
                                 void* v_pages, const void* table,
                                 const void* positions, void* out,
                                 void* workspace, int B, int H, int KVH,
                                 int D, int bs, int NB, int nsplit,
                                 int chunk, float scale, void* stream) {
  return dispatch<__nv_fp8_e4m3, false>(q, k_new, v_new, cos_t, sin_t,
                                        k_pages, v_pages, nullptr, nullptr,
                                        table, positions, out, workspace, B,
                                        H, KVH, D, bs, NB, nsplit, chunk,
                                        scale, stream);
}

extern "C" int fused_decode_int8(const void* q, const void* k_new,
                                 const void* v_new, const void* cos_t,
                                 const void* sin_t, void* k_pages,
                                 void* v_pages, void* k_scale, void* v_scale,
                                 const void* table, const void* positions,
                                 void* out, void* workspace, int B, int H,
                                 int KVH, int D, int bs, int NB, int nsplit,
                                 int chunk, float scale, void* stream) {
  return dispatch<int8_t, true>(q, k_new, v_new, cos_t, sin_t, k_pages,
                                v_pages, k_scale, v_scale, table, positions,
                                out, workspace, B, H, KVH, D, bs, NB, nsplit,
                                chunk, scale, stream);
}

extern "C" int fused_decode_fp8(const void* q, const void* k_new,
                                const void* v_new, const void* cos_t,
                                const void* sin_t, void* k_pages,
                                void* v_pages, void* k_scale, void* v_scale,
                                const void* table, const void* positions,
                                void* out, void* workspace, int B, int H,
                                int KVH, int D, int bs, int NB, int nsplit,
                                int chunk, float scale, void* stream) {
  return dispatch<__nv_fp8_e4m3, true>(q, k_new, v_new, cos_t, sin_t,
                                       k_pages, v_pages, k_scale, v_scale,
                                       table, positions, out, workspace, B, H,
                                       KVH, D, bs, NB, nsplit, chunk, scale,
                                       stream);
}
