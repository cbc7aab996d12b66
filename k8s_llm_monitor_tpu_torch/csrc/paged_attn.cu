// Paged attention for Hopper (sm_90a): QS = 1..8 query tokens per lane over
// a bf16 or unscaled e4m3, e5m2 or fp16 paged pool (ModelConfig.kv_dtype =
// "float8_e4m3fn", "float8_e5m2", "float16") that already holds them -- no
// append, no RoPE -- as split-KV flash-decoding, one template for decode
// and verify.
//
// Replaces: k8s_llm_monitor_tpu/ops/pallas_attention.py:_run_paged_attn
//           (_paged_attn_kernel), behind paged_decode_attention_pallas
//           (QS = 1, the split decode path) and paged_verify_attention_pallas
//           (QS > 1, speculative verify).
//
// Query token i of lane b sits at starts[b] + i and sees keys at positions
// <= starts[b] + i (pallas_attention.py:149); qlens[b] counts its live
// tokens.  Decode enters with lengths instead and the kernels derive
// starts = max(lengths - 1, 0), qlens = min(lengths, 1)
// (pallas_attention.py:281-282).  Lanes with qlens <= 0 and rows past
// qlens come back as zeros (the TPU kernel leaves garbage there; no caller
// reads them).  Row r of a group is token r / qpk, head r % qpk: the TPU
// kernel's block-diagonal q is an MXU workaround; the port works per kv group.
//
// What bounds it on this card: the bytes of the KV read.  A lane's keys
// [0, starts + qlens) are read once for all R = QS * qpk rows of a group:
// 2 R flops per byte of K/V, 8 at decode (qpk 4), 64 at QS = 8 (qpk 4) --
// past the f32 CUDA cores' ridge (~20), below the bf16 tensor cores' (~295).
// The design is csrc/fused_decode.cu's without RoPE and the append (the
// helpers and the merge are split_kv.cuh's):
//   * grid (KVH, B, NSPLIT): each lane's context is cut into chunks of
//     `chunk` keys, one block each (NSPLIT and chunk from the table width,
//     host integers: ops/paged_attention.py:decode_splits); a split that
//     starts at or past starts + qlens exits at once;
//   * one block holds all R rows of its (group, lane), so the chunk is read
//     once for every query token; q is staged once, scaled and rounded;
//   * a block loads its chunk's block-table entries into shared memory
//     once, divides positions by the block size by multiply and shift, and
//     stages K and V tiles of 32 keys with 16-byte cp.async in a ring of
//     STAGES tiles (rows past the split are zero-filled; rows padded by 16
//     bytes so neither the lanes' reads nor ldmatrix's collide on banks);
//   * decode (QS = 1, R <= 8, MT = 0): the tile is scored for all qpk heads
//     at once on the CUDA cores in f32 -- warp w takes dims [32w, 32w + 32)
//     of every key (lane = key, q broadcast from shared memory), the D / 32
//     partial sums meet in shared memory; PV with thread d owning output
//     dim d, P in f32;
//   * verify (QS > 1, MT = ceil(R / 16) rounded up to 1, 2 or 4 row tiles
//     of 16): S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 operands,
//     f32 accumulators; P rounded to bf16 for PV, as csrc/flash_prefill.cu
//     does against the same plain version).  Warp w scores NKT n-tiles of 8
//     keys of the tile for every row (NKT = 32 / (8 D / 32): 1 at D = 128,
//     2 at D = 64) and owns output dims [32w, 32w + 32);
//   * one online-softmax step per tile and row: TPR threads per row, each
//     over TILE / TPR keys, one max, one exp per key, one rescale; the
//     causal mask only on tiles that cross a live row's horizon, by selects
//     (a per-row branch serialised the loop of the earlier design, PERF.md);
//   * each split writes its f32 partial (m, l, acc) per row to a
//     workspace; a second kernel, one block per (group, lane, token),
//     merges the splits that token sees by log-sum-exp in split order
//     (no atomics: a rerun gives the same bits) and writes bf16.
// Rows that see no key of a split keep m = NEG, l = 0: NEG is finite, so a
// rescale by exp(NEG - NEG) is 1, never NaN, and the merge weighs such a
// partial by exp(NEG - M) = 0.  Dead and padding rows carry q = 0: finite
// scores that nothing reads.
//
// One template over the head dim D (64: llama-1b; 128: Llama-3-8B): a block
// has D threads (split_kv.cuh), so at D = 64 the softmax gives each row
// twice the keys per thread (TPR halves) and each warp scores two key
// n-tiles; the PV n-tiles per warp stay 4 (32 dims).
//
// An e4m3 pool (the TPU kernel casts any page dtype to f32,
// pallas_attention.py:150-151): the tile loads read 8 bytes of codes a
// thread with plain loads and write them widened to bf16 -- exact, every
// e4m3 value is a bf16 -- into the same shared rows the bf16 pool's
// cp.async fills, so QS = 1 on the CUDA cores and QS > 1 on mma.sync run
// unchanged on them.  No scale: the pool has none.  An e5m2 pool takes the
// same loads: e5m2 is the top byte of an fp16, and bf16 holds every value.
//
// An fp16 pool (B9): bf16 rows cannot hold fp16 values (7 mantissa bits to
// 10), so its tiles are staged as they lie, by the bf16 pool's cp.async,
// and every reader of the shared rows reads fp16 (the Row<T> trait):
// QS = 1 widens them to f32 on the CUDA cores, exactly; QS > 1 runs
// mma.sync m16n8k16 with f16 operands, f32 accumulators.  Of the three
// designs for the tensor cores (tf32 m16n8k8; a bf16 hi/lo split of each
// page value, two products; f16 operands) this is the third: it reads the
// bf16 pool's bytes, issues the bf16 pool's MMAs and needs no new fragment
// layout.  What it rounds: q (scaled and rounded to bf16 as for every
// pool) converts to f16 exactly from 2^-17 up to 65504, so only components
// below 2^-17 lose bits, each by less than 2^-25 (finite q past 65504
// would overflow: no model's scaled q comes near); P is rounded to f16
// where the bf16 pool rounds it to bf16, a finer rounding for P >= 2^-14.
//
// Trap: the kernels scale q by D**-0.5 and round it to bf16 before use, as
// the plain version and pallas_attention.py:208 scale in bf16.

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "split_kv.cuh"

namespace {

constexpr int SROW = TILE + 8;      // a row of S (f32) or P (bf16), padded
constexpr int MAX_QS = 8;           // ops/paged_attention.py:MAX_QUERY_TOKENS
constexpr float NEG = -0.7f * 3.402823466e38f;

// Four 8x8 b16 matrices from shared memory (lane l gives row l % 8 of
// matrix l / 8), as mma fragments; .trans delivers them transposed.
__device__ __forceinline__ void ldsm4(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s) : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s) : "memory");
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b: a 16x16 f16 (row), b 16x8 f16 (col), c 16x8 f32.
__device__ __forceinline__ void mma16816_f16(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16-bit element type of the shared K / V / q / P rows and its
// operations: bf16 for the bf16 and fp8 pools, fp16 for the fp16 pool.
template <bool F16>
struct Row {
  static __device__ __forceinline__ float2 widen2(uint32_t w) {
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
  }
  static __device__ __forceinline__ float widen1(uint16_t h) {
    return __uint_as_float(static_cast<uint32_t>(h) << 16);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    mma16816(c, a, b0, b1);
  }
};

template <>
struct Row<true> {
  static __device__ __forceinline__ float2 widen2(uint32_t w) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  }
  static __device__ __forceinline__ float widen1(uint16_t h) {
    return __half2float(__ushort_as_half(h));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    mma16816_f16(c, a, b0, b1);
  }
};

// fp8 interpretation of a 1-byte page type.
template <typename T>
constexpr __nv_fp8_interpretation_t kFp8 =
    std::is_same<T, __nv_fp8_e5m2>::value ? __NV_E5M2 : __NV_E4M3;

// Eight e4m3 or e5m2 codes (8 bytes, little-endian) as eight bf16 (16
// bytes), exactly: the codes widen through f16 to f32, and bf16 holds every
// e4m3 and e5m2 value.
template <typename T>
__device__ __forceinline__ uint4 fp8x8_to_bf16(uint2 raw) {
  uint4 out;
  uint32_t* o = &out.x;
  const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w[i / 2] >> (16 * (i % 2))), kFp8<T>);
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
    const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
    o[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  return out;
}

// Lane b's query tokens: the first at `start`, `qlen` of them live.
struct Span {
  int start, qlen;
};

__device__ __forceinline__ Span lane_span(const int* starts, const int* qlens,
                                          const int* lengths, int b) {
  if (lengths != nullptr) {
    const int n = lengths[b];
    return {max(n - 1, 0), min(n, 1)};
  }
  return {starts[b], qlens[b]};
}

// Shared-memory layout of the split kernel (bytes, 16-aligned pieces):
// qpk heads per group, MT row tiles of 16 on the tensor cores (0: decode
// on the CUDA cores, rows r < QPK).
template <int D, int QPK, int MT>
struct Smem {
  static constexpr int WARPS = D / PART;
  static constexpr int KROW = D * 2 + 16;    // a K, V or q row, padded
  static constexpr bool kMma = MT > 0;
  static constexpr int kRows = kMma ? 16 * MT : 16;          // softmax rows
  static constexpr int kStage = 2 * TILE * KROW;             // K tile, V tile
  static constexpr int kQ = STAGES * kStage;  // bf16 [kRows][KROW / 2] | f32 [QPK][D]
  static constexpr int kS = kQ + (kMma ? kRows * KROW : QPK * D * 4);
  // f32 S [kRows][SROW] | partial sums [WARPS][QPK][TILE]
  static constexpr int kP = kS + (kMma ? kRows * SROW * 4 : WARPS * QPK * TILE * 4);
  // bf16 P [kRows][SROW] | f32 [QPK][TILE]
  static constexpr int kAlpha = kP + (kMma ? kRows * SROW * 2 : QPK * TILE * 4);
  static constexpr int kTable = kAlpha + kRows * 4;          // int [table_n]
};

template <int D, int QPK, int MT, typename T>
__global__ void __launch_bounds__(D)
paged_attn_split_kernel(const __nv_bfloat16* __restrict__ q,   // [B, QS, H, D]
                        const T* __restrict__ k_pages,         // [nb, bs, KVH*D]
                        const T* __restrict__ v_pages,
                        const int* __restrict__ table,         // [B, NB]
                        const int* __restrict__ starts,        // [B] (or null)
                        const int* __restrict__ qlens,         // [B] (or null)
                        const int* __restrict__ lengths,       // [B] (decode)
                        float* __restrict__ ws_acc,  // [B, KVH, NSPLIT, QS*QPK, D]
                        float* __restrict__ ws_ml,   // [B, KVH, NSPLIT, QS*QPK, 2]
                        int QS, int KVH, int bs, int NB, int nsplit, int chunk,
                        unsigned bs_mul, unsigned bs_shr, float scale) {
  using L = Smem<D, QPK, MT>;
  using RT = Row<std::is_same<T, __half>::value>;
  constexpr int THREADS = D, WARPS = L::WARPS, KROW = L::KROW;
  constexpr bool MMA = L::kMma;
  constexpr int ROWS = L::kRows;
  constexpr int TPR = THREADS / ROWS;   // softmax threads per row
  constexpr int KPT = TILE / TPR;       // keys per softmax thread
  constexpr int NKT = TILE / (8 * WARPS);   // key n-tiles a warp scores
  static_assert(THREADS % ROWS == 0 && KPT % 4 == 0,
                "the softmax moves a row's keys as float4");
  constexpr int CPR = D * 2 / 16;       // 16-byte chunks per 16-bit row
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
  const Span sp = lane_span(starts, qlens, lengths, b);
  const int kv_end = sp.start + sp.qlen;  // the lane's keys: [0, kv_end)
  const int k0 = s * chunk;
  if (sp.qlen <= 0 || k0 >= kv_end) return;   // the merge never reads it
  const int k1 = min(k0 + chunk, kv_end);     // keys [k0, k1) of this split
  const int R = QS * QPK;                     // workspace rows per split

  float* sc_s = reinterpret_cast<float*>(smem + L::kS);
  float* alpha_s = reinterpret_cast<float*>(smem + L::kAlpha);
  int* tbl = reinterpret_cast<int*>(smem + L::kTable);

  auto div_bs = [&](int t) { return div_block(t, bs_mul, bs_shr); };

  // Stage q, scaled and rounded to bf16 (zeros for dead and padding rows),
  // as a row of the pool's 16-bit type, and the split's table entries.
  if constexpr (MMA) {
    for (int idx = d; idx < ROWS * (D / 8); idx += THREADS) {
      const int r = idx / (D / 8), c = idx % (D / 8);
      const int i = r / QPK;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < R && i < sp.qlen) {
        v = *reinterpret_cast<const uint4*>(
            q + (((long)b * QS + i) * H + g * QPK + r % QPK) * D + c * 8);
        uint32_t* h = &v.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = Row<false>::widen2(h[e]);
          const float2 rq = Row<false>::widen2(
              Row<false>::pack(f.x * scale, f.y * scale));
          h[e] = RT::pack(rq.x, rq.y);
        }
      }
      *reinterpret_cast<uint4*>(smem + L::kQ + r * KROW + c * 16) = v;
    }
  } else {
    float* qs = reinterpret_cast<float*>(smem + L::kQ);
#pragma unroll
    for (int j = 0; j < QPK; ++j) {
      const float x = __bfloat162float(q[((long)b * QS * H + g * QPK + j) * D + d]);
      qs[j * D + d] = __bfloat162float(__float2bfloat16_rn(x * scale));
    }
  }
  const int fb = min(div_bs(k0), NB - 1);
  {
    const int nt = min(div_bs(k1 - 1), NB - 1) - fb + 1;
    for (int i = d; i < nt; i += THREADS) tbl[i] = table[(long)b * NB + fb + i];
  }
  __syncthreads();            // the tile loads read the table entries

  // Copy tile i (keys k0 + 32 i ...) into ring stage st as 16-bit rows, 8
  // elements per chunk; rows past k1 are zero-filled (src-size 0 on bf16
  // and fp16 pages), so no stale value meets a zero weight.  fp8 pages are
  // read and widened to bf16 here (the ring's __syncthreads publish the
  // stores as they do the copies).
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
      const long e = ((long)blk * bs + (t - q_ * bs)) * F + (long)g * D + ch * 8;
      unsigned char* kd = base + r * KROW + ch * 16;
      unsigned char* vd = base + (TILE + r) * KROW + ch * 16;
      if constexpr (sizeof(T) == 2) {
        cp_async16(kd, ok ? k_pages + e : k_pages, ok ? 16 : 0);
        cp_async16(vd, ok ? v_pages + e : v_pages, ok ? 16 : 0);
      } else {
        uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
        if (ok) {
          kw = fp8x8_to_bf16<T>(*reinterpret_cast<const uint2*>(k_pages + e));
          vw = fp8x8_to_bf16<T>(*reinterpret_cast<const uint2*>(v_pages + e));
        }
        *reinterpret_cast<uint4*>(kd) = kw;
        *reinterpret_cast<uint4*>(vd) = vw;
      }
    }
  };

  // Softmax state of row sr (its TPR threads hold copies).  The row sees
  // keys < lim of this split (a dead row: lim = k0, none).  Token 0's
  // horizon is the lowest, so a tile below lim_min needs no mask.
  const int sr = d / TPR;
  const int seg = d % TPR;
  const int tok = sr / QPK;
  const bool row_live = MMA ? (sr < R && tok < sp.qlen) : sr < QPK;
  const int lim = row_live ? min(k1, sp.start + tok + 1) : k0;
  const int lim_min = min(k1, sp.start + 1);
  float m = NEG, l = 0.f;
  // Decode: acc[j], output dim d of head j.  Verify: o[mt][nt], the mma
  // accumulator of rows [16 mt, 16 mt + 16), dims 32 warp + 8 nt + [0, 8).
  constexpr int NACC = MMA ? 1 : QPK;
  constexpr int NMT = MMA ? MT : 1;
  float acc[NACC];
  float o[NMT][4][4];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
#pragma unroll
  for (int mt = 0; mt < NMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
  const int gq = lane / 4, tig = lane % 4;   // mma fragment coordinates

  const int ntiles = (k1 - k0 + TILE - 1) / TILE;
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
    const int t0 = k0 + i * TILE;

    if constexpr (MMA) {
      // S = Q K^T: warp w, keys [8 NKT w, 8 NKT (w + 1)) in n-tiles of 8,
      // every row tile.  K rows are the B operand as they lie (k = dim
      // contiguous).
#pragma unroll
      for (int kt = 0; kt < NKT; ++kt) {
        const int key0 = 8 * (NKT * warp + kt);
        uint32_t kb[D / 16][2];
#pragma unroll
        for (int c = 0; c < D / 32; ++c) {
          uint32_t r4[4];
          ldsm4(r4, base + (key0 + lane % 8) * KROW + (32 * c + 8 * (lane / 8)) * 2);
          kb[2 * c][0] = r4[0];
          kb[2 * c][1] = r4[1];
          kb[2 * c + 1][0] = r4[2];
          kb[2 * c + 1][1] = r4[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float c4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            uint32_t a[4];
            ldsm4(a, smem + L::kQ + (16 * mt + lane % 16) * KROW + (16 * ks + 8 * (lane / 16)) * 2);
            RT::mma(c4, a, kb[ks][0], kb[ks][1]);
          }
          float* row0 = sc_s + (16 * mt + gq) * SROW + key0 + 2 * tig;
          *reinterpret_cast<float2*>(row0) = make_float2(c4[0], c4[1]);
          *reinterpret_cast<float2*>(row0 + 8 * SROW) = make_float2(c4[2], c4[3]);
        }
      }
    } else {
      // Scores: warp w, lane = key, dims [32w, 32w + 32), every head.
      const float* qs = reinterpret_cast<const float*>(smem + L::kQ);
      float sc[QPK];
#pragma unroll
      for (int j = 0; j < QPK; ++j) sc[j] = 0.f;
      const unsigned char* krow = base + lane * KROW + warp * PART * 2;
#pragma unroll
      for (int ch = 0; ch < PART * 2 / 16; ++ch) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + ch * 16);
        const uint32_t* h = &raw.x;
        float kv[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = RT::widen2(h[e]);
          kv[2 * e] = f.x;
          kv[2 * e + 1] = f.y;
        }
        const int d0 = warp * PART + ch * 8;
#pragma unroll
        for (int j = 0; j < QPK; ++j) {
#pragma unroll
          for (int e = 0; e < 8; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + j * D + d0 + e);
            sc[j] += qv.x * kv[e] + qv.y * kv[e + 1] + qv.z * kv[e + 2] + qv.w * kv[e + 3];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < QPK; ++j) sc_s[(warp * QPK + j) * TILE + lane] = sc[j];
    }
    __syncthreads();

    // Softmax: row sr, keys [KPT seg, KPT seg + KPT) of the tile.
    {
      float x[KPT];
#pragma unroll
      for (int e = 0; e < KPT; e += 4) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (MMA) {
          v = *reinterpret_cast<const float4*>(sc_s + sr * SROW + seg * KPT + e);
        } else if (row_live) {
#pragma unroll
          for (int w = 0; w < WARPS; ++w) {
            const float4 u = *reinterpret_cast<const float4*>(
                sc_s + (w * QPK + sr) * TILE + seg * KPT + e);
            v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
          }
        }
        x[e] = v.x; x[e + 1] = v.y; x[e + 2] = v.z; x[e + 3] = v.w;
      }
      const bool full = t0 + TILE <= lim_min;
      float mx = NEG;
#pragma unroll
      for (int e = 0; e < KPT; ++e) {
        x[e] = (full || t0 + seg * KPT + e < lim) ? x[e] : NEG;
        mx = fmaxf(mx, x[e]);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);
      const float alpha = __expf(m - m_new);
      float p[KPT], sum = 0.f;
#pragma unroll
      for (int e = 0; e < KPT; ++e) {
        p[e] = (full || t0 + seg * KPT + e < lim) ? __expf(x[e] - m_new) : 0.f;
        sum += p[e];
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l = alpha * l + sum;   // from the unrounded P
      m = m_new;
      if constexpr (MMA) {
        uint32_t* pr = reinterpret_cast<uint32_t*>(
            smem + L::kP + (sr * SROW + seg * KPT) * 2);
#pragma unroll
        for (int e = 0; e < KPT; e += 2) pr[e / 2] = RT::pack(p[e], p[e + 1]);
        if (seg == 0) alpha_s[sr] = alpha;
      } else if (row_live) {
        float* pt = reinterpret_cast<float*>(smem + L::kP);
#pragma unroll
        for (int e = 0; e < KPT; e += 4)
          *reinterpret_cast<float4*>(pt + sr * TILE + seg * KPT + e) =
              make_float4(p[e], p[e + 1], p[e + 2], p[e + 3]);
        if (seg == 0) alpha_s[sr] = alpha;
      }
    }
    __syncthreads();

    const unsigned char* vbase = base + TILE * KROW;
    if constexpr (MMA) {
      // O += P V: warp w, dims [32w, 32w + 32) (n tiles nt), keys in two
      // k steps; V rows are the B operand transposed.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float a_lo = alpha_s[16 * mt + gq], a_hi = alpha_s[16 * mt + gq + 8];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          o[mt][nt][0] *= a_lo; o[mt][nt][1] *= a_lo;
          o[mt][nt][2] *= a_hi; o[mt][nt][3] *= a_hi;
        }
      }
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        uint32_t vb[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r4[4];
          ldsm4_t(r4, vbase + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) * KROW
                          + (PART * warp + 16 * np + 8 * (lane / 16)) * 2);
          vb[2 * np][0] = r4[0];
          vb[2 * np][1] = r4[1];
          vb[2 * np + 1][0] = r4[2];
          vb[2 * np + 1][1] = r4[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldsm4(a, smem + L::kP + ((16 * mt + lane % 16) * SROW + 16 * kk + 8 * (lane / 16)) * 2);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) RT::mma(o[mt][nt], a, vb[nt][0], vb[nt][1]);
        }
      }
    } else {
      // PV: thread d, every head, every key of the tile.
      const float* pt = reinterpret_cast<const float*>(smem + L::kP);
#pragma unroll
      for (int j = 0; j < QPK; ++j) acc[j] *= alpha_s[j];
      const uint16_t* vcol = reinterpret_cast<const uint16_t*>(vbase) + d;
#pragma unroll 2
      for (int k = 0; k < TILE; k += 4) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = RT::widen1(vcol[(k + e) * (KROW / 2)]);
#pragma unroll
        for (int j = 0; j < QPK; ++j) {
          const float4 pk = *reinterpret_cast<const float4*>(pt + j * TILE + k);
          acc[j] += pk.x * v[0] + pk.y * v[1] + pk.z * v[2] + pk.w * v[3];
        }
      }
    }
  }

  // The split's partial state.
  const long base = (((long)b * KVH + g) * nsplit + s) * R;
  if constexpr (MMA) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = 16 * mt + gq;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int dim = PART * warp + 8 * nt + 2 * tig;
        if (r0 < R)
          *reinterpret_cast<float2*>(ws_acc + (base + r0) * D + dim) =
              make_float2(o[mt][nt][0], o[mt][nt][1]);
        if (r0 + 8 < R)
          *reinterpret_cast<float2*>(ws_acc + (base + r0 + 8) * D + dim) =
              make_float2(o[mt][nt][2], o[mt][nt][3]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < QPK; ++j) ws_acc[(base + j) * D + d] = acc[j];
  }
  if (sr < R && seg == 0) {
    ws_ml[(base + sr) * 2] = m;
    ws_ml[(base + sr) * 2 + 1] = l;
  }
}

// Merge the splits of (group, lane, token i) by log-sum-exp (split_kv.cuh):
// the splits whose first key the token sees, each with a real m for every
// head of the token.  A dead token (i >= qlen) writes zeros.
template <int D, int QPK>
__global__ void __launch_bounds__(D)
paged_attn_merge_kernel(const float* __restrict__ ws_acc,
                        const float* __restrict__ ws_ml,
                        const int* __restrict__ starts,
                        const int* __restrict__ qlens,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out,   // [B, QS, H, D]
                        int QS, int KVH, int nsplit, int chunk) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int i = blockIdx.z;
  const Span sp = lane_span(starts, qlens, lengths, b);
  __nv_bfloat16* o_row =
      out + (((long)b * QS + i) * KVH * QPK + g * QPK) * D + threadIdx.x;
  if (i >= sp.qlen) {
#pragma unroll
    for (int j = 0; j < QPK; ++j) o_row[j * D] = __float2bfloat16_rn(0.f);
    return;
  }
  const int R = QS * QPK;
  merge_splits<D, QPK>(ws_acc, ws_ml, ((long)b * KVH + g) * nsplit * R + i * QPK,
                    R, min(nsplit, (sp.start + i) / chunk + 1), o_row);
}

template <int D, int QPK, int MT, typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* table, const void* starts, const void* qlens,
                   const void* lengths, void* out, void* ws, int B, int QS,
                   int KVH, int bs, int NB, int nsplit, int chunk, float scale,
                   cudaStream_t stream) {
  using L = Smem<D, QPK, MT>;
  if (!splits_ok(bs, NB, nsplit, chunk)) return cudaErrorInvalidValue;
  const int table_n = (chunk - 1) / bs + 2;
  const size_t smem = L::kTable + 4 * (size_t)table_n;
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attn_split_kernel<D, QPK, MT, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const BlockDiv div = block_div(bs);
  const int* st = static_cast<const int*>(starts);
  const int* ql = static_cast<const int*>(qlens);
  const int* ln = static_cast<const int*>(lengths);
  float* acc = static_cast<float*>(ws);
  float* ml = acc + (size_t)B * KVH * nsplit * QS * QPK * D;
  paged_attn_split_kernel<D, QPK, MT, T><<<dim3(KVH, B, nsplit), D, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table), st,
      ql, ln, acc, ml, QS, KVH, bs, NB, nsplit, chunk, div.mul, div.shr, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_attn_merge_kernel<D, QPK><<<dim3(KVH, B, QS), D, 0, stream>>>(
      acc, ml, st, ql, ln, static_cast<__nv_bfloat16*>(out), QS, KVH, nsplit,
      chunk);
  return cudaGetLastError();
}

// Decode on the CUDA cores; QS > 1 on the tensor cores, in as few row
// tiles of 16 as hold QS * qpk rows (1, 2 or 4): four only where qpk > 4
// (QS 5..8 at qpk 7 is 35..56 rows, at qpk 8 40..64).
template <int D, int QPK, typename T>
cudaError_t launch_rows(const void* q, const void* kp, const void* vp,
                        const void* table, const void* starts, const void* qlens,
                        const void* lengths, void* out, void* ws, int B, int QS,
                        int KVH, int bs, int NB, int nsplit, int chunk,
                        float scale, cudaStream_t st) {
  const int rows = QS * QPK;
  if (QS == 1)
    return launch<D, QPK, 0, T>(q, kp, vp, table, starts, qlens, lengths, out, ws, B, QS, KVH, bs, NB, nsplit, chunk, scale, st);
  if (rows <= 16)
    return launch<D, QPK, 1, T>(q, kp, vp, table, starts, qlens, lengths, out, ws, B, QS, KVH, bs, NB, nsplit, chunk, scale, st);
  if constexpr (QPK >= 4) {
    if (rows <= 32)
      return launch<D, QPK, 2, T>(q, kp, vp, table, starts, qlens, lengths, out, ws, B, QS, KVH, bs, NB, nsplit, chunk, scale, st);
  }
  if constexpr (QPK > 4)
    return launch<D, QPK, 4, T>(q, kp, vp, table, starts, qlens, lengths, out, ws, B, QS, KVH, bs, NB, nsplit, chunk, scale, st);
  return cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const void* table,
             const void* starts, const void* qlens, const void* lengths,
             void* out, void* ws, int B, int QS, int H, int KVH, int D,
             int bs, int NB, int nsplit, int chunk, float scale,
             void* stream) {
  if (B == 0) return 0;
  if (KVH < 1 || H % KVH != 0 || QS < 1 || QS > MAX_QS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_geometry(D, H / KVH, [&](auto d, auto qpk) {
    return launch_rows<decltype(d)::value, decltype(qpk)::value, T>(
        q, kp, vp, table, starts, qlens, lengths, out, ws, B, QS, KVH, bs,
        NB, nsplit, chunk, scale, st);
  });
}

}  // namespace

// `workspace` holds B * KVH * nsplit * QS * qpk * (D + 2) floats; nsplit
// and chunk (a multiple of 32, nsplit * chunk >= NB * bs) come from
// ops/paged_attention.py:decode_splits.  q is raw: the kernel scales it.
// D is 64 or 128.
extern "C" int paged_attn_bf16(const void* q, const void* k_pages,
                               const void* v_pages, const void* table,
                               const void* starts, const void* qlens,
                               void* out, void* workspace, int B, int QS,
                               int H, int KVH, int D, int bs, int NB,
                               int nsplit, int chunk, float scale,
                               void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, table, starts, qlens,
                                 nullptr, out, workspace, B, QS, H, KVH, D, bs,
                                 NB, nsplit, chunk, scale, stream);
}

// The unscaled e4m3, e5m2 and fp16 pools: the bf16 symbol's arguments.
extern "C" int paged_attn_e4m3(const void* q, const void* k_pages,
                               const void* v_pages, const void* table,
                               const void* starts, const void* qlens,
                               void* out, void* workspace, int B, int QS,
                               int H, int KVH, int D, int bs, int NB,
                               int nsplit, int chunk, float scale,
                               void* stream) {
  return dispatch<__nv_fp8_e4m3>(q, k_pages, v_pages, table, starts, qlens,
                                 nullptr, out, workspace, B, QS, H, KVH, D, bs,
                                 NB, nsplit, chunk, scale, stream);
}

extern "C" int paged_attn_e5m2(const void* q, const void* k_pages,
                               const void* v_pages, const void* table,
                               const void* starts, const void* qlens,
                               void* out, void* workspace, int B, int QS,
                               int H, int KVH, int D, int bs, int NB,
                               int nsplit, int chunk, float scale,
                               void* stream) {
  return dispatch<__nv_fp8_e5m2>(q, k_pages, v_pages, table, starts, qlens,
                                 nullptr, out, workspace, B, QS, H, KVH, D, bs,
                                 NB, nsplit, chunk, scale, stream);
}

extern "C" int paged_attn_f16(const void* q, const void* k_pages,
                              const void* v_pages, const void* table,
                              const void* starts, const void* qlens,
                              void* out, void* workspace, int B, int QS,
                              int H, int KVH, int D, int bs, int NB,
                              int nsplit, int chunk, float scale,
                              void* stream) {
  return dispatch<__half>(q, k_pages, v_pages, table, starts, qlens, nullptr,
                          out, workspace, B, QS, H, KVH, D, bs, NB, nsplit,
                          chunk, scale, stream);
}

// Decode, one token per lane: starts and qlens from `lengths` in-kernel.
extern "C" int paged_attn_decode_bf16(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* lengths, void* out,
                                      void* workspace, int B, int H, int KVH,
                                      int D, int bs, int NB, int nsplit,
                                      int chunk, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, table, nullptr, nullptr,
                                 lengths, out, workspace, B, 1, H, KVH, D, bs,
                                 NB, nsplit, chunk, scale, stream);
}

extern "C" int paged_attn_decode_e4m3(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* lengths, void* out,
                                      void* workspace, int B, int H, int KVH,
                                      int D, int bs, int NB, int nsplit,
                                      int chunk, float scale, void* stream) {
  return dispatch<__nv_fp8_e4m3>(q, k_pages, v_pages, table, nullptr, nullptr,
                                 lengths, out, workspace, B, 1, H, KVH, D, bs,
                                 NB, nsplit, chunk, scale, stream);
}

extern "C" int paged_attn_decode_e5m2(const void* q, const void* k_pages,
                                      const void* v_pages, const void* table,
                                      const void* lengths, void* out,
                                      void* workspace, int B, int H, int KVH,
                                      int D, int bs, int NB, int nsplit,
                                      int chunk, float scale, void* stream) {
  return dispatch<__nv_fp8_e5m2>(q, k_pages, v_pages, table, nullptr, nullptr,
                                 lengths, out, workspace, B, 1, H, KVH, D, bs,
                                 NB, nsplit, chunk, scale, stream);
}

extern "C" int paged_attn_decode_f16(const void* q, const void* k_pages,
                                     const void* v_pages, const void* table,
                                     const void* lengths, void* out,
                                     void* workspace, int B, int H, int KVH,
                                     int D, int bs, int NB, int nsplit,
                                     int chunk, float scale, void* stream) {
  return dispatch<__half>(q, k_pages, v_pages, table, nullptr, nullptr,
                          lengths, out, workspace, B, 1, H, KVH, D, bs, NB,
                          nsplit, chunk, scale, stream);
}
