// Flash paged prefill attention for Hopper (sm_90a), over a bf16 pool or
// an int8 / fp8 (e4m3) pool with per-(token, head) float32 scales.
//
// Replaces: k8s_llm_monitor_tpu/ops/pallas_attention.py:
//           flash_prefill_attention (_flash_prefill_kernel), the bf16 pool
//           and the quant branch (k_scale / v_scale, quant=True).
//
// Computes causal attention for q [B, S, H, D]: query i of lane b sits at
// absolute position start[b] + i and sees keys at positions <= start[b] + i.
// K/V are read straight from the paged pool [num_blocks, bs, KVH * D]
// through block_table; the [S, T] score matrix is never materialised (online
// softmax with (m, l, acc) carried per query row).  The chunk's own K/V are
// already in the pages (models/llama.py scatters before attention), so one
// kernel serves fresh prefill (start = 0) and continuation chunks.
//
// What bounds it on this card: at long S, tensor-core flops -- each K/V
// row is reused by every query row of the tile, 4 * D flops per (query,
// key) pair against 4 * D bytes per key row (2 * D with 1-byte pages).  The
// design keeps the tensor cores fed from shared memory and reads each K/V
// row once per tile:
//   * one block per (query tile, kv group, lane); the block holds the
//     tile's rows for all qpk = H / KVH query heads of its group (128 rows:
//     TQ = 128 / qpk query positions x qpk heads), so every K/V row it loads
//     serves all of them.  The TPU kernel's block-diagonal query trick is an
//     MXU workaround and is not carried over;
//   * K/V tiles of 64 keys are gathered by block id -- each row slice is
//     D = 128 contiguous elements (256 bytes bf16, 128 bytes int8/fp8) --
//     with 16-byte cp.async into padded shared memory in the pool's own
//     type, double-buffered so the next tile loads while this one computes;
//   * QK^T and PV run on mma.sync m16n8k16 (bf16 in, f32 accumulate); the
//     accumulator layout of mma.sync is fixed by the PTX ISA, so the online
//     softmax rescales rows in registers and P feeds the PV product without
//     a trip through shared memory;
//   * key tiles past the tile's last visible position are skipped.
// wgmma, TMA and warp specialisation are later work.
//
// Quantized pool: int8 codes and e4m3 values are exact in bf16, so the
// fragments widen 1-byte codes to bf16 as they are built and the same
// mma.sync path runs.  This group's scale of each key row (one float at
// scale[blk, off, g]) is staged beside the tile with 4-byte cp.async.  K
// scales multiply the score tile after the QK product; V scales multiply P
// before the PV product, while the row sum l is taken from the unscaled P
// (pallas_attention.py:1117-1119) -- otherwise the softmax denominator is
// wrong.  Rows past the context are zero-filled codes and scales: finite.
//
// Dead lanes (lengths == 0) and tiles wholly past lengths write zeros and
// read nothing; rows past lengths inside a live tile attend to the
// streamed keys and come back finite (the caller never reads them).
// Position 0 is visible to every row, so l > 0 on every live row.
//
// Trap: q arrives already scaled by D**-0.5 in bf16 (the wrapper does it,
// as pallas_attention.py:1200 does), so the kernel applies no scale.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;        // head_dim (the wrapper checks)
constexpr int DP = D + 8;     // padded bf16 smem row: 272 B, conflict-free frags
constexpr int KT = 64;        // keys per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 16;  // query rows per block (all heads)
constexpr int CHUNKS = D / 8;     // 16-byte chunks per bf16 row
constexpr float NEG_INF = -0.7f * 3.402823466e38f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a (16x16, row-major) * b (16x8, col-major); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Page element types.  pair(): two adjacent elements as one bf16x2
// fragment register; one(): one element as bf16.  Exact for int8 codes and
// e4m3 values, whose values bf16 holds.
template <typename T>
struct Page;

template <>
struct Page<__nv_bfloat16> {
  static constexpr bool kQuant = false;
  static __device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
    return ld32(p);
  }
  static __device__ __forceinline__ __nv_bfloat16 one(__nv_bfloat16 v) {
    return v;
  }
};

template <>
struct Page<int8_t> {
  static constexpr bool kQuant = true;
  static __device__ __forceinline__ uint32_t pair(const int8_t* p) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    return pack_f32(static_cast<float>(c.x), static_cast<float>(c.y));
  }
  static __device__ __forceinline__ __nv_bfloat16 one(int8_t v) {
    return __float2bfloat16_rn(static_cast<float>(v));
  }
};

template <>
struct Page<__nv_fp8_e4m3> {
  static constexpr bool kQuant = true;
  static __device__ __forceinline__ uint32_t pair(const __nv_fp8_e4m3* p) {
    const float2 f =
        static_cast<float2>(*reinterpret_cast<const __nv_fp8x2_e4m3*>(p));
    return pack_f32(f.x, f.y);
  }
  static __device__ __forceinline__ __nv_bfloat16 one(__nv_fp8_e4m3 v) {
    return __float2bfloat16_rn(static_cast<float>(v));
  }
};

// Shared memory of one block: the bf16 query tile, two K and two V tiles
// in the page type (rows padded by 16 bytes: conflict-free fragment loads
// for both widths), and for a quantized pool two K and two V scale tiles.
template <typename T>
struct Smem {
  static constexpr int KP = D + 16 / sizeof(T);          // padded row, elements
  static constexpr int KCHUNKS = D * sizeof(T) / 16;      // 16-byte chunks/row
  static constexpr size_t kQ = sizeof(__nv_bfloat16) * (size_t)ROWS * DP;
  static constexpr size_t kKV = sizeof(T) * (size_t)4 * KT * KP;
  static constexpr size_t kScales = Page<T>::kQuant ? sizeof(float) * 4 * KT : 0;
  static constexpr size_t kBytes = kQ + kKV + kScales;
};

template <int QPK, typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,   // [B, S, H, D], pre-scaled
                     const T* __restrict__ kp,              // [nb, bs, KVH*D]
                     const T* __restrict__ vp,
                     const float* __restrict__ ks,          // [nb, bs, KVH] or null
                     const float* __restrict__ vs,
                     const int* __restrict__ table,         // [B, NB]
                     const int* __restrict__ starts,        // [B]
                     const int* __restrict__ lens,          // [B]
                     __nv_bfloat16* __restrict__ out,       // [B, S, H, D]
                     int S, int KVH, int bs, int NB) {
  using P = Page<T>;
  using M = Smem<T>;
  constexpr int KP = M::KP;
  constexpr int TQ = ROWS / QPK;   // query positions per tile
  const int t = blockIdx.x;        // query tile
  const int gq = blockIdx.y;       // kv group
  const int b = blockIdx.z;        // lane
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;         // mma groupID
  const int tig = lane & 3;        // mma thread-in-group
  const int H = KVH * QPK;
  const long F = (long)KVH * D;
  const int start = starts[b];
  const int qlen = lens[b];

  // Row r of the block: head gq * QPK + r / TQ, query position t*TQ + r%TQ.
  auto q_offset = [&](int r) -> long {
    const int s = t * TQ + r % TQ;
    return (((long)b * S + s) * H + gq * QPK + r / TQ) * D;
  };
  auto row_in_range = [&](int r) { return t * TQ + r % TQ < S; };

  if (qlen <= 0 || t * TQ >= qlen) {       // dead lane or dead tile
    for (int c = tid; c < ROWS * CHUNKS; c += THREADS) {
      const int r = c / CHUNKS;
      if (row_in_range(r))
        *reinterpret_cast<uint4*>(out + q_offset(r) + (c % CHUNKS) * 8) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int ctx = start + min((t + 1) * TQ, qlen);   // keys [0, ctx)
  const int n_kt = (ctx + KT - 1) / KT;

  extern __shared__ uint4 smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_raw);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(base);
  T* Ks = reinterpret_cast<T*>(base + M::kQ);          // [2][KT][KP]
  T* Vs = Ks + 2 * KT * KP;                            // [2][KT][KP]
  float* KSs = reinterpret_cast<float*>(base + M::kQ + M::kKV);  // [2][KT]
  float* VSs = KSs + 2 * KT;                                     // [2][KT]

  for (int c = tid; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS;
    const bool ok = row_in_range(r);
    cp_async16(Qs + r * DP + (c % CHUNKS) * 8,
               ok ? q + q_offset(r) + (c % CHUNKS) * 8 : q, ok ? 16 : 0);
  }
  constexpr int PER_CHUNK = 16 / sizeof(T);
  auto load_kv = [&](int kt, int buf) {
    for (int c = tid; c < KT * M::KCHUNKS; c += THREADS) {
      const int rr = c / M::KCHUNKS;
      const int p = kt * KT + rr;
      long off = 0;
      int n = 0;
      if (p < ctx) {
        const int blk = table[(long)b * NB + min(p / bs, NB - 1)];
        off = ((long)blk * bs + p % bs) * F + (long)gq * D +
              (c % M::KCHUNKS) * PER_CHUNK;
        n = 16;
      }
      const int so = (buf * KT + rr) * KP + (c % M::KCHUNKS) * PER_CHUNK;
      cp_async16(Ks + so, kp + off, n);
      cp_async16(Vs + so, vp + off, n);
    }
    if constexpr (P::kQuant) {
      for (int rr = tid; rr < KT; rr += THREADS) {
        const int p = kt * KT + rr;
        long off = 0;
        int n = 0;
        if (p < ctx) {
          const int blk = table[(long)b * NB + min(p / bs, NB - 1)];
          off = ((long)blk * bs + p % bs) * KVH + gq;
          n = 4;
        }
        cp_async4(KSs + buf * KT + rr, ks + off, n);
        cp_async4(VSs + buf * KT + rr, vs + off, n);
      }
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // Per thread: rows r0 = 16*warp + g and r1 = r0 + 8 of the block.
  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;
  const int bound0 = start + t * TQ + r0 % TQ;   // causal horizon
  const int bound1 = start + t * TQ + r1 % TQ;

  uint32_t qa[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_kv(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const __nv_bfloat16* qr = Qs + kc * 16 + 2 * tig;
        qa[kc][0] = ld32(qr + r0 * DP);
        qa[kc][1] = ld32(qr + r1 * DP);
        qa[kc][2] = ld32(qr + r0 * DP + 8);
        qa[kc][3] = ld32(qr + r1 * DP + 8);
      }
    }
    const T* Kb = Ks + (kt & 1) * KT * KP;
    const T* Vb = Vs + (kt & 1) * KT * KP;
    const float* KSb = KSs + (kt & 1) * KT;
    const float* VSb = VSs + (kt & 1) * KT;

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float sc[KT / 8][4];
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const T* kr = Kb + (nt * 8 + g) * KP + kc * 16 + 2 * tig;
        mma16816(sc[nt], qa[kc], P::pair(kr), P::pair(kr + 8));
      }
    }

    // K scales onto the scores (key column nt*8 + 2*tig + e), then the
    // causal mask + online softmax on rows r0 (c0, c1) and r1 (c2, c3).
    if constexpr (P::kQuant) {
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float kscale = KSb[nt * 8 + 2 * tig + e];
          sc[nt][e] *= kscale;
          sc[nt][2 + e] *= kscale;
        }
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = kt * KT + nt * 8 + 2 * tig + e;
        if (!(p <= bound0 && p < ctx)) sc[nt][e] = NEG_INF;
        if (!(p <= bound1 && p < ctx)) sc[nt][2 + e] = NEG_INF;
        mx0 = fmaxf(mx0, sc[nt][e]);
        mx1 = fmaxf(mx1, sc[nt][2 + e]);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nt][e] = __expf(sc[nt][e] - mn0);
        sc[nt][2 + e] = __expf(sc[nt][2 + e] - mn1);
        sum0 += sc[nt][e];
        sum1 += sc[nt][2 + e];
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
    }
    l0 = a0 * l0 + sum0;   // from the unscaled P
    l1 = a1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= a0; o[n][1] *= a0;
      o[n][2] *= a1; o[n][3] *= a1;
    }

    // O += P V: the S accumulators of key tiles 2c, 2c+1 are exactly the
    // A fragment of keys [16c, 16c+16).  V scales multiply P here, after
    // the row sum.
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc) {
      float w0 = 1.f, w1 = 1.f, w8 = 1.f, w9 = 1.f;
      if constexpr (P::kQuant) {
        const float* vsr = VSb + kc * 16 + 2 * tig;
        w0 = vsr[0]; w1 = vsr[1]; w8 = vsr[8]; w9 = vsr[9];
      }
      uint32_t pa[4];
      pa[0] = pack_f32(sc[2 * kc][0] * w0, sc[2 * kc][1] * w1);
      pa[1] = pack_f32(sc[2 * kc][2] * w0, sc[2 * kc][3] * w1);
      pa[2] = pack_f32(sc[2 * kc + 1][0] * w8, sc[2 * kc + 1][1] * w9);
      pa[3] = pack_f32(sc[2 * kc + 1][2] * w8, sc[2 * kc + 1][3] * w9);
      const T* vr = Vb + (kc * 16 + 2 * tig) * KP + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const T* v = vr + n * 8;
        const uint32_t b0 = pack_bf16(P::one(v[0]), P::one(v[KP]));
        const uint32_t b1 = pack_bf16(P::one(v[8 * KP]), P::one(v[9 * KP]));
        mma16816(o[n], pa, b0, b1);
      }
    }
    __syncthreads();   // this buffer is refilled two iterations later
  }

  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const bool w0 = row_in_range(r0), w1 = row_in_range(r1);
  __nv_bfloat16* o0 = out + q_offset(r0) + 2 * tig;
  __nv_bfloat16* o1 = out + q_offset(r1) + 2 * tig;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (w0)
      *reinterpret_cast<uint32_t*>(o0 + n * 8) =
          pack_f32(o[n][0] * inv0, o[n][1] * inv0);
    if (w1)
      *reinterpret_cast<uint32_t*>(o1 + n * 8) =
          pack_f32(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int QPK, typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* table,
                   const void* starts, const void* lens, void* out, int B,
                   int S, int KVH, int bs, int NB, cudaStream_t stream) {
  constexpr size_t smem = Smem<T>::kBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<QPK, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  constexpr int TQ = ROWS / QPK;
  dim3 grid((S + TQ - 1) / TQ, KVH, B);
  flash_prefill_kernel<QPK, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(starts), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), S, KVH, bs, NB);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const void* ks,
             const void* vs, const void* table, const void* starts,
             const void* lens, void* out, int B, int S, int H, int KVH,
             int bs, int NB, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / KVH) {
    case 1: return launch<1, T>(q, kp, vp, ks, vs, table, starts, lens, out, B, S, KVH, bs, NB, st);
    case 2: return launch<2, T>(q, kp, vp, ks, vs, table, starts, lens, out, B, S, KVH, bs, NB, st);
    case 4: return launch<4, T>(q, kp, vp, ks, vs, table, starts, lens, out, B, S, KVH, bs, NB, st);
    case 8: return launch<8, T>(q, kp, vp, ks, vs, table, starts, lens, out, B, S, KVH, bs, NB, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_prefill_bf16(const void* q, const void* k_pages,
                                  const void* v_pages, const void* table,
                                  const void* starts, const void* lens,
                                  void* out, int B, int S, int H, int KVH,
                                  int bs, int NB, void* stream) {
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr, table,
                                 starts, lens, out, B, S, H, KVH, bs, NB,
                                 stream);
}

extern "C" int flash_prefill_int8(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scale,
                                  const void* v_scale, const void* table,
                                  const void* starts, const void* lens,
                                  void* out, int B, int S, int H, int KVH,
                                  int bs, int NB, void* stream) {
  return dispatch<int8_t>(q, k_pages, v_pages, k_scale, v_scale, table,
                          starts, lens, out, B, S, H, KVH, bs, NB, stream);
}

extern "C" int flash_prefill_fp8(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scale,
                                 const void* v_scale, const void* table,
                                 const void* starts, const void* lens,
                                 void* out, int B, int S, int H, int KVH,
                                 int bs, int NB, void* stream) {
  return dispatch<__nv_fp8_e4m3>(q, k_pages, v_pages, k_scale, v_scale, table,
                                 starts, lens, out, B, S, H, KVH, bs, NB,
                                 stream);
}
