// Flash paged prefill attention for Hopper (sm_90a), over a bf16 pool, an
// unscaled e4m3, e5m2 or fp16 pool (ModelConfig.kv_dtype =
// "float8_e4m3fn", "float8_e5m2", "float16") or an int8 / fp8 (e4m3) pool
// with per-(token, head) float32 scales.
//
// Replaces: k8s_llm_monitor_tpu/ops/pallas_attention.py:
//           flash_prefill_attention (_flash_prefill_kernel), the bf16 or
//           fp8 pool (pages cast to f32 in the kernel, :1099) and the quant
//           branch (k_scale / v_scale, quant=True).
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
// design keeps the tensor cores fed from shared memory, reads each K/V row
// once per block, and keeps address arithmetic and widening off the
// tensor-core warps:
//   * one block per (kv group, lane, query tile) holds the tile's 128 rows
//     for all qpk = H / KVH query heads of its group, so every K/V row it
//     loads serves all of them: the rows are SLABS slabs of TQ = 128 /
//     SLABS query positions, slab j the positions of head j, where SLABS
//     is qpk rounded up to a power of two.  At qpk 7 (Qwen2-7B, 28 / 4
//     heads) the eighth slab (rows 112-127, the last consumer warp's) has
//     no head: its q rows are zero-filled, never stored, and cost 1/8 of
//     the tile's MMA.  The TPU kernel's block-diagonal query trick is an MXU
//     workaround and is not carried over.  The grid starts every (group,
//     lane) of the last query tile first -- the tiles that walk the most
//     keys -- so the causal tail is short;
//   * warp specialisation: two consumer warpgroups own 64 rows each; two
//     producer warpgroups gather 64-key K/V tiles by block id (each row
//     slice is D = 128 contiguous elements) with 16-byte cp.async into a
//     ring of four stages, full/empty mbarriers in place of __syncthreads.
//     setmaxnreg hands the producers' registers to the consumers.  pos / bs
//     is a multiply and shift (a division per key cost more than the
//     copies it addressed) and the block table of the next tile is read
//     while this one is copied;
//   * every 64-column half of a K or V tile lies in shared memory as
//     128-byte rows in the 128-byte swizzle that wgmma reads, written so by
//     the copies themselves (Q too: the swizzle keeps the one-time loads
//     of its fragments free of bank conflicts);
//   * S = Q K^T on wgmma m64n64k16 with Q from registers (each consumer
//     thread holds its A fragments of Q, 32 registers) and K from shared
//     memory, K-major; O += P V on wgmma m64n128k16 with P from registers
//     (the f32 S accumulator repacked to bf16 is the A fragment) and V
//     from shared memory as an MN-major B, so V is never transposed.  The
//     QK product of tile i and the PV product of tile i - 1 go to the
//     tensor cores together, and the softmax of tile i runs while the PV
//     product does;
//   * key tiles past the tile's last visible position are skipped, and the
//     causal / context mask runs only on the tiles that cross the block's
//     diagonal.
//
// Quantized pool: the producers land 1-byte tiles by cp.async in a
// three-stage staging ring and widen them -- each thread the bytes it
// copied -- into the bf16 swizzled stage, so the consumers never see
// codes and the same wgmma path runs.  int8 codes widen without I2F: the
// biased byte (code ^ 0x80) goes into the mantissa of 2^23 and 2^23 + 128
// is subtracted; e4m3 values widen through f16.  Both are exact in bf16, so
// the top half of each float is its bf16 (one byte-permute per pair, off
// the conversion pipe the consumers' exp uses).  This group's scale of each
// key row (one float at scale[blk, off, g]) is staged beside the tile with
// 4-byte cp.async and copied beside the bf16 stage.  K scales multiply the
// score tile after the QK product; V scales multiply P before the PV
// product, while the row sum l is taken from the unscaled P
// (pallas_attention.py:1117-1119) -- otherwise the softmax denominator is
// wrong.  Rows past the context are zero-filled codes and scales: finite.
// The unscaled e4m3 and e5m2 pools (SCALED = false) take the same staging
// and widening (e5m2 through f16 too), and neither the scale copies nor
// the two multiplies.
//
// The fp16 pool (B9): bf16 cannot hold fp16 page values (7 mantissa bits
// to 10), so its tiles take the bf16 pool's path -- 16-byte cp.async
// straight into the swizzled ring, no staging -- and the tensor cores run
// f16: wgmma .f16.f16 with f32 accumulators, each consumer converting its
// Q fragments bf16 -> f16 once after loading them, and P packed to f16
// where the bf16 pool packs it to bf16.  Of the three designs (tf32
// wgmma; a bf16 hi/lo split of each page value, two products; f16
// operands) this is the third: it moves the bf16 pool's bytes, keeps its
// ring, its shared-memory layout and its registers (the launch count stays
// 65536 / 512 = 128 that setmaxnreg needs), where tf32 would halve the
// keys a K step takes and double the Q fragments, and hi/lo would double
// the ring and the MMAs.  What it rounds: the scaled bf16 q converts to
// f16 exactly from 2^-17 up to 65504 (components below 2^-17 lose bits,
// each by less than 2^-25; no model's scaled q nears 65504), and P rounds
// to f16, finer than the bf16 pool's P for P >= 2^-14.
//
// Dead lanes (lengths == 0) and tiles wholly past lengths write zeros and
// read nothing; rows past lengths inside a live tile attend to the
// streamed keys and come back finite (the caller never reads them).
// Position 0 is visible to every row, so l > 0 on every live row.
//
// Trap: q arrives already scaled by D**-0.5 in bf16 (the wrapper does it,
// as pallas_attention.py:1200 does), so the kernel applies no scale.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int D = 128;            // head_dim (the wrapper checks)
constexpr int KT = 64;            // keys per tile
constexpr int ROWS = 128;         // query rows per block (all heads)
constexpr int CONSUMERS = 2;      // warpgroups of 64 rows
constexpr int PRODUCERS = 2;      // warpgroups gathering (and widening)
constexpr int PT = PRODUCERS * 128;
constexpr int THREADS = CONSUMERS * 128 + PT;
// Registers per thread: at launch 65536 / THREADS each; producers give
// theirs back down to P_REGS, consumers take them up to C_REGS.
constexpr int P_REGS = 56, C_REGS = 200;
static_assert(CONSUMERS * 128 * C_REGS + PT * P_REGS == 65536, "registers");
constexpr int NS = 4;             // K/V ring stages
constexpr int NSTG = 3;           // 1-byte staging stages
constexpr float NEG_INF = -0.7f * 3.402823466e38f;

// Shared memory layout (bytes from a 1024-aligned base).  Every 64-column
// half of a bf16 tile is rows of 128 bytes in the 128-byte swizzle that
// wgmma reads: the 16-byte chunk c of row r sits at chunk c ^ (r % 8).
constexpr int HALF_Q = ROWS * 128;          // one 64-dim half of Q: 16 KB
constexpr int Q_BYTES = 2 * HALF_Q;
constexpr int HALF_T = KT * 128;            // one 64-dim half of a K or V tile
constexpr int TILE = 2 * HALF_T;            // K or V tile: 16 KB
constexpr int STAGE = 2 * TILE;             // K + V
constexpr int RING = Q_BYTES;
constexpr int RING_SC = RING + NS * STAGE;  // [NS][K,V][KT] scales (1-byte)
constexpr int STG = RING_SC + NS * 2 * KT * 4;   // [NSTG][K,V][KT][D] codes
constexpr int STG_SC = STG + NSTG * 2 * KT * D;  // [NSTG][K,V][KT] floats
constexpr int BARS = STG_SC + NSTG * 2 * KT * 4; // full[NS], empty[NS]

template <typename T>
constexpr size_t smem_bytes() {
  // + 1024 to align the base; 1-byte pages add the staging ring.
  return sizeof(T) == 2
             ? (size_t)RING_SC + 2 * NS * 8 + 1024
             : (size_t)BARS + 2 * NS * 8 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes (cp.async, st.shared) before wgmma's async-proxy
// reads of the same shared memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  uint32_t ok = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!ok);
}

// Arrive on the barrier once this thread's cp.async copies so far land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// wgmma matrix descriptor, 128-byte swizzle: start address, leading and
// stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S (64 x 64) += A (64 x 16, registers) * B (16 x 64, smem, K-major).
#define WGMMA_QK(AB)                                                          \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB " "                   \
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"              \
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "   \
      "{%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <bool F16>
__device__ __forceinline__ void wgmma_qk(float d[32], const uint32_t a[4],
                                         uint64_t db) {
  if constexpr (F16) {
    WGMMA_QK("f16.f16");
  } else {
    WGMMA_QK("bf16.bf16");
  }
}

// O (64 x 128) += P (64 x 16, registers) * V (16 x 128, smem, MN-major).
#define WGMMA_PV(AB)                                                          \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB " "                  \
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"              \
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"     \
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"     \
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "   \
      "{%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),     \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),     \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),     \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),     \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),     \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),     \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <bool F16>
__device__ __forceinline__ void wgmma_pv(float d[64], const uint32_t a[4],
                                         uint64_t db) {
  if constexpr (F16) {
    WGMMA_PV("f16.f16");
  } else {
    WGMMA_PV("bf16.bf16");
  }
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats as the products' A operand: bf16x2, or f16x2 on an fp16 pool.
template <bool F16>
__device__ __forceinline__ uint32_t pack_ab(float lo, float hi) {
  if constexpr (F16) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_f32(lo, hi);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats that bf16 holds exactly as one bf16x2 word: their top halves.
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Widening of one 32-bit word of 1-byte codes (4 codes) into two bf16x2
// words, exact, on the integer and FMA pipes.
__device__ __forceinline__ void widen4(int8_t, uint32_t w, uint32_t out[2]) {
  // 2^23 + (code ^ 0x80) as a float, minus 2^23 + 128: the code.
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
           8388736.f;
  out[0] = pack_exact(f[0], f[1]);
  out[1] = pack_exact(f[2], f[3]);
}

__device__ __forceinline__ void widen4(__nv_fp8_e4m3, uint32_t w,
                                       uint32_t out[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> (16 * i)), __NV_E4M3);
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
    out[i] = pack_exact(f.x, f.y);
  }
}

__device__ __forceinline__ void widen4(__nv_fp8_e5m2, uint32_t w,
                                       uint32_t out[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> (16 * i)), __NV_E5M2);
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
    out[i] = pack_exact(f.x, f.y);
  }
}

// Byte offset of 16-byte chunk c (0..15) of row r in a swizzled tile whose
// 64-column halves are `half` bytes apart.
__device__ __forceinline__ uint32_t swz(int r, int c, int half) {
  return (c >> 3) * half + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Row slabs of a block: qpk rounded up to a power of two (a slab of TQ =
// ROWS / SLABS query positions per head; TQ a multiple of 16, so each
// consumer warp's 16 rows lie in one slab).
template <int QPK>
__host__ __device__ constexpr int slabs() {
  return QPK <= 1 ? 1 : QPK <= 2 ? 2 : QPK <= 4 ? 4 : 8;
}

template <int QPK, typename T, bool SCALED>
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
                     int S, int KVH, int bs, int NB, unsigned bs_mul,
                     unsigned bs_shr) {
  // 1-byte pages go through the staging ring; only a quantized pool has
  // scale planes (an e4m3 pool may have them or not, int8 always does);
  // fp16 pages run the products in f16.
  constexpr bool kWide = sizeof(T) == 1;
  constexpr bool F16 = std::is_same<T, __half>::value;
  static_assert((!SCALED || kWide) &&
                    (SCALED || !std::is_same<T, int8_t>::value),
                "scales go with 1-byte pages; int8 needs them");
  constexpr int TQ = ROWS / slabs<QPK>();   // query positions per tile
  // Blocks start in grid order (x fastest): every (group, lane) of the
  // last query tile, which walks the most keys, first.
  const int gq = blockIdx.x;       // kv group
  const int b = blockIdx.y;        // lane
  const int t = gridDim.z - 1 - blockIdx.z;   // query tile
  const int tid = threadIdx.x;
  const int H = KVH * QPK;
  const long F = (long)KVH * D;
  const int start = starts[b];
  const int qlen = lens[b];

  // Row r of the block: head gq * QPK + r / TQ, query position t*TQ + r%TQ;
  // a row is loaded and stored only if both exist (slab r / TQ < QPK).
  auto q_offset = [&](int r) -> long {
    const int s = t * TQ + r % TQ;
    return (((long)b * S + s) * H + gq * QPK + r / TQ) * D;
  };
  auto row_in_range = [&](int r) {
    return r / TQ < QPK && t * TQ + r % TQ < S;
  };

  if (qlen <= 0 || t * TQ >= qlen) {       // dead lane or dead tile
    for (int c = tid; c < ROWS * (D / 8); c += THREADS) {
      const int r = c / (D / 8);
      if (row_in_range(r))
        *reinterpret_cast<uint4*>(out + q_offset(r) + (c % (D / 8)) * 8) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int ctx = start + min((t + 1) * TQ, qlen);   // keys [0, ctx)
  const int n_kt = (ctx + KT - 1) / KT;
  const int diag = start + t * TQ;   // the block's first row sees keys <= diag

  extern __shared__ uint4 smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  unsigned char* gbase =
      reinterpret_cast<unsigned char*>(smem_raw) + (sbase - raw);
  const uint32_t full0 = sbase + (kWide ? BARS : RING_SC);
  const uint32_t empty0 = full0 + NS * 8;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, PT);
      mbar_init(empty0 + 8 * s, CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS * 128) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(P_REGS));
    const int p = tid - CONSUMERS * 128;
    // Page row offset (elements) of key pos of this lane and group, or -1
    // past the context.  pos / bs by multiply and shift (a division per
    // key costs more than the copies it addresses), the row in 32 bits and
    // one widening multiply.
    const int* tab = table + (long)b * NB;
    auto row_off = [&](int pos) -> long {
      if (pos >= ctx) return -1;
      const int page =
          bs_mul ? static_cast<int>(__umulhi(pos, bs_mul) >> bs_shr) : pos;
      const unsigned row = static_cast<unsigned>(tab[min(page, NB - 1)]) * bs +
                           static_cast<unsigned>(pos - page * bs);
      return static_cast<long>(static_cast<unsigned long long>(row) *
                               static_cast<unsigned>(F)) +
             gq * D;
    };
    if constexpr (!kWide) {
      // Each thread: KB keys (p / 16 + 16j) x one 16-byte chunk (p % 16)
      // of K and of V, straight into the swizzled ring stage.  The page
      // rows of tile i + 1 are looked up while tile i is issued.
      constexpr int KB = KT * 16 / PT;   // keys per thread
      const int ch = p % 16;
      long nxt[KB];
#pragma unroll
      for (int j = 0; j < KB; ++j) nxt[j] = row_off(p / 16 + (PT / 16) * j);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % NS;
        long cur[KB];
#pragma unroll
        for (int j = 0; j < KB; ++j) cur[j] = nxt[j];
        if (i + 1 < n_kt) {
#pragma unroll
          for (int j = 0; j < KB; ++j)
            nxt[j] = row_off((i + 1) * KT + p / 16 + (PT / 16) * j);
        }
        if (i >= NS) mbar_wait(empty0 + 8 * s, ((i / NS) & 1) ^ 1);
        const uint32_t st = sbase + RING + s * STAGE;
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          const int key = p / 16 + (PT / 16) * j;
          const long off = cur[j];
          const long src = off < 0 ? 0 : off + ch * 8;
          const int n = off < 0 ? 0 : 16;
          const uint32_t o = swz(key, ch, HALF_T);
          cp_async16(st + o, kp + src, n);
          cp_async16(st + TILE + o, vp + src, n);
        }
        cp_async_arrive(full0 + 8 * s);
      }
      cp_async_wait<0>();   // no copy outlives its thread
    } else {
      // Each thread: KQ keys (p / 8 + 32j) x one 16-code chunk (p % 8) of
      // K and of V into the staging ring, then widened by this same thread
      // into the ring stage (no other thread reads its staging bytes).
      constexpr int KQ = KT * 8 / PT;    // keys per thread
      const int ch = p % 8;
      // Page rows of this thread's keys (and, for p < KT, of key p's
      // scales) of tile i, looked up a tile ahead of their copies.
      auto fetch = [&](int i, long (&o)[KQ], long& so) {
#pragma unroll
        for (int j = 0; j < KQ; ++j)
          o[j] = row_off(i * KT + p / 8 + (PT / 8) * j);
        so = p < KT ? row_off(i * KT + p) : -1;
      };
      auto issue = [&](int i, const long (&o)[KQ], long so) {
        const uint32_t sg = sbase + STG + (i % NSTG) * 2 * KT * D;
#pragma unroll
        for (int j = 0; j < KQ; ++j) {
          const int key = p / 8 + (PT / 8) * j;
          const long src = o[j] < 0 ? 0 : o[j] + ch * 16;
          const int n = o[j] < 0 ? 0 : 16;
          cp_async16(sg + key * D + ch * 16, kp + src, n);
          cp_async16(sg + KT * D + key * D + ch * 16, vp + src, n);
        }
        if (SCALED && p < KT) {
          // The scale of a row sits at its page offset / D.
          const long off = so < 0 ? 0 : so / D;
          const int n = so < 0 ? 0 : 4;
          const uint32_t sc = sbase + STG_SC + (i % NSTG) * 2 * KT * 4;
          cp_async4(sc + p * 4, ks + off, n);
          cp_async4(sc + (KT + p) * 4, vs + off, n);
        }
      };
      long nk[KQ], ns = -1;
      for (int i = 0; i < NSTG - 1; ++i) {     // tiles 0 and 1 in flight
        if (i < n_kt) {
          fetch(i, nk, ns);
          issue(i, nk, ns);
        }
        cp_async_commit();
      }
      if (NSTG - 1 < n_kt) fetch(NSTG - 1, nk, ns);
      for (int i = 0; i < n_kt; ++i) {
        // Tile i + 2 goes out (its rows looked up last iteration), then
        // tile i is awaited: two tiles stay in flight.
        if (i + NSTG - 1 < n_kt) {
          long ck[KQ];
#pragma unroll
          for (int j = 0; j < KQ; ++j) ck[j] = nk[j];
          const long cs = ns;
          if (i + NSTG < n_kt) fetch(i + NSTG, nk, ns);
          issue(i + NSTG - 1, ck, cs);
        }
        cp_async_commit();
        cp_async_wait<NSTG - 1>();
        const int s = i % NS;
        if (i >= NS) mbar_wait(empty0 + 8 * s, ((i / NS) & 1) ^ 1);
        const unsigned char* sg = gbase + STG + (i % NSTG) * 2 * KT * D;
        unsigned char* st = gbase + RING + s * STAGE;
#pragma unroll
        for (int j = 0; j < KQ; ++j) {
          const int key = p / 8 + (PT / 8) * j;
#pragma unroll
          for (int which = 0; which < 2; ++which) {
            const uint4 raw4 = *reinterpret_cast<const uint4*>(
                sg + which * KT * D + key * D + ch * 16);
            uint4 w[2];
            widen4(T{}, raw4.x, &w[0].x);
            widen4(T{}, raw4.y, &w[0].z);
            widen4(T{}, raw4.z, &w[1].x);
            widen4(T{}, raw4.w, &w[1].z);
            unsigned char* d = st + which * TILE;
            *reinterpret_cast<uint4*>(d + swz(key, 2 * ch, HALF_T)) = w[0];
            *reinterpret_cast<uint4*>(d + swz(key, 2 * ch + 1, HALF_T)) = w[1];
          }
        }
        if (SCALED && p < KT) {
          const float* sc = reinterpret_cast<const float*>(gbase + STG_SC) +
                            (i % NSTG) * 2 * KT;
          float* rs = reinterpret_cast<float*>(gbase + RING_SC) + s * 2 * KT;
          rs[p] = sc[p];
          rs[KT + p] = sc[KT + p];
        }
        fence_proxy_async();
        mbar_arrive(full0 + 8 * s);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C_REGS));
    const int wg = tid / 128;          // rows [64 wg, 64 wg + 64)
    const int wt = tid % 128;
    const int warp = wt / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int tig = lane & 3;

    // This warpgroup's 64 query rows into the swizzled Q tile.
    for (int u = wt; u < 64 * (D / 8); u += 128) {
      const int r = 64 * wg + u / (D / 8);
      const int ch = u % (D / 8);
      const bool ok = row_in_range(r);
      cp_async16(sbase + swz(r, ch, HALF_Q),
                 ok ? q + q_offset(r) + ch * 8 : q, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    bar_sync(1 + wg, 128);

    const int r0 = 64 * wg + 16 * warp + g;
    const int r1 = r0 + 8;
    const int bound0 = start + t * TQ + r0 % TQ;   // causal horizon
    const int bound1 = start + t * TQ + r1 % TQ;
    // This thread's A fragments of Q for the 8 steps of 16 dims (rows r0,
    // r1; dims 16k + 2tig (+1) and + 8), read once from the swizzled tile.
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {       // dims 16k + 8h + 2tig
        const int c = 2 * k + h;           // 16-byte chunk of the row
        const unsigned char* q0 = gbase + swz(r0, c, HALF_Q) + 4 * tig;
        const unsigned char* q1 = gbase + swz(r1, c, HALF_Q) + 4 * tig;
        qf[k][2 * h] = *reinterpret_cast<const uint32_t*>(q0);
        qf[k][2 * h + 1] = *reinterpret_cast<const uint32_t*>(q1);
      }
      if constexpr (F16) {   // bf16 q as f16 operands
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t w = qf[k][e];
          qf[k][e] = pack_ab<true>(__uint_as_float(w << 16),
                                   __uint_as_float(w & 0xFFFF0000u));
        }
      }
    }

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    const float* ring_sc = reinterpret_cast<const float*>(gbase + RING_SC);

    float sc[32];
    uint32_t pa[KT / 16][4];
    // S = Q K^T of tile i into sc (8 steps of 16 dims; step k lies in half
    // k / 4, at byte 32 * (k % 4) of each swizzled row), not waited for.
    auto issue_qk = [&](int i) {
      const uint32_t kb = sbase + RING + (i % NS) * STAGE;
#pragma unroll
      for (int k = 0; k < 32; ++k) sc[k] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        wgmma_qk<F16>(sc, qf[k], desc(kb + (k / 4) * HALF_T + (k % 4) * 32, 16,
                                 1024));
      wgmma_commit();
    };
    // O += P V of tile i: V is [keys][dims], dims contiguous (MN-major
    // B): the two 64-dim halves are HALF_T apart (leading offset), 8-key
    // groups 1024 bytes apart (stride offset); step c starts 16 keys down.
    auto issue_pv = [&](int i) {
      const uint32_t vb = sbase + RING + (i % NS) * STAGE + TILE;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < KT / 16; ++c)
        wgmma_pv<F16>(o, pa[c], desc(vb + c * 16 * 128, HALF_T, 1024));
      wgmma_commit();
    };
    // Online softmax of tile i on sc (landed): K scales, the mask where
    // the tile crosses the diagonal or ctx, new row maxima and sums.
    // Returns the factors that rescale O; leaves exp(S - m) in sc.
    auto softmax = [&](int i, float& a0, float& a1) {
      const float* ksc = ring_sc + (i % NS) * 2 * KT;
      // Accumulator layout: sc[4j + e] is row r0 (e < 2) or r1, key
      // 8j + 2 tig + (e & 1).
      if constexpr (SCALED) {
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float kscale = ksc[j * 8 + 2 * tig + e];
            sc[4 * j + e] *= kscale;
            sc[4 * j + 2 + e] *= kscale;
          }
        }
      }
      if (i * KT + KT - 1 > diag) {
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pos = i * KT + j * 8 + 2 * tig + e;
            if (!(pos <= bound0 && pos < ctx)) sc[4 * j + e] = NEG_INF;
            if (!(pos <= bound1 && pos < ctx)) sc[4 * j + 2 + e] = NEG_INF;
          }
        }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      constexpr float LOG2E = 1.4426950408889634f;
      a0 = ex2((m0 - mn0) * LOG2E);
      a1 = ex2((m1 - mn1) * LOG2E);
      // exp(s - m) as 2^(s * log2 e - m * log2 e): one FFMA per score.
      const float ml0 = mn0 * LOG2E, ml1 = mn1 * LOG2E;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], LOG2E, -ml0));
          sc[4 * j + 2 + e] = ex2(fmaf(sc[4 * j + 2 + e], LOG2E, -ml1));
          sum0 += sc[4 * j + e];
          sum1 += sc[4 * j + 2 + e];
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
    };
    // P of tile i as the A fragments of the PV product: keys [16c, 16c +
    // 16) are accumulator chunks 2c and 2c + 1.  V scales multiply P here.
    auto pack_p = [&](int i) {
#pragma unroll
      for (int c = 0; c < KT / 16; ++c) {
        float w0 = 1.f, w1 = 1.f, w8 = 1.f, w9 = 1.f;
        if constexpr (SCALED) {
          const float* vsr =
              ring_sc + (i % NS) * 2 * KT + KT + c * 16 + 2 * tig;
          w0 = vsr[0]; w1 = vsr[1]; w8 = vsr[8]; w9 = vsr[9];
        }
        pa[c][0] = pack_ab<F16>(sc[8 * c] * w0, sc[8 * c + 1] * w1);
        pa[c][1] = pack_ab<F16>(sc[8 * c + 2] * w0, sc[8 * c + 3] * w1);
        pa[c][2] = pack_ab<F16>(sc[8 * c + 4] * w8, sc[8 * c + 5] * w9);
        pa[c][3] = pack_ab<F16>(sc[8 * c + 6] * w8, sc[8 * c + 7] * w9);
      }
    };
    auto rescale = [&](float a0, float a1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= a0; o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1; o[4 * j + 3] *= a1;
      }
    };

    // Tile 0, then for each next tile: its QK product and the previous
    // tile's PV product go to the tensor cores together, and the softmax
    // of this tile runs while the PV product does.
    float a0, a1;
    // cp.async wrote the tiles (generic proxy); wgmma reads them through
    // the async proxy.
    mbar_wait(full0, 0);
    fence_proxy_async();
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0, a0, a1);
    pack_p(0);
    for (int i = 1; i < n_kt; ++i) {
      mbar_wait(full0 + 8 * (i % NS), (i / NS) & 1);
      fence_proxy_async();
      issue_qk(i);
      issue_pv(i - 1);
      wgmma_wait<1>();               // S of tile i
      fence_regs(sc);
      softmax(i, a0, a1);
      wgmma_wait<0>();               // P V of tile i - 1
      fence_regs(o);
      mbar_arrive(empty0 + 8 * ((i - 1) % NS));
      rescale(a0, a1);
      pack_p(i);
    }
    issue_pv(n_kt - 1);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty0 + 8 * ((n_kt - 1) % NS));

    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const bool w0 = row_in_range(r0), w1 = row_in_range(r1);
    __nv_bfloat16* o0 = out + q_offset(r0) + 2 * tig;
    __nv_bfloat16* o1 = out + q_offset(r1) + 2 * tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (w0)
        *reinterpret_cast<uint32_t*>(o0 + j * 8) =
            pack_f32(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (w1)
        *reinterpret_cast<uint32_t*>(o1 + j * 8) =
            pack_f32(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

template <int QPK, typename T, bool SCALED>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* table,
                   const void* starts, const void* lens, void* out, int B,
                   int S, int KVH, int bs, int NB, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<QPK, T, SCALED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    // setmaxnreg only moves registers between the warpgroups: were the
    // launch count below 65536 / THREADS, the consumers would wait forever
    // for registers the producers never had.  Refuse instead of hanging.
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, flash_prefill_kernel<QPK, T, SCALED>);
    if (e != cudaSuccess) return e;
    if (attr.numRegs * THREADS != 65536) return cudaErrorInvalidConfiguration;
    configured = true;
  }
  // pos / bs == __umulhi(pos, mul) >> shr for pos < 2^31, with mul =
  // ceil(2^p / bs), p = 31 + ceil(log2 bs); mul = 0 marks bs == 1.
  unsigned mul = 0, shr = 0;
  if (bs > 1) {
    int l = 31 - __builtin_clz(static_cast<unsigned>(bs));
    l += (bs & (bs - 1)) != 0;
    mul = static_cast<unsigned>(((1ull << (31 + l)) + bs - 1) / bs);
    shr = static_cast<unsigned>(l - 1);
  }
  constexpr int TQ = ROWS / slabs<QPK>();
  dim3 grid(KVH, B, (S + TQ - 1) / TQ);
  flash_prefill_kernel<QPK, T, SCALED><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(starts), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), S, KVH, bs, NB, mul, shr);
  return cudaGetLastError();
}

template <typename T, bool SCALED>
int dispatch(const void* q, const void* kp, const void* vp, const void* ks,
             const void* vs, const void* table, const void* starts,
             const void* lens, void* out, int B, int S, int H, int KVH,
             int bs, int NB, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / KVH) {
    case 1: return launch<1, T, SCALED>(q, kp, vp, ks, vs, table, starts, lens, out, B, S, KVH, bs, NB, st);
    case 2: return launch<2, T, SCALED>(q, kp, vp, ks, vs, table, starts, lens, out, B, S, KVH, bs, NB, st);
    case 4: return launch<4, T, SCALED>(q, kp, vp, ks, vs, table, starts, lens, out, B, S, KVH, bs, NB, st);
    case 7: return launch<7, T, SCALED>(q, kp, vp, ks, vs, table, starts, lens, out, B, S, KVH, bs, NB, st);
    case 8: return launch<8, T, SCALED>(q, kp, vp, ks, vs, table, starts, lens, out, B, S, KVH, bs, NB, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_prefill_bf16(const void* q, const void* k_pages,
                                  const void* v_pages, const void* table,
                                  const void* starts, const void* lens,
                                  void* out, int B, int S, int H, int KVH,
                                  int bs, int NB, void* stream) {
  return dispatch<__nv_bfloat16, false>(q, k_pages, v_pages, nullptr,
                                        nullptr, table, starts, lens, out, B,
                                        S, H, KVH, bs, NB, stream);
}

// The unscaled e4m3, e5m2 and fp16 pools: the bf16 symbol's arguments.
extern "C" int flash_prefill_e4m3(const void* q, const void* k_pages,
                                  const void* v_pages, const void* table,
                                  const void* starts, const void* lens,
                                  void* out, int B, int S, int H, int KVH,
                                  int bs, int NB, void* stream) {
  return dispatch<__nv_fp8_e4m3, false>(q, k_pages, v_pages, nullptr,
                                        nullptr, table, starts, lens, out, B,
                                        S, H, KVH, bs, NB, stream);
}

extern "C" int flash_prefill_e5m2(const void* q, const void* k_pages,
                                  const void* v_pages, const void* table,
                                  const void* starts, const void* lens,
                                  void* out, int B, int S, int H, int KVH,
                                  int bs, int NB, void* stream) {
  return dispatch<__nv_fp8_e5m2, false>(q, k_pages, v_pages, nullptr,
                                        nullptr, table, starts, lens, out, B,
                                        S, H, KVH, bs, NB, stream);
}

extern "C" int flash_prefill_f16(const void* q, const void* k_pages,
                                 const void* v_pages, const void* table,
                                 const void* starts, const void* lens,
                                 void* out, int B, int S, int H, int KVH,
                                 int bs, int NB, void* stream) {
  return dispatch<__half, false>(q, k_pages, v_pages, nullptr, nullptr, table,
                                 starts, lens, out, B, S, H, KVH, bs, NB,
                                 stream);
}

extern "C" int flash_prefill_int8(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scale,
                                  const void* v_scale, const void* table,
                                  const void* starts, const void* lens,
                                  void* out, int B, int S, int H, int KVH,
                                  int bs, int NB, void* stream) {
  return dispatch<int8_t, true>(q, k_pages, v_pages, k_scale, v_scale, table,
                                starts, lens, out, B, S, H, KVH, bs, NB,
                                stream);
}

extern "C" int flash_prefill_fp8(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scale,
                                 const void* v_scale, const void* table,
                                 const void* starts, const void* lens,
                                 void* out, int B, int S, int H, int KVH,
                                 int bs, int NB, void* stream) {
  return dispatch<__nv_fp8_e4m3, true>(q, k_pages, v_pages, k_scale, v_scale,
                                       table, starts, lens, out, B, S, H, KVH,
                                       bs, NB, stream);
}
