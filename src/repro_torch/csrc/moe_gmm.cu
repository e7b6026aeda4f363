// Grouped expert SwiGLU FFN over MoE capacity buffers, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/moe_dispatch/moe_gmm.py
//   (`moe_gmm`, body `_gmm_kernel`):
//   out[e] = (silu(buf[e] . w1[e]) * (buf[e] . w3[e])) . w2[e]
//   buf (E, C, d), w1/w3 (E, d, f), w2 (E, f, d), out (E, C, d) in buf's
//   type, fp32 accumulation.  Any C >= 1; d and f multiples of 8.
//
// What bounds it on the H100:
//   * bf16: bytes.  Every call reads all E experts' weights (mixtral-8x7b:
//     3 * 8 * 4096 * 14336 * 2 B = 2.8 GB, 0.85 ms at 3.35 TB/s) against
//     6 * E * C * d * f FLOPs (0.45 ms of bf16 tensor-core time at C = 160,
//     far less at a decode step's C = 8).
//   * fp32: tensor-core arithmetic at large C.  An fp32-exact product runs
//     as three TF32 products (below), 3 * 6 * E * C * d * f operations at
//     495 TFLOP/s: 1.1 ms for mixtral at C = 64 against 1.7 ms of fp32
//     weight bytes, 0.06 ms against 0.05 ms for granite-moe-1b at C = 256.
//
// What this design does about it: two grouped GEMMs that share one tiled,
//   pipelined main loop, so no tile depends on d or f as a whole.
//   1. gate-up, grid (C tiles x f tiles, E): acc1 = x . w1 and acc3 = x . w3
//      over K = d for one (BM x 64) tile of h; the epilogue writes
//      h = silu(acc1) * acc3, formed in fp32, to a scratch (E, C, f) in
//      buf's type (bf16 rounding of h, as the fused kernel before it did).
//   2. down, grid (C tiles x d tiles, E, K splits): out = h . w2 over K = f
//      for one (BM x 128) tile, cast to out's type.  When E * tiles is too
//      small to fill the card (decode at few experts) K is cut into splits
//      that write fp32 partial sums, and a second pass adds them in split
//      order: no atomics, bitwise the same result on every call.
//   h's round trip through device memory costs 2 * E * C * f elements,
//   about 0.02 ms for mixtral at C = 160.
//   * Each block computes BM (32, 64 or 128) C rows against 128 weight
//     columns (64 of w1 beside the same 64 of w3, or 128 of w2), with
//     8 warps in 2 x 4, so a weight tile is read once per C tile:
//     ceil(C / BM) times in all.  The C tiles that share a weight tile are
//     adjacent in blockIdx.x, so a repeat read comes from the L2 cache.
//   * Tiles stream through a ring of STAGES slots in dynamic shared memory,
//     filled by 16-byte cp.async.cg (zero-fill for the ragged rows of C and
//     the ragged ends of d and f); one cp.async.wait_group and one barrier
//     per slot, so the loads of the next slots overlap this slot's products.
//     Shared rows are padded by 16 bytes (A) and 8 elements (B), which
//     keeps ldmatrix and the fp32 fragment loads free of bank conflicts.
//   * bf16: mma.sync.m16n8k16 (bf16 in, fp32 accumulate), A by ldmatrix,
//     B (row-major K x N) by ldmatrix.trans.
//   * fp32: 3xTF32 on mma.sync.m16n8k8.tf32.  Each operand is split into
//     big = tf32(x) and small = tf32(x - big), and each product is
//     a_small.b_big + a_big.b_small + a_big.b_big in fp32 accumulators,
//     which keeps fp32 results within 1e-4 of the plain version (one TF32
//     pass does not).
//   The forward on wgmma, TMA and a persistent grid are later work.
//
// Backward (moe_gmm_bwd_launch): dbuf, dw1, dw3, dw2 from dout in four
//   grouped GEMMs, in this order: kDh (a = buf.w1, b = buf.w3 and dh =
//   dout.w2^T in fp32, then da, db and h = silu(a) * b, the forward's h),
//   dw2 = h^T.dout, dw1 | dw3 = buf^T.(da | db), dbuf = da.w1^T + db.w3^T.
//   What bounds it: operations.  16 * E * C * d * f FLOPs (a and b are
//   recomputed, not kept): at granite-moe-1b-a400m's training microbatch
//   (E 32, C 1280, d 1024, f 512) 343.6 GFLOP, 0.347 ms at 989 TFLOP/s,
//   against 0.13 GB of bf16 operands (0.04 ms at 3.35 TB/s).
//   What the bf16 design does about it (wg_kernel):
//   * wgmma.mma_async (bf16 in, fp32 accumulate), the only path to the
//     card's tensor-core rate, on 128-row output tiles: two consumer
//     warpgroups of 64 rows each, so every operand byte brought into
//     shared memory feeds 128 x BN products;
//   * operands arrive by TMA (cp.async.bulk.tensor, 3-D maps (inner, rows,
//     expert) made on the host, 128-byte swizzle) into a ring of 4 stages
//     of 64 K, completing on mbarriers; one producer warp
//     keeps the ring full while the consumers run, and no thread spends
//     registers or instructions on addresses.  TMA zero-fills the ragged
//     edges of C, d and f (and never reads across an expert);
//   * the transposed operands (A of dw = buf^T or h^T, B of kDh's x.w1 and
//     of dw, all stored M- or N-contiguous) are read MN-major by the
//     wgmma descriptor itself: no transposing copy;
//   * the GEMMs move operands from the L2 cache at about 7 TB/s, so the
//     tiles are as wide as the registers allow, for FLOPs per byte: dw2,
//     dw1 | dw3 (one product over buf^T's tile, 128 columns of each) and
//     dbuf keep one 64 x 256 accumulator per warpgroup (128 x 256 tiles,
//     85 FLOPs per byte of operands); kDh keeps [a | b] in one 64 x 128
//     accumulator (one read of buf's tile for both) and dh in a 64 x 64
//     one (96 registers a thread, 56 FLOPs per byte); one block of
//     288 threads per SM (up to 224 registers a thread), on a persistent
//     grid: each block walks its tiles, and the producer fills the ring
//     for the next tile while the consumers store this one;
//   * no atomics and no K split: every call gives the same bits.
//   fp32 (3xTF32) keeps the mma.sync main loop above at 64-row tiles (it
//   serves only small gradient checks); its redesign is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;   // 8 warps: 2 along the C rows x 4 along N
constexpr int kKBytes = 64;     // K bytes per slot: 32 bf16 or 16 fp32
constexpr int kWCols = 128;     // weight columns per slot, all operands
constexpr int kBPad = 8;        // elements of padding per shared B row

template <typename T>
struct Tile {
  static constexpr int kBK = kKBytes / (int)sizeof(T);  // K per slot
  static constexpr int kEPC = 16 / (int)sizeof(T);      // elements per 16 B
};

// The products one kernel instance computes.  An operand is read "plain"
// from a row-major (M, K) array (A) or (K, N) array (B), or "transposed"
// from a row-major (K, M) array (A) or (N, K) array (B).
enum Op : int {
  kFwd = 0,  // forward: NB 2 gate-up (h = silu(x.w1) * x.w3), NB 1 down
  kDh = 1,   // NB 2 plain (a = x.w1, b = x.w3) beside a third product
             // dh = dout.w2^T (its A the second A tile, its B transposed);
             // epilogue: da, db and h from dh, a and b, all in fp32
  kDw = 2,   // A transposed (K = C), the NB results stored
  kDx = 3,   // B transposed, two K segments: a.b0^T + a2.b1^T
};

template <int OP>
struct OpTraits {
  static constexpr bool kAT = OP == kDw;
  static constexpr bool kBT = OP == kDx;
  static constexpr bool kTwo = OP == kDx;
  static constexpr bool kDual = OP == kDh;
};

// Shared slot geometry.  A: plain [BM][BK + 16 B] (80-byte rows),
// transposed [BK][BM + 8]; B: plain [BK][128 + 8], transposed [128][BK +
// 16 B].  kDh holds two plain A tiles (x, then dout) and, after the plain
// B tile of w1 | w3, a transposed [64][BK + 16 B] tile of w2.  Every pad
// keeps ldmatrix and the fp32 fragment reads free of bank conflicts and
// every row 16-byte aligned.
template <typename T, int BM, int OP>
struct Slot {
  static constexpr int kBK = Tile<T>::kBK, kEPC = Tile<T>::kEPC;
  static constexpr bool kDual = OpTraits<OP>::kDual;
  static constexpr int kSA = OpTraits<OP>::kAT ? BM + 8 : kBK + kEPC;
  static constexpr int kA1 = OpTraits<OP>::kAT ? kBK * kSA : BM * kSA;
  static constexpr int kA = kDual ? 2 * kA1 : kA1;
  static constexpr int kSB = OpTraits<OP>::kBT ? kBK + kEPC : kWCols + kBPad;
  static constexpr int kB1 = OpTraits<OP>::kBT ? kWCols * kSB : kBK * kSB;
  static constexpr int kST = kBK + kEPC;  // kDh: the transposed w2 rows
  static constexpr int kB = kDual ? kB1 + (kWCols / 2) * kST : kB1;
};

template <typename T, int BM, int STAGES, int OP = kFwd>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * (Slot<T, BM, OP>::kA + Slot<T, BM, OP>::kB) *
         sizeof(T);
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
// (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row-major fragment) . b (16 x 8, col-major fragment)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 8, row-major fragment) . b (8 x 8, col-major fragment), TF32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = big + small, both TF32 (10-bit mantissa), rounded to nearest.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// SwiGLU backward at one element: h = silu(a) * b (as the forward forms
// it), dh = dL/dh.
__device__ __forceinline__ void swiglu_bwd(float dh, float a, float b,
                                           float& da, float& db, float& h) {
  const float sig = 1.0f / (1.0f + expf(-a));
  const float sa = silu(a);
  da = dh * b * sig * (1.0f + a * (1.0f - sig));
  db = dh * sa;
  h = sa * b;
}

// The operands of one grouped GEMM (pointers at expert 0).
template <typename T>
struct GemmArgs {
  const T* a;       // A: (E, M, K), or (E, K, M) transposed
  const T* a2;      // kDx: the second segment's A; kDh: dout (E, M, K)
  const T* b0;      // B: (E, K, N), or (E, N, K) transposed
  const T* b1;      // NB 2: the second operand; kDx: the second segment's B
  const T* b2;      // kDh: w2, read transposed (E, N, K)
  T* dst;           // (E, M, N)
  T* dst1;          // NB 2 (kDw): the second result; kDh: db
  T* dst2;          // kDh: h
  float* partial;   // kFwd down with K split: fp32 (splits, E, M, N)
  int M, K, N, m_tiles, k_tiles_per_split;
};

// One grouped GEMM over experts: for expert e = blockIdx.y,
//   kFwd, NB = 2 (gate-up): dst[e] = silu(a[e] . b0[e]) * (a[e] . b1[e]);
//   kFwd, NB = 1 (down):    dst[e] = a[e] . b0[e], or into `partial` (fp32,
//                           one (E, M, N) slab per K split) when K is split;
//   kDw:                    dst[e] = A[e] . b0[e] (and dst1[e] = A[e] . b1[e]);
//   kDh, NB = 2:            a = a[e] . b0[e], b = a[e] . b1[e] and
//                           dh = a2[e] . b2[e]^T in fp32 accumulators ->
//                           da, db, h (swiglu_bwd);
//   kDx:                    dst[e] = a[e] . b0[e]^T + a2[e] . b1[e]^T.
// grid: (m_tiles * n_tiles, E, splits), the m tile fastest; block: 8 warps.
// Each block owns BM rows x BN = 128 / NB output columns; a slot holds an
// A tile (BM x BK) and the NB weight tiles (BK x BN each) side by side
// (kDh: two A tiles, and the BN x BK tile of w2 after them).
template <typename T, int NB, int BM, int STAGES, int OP>
__global__ void __launch_bounds__(kThreads, 2)
gmm_kernel(const GemmArgs<T> p) {
  using Sl = Slot<T, BM, OP>;
  constexpr bool AT = OpTraits<OP>::kAT, BT = OpTraits<OP>::kBT;
  constexpr bool TWO = OpTraits<OP>::kTwo, DUAL = OpTraits<OP>::kDual;
  constexpr int BK = Tile<T>::kBK, EPC = Tile<T>::kEPC;
  constexpr int SA = Sl::kSA, SB = Sl::kSB, ST = Sl::kST;
  constexpr int NACC = DUAL ? NB + 1 : NB;  // accumulated products
  constexpr int BN = kWCols / NB;  // output columns of the tile
  constexpr int WM = BM / 2;       // rows per warp
  constexpr int MT = WM / 16;      // m16 tiles per warp
  constexpr int WN = BN / 4;       // output columns per warp
  constexpr int NT = WN / 8;       // n8 tiles per warp and operand
  constexpr int A_SLOT = Sl::kA, B_SLOT = Sl::kB;
  constexpr bool kBF16 = std::is_same<T, bf16>::value;
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "tile shape");
  static_assert(!DUAL || NB == 2, "kDh: x.w1 and x.w3 beside dout.w2^T");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + STAGES * A_SLOT;

  const int M = p.M, K = p.K, N = p.N;
  const int e = blockIdx.y, split = blockIdx.z;
  const int m0 = (blockIdx.x % p.m_tiles) * BM;
  const int n0 = (blockIdx.x / p.m_tiles) * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;

  const T* ae = p.a + (size_t)e * M * K;
  const T* a2e = (TWO || DUAL) ? p.a2 + (size_t)e * M * K : ae;
  const T* b0e = p.b0 + (size_t)e * K * N;
  const T* b1e = (NB == 2 || TWO) ? p.b1 + (size_t)e * K * N : b0e;
  const T* b2e = DUAL ? p.b2 + (size_t)e * K * N : b0e;
  const int k_seg = (K + BK - 1) / BK;  // K tiles of one segment
  const int k_tiles = TWO ? 2 * k_seg : k_seg;
  const int kt0 = split * p.k_tiles_per_split;
  const int nk = min(p.k_tiles_per_split, k_tiles - kt0);

  // One slot: the A tile (zero past M or K), then the weight tiles (zero
  // past K or N), all in 16-byte chunks.
  auto load_slot = [&](int slot, int kt) {
    const bool seg2 = TWO && kt >= k_seg;
    const int k0 = (seg2 ? kt - k_seg : kt) * BK;
    const T* asrc = seg2 ? a2e : ae;
    T* as = As + slot * A_SLOT;
    T* bs = Bs + slot * B_SLOT;
    if constexpr (AT) {
      constexpr int CPR = BM / EPC;  // chunks per stored row (one k)
#pragma unroll
      for (int it = 0; it < (BK * CPR + kThreads - 1) / kThreads; ++it) {
        const int i = tid + it * kThreads;
        if (i >= BK * CPR) break;
        const int r = i / CPR, c = (i % CPR) * EPC;
        const bool ok = k0 + r < K && m0 + c < M;
        cp_async16(as + r * SA + c,
                   ok ? asrc + (size_t)(k0 + r) * M + m0 + c : asrc, ok);
      }
    } else {
      constexpr int CPR = BK / EPC;  // 4 chunks per A row
#pragma unroll
      for (int tile = 0; tile < (DUAL ? 2 : 1); ++tile) {
        const T* src = tile ? a2e : asrc;
#pragma unroll
        for (int it = 0; it < (BM * CPR + kThreads - 1) / kThreads; ++it) {
          const int i = tid + it * kThreads;
          if (i >= BM * CPR) break;
          const int r = i / CPR, c = (i % CPR) * EPC;
          const bool ok = m0 + r < M && k0 + c < K;
          cp_async16(as + tile * Sl::kA1 + r * SA + c,
                     ok ? src + (size_t)(m0 + r) * K + k0 + c : src, ok);
        }
      }
    }
    if constexpr (BT) {
      constexpr int CPR = BK / EPC;  // chunks per stored row (one n)
#pragma unroll
      for (int it = 0; it < kWCols * CPR / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int r = i / CPR, c = (i % CPR) * EPC;
        const int n = n0 + r % BN;
        const T* src = (r >= BN || seg2) ? b1e : b0e;
        const bool ok = n < N && k0 + c < K;
        cp_async16(bs + r * SB + c, ok ? src + (size_t)n * K + k0 + c : b0e,
                   ok);
      }
    } else {
      constexpr int CPR = kWCols / EPC;  // 16 or 32 chunks per B row
#pragma unroll
      for (int it = 0; it < BK * CPR / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int r = i / CPR, c = (i % CPR) * EPC;
        const int col = n0 + c % BN;
        const T* src = c < BN ? b0e : b1e;
        const bool ok = k0 + r < K && col < N;
        cp_async16(bs + r * SB + c,
                   ok ? src + (size_t)(k0 + r) * N + col : b0e, ok);
      }
      if constexpr (DUAL) {  // w2's BN rows n0.. of K, after the B tile
        constexpr int CPRT = BK / EPC;
        T* bt = bs + Sl::kB1;
#pragma unroll
        for (int it = 0; it < BN * CPRT / kThreads; ++it) {
          const int i = tid + it * kThreads;
          const int r = i / CPRT, c = (i % CPRT) * EPC;
          const bool ok = n0 + r < N && k0 + c < K;
          cp_async16(bt + r * ST + c,
                     ok ? b2e + (size_t)(n0 + r) * K + k0 + c : b2e, ok);
        }
      }
    }
  };

  float acc[MT][NACC * NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NACC * NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_slot(s, kt0 + s);
    cp_async_commit();
  }

  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();  // slot i has landed (this thread's part)
    __syncthreads();              // ... everyone's; slot i - 1 is consumed
    if (i + STAGES - 1 < nk)
      load_slot((i + STAGES - 1) % STAGES, kt0 + i + STAGES - 1);
    cp_async_commit();

    // this warp's rows (A) and columns (B) of the slot
    const T* as = As + (i % STAGES) * A_SLOT + (AT ? wm * WM : wm * WM * SA);
    const T* bs = Bs + (i % STAGES) * B_SLOT + (BT ? wn * WN * SB : wn * WN);
    // kDh: this warp's dout rows and w2 rows
    const T* as2 = As + (i % STAGES) * A_SLOT + Sl::kA1 + wm * WM * SA;
    const T* bt = Bs + (i % STAGES) * B_SLOT + Sl::kB1 + wn * WN * ST;
    if constexpr (kBF16) {
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (AT)
            ldsm_x4_trans(af[mt], as + (ks * 16 + (lane & 7) +
                                        (lane >> 4) * 8) * SA +
                                       mt * 16 + ((lane >> 3) & 1) * 8);
          else
            ldsm_x4(af[mt], as + (mt * 16 + (lane & 15)) * SA + ks * 16 +
                                (lane >> 4) * 8);
        }
#pragma unroll
        for (int op = 0; op < NB; ++op)
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp) {
            uint32_t bf[4];
            if constexpr (BT)
              ldsm_x4(bf, bs + (op * BN + jp * 16 + (lane & 7) +
                                (lane >> 4) * 8) * SB +
                              ks * 16 + ((lane >> 3) & 1) * 8);
            else
              ldsm_x4_trans(bf, bs + (ks * 16 + (lane & 15)) * SB + op * BN +
                                    jp * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][op * NT + 2 * jp], af[mt], bf[0], bf[1]);
              mma_bf16(acc[mt][op * NT + 2 * jp + 1], af[mt], bf[2], bf[3]);
            }
          }
        if constexpr (DUAL) {  // dh += dout . w2^T
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldsm_x4(af[mt], as2 + (mt * 16 + (lane & 15)) * SA + ks * 16 +
                                (lane >> 4) * 8);
#pragma unroll
          for (int jp = 0; jp < NT / 2; ++jp) {
            uint32_t bf[4];
            ldsm_x4(bf, bt + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * ST +
                            ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][NB * NT + 2 * jp], af[mt], bf[0], bf[1]);
              mma_bf16(acc[mt][NB * NT + 2 * jp + 1], af[mt], bf[2], bf[3]);
            }
          }
        }
      }
    } else {
      // The tensor cores add into their accumulator with truncation, an
      // error that grows with the number of products summed into it (5e-4
      // over mixtral's K = 14336).  So one slot's products go into a
      // zeroed partial, which is added to acc in IEEE fp32 once per slot.
      float part[MT][NACC * NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NACC * NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[mt][j][q] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        uint32_t bb[NB * NT][2], bsm[NB * NT][2];
#pragma unroll
        for (int op = 0; op < NB; ++op)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float x0, x1;  // B[k = t][n = g] and B[t + 4][g]
            if constexpr (BT) {
              const T* q = bs + (op * BN + j * 8 + g) * SB + ks * 8 + t;
              x0 = q[0];
              x1 = q[4];
            } else {
              const T* q = bs + (ks * 8 + t) * SB + op * BN + j * 8 + g;
              x0 = q[0];
              x1 = q[4 * SB];
            }
            split_tf32(x0, bb[op * NT + j][0], bsm[op * NT + j][0]);
            split_tf32(x1, bb[op * NT + j][1], bsm[op * NT + j][1]);
          }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float x[4];  // A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]
          if constexpr (AT) {
            const T* q = as + (ks * 8 + t) * SA + mt * 16 + g;
            x[0] = q[0];
            x[1] = q[8];
            x[2] = q[4 * SA];
            x[3] = q[4 * SA + 8];
          } else {
            const T* q = as + (mt * 16 + g) * SA + ks * 8 + t;
            x[0] = q[0];
            x[1] = q[8 * SA];
            x[2] = q[4];
            x[3] = q[8 * SA + 4];
          }
          uint32_t ab[4], asm_[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) split_tf32(x[q], ab[q], asm_[q]);
#pragma unroll
          for (int j = 0; j < NB * NT; ++j) {
            mma_tf32(part[mt][j], asm_, bb[j]);
            mma_tf32(part[mt][j], ab, bsm[j]);
            mma_tf32(part[mt][j], ab, bb[j]);
          }
        }
        if constexpr (DUAL) {  // dh += dout . w2^T, B from the w2 rows
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const T* q = bt + (j * 8 + g) * ST + ks * 8 + t;
            split_tf32(q[0], bb[j][0], bsm[j][0]);
            split_tf32(q[4], bb[j][1], bsm[j][1]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const T* q = as2 + (mt * 16 + g) * SA + ks * 8 + t;
            const float x[4] = {q[0], q[8 * SA], q[4], q[8 * SA + 4]};
            uint32_t ab[4], asm_[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) split_tf32(x[r], ab[r], asm_[r]);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              mma_tf32(part[mt][NB * NT + j], asm_, bb[j]);
              mma_tf32(part[mt][NB * NT + j], ab, bsm[j]);
              mma_tf32(part[mt][NB * NT + j], ab, bb[j]);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NACC * NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][j][q] += part[mt][j][q];
    }
  }
  cp_async_wait<0>();

  // Epilogue: thread (g, t) of an m16n8 tile holds rows g and g + 8,
  // columns 2t and 2t + 1 (N is a multiple of 8: a pair is in or out).
  const size_t slab = (size_t)gridDim.y * M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * WM + mt * 16 + g + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * WN + j * 8 + 2 * t;
        if (col >= N) continue;
        const float* c0 = acc[mt][j];
        float v0 = c0[2 * half], v1 = c0[2 * half + 1];
        const size_t o = ((size_t)e * M + row) * N + col;
        if constexpr (OP == kFwd) {
          if constexpr (NB == 2) {
            const float* c1 = acc[mt][NT + j];
            v0 = silu(v0) * c1[2 * half];
            v1 = silu(v1) * c1[2 * half + 1];
          }
          if (p.partial != nullptr)
            store2(p.partial + split * slab + o, v0, v1);
          else
            store2(p.dst + o, v0, v1);
        } else if constexpr (OP == kDh) {  // v: a; then b and dh
          const float* cb = acc[mt][NT + j];
          const float* ch = acc[mt][2 * NT + j];
          float da0, db0, h0, da1, db1, h1;
          swiglu_bwd(ch[2 * half], v0, cb[2 * half], da0, db0, h0);
          swiglu_bwd(ch[2 * half + 1], v1, cb[2 * half + 1], da1, db1, h1);
          store2(p.dst + o, da0, da1);
          store2(p.dst1 + o, db0, db1);
          store2(p.dst2 + o, h0, h1);
        } else {
          store2(p.dst + o, v0, v1);
          if constexpr (NB == 2) {
            const float* c1 = acc[mt][NT + j];
            store2(p.dst1 + o, c1[2 * half], c1[2 * half + 1]);
          }
        }
      }
    }
}

// out[i] = sum over splits of partial[s][i], in split order.
template <typename T>
__global__ void split_sum_kernel(const float* __restrict__ partial,
                                 T* __restrict__ out, size_t n, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += partial[(size_t)k * n + i];
    if constexpr (std::is_same<T, bf16>::value)
      out[i] = __float2bfloat16(s);
    else
      out[i] = s;
  }
}

template <typename T, int NB, int BM, int STAGES, int OP = kFwd>
int launch_gmm(GemmArgs<T> p, int E, int splits, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, BM, STAGES, OP>();
  auto kern = gmm_kernel<T, NB, BM, STAGES, OP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  p.m_tiles = (p.M + BM - 1) / BM;
  const int n_tiles = (p.N + kWCols / NB - 1) / (kWCols / NB);
  const int k_tiles = (OpTraits<OP>::kTwo ? 2 : 1) *
                      ((p.K + Tile<T>::kBK - 1) / Tile<T>::kBK);
  p.k_tiles_per_split = k_tiles / splits;
  const dim3 grid(p.m_tiles * n_tiles, E, splits);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// gate-up into h, then down into out (through `scratch` when split).
template <typename T, int BM, int STAGES>
int run(const void* buf, const void* w1, const void* w3, const void* w2,
        void* h, void* out, void* scratch, int E, int C, int d, int f,
        int splits, cudaStream_t s) {
  GemmArgs<T> p{};
  p.a = static_cast<const T*>(buf);
  p.b0 = static_cast<const T*>(w1);
  p.b1 = static_cast<const T*>(w3);
  p.dst = static_cast<T*>(h);
  p.M = C, p.K = d, p.N = f;
  int err = launch_gmm<T, 2, BM, STAGES>(p, E, 1, s);
  if (err != 0) return err;
  float* partial = splits > 1 ? static_cast<float*>(scratch) : nullptr;
  p = GemmArgs<T>{};
  p.a = static_cast<const T*>(h);
  p.b0 = static_cast<const T*>(w2);
  p.dst = static_cast<T*>(out);
  p.partial = partial;
  p.M = C, p.K = f, p.N = d;
  err = launch_gmm<T, 1, BM, STAGES>(p, E, splits, s);
  if (err != 0 || splits == 1) return err;
  const size_t n = (size_t)E * C * d;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  split_sum_kernel<T><<<blocks, 256, 0, s>>>(partial, static_cast<T*>(out), n,
                                             splits);
  return (int)cudaGetLastError();
}

template <int BM, int STAGES>
int run_dtype(int dtype, const void* buf, const void* w1, const void* w3,
              const void* w2, void* h, void* out, void* scratch, int E, int C,
              int d, int f, int splits, cudaStream_t s) {
  if (dtype == 1)
    return run<bf16, BM, STAGES>(buf, w1, w3, w2, h, out, scratch, E, C, d, f,
                                 splits, s);
  if constexpr (BM <= 64)
    return run<float, BM, STAGES>(buf, w1, w3, w2, h, out, scratch, E, C, d,
                                  f, splits, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The bf16 backward on wgmma: TMA into an mbarrier ring, one producer warp,
// two consumer warpgroups of 64 rows each (see the note at the top).
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 288;  // consumer warpgroups 0 and 1, producer warp 8
constexpr int kWgBM = 128;       // output rows of a block: 64 per warpgroup
constexpr int kWgBK = 64;        // K per ring stage: one 128-byte swizzle row
constexpr int kWgATile = kWgBM * kWgBK * 2;  // bytes of one A tile
constexpr int kWgBox = 64 * kWgBK * 2;       // bytes of one 64 x 64 box

// The operands of one backward GEMM on wgmma.  A tiles are 128 x 64 (two
// warpgroups of 64 rows), read K-major (K contiguous in memory) or
// MN-major (M contiguous: the product takes A transposed).  Accumulator 0
// is A tile 0 against a B tile of W0 columns (several 64-column boxes
// side by side, from one or two tensors), kDh's accumulator 1 dout
// against w2.
//   kDh, NB 2: [a | b] = buf.[w1 | w3] (W0 128: 64 columns of each, B
//              MN-major) and dh = dout.w2^T (64 columns, B K-major); A
//              buf and dout, K-major.  96 accumulator registers a thread.
//   kDw, NB 1: dw2 = h^T.dout; A and B MN-major, W0 256.
//   kDw, NB 2: [dw1 | dw3] = buf^T.[da | db]; A and B MN-major, W0 256:
//              128 columns of each.
//   kDx, NB 1: dbuf = da.w1^T + db.w3^T: two K segments (A da then db, B
//              w1 then w3), all K-major, W0 256.
template <int OP, int NB>
struct WgOp {
  static constexpr bool kDual = OP == kDh;  // the second accumulator
  static constexpr int kW0 = OP == kDh ? 128 : 256;  // accumulator 0's width
  static constexpr int kW1 = 64;                     // kDh's dh
  // output columns per tile (of each output)
  static constexpr int kTileN = OP == kDh ? 64 : NB == 2 ? 128 : 256;
  static constexpr int kATiles = OP == kDh ? 2 : 1;
  static constexpr bool kAMN = OP == kDw;
  static constexpr bool kBMN = OP != kDx;  // accumulator 0's B
  static constexpr int kStages = 4;
  static constexpr int kB0 = kW0 * kWgBK * 2;
  static constexpr int kStage =
      kATiles * kWgATile + kB0 + (kDual ? kW1 * kWgBK * 2 : 0);
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStage +
                                  2 * kStages * sizeof(uint64_t);
};

struct WgArgs {
  CUtensorMap ta[2];  // A operands (kDx: one per K segment)
  CUtensorMap tb[3];  // B operands (kDx: one per K segment)
  bf16* dst[3];       // (E, M, N) outputs; kDh: da, db, h
  int M, K, N, E, m_tiles, n_tiles;
};

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 x 64, fp32) += A (64 x 16) . B (16 x 64), bf16 from shared memory;
// TA / TB = 1 reads that operand MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 128, fp32) += A (64 x 16) . B (16 x 128), as wgmma_n64.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 256, fp32) += A (64 x 16) . B (16 x 256), as wgmma_n64.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (BN == 64)
    wgmma_n64<TA, TB>(d, da, db);
  else if constexpr (BN == 128)
    wgmma_n128<TA, TB>(d, da, db);
  else
    wgmma_n256<TA, TB>(d, da, db);
}

// Keeps the compiler from moving an accumulator across the asynchronous
// products that write it.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// One backward GEMM over all experts, on a persistent grid: block b takes
// the 128 x BN output tiles b, b + gridDim.x, ... of the (M tile fastest,
// then N tile, then expert) order, so the blocks at work at one time share
// weight tiles through the L2 cache.  Warp 8 (lane 0) fills the ring,
// running on into the next tile while the consumers finish this one: per
// stage it waits for the stage's "empty" barrier, arms its "full" barrier
// with the stage's bytes and issues the TMA boxes.  Warpgroups 0 and 1
// wait on "full", issue the stage's wgmmas (4 K steps of 16) for their 64
// rows, keep one stage of products in flight, and release the stage
// before it on "empty" (one arrival per consumer warp).  Stage and parity
// run on over the block's tiles.
template <int OP, int NB>
__global__ void __launch_bounds__(kWgThreads, 1)
wg_kernel(const __grid_constant__ WgArgs p) {
  using W = WgOp<OP, NB>;
  constexpr int S = W::kStages, BN = W::kTileN, W0 = W::kW0;
  extern __shared__ unsigned char wg_smem[];
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  const uint32_t full0 = ring + S * W::kStage;
  const uint32_t empty0 = full0 + S * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k_seg = (p.K + kWgBK - 1) / kWgBK;
  const int nk = OP == kDx ? 2 * k_seg : k_seg;
  const int mn_tiles = p.m_tiles * p.n_tiles;
  const int tiles = mn_tiles * p.E;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      tma::mbar_init(full0 + 8 * s, 1);
      tma::mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane != 0) return;
    int it = 0;  // ring slot uses so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int e = tile / mn_tiles, mn = tile % mn_tiles;
      const int m0 = (mn % p.m_tiles) * kWgBM, n0 = (mn / p.m_tiles) * BN;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % S;
        if (it >= S) tma::mbar_wait(empty0 + 8 * s, ((it / S) + 1) & 1);
        const uint32_t full = full0 + 8 * s;
        tma::mbar_expect_tx(full, W::kStage);
        const int seg = (OP == kDx && kt >= k_seg) ? 1 : 0;
        const int k0 = (kt - seg * k_seg) * kWgBK;
        const uint32_t sa = ring + s * W::kStage;
        const uint32_t sb = sa + W::kATiles * kWgATile;
#pragma unroll
        for (int a = 0; a < W::kATiles; ++a) {
          const CUtensorMap* map = &p.ta[OP == kDx ? seg : a];
          if constexpr (W::kAMN) {
            tma::load_3d(sa + a * kWgATile, map, full, m0, k0, e);
            tma::load_3d(sa + a * kWgATile + kWgBox, map, full, m0 + 64, k0,
                         e);
          } else {
            tma::load_3d(sa + a * kWgATile, map, full, k0, m0, e);
          }
        }
        if constexpr (W::kBMN) {
          // W0 / 64 boxes side by side; kDh and dw1 | dw3 take the first
          // half from tb[0] and the second from tb[1]
          constexpr int boxes = W0 / 64;
          constexpr int per = (OP == kDw && NB == 1) ? boxes : boxes / 2;
#pragma unroll
          for (int j = 0; j < boxes; ++j)
            tma::load_3d(sb + j * kWgBox, &p.tb[j / per], full,
                         n0 + 64 * (j % per), k0, e);
        } else {
          tma::load_3d(sb, &p.tb[seg], full, k0, n0, e);
        }
        if constexpr (W::kDual)
          tma::load_3d(sb + W::kB0, &p.tb[2], full, k0, n0, e);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. of each tile
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int M = p.M, N = p.N;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int e = tile / mn_tiles, mn = tile % mn_tiles;
    const int m0 = (mn % p.m_tiles) * kWgBM, n0 = (mn / p.m_tiles) * BN;
    float acc[W0 / 2], acc1[W::kDual ? W::kW1 / 2 : 1];
#pragma unroll
    for (int r = 0; r < W0 / 2; ++r) acc[r] = 0.0f;
#pragma unroll
    for (int r = 0; r < (W::kDual ? W::kW1 / 2 : 1); ++r) acc1[r] = 0.0f;

    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % S;
      tma::mbar_wait(full0 + 8 * s, (it / S) & 1);
      __syncwarp();
      const uint32_t sa = ring + s * W::kStage;
      const uint32_t sb = sa + W::kATiles * kWgATile;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < kWgBK / 16; ++ks) {
        // this warpgroup's 64 rows of A: the second half of a K-major tile
        // (64 rows of 128 bytes) or the second box of an MN-major one
        const uint32_t a = sa + wg * kWgBox;
        const uint64_t da = W::kAMN ? wg_desc(a + ks * 2048, kWgBox, 1024)
                                    : wg_desc(a + ks * 32, 16, 1024);
        const uint64_t db = W::kBMN ? wg_desc(sb + ks * 2048, kWgBox, 1024)
                                    : wg_desc(sb + ks * 32, 16, 1024);
        wgmma<W0, W::kAMN ? 1 : 0, W::kBMN ? 1 : 0>(acc, da, db);
        if constexpr (W::kDual)  // dh += dout . w2^T, both K-major
          wgmma<W::kW1, 0, 0>(acc1, wg_desc(a + kWgATile + ks * 32, 16, 1024),
                              wg_desc(sb + W::kB0 + ks * 32, 16, 1024));
      }
      wg_commit();
      wg_wait<1>();  // the previous stage's products are done: release it
      if (kt > 0 && lane == 0) tma::mbar_arrive(empty0 + 8 * ((it - 1) % S));
    }
    wg_wait<0>();
    if (lane == 0) tma::mbar_arrive(empty0 + 8 * ((it - 1) % S));
    fence_acc(acc);
    fence_acc(acc1);

    // Epilogue: in warp w of the warpgroup, lane (g, t) holds rows 16 w + g
    // and + 8, columns 8 j + 2 t and + 1, of each accumulator.
    const int row0 = m0 + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + half * 8;
      if (row >= M) continue;
      const size_t orow = ((size_t)e * M + row) * N;
      if constexpr (OP == kDh) {  // a: columns 0..63, b: 64..127; dh
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + j * 8 + 2 * t;
          if (col >= N) continue;
          const int r = 4 * j + 2 * half, rb = r + 32;
          float da0, db0, h0, da1, db1, h1;
          swiglu_bwd(acc1[r], acc[r], acc[rb], da0, db0, h0);
          swiglu_bwd(acc1[r + 1], acc[r + 1], acc[rb + 1], da1, db1, h1);
          store2(p.dst[0] + orow + col, da0, da1);
          store2(p.dst[1] + orow + col, db0, db1);
          store2(p.dst[2] + orow + col, h0, h1);
        }
      } else {  // dw1 | dw3: columns 0..127 of each; else one output
#pragma unroll
        for (int j = 0; j < W0 / 8; ++j) {
          const int out = j / (BN / 8);
          const int col = n0 + (j % (BN / 8)) * 8 + 2 * t;
          if (col >= N) continue;
          const int r = 4 * j + 2 * half;
          store2(p.dst[out] + orow + col, acc[r], acc[r + 1]);
        }
      }
    }
  }
}

// A bf16 (E, rows, inner) array as a 3-D tensor map whose box is 64 inner
// elements (128 bytes, the swizzle span) by box_rows rows of one expert.
bool make_map(CUtensorMap* map, const void* ptr, int inner, int rows, int E,
              int box_rows) {
  return tma::make_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, inner,
                      rows, E, 64, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The SMs of the current device: the persistent grid's size.
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <int OP, int NB>
int launch_wg(WgArgs& p, int E, cudaStream_t stream) {
  using W = WgOp<OP, NB>;
  auto kern = wg_kernel<OP, NB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  p.E = E;
  p.m_tiles = (p.M + kWgBM - 1) / kWgBM;
  p.n_tiles = (p.N + W::kTileN - 1) / W::kTileN;
  const long tiles = (long)p.m_tiles * p.n_tiles * E;
  kern<<<(unsigned)(tiles < sms ? tiles : sms), kWgThreads, W::kSmem,
         stream>>>(p);
  return (int)cudaGetLastError();
}

// The four bf16 GEMMs in order on wgmma.  Tensor maps: A boxes 64 x 128
// (K-major) or 64 x 64 (MN-major, two per tile), B boxes 64 x 256 (dbuf's
// K-major w1, w3), 64 x 64 (kDh's K-major w2) or 64 x 64 (MN-major).
int run_bwd_wg(const void* buf, const void* w1, const void* w3,
               const void* w2, const void* dout, void* da, void* db, void* h,
               void* dbuf, void* dw1, void* dw3, void* dw2, int E, int C,
               int d, int f, cudaStream_t s) {
  const int bad = (int)cudaErrorInvalidValue;
  auto m = [](void* x) { return static_cast<bf16*>(x); };
  WgArgs p{};
  // 1. a, b, dh -> da, db, h: M = C, K = d, N = f
  if (!make_map(&p.ta[0], buf, d, C, E, kWgBM) ||
      !make_map(&p.ta[1], dout, d, C, E, kWgBM) ||
      !make_map(&p.tb[0], w1, f, d, E, 64) ||
      !make_map(&p.tb[1], w3, f, d, E, 64) ||
      !make_map(&p.tb[2], w2, d, f, E, 64))
    return bad;
  p.dst[0] = m(da), p.dst[1] = m(db), p.dst[2] = m(h);
  p.M = C, p.K = d, p.N = f;
  int err = launch_wg<kDh, 2>(p, E, s);
  if (err != 0) return err;
  // 2. dw2 = h^T . dout: M = f, K = C, N = d
  p = WgArgs{};
  if (!make_map(&p.ta[0], h, f, C, E, 64) ||
      !make_map(&p.tb[0], dout, d, C, E, 64))
    return bad;
  p.dst[0] = m(dw2);
  p.M = f, p.K = C, p.N = d;
  if ((err = launch_wg<kDw, 1>(p, E, s)) != 0) return err;
  // 3. dw1, dw3 = buf^T . da, buf^T . db: M = d, K = C, N = f
  p = WgArgs{};
  if (!make_map(&p.ta[0], buf, d, C, E, 64) ||
      !make_map(&p.tb[0], da, f, C, E, 64) ||
      !make_map(&p.tb[1], db, f, C, E, 64))
    return bad;
  p.dst[0] = m(dw1), p.dst[1] = m(dw3);
  p.M = d, p.K = C, p.N = f;
  if ((err = launch_wg<kDw, 2>(p, E, s)) != 0) return err;
  // 4. dbuf = da . w1^T + db . w3^T: M = C, K = f per segment, N = d
  p = WgArgs{};
  if (!make_map(&p.ta[0], da, f, C, E, kWgBM) ||
      !make_map(&p.ta[1], db, f, C, E, kWgBM) ||
      !make_map(&p.tb[0], w1, f, d, E, 256) ||
      !make_map(&p.tb[1], w3, f, d, E, 256))
    return bad;
  p.dst[0] = m(dbuf);
  p.M = C, p.K = f, p.N = d;
  return launch_wg<kDx, 1>(p, E, s);
}

// The fp32 backward's four grouped GEMMs on the mma.sync main loop (all BM
// 64, a ring of 4 slots):
//   1. a, b = buf . w1, buf . w3 and dh = dout . w2^T in fp32, then
//      da, db, h                          M = C, K = d, N = f   (kDh)
//   2. dw2 = h^T . dout                    M = f, K = C, N = d   (kDw)
//   3. [dw1, dw3] = buf^T . [da, db]       M = d, K = C, N = f   (kDw)
//   4. dbuf = da . w1^T + db . w3^T        M = C, K = 2f, N = d  (kDx)
constexpr int kBwdBM = 64, kBwdStages = 4;

template <typename T>
int run_bwd(const void* buf, const void* w1, const void* w3, const void* w2,
            const void* dout, void* da, void* db, void* h, void* dbuf,
            void* dw1, void* dw3, void* dw2, int E, int C, int d, int f,
            cudaStream_t s) {
  constexpr int BM = kBwdBM, ST = kBwdStages;
  auto c = [](const void* x) { return static_cast<const T*>(x); };
  auto m = [](void* x) { return static_cast<T*>(x); };
  GemmArgs<T> p{};
  p.a = c(buf), p.a2 = c(dout), p.b0 = c(w1), p.b1 = c(w3), p.b2 = c(w2);
  p.dst = m(da), p.dst1 = m(db), p.dst2 = m(h);
  p.M = C, p.K = d, p.N = f;
  int err = launch_gmm<T, 2, BM, ST, kDh>(p, E, 1, s);
  if (err != 0) return err;
  p = GemmArgs<T>{};
  p.a = c(h), p.b0 = c(dout), p.dst = m(dw2);
  p.M = f, p.K = C, p.N = d;
  if ((err = launch_gmm<T, 1, BM, ST, kDw>(p, E, 1, s)) != 0) return err;
  p = GemmArgs<T>{};
  p.a = c(buf), p.b0 = c(da), p.b1 = c(db), p.dst = m(dw1), p.dst1 = m(dw3);
  p.M = d, p.K = C, p.N = f;
  if ((err = launch_gmm<T, 2, BM, ST, kDw>(p, E, 1, s)) != 0) return err;
  p = GemmArgs<T>{};
  p.a = c(da), p.a2 = c(db), p.b0 = c(w1), p.b1 = c(w3), p.dst = m(dbuf);
  p.M = C, p.K = f, p.N = d;
  return launch_gmm<T, 1, BM, ST, kDx>(p, E, 1, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The (BM, STAGES) pairs built: the deeper rings for the small tiles keep
// more weight bytes in flight at decode, where the call is bound by bytes;
// each stays under half of an SM's shared memory, so two blocks fit.  fp32
// takes BM <= 64: its per-slot partial sums double the accumulator
// registers, which at BM = 128 would not fit two blocks per SM.
#define MOE_GMM_TILES(X) X(32, 8) X(64, 6) X(128, 4)

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  h: (E, C, f) scratch in buf's type;
// scratch: splits * E * C * d floats when splits > 1 (both allocated by the
// caller).  block_m and stages must be one of MOE_GMM_TILES (block_m <= 64
// for fp32); splits must
// divide the down kernel's K tiles (ceil(f / BK)).  Returns
// cudaGetLastError() after the launches.
extern "C" int moe_gmm_launch(const void* buf, const void* w1, const void* w3,
                              const void* w2, void* h, void* out,
                              void* scratch, int E, int C, int d, int f,
                              int block_m, int stages, int splits, int dtype,
                              void* stream) {
  const int bk = dtype == 1 ? Tile<bf16>::kBK : Tile<float>::kBK;
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0 || d % 8 != 0 || f % 8 != 0 ||
      (dtype != 0 && dtype != 1) || splits <= 0 ||
      ((f + bk - 1) / bk) % splits != 0 ||
      (splits > 1 && (scratch == nullptr || !aligned16(scratch))) ||
      !aligned16(buf) || !aligned16(w1) || !aligned16(w3) || !aligned16(w2) ||
      !aligned16(h) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MOE_GMM_CASE(BM, ST)                                                  \
  if (block_m == BM && stages == ST)                                          \
    return run_dtype<BM, ST>(dtype, buf, w1, w3, w2, h, out, scratch, E, C,   \
                             d, f, splits, s);
  MOE_GMM_TILES(MOE_GMM_CASE)
#undef MOE_GMM_CASE
  return (int)cudaErrorInvalidValue;
}

// Backward of moe_gmm.  dtype: 0 = float32, 1 = bfloat16; every tensor in
// that type, contiguous and 16-byte aligned: buf/dout/dbuf (E, C, d),
// w1/w3/dw1/dw3 (E, d, f), w2/dw2 (E, f, d), and the scratch da, db, h
// (E, C, f) that the caller allocates.  a = buf . w1 and b = buf . w3 are
// recomputed here, in the same fp32 accumulators as dh (so h is the
// forward's h), rather than kept by the forward.  Four launches on
// `stream` (bf16 on wgmma, fp32 on mma.sync), no atomics and no K split:
// every call gives the same bits.  Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue if a tensor map cannot be made.
extern "C" int moe_gmm_bwd_launch(const void* buf, const void* w1,
                                  const void* w3, const void* w2,
                                  const void* dout, void* da, void* db,
                                  void* h, void* dbuf, void* dw1, void* dw3,
                                  void* dw2, int E, int C, int d, int f,
                                  int dtype, void* stream) {
  const void* ptrs[] = {buf, w1, w3, w2, dout, da, db, h, dbuf, dw1, dw3,
                        dw2};
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0 || d % 8 != 0 || f % 8 != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  for (const void* q : ptrs)
    if (!aligned16(q)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run_bwd_wg(buf, w1, w3, w2, dout, da, db, h, dbuf, dw1, dw3, dw2,
                      E, C, d, f, s);
  return run_bwd<float>(buf, w1, w3, w2, dout, da, db, h, dbuf, dw1, dw3,
                        dw2, E, C, d, f, s);
}
