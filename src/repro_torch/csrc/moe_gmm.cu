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
//   wgmma, TMA and a persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

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

// The backward's four grouped GEMMs (all BM 64, a ring of 4 slots):
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
// `stream`, no atomics and no K split: every call gives the same bits.
// Returns cudaGetLastError() after the launches.
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
    return run_bwd<bf16>(buf, w1, w3, w2, dout, da, db, h, dbuf, dw1, dw3,
                         dw2, E, C, d, f, s);
  return run_bwd<float>(buf, w1, w3, w2, dout, da, db, h, dbuf, dw1, dw3,
                        dw2, E, C, d, f, s);
}
