// Backward of GQA flash attention for Hopper (sm_90a).
//
// Replaces: the gradient of the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py (`flash_attention`),
//   which the JAX package differentiates through its XLA reference
//   (`chunked_attention`, jax.grad).  Given q (B, S, H, dh), k/v (B, T, KV,
//   dh), the forward's output o (B, S, H, dh) and row log-sum-exp lse
//   (B, H, S, fp32, from flash_attention.cu), and dO = dL/do, it computes,
//   with s_ij = scale * q_i . k_j and the causal / window masks of the
//   forward:
//     P_ij  = exp(s_ij - lse_i)            (0 where masked)
//     D_i   = sum_d dO_id * o_id
//     dP_ij = dO_i . v_j
//     dS_ij = P_ij * (dP_ij - D_i)
//     dq_i  = scale * sum_j dS_ij k_j
//     dk_j  = scale * sum_{i, heads of the group} dS_ij q_i
//     dv_j  = sum_{i, heads of the group} P_ij dO_i
//   fp32 and bf16 inputs, fp32 sums, results in the input's type.  Head
//   dims: every multiple of 16 up to 128, G = H / KV up to 64, as the
//   forward takes.
//
// What bounds it on the H100: operations.  It recomputes S in both kernels
//   and dP in both, so it does 7 products of the forward's 2; granite's
//   training shape (B 4, S 1024, H 16, dh 64, causal) needs 10 dh FLOPs
//   per visible pair and head, 21.5 GFLOP (0.022 ms of bf16 tensor-core
//   time), against 50 MB of traffic (0.015 ms).
//
// Design: two kernels, no atomics, so every call gives the same bits.
//   1. dq (grid: query tiles x B * H, the long causal tiles first): one
//      block owns 64 query rows of one head.  Its prologue forms D for
//      those rows (and writes it for kernel 2), then it walks the key tiles
//      [lo, hi) that meet the triangle or band, as the forward does, and
//      accumulates dq in registers.
//   2. dk/dv (grid: key tiles x B * KV, the long causal tiles first): one
//      block owns 64 keys of one kv head and walks the query tiles of all
//      G heads of its group over the rows that can see those keys (causal:
//      from the tile's first key; window: up to its last key + window),
//      accumulating dk and dv in registers; the G-head sum of GQA stays
//      inside the block.
//
// * bf16: tensor cores, every product on mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate), 4 warps of 16 rows each, as the forward.  In the dq kernel
//   a warp owns 16 queries: S = Q K^T and dP = dO V^T take Q and dO as
//   ldmatrix A-fragments and K and V as B-fragments; P = exp2(S scale log2e
//   - lse log2e) from the forward's row log-sum-exp; dS = P (dP - D) is
//   re-packed from its accumulators into bf16 A-fragments in registers and
//   dQ += dS K reads K with ldmatrix.trans.  In the dk/dv kernel a warp
//   owns 16 keys and computes S^T = K Q^T and dP^T = V dO^T with keys as
//   rows, so P^T and dS^T come out as accumulators and are re-packed to
//   A-fragments with no trip through shared memory; dV += P^T dO and
//   dK += dS^T Q read dO and Q with ldmatrix.trans.  The walked operands
//   (K and V in kernel 1; Q, dO and the tile's lse and D in kernel 2) are
//   double-buffered with zero-filling cp.async, rows padded by 16 bytes
//   against bank conflicts; masks are evaluated only on tiles that cross
//   the diagonal, the band edge or a ragged end.  Left on the table:
//   wgmma and TMA (mma.sync reaches a fraction of the card's rate); one
//   pass that forms dq beside dk/dv (by atomics or a second reduction)
//   instead of recomputing S and dP in both kernels; and the 80 dk/dv
//   blocks of a GQA group of 5 at B 1 (hymba-1.5b), fewer than the 132 SMs.
// * fp32: the CUDA cores, as the forward's fp32: 256 threads as 16 x 16,
//   each a 4 x 4 tile of the 64 x 64 score block and a 4 x dh/16 tile of
//   the result; q, dO, k and v tiles are fp32 in shared memory with rows
//   padded by one float (conflict-free column reads); P and dS go through
//   shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define FA_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kMaxGroup = 64;

// ---------------------------------------------------------------------------
// fp32 path: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }

// Rows [r0, r0 + kTile) of a (rows, ld) row-major operand whose row r lies
// at src + r * stride, into dst [kTile][DH + 1] as fp32; rows at or past
// n_rows are zero.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          size_t stride, int r0, int n_rows) {
  for (int i = threadIdx.x; i < kTile * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    dst[r * (DH + 1) + c] =
        r0 + r < n_rows ? to_f(src[(size_t)(r0 + r) * stride + c]) : 0.0f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int Tk,
                                        int causal, int window) {
  return qpos < S && kpos < Tk && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

template <int DH>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * (size_t)kTile * (DH + 1) +
                          (size_t)kTile * (kTile + 1) + 2 * kTile);
}

// grid: (ceil(S / 64), B * H), query tiles in reverse; block 16 x 16.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ o,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   float* __restrict__ Dg, T* __restrict__ dq, int S, int Tk,
                   int H, int KV, int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = DH + 1, kCols = DH / 16;
  float* qs = smem;                  // [64][LD]
  float* dos = qs + kTile * LD;      // [64][LD]
  float* ks = dos + kTile * LD;      // [64][LD]
  float* vs = ks + kTile * LD;       // [64][LD]
  float* dss = vs + kTile * LD;      // [64][65]
  float* lse_s = dss + kTile * (kTile + 1);
  float* D_s = lse_s + kTile;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t qstride = (size_t)H * DH, kstride = (size_t)KV * DH;
  const T* qb = q + ((size_t)b * S * H + h) * DH;
  const T* ob = o + ((size_t)b * S * H + h) * DH;
  const T* dob = dout + ((size_t)b * S * H + h) * DH;
  const T* kb_ = k + ((size_t)b * Tk * KV + kvh) * DH;
  const T* vb_ = v + ((size_t)b * Tk * KV + kvh) * DH;
  const size_t row0 = (size_t)bh * S;  // (b, h) rows of lse / D

  load_tile<T, DH>(qs, qb, qstride, q0, S);
  load_tile<T, DH>(dos, dob, qstride, q0, S);
  // D_i = dO_i . o_i: four threads per row, then a shuffle over the four
  {
    const int r = tid / 4, part = tid % 4;
    float acc = 0.0f;
    if (q0 + r < S) {
      const T* orow = ob + (size_t)(q0 + r) * qstride;
      const T* drow = dob + (size_t)(q0 + r) * qstride;
      for (int c = part; c < DH; c += 4) acc += to_f(orow[c]) * to_f(drow[c]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      D_s[r] = acc;
      lse_s[r] = q0 + r < S ? lse[row0 + q0 + r] : INFINITY;
      if (q0 + r < S) Dg[row0 + q0 + r] = acc;
    }
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;

  const int q_last = min(q0 + kTile, S) - 1;
  const int hi = causal ? min(Tk, q_last + 1) : Tk;
  const int lo = window > 0 ? max(0, q0 - (window - 1)) : 0;
  for (int kb = (lo / kTile) * kTile; kb < hi; kb += kTile) {
    __syncthreads();  // the previous tile is consumed (and the prologue done)
    load_tile<T, DH>(ks, kb_, kstride, kb, Tk);
    load_tile<T, DH>(vs, vb_, kstride, kb, Tk);
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < DH; ++dd) {
      float qa[4], da[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = qs[(ty * 4 + i) * LD + dd];
        da[i] = dos[(ty * 4 + i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = ks[(tx + 16 * j) * LD + dd];
        vv[j] = vs[(tx + 16 * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qa[i], kk[j], sc[i][j]);
          dp[i][j] = fmaf(da[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + r, kb + c, S, Tk, causal, window)
                            ? expf(sc[i][j] * scale - lse_s[r])
                            : 0.0f;
        dss[r * (kTile + 1) + c] = p * (dp[i][j] - D_s[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kk[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kk[c] = ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = dss[(ty * 4 + i) * (kTile + 1) + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(s, kk[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    T* row = dq + ((size_t)b * S * H + (size_t)s * H + h) * DH;
#pragma unroll
    for (int c = 0; c < kCols; ++c) from_f(row + tx + 16 * c, acc[i][c] * scale);
  }
}

template <int DH>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * (size_t)kTile * (DH + 1) +
                          2 * (size_t)kTile * (kTile + 1) + 2 * kTile);
}

// grid: (ceil(T / 64), B * KV); block 16 x 16.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ Dg, T* __restrict__ dk,
                    T* __restrict__ dv, int S, int Tk, int H, int KV,
                    int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = DH + 1, kCols = DH / 16;
  float* ks = smem;                  // [64][LD]
  float* vs = ks + kTile * LD;       // [64][LD]
  float* qs = vs + kTile * LD;       // [64][LD]
  float* dos = qs + kTile * LD;      // [64][LD]
  float* ps = dos + kTile * LD;      // [64 queries][65]
  float* dss = ps + kTile * (kTile + 1);
  float* lse_s = dss + kTile * (kTile + 1);
  float* D_s = lse_s + kTile;

  const int G = H / KV;
  const int bkv = blockIdx.y, b = bkv / KV, kvh = bkv % KV;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t qstride = (size_t)H * DH, kstride = (size_t)KV * DH;

  load_tile<T, DH>(ks, k + ((size_t)b * Tk * KV + kvh) * DH, kstride, k0, Tk);
  load_tile<T, DH>(vs, v + ((size_t)b * Tk * KV + kvh) * DH, kstride, k0, Tk);

  float dka[4][kCols], dva[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[i][c] = dva[i][c] = 0.0f;

  // Query rows that can see a key of this tile.
  const int k_last = min(k0 + kTile, Tk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k_last + window) : S;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t row0 = ((size_t)b * H + h) * S;
    const T* qb = q + ((size_t)b * S * H + h) * DH;
    const T* dob = dout + ((size_t)b * S * H + h) * DH;
    for (int q0 = (q_lo / kTile) * kTile; q0 < q_hi; q0 += kTile) {
      __syncthreads();  // the previous tile is consumed
      load_tile<T, DH>(qs, qb, qstride, q0, S);
      load_tile<T, DH>(dos, dob, qstride, q0, S);
      if (tid < kTile) {
        const bool ok = q0 + tid < S;
        lse_s[tid] = ok ? lse[row0 + q0 + tid] : INFINITY;
        D_s[tid] = ok ? Dg[row0 + q0 + tid] : 0.0f;
      }
      __syncthreads();

      // score tile: rows = queries ty * 4 + i, columns = keys tx + 16 j
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
      for (int dd = 0; dd < DH; ++dd) {
        float qa[4], da[4], kk[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = qs[(ty * 4 + i) * LD + dd];
          da[i] = dos[(ty * 4 + i) * LD + dd];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kk[j] = ks[(tx + 16 * j) * LD + dd];
          vv[j] = vs[(tx + 16 * j) * LD + dd];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(qa[i], kk[j], sc[i][j]);
            dp[i][j] = fmaf(da[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = visible(q0 + r, k0 + c, S, Tk, causal, window)
                              ? expf(sc[i][j] * scale - lse_s[r])
                              : 0.0f;
          ps[r * (kTile + 1) + c] = p;
          dss[r * (kTile + 1) + c] = p * (dp[i][j] - D_s[r]);
        }
      }
      __syncthreads();

      // dv_j += sum_i P_ij dO_i and dk_j += sum_i dS_ij q_i: this thread's
      // keys ty * 4 + i, columns tx + 16 c
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float dov[kCols], qv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dov[c] = dos[r * LD + tx + 16 * c];
          qv[c] = qs[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = ps[r * (kTile + 1) + ty * 4 + i];
          const float s = dss[r * (kTile + 1) + ty * 4 + i];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            dva[i][c] = fmaf(p, dov[c], dva[i][c]);
            dka[i][c] = fmaf(s, qv[c], dka[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= Tk) continue;
    const size_t off = ((size_t)b * Tk * KV + (size_t)t * KV + kvh) * DH;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      from_f(dk + off + tx + 16 * c, dka[i][c] * scale);
      from_f(dv + off + tx + 16 * c, dva[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 path: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // 4 warps x 16 rows
constexpr int kPad = 8;          // bf16 pad per shared row (16 bytes)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
// (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ldmatrix lane offsets (lane = 8 * quarter + i).  "A" pattern: an A
// fragment of a row-major [rows][k] tile, or (with .trans) a B fragment of a
// row-major [k][n] tile; "B" pattern: a B fragment of a row-major [n][k]
// tile, two n8 tiles per x4.
struct Lanes {
  int a_row, a_col, b_row, b_col;
  __device__ Lanes(int lane)
      : a_row((lane & 7) + ((lane >> 3) & 1) * 8), a_col((lane >> 4) * 8),
        b_row((lane & 7) + (lane >> 4) * 8), b_col(((lane >> 3) & 1) * 8) {}
};

// acc[8][4] += A (16 rows of `a`, row-major [.][LD]) . B^T where B is 64
// rows of `b` (row-major [64][LD]), over DH: S = Q K^T-shaped products.
template <int DH, int LD>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* a,
                                        const bf16* b, const Lanes& ln) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + ln.a_row * LD + kk * 16 + ln.a_col);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bfr[4];
      ldsm_x4(bfr, b + (np * 16 + ln.b_row) * LD + kk * 16 + ln.b_col);
      mma_bf16(acc[2 * np], af, bfr[0], bfr[1]);
      mma_bf16(acc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// out[DH/8][4] += X . B where X (16 x 64) is given as packed bf16
// A-fragments xa[4][4] (four k16 steps) and B is 64 rows of `b`
// (row-major [64][LD], read with ldmatrix.trans): dQ += dS K-shaped.
template <int DH, int LD>
__device__ __forceinline__ void mma_xb(float (&out)[DH / 8][4],
                                       const uint32_t (&xa)[4][4],
                                       const bf16* b, const Lanes& ln) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t bfr[4];
      ldsm_x4_trans(bfr, b + (kk * 16 + ln.a_row) * LD + np * 16 + ln.a_col);
      mma_bf16(out[2 * np], xa[kk], bfr[0], bfr[1]);
      mma_bf16(out[2 * np + 1], xa[kk], bfr[2], bfr[3]);
    }
  }
}

// The accumulators of a 16 x 64 product as bf16 A-fragments of four k16
// steps (tiles 2kk and 2kk + 1 are columns [16kk, 16kk + 16)).
__device__ __forceinline__ void pack_a(uint32_t (&xa)[4][4],
                                       const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    xa[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    xa[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    xa[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    xa[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.0f;
}

// 64 rows [r0, r0 + 64) of a row-major operand (row r at src + r * stride,
// DH bf16 each) into dst [64][LD] with cp.async; rows at or past n_rows are
// zero-filled.
template <int DH, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t stride, int r0, int n_rows) {
  constexpr int kVecs = DH / 8;
  for (int i = threadIdx.x; i < kTile * kVecs; i += kTcThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    const bool ok = r0 + r < n_rows;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * stride + c : src,
               ok);
  }
}

template <int DH>
constexpr size_t tc_smem_bytes() {
  // six 64-row bf16 tiles, and lse / D for two stages
  return sizeof(bf16) * 6 * (size_t)kTile * (DH + kPad) +
         sizeof(float) * 4 * kTile;
}

// grid: (ceil(S / 64), B * H), query tiles in reverse; block: 4 warps.
// Fragment layout of m16n8k16 (per warp, lane = 4 * g + t): accumulator
// c0, c1 at (row g, cols 2t, 2t + 1), c2, c3 at row g + 8.
template <int DH>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ Dg,
                      bf16* __restrict__ dq, int S, int Tk, int H, int KV,
                      int causal, int window, float scale_log2) {
  constexpr int LD = DH + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* dos = qs + kTile * LD;                    // [64][LD]
  bf16* ks = dos + kTile * LD;                    // [2][64][LD]
  bf16* vs = ks + 2 * kTile * LD;                 // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(vs + 2 * kTile * LD);  // [64]
  float* D_s = lse_s + kTile;                                     // [64]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t qstride = (size_t)H * DH, kstride = (size_t)KV * DH;
  const bf16* qb = q + ((size_t)b * S * H + h) * DH;
  const bf16* dob = dout + ((size_t)b * S * H + h) * DH;
  const bf16* kb_ = k + ((size_t)b * Tk * KV + kvh) * DH;
  const bf16* vb_ = v + ((size_t)b * Tk * KV + kvh) * DH;
  const size_t row0 = (size_t)bh * S;  // (b, h) rows of lse / D

  const int q_last = min(q0 + kTile, S) - 1;
  const int hi = causal ? min(Tk, q_last + 1) : Tk;
  const int lo = window > 0 ? max(0, q0 - (window - 1)) : 0;
  const int kb0 = (lo / kTile) * kTile;
  const int n_tiles = hi > kb0 ? (hi - kb0 + kTile - 1) / kTile : 0;

  load_rows<DH, LD>(qs, qb, qstride, q0, S);
  load_rows<DH, LD>(dos, dob, qstride, q0, S);
  if (n_tiles > 0) {
    load_rows<DH, LD>(ks, kb_, kstride, kb0, Tk);
    load_rows<DH, LD>(vs, vb_, kstride, kb0, Tk);
  }
  cp_async_commit();

  // D_i = dO_i . o_i: two threads per row, 16-byte loads, then a shuffle
  {
    const int r = tid / 2, part = tid % 2;
    float acc = 0.0f;
    if (q0 + r < S) {
      const bf16* orow = o + ((size_t)b * S * H + (size_t)(q0 + r) * H + h) * DH;
      const bf16* drow = dob + (size_t)(q0 + r) * qstride;
      for (int c = part * 8; c < DH; c += 16) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          acc = fmaf(of.x, df.x, fmaf(of.y, df.y, acc));
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      D_s[r] = acc;
      // row log-sum-exp in base 2; +inf (no visible key) gives P = 0
      lse_s[r] = q0 + r < S ? lse[row0 + q0 + r] * 1.4426950408889634f
                            : INFINITY;
      if (q0 + r < S) Dg[row0 + q0 + r] = acc;
    }
  }

  const Lanes ln(lane);
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's rows
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float lse0 = 0.0f, lse1 = 0.0f, D0 = 0.0f, D1 = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kb = kb0 + it * kTile;
    if (it + 1 < n_tiles) {
      const int st = (it + 1) & 1;
      load_rows<DH, LD>(ks + st * kTile * LD, kb_, kstride, kb + kTile, Tk);
      load_rows<DH, LD>(vs + st * kTile * LD, vb_, kstride, kb + kTile, Tk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q, dO) has landed
    __syncthreads();
    if (it == 0) {
      lse0 = lse_s[r0];
      lse1 = lse_s[r1];
      D0 = D_s[r0];
      D1 = D_s[r1];
    }
    const bf16* kt = ks + (it & 1) * kTile * LD;
    const bf16* vt = vs + (it & 1) * kTile * LD;

    // P = exp2(S scale log2e - lse log2e), masked on edge tiles
    float p[8][4];
    zero(p);
    mma_abt<DH, LD>(p, qs + warp * 16 * LD, kt, ln);
    const bool edge = kb + kTile > Tk || (causal && kb + kTile - 1 > q0) ||
                      (window > 0 && q_last - kb >= window);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = exp2f(p[n][e] * scale_log2 - (e < 2 ? lse0 : lse1));
        if (edge) {
          const int qp = q0 + (e < 2 ? r0 : r1);
          const int kp = kb + n * 8 + t2 + (e & 1);
          if (kp >= Tk || (causal && qp < kp) ||
              (window > 0 && qp - kp >= window))
            x = 0.0f;
        }
        p[n][e] = x;
      }
    }
    // dS = P (dP - D), dP = dO V^T
    float ds[8][4];
    zero(ds);
    mma_abt<DH, LD>(ds, dos + warp * 16 * LD, vt, ln);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = p[n][e] * (ds[n][e] - (e < 2 ? D0 : D1));
    }
    uint32_t dsa[4][4];
    pack_a(dsa, ds);
    mma_xb<DH, LD>(acc, dsa, kt, ln);  // dQ += dS K
    __syncthreads();  // this stage is free for the load two tiles ahead
  }
  cp_async_wait<0>();

  // dq = scale * acc (scale_log2 / log2e is the natural scale)
  const float scale = scale_log2 * 0.6931471805599453f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = q0 + (half ? r1 : r0);
    if (s >= S) continue;
    bf16* row = dq + ((size_t)b * S * H + (size_t)s * H + h) * DH + t2;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
  }
}

// grid: (ceil(T / 64), B * KV); block: 4 warps, warp w owning keys
// [k0 + 16 w, k0 + 16 w + 16).
template <int DH>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ Dg, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int S, int Tk, int H, int KV,
                       int causal, int window, float scale_log2) {
  constexpr int LD = DH + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* vs = ks + kTile * LD;                     // [64][LD]
  bf16* qs = vs + kTile * LD;                     // [2][64][LD]
  bf16* dos = qs + 2 * kTile * LD;                // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTile * LD);  // [2][64]
  float* D_s = lse_s + 2 * kTile;                                 // [2][64]

  const int G = H / KV;
  const int bkv = blockIdx.y, b = bkv / KV, kvh = bkv % KV;
  const int k0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t qstride = (size_t)H * DH, kstride = (size_t)KV * DH;

  // Query rows that can see a key of this tile, and the tiles per head.
  const int k_last = min(k0 + kTile, Tk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k_last + window) : S;
  const int qt0 = (q_lo / kTile) * kTile;
  const int per_head = q_hi > qt0 ? (q_hi - qt0 + kTile - 1) / kTile : 0;
  const int n_iter = G * per_head;

  // stage the query tile of iteration `it` (head kvh * G + it / per_head)
  auto load_q = [&](int it, int st) {
    const int h = kvh * G + it / per_head;
    const int q0 = qt0 + (it % per_head) * kTile;
    const size_t off = ((size_t)b * S * H + h) * DH;
    load_rows<DH, LD>(qs + st * kTile * LD, q + off, qstride, q0, S);
    load_rows<DH, LD>(dos + st * kTile * LD, dout + off, qstride, q0, S);
    if (tid < kTile) {
      const size_t row = ((size_t)b * H + h) * S + q0 + tid;
      const bool ok = q0 + tid < S;
      cp_async4(lse_s + st * kTile + tid, ok ? lse + row : lse, ok);
      cp_async4(D_s + st * kTile + tid, ok ? Dg + row : Dg, ok);
    }
  };
  load_rows<DH, LD>(ks, k + ((size_t)b * Tk * KV + kvh) * DH, kstride, k0, Tk);
  load_rows<DH, LD>(vs, v + ((size_t)b * Tk * KV + kvh) * DH, kstride, k0, Tk);
  if (n_iter > 0) load_q(0, 0);
  cp_async_commit();

  const Lanes ln(lane);
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;  // this thread's keys
  float dka[DH / 8][4], dva[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  for (int it = 0; it < n_iter; ++it) {
    const int q0 = qt0 + (it % per_head) * kTile;
    const int st = it & 1;
    if (it + 1 < n_iter) load_q(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) has landed
    __syncthreads();
    const bf16* qt = qs + st * kTile * LD;
    const bf16* dot = dos + st * kTile * LD;
    const float* lt = lse_s + st * kTile;
    const float* Dt = D_s + st * kTile;

    // P^T = exp2(S^T scale log2e - lse log2e), S^T = K Q^T (keys as rows)
    float p[8][4];
    zero(p);
    mma_abt<DH, LD>(p, ks + warp * 16 * LD, qt, ln);
    const bool edge = q0 + kTile > S || (causal && k0 + kTile - 1 > q0) ||
                      (window > 0 && q0 + kTile - 1 - k0 >= window);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + t2 + (e & 1);
        float x = exp2f(p[n][e] * scale_log2 - lt[c] * 1.4426950408889634f);
        if (edge) {
          const int qp = q0 + c, kp = e < 2 ? kr0 : kr1;
          if (qp >= S || (causal && qp < kp) ||
              (window > 0 && qp - kp >= window))
            x = 0.0f;
        }
        p[n][e] = x;
      }
    }
    // dS^T = P^T (dP^T - D), dP^T = V dO^T
    float ds[8][4];
    zero(ds);
    mma_abt<DH, LD>(ds, vs + warp * 16 * LD, dot, ln);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] = p[n][e] * (ds[n][e] - Dt[n * 8 + t2 + (e & 1)]);
    }
    uint32_t xa[4][4];
    pack_a(xa, p);
    mma_xb<DH, LD>(dva, xa, dot, ln);  // dV += P^T dO
    pack_a(xa, ds);
    mma_xb<DH, LD>(dka, xa, qt, ln);   // dK += dS^T Q
    __syncthreads();  // this stage is free for the load two tiles ahead
  }
  cp_async_wait<0>();

  const float scale = scale_log2 * 0.6931471805599453f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = half ? kr1 : kr0;
    if (t >= Tk) continue;
    const size_t off = ((size_t)b * Tk * KV + (size_t)t * KV + kvh) * DH + t2;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(dka[n][2 * half] * scale,
                                dka[n][2 * half + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(dva[n][2 * half], dva[n][2 * half + 1]);
    }
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* D, void* dq,
               void* dk, void* dv, int B, int S, int Tk, int H, int KV,
               int causal, int window, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)DH);
  constexpr size_t smem_q = dq_smem_bytes<DH>(), smem_kv = dkv_smem_bytes<DH>();
  auto kq = attn_bwd_dq_kernel<float, DH>;
  auto kkv = attn_bwd_dkv_kernel<float, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (S + kTile - 1) / kTile;
  const int k_tiles = (Tk + kTile - 1) / kTile;
  kq<<<dim3(q_tiles, B * H), kThreads, smem_q, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, D, static_cast<float*>(dq), S,
      Tk, H, KV, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3(k_tiles, B * KV), kThreads, smem_kv, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, D,
      static_cast<float*>(dk), static_cast<float*>(dv), S, Tk, H, KV, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* D, void* dq,
                void* dk, void* dv, int B, int S, int Tk, int H, int KV,
                int causal, int window, cudaStream_t stream) {
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)DH);
  constexpr size_t smem = tc_smem_bytes<DH>();
  auto kq = attn_bwd_dq_tc_kernel<DH>;
  auto kkv = attn_bwd_dkv_tc_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (S + kTile - 1) / kTile;
  const int k_tiles = (Tk + kTile - 1) / kTile;
  kq<<<dim3(q_tiles, B * H), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, D, static_cast<bf16*>(dq), S, Tk,
      H, KV, causal, window, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3(k_tiles, B * KV), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, D,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Tk, H, KV, causal,
      window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  q/o/dout/dq
// (B, S, H, dh), k/v/dk/dv (B, T, KV, dh), all contiguous in one type (and
// 16-byte aligned for bf16); lse (B, H, S) fp32 from the forward; D: B * H
// * S floats of scratch (allocated by the caller).  Two launches on
// `stream` (dq and D, then dk/dv).  Returns cudaGetLastError().
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* D, void* dq, void* dk, void* dv,
    int B, int S, int Tk, int H, int KV, int dh, int causal, int window,
    int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > kMaxGroup || (dtype != 0 && dtype != 1) || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
#define FA_BWD_CASE(DH)                                                      \
  case DH:                                                                   \
    return dtype == 0                                                        \
        ? launch_f32<DH>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, Tk, H,    \
                         KV, causal, window, s)                              \
        : launch_bf16<DH>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, Tk, H,   \
                          KV, causal, window, s);
  switch (dh) {
    FA_HEAD_DIMS(FA_BWD_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_BWD_CASE
}
