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
//   fp32 and bf16 inputs, fp32 arithmetic throughout, results in the
//   input's type.  Head dims: every multiple of 16 up to 128, G = H / KV up
//   to 64, as the forward takes.
//
// What bounds it on the H100: operations.  It recomputes S in both kernels
//   and dP in both, so it does 7 products of the forward's 2 (3.5x the
//   forward's FLOPs); granite's training shape (B 4, S 1024, H 16, dh 64,
//   causal) is 30 GFLOP against 50 MB of traffic.
//
// Design: two kernels, no atomics, so every call gives the same bits.
//   1. dq (grid: query tiles x B * H, the long causal tiles first): one
//      block owns 64 query rows of one head.  Its prologue forms D for
//      those rows (and writes it for kernel 2), then it walks the key tiles
//      [lo, hi) that meet the triangle or band, as the forward does, and
//      accumulates dq in registers.
//   2. dk/dv (grid: key tiles x B * KV): one block owns 64 keys of one kv
//      head and walks the query tiles of all G heads of its group over the
//      rows that can see those keys (causal: from the tile's first key;
//      window: up to its last key + window), accumulating dk and dv in
//      registers; the G-head sum of GQA stays inside the block.
//   Both run on the CUDA cores: 256 threads as 16 x 16, each a 4 x 4 tile
//   of the 64 x 64 score block and a 4 x dh/16 tile of the result; q, dO,
//   k and v tiles are fp32 in shared memory with rows padded by one float
//   (conflict-free column reads); P and dS go through shared memory.  A
//   tensor-core (mma.sync / wgmma) version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define FA_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxGroup = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

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

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* D, void* dq, void* dk,
           void* dv, int B, int S, int Tk, int H, int KV, int causal,
           int window, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)DH);
  constexpr size_t smem_q = dq_smem_bytes<DH>(), smem_kv = dkv_smem_bytes<DH>();
  auto kq = attn_bwd_dq_kernel<T, DH>;
  auto kkv = attn_bwd_dkv_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (S + kTile - 1) / kTile;
  const int k_tiles = (Tk + kTile - 1) / kTile;
  if (B * H > 65535) return (int)cudaErrorInvalidValue;
  kq<<<dim3(q_tiles, B * H), kThreads, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, D, static_cast<T*>(dq), S, Tk, H, KV,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3(k_tiles, B * KV), kThreads, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, D,
      static_cast<T*>(dk), static_cast<T*>(dv), S, Tk, H, KV, causal, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/o/dout/dq (B, S, H, dh), k/v/dk/dv
// (B, T, KV, dh), all contiguous in one type; lse (B, H, S) fp32 from the
// forward; D: B * H * S floats of scratch (allocated by the caller).  Two
// launches on `stream` (dq and D, then dk/dv).  Returns cudaGetLastError().
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* D, void* dq, void* dk, void* dv,
    int B, int S, int Tk, int H, int KV, int dh, int causal, int window,
    int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > kMaxGroup || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
#define FA_BWD_CASE(DH)                                                      \
  case DH:                                                                   \
    return dtype == 0                                                        \
        ? launch<float, DH>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, Tk, H, \
                            KV, causal, window, s)                           \
        : launch<bf16, DH>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, Tk, H,  \
                           KV, causal, window, s);
  switch (dh) {
    FA_HEAD_DIMS(FA_BWD_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_BWD_CASE
}
