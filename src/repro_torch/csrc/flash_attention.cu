// Forward GQA flash attention for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py (`flash_attention`,
//   body `_attn_kernel`): q (B, S, H, dh), k/v (B, T, KV, dh), out in q's
//   type; online softmax in fp32 with scale dh^-0.5; causal mask
//   qpos >= kpos and optional window qpos - kpos < window; the KV loop of
//   each query block visits only the key blocks [lo, hi) that meet the
//   triangle / band (the DLBC "work only where it exists" bound); masked
//   probabilities are zeroed and l is clamped at 1e-30.  Positions start
//   at 0 for both streams.
//
// What bounds it on the H100: operations.  Causal attention over S = 2048
//   with H = 16, dh = 64 is 4 * H * S^2 / 2 * dh = 8.6 GFLOP (about 9 us of
//   bf16 tensor-core time) against 12.6 MB of q/k/v/out traffic (about
//   4 us), and the score matrix itself is never written.
//
// What this design does about it (a first version: right, simple, not
//   yet fast):
//   * one block per (batch * kv-head, query tile); the tile folds all G
//     query heads of its kv head into 64 rows (64 / G queries x G heads),
//     so each K/V tile is loaded once for the G heads sharing it;
//   * the KV loop runs only over key tiles [lo, hi) that meet the causal
//     triangle or the window band, as the Pallas kernel's block bound does;
//   * S = Q K^T and P V run out of shared memory as 4 x 4 register tiles
//     per thread (fp32 FMAs on the CUDA cores); the running max, sum and
//     output rows stay in registers and the (64 x 64) P tile in shared
//     memory, so no score ever reaches device memory;
//   * ragged S and T tails are masked here, so no divisibility is needed.
//   Tensor cores (mma.sync / wgmma) and TMA pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = 64;      // query rows (query x head) per block
constexpr int kBK = 64;        // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Max / sum over the 16 lanes that share a row group (lane bits 0..3).
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kRows * (DH + 1) + (size_t)kBK * (DH + 1) +
                          (size_t)kBK * DH + (size_t)kRows * (kBK + 1));
}

// grid: (ceil(S / BQ), B * KV) with BQ = kRows / G; block: 16 x 16 threads.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
            int H, int KV, int causal, int window, float sm_scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [kRows][DH + 1]
  float* ks = qs + kRows * (DH + 1);         // [kBK][DH + 1]
  float* vs = ks + kBK * (DH + 1);           // [kBK][DH]
  float* ps = vs + kBK * DH;                 // [kRows][kBK + 1]
  constexpr int kCols = DH / 16;             // output columns per thread

  const int G = H / KV;
  const int BQ = kRows / G;
  const int bkv = blockIdx.y;
  const int b = bkv / KV;
  const int kvh = bkv % KV;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  // Q tile, pre-scaled; row r = (query r / G, head kvh * G + r % G).
  for (int i = tid; i < kRows * DH; i += kThreads) {
    const int r = i / DH, dd = i % DH;
    const int qi = r / G, s = q0 + qi;
    float val = 0.0f;
    if (qi < BQ && s < S)
      val = to_f(q[(((size_t)b * S + s) * H + kvh * G + r % G) * DH + dd]) * sm_scale;
    qs[r * (DH + 1) + dd] = val;
  }

  float m[4], l[4], o[4][kCols];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
    qpos[i] = q0 + (ty * 4 + i) / G;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.0f;
  }

  // Key range [lo, hi) that meets the triangle / band of this tile.
  const int q_last = min(q0 + BQ, S) - 1;
  const int hi = causal ? min(Tk, q_last + 1) : Tk;
  const int lo = window > 0 ? max(0, q0 - (window - 1)) : 0;
  const int kb0 = (lo / kBK) * kBK;

  for (int kb = kb0; kb < hi; kb += kBK) {
    __syncthreads();  // previous tile fully consumed (and Q staged)
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int j = i / DH, dd = i % DH;
      const int t = kb + j;
      float kv_k = 0.0f, kv_v = 0.0f;
      if (t < Tk) {
        const size_t off = (((size_t)b * Tk + t) * KV + kvh) * DH + dd;
        kv_k = to_f(k[off]);
        kv_v = to_f(v[off]);
      }
      ks[j * (DH + 1) + dd] = kv_k;
      vs[j * DH + dd] = kv_v;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.0f;
#pragma unroll 8
    for (int dd = 0; dd < DH; ++dd) {
      float qa[4], kb_[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qs[(ty * 4 + i) * (DH + 1) + dd];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kb_[jj] = ks[(tx + 16 * jj) * (DH + 1) + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = fmaf(qa[i], kb_[jj], sc[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float row_max = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = kb + tx + 16 * jj;
        ok[jj] = kpos < Tk && (!causal || qpos[i] >= kpos) &&
                 (window <= 0 || qpos[i] - kpos < window);
        if (!ok[jj]) sc[i][jj] = kNegInf;
        row_max = fmaxf(row_max, sc[i][jj]);
      }
      const float m_new = fmaxf(m[i], group_max(row_max));
      float row_sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ok[jj] ? expf(sc[i][jj] - m_new) : 0.0f;
        ps[(ty * 4 + i) * (kBK + 1) + tx + 16 * jj] = p;
        row_sum += p;
      }
      const float scale = expf(m[i] - m_new);
      l[i] = l[i] * scale + group_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= scale;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[j * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * (kBK + 1) + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qi = r / G, s = q0 + qi;
    if (qi >= BQ || s >= S) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* orow = out + (((size_t)b * S + s) * H + kvh * G + r % G) * DH;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[tx + 16 * c] = from_f<T>(o[i][c] * inv);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int H, int KV, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  auto kern = attn_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int BQ = kRows / (H / KV);
  const dim3 grid((S + BQ - 1) / BQ, B * KV);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, KV, causal,
      window, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out, int B,
              int S, int Tk, int H, int KV, int dh, int causal, int window,
              cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, Tk, H, KV, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, out, B, S, Tk, H, KV, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, out, B, S, Tk, H, KV, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, out, B, S, Tk, H, KV, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out (B, S, H, dh), k/v (B, T, KV, dh),
// all contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int Tk, int H, int KV, int dh,
                                      int causal, int window, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0 || H / KV > kRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(q, k, v, out, B, S, Tk, H, KV, dh, causal, window, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, out, B, S, Tk, H, KV, dh, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
