// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel
//   src/repro/kernels/ssm_scan/ssm_scan.py (`ssm_scan`, body `_ssm_kernel`):
//   dA/dBx (B, L, Di, N) fp32, C (B, L, N) fp32 -> y (B, L, Di) fp32 with
//   h_t = dA_t * h_{t-1} + dBx_t and y_t[d] = sum_n h_t[d, n] * C_t[n].  The
//   Pallas kernel walks L in chunks along an ordered ("arbitrary") grid axis
//   and carries the (block_d, N) state in VMEM scratch, zeroed at chunk 0.
//   Here the state may also start from h0 (B, Di, N) and the last state is
//   written to h_out (B, Di, N), so a caller can chain launches over L.
//
// What bounds it on the H100: bytes.  Each step reads 2 * N fp32 of dA/dBx
//   per channel and does 4 * N flops on them: at falcon-mamba-7b's
//   per-chunk launch (B = 1, L = 256, Di = 8192, N = 16) that is 0.28 GB,
//   about 0.08 ms at 3.35 TB/s, against 0.13 GFLOP (2 us at 67 TFLOP/s).
//
// What this design does about it (a first version: right, simple):
//   * a CUDA grid has no ordered axis, so the chunk walk moves inside the
//     kernel: one block owns (b, a range of channels) and walks all of L
//     with the state in registers; nothing is carried between blocks;
//   * N / 4 threads per channel, each holding 4 of its N states, so every
//     thread reads dA and dBx as one 16-byte load per step and a warp reads
//     512 contiguous bytes; y is summed over the N / 4 lanes with
//     __shfl_xor_sync.  At N = 16 this is 32 channels per 128-thread block,
//     256 blocks for B = 1, Di = 8192 (one thread per channel would give 64);
//   * the loads of kUnroll steps are issued before any of them is used, to
//     keep enough bytes in flight; C for a tile of kTile steps is staged in
//     shared memory and read there as a broadcast;
//   * ragged Di is masked (no divisibility needed: hymba-1.5b has Di = 3200).
//   cp.async / TMA pipelining and fusing the discretisation (reading dt, x,
//   B and A instead of the 2 * N times larger dA / dBx) are later work.
//
// Backward (ssm_scan_bwd_launch): the gradient the JAX package takes
//   through its XLA scan (src/repro/models/ssm.py `ssm_scan_chunked`,
//   jax.grad).  From dy = dL/dy (B, L, Di) and dh_last = dL/dh_last
//   (B, Di, N) or null, with the carried state gradient
//     g_{L-1} = dh_last + dy_{L-1}[d] C_{L-1}[n],
//     g_t     = dy_t[d] C_t[n] + dA_{t+1} * g_{t+1},
//   it writes d_dBx_t = g_t, d_dA_t = g_t * h_{t-1} (h_{-1} = h0, or 0),
//   dC_t[n] = sum_d dy_t[d] h_t[d, n] and dh0 = dA_0 * g_0.
//   Bound: bytes.  dA and dBx in, d_dA and d_dBx out: four (B, L, Di, N)
//   fp32 tensors, 0.21 GB at hymba-1.5b's chunk (B 1, L 256, Di 3200,
//   N 16; 0.063 ms at 3.35 TB/s) and 0.54 GB at falcon-mamba-7b's (Di
//   8192; 0.160 ms).  Design (simple and right first):
//   * the forward's layout: one block owns (b, a range of channels) and
//     walks all of L; N / 4 lanes per channel, 4 states each;
//   * the states h_t are recomputed by a forward sweep inside the launch
//     and parked in the d_dA output (each thread reads back only what it
//     wrote itself), then the reverse walk reads h_{t-1} there, keeps g
//     and h_t in registers, and overwrites the slot with d_dA_t.  h_t is
//     never divided out of h_{t+1}: dA underflows to 0.  The sweep costs
//     one extra write and read of a (B, L, Di, N) tensor (7 passes in all
//     where 4 are needed); keeping the states on chip is later work;
//   * dC sums over Di, across blocks, with no atomics: the block reduces
//     its channels (warp shuffles, then shared memory over its warps)
//     into a per-block partial (blocks, B, L, N), which a second small
//     kernel sums in a fixed order, so every call gives the same bits.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;   // steps of C staged in shared memory at a time
constexpr int kUnroll = 8;  // steps whose loads are issued together

__device__ __forceinline__ float4 fma4(float4 a, float4 h, float4 x) {
  return make_float4(fmaf(a.x, h.x, x.x), fmaf(a.y, h.y, x.y),
                     fmaf(a.z, h.z, x.z), fmaf(a.w, h.w, x.w));
}

// grid: (ceil(Di / channels per block), B); block: kThreads.
template <int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float4* __restrict__ dA, const float4* __restrict__ dBx,
                const float4* __restrict__ C, const float4* h0,
                float* __restrict__ y, float4* h_out, int L, int Di) {
  constexpr int kTpc = N / 4;            // threads per channel
  constexpr int kCpb = kThreads / kTpc;  // channels per block
  __shared__ float4 cs[kTile * kTpc];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int sub = tid % kTpc;
  const int d = blockIdx.x * kCpb + tid / kTpc;
  const bool live = d < Di;
  const size_t step = (size_t)Di * kTpc;  // float4s per time step
  const size_t base = (size_t)b * L * step + (size_t)(live ? d : 0) * kTpc + sub;
  const size_t hidx = ((size_t)b * Di + (live ? d : 0)) * kTpc + sub;

  float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live && h0 != nullptr) h = h0[hidx];

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int nt = min(kTile, L - t0);
    __syncthreads();  // the previous tile of C is consumed
    const float4* ct = C + ((size_t)b * L + t0) * kTpc;
    for (int i = tid; i < nt * kTpc; i += kThreads) cs[i] = ct[i];
    __syncthreads();

    for (int tt = 0; tt < nt; tt += kUnroll) {
      float4 a[kUnroll], x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        a[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        x[u] = a[u];
        if (live && tt + u < nt) {
          const size_t off = base + (size_t)(t0 + tt + u) * step;
          a[u] = __ldg(dA + off);
          x[u] = __ldg(dBx + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (tt + u < nt) {  // uniform over the block: every lane shuffles
          h = fma4(a[u], h, x[u]);
          const float4 c = cs[(tt + u) * kTpc + sub];
          float p = h.x * c.x + h.y * c.y + h.z * c.z + h.w * c.w;
#pragma unroll
          for (int o = kTpc / 2; o > 0; o >>= 1)
            p += __shfl_xor_sync(0xffffffffu, p, o);
          if (live && sub == 0) y[((size_t)b * L + t0 + tt + u) * Di + d] = p;
        }
      }
    }
  }
  if (live) h_out[hidx] = h;
}

template <int N>
int launch(const void* dA, const void* dBx, const void* C, const void* h0,
           void* y, void* h_out, int B, int L, int Di, cudaStream_t stream) {
  constexpr int kCpb = kThreads / (N / 4);
  const dim3 grid((Di + kCpb - 1) / kCpb, B);
  ssm_scan_kernel<N><<<grid, kThreads, 0, stream>>>(
      static_cast<const float4*>(dA), static_cast<const float4*>(dBx),
      static_cast<const float4*>(C), static_cast<const float4*>(h0),
      static_cast<float*>(y), static_cast<float4*>(h_out), L, Di);
  return (int)cudaGetLastError();
}

// grid: (ceil(Di / channels per block), B); block: kThreads.  d_dA holds
// the recomputed states until the reverse walk overwrites them.
template <int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const float4* __restrict__ dA,
                    const float4* __restrict__ dBx,
                    const float4* __restrict__ C, const float4* h0,
                    const float* __restrict__ dy, const float4* dh_last,
                    float4* d_dA, float4* __restrict__ d_dBx, float4* dh0,
                    float* __restrict__ part, int L, int Di) {
  constexpr int kTpc = N / 4;            // threads per channel
  constexpr int kCpb = kThreads / kTpc;  // channels per block
  constexpr int kWarps = kThreads / 32;
  __shared__ float4 cs[kTile * kTpc];
  __shared__ float4 dcs[kWarps][kTile * kTpc];  // per-warp dC of a tile

  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = tid % kTpc;
  const int d = blockIdx.x * kCpb + tid / kTpc;
  const bool live = d < Di;
  const size_t step = (size_t)Di * kTpc;  // float4s per time step
  const size_t base = (size_t)b * L * step + (size_t)(live ? d : 0) * kTpc + sub;
  const size_t hidx = ((size_t)b * Di + (live ? d : 0)) * kTpc + sub;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // 1. forward sweep: h_t into d_dA's slot t
  float4 h0v = zero;
  if (live && h0 != nullptr) h0v = h0[hidx];
  float4 h = h0v;
  if (live) {
    for (int t0 = 0; t0 < L; t0 += kUnroll) {
      float4 a[kUnroll], x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        a[u] = zero;
        x[u] = zero;
        if (t0 + u < L) {
          const size_t off = base + (size_t)(t0 + u) * step;
          a[u] = __ldg(dA + off);
          x[u] = __ldg(dBx + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t0 + u < L) {
          h = fma4(a[u], h, x[u]);
          d_dA[base + (size_t)(t0 + u) * step] = h;
        }
      }
    }
  }

  // 2. reverse walk, in tiles of kTile steps from the end
  float4 g = zero;
  if (live && dh_last != nullptr) g = dh_last[hidx];
  const int n_tiles = (L + kTile - 1) / kTile;
  for (int ti = n_tiles - 1; ti >= 0; --ti) {
    const int t0 = ti * kTile;
    const int nt = min(kTile, L - t0);
    __syncthreads();  // the previous tile's C and dC partials are consumed
    const float4* ct = C + ((size_t)b * L + t0) * kTpc;
    for (int i = tid; i < nt * kTpc; i += kThreads) cs[i] = ct[i];
    __syncthreads();

    for (int tt = nt - 1; tt >= 0; tt -= kUnroll) {
      // steps tt, tt - 1, ..., tt - kUnroll + 1 of this tile
      float4 a[kUnroll], hp[kUnroll];
      float dyv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + tt - u;
        a[u] = zero;
        hp[u] = h0v;
        dyv[u] = 0.0f;
        if (live && tt - u >= 0) {
          const size_t off = base + (size_t)t * step;
          a[u] = __ldg(dA + off);
          if (t > 0) hp[u] = d_dA[off - step];  // h_{t-1}, own write
          dyv[u] = __ldg(dy + ((size_t)b * L + t) * Di + d);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (tt - u >= 0) {  // uniform over the block: every lane shuffles
          const int t = t0 + tt - u;
          const float4 c = cs[(tt - u) * kTpc + sub];
          // dC partial: dy_t[d] * h_t[d, n], h_t = h (held from the last
          // step, or the sweep's final state)
          float4 p = make_float4(dyv[u] * h.x, dyv[u] * h.y, dyv[u] * h.z,
                                 dyv[u] * h.w);
          if (!live) p = zero;
#pragma unroll
          for (int o = kTpc; o < 32; o <<= 1) {
            p.x += __shfl_xor_sync(0xffffffffu, p.x, o);
            p.y += __shfl_xor_sync(0xffffffffu, p.y, o);
            p.z += __shfl_xor_sync(0xffffffffu, p.z, o);
            p.w += __shfl_xor_sync(0xffffffffu, p.w, o);
          }
          if (lane < kTpc) dcs[warp][(tt - u) * kTpc + lane] = p;
          g = make_float4(fmaf(dyv[u], c.x, g.x), fmaf(dyv[u], c.y, g.y),
                          fmaf(dyv[u], c.z, g.z), fmaf(dyv[u], c.w, g.w));
          if (live) {
            const size_t off = base + (size_t)t * step;
            d_dBx[off] = g;
            d_dA[off] = make_float4(g.x * hp[u].x, g.y * hp[u].y,
                                    g.z * hp[u].z, g.w * hp[u].w);
          }
          g = make_float4(a[u].x * g.x, a[u].y * g.y, a[u].z * g.z,
                          a[u].w * g.w);
          h = hp[u];
        }
      }
    }
    __syncthreads();
    // the block's dC partial of this tile: the warps summed in order
    const float4* dflat = &dcs[0][0];
    float4* pt = reinterpret_cast<float4*>(part) +
                 (((size_t)blockIdx.x * gridDim.y + b) * L + t0) * kTpc;
    for (int i = tid; i < nt * kTpc; i += kThreads) {
      float4 s = dflat[i];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float4 v = dflat[w * kTile * kTpc + i];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      pt[i] = s;
    }
  }
  if (live && dh0 != nullptr) dh0[hidx] = g;
}

// dC[i] = sum over blocks of part[blk][i], blocks in order; i < n = B*L*N.
__global__ void ssm_scan_dc_kernel(const float* __restrict__ part,
                                   float* __restrict__ dC, int blocks,
                                   size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < blocks; ++k) s += part[(size_t)k * n + i];
  dC[i] = s;
}

template <int N>
int launch_bwd(const void* dA, const void* dBx, const void* C, const void* h0,
               const void* dy, const void* dh_last, void* d_dA, void* d_dBx,
               void* dC, void* dh0, void* part, int B, int L, int Di,
               cudaStream_t stream) {
  constexpr int kCpb = kThreads / (N / 4);
  const int blocks = (Di + kCpb - 1) / kCpb;
  ssm_scan_bwd_kernel<N><<<dim3(blocks, B), kThreads, 0, stream>>>(
      static_cast<const float4*>(dA), static_cast<const float4*>(dBx),
      static_cast<const float4*>(C), static_cast<const float4*>(h0),
      static_cast<const float*>(dy), static_cast<const float4*>(dh_last),
      static_cast<float4*>(d_dA), static_cast<float4*>(d_dBx),
      static_cast<float4*>(dh0), static_cast<float*>(part), L, Di);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * L * N;
  ssm_scan_dc_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dC), blocks, n);
  return (int)cudaGetLastError();
}

}  // namespace

// All fp32, contiguous, 16-byte aligned: dA/dBx (B, L, Di, N), C (B, L, N),
// y (B, L, Di), h0/h_out (B, Di, N).  h0 may be null (zero state); h_out
// receives the state after step L - 1.  N is 4, 8 or 16.  Returns
// cudaGetLastError() after the launch.
extern "C" int ssm_scan_launch(const void* dA, const void* dBx, const void* C,
                               const void* h0, void* y, void* h_out, int B,
                               int L, int Di, int N, void* stream) {
  if (B <= 0 || L <= 0 || Di <= 0 || B > 65535 || h_out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch<4>(dA, dBx, C, h0, y, h_out, B, L, Di, s);
    case 8: return launch<8>(dA, dBx, C, h0, y, h_out, B, L, Di, s);
    case 16: return launch<16>(dA, dBx, C, h0, y, h_out, B, L, Di, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The gradient of ssm_scan_launch.  All fp32, contiguous, 16-byte aligned:
// dA/dBx/d_dA/d_dBx (B, L, Di, N), C/dC (B, L, N), dy (B, L, Di),
// h0/dh_last/dh0 (B, Di, N); h0 null = zero state (dh0 must then be null),
// dh_last null = zero.  part: scratch of ceil(Di / (128 / (N / 4))) * B *
// L * N floats (the per-block dC partials).  Two launches on `stream`.
// Returns cudaGetLastError().
extern "C" int ssm_scan_bwd_launch(const void* dA, const void* dBx,
                                   const void* C, const void* h0,
                                   const void* dy, const void* dh_last,
                                   void* d_dA, void* d_dBx, void* dC,
                                   void* dh0, void* part, int B, int L,
                                   int Di, int N, void* stream) {
  if (B <= 0 || L <= 0 || Di <= 0 || B > 65535 ||
      (h0 == nullptr) != (dh0 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSM_BWD_CASE(NS)                                                    \
  case NS:                                                                  \
    return launch_bwd<NS>(dA, dBx, C, h0, dy, dh_last, d_dA, d_dBx, dC, dh0, \
                          part, B, L, Di, s);
  switch (N) {
    SSM_BWD_CASE(4)
    SSM_BWD_CASE(8)
    SSM_BWD_CASE(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSM_BWD_CASE
}
