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
