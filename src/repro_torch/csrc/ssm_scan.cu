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
//   8192; 0.160 ms).  Design:
//   * four passes over device memory at the chunk lengths the model
//     launches (L <= kBwdSeg = 256): dA and dBx are read once and d_dA
//     and d_dBx written once; the states never leave the chip.  A block
//     keeps, for its channels and the whole chunk, dA and h in shared
//     memory (one 128-byte row per step and tensor: 64 KB at L 256, so
//     three blocks share an SM).  TMA fills it with dA and dBx in boxes of
//     32 steps x 32 floats (a (B, L, Di * N) tensor map, zeros past Di and
//     L), one mbarrier per box of rows, so the bytes are in flight without
//     threads to issue them.  (One bulk copy per 128-byte row was tried
//     first: the copy engine's per-copy cost, ~40 ns, bound the kernel at
//     ~0.25 ms for hymba.)  The forward sweep overwrites dBx with h_t in
//     place, starting on the first rows while the later ones arrive.  Only
//     the loads name dA and dBx: fusing the discretisation changes them
//     alone;
//   * one warp per block, one state lane per thread: 32 / N channels, so
//     B 1 at hymba's Di 3200 launches 1600 blocks (falcon's 8192: 4096);
//   * dy of the chunk (small) is loaded into registers spread over the
//     lanes before the forward sweep, so its latency hides behind the
//     sweep, and reaches each step by a shuffle; C (16 KB, read by every
//     block) comes through L1 one 32-step window ahead.  The reverse walk
//     reads dA and h in batches of 8 steps before any of the batch's
//     shared stores and runs each batch without a branch, so that one
//     step's shuffles and stores overlap the next steps; it stores d_dA_t
//     and d_dBx_t as coalesced 128-byte rows;
//   * L > kBwdSeg (no model path launches it): segment checkpoints.  A
//     first sweep over the segments parks the state at each later
//     segment's start in the lane's own word of d_dA there; then each
//     segment, from the last, is loaded again, swept and walked back.  dA
//     and dBx are read twice, d_dA is written once more per segment;
//   * dC sums over Di across blocks with no atomics: the warp sums its
//     channels by shuffles into the rows of dA it has finished; the 8
//     blocks of a thread-block cluster then sum their rows in rank order
//     through distributed shared memory into one partial per cluster
//     (clusters, B, L, N), and a second small kernel sums those in a
//     fixed order, so every call gives the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;   // steps of C staged in shared memory at a time
constexpr int kUnroll = 8;  // steps whose loads are issued together
// The backward: steps of a chunk kept on chip at once, blocks whose dC
// partials one cluster sums, rows per load barrier and reverse window.
constexpr int kBwdSeg = 256, kBwdCluster = 8, kBwdRows = 32;

// *p = v where pred holds: a predicated store, never a branch, so that the
// steps of an unrolled batch stay in one basic block.
__device__ __forceinline__ void store_if(bool pred, float* p, float v) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q st.global.f32 [%0], %1;\n}\n"
      :: "l"(p), "f"(v), "r"((int)pred));
}

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

// grid: (bwd_blocks(Di, N), B) in clusters of kBwdCluster along x; block:
// one warp, lane = (channel c, state n), 32 / N channels.  Shared memory:
// dA and h (dBx until the sweep overwrites it) of min(L, kBwdSeg) steps
// rounded up to whole kBwdRows boxes, one 128-byte row per step, then one
// load mbarrier per box of rows.  map_dA / map_dBx: (B, L, Di * N) fp32
// tensor maps with 32 x kBwdRows boxes.
template <int N>
__global__ void __cluster_dims__(kBwdCluster, 1, 1) __launch_bounds__(32)
ssm_scan_bwd_kernel(const __grid_constant__ CUtensorMap map_dA,
                    const __grid_constant__ CUtensorMap map_dBx,
                    const float* __restrict__ C, const float* h0,
                    const float* __restrict__ dy, const float* dh_last,
                    float* d_dA, float* __restrict__ d_dBx, float* dh0,
                    float* __restrict__ part, int L, int Di) {
  constexpr int kCpb = 32 / N;  // channels per block
  constexpr int W = kBwdRows;   // steps per box (and per reverse window)
  extern __shared__ __align__(128) float sm[];
  cg::cluster_group cluster = cg::this_cluster();

  const int b = blockIdx.y, lane = threadIdx.x;
  const int c = lane / N, n = lane % N;
  const int d0 = blockIdx.x * kCpb;
  const int nch = max(0, min(kCpb, Di - d0));  // 0: a cluster's padding
  const bool live = c < nch;
  const int d = d0 + (live ? c : 0);
  const int rows = (min(L, kBwdSeg) + W - 1) / W * W;
  float* sA = sm;
  float* sH = sA + rows * 32;
  const uint32_t bar0 = tma::smem_u32(sH + rows * 32);
  const size_t step = (size_t)Di * N;  // floats per time step
  const size_t own = (size_t)b * L * step + (size_t)d * N + n;  // t = 0
  const size_t hidx = ((size_t)b * Di + d) * N + n;

  if (lane == 0) {
    for (int i = 0; i < rows / W; ++i) tma::mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  uint32_t parity = 0;  // bit i: the parity of load barrier i's next phase

  // Steps [t0, t0 + nt) of dA into sA and of dBx into sH: one box of W
  // steps x 32 floats (this block's channels) per barrier and tensor,
  // zeros past Di and L.
  auto load = [&](int t0, int nt) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0)
      for (int i = 0; i * W < nt; ++i) {
        const uint32_t bar = bar0 + 8 * i;
        tma::mbar_expect_tx(bar, 2 * W * 32 * 4);
        tma::load_3d(tma::smem_u32(sA + i * W * 32), &map_dA, bar, d0 * N,
                     t0 + i * W, b);
        tma::load_3d(tma::smem_u32(sH + i * W * 32), &map_dBx, bar, d0 * N,
                     t0 + i * W, b);
      }
  };
  // The forward sweep over the loaded rows from state h: h_t into sH.
  // Branch-free over each box (rows past nt are computed and ignored), so
  // the steps of a batch of 8 schedule together.
  auto sweep = [&](int nt, float h) {
    for (int r0 = 0; r0 < nt; r0 += W) {
      tma::mbar_wait(bar0 + 8 * (r0 / W), (parity >> (r0 / W)) & 1u);
      parity ^= 1u << (r0 / W);
#pragma unroll
      for (int u0 = 0; u0 < W; u0 += 8) {
        float a[8], x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          a[u] = sA[(r0 + u0 + u) * 32 + lane];
          x[u] = sH[(r0 + u0 + u) * 32 + lane];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float hn = fmaf(a[u], h, x[u]);
          sH[(r0 + u0 + u) * 32 + lane] = hn;
          h = r0 + u0 + u < nt ? hn : h;
        }
      }
    }
    return h;
  };

  // Pass 1, only for L > kBwdSeg: the state at each later segment's start,
  // parked in this lane's own word of d_dA at that segment's first step
  // (which the reverse walk of that segment overwrites last).
  float hs = (live && h0 != nullptr) ? h0[hidx] : 0.0f;
  const int nseg = (L + kBwdSeg - 1) / kBwdSeg;
  for (int s = 0; s + 1 < nseg; ++s) {
    load(s * kBwdSeg, kBwdSeg);
    hs = sweep(kBwdSeg, hs);
    if (live) d_dA[own + (size_t)(s + 1) * kBwdSeg * step] = hs;
  }

  // Pass 2: segments from the last, each loaded once, swept forward, then
  // walked back with the carried state gradient g.
  float g = (live && dh_last != nullptr) ? dh_last[hidx] : 0.0f;
  for (int s = nseg - 1; s >= 0; --s) {
    const int t0 = s * kBwdSeg, nt = min(kBwdSeg, L - t0);
    float h_in = 0.0f;  // the state before step t0
    if (s == 0)
      h_in = (live && h0 != nullptr) ? h0[hidx] : 0.0f;
    else if (live)
      h_in = d_dA[own + (size_t)t0 * step];
    load(t0, nt);
    // dy of the whole segment, spread over the lanes and loaded before the
    // sweep so that its latency hides behind it: q[j][i] holds dy of this
    // lane's channel c at row (top - j) W + n + N i, j counting windows
    // down from the top one.  A step takes it from lane (c, row % N) by
    // one shuffle.  C (small, read by every block: L1 hits) is loaded one
    // W-step window ahead.
    constexpr int kQ = W / N;  // dy values per lane and window
    const int top = (nt - 1) / W;  // the last window
    const float* dyb = dy + ((size_t)b * L + t0) * Di + min(d, Di - 1);
    float q[kBwdSeg / W][kQ];
#pragma unroll
    for (int j = 0; j < kBwdSeg / W; ++j)
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        const int r = (top - j) * W + n + N * i;  // masked where used
        q[j][i] = __ldg(dyb + (size_t)min(max(r, 0), nt - 1) * Di);
      }
    sweep(nt, h_in);

    const float* cb = C + ((size_t)b * L + t0) * N + n;
    float cw[W], cn[W];
    auto fetch = [&](int w, float (&cv)[W]) {
#pragma unroll
      for (int u = 0; u < W; ++u)
        cv[u] = __ldg(cb + (size_t)min(w * W + u, nt - 1) * N);
    };
    // The walk takes a window in batches of 8 steps whose dA and h rows are
    // read before any of the batch's shared stores, and each batch is
    // branch-free (rows past nt leave g as it is, and store nothing), so
    // one step's shuffles and stores overlap the next steps.
    fetch(top, cw);
    for (int w = top; w >= 0; --w) {
      if (w > 0) fetch(w - 1, cn);
#pragma unroll
      for (int u0 = W - 8; u0 >= 0; u0 -= 8) {
        const int r0 = w * W + u0;  // rows r0 .. r0 + 7 (rows < the alloc)
        float a[8], h[9];           // h[k]: h at row r0 + k - 1
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          a[k] = sA[(r0 + k) * 32 + lane];
          h[k + 1] = sH[(r0 + k) * 32 + lane];
        }
        const float hb = sH[max(r0 - 1, 0) * 32 + lane];
        h[0] = r0 > 0 ? hb : h_in;
        const size_t o0 = own + (size_t)(t0 + r0) * step;
#pragma unroll
        for (int k = 7; k >= 0; --k) {
          const int u = u0 + k, r = r0 + k;
          const bool in = r < nt;
          const float dq = __shfl_sync(0xffffffffu, q[0][u / N],
                                       c * N + u % N);
          const float dyk = live && in ? dq : 0.0f;
          g = fmaf(dyk, cw[u], g);
          store_if(live && in, d_dBx + o0 + k * step, g);
          store_if(live && in, d_dA + o0 + k * step, g * h[k]);
          // dC partial: the block's channels' dy_t[d] h_t[d, n]
          float p = dyk * h[k + 1];
#pragma unroll
          for (int o = N; o < 32; o <<= 1)
            p += __shfl_xor_sync(0xffffffffu, p, o);
          if (lane < N) sA[r * 32 + lane] = p;  // row r's dA is read
          g = (in ? a[k] : 1.0f) * g;
        }
      }
#pragma unroll
      for (int j = 0; j + 1 < kBwdSeg / W; ++j)
#pragma unroll
        for (int i = 0; i < kQ; ++i) q[j][i] = q[j + 1][i];
#pragma unroll
      for (int u = 0; u < W; ++u) cw[u] = cn[u];
    }

    // The cluster's dC partial of this segment: block `rank` sums a share
    // of the (step, n) pairs over the cluster's blocks in rank order,
    // reading their shared memory.
    cluster.sync();
    const unsigned rank = cluster.block_rank();
    float* peer[kBwdCluster];
#pragma unroll
    for (int pr = 0; pr < kBwdCluster; ++pr)
      peer[pr] = cluster.map_shared_rank(sA, pr);
    float* pc = part + (((size_t)(blockIdx.x / kBwdCluster) * gridDim.y + b) *
                            L + t0) * N;
#pragma unroll 4
    for (int i = rank * 32 + lane; i < nt * N; i += kBwdCluster * 32) {
      const int r = i / N, k = i % N;
      float acc = 0.0f;
#pragma unroll
      for (int pr = 0; pr < kBwdCluster; ++pr) acc += peer[pr][r * 32 + k];
      pc[i] = acc;
    }
    cluster.sync();  // no block reuses its rows while a peer reads them
  }
  if (live && dh0 != nullptr) dh0[hidx] = g;
}

// dC[i] = sum over the clusters' partials part[k][i] (i < n = B*L*N), in
// a fixed order: 8 lanes per output each add a contiguous eighth of the
// partials in order, then the eighths are added by a fixed shuffle tree.
// block: 256 threads, 32 outputs.
__global__ void ssm_scan_dc_kernel(const float* __restrict__ part,
                                   float* __restrict__ dC, int parts,
                                   size_t n) {
  const size_t i = (size_t)blockIdx.x * 32 + threadIdx.x / 8;
  const int slice = threadIdx.x % 8;
  const int k0 = parts * slice / 8, k1 = parts * (slice + 1) / 8;
  float s = 0.0f;
  if (i < n)
    for (int k = k0; k < k1; ++k) s += part[(size_t)k * n + i];
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (i < n && slice == 0) dC[i] = s;
}

// Blocks along x: the 32 / N-channel groups, padded to whole clusters.
int bwd_blocks(int Di, int N) {
  const int groups = (Di + 32 / N - 1) / (32 / N);
  return (groups + kBwdCluster - 1) / kBwdCluster * kBwdCluster;
}

template <int N>
int launch_bwd(const void* dA, const void* dBx, const void* C, const void* h0,
               const void* dy, const void* dh_last, void* d_dA, void* d_dBx,
               void* dC, void* dh0, void* part, int B, int L, int Di,
               cudaStream_t stream) {
  const int blocks = bwd_blocks(Di, N);
  const int rows = ((L < kBwdSeg ? L : kBwdSeg) + kBwdRows - 1) / kBwdRows *
                   kBwdRows;
  const size_t smem = (size_t)rows * 32 * 4 * 2 +
                      8 * (size_t)(rows / kBwdRows);
  CUtensorMap map_dA, map_dBx;
  if (!tma::make_3d(&map_dA, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dA,
                    (uint64_t)Di * N, L, B, 32, kBwdRows,
                    CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tma::make_3d(&map_dBx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dBx,
                    (uint64_t)Di * N, L, B, 32, kBwdRows,
                    CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  auto kern = ssm_scan_bwd_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(blocks, B), 32, smem, stream>>>(
      map_dA, map_dBx, static_cast<const float*>(C),
      static_cast<const float*>(h0), static_cast<const float*>(dy),
      static_cast<const float*>(dh_last), static_cast<float*>(d_dA),
      static_cast<float*>(d_dBx), static_cast<float*>(dh0),
      static_cast<float*>(part), L, Di);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * L * N;
  ssm_scan_dc_kernel<<<(unsigned)((n + 31) / 32), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dC),
      blocks / kBwdCluster, n);
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
// dh_last null = zero.  part: scratch of bwd_blocks(Di, N) / kBwdCluster *
// B * L * N floats (the per-cluster dC partials; ssm_scan.py `bwd_plan`).
// Two launches on `stream`.  Returns cudaGetLastError().
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
