// Grouped expert SwiGLU FFN over MoE capacity buffers, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/moe_dispatch/moe_gmm.py
//   (`moe_gmm`, body `_gmm_kernel`):
//   out[e] = (silu(buf[e] . w1[e]) * (buf[e] . w3[e])) . w2[e]
//   buf (E, C, d), w1/w3 (E, d, f), w2 (E, f, d), out (E, C, d) in buf's
//   type; inputs upcast to fp32, the down-projection accumulated in fp32
//   over f-blocks.
//
// What bounds it on the H100: bytes.  Every launch reads all E experts'
//   weights (granite-moe-1b: 3 * 32 * 1024 * 512 * 2 B = 101 MB in bf16,
//   about 30 us at 3.35 TB/s) while the capacity C is small (8 per
//   decode step, 80 per prefill round), so the tensor-core time of the
//   same work (8 GFLOP at C = 80, about 8 us) sits below the memory time.
//
// What this design does about it (a first version: right, simple, not
//   yet fast):
//   * each weight element is read from device memory by one block per
//     C-tile only, in coalesced rows; at decode there is one C-tile, so
//     the weights are read once;
//   * the (block_c x block_f) SwiGLU intermediate h never leaves the
//     chip: it is built in shared memory and consumed there by the
//     down-projection, whose fp32 sums stay in registers;
//   * at decode E * C-tiles is only 32 blocks for 132 SMs, so the f
//     range is split over gridDim.z (`f_splits`): each split writes an
//     fp32 partial and a second pass sums the splits in a fixed order
//     (deterministic, no atomics) and casts to the output type;
//   * a ragged C tile (decode capacity 8 < block_c 16, or C % 16 != 0) is
//     masked: zero rows in, no rows out.
//   Two paths, chosen here from the dtype and shapes:
//   * bf16 with d and f multiples of 64 (the serving path): tensor cores
//     through mma.sync m16n8k16 (bf16 in, fp32 accumulate).  The x tile
//     (16 x d) sits in shared memory; weights stream through it in 64 x 64
//     tiles loaded with 16-byte vector loads; ldmatrix feeds the MMAs.  h
//     is formed in fp32 and rounded to bf16 as the A operand of the
//     down-projection (the plain version keeps h in fp32; the difference
//     is far inside the bf16 tolerance).
//   * otherwise (fp32, or other shapes): fp32 FMAs on the CUDA cores,
//     which keeps fp32 results within 1e-4 of the plain version.
//   wgmma, TMA and a pipelined weight stream are later work.
//
// d > 1024 (mixtral-8x7b: d = 4096): one block holds at most 1024 output
//   columns (four per thread of 256, or sixteen 64-wide mma chunks), and
//   the x tile alone (block_c x d, 256 KB in fp32 at d = 4096) would not
//   fit in shared memory.  So the output columns are cut into
//   d_slices = ceil(d / 1024) slices on the grid, and a second pair of
//   kernels (one per path above) streams x through shared memory in
//   chunks during the first product.  Each slice recomputes its own
//   (block_c x block_f) h tile, so w1 and w3 are read once per slice: four
//   times at d = 4096 (w2 still once).  The slices of one C tile are
//   adjacent in blockIdx.x, so they run together and the repeated w1/w3
//   tiles mostly come from the L2 cache rather than device memory.  A
//   design that reads the weights once is later work.  For d <= 1024
//   nothing of this runs: the kernels above take every such launch.
//
// Limits checked here and in the Python wrapper: d_slices = ceil(d / 1024),
// block_f <= 64 and f % block_f == 0, block_c in {8, 16}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBF = 64;          // widest f-block (columns of h)
constexpr int kColsPerThread = 4;   // output columns per thread
constexpr int kMaxD = kThreads * kColsPerThread;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// grid: (ceil(C / BC), E, f_splits); block: kThreads.
// Dynamic shared memory: x tile (BC x d) and h tile (BC x kMaxBF), fp32.
template <typename T, int BC>
__global__ void __launch_bounds__(kThreads)
moe_gmm_kernel(const T* __restrict__ buf, const T* __restrict__ w1,
               const T* __restrict__ w3, const T* __restrict__ w2,
               T* __restrict__ out, float* __restrict__ partial,
               int C, int d, int f, int block_f, int f_per_split) {
  extern __shared__ float smem[];
  float* xs = smem;              // [BC][d]
  float* hs = smem + BC * d;     // [BC][kMaxBF]

  const int E = gridDim.y;
  const int e = blockIdx.y;
  const int split = blockIdx.z;
  const int c0 = blockIdx.x * BC;
  const int rows = min(BC, C - c0);
  const int tid = threadIdx.x;

  // Stage the x tile in fp32; ragged rows are zero.
  const T* xb = buf + ((size_t)e * C + c0) * d;
  for (int i = tid; i < BC * d; i += kThreads) {
    const int r = i / d;
    xs[i] = r < rows ? to_f(xb[i]) : 0.0f;
  }

  constexpr int kRowGroups = kThreads / kMaxBF;  // 4
  constexpr int kRowsPerThread = BC / kRowGroups;
  const int hj = tid % kMaxBF;
  const int hr = tid / kMaxBF;

  float acc[BC][kColsPerThread];
#pragma unroll
  for (int r = 0; r < BC; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.0f;

  const T* w1e = w1 + (size_t)e * d * f;
  const T* w3e = w3 + (size_t)e * d * f;
  const T* w2e = w2 + (size_t)e * f * d;
  const int f_lo = split * f_per_split;
  const int f_hi = f_lo + f_per_split;
  __syncthreads();

  for (int fb = f_lo; fb < f_hi; fb += block_f) {
    // h = silu(x . w1[:, fb:fb+block_f]) * (x . w3[:, fb:fb+block_f])
    if (hj < block_f) {
      float g[kRowsPerThread], u[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) { g[i] = 0.0f; u[i] = 0.0f; }
      const T* p1 = w1e + fb + hj;
      const T* p3 = w3e + fb + hj;
#pragma unroll 4
      for (int k = 0; k < d; ++k) {
        const float a = to_f(p1[(size_t)k * f]);
        const float b = to_f(p3[(size_t)k * f]);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float xv = xs[(hr + i * kRowGroups) * d + k];
          g[i] = fmaf(xv, a, g[i]);
          u[i] = fmaf(xv, b, u[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        hs[(hr + i * kRowGroups) * kMaxBF + hj] = silu(g[i]) * u[i];
    }
    __syncthreads();
    // acc += h . w2[fb:fb+block_f, :]
    for (int j = 0; j < block_f; ++j) {
      const T* p2 = w2e + (size_t)(fb + j) * d;
      float wv[kColsPerThread];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int n = tid + c * kThreads;
        wv[c] = n < d ? to_f(p2[n]) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < BC; ++r) {
        const float hv = hs[r * kMaxBF + j];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = fmaf(hv, wv[c], acc[r][c]);
      }
    }
    __syncthreads();
  }

  const size_t n_out = (size_t)E * C * d;
#pragma unroll
  for (int r = 0; r < BC; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int n = tid + c * kThreads;
      if (n >= d) continue;
      const size_t o = ((size_t)e * C + c0 + r) * d + n;
      if (partial != nullptr) {
        partial[(size_t)split * n_out + o] = acc[r][c];
      } else {
        out[o] = from_f<T>(acc[r][c]);
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
    out[i] = from_f<T>(s);
  }
}

// The second pass of a split launch, shared by every path.
template <typename T>
int finish_splits(void* scratch, void* out, int E, int C, int d, int f_splits,
                  cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || f_splits == 1) return (int)err;
  const size_t n = (size_t)E * C * d;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  split_sum_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<T*>(out), n, f_splits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 16;                     // mma M: rows of the C tile
constexpr int kTcTile = 64;                     // K / N width of a weight tile
constexpr int kTcPad = 8;                       // bf16 pad per smem row (16 B)
constexpr int kTcWS = kTcTile + kTcPad;         // weight-tile row stride
constexpr int kTcMaxChunks = kMaxD / kTcTile;   // output column chunks (d <= 1024)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
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

// A 64 x 64 bf16 tile (global rows `ld` elements apart) into shared rows of
// kTcWS: 512 16-byte vectors, two per thread.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int ld,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx >> 3, c = (idx & 7) * 8;
    *reinterpret_cast<uint4*>(dst + r * kTcWS + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
  }
}

// grid: (ceil(C / 16), E, f_splits); block: 8 warps.  Warp w owns columns
// [8w, 8w + 8) of each 64-wide h block and of each 64-wide output chunk.
// Dynamic shared memory (bf16): x [16][d + 8], w1/w3/w2 tiles [64][72],
// h [16][72].
__global__ void __launch_bounds__(kThreads)
moe_gmm_tc_kernel(const bf16* __restrict__ buf, const bf16* __restrict__ w1,
                  const bf16* __restrict__ w3, const bf16* __restrict__ w2,
                  bf16* __restrict__ out, float* __restrict__ partial, int C,
                  int d, int f, int f_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int XS = d + kTcPad;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* w1s = xs + kTcRows * XS;
  bf16* w3s = w1s + kTcTile * kTcWS;
  bf16* w2s = w3s + kTcTile * kTcWS;
  bf16* hs = w2s + kTcTile * kTcWS;

  const int E = gridDim.y;
  const int e = blockIdx.y;
  const int split = blockIdx.z;
  const int c0 = blockIdx.x * kTcRows;
  const int rows = min(kTcRows, C - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nchunks = d / kTcTile;

  // x tile; ragged rows are zero
  const bf16* xb = buf + ((size_t)e * C + c0) * d;
  const int vec_per_row = d / 8;
  for (int idx = tid; idx < kTcRows * vec_per_row; idx += kThreads) {
    const int r = idx / vec_per_row, c = (idx % vec_per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = *reinterpret_cast<const uint4*>(xb + (size_t)r * d + c);
    *reinterpret_cast<uint4*>(xs + r * XS + c) = v;
  }

  float acc[kTcMaxChunks][4];
#pragma unroll
  for (int n = 0; n < kTcMaxChunks; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;

  // per-lane ldmatrix row addresses (A: x4, B: x2.trans)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = lane & 15;
  const bf16* w1e = w1 + (size_t)e * d * f;
  const bf16* w3e = w3 + (size_t)e * d * f;
  const bf16* w2e = w2 + (size_t)e * f * d;
  const int f_lo = split * f_per_split;
  const int f_hi = f_lo + f_per_split;
  __syncthreads();

  for (int fb = f_lo; fb < f_hi; fb += kTcTile) {
    // h1 = x . w1[:, fb + 8w : +8], h3 likewise (16 x 8 per warp)
    float h1[4] = {0.0f, 0.0f, 0.0f, 0.0f}, h3[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kc = 0; kc < nchunks; ++kc) {
      load_tile(w1s, w1e + (size_t)kc * kTcTile * f + fb, f, tid);
      load_tile(w3s, w3e + (size_t)kc * kTcTile * f + fb, f, tid);
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kTcTile / 16; ++ks) {
        uint32_t a[4], b0, b1;
        ldsm_x4(a, xs + a_row * XS + kc * kTcTile + ks * 16 + a_col);
        ldsm_x2_trans(b0, b1, w1s + (ks * 16 + b_row) * kTcWS + warp * 8);
        mma_bf16(h1, a, b0, b1);
        ldsm_x2_trans(b0, b1, w3s + (ks * 16 + b_row) * kTcWS + warp * 8);
        mma_bf16(h3, a, b0, b1);
      }
      __syncthreads();
    }
    // h = silu(h1) * h3 in fp32, stored as bf16 (the down-projection's A)
    {
      const int r = lane >> 2, c = warp * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(hs + r * kTcWS + c) =
          __floats2bfloat162_rn(silu(h1[0]) * h3[0], silu(h1[1]) * h3[1]);
      *reinterpret_cast<__nv_bfloat162*>(hs + (r + 8) * kTcWS + c) =
          __floats2bfloat162_rn(silu(h1[2]) * h3[2], silu(h1[3]) * h3[3]);
    }
    __syncthreads();
    uint32_t ha[kTcTile / 16][4];
#pragma unroll
    for (int ks = 0; ks < kTcTile / 16; ++ks)
      ldsm_x4(ha[ks], hs + a_row * kTcWS + ks * 16 + a_col);
    // acc[:, chunk nc] += h . w2[fb : fb + 64, 64 nc + 8w : +8]
#pragma unroll
    for (int nc = 0; nc < kTcMaxChunks; ++nc) {
      if (nc < nchunks) {
        load_tile(w2s, w2e + (size_t)fb * d + nc * kTcTile, d, tid);
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < kTcTile / 16; ++ks) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, w2s + (ks * 16 + b_row) * kTcWS + warp * 8);
          mma_bf16(acc[nc], ha[ks], b0, b1);
        }
        __syncthreads();
      }
    }
  }

  const size_t n_out = (size_t)E * C * d;
  const int r0 = lane >> 2, cc = warp * 8 + (lane & 3) * 2;
#pragma unroll
  for (int nc = 0; nc < kTcMaxChunks; ++nc) {
    if (nc >= nchunks) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + half * 8;
      if (r >= rows) continue;
      const size_t o = ((size_t)e * C + c0 + r) * d + nc * kTcTile + cc;
      const float v0 = acc[nc][2 * half], v1 = acc[nc][2 * half + 1];
      if (partial != nullptr) {
        partial[(size_t)split * n_out + o] = v0;
        partial[(size_t)split * n_out + o + 1] = v1;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

int launch_tc(const void* buf, const void* w1, const void* w3, const void* w2,
              void* out, void* scratch, int E, int C, int d, int f,
              int f_splits, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) *
      ((size_t)kTcRows * (d + kTcPad) + 3 * kTcTile * kTcWS + kTcRows * kTcWS);
  cudaError_t err = cudaFuncSetAttribute(
      moe_gmm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + kTcRows - 1) / kTcRows, E, f_splits);
  float* partial = f_splits > 1 ? static_cast<float*>(scratch) : nullptr;
  moe_gmm_tc_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(buf), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w3), static_cast<const bf16*>(w2),
      static_cast<bf16*>(out), partial, C, d, f, f / f_splits);
  return finish_splits<bf16>(scratch, out, E, C, d, f_splits, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int BC>
int launch(const void* buf, const void* w1, const void* w3, const void* w2,
           void* out, void* scratch, int E, int C, int d, int f, int block_f,
           int f_splits, cudaStream_t stream) {
  const size_t smem = (size_t)(BC * d + BC * kMaxBF) * sizeof(float);
  auto kern = moe_gmm_kernel<T, BC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + BC - 1) / BC, E, f_splits);
  float* partial = f_splits > 1 ? static_cast<float*>(scratch) : nullptr;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(buf), static_cast<const T*>(w1),
      static_cast<const T*>(w3), static_cast<const T*>(w2),
      static_cast<T*>(out), partial, C, d, f, block_f, f / f_splits);
  return finish_splits<T>(scratch, out, E, C, d, f_splits, stream);
}

// ---------------------------------------------------------------------------
// d > kMaxD: output columns in slices of kMaxD, x streamed in chunks
// ---------------------------------------------------------------------------

constexpr int kDChunk = 256;  // x columns staged per step (CUDA-core path)

// grid: (d_slices * ceil(C / BC), E, f_splits), slice = blockIdx.x % d_slices;
// block: kThreads.  As moe_gmm_kernel, for output columns
// [slice * kMaxD, slice * kMaxD + kMaxD) of d, with x staged kDChunk
// columns at a time.
template <typename T, int BC>
__global__ void __launch_bounds__(kThreads)
moe_gmm_dslice_kernel(const T* __restrict__ buf, const T* __restrict__ w1,
                      const T* __restrict__ w3, const T* __restrict__ w2,
                      T* __restrict__ out, float* __restrict__ partial,
                      int C, int d, int f, int block_f, int f_per_split,
                      int d_slices) {
  __shared__ float xs[BC][kDChunk];
  __shared__ float hs[BC][kMaxBF];

  const int E = gridDim.y;
  const int e = blockIdx.y;
  const int split = blockIdx.z;
  const int slice = blockIdx.x % d_slices;
  const int c0 = (blockIdx.x / d_slices) * BC;
  const int n0 = slice * kMaxD;
  const int rows = min(BC, C - c0);
  const int tid = threadIdx.x;

  constexpr int kRowGroups = kThreads / kMaxBF;  // 4
  constexpr int kRowsPerThread = BC / kRowGroups;
  const int hj = tid % kMaxBF;
  const int hr = tid / kMaxBF;

  float acc[BC][kColsPerThread];
#pragma unroll
  for (int r = 0; r < BC; ++r)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = 0.0f;

  const T* xb = buf + ((size_t)e * C + c0) * d;
  const T* w1e = w1 + (size_t)e * d * f;
  const T* w3e = w3 + (size_t)e * d * f;
  const T* w2e = w2 + (size_t)e * f * d;
  const int f_lo = split * f_per_split;
  const int f_hi = f_lo + f_per_split;

  for (int fb = f_lo; fb < f_hi; fb += block_f) {
    // h = silu(x . w1[:, fb:fb+block_f]) * (x . w3[:, fb:fb+block_f])
    float g[kRowsPerThread], u[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) { g[i] = 0.0f; u[i] = 0.0f; }
    for (int k0 = 0; k0 < d; k0 += kDChunk) {
      const int kn = min(kDChunk, d - k0);
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < BC * kDChunk; i += kThreads) {
        const int r = i / kDChunk, c = i % kDChunk;
        xs[r][c] = r < rows && c < kn ? to_f(xb[(size_t)r * d + k0 + c]) : 0.0f;
      }
      __syncthreads();
      if (hj < block_f) {
        const T* p1 = w1e + (size_t)k0 * f + fb + hj;
        const T* p3 = w3e + (size_t)k0 * f + fb + hj;
#pragma unroll 4
        for (int k = 0; k < kn; ++k) {
          const float a = to_f(p1[(size_t)k * f]);
          const float b = to_f(p3[(size_t)k * f]);
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const float xv = xs[hr + i * kRowGroups][k];
            g[i] = fmaf(xv, a, g[i]);
            u[i] = fmaf(xv, b, u[i]);
          }
        }
      }
    }
    if (hj < block_f) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        hs[hr + i * kRowGroups][hj] = silu(g[i]) * u[i];
    }
    __syncthreads();
    // acc += h . w2[fb:fb+block_f, n0 : n0 + kMaxD]
    for (int j = 0; j < block_f; ++j) {
      const T* p2 = w2e + (size_t)(fb + j) * d + n0;
      float wv[kColsPerThread];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int n = tid + c * kThreads;
        wv[c] = n0 + n < d ? to_f(p2[n]) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < BC; ++r) {
        const float hv = hs[r][j];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = fmaf(hv, wv[c], acc[r][c]);
      }
    }
    __syncthreads();
  }

  const size_t n_out = (size_t)E * C * d;
#pragma unroll
  for (int r = 0; r < BC; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int n = n0 + tid + c * kThreads;
      if (n >= d) continue;
      const size_t o = ((size_t)e * C + c0 + r) * d + n;
      if (partial != nullptr) {
        partial[(size_t)split * n_out + o] = acc[r][c];
      } else {
        out[o] = from_f<T>(acc[r][c]);
      }
    }
  }
}

// grid: (d_slices * ceil(C / 16), E, f_splits); block: 8 warps.  As
// moe_gmm_tc_kernel, for the output chunks of one slice, with the x tile
// loaded 64 columns at a time beside the w1/w3 tiles it multiplies.
__global__ void __launch_bounds__(kThreads)
moe_gmm_tc_dslice_kernel(const bf16* __restrict__ buf,
                         const bf16* __restrict__ w1,
                         const bf16* __restrict__ w3,
                         const bf16* __restrict__ w2, bf16* __restrict__ out,
                         float* __restrict__ partial, int C, int d, int f,
                         int f_per_split, int d_slices) {
  __shared__ __align__(16) bf16 xs[kTcRows * kTcWS];
  __shared__ __align__(16) bf16 w1s[kTcTile * kTcWS];
  __shared__ __align__(16) bf16 w3s[kTcTile * kTcWS];
  __shared__ __align__(16) bf16 w2s[kTcTile * kTcWS];
  __shared__ __align__(16) bf16 hs[kTcRows * kTcWS];

  const int E = gridDim.y;
  const int e = blockIdx.y;
  const int split = blockIdx.z;
  const int slice = blockIdx.x % d_slices;
  const int c0 = (blockIdx.x / d_slices) * kTcRows;
  const int n0 = slice * kMaxD;
  const int rows = min(kTcRows, C - c0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kchunks = d / kTcTile;
  const int nchunks = min(kTcMaxChunks, (d - n0) / kTcTile);

  float acc[kTcMaxChunks][4];
#pragma unroll
  for (int n = 0; n < kTcMaxChunks; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;

  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = lane & 15;
  const bf16* xb = buf + ((size_t)e * C + c0) * d;
  const bf16* w1e = w1 + (size_t)e * d * f;
  const bf16* w3e = w3 + (size_t)e * d * f;
  const bf16* w2e = w2 + (size_t)e * f * d;
  const int f_lo = split * f_per_split;
  const int f_hi = f_lo + f_per_split;

  for (int fb = f_lo; fb < f_hi; fb += kTcTile) {
    float h1[4] = {0.0f, 0.0f, 0.0f, 0.0f}, h3[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kc = 0; kc < kchunks; ++kc) {
      load_tile(w1s, w1e + (size_t)kc * kTcTile * f + fb, f, tid);
      load_tile(w3s, w3e + (size_t)kc * kTcTile * f + fb, f, tid);
      if (tid < kTcRows * 8) {  // x[:, 64 kc : 64 kc + 64]; ragged rows zero
        const int r = tid >> 3, c = (tid & 7) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows)
          v = *reinterpret_cast<const uint4*>(xb + (size_t)r * d + kc * kTcTile + c);
        *reinterpret_cast<uint4*>(xs + r * kTcWS + c) = v;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kTcTile / 16; ++ks) {
        uint32_t a[4], b0, b1;
        ldsm_x4(a, xs + a_row * kTcWS + ks * 16 + a_col);
        ldsm_x2_trans(b0, b1, w1s + (ks * 16 + b_row) * kTcWS + warp * 8);
        mma_bf16(h1, a, b0, b1);
        ldsm_x2_trans(b0, b1, w3s + (ks * 16 + b_row) * kTcWS + warp * 8);
        mma_bf16(h3, a, b0, b1);
      }
      __syncthreads();
    }
    {
      const int r = lane >> 2, c = warp * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(hs + r * kTcWS + c) =
          __floats2bfloat162_rn(silu(h1[0]) * h3[0], silu(h1[1]) * h3[1]);
      *reinterpret_cast<__nv_bfloat162*>(hs + (r + 8) * kTcWS + c) =
          __floats2bfloat162_rn(silu(h1[2]) * h3[2], silu(h1[3]) * h3[3]);
    }
    __syncthreads();
    uint32_t ha[kTcTile / 16][4];
#pragma unroll
    for (int ks = 0; ks < kTcTile / 16; ++ks)
      ldsm_x4(ha[ks], hs + a_row * kTcWS + ks * 16 + a_col);
#pragma unroll
    for (int nc = 0; nc < kTcMaxChunks; ++nc) {
      if (nc < nchunks) {
        load_tile(w2s, w2e + (size_t)fb * d + n0 + nc * kTcTile, d, tid);
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < kTcTile / 16; ++ks) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, w2s + (ks * 16 + b_row) * kTcWS + warp * 8);
          mma_bf16(acc[nc], ha[ks], b0, b1);
        }
        __syncthreads();
      }
    }
  }

  const size_t n_out = (size_t)E * C * d;
  const int r0 = lane >> 2, cc = warp * 8 + (lane & 3) * 2;
#pragma unroll
  for (int nc = 0; nc < kTcMaxChunks; ++nc) {
    if (nc >= nchunks) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + half * 8;
      if (r >= rows) continue;
      const size_t o = ((size_t)e * C + c0 + r) * d + n0 + nc * kTcTile + cc;
      const float v0 = acc[nc][2 * half], v1 = acc[nc][2 * half + 1];
      if (partial != nullptr) {
        partial[(size_t)split * n_out + o] = v0;
        partial[(size_t)split * n_out + o + 1] = v1;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

int launch_tc_dslice(const void* buf, const void* w1, const void* w3,
                     const void* w2, void* out, void* scratch, int E, int C,
                     int d, int f, int f_splits, int d_slices,
                     cudaStream_t stream) {
  const dim3 grid(d_slices * ((C + kTcRows - 1) / kTcRows), E, f_splits);
  float* partial = f_splits > 1 ? static_cast<float*>(scratch) : nullptr;
  moe_gmm_tc_dslice_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(buf), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w3), static_cast<const bf16*>(w2),
      static_cast<bf16*>(out), partial, C, d, f, f / f_splits, d_slices);
  return finish_splits<bf16>(scratch, out, E, C, d, f_splits, stream);
}

template <typename T, int BC>
int launch_dslice(const void* buf, const void* w1, const void* w3,
                  const void* w2, void* out, void* scratch, int E, int C,
                  int d, int f, int block_f, int f_splits, int d_slices,
                  cudaStream_t stream) {
  const dim3 grid(d_slices * ((C + BC - 1) / BC), E, f_splits);
  float* partial = f_splits > 1 ? static_cast<float*>(scratch) : nullptr;
  moe_gmm_dslice_kernel<T, BC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(buf), static_cast<const T*>(w1),
      static_cast<const T*>(w3), static_cast<const T*>(w2),
      static_cast<T*>(out), partial, C, d, f, block_f, f / f_splits, d_slices);
  return finish_splits<T>(scratch, out, E, C, d, f_splits, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `scratch` holds f_splits * E * C * d
// floats when f_splits > 1 (allocated by the caller).  d_slices is
// ceil(d / 1024): 1 takes the kernels above unchanged, more the sliced
// pair.  Returns cudaGetLastError() after the launches.
extern "C" int moe_gmm_launch(const void* buf, const void* w1, const void* w3,
                              const void* w2, void* out, void* scratch, int E,
                              int C, int d, int f, int block_c, int block_f,
                              int f_splits, int d_slices, int dtype,
                              void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || d_slices != (d + kMaxD - 1) / kMaxD ||
      block_f <= 0 || block_f > kMaxBF || f % block_f != 0 || f_splits <= 0 ||
      (f / block_f) % f_splits != 0 || (block_c != 8 && block_c != 16) ||
      (f_splits > 1 && scratch == nullptr) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = dtype == 1 && d % kTcTile == 0 && block_f == kTcTile &&
                  aligned16(buf) && aligned16(w1) && aligned16(w3) &&
                  aligned16(w2) && aligned16(out);
  if (d_slices > 1) {
    if (tc)
      return launch_tc_dslice(buf, w1, w3, w2, out, scratch, E, C, d, f,
                              f_splits, d_slices, s);
    if (dtype == 0)
      return block_c == 8
          ? launch_dslice<float, 8>(buf, w1, w3, w2, out, scratch, E, C, d, f, block_f, f_splits, d_slices, s)
          : launch_dslice<float, 16>(buf, w1, w3, w2, out, scratch, E, C, d, f, block_f, f_splits, d_slices, s);
    return block_c == 8
        ? launch_dslice<bf16, 8>(buf, w1, w3, w2, out, scratch, E, C, d, f, block_f, f_splits, d_slices, s)
        : launch_dslice<bf16, 16>(buf, w1, w3, w2, out, scratch, E, C, d, f, block_f, f_splits, d_slices, s);
  }
  if (tc)
    return launch_tc(buf, w1, w3, w2, out, scratch, E, C, d, f, f_splits, s);
  if (dtype == 0)
    return block_c == 8
        ? launch<float, 8>(buf, w1, w3, w2, out, scratch, E, C, d, f, block_f, f_splits, s)
        : launch<float, 16>(buf, w1, w3, w2, out, scratch, E, C, d, f, block_f, f_splits, s);
  if (dtype == 1)
    return block_c == 8
        ? launch<__nv_bfloat16, 8>(buf, w1, w3, w2, out, scratch, E, C, d, f, block_f, f_splits, s)
        : launch<__nv_bfloat16, 16>(buf, w1, w3, w2, out, scratch, E, C, d, f, block_f, f_splits, s);
  return (int)cudaErrorInvalidValue;
}
