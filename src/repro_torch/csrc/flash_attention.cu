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
//   at 0 for both streams.  Head dims: every multiple of 16 up to 128.
//   Given a non-null `lse` pointer, both paths also write each row's
//   log-sum-exp of the scaled scores (B, H, S, fp32), which the backward
//   (flash_attention_bwd.cu) uses to recompute the probabilities; serving
//   passes null and writes nothing more.
//
// What bounds it on the H100: operations.  Causal attention over S = 2048
//   with H = 16, dh = 64 is 4 * H * S^2 / 2 * dh = 8.6 GFLOP (about 9 us of
//   bf16 tensor-core time) against 12.6 MB of q/k/v/out traffic (about
//   4 us); phi3-mini (H = 32, dh = 96) is 25.8 GFLOP (26 us) against 50 MB
//   (15 us).  The score matrix itself is never written.
//
// Two paths, chosen by dtype.  Both give one block a (batch * kv-head,
// query tile) pair and fold the G query heads of its kv head into the
// tile's 64 rows (64 / G queries x G heads), so each K/V tile is loaded
// once for the G heads that share it; both run the KV loop only over the
// key tiles [lo, hi) that meet the causal triangle or the window band,
// and both mask ragged S and T tails themselves.
//
// * bf16 (the serving and long-prompt path): tensor cores, in the style of
//   FlashAttention-2.  4 warps own 16 rows each.  Q is staged once in
//   shared memory and kept as ldmatrix A-fragments in registers; K/V tiles
//   of 64 keys x dh are bf16 in shared memory, rows padded by 16 bytes so
//   that ldmatrix is free of bank conflicts, and double-buffered with
//   cp.async so the next tile's load overlaps this tile's products.
//   S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate); the online max and sum run on the accumulator fragments
//   with quad shuffles, exponents in base 2 (exp2f on pre-scaled scores);
//   P is re-packed to bf16 A-fragments in registers, never through shared
//   memory; V is read with ldmatrix.trans.  Masks are evaluated only on
//   tiles that cross the diagonal, the band edge or the ragged end of T.
//   The query-tile index is reversed, so the long causal tiles start first
//   and the short ones fill the tail of the grid (DLBC's argument for
//   issuing the heavy chunks first).  wgmma and TMA are later work.
// * fp32: the CUDA cores (the tensor cores take no fp32 operands): S and
//   P V as 4 x 4 register tiles per thread out of fp32 shared memory, the
//   P tile staged in shared memory.  It keeps fp32 results within 2e-5
//   of the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

// Every head dim the kernels are built for.
#define FA_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

namespace {

constexpr int kRows = 64;      // query rows (query x head) per block
constexpr int kBK = 64;        // keys per tile
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32 path: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16

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
template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out,
            float* __restrict__ lse, int S, int Tk, int H, int KV, int causal,
            int window, float sm_scale) {
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
      val = q[(((size_t)b * S + s) * H + kvh * G + r % G) * DH + dd] * sm_scale;
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
        kv_k = k[off];
        kv_v = v[off];
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
    float* orow = out + (((size_t)b * S + s) * H + kvh * G + r % G) * DH;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[tx + 16 * c] = o[i][c] * inv;
    // row log-sum-exp of the scaled scores, for the backward (+inf for a
    // row that sees no key, so that its recomputed probabilities are 0)
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + kvh * G + r % G) * S + s] =
          l[i] > 0.0f ? m[i] + logf(l[i]) : INFINITY;
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int Tk, int H, int KV, int causal,
               int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  auto kern = attn_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int BQ = kRows / (H / KV);
  const dim3 grid((S + BQ - 1) / BQ, B * KV);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, Tk, H,
      KV, causal, window, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 path: tensor cores
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kTcThreads = 128;  // 4 warps x 16 rows
constexpr int kPad = 8;          // bf16 pad per shared row (16 bytes)

// Q [kRows] + K and V [2 stages][kBK] rows of dh + kPad bf16.
template <int DH>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (size_t)(kRows + 4 * kBK) * (DH + kPad);
}

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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// grid: (B * KV, ceil(S / BQ)) with BQ = kRows / G, query tiles in reverse;
// block: 4 warps.  Fragment layout of m16n8k16 (per warp, lane = 4 * g + t):
// accumulator c0, c1 at (row g, cols 2t, 2t + 1), c2, c3 at row g + 8.
template <int DH>
__global__ void __launch_bounds__(kTcThreads)
attn_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, int S, int Tk, int H, int KV,
               int causal, int window, float scale_log2) {
  constexpr int LD = DH + kPad;      // shared row stride (elements)
  constexpr int kVecs = DH / 8;      // 16-byte vectors per row
  constexpr int kKSteps = DH / 16;   // k16 steps of Q K^T
  constexpr int kNTiles = DH / 8;    // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LD]
  bf16* ks = qs + kRows * LD;                     // [2][kBK][LD]
  bf16* vs = ks + 2 * kBK * LD;                   // [2][kBK][LD]

  const int G = H / KV;
  const int BQ = kRows / G;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Key range [lo, hi) that meets the triangle / band of this tile.
  const int q_last = min(q0 + BQ, S) - 1;
  const int hi = causal ? min(Tk, q_last + 1) : Tk;
  const int lo = window > 0 ? max(0, q0 - (window - 1)) : 0;
  const int kb0 = (lo / kBK) * kBK;
  const int n_tiles = hi > kb0 ? (hi - kb0 + kBK - 1) / kBK : 0;

  // Q tile; row r = (query r / G, head kvh * G + r % G), idle rows zero.
  for (int i = tid; i < kRows * kVecs; i += kTcThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    const int qi = r / G, s = q0 + qi;
    const bool ok = qi < BQ && s < S;
    const bf16* src =
        ok ? q + (((size_t)b * S + s) * H + kvh * G + r % G) * DH + c : q;
    cp_async16(qs + r * LD + c, src, ok);
  }
  auto load_kv = [&](int kb, int stage) {
    bf16* kd = ks + stage * kBK * LD;
    bf16* vd = vs + stage * kBK * LD;
    for (int i = tid; i < kBK * kVecs; i += kTcThreads) {
      const int j = i / kVecs, c = (i % kVecs) * 8;
      const bool ok = kb + j < Tk;
      const size_t off = ok ? (((size_t)b * Tk + kb + j) * KV + kvh) * DH + c : 0;
      cp_async16(kd + j * LD + c, k + off, ok);
      cp_async16(vd + j * LD + c, v + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(kb0, 0);
  cp_async_commit();

  // ldmatrix lane addresses: A (Q) and V^T as x4 over (rows 0-15, cols 0/8);
  // K as x4 over (keys 0-7 / 8-15, cols 0/8).
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 8;
  // this thread's two rows and their query positions
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int qpos0 = q0 + r0 / G, qpos1 = q0 + r1 / G;

  uint32_t qf[kKSteps][4];
  float o[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kb = kb0 + it * kBK;
    if (it + 1 < n_tiles) load_kv(kb + kBK, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) has landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + a_row) * LD + kk * 16 + a_col);
    }
    const bf16* kt = ks + (it & 1) * kBK * LD;
    const bf16* vt = vs + (it & 1) * kBK * LD;

    // S = Q K^T: 16 rows x 64 keys per warp, eight n8 tiles
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, kt + (np * 16 + k_row) * LD + kk * 16 + k_col);
        mma_bf16(sc[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale to base 2; mask only tiles that cross the diagonal, the band
    // edge or the end of T
    const bool edge = kb + kBK > Tk || (causal && kb + kBK - 1 > q0) ||
                      (window > 0 && q_last - kb >= window);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[n][e] * scale_log2;
        if (edge) {
          const int kpos = kb + n * 8 + (lane & 3) * 2 + (e & 1);
          const int qp = e < 2 ? qpos0 : qpos1;
          if (kpos >= Tk || (causal && qp < kpos) ||
              (window > 0 && qp - kpos >= window))
            s = -INFINITY;
        }
        sc[n][e] = s;
      }
    }

    // online softmax on the fragments: row max over the quad, rescale
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    // a row with no visible key yet keeps max -inf: exponentiate against 0
    const float base0 = mx0 == -INFINITY ? 0.0f : mx0;
    const float base1 = mx1 == -INFINITY ? 0.0f : mx1;
    const float alpha0 = exp2f(m0 - base0), alpha1 = exp2f(m1 - base1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sc[n][0] = exp2f(sc[n][0] - base0);
      sc[n][1] = exp2f(sc[n][1] - base0);
      sc[n][2] = exp2f(sc[n][2] - base1);
      sc[n][3] = exp2f(sc[n][3] - base1);
      rs0 += sc[n][0] + sc[n][1];
      rs1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * alpha0 + rs0;  // this thread's share; the quad sums at the end
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O += P V: P's accumulator tiles (2j, 2j + 1) are the A fragment of
    // keys [16j, 16j + 16), packed to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vt + (kk * 16 + a_row) * LD + np * 16 + a_col);
        mma_bf16(o[2 * np], pa, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is free for the load two tiles ahead
  }
  cp_async_wait<0>();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  const int col = (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    const int qi = r / G, s = q0 + qi;
    if (qi >= BQ || s >= S) continue;
    const float inv = half ? inv1 : inv0;
    bf16* orow = out + (((size_t)b * S + s) * H + kvh * G + r % G) * DH + col;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
          o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    // row log-sum-exp in natural units (the scores ran in base 2)
    if (lse != nullptr && (lane & 3) == 0) {
      const float l = half ? l1 : l0, m = half ? m1 : m0;
      lse[((size_t)b * H + kvh * G + r % G) * S + s] =
          l > 0.0f ? (m + log2f(l)) * 0.6931471805599453f : INFINITY;
    }
  }
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int S, int Tk, int H, int KV, int causal,
                int window, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<DH>();
  auto kern = attn_tc_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int BQ = kRows / (H / KV);
  const int q_tiles = (S + BQ - 1) / BQ;
  if (q_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * KV, q_tiles);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, Tk, H,
      KV, causal, window, 1.4426950408889634f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out (B, S, H, dh), k/v (B, T, KV, dh),
// all contiguous (and 16-byte aligned for bf16); dh a multiple of 16 up to
// 128.  lse: null (serving), or (B, H, S) fp32 that receives each row's
// log-sum-exp of the scaled scores for the backward
// (flash_attention_bwd.cu).  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int S, int Tk, int H, int KV,
                                      int dh, int causal, int window,
                                      int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0 || H / KV > kRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define FA_CASE(D)                                                             \
  case D:                                                                      \
    return dtype == 0                                                          \
        ? launch_f32<D>(q, k, v, out, l, B, S, Tk, H, KV, causal, window, s)   \
        : launch_bf16<D>(q, k, v, out, l, B, S, Tk, H, KV, causal, window, s);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (dh) {
    FA_HEAD_DIMS(FA_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}
