// Shared pieces of the low-rank kernels (lowrank_matmul.cu, lowrank_ffn.cu).
//
// Tiling, for both kernels: one CTA of 8 warps owns a 16-row block of x and
// a 64-column block of the output.
//
// Phase 1 forms the whole rank-r intermediate t = x U for the CTA's 16 rows
// with bf16 tensor-core products (mma.sync m16n8k16, float32 accumulators)
// and rounds t to bf16 into shared memory — the one rounding point between
// the two products.  The 8 CTAs of a thread-block cluster (8 neighbouring
// column blocks of the output, same rows) split C between them: each walks
// every 8th 32-row chunk of C, leaves its float32 partial of t in shared
// memory, and after a cluster barrier each CTA sums one eighth of t's
// columns over the 8 partials (distributed shared memory, fixed order),
// rounds it, and writes it into all 8 CTAs' copies of t.  So U crosses each
// cluster once, spread over 8 SMs.  32 rows of U are one contiguous span of
// global memory, so each chunk is copied as it lies (16-byte cp.async, no
// re-layout) through a 3-stage ring that keeps two chunks in flight while
// one is multiplied; the B fragments are read from that flat layout element
// by element.  Ranks need not be multiples of 8.
//
// Phase 2 multiplies t by the CTA's 64 columns of V (WMMA, float32
// accumulators), walking r in 64-row chunks through a second 3-stage ring
// whose first two chunks are requested before phase 1 starts.
//
// t never leaves the cluster, as it never leaves VMEM in the TPU kernel.
// Every M, C, r <= kRMax and S is taken: rows, columns and ranks past the
// edge are zero-filled in shared memory and masked on the store; the grid
// is padded to whole clusters, and the padding CTAs store nothing.  The fast path needs 16-byte
// aligned x, U and V with C % 8 == 0 and S % 8 == 0; otherwise the same
// stages are filled by plain element loads.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

namespace repro {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
namespace cg = cooperative_groups;

constexpr int kCluster = 8;    // CTAs of a cluster: column blocks sharing t
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 16;        // rows of x per CTA: one MMA row tile
constexpr int kBN = 64;        // output columns per CTA
constexpr int kKC = 32;        // rows of U (and columns of x) per phase-1 stage
constexpr int kStages = 3;     // phase-1 ring depth
constexpr int kRC = 64;        // rows of V per phase-2 stage
constexpr int kVStages = 3;    // phase-2 ring depth
constexpr int kRMax = 512;     // largest rank the kernels take
constexpr int kTilesPerWarp = kRMax / 8 / kWarps;  // n8 tiles of t per warp
constexpr int kLdx = kKC + 8;  // smem row strides (elements), padded
constexpr int kLdv = kBN + 8;
constexpr int kLdo = kBN + 4;  // float32 output staging
constexpr int kXStage = kBM * kLdx;  // elements
constexpr int kVStage = kRC * kLdv;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// Rank padded to the WMMA tile, and the smem row stride of t.
__host__ __device__ inline int padded_rank(int r) { return round_up(r, 16); }
__host__ __device__ inline int rank_stride(int rp) { return rp + 8; }
// Elements of one phase-1 U stage: kKC rows of r, rounded to 16 bytes.
__host__ __device__ inline int u_stage(int r) { return round_up(kKC * r, 8); }
// Bytes of the phase-1 region: the U ring, which the float32 partial of t
// (kBM x rp) reuses once the ring is drained.
__host__ __device__ inline size_t ring_bytes(int r) {
  const size_t ring = sizeof(bf16) * kStages * u_stage(r);
  const size_t part = sizeof(float) * kBM * padded_rank(r);
  return ring > part ? ring : part;
}

__device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// --------------------------------------------------------------------------
// cp.async (global -> shared, 16 bytes, zero-filled past `bytes`)
// --------------------------------------------------------------------------

__device__ inline void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// --------------------------------------------------------------------------
// Stage fills
// --------------------------------------------------------------------------

// xs[kBM][kLdx] = x[m0:m0+kBM, c0:c0+kKC], zero past M and C.
__device__ inline void x_fill(const bf16* __restrict__ x, int M, int C, int m0, int c0,
                              bool vec, bf16* xs) {
  if (vec) {
    if (threadIdx.x < kBM * kKC / 8) {
      const int row = threadIdx.x / (kKC / 8), col = (threadIdx.x % (kKC / 8)) * 8;
      const int m = m0 + row, c = c0 + col;
      const int bytes = m < M ? 2 * max(0, min(8, C - c)) : 0;
      cp_async16(xs + row * kLdx + col, bytes ? x + (size_t)m * C + c : x, bytes);
    }
    return;
  }
  for (int i = threadIdx.x; i < kBM * kKC; i += kThreads) {
    const int row = i / kKC, col = i % kKC;
    const int m = m0 + row, c = c0 + col;
    xs[row * kLdx + col] = (m < M && c < C) ? x[(size_t)m * C + c] : __float2bfloat16(0.0f);
  }
}

// us[0 .. rows*r) = U rows [c0, c0+rows) as they lie in memory (row-major,
// one contiguous span).  Vector copies may run up to 7 elements past the
// span (into the next rows, never past the end of U); those are not read.
__device__ inline void u_fill(const bf16* __restrict__ u, int C, int r, int c0, bool vec,
                              bf16* us) {
  const size_t start = (size_t)c0 * r, total = (size_t)C * r;
  const int n = min(kKC, C - c0) * r;
  if (vec) {
    for (int q = threadIdx.x; q < (n + 7) / 8; q += kThreads) {
      const size_t e = start + (size_t)q * 8;
      cp_async16(us + q * 8, u + e, (int)min((size_t)16, 2 * (total - e)));
    }
    return;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) us[i] = u[start + i];
}

// vs[kRC][kLdv] = V[r0:r0+kRC, n0:n0+kBN], zero past r and S.
__device__ inline void v_fill(const bf16* __restrict__ v, int r, int S, int r0, int n0,
                              bool vec, bf16* vs) {
  for (int q = threadIdx.x; q < kRC * kBN / 8; q += kThreads) {
    const int row = q / (kBN / 8), col = (q % (kBN / 8)) * 8;
    const int rr = r0 + row, n = n0 + col;
    bf16* dst = vs + row * kLdv + col;
    if (vec) {
      const int bytes = rr < r ? 2 * max(0, min(8, S - n)) : 0;
      cp_async16(dst, bytes ? v + (size_t)rr * S + n : v, bytes);
    } else {
      for (int j = 0; j < 8; ++j)
        dst[j] = (rr < r && n + j < S) ? v[(size_t)rr * S + n + j] : __float2bfloat16(0.0f);
    }
  }
}

// --------------------------------------------------------------------------
// Phase 1: ts[kBM][rank_stride(rp)] = bf16( x[m0:m0+kBM, :] @ u )
// --------------------------------------------------------------------------

__device__ inline unsigned pack2(bf16 lo, bf16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

// d += A (16x16, row-major) * B (16x8, col-major), bf16 in, float32 out.
__device__ inline void mma16816(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// float32 accumulation over C; ranks in [r, rp) come out zero.  xring holds
// kStages x kXStage elements, uring ring_bytes(r).  cp.async copies issued
// (not committed) before the call join the first stage's group.  Every CTA
// of the cluster must call it with the same x rows, u, C and r.  Ends with
// every copy landed and a cluster-wide barrier, after which ts is complete.
__device__ inline void rank_product(const bf16* __restrict__ x, const bf16* __restrict__ u,
                                    int M, int C, int r, int m0, int rp, bool vec,
                                    bf16* xring, bf16* uring, bf16* ts) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // MMA group and thread-in-group
  const int ntiles = rp / 8;
  const int nchunks = (C + kKC - 1) / kKC;
  const int nloc = nchunks > q ? (nchunks - q + kCluster - 1) / kCluster : 0;
  const int us_stride = u_stage(r);
  const bf16 zero = __float2bfloat16(0.0f);
  float acc[kTilesPerWarp][4];
#pragma unroll
  for (int f = 0; f < kTilesPerWarp; ++f)
    acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.0f;

  // local chunk i is chunk q + i * kCluster of C
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nloc) {
      const int c0 = (q + s * kCluster) * kKC;
      x_fill(x, M, C, m0, c0, vec, xring + s * kXStage);
      u_fill(u, C, r, c0, vec, uring + s * us_stride);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nloc; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk i landed for all; stage (i-1) % kStages is free
    const int ni = i + kStages - 1;
    if (ni < nloc) {
      const int c0 = (q + ni * kCluster) * kKC;
      x_fill(x, M, C, m0, c0, vec, xring + (ni % kStages) * kXStage);
      u_fill(u, C, r, c0, vec, uring + (ni % kStages) * us_stride);
    }
    cp_async_commit();

    const bf16* xs = xring + (i % kStages) * kXStage;
    const bf16* us = uring + (i % kStages) * us_stride;
    const int rows = min(kKC, C - (q + i * kCluster) * kKC);
#pragma unroll
    for (int k0 = 0; k0 < kKC; k0 += 16) {
      const unsigned* xw = reinterpret_cast<const unsigned*>(xs);
      const unsigned a0 = xw[(g * kLdx + k0 + 2 * t) / 2];
      const unsigned a1 = xw[((g + 8) * kLdx + k0 + 2 * t) / 2];
      const unsigned a2 = xw[(g * kLdx + k0 + 2 * t + 8) / 2];
      const unsigned a3 = xw[((g + 8) * kLdx + k0 + 2 * t + 8) / 2];
      const int ka = k0 + 2 * t;  // this thread's B rows: ka, ka+1, ka+8, ka+9
#pragma unroll
      for (int f = 0; f < kTilesPerWarp; ++f) {
        const int j = warp + f * kWarps;
        if (j < ntiles) {
          const int n = j * 8 + g;
          bf16 e0 = zero, e1 = zero, e2 = zero, e3 = zero;
          if (n < r) {
            if (ka < rows) e0 = us[ka * r + n];
            if (ka + 1 < rows) e1 = us[(ka + 1) * r + n];
            if (ka + 8 < rows) e2 = us[(ka + 8) * r + n];
            if (ka + 9 < rows) e3 = us[(ka + 9) * r + n];
          }
          mma16816(acc[f], a0, a1, a2, a3, pack2(e0, e1), pack2(e2, e3));
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: its bytes now hold this CTA's partial

  float* part = reinterpret_cast<float*>(uring);  // [kBM][rp] float32
#pragma unroll
  for (int f = 0; f < kTilesPerWarp; ++f) {
    const int j = warp + f * kWarps;
    if (j < ntiles) {
      const int col = j * 8 + 2 * t;
      *reinterpret_cast<float2*>(part + g * rp + col) = make_float2(acc[f][0], acc[f][1]);
      *reinterpret_cast<float2*>(part + (g + 8) * rp + col) =
          make_float2(acc[f][2], acc[f][3]);
    }
  }
  cluster.sync();  // every partial is written

  // CTA q sums columns [q w, (q+1) w) of t over the cluster's partials in
  // rank order, rounds them (the one rounding point between the two
  // products) and writes them into every CTA's ts.
  const int w = rp / kCluster, ldt = rank_stride(rp);
  for (int e = threadIdx.x; e < kBM * w; e += kThreads) {
    const int row = e / w, col = q * w + e % w;
    float sum = 0.0f;
#pragma unroll
    for (int p = 0; p < kCluster; ++p) sum += cluster.map_shared_rank(part, p)[row * rp + col];
    const bf16 b = __float2bfloat16(sum);
#pragma unroll
    for (int p = 0; p < kCluster; ++p) cluster.map_shared_rank(ts, p)[row * ldt + col] = b;
  }
  cluster.sync();  // ts complete everywhere; no partial is read any more
}

// --------------------------------------------------------------------------
// Phase 2 pieces
// --------------------------------------------------------------------------

// acc += ts[:, r0+k .. r0+k+16) @ vs[k .. k+16, cf*16 .. cf*16+16) for the
// two 16-deep steps k this warp owns in the current rank chunk.
__device__ inline void output_steps(FragC& acc, const bf16* ts, int ldt, int rp,
                                    const bf16* vs, int r0, int kh, int cf) {
#pragma unroll
  for (int s2 = 0; s2 < 2; ++s2) {
    const int k = (kh * 2 + s2) * 16;
    if (r0 + k < rp) {
      FragA a;
      FragB b;
      wmma::load_matrix_sync(a, ts + r0 + k, ldt);
      wmma::load_matrix_sync(b, vs + k * kLdv + cf * 16, kLdv);
      wmma::mma_sync(acc, a, b, acc);
    }
  }
}

// Allow more than 48 KB of dynamic shared memory once per size.
template <typename Kernel>
inline cudaError_t reserve_smem(Kernel kernel, size_t bytes, size_t* reserved) {
  if (bytes <= 48 * 1024 || bytes <= *reserved) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e == cudaSuccess) *reserved = bytes;
  return e;
}

}  // namespace repro
