// K6 and K7: int8 x int8 -> int32 decode matmuls on int8 tensor cores
// (mma.sync m16n8k32 .s32.s8.s8.s32, exact int32 accumulation, no
// .satfinite: |sum| <= 2560 * 127^2 < 2^31 at the shapes served).
//
//   K6  y_i32 = x_q @ w_q                         x_q (M,C), w_q (C,S) -> int32 (M,S)
//   K7  t     = float(x_q @ u_q) * u_scale        x_q (M,C), u_q (C,r), u_scale (1,r)
//       ts    = max(max_row |t|, 1e-8) / 127      per row, over the whole r
//       tq    = clamp(rint(t / ts), -127, 127)    int8, round half to even
//       y     = (float(tq @ v_q) * ts) * v_scale  v_q (r,S), v_scale (1,S) -> f32 (M,S)
//
// Replaces the TPU kernels of repro/kernels/int8_matmul.py: int8_matmul
// (`_dense_kernel`, grid (M/bm, S/bn, C/bk) with an int32 VMEM accumulator)
// and int8_lowrank_matmul (`_lowrank_kernel`, same grid with a (bm, r) int32
// accumulator of x_q u_q that is rescaled, requantized and multiplied by
// v_q on the last C step, so t never leaves VMEM).
//
// What bounds them on the H100: at the serving shapes (M = 8 decode slots
// or a 128-token prefill, C and S <= 2560, r <= 256) they do far fewer
// operations than the card's int8 ridge (~590 operations a byte), so the
// floor is the bytes of the int8 weights read from HBM (0.05-0.7 us).  What
// bounds this design is latency: a CTA walks its share of C chunk by chunk.
//
// Tiling: a CTA owns a 16-row block of x (one m16 MMA tile) and 64 output
// columns.  Operands are staged in shared memory as they lie in global
// memory (16-byte cp.async, zero-filled past every edge), three stages
// deep.  The int8 MMA wants both operands k-contiguous; x is, w, u and v
// are not (their rows run along S or r), so each B fragment register is
// packed from four bytes of four consecutive staged rows.
//
// K6 splits C over CTAs when the (M, S) grid alone is too small to fill
// the card (decode): each split adds its int32 partial into the zeroed
// output with atomicAdd.  Integer sums are exact in any order, so the
// result does not depend on the schedule.
//
// K7 redoes the rank product for each column block, as the TPU grid does,
// but the 8 CTAs of a thread-block cluster (8 neighbouring column blocks,
// same rows) split C between them: each walks every 8th 64-deep chunk,
// leaves its int32 partial of t in shared memory, and after a cluster
// barrier each CTA sums one eighth of t's columns over the 8 partials
// (distributed shared memory) and writes them into all 8 CTAs' copies of t.
// Each CTA then takes the row max over the whole rank (requantization needs
// all of it, so a CTA cannot split r), requantizes t into shared memory
// with the padded ranks zero, and multiplies by its 64 columns of v_q (r
// padded to 32 with zero rows), loaded whole before the rank product
// starts.  Every float step is one IEEE operation in the TPU kernel's
// order (build without --use_fast_math), so the result matches the plain
// version bit for bit.  Next steps: TMA and a deeper pipeline.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace repro {
namespace i8 {

constexpr int kKC = 64;          // depth (bytes) of one stage: two k32 MMA steps
constexpr int kLdx = kKC + 16;   // smem row stride (bytes) of an x stage
constexpr int kLdb = kBN + 16;   // smem row stride (bytes) of a w / v tile
constexpr int kK6Threads = 128;  // 4 warps, 16 output columns each
constexpr int kK7Threads = 256;  // 8 warps
constexpr int kK7Warps = kK7Threads / 32;
constexpr int kK7Tiles = kRMax / 8 / kK7Warps;  // n8 tiles of t per warp
static_assert(kBM == 16 && kBN == 64, "fragment mapping assumes 16 x 64 CTA tiles");
static_assert(kBM == 2 * kK7Warps, "each K7 warp requantizes two rows");

// --------------------------------------------------------------------------
// Stage fills (zero past the edges)
// --------------------------------------------------------------------------

// xs[kBM][kLdx] = x[m0:m0+kBM, c0:c0+kKC]
__device__ inline void fill_x(const int8_t* __restrict__ x, int M, int C, int m0, int c0,
                              bool vec, int8_t* xs) {
  if (vec) {
    for (int q = threadIdx.x; q < kBM * kKC / 16; q += blockDim.x) {
      const int row = q / (kKC / 16), col = (q % (kKC / 16)) * 16;
      const int m = m0 + row, c = c0 + col;
      const int bytes = m < M ? max(0, min(16, C - c)) : 0;
      cp_async16(xs + row * kLdx + col, bytes ? x + (size_t)m * C + c : x, bytes);
    }
    return;
  }
  for (int i = threadIdx.x; i < kBM * kKC; i += blockDim.x) {
    const int row = i / kKC, col = i % kKC;
    const int m = m0 + row, c = c0 + col;
    xs[row * kLdx + col] = (m < M && c < C) ? x[(size_t)m * C + c] : (int8_t)0;
  }
}

// bs[rows][kLdb] = b[k0:k0+rows, n0:n0+kBN] of a row-major (K, S) matrix
__device__ inline void fill_tile(const int8_t* __restrict__ b, int K, int S, int k0, int n0,
                                 int rows, bool vec, int8_t* bs) {
  if (vec) {
    for (int q = threadIdx.x; q < rows * (kBN / 16); q += blockDim.x) {
      const int row = q / (kBN / 16), col = (q % (kBN / 16)) * 16;
      const int k = k0 + row, n = n0 + col;
      const int bytes = k < K ? max(0, min(16, S - n)) : 0;
      cp_async16(bs + row * kLdb + col, bytes ? b + (size_t)k * S + n : b, bytes);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * kBN; i += blockDim.x) {
    const int row = i / kBN, col = i % kBN;
    const int k = k0 + row, n = n0 + col;
    bs[row * kLdb + col] = (k < K && n < S) ? b[(size_t)k * S + n] : (int8_t)0;
  }
}

// Bytes of one K7 u stage: kKC rows of u, rounded to 16.
__host__ __device__ inline int u_stage_bytes(int r) { return round_up(kKC * r, 16); }

// us[0 .. rows*r) = u rows [c0, c0+rows) as they lie in memory (row-major,
// one contiguous span).  Vector copies may run up to 15 bytes past the span
// (into the next rows, never past the end of u); those are not read.
__device__ inline void fill_flat(const int8_t* __restrict__ u, int C, int r, int c0, bool vec,
                                 int8_t* us) {
  const size_t start = (size_t)c0 * r, total = (size_t)C * r;
  const int n = min(kKC, C - c0) * r;
  if (vec) {
    for (int q = threadIdx.x; q < (n + 15) / 16; q += blockDim.x) {
      const size_t e = start + (size_t)q * 16;
      cp_async16(us + q * 16, u + e, (int)min((size_t)16, total - e));
    }
    return;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) us[i] = u[start + i];
}

// --------------------------------------------------------------------------
// Fragments and the MMA
// --------------------------------------------------------------------------

// A (16 x 32, k-contiguous rows, row stride ld bytes): a0/a1 rows g / g+8
// at k 4t..4t+3, a2/a3 the same rows at k 16+4t..16+4t+3.
__device__ inline void a_frag(const int8_t* s, int ld, int k0, int g, int t, unsigned (&a)[4]) {
  const unsigned* w = reinterpret_cast<const unsigned*>(s);
  const int c = k0 + 4 * t;
  a[0] = w[(g * ld + c) / 4];
  a[1] = w[((g + 8) * ld + c) / 4];
  a[2] = w[(g * ld + c + 16) / 4];
  a[3] = w[((g + 8) * ld + c + 16) / 4];
}

// Four bytes p[0], p[ld], p[2 ld], p[3 ld] (four rows of one column),
// the first in the low byte.
__device__ inline unsigned pack_col(const int8_t* p, int ld) {
  return (unsigned)(uint8_t)p[0] | ((unsigned)(uint8_t)p[ld] << 8) |
         ((unsigned)(uint8_t)p[2 * ld] << 16) | ((unsigned)(uint8_t)p[3 * ld] << 24);
}

// The same from a flat stage of u (row stride r), rows at or past `rows`
// read as zero.
__device__ inline unsigned pack_flat(const int8_t* us, int r, int k, int n, int rows) {
  unsigned out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < rows) out |= (unsigned)(uint8_t)us[(k + i) * r + n] << (8 * i);
  return out;
}

// d += A (16x32 s8, row) * B (32x8 s8, col), exact int32.
__device__ inline void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --------------------------------------------------------------------------
// K6
// --------------------------------------------------------------------------

// CTA (blockIdx.x, blockIdx.y) owns columns [64 x, 64 x + 64) and rows
// [16 y, 16 y + 16); blockIdx.z is its split of C: chunks [z per, z per + per).
__global__ void __launch_bounds__(kK6Threads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   int* __restrict__ y, int M, int C, int S, int per, int atomic) {
  __shared__ __align__(128) int8_t xring[kStages][kBM * kLdx];
  __shared__ __align__(128) int8_t wring[kStages][kKC * kLdb];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int nchunks = (C + kKC - 1) / kKC;
  const int first = blockIdx.z * per;
  const int n = min(per, nchunks - first);
  const bool xv = aligned16(x) && C % 16 == 0;
  const bool wv = aligned16(w) && S % 16 == 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  int acc[2][4] = {};  // this warp's n8 tiles: columns 16 warp + 8 f

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) {
      const int c0 = (first + s) * kKC;
      fill_x(x, M, C, m0, c0, xv, xring[s]);
      fill_tile(w, C, S, c0, n0, kKC, wv, wring[s]);
    }
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk i landed for all; stage (i-1) % kStages is free
    const int ni = i + kStages - 1;
    if (ni < n) {
      const int c0 = (first + ni) * kKC;
      fill_x(x, M, C, m0, c0, xv, xring[ni % kStages]);
      fill_tile(w, C, S, c0, n0, kKC, wv, wring[ni % kStages]);
    }
    cp_async_commit();
    const int8_t* xs = xring[i % kStages];
    const int8_t* ws = wring[i % kStages];
#pragma unroll
    for (int k0 = 0; k0 < kKC; k0 += 32) {
      unsigned a[4];
      a_frag(xs, kLdx, k0, g, t, a);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int8_t* p = ws + (k0 + 4 * t) * kLdb + warp * 16 + f * 8 + g;
        mma_s8(acc[f], a, pack_col(p, kLdb), pack_col(p + 16 * kLdb, kLdb));
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int col = n0 + warp * 16 + f * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e >= S) continue;
        int* dst = y + (size_t)m * S + col + e;
        if (atomic)
          atomicAdd(dst, acc[f][2 * h + e]);
        else
          *dst = acc[f][2 * h + e];
      }
    }
  }
}

// --------------------------------------------------------------------------
// K7
// --------------------------------------------------------------------------

struct K7Smem {
  size_t xring, uring, t32, tq, ts, vblk, total;
};

// rk = round_up(r, 32): t's columns as the second product's depth
__host__ __device__ inline K7Smem k7_layout(int r) {
  const int rk = round_up(r, 32);
  K7Smem s;
  size_t off = 0;
  s.xring = off; off = align128(off + (size_t)kStages * kBM * kLdx);
  // the u ring; once drained, it holds this CTA's int32 partial of t
  const size_t ring = (size_t)kStages * u_stage_bytes(r), part = sizeof(int) * kBM * rk;
  s.uring = off; off = align128(off + (ring > part ? ring : part));
  s.t32 = off; off = align128(off + sizeof(int) * kBM * rk);
  s.tq = off; off = align128(off + (size_t)kBM * (rk + 16));
  s.ts = off; off = align128(off + sizeof(float) * kBM);
  s.vblk = off; off = align128(off + (size_t)rk * kLdb);
  s.total = off;
  return s;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kK7Threads)
int8_lowrank_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ u,
                    const float* __restrict__ u_scale, const int8_t* __restrict__ v,
                    const float* __restrict__ v_scale, float* __restrict__ y,
                    int M, int C, int r, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int rk = round_up(r, 32), ldq = rk + 16;
  const K7Smem L = k7_layout(r);
  int8_t* xring = reinterpret_cast<int8_t*>(smem + L.xring);
  int8_t* uring = reinterpret_cast<int8_t*>(smem + L.uring);
  int* t32 = reinterpret_cast<int*>(smem + L.t32);
  int8_t* tq = reinterpret_cast<int8_t*>(smem + L.tq);
  float* tsm = reinterpret_cast<float*>(smem + L.ts);
  int8_t* vb = reinterpret_cast<int8_t*>(smem + L.vblk);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool xv = aligned16(x) && C % 16 == 0;
  const bool uv = aligned16(u);  // a stage starts at 64 r bytes: 16-byte aligned
  const bool vv = aligned16(v) && S % 16 == 0;
  const int ustride = u_stage_bytes(r);
  const int ntiles = rk / 8;
  const int nchunks = (C + kKC - 1) / kKC;
  const int nloc = nchunks > q ? (nchunks - q + kCluster - 1) / kCluster : 0;

  // v_q's rows for this CTA's columns do not depend on t: request them all
  // now (they join the first stage's copy group)
  fill_tile(v, r, S, 0, n0, rk, vv, vb);

  // 1. int32 t = x_q u_q over this CTA's chunks of C (chunk q + 8 i)
  int acc[kK7Tiles][4];
#pragma unroll
  for (int f = 0; f < kK7Tiles; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nloc) {
      const int c0 = (q + s * kCluster) * kKC;
      fill_x(x, M, C, m0, c0, xv, xring + s * kBM * kLdx);
      fill_flat(u, C, r, c0, uv, uring + s * ustride);
    }
    cp_async_commit();
  }
  for (int i = 0; i < nloc; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk i landed for all; stage (i-1) % kStages is free
    const int ni = i + kStages - 1;
    if (ni < nloc) {
      const int c0 = (q + ni * kCluster) * kKC;
      fill_x(x, M, C, m0, c0, xv, xring + (ni % kStages) * kBM * kLdx);
      fill_flat(u, C, r, c0, uv, uring + (ni % kStages) * ustride);
    }
    cp_async_commit();
    const int8_t* xs = xring + (i % kStages) * kBM * kLdx;
    const int8_t* us = uring + (i % kStages) * ustride;
    const int rows = min(kKC, C - (q + i * kCluster) * kKC);
#pragma unroll
    for (int k0 = 0; k0 < kKC; k0 += 32) {
      unsigned a[4];
      a_frag(xs, kLdx, k0, g, t, a);
      const int kb = k0 + 4 * t;  // this thread's B rows: kb..kb+3, kb+16..kb+19
#pragma unroll
      for (int f = 0; f < kK7Tiles; ++f) {
        const int j = warp + f * kK7Warps;
        if (j < ntiles) {
          const int n = j * 8 + g;
          unsigned b0 = 0, b1 = 0;
          if (n < r) {
            b0 = pack_flat(us, r, kb, n, rows);
            b1 = pack_flat(us, r, kb + 16, n, rows);
          }
          mma_s8(acc[f], a, b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained (and v_q landed): it now holds the partial

  int* part = reinterpret_cast<int*>(uring);  // [kBM][rk] int32
#pragma unroll
  for (int f = 0; f < kK7Tiles; ++f) {
    const int j = warp + f * kK7Warps;
    if (j < ntiles) {
      const int col = j * 8 + 2 * t;
      part[g * rk + col] = acc[f][0];
      part[g * rk + col + 1] = acc[f][1];
      part[(g + 8) * rk + col] = acc[f][2];
      part[(g + 8) * rk + col + 1] = acc[f][3];
    }
  }
  cluster.sync();  // every partial is written

  // CTA q sums columns [q w, (q+1) w) of t over the cluster's partials and
  // writes them into every CTA's t32 (integer sums: exact in any order)
  const int w = rk / kCluster;
  for (int e = threadIdx.x; e < kBM * w; e += blockDim.x) {
    const int row = e / w, col = q * w + e % w;
    int sum = 0;
#pragma unroll
    for (int p = 0; p < kCluster; ++p) sum += cluster.map_shared_rank(part, p)[row * rk + col];
#pragma unroll
    for (int p = 0; p < kCluster; ++p) cluster.map_shared_rank(t32, p)[row * rk + col] = sum;
  }
  cluster.sync();  // t32 complete everywhere; no partial is read any more

  // 2-4. rescale, row max over the whole rank, requantize (warp: 2 rows)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 2 + h;
    float mx = 0.0f;
    for (int col = lane; col < r; col += 32)
      mx = fmaxf(mx, fabsf((float)t32[row * rk + col] * u_scale[col]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float ts = fmaxf(mx, 1e-8f) / 127.0f;
    if (lane == 0) tsm[row] = ts;
    for (int col = lane; col < rk; col += 32) {
      float qv = 0.0f;
      if (col < r) {
        const float tv = (float)t32[row * rk + col] * u_scale[col];
        qv = fminf(fmaxf(rintf(tv / ts), -127.0f), 127.0f);
      }
      tq[row * ldq + col] = (int8_t)(int)qv;
    }
  }
  __syncthreads();

  // 5. y = int32(tq v_q) for this warp's 8 columns, then (y * ts) * v_scale
  int acc2[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < rk; k0 += 32) {
    unsigned a[4];
    a_frag(tq, ldq, k0, g, t, a);
    const int8_t* p = vb + (k0 + 4 * t) * kLdb + warp * 8 + g;
    mma_s8(acc2, a, pack_col(p, kLdb), pack_col(p + 16 * kLdb, kLdb));
  }
  const int col = n0 + warp * 8 + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + g + 8 * h;
    if (m >= M) continue;
    const float ts = tsm[g + 8 * h];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (col + e < S)
        y[(size_t)m * S + col + e] = ((float)acc2[2 * h + e] * ts) * v_scale[col + e];
  }
}

// --------------------------------------------------------------------------
// Launches
// --------------------------------------------------------------------------

inline cudaError_t launch_k6(const int8_t* x, const int8_t* w, int* y, int M, int C, int S,
                             cudaStream_t stream) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int gx = (S + kBN - 1) / kBN, gy = (M + kBM - 1) / kBM;
  if (gy > 65535) return cudaErrorInvalidValue;
  const int nchunks = (C + kKC - 1) / kKC;
  // split C until the grid holds about two CTAs per SM
  const long ctas = (long)gx * gy;
  int splits = (int)std::min<long>(nchunks, std::max<long>(1, (2L * sms + ctas - 1) / ctas));
  const int per = (nchunks + splits - 1) / splits;
  splits = (nchunks + per - 1) / per;
  if (splits > 1) {
    cudaError_t e = cudaMemsetAsync(y, 0, sizeof(int) * (size_t)M * S, stream);
    if (e != cudaSuccess) return e;
  }
  int8_matmul_kernel<<<dim3(gx, gy, splits), kK6Threads, 0, stream>>>(x, w, y, M, C, S, per,
                                                                      splits > 1);
  return cudaGetLastError();
}

inline cudaError_t launch_k7(const int8_t* x, const int8_t* u, const float* us,
                             const int8_t* v, const float* vs, float* y, int M, int C, int r,
                             int S, cudaStream_t stream) {
  const size_t smem = k7_layout(r).total;
  static size_t reserved = 0;
  cudaError_t e = reserve_smem(int8_lowrank_kernel, smem, &reserved);
  if (e != cudaSuccess) return e;
  // column blocks past S (up to a whole cluster) share the rank product
  // and store nothing
  const dim3 grid(round_up((S + kBN - 1) / kBN, kCluster), (M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  int8_lowrank_kernel<<<grid, kK7Threads, smem, stream>>>(x, u, us, v, vs, y, M, C, r, S);
  return cudaGetLastError();
}

}  // namespace i8
}  // namespace repro

extern "C" {

// y (M, S) int32 = x (M, C) int8 @ w (C, S) int8, row-major and contiguous.
// Launches on `stream` and returns the cudaError_t of the launch.
int repro_int8_matmul(const void* x, const void* w, void* y, int M, int C, int S,
                      void* stream) {
  if (M <= 0 || S <= 0) return 0;
  if (C <= 0) return (int)cudaErrorInvalidValue;
  return (int)repro::i8::launch_k6((const int8_t*)x, (const int8_t*)w, (int*)y, M, C, S,
                                   (cudaStream_t)stream);
}

// y (M, S) float32 = K7 of x (M, C), u (C, r), u_scale (1, r), v (r, S),
// v_scale (1, S): int8 operands, float32 scales, all contiguous.
int repro_int8_lowrank_matmul(const void* x, const void* u, const void* u_scale,
                              const void* v, const void* v_scale, void* y, int M, int C,
                              int r, int S, void* stream) {
  if (M <= 0 || S <= 0) return 0;
  if (C <= 0 || r <= 0 || r > repro::kRMax) return (int)cudaErrorInvalidValue;
  return (int)repro::i8::launch_k7((const int8_t*)x, (const int8_t*)u, (const float*)u_scale,
                                   (const int8_t*)v, (const float*)v_scale, (float*)y, M, C,
                                   r, S, (cudaStream_t)stream);
}

const char* repro_int8_matmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

const char* repro_int8_lowrank_matmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
