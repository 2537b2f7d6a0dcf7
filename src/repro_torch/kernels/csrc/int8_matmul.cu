// K6 and K7: int8 x int8 -> int32 serving matmuls on int8 tensor cores
// (mma.sync m16n8k32 .s32.s8.s8.s32, exact int32 accumulation, no
// .satfinite: |sum| <= C * 127^2, which is below 2^31 for every depth the
// wrappers take, C * 127^2 < 2^31, i.e. C <= 133,144; the widest served,
// llama-3.2-vision's FFN down at C = 28672, sums to at most 4.6e8.  K7's
// second product has depth r <= 4096).
//
//   K6  y_i32 = x_q @ w_q                         x_q (M,C), w_q (C,S) -> int32 (M,S)
//   K7  t     = float(x_q @ u_q) * u_scale        x_q (M,C), u_q (C,r), u_scale (1,r)
//       ts    = max(max_row |t|, 1e-8) / 127      per row, over the whole r
//       tq    = clamp(rint(t / ts), -127, 127)    int8, round half to even
//       y     = (float(tq @ v_q) * ts) * v_scale  v_q (r,S), v_scale (1,S) -> f32 (M,S)
//
// Replaces the TPU kernels of src/repro/kernels/int8_matmul.py:
// int8_matmul (:86, `_dense_kernel`) and int8_lowrank_matmul (:142,
// `_lowrank_kernel`, whose t never leaves VMEM).  Those take x already
// quantized; the JAX dispatchers quantize x per row and scale the output
// outside the kernel.  Here each kernel has two entries, one body with a
// template flag: the TPU contract (int8 x in, int32 / float32 in x_q's
// units out) and the fused serving entry, which takes x itself (bf16 or
// float32) and returns the layer's output in x's dtype:
//
//   x_scale = max(max_row |float(x)| / 127, 1e-8)  (one IEEE division)
//   x_q     = clamp(rint(float(x) / x_scale), -127, 127)
//   K6      y = (float(acc) * x_scale) * w_scale
//   K7      y = (((float(tq @ v_q) * ts) * v_scale) * x_scale)
//
// every float step one IEEE operation in the plain version's order
// (kernels/ref.py; build without --use_fast_math), so both entries match
// their plain versions bit for bit.  A projection of the int8 export is
// one launch (K6) or two (K7), where a torch quantizer and the scaling
// cost about a dozen more.
//
// What bounds them on the H100: at the decode shapes (M = 8 slots, C and
// S up to 28672, r up to 3072) they do far fewer operations than the
// card's int8 ridge (~590 operations a byte), so the floor is the bytes of
// the int8 weights read from HBM (0.05 us at smollm's 128-rank groups, 34
// us at llama-3.2-vision's FFN).  At the small ones a call is latency: the
// launch, one or two dependent trips to memory, and whatever runs one after
// the other inside a CTA.  The design spreads each call over the whole card
// and keeps every trip in flight.  It was designed for M = 8 and 128; a
// prefill of thousands of rows runs on the same grid, one CTA a 16-row
// block, each reading its own tile of the factors.
//
// The product (gemm_body, both K6 and K7's phase 1): a CTA owns 16 rows of
// x and a tile of at most 32 columns of the int8 operand B (w or u), and
// the CTAs of a thread-block cluster split the depth C between them, each
// a contiguous slab of 128-row chunks.  B's chunks stream through a
// 4-stage ring (up to three chunks in flight, requested before anything
// else): by TMA where B's base and row pitch are 16-byte aligned (a box of
// 32 columns from the 16-byte boundary at or before the tile, so tiles of
// at most 16 columns too), else by element loads that zero-fill past the
// edges (u at r = 119, operands off a 16-byte boundary), issued behind the
// first loads of x so the two trips overlap.  The CTA's slab of x sits
// whole in shared memory, in int8.  In the fused entries each CTA takes
// its slab's row maxima, the cluster exchanges them through distributed
// shared memory (one cluster barrier, so every CTA holds each row's scale
// over the whole of C), and each CTA quantizes its slab from the registers
// its loads left, with the reciprocal of each row's scale, taking the IEEE
// division only where the product lies next to a half-integer (quant: the
// same integers as the division, without its long dependent chain on every
// value).  Four warps each take every fourth 32-deep step.  Their int32
// partials meet in shared memory; each CTA then pushes its sums into the
// shared memory of the cluster rank that owns them (distributed shared
// memory), and after one cluster barrier each owner adds up and stores
// its share: integer sums, exact in any order, and no memset, atomic or
// global partial.
//
// K7 computes its rank product once per call on that body (phase 1: tiles
// of r narrow enough that the cluster split of C and r's tiles give about
// one wave at M = 8) into an int32 scratch that the wrapper allocates,
// with the x scales beside it.  Phase 2 is a programmatic dependent: each
// CTA requests its tile of v (at most 32 columns of S, narrow enough for a
// wave at M = 8) before it waits on phase 1, then reads its rows of t,
// takes each row's max over the whole rank (requantization needs all of
// it), requantizes into shared memory and multiplies.  So u crosses the
// card once a call, and no CTA waits on another's rank product.  Up to
// r = 512 a row's ranks sit in its 8 threads' registers; past that the
// rank is walked in pieces of 512, one pass for the max and a second,
// which reads t again from L2, for the requantization (the same integers
// in any order, so both entries keep their bits).  At r = 4096 the v tile
// (4096 x 32 bytes) and the tq slab (16 x 4112) take 201 KB of the 227 KB
// a CTA may hold.
//
// Fragments: the MMA wants B k-contiguous in each register; w, u and v lie
// with their rows along S or r (and the export keeps that layout), so each
// thread loads four 32-bit words from four rows and transposes the 4 x 4
// bytes with __byte_perm, which gives it one register of each of four n8
// tiles.  Thread (g, t) reads rows t, t+4, t+8, t+12 of a 16-row half (no
// bank conflicts at a 32-byte row pitch), so the k order inside each
// 16-deep group is permuted; x (or tq) is written to shared memory in the
// same permuted order, and the sum over k is unchanged.
//
// The plans (cluster size, chunks a CTA, tile widths) come from the wrapper
// (kernels/int8_matmul.py, mirrored by the CPU tests); the launch checks
// them.  Nothing is kept across calls: every launch writes all it reads.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace i8 {

constexpr int kW = 32;                 // columns of a B tile in shared memory (bytes)
constexpr int kWarpsG = 4;             // warps of a CTA, each every 4th k32 step
constexpr int kThreadsG = 32 * kWarpsG;
constexpr int kKC = 32 * kWarpsG;      // rows of B a ring stage (one k32 step a warp)
constexpr int kRing = 4;               // ring stages
constexpr int kStage = kKC * kW;       // bytes of a stage
constexpr int kClusterMax = 8;
constexpr int kPerMax = 80;            // chunks a CTA (its x slab must fit in shared memory)
constexpr int kHold = 4;               // x items a thread keeps in registers (16 values each)
constexpr int kPiece = kHold * 8 * 16;  // ranks of a piece of K7's requantization (8 threads a row)
static_assert(kBM == 16, "a CTA owns one m16 row tile");
static_assert(kPiece == 512, "K7's requantization walks the rank in pieces of 512");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// --------------------------------------------------------------------------
// Fragments and the MMA
// --------------------------------------------------------------------------

// Bytes j of r0..r3 -> word j, r0's byte lowest: a 4 x 4 byte transpose.
__device__ inline uint4 transpose4(unsigned r0, unsigned r1, unsigned r2, unsigned r3) {
  const unsigned t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
  const unsigned t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
  return make_uint4(__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                    __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632));
}

// d += A (16x32 s8, row) * B (32x8 s8, col), exact int32.
__device__ inline void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[f] += A[0:16, kx:kx+32] @ B[0:32, cols of tile f]: A in MMA order with
// row pitch lda (a multiple of 16 that is 16 mod 32, so the A loads miss
// no bank), B 32 rows of kW bytes.  n8 tile f's column j is B's column
// 4 j + f, so acc[f] = {(g, 8t+f), (g, 8t+4+f), (g+8, 8t+f), (g+8, 8t+4+f)}.
__device__ inline void mma_step(const int8_t* a, int lda, int kx, const unsigned char* b,
                                int g, int t, int (&acc)[4][4]) {
  const unsigned* aw = reinterpret_cast<const unsigned*>(a + kx) + t;
  const unsigned af[4] = {aw[g * lda / 4], aw[(g + 8) * lda / 4], aw[g * lda / 4 + 4],
                          aw[(g + 8) * lda / 4 + 4]};
  const unsigned* bw = reinterpret_cast<const unsigned*>(b) + g;
  constexpr int r = kW / 4;  // words a row
  const uint4 lo = transpose4(bw[t * r], bw[(t + 4) * r], bw[(t + 8) * r], bw[(t + 12) * r]);
  const uint4 hi =
      transpose4(bw[(t + 16) * r], bw[(t + 20) * r], bw[(t + 24) * r], bw[(t + 28) * r]);
  mma_s8(acc[0], af, lo.x, hi.x);
  mma_s8(acc[1], af, lo.y, hi.y);
  mma_s8(acc[2], af, lo.z, hi.z);
  mma_s8(acc[3], af, lo.w, hi.w);
}

// This warp's accumulators into part[16][kW] (column order of mma_step).
__device__ inline void store_partial(int* part, const int (&acc)[4][4], int g, int t) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    part[g * kW + 8 * t + f] = acc[f][0];
    part[g * kW + 8 * t + 4 + f] = acc[f][1];
    part[(g + 8) * kW + 8 * t + f] = acc[f][2];
    part[(g + 8) * kW + 8 * t + 4 + f] = acc[f][3];
  }
}

// --------------------------------------------------------------------------
// Loads
// --------------------------------------------------------------------------

__device__ inline void store_as(float* p, float v) { *p = v; }
__device__ inline void store_as(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// x_q[m, k:k+16] as four words (k = 4 j + i in byte i of word j), zero past M and K.
__device__ inline uint4 load16_i8(const int8_t* __restrict__ x, int M, int K, int m, int k,
                                  bool vec) {
  if (m >= M) return make_uint4(0, 0, 0, 0);
  const int8_t* p = x + (size_t)m * K + k;
  if (vec && k + 16 <= K) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll 1
  for (int i = 0; i < 16; ++i)  // the rare path: one copy of the code
    if (k + i < K) w[i / 4] |= (unsigned)(uint8_t)p[i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x[m, k:k+16] as the raw bits of its values, zero past M and K (16 *
// sizeof(T) bytes: what a batch keeps in flight before it reads any).
template <typename T>
__device__ inline void load_raw16(const T* __restrict__ x, int M, int K, int m, int k, bool vec,
                                  uint4 (&w)[sizeof(T)]) {
  if (m < M && vec && k + 16 <= K) {
    const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
#pragma unroll
    for (int j = 0; j < (int)sizeof(T); ++j) w[j] = __ldg(p + j);
    return;
  }
  using U = typename std::conditional<sizeof(T) == 2, unsigned short, unsigned>::type;
  constexpr int kPerWord = 4 / sizeof(T);
  const U* p = reinterpret_cast<const U*>(x + (size_t)m * K + k);
  unsigned words[4 * sizeof(T)] = {};
#pragma unroll 1
  for (int i = 0; i < 16; ++i)  // the rare path: one copy of the code
    if (m < M && k + i < K)
      words[i / kPerWord] |= (unsigned)p[i] << (8 * sizeof(T) * (i % kPerWord));
#pragma unroll
  for (int j = 0; j < (int)sizeof(T); ++j)
    w[j] = make_uint4(words[4 * j], words[4 * j + 1], words[4 * j + 2], words[4 * j + 3]);
}

// The float bits of max |x| over load_raw16's values: non-negative floats
// (and bf16s) order as their bits do.
template <typename T>
__device__ inline unsigned absmax_bits(const uint4 (&w)[sizeof(T)]) {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < (int)sizeof(T); ++j) {
    const unsigned v[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (sizeof(T) == 2)
        m = max(m, max(v[i] & 0x7fffu, (v[i] >> 16) & 0x7fffu));
      else
        m = max(m, v[i] & 0x7fffffffu);
    }
  }
  return sizeof(T) == 2 ? m << 16 : m;
}

// 1 / s to within one ulp (one MUFU instruction)
__device__ inline float rcp_approx(float s) {
  float r;
  asm("rcp.approx.f32 %0, %1;\n" : "=f"(r) : "f"(s));
  return r;
}

// load_raw16's values as floats (exact: bf16 is float's upper half)
template <typename T>
__device__ inline void raw_to_float(const uint4 (&w)[sizeof(T)], float (&v)[16]) {
#pragma unroll
  for (int j = 0; j < (int)sizeof(T); ++j) {
    const unsigned u[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (sizeof(T) == 2) {
        v[8 * j + 2 * i] = __uint_as_float(u[i] << 16);
        v[8 * j + 2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      } else {
        v[4 * j + i] = __uint_as_float(u[i]);
      }
    }
  }
}

// q[i] = clamp(rint(v[i] / s), -127, 127) with v[i] / s the IEEE quotient,
// from rs = rcp_approx(s): v * rs lies within 2^-22 of v / s relative, so
// it rounds to the same integer unless it lies within 2^-20 of a
// half-integer.  Those values (rare) take the division, after the rest: a
// division is a long dependent chain, so the common path has none and no
// branch, and the N values are independent.  Rounding to the nearest
// integer, ties to even, is the add of 1.5 * 2^23 (|v * rs| < 2^22): the
// integer is in the sum's low bits, all on the full-rate float and integer
// pipes.
// quant's rare path, out of line so the kernels carry one copy of the
// division: q[i] = clamp(rint(v[i] / s)) for the set bits i of `slow`
__device__ __noinline__ void quant_fix(const float* v, int* q, float s, unsigned slow) {
  while (slow) {
    const int i = __ffs(slow) - 1;
    slow &= slow - 1;
    q[i] = (int)rintf(fminf(fmaxf(__fdiv_rn(v[i], s), -127.0f), 127.0f));
  }
}

template <int N>
__device__ inline void quant(const float (&v)[N], float s, float rs, int (&q)[N]) {
  constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
  unsigned slow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float qa = v[i] * rs, big = qa + kMagic;
    q[i] = __float_as_int(big) - __float_as_int(kMagic);
    const float frac = fabsf(qa - (big - kMagic));  // distance to that integer, <= 0.5
    slow |= (unsigned)(0.5f - frac <= 0x1p-20f * fmaxf(fabsf(qa), 1.0f)) << i;
  }
  if (slow) {  // copies, so that v and q stay in registers on the common path
    float vt[N];
    int qt[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      vt[i] = v[i];
      qt[i] = q[i];
    }
    quant_fix(vt, qt, s, slow);
#pragma unroll
    for (int i = 0; i < N; ++i) q[i] = qt[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) q[i] = min(max(q[i], -127), 127);
}

// dst[rows][kW] = B[k0:k0+rows, n0:n0+w] of a row-major (K, N) int8 matrix,
// zero past K, N and w, by element loads (the path TMA cannot take).  A
// thread owns one column and takes its 32 rows of each 128 in one batch,
// so a stage costs one trip to memory.  rows: a multiple of kKC.
__device__ inline void fill_elems(const int8_t* __restrict__ b, int K, int N, int k0, int n0,
                                  int w, int rows, unsigned char* dst) {
  constexpr int kStep = kThreadsG / kW, kBatch = kKC / kStep;  // rows apart, rows a batch
  const int col = threadIdx.x % kW, n = n0 + col;
  const bool live = col < w && n < N;
  for (int r0 = threadIdx.x / kW; r0 < rows; r0 += kKC) {
    unsigned char v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int k = k0 + r0 + j * kStep;
      v[j] = (live && k < K) ? (unsigned char)__ldg(b + (size_t)k * N + n) : 0;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) dst[(r0 + j * kStep) * kW + col] = v[j];
  }
}

__device__ inline void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ inline void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// --------------------------------------------------------------------------
// The product: K6, and K7's phase 1
// --------------------------------------------------------------------------

struct GemmArgs {
  const void* x;        // (M, K): int8, or T in the fused entries
  const int8_t* b;      // (K, N) int8: w (K6) or u (K7)
  const float* bscale;  // (1, N): K6's w_scale in the fused entry
  void* y;              // K6: (M, N) int32, or T fused; K7: t (M, N) int32
  float* xscale;        // K7 fused: (M) x scales for phase 2
  int M, K, N;
  int w;                // columns of a CTA's tile (<= kW)
  int per;              // chunks of kKC rows a CTA
  int tma;              // B read by TMA
  int xvec;             // x rows 16-byte aligned
};

__host__ __device__ inline int gemm_ldx(int per) { return per * kKC + 16; }
constexpr int kRecv = kClusterMax * kBM * kW;  // ints of partial sums a CTA receives
__host__ __device__ inline size_t gemm_smem(int per) {
  return (size_t)kRing * kStage + (size_t)kBM * gemm_ldx(per) +
         sizeof(int) * (kWarpsG * kBM * kW + kRecv) +
         (3 * kBM + kW) * 4 + kRing * 8;
}

// CTA (q, tile, row block) = (cluster rank, blockIdx.y, blockIdx.z): rows
// [16 z, 16 z + 16), B's columns [w y, w y + w), chunks [q per, q per + per).
// kK7: t (int32) out, plus x's scales when T quantizes; else K6: int32
// (T = int8_t) or the scaled output in T.
template <bool kK7, typename T>
__device__ inline void gemm_body(const GemmArgs& a, const CUtensorMap* bmap) {
  constexpr bool kQuant = !std::is_same<T, int8_t>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int n0 = blockIdx.y * a.w, m0 = blockIdx.z * kBM;
  // TMA boxes start 16-byte aligned: the tile sits `off` columns into its box
  const int nb = a.tma ? n0 & ~15 : n0, off = n0 - nb;
  const int nchunks = cdiv(a.K, kKC), first = q * a.per;
  const int n = min(a.per, nchunks - first);  // >= 1 by the plan
  const int ldx = gemm_ldx(a.per);
  unsigned char* ring = smem;
  int8_t* xs = reinterpret_cast<int8_t*>(smem + kRing * kStage);
  int* part = reinterpret_cast<int*>(xs + kBM * ldx);  // [kWarpsG][kBM][kW]: the warps' sums
  int* recv = part + kWarpsG * kBM * kW;  // [rank][kBM * kW]: the cluster's sums pushed here
  float* amax = reinterpret_cast<float*>(recv + kRecv);
  float* xsc = amax + kBM;  // x's row scales
  float* xrc = xsc + kBM;   // their reciprocals (rcp_approx)
  float* bsc = xrc + kBM;   // the fused K6's w_scale of this tile
  uint64_t* bar = reinterpret_cast<uint64_t*>(bsc + kW);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  if (threadIdx.x == 0 && a.tma) {
    for (int s = 0; s < kRing; ++s) mbar_init(bar + s, 1);
    mbar_fence_init();
    prefetch_map(bmap);
  }
  // the fused K6's w_scale: needed last, requested first (cp.async)
  if (!kK7 && kQuant && threadIdx.x < kW) {
    if (threadIdx.x < a.w && n0 + threadIdx.x < a.N) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(bsc + threadIdx.x)),
                   "l"(a.bscale + n0 + threadIdx.x));
    } else {
      bsc[threadIdx.x] = 0.0f;
    }
    cp_async_commit();
  }
  __syncthreads();
  if (!kQuant) cluster_arrive();  // this CTA runs; waited on before the first remote write
  if (kK7) grid_dependents_may_launch();  // phase 2 may start and fetch v

  // B's chunk i of this CTA into its stage (TMA: one thread; else all)
  auto fill = [&](int i) {
    unsigned char* dst = ring + (i % kRing) * kStage;
    const int k0 = (first + i) * kKC;
    if (a.tma) {
      if (threadIdx.x == 0) {
        mbar_arrive_tx(bar + i % kRing, kStage);
        tma_load_2d(dst, bmap, nb, k0, bar + i % kRing);
      }
    } else {
      fill_elems(a.b, a.K, a.N, k0, n0, a.w, kKC, dst);
    }
  };
  auto fill_first = [&]() {
    for (int i = 0; i < kRing - 1 && i < n; ++i) fill(i);
  };
  if (a.tma) fill_first();

  // this CTA's slab of x (columns [c0, c0 + 128 n)) into xs, in MMA order:
  // 8 threads a row, a thread's item i the 16 columns from 16 (cg + 8 i)
  const int c0 = first * kKC, row = threadIdx.x >> 3, cg = threadIdx.x & 7;
  auto col_of = [&](int i) { return (cg + 8 * i) * 16; };
  if constexpr (!kQuant) {
    if (!a.tma) fill_first();
    const int8_t* x = static_cast<const int8_t*>(a.x);
    for (int i0 = 0; i0 < n; i0 += kHold) {
      uint4 v[kHold];
#pragma unroll
      for (int j = 0; j < kHold; ++j)
        if (i0 + j < n) v[j] = load16_i8(x, a.M, a.K, m0 + row, c0 + col_of(i0 + j), a.xvec);
#pragma unroll
      for (int j = 0; j < kHold; ++j)
        if (i0 + j < n)
          *reinterpret_cast<uint4*>(xs + row * ldx + col_of(i0 + j)) =
              transpose4(v[j].x, v[j].y, v[j].z, v[j].w);
    }
  } else {
    const T* x = static_cast<const T*>(a.x);
    // the slab's row maxima (its values kept as they came, kHold items a
    // thread; B's first element fills issued behind the first loads), then
    // every row's max over the cluster's slabs, i.e. the whole of C, through
    // distributed shared memory
    uint4 raw[kHold][sizeof(T)];
    unsigned mx = 0;  // max |x| over this thread's items, as float bits
    for (int i0 = 0; i0 < n; i0 += kHold) {
#pragma unroll
      for (int j = 0; j < kHold; ++j)
        if (i0 + j < n) load_raw16(x, a.M, a.K, m0 + row, c0 + col_of(i0 + j), a.xvec, raw[j]);
      if (i0 == 0 && !a.tma) fill_first();
#pragma unroll
      for (int j = 0; j < kHold; ++j)
        if (i0 + j < n) mx = max(mx, absmax_bits<T>(raw[j]));
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (cg == 0) amax[row] = __uint_as_float(mx);  // the row's 8 threads share a warp
    __syncthreads();
    cluster_arrive();
    cluster_wait();  // every CTA's slab maxima are in (and every CTA runs)
    if (threadIdx.x < kBM) {
      float rank_max[kClusterMax];  // every remote load in flight at once
#pragma unroll
      for (int p = 0; p < kClusterMax; ++p)
        rank_max[p] = p < cs ? cluster.map_shared_rank(amax, p)[threadIdx.x] : 0.0f;
      float row_max = 0.0f;
#pragma unroll
      for (int p = 0; p < kClusterMax; ++p) row_max = fmaxf(row_max, rank_max[p]);
      const float scale = fmaxf(row_max / 127.0f, 1e-8f);
      xsc[threadIdx.x] = scale;
      xrc[threadIdx.x] = rcp_approx(scale);
      if (kK7 && q == 0 && blockIdx.y == 0 && m0 + threadIdx.x < a.M)
        a.xscale[m0 + threadIdx.x] = scale;
    }
    __syncthreads();
    // quantize the slab: from the registers when it fits (decode), else
    // read again (this CTA's own reads: L1)
    const float sc = xsc[row], rc = xrc[row];
    for (int i0 = 0; i0 < n; i0 += kHold) {
      if (n > kHold) {
#pragma unroll
        for (int j = 0; j < kHold; ++j)
          if (i0 + j < n) load_raw16(x, a.M, a.K, m0 + row, c0 + col_of(i0 + j), a.xvec, raw[j]);
      }
#pragma unroll
      for (int j = 0; j < kHold; ++j) {
        if (i0 + j >= n) continue;
        float v[16];
        int qv[16];
        raw_to_float<T>(raw[j], v);
        quant(v, sc, rc, qv);
        unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int i = 0; i < 16; ++i)  // k = 4 (i/4) + i%4 goes to byte i/4 of word i%4
          w[i % 4] |= (unsigned)(uint8_t)(int8_t)qv[i] << (8 * (i / 4));
        *reinterpret_cast<uint4*>(xs + row * ldx + col_of(i0 + j)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
  if (!kK7 && kQuant && threadIdx.x < kW) cp_async_wait<0>();  // w_scale landed

  // stream B: chunk i's stage is read by all four warps, one k32 step each
  int acc[4][4] = {};
  for (int i = 0; i < n; ++i) {
    if (a.tma) mbar_wait(bar + i % kRing, (i / kRing) & 1);
    __syncthreads();  // chunk i (and xs) visible to all; chunk i - 1's stage is free
    if (i + kRing - 1 < n) fill(i + kRing - 1);
    mma_step(xs, ldx, i * kKC + warp * 32, ring + (i % kRing) * kStage + warp * 32 * kW, g, t,
             acc);
  }
  store_partial(part + warp * kBM * kW, acc, g, t);
  __syncthreads();

  // The tile's outputs, e = 32 row + column, belong to cluster rank
  // (e cs) >> 9: each CTA adds up its warps' partials of them and pushes the
  // sums into the owner's shared memory (slot 512 rank + e), and after one
  // cluster barrier every owner adds up what it received and stores it
  const int rows = min(kBM, a.M - m0), cols = min(a.w, a.N - n0);
  if (!kQuant) cluster_wait();  // every CTA of the cluster runs (the arrive at the start)
#pragma unroll
  for (int k = 0; k < kBM * kW / kThreadsG; ++k) {
    const int e = threadIdx.x + k * kThreadsG, er = e / kW, ec = e % kW;
    if (er < rows && ec < cols) {
      int sum = 0;
#pragma unroll
      for (int wp = 0; wp < kWarpsG; ++wp) sum += part[wp * kBM * kW + er * kW + off + ec];
      cluster.map_shared_rank(recv, (e * cs) >> 9)[q * kBM * kW + e] = sum;
    }
  }
  cluster_arrive();
  cluster_wait();  // every push has landed; no remote access follows
#pragma unroll
  for (int k = 0; k < kBM * kW / kThreadsG; ++k) {
    const int e = threadIdx.x + k * kThreadsG, er = e / kW, ec = e % kW;
    if (er >= rows || ec >= cols || (e * cs) >> 9 != q) continue;
    int s = 0;
#pragma unroll
    for (int p = 0; p < kClusterMax; ++p)
      if (p < cs) s += recv[p * kBM * kW + e];
    const size_t o = (size_t)(m0 + er) * a.N + n0 + ec;
    if constexpr (kK7 || !kQuant) {
      static_cast<int*>(a.y)[o] = s;
    } else {
      store_as(static_cast<T*>(a.y) + o, ((float)s * xsc[er]) * bsc[ec]);
    }
  }
}

// K6 (T = int8_t: the TPU contract; bf16 / float: the fused entry)
template <typename T>
__global__ void __launch_bounds__(kThreadsG)
k6_kernel(const GemmArgs a, const __grid_constant__ CUtensorMap bmap) {
  gemm_body<false, T>(a, &bmap);
}

// K7's phase 1: t = x_q u_q (int32), and the x scales when T quantizes
template <typename T>
__global__ void __launch_bounds__(kThreadsG)
k7_rank_kernel(const GemmArgs a, const __grid_constant__ CUtensorMap bmap) {
  gemm_body<true, T>(a, &bmap);
}

// --------------------------------------------------------------------------
// K7's phase 2: requantize t per row and multiply by v
// --------------------------------------------------------------------------

struct OutArgs {
  const int* t;          // (M, r) int32 from phase 1
  const float* uscale;   // (1, r)
  const int8_t* v;       // (r, S)
  const float* vscale;   // (1, S)
  const float* xscale;   // (M), or null: the TPU contract's output in x_q's units
  void* y;               // (M, S) in T
  int M, r, S, w, tma;
  int tvec;              // t's rows and u_scale 16-byte aligned (r % 4 == 0)
};

__host__ __device__ inline int out_rows(int r) { return cdiv(round_up(r, 32), kKC) * kKC; }
__host__ __device__ inline size_t out_smem(int r) {
  const int rk = round_up(r, 32);
  return (size_t)out_rows(r) * kW + align128((size_t)kBM * (rk + 16)) +
         sizeof(int) * kWarpsG * kBM * kW + (2 * kBM + kW) * 4 + 16;
}

// CTA (tile, row block) = (blockIdx.x, blockIdx.y): columns [w x, w x + w)
// of rows [16 y, 16 y + 16).
template <typename T>
__global__ void __launch_bounds__(kThreadsG)
k7_out_kernel(const OutArgs a, const __grid_constant__ CUtensorMap vmap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rk = round_up(a.r, 32), nrows = out_rows(a.r), ldq = rk + 16;
  unsigned char* vt = smem;  // [nrows][kW]
  int8_t* tq = reinterpret_cast<int8_t*>(smem + nrows * kW);
  int* part = reinterpret_cast<int*>(smem + nrows * kW + align128((size_t)kBM * ldq));
  float* tsm = reinterpret_cast<float*>(part + kWarpsG * kBM * kW);
  float* xsm = tsm + kBM;  // the x scales of the rows (1 for the int8 entry)
  float* vsc = xsm + kBM;  // v_scale of the tile's columns
  uint64_t* bar = reinterpret_cast<uint64_t*>(vsc + kW);
  const int n0 = blockIdx.x * a.w, m0 = blockIdx.y * kBM;
  const int nb = a.tma ? n0 & ~15 : n0, off = n0 - nb;  // as in gemm_body
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  // v's tile does not depend on phase 1: request it before waiting
  if (a.tma) {
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      mbar_fence_init();
      prefetch_map(&vmap);
      mbar_arrive_tx(bar, nrows * kW);
      for (int k0 = 0; k0 < nrows; k0 += kKC) tma_load_2d(vt + k0 * kW, &vmap, nb, k0, bar);
    }
  } else {
    fill_elems(a.v, a.r, a.S, 0, n0, a.w, nrows, vt);
  }
  if (threadIdx.x < kW)
    vsc[threadIdx.x] = threadIdx.x < a.w && n0 + threadIdx.x < a.S ? a.vscale[n0 + threadIdx.x]
                                                                   : 0.0f;
  grid_dependency_wait();  // phase 1's t and x scales are written
  if (threadIdx.x < kBM)
    xsm[threadIdx.x] = a.xscale && m0 + threadIdx.x < a.M ? a.xscale[m0 + threadIdx.x] : 1.0f;

  // t * u_scale, each row's max over the whole rank, requantization: as
  // gemm_body's slab of x, 8 threads a row, a thread's item i the 16 ranks
  // from p kPiece + 16 (cg + 8 i) of piece p (kPiece = 512 ranks: what the
  // kHold items hold), every load of a piece issued first, 16 bytes a load
  // where t's rows are aligned (a row's 8 threads then read 512 contiguous
  // bytes an item).  One pass over the pieces takes the row's max (exact in
  // any order); a second quantizes them, last piece first, from the
  // registers the first pass left for it and reading t again (L2) for the
  // others.  Up to 512 ranks: one piece, one read.
  {
    const int row = threadIdx.x >> 3, cg = threadIdx.x & 7, m = m0 + row;
    const int pieces = cdiv(rk, kPiece);
    float tv[kHold][16];
    auto load = [&](int p) {
#pragma unroll
      for (int j = 0; j < kHold; ++j) {
        const int c0 = p * kPiece + (cg + 8 * j) * 16;
        if (a.tvec && m < a.M && c0 + 16 <= a.r) {
          const int4* tp = reinterpret_cast<const int4*>(a.t + (size_t)m * a.r + c0);
          const float4* up = reinterpret_cast<const float4*>(a.uscale + c0);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int4 ti = tp[q];  // written by phase 1: a coherent load, not __ldg
            const float4 us = __ldg(up + q);
            tv[j][4 * q] = (float)ti.x * us.x;
            tv[j][4 * q + 1] = (float)ti.y * us.y;
            tv[j][4 * q + 2] = (float)ti.z * us.z;
            tv[j][4 * q + 3] = (float)ti.w * us.w;
          }
          continue;
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int col = c0 + i;
          tv[j][i] =
              m < a.M && col < a.r ? (float)a.t[(size_t)m * a.r + col] * a.uscale[col] : 0.0f;
        }
      }
    };
    float mx = 0.0f;
    for (int p = 0; p < pieces; ++p) {
      load(p);
#pragma unroll
      for (int j = 0; j < kHold; ++j)
#pragma unroll
        for (int i = 0; i < 16; ++i) mx = fmaxf(mx, fabsf(tv[j][i]));
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float ts = fmaxf(mx, 1e-8f) / 127.0f, rts = rcp_approx(ts);
    if (cg == 0) tsm[row] = ts;
    for (int p = pieces - 1; p >= 0; --p) {
      if (p != pieces - 1) load(p);
#pragma unroll
      for (int j = 0; j < kHold; ++j) {
        const int c0 = p * kPiece + (cg + 8 * j) * 16;
        if (c0 >= rk) continue;
        int qv[16];
        quant(tv[j], ts, rts, qv);
        unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int i = 0; i < 16; ++i)  // MMA order, as gemm_body's x
          w[i % 4] |= (unsigned)(uint8_t)(int8_t)qv[i] << (8 * (i / 4));
        *reinterpret_cast<uint4*>(tq + row * ldq + c0) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
  if (a.tma) mbar_wait(bar, 0);
  __syncthreads();

  int acc[4][4] = {};
  for (int s = warp; s < rk / 32; s += kWarpsG)
    mma_step(tq, ldq, s * 32, vt + s * 32 * kW, g, t, acc);
  store_partial(part + warp * kBM * kW, acc, g, t);
  __syncthreads();

  const int cols = min(a.w, a.S - n0);
  for (int e = threadIdx.x; e < kBM * cols; e += blockDim.x) {
    const int row = e / cols, col = e % cols, m = m0 + row;
    if (m >= a.M) break;
    int s = 0;
#pragma unroll
    for (int wp = 0; wp < kWarpsG; ++wp) s += part[(wp * kBM + row) * kW + off + col];
    float y = ((float)s * tsm[row]) * vsc[col];
    if (a.xscale) y = y * xsm[row];
    store_as(static_cast<T*>(a.y) + (size_t)m * a.S + n0 + col, y);
  }
}

// --------------------------------------------------------------------------
// Launches
// --------------------------------------------------------------------------

// Tensor map of a row-major int8 (rows, cols) matrix read in kW x kKC boxes,
// zeros out of bounds.
inline cudaError_t make_map_i8(CUtensorMap* map, const void* p, int rows, int cols) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorSharedObjectSymbolNotFound;
  int dev = 0;
  cudaError_t e = bind_device(&dev);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {kW, kKC};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// TMA reads a tile where the base and the row pitch are 16-byte aligned: a
// box of 32 columns from the 16-byte boundary at or before the tile's first
// column (zero past N), so the tile is 32 wide or at most 16 (the plans'
// widths); the MMA's columns outside the tile are not stored
inline bool tma_ok(const void* p, int cols, int w) {
  return (reinterpret_cast<size_t>(p) & 15) == 0 && cols % 16 == 0 && (w == kW || w <= 16);
}

// the plan the wrapper computed: every CTA of the cluster has a chunk, and
// its slab of x fits in shared memory
inline bool plan_ok(int K, int w, int cs, int per) {
  return w >= 1 && w <= kW && cs >= 1 && cs <= kClusterMax && per >= 1 && per <= kPerMax &&
         cdiv(cdiv(K, kKC), per) == cs;
}

template <auto kernel>
inline cudaError_t launch_gemm(GemmArgs a, int cs, cudaStream_t stream) {
  static size_t reserved = 0;  // one per kernel
  const size_t smem = gemm_smem(a.per);
  cudaError_t e = reserve_smem(kernel, smem, &reserved);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (a.tma && (e = make_map_i8(&map, a.b, a.K, a.N)) != cudaSuccess) return e;
  const int tiles = cdiv(a.N, a.w), blocks = cdiv(a.M, kBM);
  if (tiles > 65535 || blocks > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, tiles, blocks);
  cfg.blockDim = dim3(kThreadsG);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, map);
}

template <auto kernel>
inline cudaError_t launch_out(OutArgs a, cudaStream_t stream) {
  static size_t reserved = 0;  // one per kernel
  const size_t smem = out_smem(a.r);
  cudaError_t e = reserve_smem(kernel, smem, &reserved);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (a.tma && (e = make_map_i8(&map, a.v, a.r, a.S)) != cudaSuccess) return e;
  const int tiles = cdiv(a.S, a.w), blocks = cdiv(a.M, kBM);
  if (tiles > 65535 || blocks > 65535) return cudaErrorInvalidValue;
  return launch_after(kernel, dim3(tiles, blocks), dim3(kThreadsG), smem, true, stream, a, map);
}

// x's element type: 0 int8 (the TPU contract), 1 float32, 2 bf16
inline bool x_vec(const void* x, int K, int xtype) {
  const int per = xtype == 0 ? 16 : xtype == 1 ? 4 : 8;  // elements in 16 bytes
  return (reinterpret_cast<size_t>(x) & 15) == 0 && K % per == 0;
}

inline cudaError_t launch_k6(int xtype, const void* x, const int8_t* w, const float* ws,
                             void* y, int M, int C, int S, int cs, int per,
                             cudaStream_t stream) {
  if (!plan_ok(C, kW, cs, per)) return cudaErrorInvalidValue;
  GemmArgs a = {x, w, ws, y, nullptr, M, C, S, kW, per, tma_ok(w, S, kW), x_vec(x, C, xtype)};
  if (xtype == 0) return launch_gemm<k6_kernel<int8_t>>(a, cs, stream);
  if (xtype == 1) return launch_gemm<k6_kernel<float>>(a, cs, stream);
  return launch_gemm<k6_kernel<bf16>>(a, cs, stream);
}

inline cudaError_t launch_k7(int xtype, const void* x, const int8_t* u, const float* us,
                             const int8_t* v, const float* vs, void* y, int* t, float* xscale,
                             int M, int C, int r, int S, int w1, int cs1, int per1, int w2,
                             cudaStream_t stream) {
  if (!plan_ok(C, w1, cs1, per1) || w2 < 1 || w2 > kW) return cudaErrorInvalidValue;
  GemmArgs a1 = {x, u, nullptr, t, xscale, M, C, r, w1, per1, tma_ok(u, r, w1),
                 x_vec(x, C, xtype)};
  OutArgs a2 = {t, us, v, vs, xtype ? xscale : nullptr, y, M, r, S, w2, tma_ok(v, S, w2),
                (reinterpret_cast<size_t>(us) & 15) == 0 && r % 4 == 0};
  cudaError_t e;
  if (xtype == 0) e = launch_gemm<k7_rank_kernel<int8_t>>(a1, cs1, stream);
  else if (xtype == 1) e = launch_gemm<k7_rank_kernel<float>>(a1, cs1, stream);
  else e = launch_gemm<k7_rank_kernel<bf16>>(a1, cs1, stream);
  if (e != cudaSuccess) return e;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return xtype == 2 ? launch_out<k7_out_kernel<bf16>>(a2, stream)
                    : launch_out<k7_out_kernel<float>>(a2, stream);
}

}  // namespace i8
}  // namespace repro

extern "C" {

// K6: y (M, S) = x (M, C) @ w (C, S), row-major and contiguous.  xtype 0:
// x int8, y int32 (w_scale unused); 1 / 2: x float32 / bf16, quantized per
// row in the kernel, y = (acc * x_scale) * w_scale (1, S) in x's dtype.
// (cs, per): the wrapper's plan.  Launches on `stream`; returns the
// cudaError_t of the launch.
int repro_int8_matmul(int xtype, const void* x, const void* w, const void* w_scale, void* y,
                      int M, int C, int S, int cs, int per, void* stream) {
  if (M <= 0 || S <= 0) return 0;
  if (C <= 0 || xtype < 0 || xtype > 2) return (int)cudaErrorInvalidValue;
  cudaError_t e = repro::i8::launch_k6(xtype, x, (const int8_t*)w, (const float*)w_scale, y, M,
                                       C, S, cs, per, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// K7: y (M, S) of x (M, C), u (C, r), u_scale (1, r), v (r, S), v_scale
// (1, S), all contiguous.  xtype 0: x int8, y float32 in x's units; 1 / 2:
// x float32 / bf16, quantized in phase 1, y in x's dtype.  t: (M, r) int32
// scratch, x_scale: (M) float32 scratch (xtype 1 / 2).  (w1, cs1, per1):
// phase 1's plan, w2: phase 2's tile width.
int repro_int8_lowrank_matmul(int xtype, const void* x, const void* u, const void* u_scale,
                              const void* v, const void* v_scale, void* y, void* t,
                              void* x_scale, int M, int C, int r, int S, int w1, int cs1,
                              int per1, int w2, void* stream) {
  if (M <= 0 || S <= 0) return 0;
  if (C <= 0 || r <= 0 || r > repro::kRMax || xtype < 0 || xtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = repro::i8::launch_k7(
      xtype, x, (const int8_t*)u, (const float*)u_scale, (const int8_t*)v,
      (const float*)v_scale, y, (int*)t, (float*)x_scale, M, C, r, S, w1, cs1, per1, w2,
      (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

const char* repro_int8_matmul_error(int code) { return cudaGetErrorString((cudaError_t)code); }
const char* repro_int8_lowrank_matmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
const char* repro_int8_linear_error(int code) { return cudaGetErrorString((cudaError_t)code); }
const char* repro_int8_lowrank_linear_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
