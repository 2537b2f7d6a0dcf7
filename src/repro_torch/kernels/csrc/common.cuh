// Shared pieces of the low-rank kernels (lowrank_matmul.cu, lowrank_ffn.cu,
// lowrank_bwd.cu, int8_matmul.cu).  K1/K5 have two designs, chosen by the
// wrappers by M alone (kernels/lowrank_matmul.py and lowrank_ffn.py,
// LARGE_M): the decode design below, and the large-M design in the second
// half of this file, whose Hopper primitives (mbarriers, TMA, swizzled wgmma
// descriptors, wgmma with either operand transposed, tensor maps) K3/K4 also
// use.
//
// ==== The decode design (M below LARGE_M) ====
//
// What bounds it on the H100: at M = 8-40 a call reads 0.15-4.9 MB of
// factors and does well under a GFLOP, so the floor is the bytes (0.05-1.5
// us at 3.35 TB/s), and what a call costs is latency: the launch and every
// dependent trip to memory.  The design spreads both products over the whole
// card and gives each one trip.
//
// Phase 1 (the rank kernel): t = x U, once a call for all M rows.  A CTA
// owns a tile of w1 columns of t (w1 a multiple of 8, at most 64) and a slab
// of C; the cs CTAs of a thread-block cluster split C between them (kc rows
// a CTA), so cs x (r / w1) CTAs make about one wave.  Each CTA requests its
// slab of U and its columns of x at once: 16-byte cp.async where rows are
// 16-byte aligned, else 16-byte loads of the aligned chunks around every 8
// elements, shifted into place in registers (U at the odd ranks 349, 239,
// 119 and 59; operands off a 16-byte boundary).  Its warps multiply them on
// mma.sync m16n8k16 with ldmatrix fragments (x K-major, U through
// ldmatrix.trans), each warp whole (16-row, 8-column) tiles over the slab,
// and push the float32 sums into the shared memory of the cluster rank that
// owns each element (distributed shared memory).  After one cluster barrier
// each owner adds the cs partials in rank order, rounds once to bf16 (the one
// rounding point between the two products) and stores its elements of t to
// a global scratch the wrapper allocates (L2-resident, (M, rt) a branch).
//
// Phase 2 (the out kernel), a programmatic dependent of phase 1: a CTA owns
// w2 columns of the output (a multiple of 8, at most 64) and requests its
// tile of V, every rank row of it, when it starts, while phase 1 runs; then
// it waits for phase 1, requests t and multiplies, each warp whole output
// tiles (16 rows, 8 columns) over the whole rank.  Each output is rounded
// once (K5: silu(g) * u in float32 from both branches' sums, then rounded).
// Past kDKpMax = 512 rank rows (Zamba2's 640-1365; K5 too from the VLM's
// 3185) the V tile and t no longer fit shared memory whole, so the CTA
// walks the rank in the fewest equal pieces of at most 512 rows (decode_kp,
// a function of r alone): the first piece's V is requested before the wait
// and the later pieces' asked into L2, each piece's float32 sums (each
// branch's, for K5) are added to the earlier ones' in shared memory, and
// the output is still rounded once, after the last piece (K5: silu(g) * u
// on the whole float32 sums, then the rounding).  Shared memory stays what
// r = 512 needed.
//
// Sums in a fixed order that M does not change: the split of C (cs, kc, per)
// and of r (w1) come from the wrapper's plan (decode_plan in
// kernels/lowrank_matmul.py), a function of (C, r, S, SMs) alone; every
// tile's product over its depth runs as four chains of k steps, added in
// one order (tile_product); and no row's sums mix with another's.  So a call
// is bitwise repeatable and a row has the same bits at every M.  No atomics,
// and nothing is kept across calls: the scratch is written before it is
// read within the call, so a CUDA graph can replay it.
//
// Above 128 rows (fewer where shared memory asks: block_rows) M is split
// into row blocks, a grid dimension of both phases (a row's sums do not
// change); C above cs x 512 is taken in pieces of kc rows a CTA (per > 1).  Rows
// past M, ranks past r and columns past C and S are zero-filled in shared
// memory and never stored.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <dlfcn.h>
#include <stdint.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

namespace repro {

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kBM = 16;          // rows of an MMA tile (m16n8k16)
constexpr int kRMax = 4096;      // largest rank K1, K2-K4, K5 and K7 take
constexpr int kSmemMax = 232448; // 227 KB, the most shared memory a block may use
constexpr int kDThreads = 256;   // decode design: 8 warps a CTA, both phases
constexpr int kDWarps = kDThreads / 32;
constexpr int kDRows = 128;      // most rows of x (phase 1) or t (phase 2) a CTA holds
constexpr int kDClusterMax = 8;  // CTAs of a cluster splitting C
constexpr int kDKcMax = 512;     // rows of C in a CTA's piece
constexpr int kDW1Max = 64;      // columns of t a phase-1 CTA owns
constexpr int kDW2Max = 64;      // output columns a phase-2 CTA owns
constexpr int kDBatch = 8;       // 16-byte chunks a thread has in flight on the shifted path
constexpr int kDKpMax = 512;     // rank rows of V and t a phase-2 CTA holds at once

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~size_t(127); }
// shared-memory row pitch (elements) of a tile w wide (w a multiple of 8): an
// odd number of 16-byte groups, so the 8 rows of an ldmatrix hit 8 bank groups
__host__ __device__ inline int tile_ld(int w) { return (w / 8) % 2 ? w + 16 : w + 8; }

__device__ inline uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline unsigned pack2(bf16 lo, bf16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
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
// Cluster barriers in two halves (every thread of the cluster), and
// programmatic dependent launch
// --------------------------------------------------------------------------

__device__ inline void cluster_arrive() { asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory"); }
__device__ inline void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ inline void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// A grid launched as a programmatic dependent (launch_after) may start while
// the grid before it runs; it waits here before touching anything that grid
// writes, or that an earlier one may still use (a no-op in a grid not
// launched so).  The grid before lets its dependents launch once each of its
// CTAs has called grid_dependents_may_launch (or exited).
__device__ inline void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ inline void grid_dependents_may_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// --------------------------------------------------------------------------
// Tile loads: every chunk of a CTA's tile requested at once
// --------------------------------------------------------------------------

// The 8 bf16 from element sh (0-7) of the 16 in lo:hi (two chunks in memory
// order): a shift by 2 and by 1 words as selects, then a funnel shift by
// the odd half word.
__device__ inline uint4 shift8(uint4 lo, uint4 hi, int sh) {
  unsigned a0 = lo.x, a1 = lo.y, a2 = lo.z, a3 = lo.w, a4 = hi.x, a5 = hi.y, a6 = hi.z,
           a7 = hi.w;
  if (sh & 4) a0 = a2, a1 = a3, a2 = a4, a3 = a5, a4 = a6, a5 = a7;
  if (sh & 2) a0 = a1, a1 = a2, a2 = a3, a3 = a4, a4 = a5;
  const unsigned f = (sh & 1) * 16;
  return make_uint4(__funnelshift_r(a0, a1, f), __funnelshift_r(a1, a2, f),
                    __funnelshift_r(a2, a3, f), __funnelshift_r(a3, a4, f));
}

// v with its elements from n on (0 <= n <= 8) zeroed
__device__ inline uint4 keep_first(uint4 v, int n) {
  if (n >= 8) return v;
  unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] &= (2 * i < n ? 0xffffu : 0u) | (2 * i + 1 < n ? 0xffff0000u : 0u);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// dst[i][j] (row pitch ld) = g[r0 + i][c0 + j] for i < rows and j < cols (a
// multiple of 8) of a row-major bf16 matrix g with row pitch `pitch`, zero
// where r0 + i >= nr or c0 + j >= nc.  vec (g 16-byte aligned, pitch and c0
// multiples of 8): 16-byte cp.async, committed by the caller.  Otherwise
// every 8 elements come from the one or two aligned 16-byte chunks around
// them (16-byte loads that stay inside the chunks holding valid elements),
// kDBatch chunks a thread in flight at once, shifted into place.
__device__ inline void load_tile(const bf16* __restrict__ g, int pitch, int nr, int nc, int r0,
                                 int c0, int rows, int cols, bf16* dst, int ld, bool vec) {
  const int cpr = cols >> 3, n = rows * cpr;
  if (vec) {
    for (int i = threadIdx.x; i < n; i += kDThreads) {
      const int row = i / cpr, col = (i - row * cpr) * 8, gr = r0 + row, gc = c0 + col;
      const int valid = gr < nr ? max(0, min(8, nc - gc)) : 0;
      cp_async16(dst + row * ld + col, valid ? g + (size_t)gr * pitch + gc : g, 2 * valid);
    }
    return;
  }
  const auto at = [&](int i, int& valid) {  // chunk i's first element, and how many are valid
    const int row = i / cpr, col = (i - row * cpr) * 8, gr = r0 + row, gc = c0 + col;
    valid = gr < nr ? max(0, min(8, nc - gc)) : 0;
    return reinterpret_cast<size_t>(g + (size_t)gr * pitch + gc);
  };
  for (int i0 = threadIdx.x; i0 < n; i0 += kDThreads * kDBatch) {
    uint4 lo[kDBatch], hi[kDBatch];
#pragma unroll
    for (int j = 0; j < kDBatch; ++j) {  // every load of the batch in flight first
      const int i = i0 + j * kDThreads;
      lo[j] = hi[j] = make_uint4(0, 0, 0, 0);
      int valid = 0;
      const size_t a = i < n ? at(i, valid) : 0;
      if (valid) {
        const uint4* p = reinterpret_cast<const uint4*>(a & ~(size_t)15);
        lo[j] = __ldg(p);
        if ((int)(a & 15) / 2 + valid > 8) hi[j] = __ldg(p + 1);
      }
    }
#pragma unroll
    for (int j = 0; j < kDBatch; ++j) {
      const int i = i0 + j * kDThreads;
      if (i >= n) break;
      int valid;
      const size_t a = at(i, valid);
      const int row = i / cpr, col = (i - row * cpr) * 8;
      *reinterpret_cast<uint4*>(dst + row * ld + col) =
          keep_first(shift8(lo[j], hi[j], (int)(a & 15) / 2), valid);
    }
  }
}

// --------------------------------------------------------------------------
// Fragments and the MMA
// --------------------------------------------------------------------------

// the m16n8k16 A fragment of the 16 x 16 tile whose rows start at p (pitch
// ld): lane l gives row l % 16, columns 8 (l / 16) onwards
__device__ inline void ldsm_a(unsigned (&a)[4], const bf16* p, int ld) {
  const int lane = threadIdx.x % 32;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p + (lane & 15) * ld + (lane >> 4) * 8)));
}
// the B fragment of the 16 x 8 tile at p of a K x N row-major matrix (pitch
// ld), transposed by ldmatrix: lanes 0-15 give rows 0-15
__device__ inline void ldsm_b(unsigned& b0, unsigned& b1, const bf16* p, int ld) {
  const int lane = threadIdx.x % 32;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_u32(p + (lane & 15) * ld)));
}

// d += A (16x16, row-major) * B (16x8, col-major), bf16 in, float32 out.
// d[0..1]: row lane / 4, columns 2 (lane % 4) + {0, 1}; d[2..3]: row + 8.
__device__ inline void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = A B over the k steps [0, ks) of a 16-row tile at a (K-major, pitch
// lda) and a 16 ks x 8 tile at b (rows of K, pitch ldb): four chains of
// steps k % 4, added as (c0 + c1) + (c2 + c3).  The order depends on ks
// alone.
__device__ inline void tile_product(float (&d)[4], const bf16* a, int lda, const bf16* b,
                                    int ldb, int ks) {
  float c[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
  for (int k = 0; k < ks; k += 4) {
    unsigned af[4][4], b0[4], b1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k + j >= ks) break;
      ldsm_a(af[j], a + (k + j) * 16, lda);
      ldsm_b(b0[j], b1[j], b + (k + j) * 16 * ldb, ldb);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k + j >= ks) break;
      mma16816(c[j], af[j], b0[j], b1[j]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] = (c[0][e] + c[1][e]) + (c[2][e] + c[3][e]);
}

// --------------------------------------------------------------------------
// Phase 1: t = bf16(x U), a cluster's tile of w1 columns
// --------------------------------------------------------------------------

struct DecodeRank {
  const bf16* x;     // (M, C)
  const bf16* u[2];  // (C, r_b) of each branch
  bf16* t;           // scratch (nb, M, rt), rt = the larger rank rounded up to 8
  int M, C, r[2], rt;
  int kc, per, w1;   // the C split (the plan's), tile width
  int tiles0;        // branch 0's tiles of r; branch 1's follow in blockIdx.y
  int rows;          // rows of x a CTA holds (a row block)
  int xvec, uvec[2];
};

// Shared memory of phase 1 at `rows` rows a CTA: x [rows][tile_ld(kc)] | U
// [kc][tile_ld(w1)] | this CTA's sums [rows][w1] float32 | the sums pushed
// to it [cs][own] float32, own = ceil(rows w1 / cs)
struct RankSmem {
  size_t u, part, recv, total;
  int own;
};
__host__ __device__ inline RankSmem rank_smem(int rows, int kc, int w1, int cs) {
  RankSmem s;
  s.u = align128(sizeof(bf16) * rows * tile_ld(kc));
  s.part = s.u + align128(sizeof(bf16) * kc * tile_ld(w1));
  s.recv = s.part + align128(sizeof(float) * rows * w1);
  s.own = ceil_div(rows * w1, cs);
  s.total = s.recv + sizeof(float) * cs * s.own;
  return s;
}

// Rows of a row block: M rounded up to the MMA tile, at most kDRows, fewer
// (by 16) until shared memory holds the block.  smem(rows) is the layout's
// size.
template <typename Fn>
inline int block_rows(int M, Fn smem) {
  int rows = M < kDRows ? round_up(M, kBM) : kDRows;
  while (rows > kBM && smem(rows) > (size_t)kSmemMax) rows -= kBM;
  return rows;
}

// CTA (cluster rank q, tile, row block) = (blockIdx.x, blockIdx.y,
// blockIdx.z): columns [n0, n0 + w1) of branch b's t over rows [q per kc,
// (q + 1) per kc) of C, for rows [m0, m0 + rows) of x.
__device__ inline void decode_rank_body(const DecodeRank& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int b = (int)blockIdx.y < a.tiles0 ? 0 : 1;
  const int n0 = ((int)blockIdx.y - (b ? a.tiles0 : 0)) * a.w1;
  const int m0 = blockIdx.z * a.rows, rows = min(a.rows, a.M - m0), mt = ceil_div(rows, kBM);
  const RankSmem L = rank_smem(a.rows, a.kc, a.w1, cs);
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* us = reinterpret_cast<bf16*>(smem + L.u);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* recv = reinterpret_cast<float*>(smem + L.recv);
  const int ldx = tile_ld(a.kc), ldu = tile_ld(a.w1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int nt = a.w1 / 8, ks = a.kc / 16;

  grid_dependents_may_launch();  // phase 2 may start and fetch V
  cluster_arrive_relaxed();      // this CTA runs: waited on before the first remote write
  for (int pc = 0; pc < a.per; ++pc) {
    const int c0 = (q * a.per + pc) * a.kc;
    // U's slab and x's rows: every chunk in flight at once
    load_tile(a.u[b], a.r[b], a.C, a.r[b], c0, n0, a.kc, a.w1, us, ldu, a.uvec[b]);
    load_tile(a.x, a.C, a.M, a.C, m0, c0, mt * kBM, a.kc, xs, ldx, a.xvec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // warp w: tiles (16 rows, 8 columns) w, w + 8, ..., each over the piece,
    // added to the sums in piece order
    for (int p = warp; p < mt * nt; p += kDWarps) {
      const int mi = p / nt, ni = p - mi * nt;
      float d[4];
      tile_product(d, xs + mi * kBM * ldx, ldx, us + ni * 8, ldu, ks);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* s = part + (mi * kBM + g + 8 * (j >> 1)) * a.w1 + ni * 8 + 2 * tq + (j & 1);
        *s = pc ? *s + d[j] : d[j];
      }
    }
    __syncthreads();  // xs, us free for the next piece; part complete
  }
  // the sums to their owners: rank p owns elements [p own, (p + 1) own) of
  // the rows x w1, and takes this CTA's in slot q
  const int n = rows * a.w1, own = ceil_div(n, cs);
  cluster_wait();  // every CTA of the cluster runs
  for (int e = threadIdx.x; e < n; e += kDThreads)
    cluster.map_shared_rank(recv, e / own)[q * own + e % own] = part[e];
  cluster_arrive();
  cluster_wait();  // every push has landed; no remote access follows
  bf16* tb = a.t + ((size_t)b * a.M + m0) * a.rt + n0;
  for (int i = threadIdx.x; i < own && q * own + i < n; i += kDThreads) {
    const int e = q * own + i, row = e / a.w1, col = e - row * a.w1;
    if (n0 + col >= a.r[b]) continue;  // t holds the rank's columns only
    float s = 0.0f;
    for (int p = 0; p < cs; ++p) s += recv[p * own + i];
    tb[(size_t)row * a.rt + col] = __float2bfloat16(s);
  }
}

// --------------------------------------------------------------------------
// Phase 2: y = bf16(t V), or bf16(silu(t_g V_g) * (t_u V_u)), w2 columns
// --------------------------------------------------------------------------

struct DecodeOut {
  const bf16* v[2];  // (r_b, S) of each branch
  const bf16* t;     // (nb, M, rt), phase 1's
  bf16* y;           // (M, S)
  int M, S, r[2], rt;
  int kext;          // rank rows multiplied: the larger rank rounded up to 16
  int kp;            // rank rows a piece (decode_kp): kext, or pieces of at most kDKpMax
  int w2, rows;      // columns and rows (a row block) a CTA owns
  int vvec[2];
};

// Rank rows of one phase-2 piece: the whole rank up to kDKpMax, else the
// rank cut into the fewest equal pieces of at most kDKpMax rows (multiples
// of 16).  A function of the rank alone, so the order of a row's sum does
// not depend on M.
__host__ __device__ inline int decode_kp(int kext) {
  const int n = ceil_div(kext, kDKpMax);
  return round_up(ceil_div(kext, n), kBM);
}

// Shared memory of phase 2 at `rows` rows a CTA and pieces of kp rank rows:
// V [nb][kp][tile_ld(w2)] | t [nb][rows][tile_ld(kp)] | with more than one
// piece, the float32 sums carried between pieces [nb][rows][w2]
struct OutSmem {
  size_t t, acc, total;
};
__host__ __device__ inline OutSmem out_smem(int rows, int kp, int w2, int nb, bool pieces) {
  OutSmem s;
  s.t = align128(sizeof(bf16) * nb * kp * tile_ld(w2));
  const size_t end = s.t + sizeof(bf16) * nb * rows * tile_ld(kp);
  s.acc = align128(end);
  s.total = pieces ? s.acc + sizeof(float) * nb * rows * w2 : end;
  return s;
}

// Ask L2 for rows [r0, r1) x columns [c0, c0 + cols) of a row-major bf16
// matrix (pitch elements a row; the first and last byte of each row's
// segment, at most 128 bytes), rows past nr skipped.
__device__ inline void prefetch_rows_l2(const bf16* g, int pitch, int nr, int r0, int r1, int c0,
                                        int cols) {
  for (int i = r0 + (int)threadIdx.x; i < r1 && i < nr; i += kDThreads) {
    const bf16* p = g + (size_t)i * pitch + c0;
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p + cols - 1));
  }
}

// CTA (column tile, row block) = (blockIdx.x, blockIdx.y): output columns
// [s0, s0 + w2) of rows [m0, m0 + rows).  Warp w takes the output tiles (16
// rows, 8 columns) w, w + 8, ..., each over the whole rank: in one piece
// (rank <= kDKpMax) or piece by piece, each piece's float32 sum (of each
// branch) added to those before it in shared memory and the output formed
// and rounded after the last.  The V of later pieces is asked into L2
// before the wait for phase 1.  kPieces false compiles the one-piece walk
// alone (K5 up to 512 rank rows: a runtime piece count there cost it 3-8%
// at M 24-128 on the H100), and launch_decode takes it where kp == kext.
template <int NB, bool kGated, bool kPieces = true>
__device__ inline void decode_out_body(const DecodeOut& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int np = kPieces ? ceil_div(a.kext, a.kp) : 1;
  const OutSmem L = out_smem(a.rows, a.kp, a.w2, NB, np > 1);
  bf16* vs = reinterpret_cast<bf16*>(smem);
  bf16* ts = reinterpret_cast<bf16*>(smem + L.t);
  float* sums = reinterpret_cast<float*>(smem + L.acc);
  const int ldv = tile_ld(a.w2), ldt = tile_ld(a.kp), s0 = blockIdx.x * a.w2;
  const int m0 = blockIdx.y * a.rows, mt = ceil_div(min(a.rows, a.M - m0), kBM);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int nt = a.w2 / 8;

  for (int pc = 0; pc < np; ++pc) {
    const int k0 = pc * a.kp, kn = min(a.kp, a.kext - k0), ks = kn / 16;
    if (pc) __syncthreads();  // the last piece's V and t are read
    // V's piece does not depend on t: the first is requested before the wait
#pragma unroll
    for (int b = 0; b < NB; ++b)
      load_tile(a.v[b], a.S, a.r[b], a.S, k0, s0, kn, a.w2, vs + b * a.kp * ldv, ldv,
                a.vvec[b]);
    cp_async_commit();
    if (!pc) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
        prefetch_rows_l2(a.v[b], a.S, a.r[b], a.kp, a.kext, s0, min(a.w2, a.S - s0));
      grid_dependency_wait();  // phase 1's t is written
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)  // ranks past r_b read as zeros
      load_tile(a.t + (size_t)b * a.M * a.rt, a.rt, a.M, a.r[b], m0, k0, mt * kBM, kn,
                ts + b * a.rows * ldt, ldt, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const bool last = pc == np - 1;
    for (int p = warp; p < mt * nt; p += kDWarps) {
      const int mi = p / nt, ni = p - mi * nt;
      float o[NB][4];
#pragma unroll
      for (int b = 0; b < NB; ++b)
        tile_product(o[b], ts + (b * a.rows + mi * kBM) * ldt, ldt, vs + b * a.kp * ldv + ni * 8,
                     ldv, ks);
      if (kPieces && np > 1) {  // this thread's elements: the same every piece
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* s = sums + (b * a.rows + mi * kBM + g + 8 * (j >> 1)) * a.w2 + ni * 8 +
                       2 * tq + (j & 1);
            if (pc) o[b][j] = *s + o[b][j];
            if (!last) *s = o[b][j];
          }
        if (!last) continue;
      }
      const int n = s0 + ni * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + mi * kBM + g + 8 * h;
        if (m >= a.M || n >= a.S) continue;
        float v[2];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const float x0 = o[0][2 * h + e2];
          v[e2] = kGated ? x0 / (1.0f + expf(-x0)) * o[NB - 1][2 * h + e2] : x0;
        }
        bf16* dst = a.y + (size_t)m * a.S + n;
        if (n + 1 < a.S && a.S % 2 == 0) {  // y is the wrapper's: 4-byte aligned
          *reinterpret_cast<unsigned*>(dst) = pack2(__float2bfloat16(v[0]), __float2bfloat16(v[1]));
        } else {
          dst[0] = __float2bfloat16(v[0]);
          if (n + 1 < a.S) dst[1] = __float2bfloat16(v[1]);
        }
      }
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

// Launch `kernel` on `stream`, as a programmatic dependent of the grid
// launched before it when `dependent` (its CTAs may start early and must
// call grid_dependency_wait before touching memory).
template <typename... Params, typename... Args>
inline cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                                bool dependent, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Check the wrapper's plan and launch both phases of the decode design on
// NB branches: x (M, C); u[b] (C, r[b]); v[b] (r[b], S); y (M, S); t the
// scratch of nb x M x rt bf16, rt = max_b r[b] rounded up to 8; phase 2
// runs out_kernel in one piece of the rank, pieces_kernel past kDKpMax rank
// rows (K1 passes the same kernel twice).  The plan:
// clusters of cs CTAs, each `per` pieces of kc rows of C, tiles of w1
// columns of r (phase 1) and of w2 columns of S (phase 2).  Where M takes
// more than one row block the tiles widen with it; the widths only share
// the columns out, and no sum changes order.
template <int NB>
inline cudaError_t launch_decode(void (*rank_kernel)(DecodeRank), void (*out_kernel)(DecodeOut),
                                 void (*pieces_kernel)(DecodeOut), const bf16* x,
                                 const bf16* const* u, const bf16* const* v, bf16* y, bf16* t,
                                 int M, int C, const int* r, int S, int cs, int kc, int per,
                                 int w1, int w2, cudaStream_t stream) {
  // one per instantiation: K1's or K5's kernels
  static size_t reserved1 = 0, reserved2 = 0, reserved3 = 0;
  if (cs < 1 || cs > kDClusterMax || kc < kBM || kc > kDKcMax || kc % kBM || per < 1 ||
      ceil_div(C, kc * per) != cs || w1 < 8 || w1 > kDW1Max || w1 % 8 || w2 < 8 ||
      w2 > kDW2Max || w2 % 8)
    return cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; };
  DecodeRank a1 = {};
  DecodeOut a2 = {};
  a1.x = x, a1.t = t, a1.M = M, a1.C = C, a1.kc = kc, a1.per = per;
  a1.xvec = aligned(x) && C % 8 == 0;
  a2.t = t, a2.y = y, a2.M = M, a2.S = S;
  int rmax = 0;
  for (int b = 0; b < NB; ++b) {
    a1.u[b] = u[b], a1.r[b] = a2.r[b] = r[b];
    a1.uvec[b] = aligned(u[b]) && r[b] % 8 == 0;
    a2.v[b] = v[b];
    a2.vvec[b] = aligned(v[b]) && S % 8 == 0;
    rmax = r[b] > rmax ? r[b] : rmax;
  }
  a1.rt = a2.rt = round_up(rmax, 8);
  a2.kext = round_up(rmax, kBM);
  a2.kp = decode_kp(a2.kext);
  const bool pieces = a2.kp < a2.kext;
  void (*out)(DecodeOut) = pieces ? pieces_kernel : out_kernel;
  const auto smem1 = [&](int rows) { return rank_smem(rows, kc, a1.w1, cs).total; };
  const auto smem2 = [&](int rows) { return out_smem(rows, a2.kp, a2.w2, NB, pieces).total; };
  // M in B row blocks: each CTA takes B times the plan's columns (to
  // kDW1Max, kDW2Max), so each grid keeps the size the plan chose
  a1.w1 = w1, a2.w2 = w2;
  const int blocks = ceil_div(M, block_rows(M, smem1));
  a1.w1 = w1 * blocks < kDW1Max ? w1 * blocks : kDW1Max;
  a2.w2 = w2 * blocks < kDW2Max ? w2 * blocks : kDW2Max;
  a1.rows = block_rows(M, smem1);
  a2.rows = block_rows(M, smem2);
  a1.tiles0 = ceil_div(r[0], a1.w1);
  const int tiles = a1.tiles0 + (NB == 2 ? ceil_div(r[NB - 1], a1.w1) : 0);
  const int blocks1 = ceil_div(M, a1.rows), blocks2 = ceil_div(M, a2.rows);
  if (smem1(a1.rows) > (size_t)kSmemMax || smem2(a2.rows) > (size_t)kSmemMax || tiles > 65535 ||
      blocks1 > 65535 || blocks2 > 65535)
    return cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = reserve_smem(rank_kernel, smem1(a1.rows), &reserved1)) != cudaSuccess) return e;
  // K1's two are one kernel: one record, so its attribute only ever grows
  size_t* reserved_out = pieces && pieces_kernel != out_kernel ? &reserved3 : &reserved2;
  if ((e = reserve_smem(out, smem2(a2.rows), reserved_out)) != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, tiles, blocks1);
  cfg.blockDim = dim3(kDThreads);
  cfg.dynamicSmemBytes = smem1(a1.rows);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((e = cudaLaunchKernelEx(&cfg, rank_kernel, a1)) != cudaSuccess) return e;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_after(out, dim3(ceil_div(S, a2.w2), blocks2), dim3(kDThreads),
                      smem2(a2.rows), true, stream, a2);
}

// ==========================================================================
// The large-M design (M >= LARGE_M: training steps, long prefills)
// ==========================================================================
//
// Replaces, above LARGE_M, the TPU kernels src/repro/kernels/
// lowrank_matmul.py:107 (K1) and lowrank_ffn.py:52 (K5) as the decode
// design does below it; same arithmetic: t = x U summed in float32 over the
// whole of C and rounded to bf16 once, then t V in float32, rounded once
// (K1) or kept in float32 per branch for silu(g) * u, rounded once (K5).
//
// What bounds it on the H100 at M ~ 2048: operations.  2 M C r + 2 M r S
// flops (3.7-7.5 GFLOP per call at the model's shapes) against a few MB of
// operands, far above the ~295 flop/byte ridge: 4-10 us at 989 TFLOP/s.
// The decode design runs on mma.sync and reads x (phase 1) and t (phase 2)
// again for every tile of r and of S: at M = 2048, 16 row blocks of both.
//
// Design: one wave, each rank product once per 64-row block.
//   Groups of kLG = 4 CTAs own a 64-row block of x; a persistent grid of as
//   many groups as the card holds at once (a cooperative launch, so every
//   CTA runs together and CTAs may wait on each other) walks the blocks.
//   Phase 1: CTA q computes columns [q N, (q+1) N) of t over the whole of
//   C (N = rp / 4, rp = r padded to a phase-2 stage) with wgmma into
//   float32 registers, warpgroup w taking columns [64 w, 64 w + 64) in one
//   wgmma of width <= 64 per 16-deep step; it rounds them to bf16 and
//   stores them to a global scratch (L2-resident), then a flag.  Each
//   element of t is summed by one CTA in one order: no float32 partials,
//   no cross-CTA reduction.  U is read once per group.
//   Phase 2: once the 4 flags of its block are up, the CTA loads the whole
//   64 x rp of t (of each branch) by TMA into shared memory, then walks the
//   output's 128-column tiles q, q + 4, ...: wgmma m64n64k16 with A = t and
//   B = V tiles (128 rank rows for K1, 64 a branch for K5) from the ring,
//   each warpgroup 64 of the 128 columns.  The epilogue stages the bf16 tile
//   in shared memory and stores it by TMA (rows past M and columns past S
//   clipped), overlapping the next tile.
// Warp roles: warpgroups 0 and 1 run wgmma; warpgroup 2 keeps a ring of
// stages full by TMA (one thread issues; full/empty mbarriers), phase 1's
// x tiles and U chunks then phase 2's V tiles.
//
// Why not clusters and distributed shared memory (the first version): with
// a CTA per SM, 16 clusters of 8 or 32 of 4 did not run as one wave on the
// H100 (a cluster's CTAs must share a GPC), and the exchange of t through
// distributed shared memory was slower than the store to L2 and TMA load
// back; groups of a cooperative launch need no GPC of their own.
//
// Ranks past 512 (Zamba2's 640-1408 padded; K5's two branches from the
// VLM's 3185, KC2 64 ranks a stage and branch): a CTA's N = rp / 4
// columns of t are computed in passes of kLNPass = 128 (each pass walks C
// again, x re-read from L2), so the U chunk of a stage keeps its size; and
// the row block's t, 128 bytes a rank, no longer fits beside the ring, so
// it streams through the ring with V instead (LargeSmem::stream_t): each
// phase-2 stage carries its 128 ranks of t (16 KB) beside the V tile, read
// again from L2 for each output tile.  t V still sums every rank in one
// float32 accumulator and rounds once.  Up to a padded rank of 512 the
// layout and the stages are as before.
//
// Layouts: every wgmma operand is a 128-byte swizzled canonical layout.  A
// (x tiles, t) is K-major: rows of 64 bf16 (128 B), 8-row atoms of 1 KB,
// the XOR swizzle of TMA's CU_TENSOR_MAP_SWIZZLE_128B.  B (U chunks, V
// tiles) is MN-major, since U (C, r) and V (r, S) are row-major: each K
// row holds 64 columns in 128 B, 8 K rows form a 1 KB atom, and wgmma reads
// it with its transpose-B flag.  x, t, V and y go through TMA when their
// base is 16-byte aligned and their rows a multiple of 8 elements;
// otherwise the producer fills the same layouts by element loads and the
// epilogue stores straight to y.
//
// U's rows at odd ranks (349, 239: 698 and 478 bytes) are not the multiple
// of 16 bytes a tensor map needs.  Phase 0, inside the same launch, copies
// U once into the scratch with rows padded to 8 elements, each CTA of the
// grid (groups without a row block too) a few rows, then a flag; a CTA's
// producer waits for every flag before its first U load.  Two per-stage
// schemes were measured slower first: element loads of U (each stage a
// round trip to memory) and 16-byte cp.async copies re-laid out by the
// producer (instruction-bound on one warp a scheduler).  Where U is
// aligned with r % 8 == 0 (ranks 256, 240, 120, 80) TMA reads U where it
// lies and phase 0 is skipped.  Past M, C, r and S, TMA fills zeros (U
// boxes starting past r are zeroed by the producer) and the epilogue
// masks or clips.

// --------------------------------------------------------------------------
// Hopper primitives (inline PTX)
// --------------------------------------------------------------------------

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ inline void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Spins until the phase of parity `parity` completes (each poll may sleep
// up to the suspend hint, and wakes when the phase completes).  A wait that
// outlives any real stage by far (10 s on the global timer) traps, so a
// broken protocol ends the launch with an error instead of hanging the card.
__device__ inline uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity), "r"(0x989680)
        : "memory");
    if (!done && (polls & 1023) == 1023) {
      if (!t0) t0 = global_ns();
      else if (global_ns() - t0 > 10000000000ull) __trap();
    }
  }
}

// 2-D TMA load of the box at (c0 inner, c1 outer) into dst; completes on bar.
__device__ inline void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                   uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// 3-D TMA load of the box at (c0 inner, c1, c2 outer) into dst; completes
// on bar
__device__ inline void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                   uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// 2-D TMA store of the box at src to (c0 inner, c1 outer); rows and columns
// out of the tensor are not written
__device__ inline void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the shared memory of this thread's earlier TMA stores has been read
__device__ inline void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ask L2 to fetch `bytes` (a multiple of 16, 16-byte aligned) of global memory
__device__ inline void bulk_prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes)
               : "memory");
}

// generic-proxy writes to this CTA's (or the cluster's) shared memory ->
// later reads by wgmma / TMA
__device__ inline void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// this thread's later async-proxy (TMA) reads of global memory see what it
// has observed of other threads' generic-proxy writes
__device__ inline void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ inline unsigned long long ld_acquire_u64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ inline void st_release_u64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}
// barrier of the two consumer warpgroups only (256 threads, barrier 1)
__device__ inline void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }
// barrier of one consumer warpgroup (128 threads, barrier 3 + wg)
__device__ inline void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

// wgmma matrix descriptor of a 128-byte swizzled operand at `p` (1 KB
// aligned atoms): sbo = byte stride between 8-row groups (K-major: along
// M/N; MN-major: along K), lbo = byte stride between 64-wide MN atoms
// (MN-major only; every product here stays inside one atom).
__device__ inline uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across a
// wgmma fence / wait
template <int N>
__device__ inline void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x W, float32) += A (64 x 16) * B (16 x W), bf16 from shared memory.
// TA / TB are wgmma's transpose flags: TA = 0 reads A K-major, 1 MN-major
// (A stored K rows of 64 M values); TB = 0 reads B K-major (B stored N
// rows of 16 K values), 1 MN-major (K rows of N values).  The defaults
// (K-major A, MN-major B) are what K1/K5 use.
template <int TA = 0, int TB = 1>
__device__ inline void wgmma_n16(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA = 0, int TB = 1>
__device__ inline void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA = 0, int TB = 1>
__device__ inline void wgmma_n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA = 0, int TB = 1>
__device__ inline void wgmma_n48(float (&d)[24], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 64, float32) += A (64 x 16) * B (16 x 64), A bf16 from registers:
// each warp's 16 rows as the m16n8k16 A fragment (a[0]: row lane / 4,
// columns 2 (lane % 4) + {0, 1}; a[1]: row + 8; a[2], a[3]: columns + 8),
// which is also how the float32 accumulator of a 16-column slice of an
// earlier wgmma lies, packed to bf16 pairs.  B from shared memory, read
// MN-major (TB = 1) or K-major (0) as in wgmma_n64.
template <int TB = 1>
__device__ inline void wgmma_rs_n64(float (&d)[32], const unsigned (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

// d (64 x W) += A * B for W in {16, 32, 48, 64}
template <int W, int TA = 0, int TB = 1>
__device__ inline void wgmma_w(float (&d)[W / 2], uint64_t a, uint64_t b) {
  if constexpr (W == 16) wgmma_n16<TA, TB>(d, a, b);
  else if constexpr (W == 32) wgmma_n32<TA, TB>(d, a, b);
  else if constexpr (W == 48) wgmma_n48<TA, TB>(d, a, b);
  else wgmma_n64<TA, TB>(d, a, b);
}

// byte offset of element (row, col) in a 128-byte swizzled tile whose rows
// are 64 bf16 (K-major A: row = M, col = K; MN-major B: row = K, col = N)
__device__ inline uint32_t sw128_off(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// --------------------------------------------------------------------------
// The large-M kernel body, shared by K1 (kGated false, one branch) and K5
// (true, two branches)
// --------------------------------------------------------------------------

constexpr int kLThreads = 384;      // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kLSlotsMax = 8;       // ring slots, as many as shared memory holds
constexpr int kLBM = 64;            // rows of x per row block
constexpr int kLG = 4;              // CTAs sharing a row block's t
constexpr int kLTN = 128;           // output columns per phase-2 tile, 64 a warpgroup
constexpr int kLKC = 64;            // rows of U per phase-1 stage
constexpr int kLNPass = 128;        // t columns a CTA computes in one phase-1 pass
constexpr int kLTRes = 512;         // largest padded rank whose t stays in shared memory
// rank rows of V per phase-2 stage: 128 for K1, 64 a branch for K5
__host__ __device__ constexpr int large_kc2(int nb) { return 128 / nb; }
// one ring slot: phase 1 [x tile | U chunk]; phase 2 [V tile per branch]
constexpr int kLXBytes = kLBM * 128;                  // x: 64 rows x 64 columns
constexpr int kLUOff = kLXBytes;
constexpr int kLUBytes = (kLNPass / 64) * kLKC * 128;  // U: 64 rows x kLNPass
// one branch's V tile: KC2 rank rows x 128 columns; a phase-2 stage holds
// every branch's
__host__ __device__ constexpr int large_vbytes(int nb) {
  return (kLTN / 64) * large_kc2(nb) * 128;
}
// one branch's t chunk when t streams through the ring: 64 rows x KC2 ranks
__host__ __device__ constexpr int large_tbytes(int nb) { return (large_kc2(nb) / 64) * kLBM * 128; }
// a ring slot holds phase 1's stage and phase 2's (with t: `stream`)
__host__ __device__ constexpr int large_slot(int nb, bool stream = false) {
  return kLUOff + kLUBytes > nb * (large_vbytes(nb) + (stream ? large_tbytes(nb) : 0))
             ? kLUOff + kLUBytes
             : nb * (large_vbytes(nb) + (stream ? large_tbytes(nb) : 0));
}
static_assert(large_slot(1) % 1024 == 0 && large_slot(2) % 1024 == 0 &&
                  large_slot(1, true) % 1024 == 0 && large_slot(2, true) % 1024 == 0,
              "ring slots keep 1 KB swizzle atoms aligned");

// The padded rank: the larger branch's rank rounded up to whole phase-2
// stages (so each CTA's quarter of t is a multiple of 16 columns).  K5's
// branches share it; the smaller branch reads zero columns of U and zero
// rows of V past its own rank, so its t is exact zeros there.
__host__ __device__ inline int large_rp(const int* r, int nb) {
  const int rm = nb == 2 && r[1] > r[0] ? r[1] : r[0];
  return round_up(rm, large_kc2(nb));
}

// Shared memory: [t of each branch][output tile of each consumer
// warpgroup][ring slots][full | empty][t full, t free], behind up to 1 KB of
// alignment slack.  Past kLTRes padded ranks (Zamba2's 640-1408, the VLM's
// 3200) the row block's t (128 bytes a rank) no longer fits beside the ring, and
// streams through it instead: each phase-2 slot carries the stage's KC2
// ranks of t beside its V tile (stream_t; no t region).
constexpr int kLOutBytes = kLBM * 64 * 2;  // a warpgroup's 64 x 64 bf16 output tile
struct LargeSmem {
  int t_bytes, out_off, ring_off, bar_off, slots, slot, stream_t;
  size_t total;
};

inline LargeSmem large_layout(const int* r, int nb) {
  LargeSmem L;
  L.stream_t = large_rp(r, nb) > kLTRes;
  L.t_bytes = L.stream_t ? 0 : kLBM * large_rp(r, nb) * 2;
  L.out_off = nb * L.t_bytes;
  L.ring_off = L.out_off + 2 * kLOutBytes;
  const int room = kSmemMax - 1024 - L.ring_off - (2 * kLSlotsMax + 2) * 8;
  L.slot = large_slot(nb, L.stream_t);
  L.slots = room / L.slot < kLSlotsMax ? room / L.slot : kLSlotsMax;
  L.bar_off = L.ring_off + L.slots * L.slot;
  L.total = 1024 + (size_t)L.bar_off + (2 * kLSlotsMax + 2) * 8;
  return L;
}

// Global scratch of one launch: t of every row block and branch, bf16
// [nb][rows rounded to 64][rp]; U of every branch with rows padded to 8
// elements [nb][C][round_up(r_max, 8)]; then the flags: one per (row block,
// CTA) for t, one per CTA for the padded U.
__host__ __device__ inline size_t large_t_elems(int M, const int* r, int nb) {
  return (size_t)round_up(M, kLBM) * large_rp(r, nb);
}
__host__ __device__ inline int large_rpad(const int* r, int nb) {
  return round_up(nb == 2 && r[1] > r[0] ? r[1] : r[0], 8);
}

struct LargeArgs {
  const bf16* x;
  const bf16* u[2];
  const bf16* v[2];
  bf16* y;
  bf16* t;                   // global t scratch
  bf16* upad;                // U with 16-byte aligned rows: [branch][C][rpad]
  unsigned long long* flag;  // [row block][CTA]: `id` once its t slice is stored
  unsigned long long* flag0;  // [CTA]: `id` once its share of upad is stored
  unsigned long long id;     // this launch's flag value, unique in the process
  int M, C, S;
  int r[2];
  int x_tma, v_tma[2], u_direct, y_tma;
  int groups;  // groups of kLG CTAs in the grid; group g takes row blocks g, g + groups, ...
  LargeSmem L;
};

__device__ inline bf16 ldg_bf16(const bf16* p) {
  return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// Producer: x tile (64 x 64) by element loads into the K-major layout.
__device__ inline void fill_x_elems(const LargeArgs& a, int m0, int c0, unsigned char* dst,
                                    int pt) {
  constexpr int kIt = kLBM * 32 / 128;  // bf16 pairs per producer thread
  unsigned w[kIt];
#pragma unroll
  for (int it = 0; it < kIt; ++it) {  // every load in flight before any store
    const int e = pt + 128 * it, row = e >> 5, col = (e & 31) * 2, m = m0 + row;
    bf16 v0 = __float2bfloat16(0.0f), v1 = v0;
    if (m < a.M) {
      const bf16* src = a.x + (size_t)m * a.C + c0 + col;
      if (c0 + col < a.C) v0 = ldg_bf16(src);
      if (c0 + col + 1 < a.C) v1 = ldg_bf16(src + 1);
    }
    w[it] = pack2(v0, v1);
  }
#pragma unroll
  for (int it = 0; it < kIt; ++it) {
    const int e = pt + 128 * it;
    *reinterpret_cast<unsigned*>(dst + sw128_off(e >> 5, (e & 31) * 2)) = w[it];
  }
}

// barrier of the producer warpgroup only (128 threads, barrier 2)
__device__ inline void producer_sync() { asm volatile("bar.sync 2, 128;\n" ::: "memory"); }

// Producer: rank rows [r0, r0+KC2) x columns [n0, n0+128) of V (r, S) into
// the MN-major layout (one KC2-row box per 64 columns), zeros past r and S.
template <int KC2>
__device__ inline void fill_v_elems(const bf16* __restrict__ v, int r, int S, int r0, int n0,
                                    unsigned char* dst, int pt) {
  constexpr int half = kLTN / 2, kIt = KC2 * half / 128;
  for (int i0 = 0; i0 < kIt; i0 += 8) {
    unsigned w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = pt + 128 * (i0 + j);
      const int k = e / half, n = (e - k * half) * 2, rr = r0 + k, col = n0 + n;
      bf16 v0 = __float2bfloat16(0.0f), v1 = v0;
      if (rr < r) {
        const bf16* src = v + (size_t)rr * S + col;
        if (col < S) v0 = ldg_bf16(src);
        if (col + 1 < S) v1 = ldg_bf16(src + 1);
      }
      w[j] = pack2(v0, v1);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = pt + 128 * (i0 + j);
      const int k = e / half, n = (e - k * half) * 2;
      *reinterpret_cast<unsigned*>(dst + (n >> 6) * (KC2 * 128) + sw128_off(k, n & 63)) =
          w[j];
    }
  }
}

// One consumer warpgroup's view of the ring: wait for a stage; release it
// once its wgmma group is done.  With retire, one group stays in flight
// (stage g is released after stage g+1's group is issued); with
// release_now, none does and the producer may run one stage further ahead.
struct RingReader {
  uint64_t* full;
  uint64_t* empty;
  int ns, slot_bytes, prev;
  __device__ const unsigned char* wait(const unsigned char* ring, int g) {
    const int slot = g % ns;
    mbar_wait(full + slot, (g / ns) & 1);
    return ring + slot * slot_bytes;
  }
  // after the commit of stage g's group: wait for it and release g at once
  __device__ void release_now(int g) {
    wgmma_wait<0>();
    if (threadIdx.x % 128 == 0) mbar_arrive(empty + g % ns);
  }
  // after the commit of stage g's group
  __device__ void retire(int g) {
    wgmma_wait<1>();
    if (prev >= 0 && threadIdx.x % 128 == 0) mbar_arrive(empty + prev);
    prev = g % ns;
  }
  __device__ void drain() {
    wgmma_wait<0>();
    if (prev >= 0 && threadIdx.x % 128 == 0) mbar_arrive(empty + prev);
    prev = -1;
  }
};

// 4-lane rotation: lane t of each quad ends with chunk t of the quad's four
// words p0..p3 (p_i of lane t' lands in word t' of lane i's chunk).
__device__ inline uint4 quad_transpose(unsigned p0, unsigned p1, unsigned p2, unsigned p3) {
  const int lane = threadIdx.x % 32, t = lane & 3;
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = (t + i) & 3;  // the chunk this lane sends to lane k
    const unsigned send = k == 0 ? p0 : k == 1 ? p1 : k == 2 ? p2 : p3;
    const unsigned got = __shfl_sync(0xffffffffu, send, (lane & ~3) | ((t - i) & 3));
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (s == ((t - i) & 3)) w[s] = got;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Consumer phase 1 of one pass of one branch: warpgroup w computes columns
// [col0 + 64 w, col0 + 64 w + W) of t (W = 64 and Np - 64 for a pass of Np
// > 64 columns; Np and 0 else), one wgmma of width W per 16-deep step, W
// known at compile time (a wgmma behind a runtime test is serialised by
// ptxas).  The slice is rounded to bf16 and stored to the global scratch,
// 16 bytes a lane.
template <int NB, int W>
__device__ inline void consume_phase1(const LargeArgs& a, const unsigned char* ring,
                                      RingReader& rd, int& g, int nc1, int col0, int rp, int m0,
                                      int wg, int b) {
  constexpr int R = W ? W / 2 : 1;  // accumulator registers
  const int w4 = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  for (int i = 0; i < nc1; ++i, ++g) {
    const unsigned char* st = rd.wait(ring, g);
    fence_regs(acc);
    wgmma_fence();
    if constexpr (W > 0) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const unsigned char* ub = st + kLUOff + wg * (kLKC * 128) + ks * 2048;
        wgmma_w<W>(acc, sw128_desc(st + ks * 32, 16, 1024), sw128_desc(ub, kLKC * 128, 1024));
      }
    }
    wgmma_commit();
    rd.release_now(g);  // phase-1 groups are short: look-ahead matters more
    fence_regs(acc);
  }
  // rows past M hold zeros (x is zero there) and land in the scratch's
  // padding rows
  bf16* tb = a.t + (size_t)b * large_t_elems(a.M, a.r, NB);
#pragma unroll
  for (int sl = 0; sl < W / 16; ++sl) {
    const uint4 chunk = quad_transpose(
        pack2(__float2bfloat16(acc[8 * sl + 0]), __float2bfloat16(acc[8 * sl + 1])),
        pack2(__float2bfloat16(acc[8 * sl + 2]), __float2bfloat16(acc[8 * sl + 3])),
        pack2(__float2bfloat16(acc[8 * sl + 4]), __float2bfloat16(acc[8 * sl + 5])),
        pack2(__float2bfloat16(acc[8 * sl + 6]), __float2bfloat16(acc[8 * sl + 7])));
    // chunk t = (8-column group t / 2, row half t % 2) of 16-column group sl
    const int t = lane & 3;
    const int row = m0 + 16 * w4 + lane / 4 + 8 * (t & 1);
    const int col = col0 + 64 * wg + 16 * sl + 8 * (t >> 1);
    *reinterpret_cast<uint4*>(tb + (size_t)row * rp + col) = chunk;
  }
}

template <int NB, bool kGated>
__device__ inline void large_body(const LargeArgs& a, const CUtensorMap* xmap,
                                  const CUtensorMap* vmap0, const CUtensorMap* vmap1,
                                  const CUtensorMap* tmap0, const CUtensorMap* tmap1,
                                  const CUtensorMap* umap0, const CUtensorMap* umap1,
                                  const CUtensorMap* ymap) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int KC2 = large_kc2(NB), VB = large_vbytes(NB), TB = large_tbytes(NB);
  const LargeSmem& L = a.L;
  const int SLOT = L.slot;
  unsigned char* ring = base + L.ring_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bar_off);
  uint64_t* empty = full + kLSlotsMax;
  uint64_t* t_full = empty + kLSlotsMax;
  uint64_t* t_free = t_full + 1;
  const int ns = L.slots;

  const int grp = blockIdx.x / kLG, q = blockIdx.x % kLG;
  const int nrb = (a.M + kLBM - 1) / kLBM;
  const int rp = large_rp(a.r, NB);
  const int N = rp / kLG;           // t columns this CTA computes: [q N, (q+1) N)
  const int npass = (N + kLNPass - 1) / kLNPass;  // of kLNPass columns each
  const int nc1 = (a.C + 63) / 64;  // phase-1 stages a branch
  const int nc2 = rp / KC2;         // phase-2 stages a tile
  const int ntiles = (a.S + kLTN - 1) / kLTN;
  const int my_tiles = ntiles > q ? (ntiles - q + kLG - 1) / kLG : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full + s, 1);    // one producer thread arrives (with the TMA bytes)
      mbar_init(empty + s, 2);   // one thread per consumer warpgroup
    }
    mbar_init(t_full, 1);
    mbar_init(t_free, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Phase 0: this CTA's rows of every U ([blockIdx.x * rpc, +rpc), rpc =
  // ceil(C / gridDim.x)) copied into rows padded to 16 bytes, a layout TMA
  // can read, then its flag
  const int rpad = large_rpad(a.r, NB), rpc = (a.C + gridDim.x - 1) / gridDim.x;
  if (!a.u_direct) {
    const int c_lo = blockIdx.x * rpc, c_hi = c_lo + rpc < a.C ? c_lo + rpc : a.C;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int r = a.r[b];
      for (int n = threadIdx.x; n < r; n += kLThreads) {
        for (int c0 = c_lo; c0 < c_hi; c0 += 8) {  // 8 rows' loads in flight
          bf16 v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (c0 + k < c_hi) v[k] = ldg_bf16(a.u[b] + (size_t)(c0 + k) * r + n);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (c0 + k < c_hi) a.upad[((size_t)b * a.C + c0 + k) * rpad + n] = v[k];
        }
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && !a.u_direct) st_release_u64(a.flag0 + blockIdx.x, a.id);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------- producer warpgroup ----------------
    const int pt = threadIdx.x - 256;
    if (pt == 0) {
      const CUtensorMap* maps[8] = {xmap, vmap0, vmap1, tmap0, tmap1, umap0, umap1, ymap};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(maps[i]))
                     : "memory");
    }
    if (pt == 0) {  // V is read after phase 1: have L2 fetch this CTA's share now
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (!a.v_tma[b]) continue;
        const size_t total = (size_t)a.r[b] * a.S * 2 & ~(size_t)15;
        const size_t share = ((total + gridDim.x - 1) / gridDim.x + 15) & ~(size_t)15;
        const size_t off = share * blockIdx.x;
        if (off < total)
          bulk_prefetch_l2(reinterpret_cast<const unsigned char*>(a.v[b]) + off,
                           (uint32_t)(total - off < share ? total - off : share));
      }
    }
    // every CTA's rows of the padded U are stored (each producer thread
    // watches some CTAs' flags) before the first TMA read of it
    for (int k = pt; !a.u_direct && k < (int)gridDim.x && k * rpc < a.C; k += 128) {
      uint64_t t0 = 0;
      for (uint32_t polls = 0; ld_acquire_u64(a.flag0 + k) != a.id; ++polls) {
        if ((polls & 1023) == 1023) {
          if (!t0) t0 = global_ns();
          else if (global_ns() - t0 > 10000000000ull) __trap();
        }
      }
    }
    producer_sync();
    fence_async_global();
    int g = 0, round = 0;
    for (int rb = grp; rb < nrb; rb += a.groups, ++round) {
      const int m0 = rb * kLBM;
      // Phase 1: x tiles and this CTA's N columns of the padded U (one
      // 64-column box per 64 columns), branch by branch and pass by pass
      // (kLNPass columns a pass, x read again each pass), all by TMA when x
      // is aligned
      for (int b = 0; b < NB; ++b)
      for (int ps = 0; ps < npass; ++ps)
      for (int c0 = 0; c0 < a.C; c0 += 64, ++g) {
        const int slot = g % ns;
        const int col0 = q * N + ps * kLNPass, np_ = N - ps * kLNPass;
        const int ub = ((np_ < kLNPass ? np_ : kLNPass) + 63) / 64;
        // U boxes starting past the rank are zeros (t is exactly zero there)
        const int u_in = col0 < a.r[b] ? (a.r[b] - col0 + 63) / 64 : 0;
        const int u_boxes = u_in < ub ? u_in : ub;
        const bool fill = !a.x_tma || u_boxes < ub;  // the whole warpgroup stores
        // every producer thread waits (a parity wait must not run a phase
        // ahead); thread 0 alone arrives, with the TMA bytes
        mbar_wait(empty + slot, ((g / ns) & 1) ^ 1);
        unsigned char* st = ring + slot * SLOT;
        if (fill) {
          if (!a.x_tma) fill_x_elems(a, m0, c0, st, pt);
          for (int i = u_boxes * (kLKC * 128) / 16 + pt; i < ub * (kLKC * 128) / 16; i += 128)
            reinterpret_cast<uint4*>(st + kLUOff)[i] = make_uint4(0, 0, 0, 0);
          fence_async_shared();
          producer_sync();
        }
        if (pt == 0) {
          mbar_arrive_tx(full + slot, (a.x_tma ? kLXBytes : 0) + u_boxes * kLKC * 128);
          if (a.x_tma) tma_load_2d(st, xmap, c0, m0, full + slot);
          for (int k = 0; k < u_boxes; ++k)
            tma_load_2d(st + kLUOff + k * (kLKC * 128), b ? umap1 : umap0, col0 + 64 * k, c0,
                        full + slot);
        }
      }
      // t of the row block, once all kLG slices are stored and this CTA's
      // consumers are done with the previous row block's t
      if (pt < kLG) {  // one thread a slice
        const unsigned long long* f = a.flag + (size_t)rb * kLG + pt;
        uint64_t t0 = 0;
        for (uint32_t polls = 0; ld_acquire_u64(f) != a.id; ++polls) {
          if ((polls & 1023) == 1023) {
            if (!t0) t0 = global_ns();
            else if (global_ns() - t0 > 10000000000ull) __trap();
          }
        }
      }
      __syncwarp();
      if (pt == 0) fence_async_global();
      if (pt == 0 && !L.stream_t) {
        if (round) mbar_wait(t_free, (round - 1) & 1);
        mbar_arrive_tx(t_full, NB * kLBM * rp * 2);
        for (int b = 0; b < NB; ++b)
          for (int kb = 0; kb < rp / 64; ++kb)
            tma_load_2d(base + b * L.t_bytes + kb * (kLBM * 128), b ? tmap1 : tmap0, kb * 64,
                        m0, t_full);
      }
      // Phase 2: V tiles, by TMA where V is aligned and the stage starts
      // inside the branch's rank, else element fills (zeros past the rank);
      // with stream_t also the stage's ranks of t, by TMA
      for (int ti = 0; ti < my_tiles; ++ti) {
        const int n0 = (q + ti * kLG) * kLTN;
        for (int ch = 0; ch < nc2; ++ch, ++g) {
          const int slot = g % ns, r0 = ch * KC2;
          bool fill = false;  // a branch's V not by TMA: the whole warpgroup stores
#pragma unroll
          for (int b = 0; b < NB; ++b) fill |= !(a.v_tma[b] && r0 < a.r[b]);
          mbar_wait(empty + slot, ((g / ns) & 1) ^ 1);
          unsigned char* st = ring + slot * SLOT;
          if (fill) {
#pragma unroll
            for (int b = 0; b < NB; ++b)
              if (!(a.v_tma[b] && r0 < a.r[b]))
                fill_v_elems<KC2>(a.v[b], a.r[b], a.S, r0, n0, st + b * VB, pt);
            fence_async_shared();
            producer_sync();
          }
          if (pt == 0) {
            uint32_t bytes = L.stream_t ? NB * TB : 0;
#pragma unroll
            for (int b = 0; b < NB; ++b)
              if (a.v_tma[b] && r0 < a.r[b])
                for (int bx = 0; bx < kLTN / 64; ++bx)
                  if (n0 + bx * 64 < a.S) bytes += KC2 * 128;
            mbar_arrive_tx(full + slot, bytes);
            if (L.stream_t)
#pragma unroll
              for (int b = 0; b < NB; ++b)
                for (int kb = 0; kb < KC2 / 64; ++kb)
                  tma_load_2d(st + NB * VB + b * TB + kb * (kLBM * 128), b ? tmap1 : tmap0,
                              r0 + kb * 64, m0, full + slot);
#pragma unroll
            for (int b = 0; b < NB; ++b)
              if (a.v_tma[b] && r0 < a.r[b])
                for (int bx = 0; bx < kLTN / 64; ++bx)
                  if (n0 + bx * 64 < a.S)
                    tma_load_2d(st + b * VB + bx * (KC2 * 128), b ? vmap1 : vmap0, n0 + bx * 64,
                                r0, full + slot);
          }
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  RingReader rd{full, empty, ns, SLOT, -1};
  const int w4 = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  int g = 0, round = 0;
  for (int rb = grp; rb < nrb; rb += a.groups, ++round) {
    const int m0 = rb * kLBM;
    for (int b = 0; b < NB; ++b)
      for (int ps = 0; ps < npass; ++ps) {
        const int col0 = q * N + ps * kLNPass;
        const int np_ = N - ps * kLNPass < kLNPass ? N - ps * kLNPass : kLNPass;
        switch (wg ? (np_ > 64 ? np_ - 64 : 0) : (np_ < 64 ? np_ : 64)) {  // this warpgroup's columns
          case 0: consume_phase1<NB, 0>(a, ring, rd, g, nc1, col0, rp, m0, wg, b); break;
          case 16: consume_phase1<NB, 16>(a, ring, rd, g, nc1, col0, rp, m0, wg, b); break;
          case 32: consume_phase1<NB, 32>(a, ring, rd, g, nc1, col0, rp, m0, wg, b); break;
          case 48: consume_phase1<NB, 48>(a, ring, rd, g, nc1, col0, rp, m0, wg, b); break;
          default: consume_phase1<NB, 64>(a, ring, rd, g, nc1, col0, rp, m0, wg, b); break;
        }
      }
    // publish this CTA's slice: every consumer thread's stores, then the flag
    __threadfence();
    consumers_sync();
    if (threadIdx.x == 0) st_release_u64(a.flag + (size_t)rb * kLG + q, a.id);
    if (!L.stream_t) mbar_wait(t_full, round & 1);  // the whole t of the row block, by TMA

    // Phase 2: output tiles of 64 rows x 128 columns, this warpgroup's 64
    // columns, one float32 accumulator per branch
    const int row = m0 + 16 * w4 + lane / 4;
    for (int ti = 0; ti < my_tiles; ++ti) {
      const int n0 = (q + ti * kLG) * kLTN + 64 * wg;
      float acc[NB][32];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[b][i] = 0.0f;
      for (int ch = 0; ch < nc2; ++ch, ++g) {
        const unsigned char* st = rd.wait(ring, g);
#pragma unroll
        for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
        wgmma_fence();
        // this stage's KC2 ranks of t (KC2 a multiple of 64: whole boxes),
        // resident or streamed with the stage
        const unsigned char* tb[NB];
#pragma unroll
        for (int b = 0; b < NB; ++b)
          tb[b] = L.stream_t ? st + NB * VB + b * TB
                             : base + b * L.t_bytes + (ch * KC2 / 64) * (kLBM * 128);
#pragma unroll
        for (int ks = 0; ks < KC2 / 16; ++ks) {
          const int kl = ks * 16;  // rank within the stage
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            const unsigned char* ta = tb[b] + (kl >> 6) * (kLBM * 128) + ((kl & 63) >> 4) * 32;
            const unsigned char* vb = st + b * VB + wg * (KC2 * 128) + ks * 2048;
            wgmma_n64(acc[b], sw128_desc(ta, 16, 1024), sw128_desc(vb, KC2 * 128, 1024));
          }
        }
        wgmma_commit();
        rd.retire(g);
#pragma unroll
        for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
      }
      rd.drain();
#pragma unroll
      for (int b = 0; b < NB; ++b) fence_regs(acc[b]);
      // epilogue: one rounding per element.  With an aligned y the tile
      // goes through shared memory (the 128-byte swizzled box of y's tensor
      // map) and one TMA store, which clips rows past M and columns past S
      // and overlaps the next tile; else straight to y, masked.
      unsigned char* ot = base + L.out_off + wg * kLOutBytes;
      if (a.y_tma) {
        if (threadIdx.x % 128 == 0) tma_store_wait_read();  // the last tile's store read ot
        warpgroup_sync(wg);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float o[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            if (kGated) {
              const float gt = acc[0][i], up = acc[NB - 1][i];
              o[e] = gt / (1.0f + expf(-gt)) * up;
            } else {
              o[e] = acc[0][i];
            }
          }
          const unsigned pair = pack2(__float2bfloat16(o[0]), __float2bfloat16(o[1]));
          if (a.y_tma) {
            *reinterpret_cast<unsigned*>(
                ot + sw128_off(16 * w4 + lane / 4 + 8 * h, 8 * j + 2 * (lane % 4))) = pair;
            continue;
          }
          const int m = row + 8 * h;
          if (m >= a.M || n >= a.S) continue;
          bf16* dst = a.y + (size_t)m * a.S + n;
          if ((a.S & 1) == 0) {
            *reinterpret_cast<unsigned*>(dst) = pair;
          } else {
            dst[0] = __float2bfloat16(o[0]);
            if (n + 1 < a.S) dst[1] = __float2bfloat16(o[1]);
          }
        }
      }
      if (a.y_tma) {
        fence_async_shared();
        warpgroup_sync(wg);
        if (threadIdx.x % 128 == 0) tma_store_2d(ymap, ot, n0, m0);
      }
    }
    // this warpgroup no longer reads t: the next row block's t may land
    if (threadIdx.x % 128 == 0 && !L.stream_t) mbar_arrive(t_free);
  }
  // the output tiles' stores are done before shared memory goes
  if (a.y_tma && threadIdx.x % 128 == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// --------------------------------------------------------------------------
// Host side: tensor maps and the launch
// --------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda PyTorch has already loaded (the
// libraries link no libcuda of their own).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_LOCAL);
    if (lib) fn = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The current device, bound to this thread: libcuda's map encoder needs a
// current context, which a thread that has made no runtime call yet
// (autograd's backward thread) lacks.
inline cudaError_t bind_device(int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  return e == cudaSuccess ? cudaSetDevice(*dev) : e;
}

inline bool tma_ok(const void* p, int row_elems) {
  return (reinterpret_cast<size_t>(p) & 15) == 0 && row_elems % 8 == 0;
}

// Tensor map of a row-major bf16 (rows, cols) matrix (rows `pitch`
// elements apart, default cols) read in 64-column x box_rows boxes with
// the 128-byte swizzle, zeros out of bounds.
inline cudaError_t make_map(CUtensorMap* map, const void* p, int rows, int cols,
                            int box_rows, int pitch = 0) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(pitch ? pitch : cols) * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Byte offsets in the global scratch of a launch: [t | padded U | t flags
// | U flags], each part 16-byte aligned.
constexpr int kLMaxCTAs = 1024;  // the most CTAs a launch takes
struct LargeScratch {
  size_t upad, flag, flag0, total;
};
inline LargeScratch large_scratch(int M, int C, const int* r, int nb) {
  LargeScratch s;
  const auto up16 = [](size_t n) { return (n + 15) & ~(size_t)15; };
  s.upad = up16((size_t)nb * large_t_elems(M, r, nb) * 2);
  s.flag = s.upad + up16((size_t)nb * C * large_rpad(r, nb) * 2);
  const size_t nrb = (M + kLBM - 1) / kLBM;
  s.flag0 = s.flag + nrb * kLG * 8;
  s.total = s.flag0 + kLMaxCTAs * 8;  // one flag a CTA of the grid
  return s;
}

// Build the maps, size shared memory and launch `kernel` (NB branches):
// kLG CTAs a row block, as many groups as the card holds at once (a
// cooperative launch, so all CTAs run together and may wait on each
// other), each group walking row blocks g, g + groups, ...
template <int NB, typename Kernel>
inline cudaError_t launch_large(Kernel kernel, LargeArgs a, void* scratch, cudaStream_t stream,
                                size_t* reserved) {
  static unsigned long long next_id = 0x5eed000000000001ull;
  int dev = 0;
  cudaError_t e;
  if ((e = bind_device(&dev)) != cudaSuccess) return e;
  CUtensorMap xmap, vmap[2], tmap[2], umap[2], ymap;
  memset(&ymap, 0, sizeof ymap);
  memset(&xmap, 0, sizeof xmap);
  memset(vmap, 0, sizeof vmap);
  memset(tmap, 0, sizeof tmap);
  memset(umap, 0, sizeof umap);
  const int rp = large_rp(a.r, NB), rpad = large_rpad(a.r, NB);
  const size_t t_elems = large_t_elems(a.M, a.r, NB);
  const LargeScratch sc = large_scratch(a.M, a.C, a.r, NB);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  a.t = reinterpret_cast<bf16*>(base);
  a.upad = reinterpret_cast<bf16*>(base + sc.upad);
  a.flag = reinterpret_cast<unsigned long long*>(base + sc.flag);
  a.flag0 = reinterpret_cast<unsigned long long*>(base + sc.flag0);
  a.id = __atomic_fetch_add(&next_id, 1ull, __ATOMIC_RELAXED);  // also from autograd's thread
  a.x_tma = tma_ok(a.x, a.C);
  a.y_tma = tma_ok(a.y, a.S);
  // U is read where it lies when TMA can (aligned rows of a multiple of 8
  // elements); else phase 0 copies it into rows padded to 8 elements
  a.u_direct = 1;
  for (int b = 0; b < NB; ++b) a.u_direct &= tma_ok(a.u[b], a.r[b]);
  if (a.y_tma && (e = make_map(&ymap, a.y, a.M, a.S, kLBM)) != cudaSuccess) return e;
  if (a.x_tma && (e = make_map(&xmap, a.x, a.M, a.C, kLBM)) != cudaSuccess) return e;
  for (int b = 0; b < NB; ++b) {
    a.v_tma[b] = tma_ok(a.v[b], a.S);
    if (a.v_tma[b] && (e = make_map(&vmap[b], a.v[b], a.r[b], a.S, large_kc2(NB))) != cudaSuccess)
      return e;
    if ((e = make_map(&tmap[b], a.t + b * t_elems, round_up(a.M, kLBM), rp, kLBM)) !=
        cudaSuccess)
      return e;
    // the padded U: rows of rpad elements, columns past r out of bounds
    const bf16* u = a.u_direct ? a.u[b] : a.upad + (size_t)b * a.C * rpad;
    if ((e = make_map(&umap[b], u, a.C, a.r[b], kLKC, a.u_direct ? a.r[b] : rpad)) !=
        cudaSuccess)
      return e;
  }
  a.L = large_layout(a.r, NB);
  const LargeSmem& L = a.L;
  if (L.slots < 2) return cudaErrorInvalidValue;
  if ((e = reserve_smem(kernel, L.total, reserved)) != cudaSuccess) return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLThreads,
                                                         L.total)) != cudaSuccess)
    return e;
  const int nrb = (a.M + kLBM - 1) / kLBM;
  const int fit = (sms * per_sm < kLMaxCTAs ? sms * per_sm : kLMaxCTAs) / kLG;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  // padding U (phase 0) is spread over every CTA the card holds, also those
  // of groups without a row block, which only copy
  a.groups = nrb < fit ? nrb : fit;
  const int grid_groups = a.u_direct ? a.groups : fit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kLG * grid_groups);
  cfg.blockDim = dim3(kLThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, xmap, vmap[0], vmap[1], tmap[0], tmap[1],
                            umap[0], umap[1], ymap);
}

}  // namespace repro
