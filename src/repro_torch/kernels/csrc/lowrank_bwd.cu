// K2-K4: the low-rank matmul's backward, y = bf16( bf16(x U) V ):
//
//   K2 (dx)  dx = bf16( bf16(dy Vᵀ) Uᵀ )        dy (M,S), U (C,r), V (r,S) -> (M,C)
//   K3 (dU)  dU = bf16( xᵀ bf16(dy Vᵀ) )        x (M,C), dy, V             -> (C,r)
//   K4 (dV)  dV = bf16( bf16(x U)ᵀ dy )         x, U, dy                   -> (r,S)
//
// float32 accumulation everywhere; the rank-r intermediate (dt or t) is
// rounded to bf16 once, after its full float32 sum, and the output once,
// as the TPU kernels do.
//
// Replaces the TPU kernels of repro/kernels/lowrank_bwd.py:
// lowrank_matmul_dx (`_dx_kernel`, `_dx_kernel_db`, pallas_call at 116),
// lowrank_matmul_du (`_du_kernel`, 215) and lowrank_matmul_dv (`_dv_kernel`,
// 298).  Their grids keep dt or t in a VMEM scratch and rebuild it once per
// C block (K3) or S block (K4): FLOPs on the idle MXU traded for HBM bytes.
//
// What bounds them on the H100: at the training shapes (M = B*S = 2048
// tokens, C and S <= 2560, r <= 349) each does 2-5 GFLOP on 5-17 MB, so
// the bf16 tensor-core peak and the HBM rate give bounds of the same
// order (1.6-5.1 us); neither is far below the other.
//
// K2 (simple first, PR 12 design): each product is one launch of a generic
// tiled tensor-core GEMM (`gemm_kernel`: 64x64 output tile per CTA, 4 warps
// of 32x32, mma.sync m16n8k16, K walked in 32-deep tiles through two
// shared-memory buffers with the next tile prefetched into registers).
// Operands are read in place, transposed or not: each names the strides of
// its (row, k) element, and the loader copies 16-byte vectors along the
// contiguous dimension into a k-contiguous shared-memory tile.
//
// K3 and K4 (the Hopper design, PR 16): both products of each run on
// wgmma fed by TMA (`tc_gemm`), with no operand transposed element by
// element.
//   Phase 1 forms the rank-r intermediate once, M x r, into a scratch with
//   rows padded to 8 elements (L2-resident: 1.4 MB at r = 349): K4's t =
//   x U (A = x K-major, B = U MN-major: wgmma's transpose-B) and K3's dt =
//   dy Vᵀ (A = dy K-major, B = V K-major: V's rows are Vᵀ's columns).
//   Output tiles are 64 x 64 (one consumer warpgroup a CTA) where those
//   still fit one wave, else 64 x 128.
//   Phase 2 contracts over M: dU = xᵀ dt and dV = tᵀ dy.  Both operands
//   have M as their row, so A is MN-major too: TMA loads every tile in its
//   natural layout and wgmma reads A with transpose-A and B with
//   transpose-B.  Output tiles are 64 x 128, and M is split so that tiles
//   x splits fill about one wave of SMs (kernels/lowrank_bwd.py's
//   `split_plan`; splits are whole 128-row stages, in order).  With one
//   split the epilogue writes bf16; with more, each CTA writes a float32
//   partial and a last launch sums them in split order: fixed, so two
//   calls give the same bits; no atomics, no flags, nothing that outlives
//   the call in the scratch.
// A CTA: 2 consumer warpgroups, each one 64 x 64 half of the output tile
// (one wgmma m64n64k16 per 16-deep step, float32 in registers), and one
// producer thread that keeps a ring of 128-deep stages (32 or 48 KB: A's
// tile and each consumer's B tile) full by TMA, with full/empty mbarriers.
// Every box is 64 bf16 wide (128 bytes, the 128-byte swizzle): MN-major
// tiles are one 64 x 128 box, K-major ones two 64 x 64 boxes.  TMA fills
// zeros past every edge, so any M, C, r <= 512 and S is taken.  An operand
// TMA cannot read (base not 16-byte aligned, or rows not a multiple of 8
// elements: U at ranks 349 and 239, whose rows are 698 and 478 bytes) is
// first copied by a pad launch into the scratch, rows padded to 8 elements.
// What bounds this design (measured on the H100): a cost per ring stage
// that barely depends on what the stage loads or multiplies, hence
// 128-deep stages, and a fixed cost per launch (the first load from
// memory, the epilogue).  Summing the splits inside the launch instead, a
// tile's splits one cluster reducing through distributed shared memory,
// measured slower: 32 clusters of 4 did not fit one wave.
// Launches a call: pad (only then), phase 1, phase 2, and the reduction
// (only with splits > 1), each after the first a programmatic dependent of
// the one before, so its launch and prologue overlap that one's tail.
// K3's kernels are named k3_*, K4's k4_*, so a profile tells them apart
// from each other and from K2's gemm_kernel.

#include "common.cuh"

namespace repro {
namespace bwd {

constexpr int kGM = 64;          // output rows per CTA
constexpr int kGN = 64;          // output columns per CTA
constexpr int kGK = 32;          // K depth per shared-memory tile
constexpr int kGThreads = 128;   // 4 warps, 2 x 2, each 32 x 32
constexpr int kGLd = kGK + 8;    // smem row stride (elements): conflict-free fragments
constexpr int kVecs = kGM * kGK / 8 / kGThreads;  // 16-byte vectors per thread per tile
static_assert(kGM == kGN, "one loader serves both operands");
static_assert(kVecs == 2, "loader mapping assumes two vectors per thread");

// One operand of a product: element (row, k) at p[row * s_row + k * s_k],
// rows in [0, rows).  One of the two strides is 1.
struct Operand {
  const bf16* p;
  int s_row, s_k, rows;
};

__host__ __device__ inline Operand operand(const void* p, int s_row, int s_k, int rows) {
  Operand o;
  o.p = static_cast<const bf16*>(p);
  o.s_row = s_row;
  o.s_k = s_k;
  o.rows = rows;
  return o;
}

// Vector q (0 .. 255) of a 64 x 32 tile: its first element's (row, k)
// offsets and whether its 8 elements run along k (else along rows).
// Along k: 4 vectors a row.  Along rows: 8 vectors a k column, so 8
// neighbouring threads read 128 contiguous bytes either way.
__device__ inline void vec_pos(int q, bool k_contig, int& row, int& k) {
  if (k_contig) {
    row = q / (kGK / 8);
    k = (q % (kGK / 8)) * 8;
  } else {
    k = q / (kGM / 8);
    row = (q % (kGM / 8)) * 8;
  }
}

// Registers <- the 64 x 32 tile at (row0, k0) of `op`, zero past its rows
// and past k_end.  `vec`: the operand's base is 16-byte aligned and the
// stride across vectors is a multiple of 8, so whole in-bounds vectors are
// single 16-byte loads.
__device__ inline void load_tile(const Operand& op, int row0, int k0, int k_end,
                                 bool k_contig, bool vec, uint4 (&regs)[kVecs]) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    int row, k;
    vec_pos(threadIdx.x + i * kGThreads, k_contig, row, k);
    row += row0;
    k += k0;
    const bool whole = k_contig ? (row < op.rows && k + 8 <= k_end)
                                : (row + 8 <= op.rows && k < k_end);
    if (vec && whole) {
      regs[i] = *reinterpret_cast<const uint4*>(op.p + (size_t)row * op.s_row +
                                                (size_t)k * op.s_k);
      continue;
    }
    unsigned short e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int rj = k_contig ? row : row + j, kj = k_contig ? k + j : k;
      e[j] = (rj < op.rows && kj < k_end)
                 ? __bfloat16_as_ushort(op.p[(size_t)rj * op.s_row + (size_t)kj * op.s_k])
                 : (unsigned short)0;
    }
    regs[i] = make_uint4(e[0] | (unsigned)e[1] << 16, e[2] | (unsigned)e[3] << 16,
                         e[4] | (unsigned)e[5] << 16, e[6] | (unsigned)e[7] << 16);
  }
}

// smem tile [64][kGLd], k contiguous <- registers of load_tile.
__device__ inline void store_tile(bf16* s, bool k_contig, const uint4 (&regs)[kVecs]) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    int row, k;
    vec_pos(threadIdx.x + i * kGThreads, k_contig, row, k);
    if (k_contig) {
      *reinterpret_cast<uint4*>(s + row * kGLd + k) = regs[i];
    } else {
      const unsigned short* e = reinterpret_cast<const unsigned short*>(&regs[i]);
      unsigned short* d = reinterpret_cast<unsigned short*>(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) d[(row + j) * kGLd + k] = e[j];
    }
  }
}

// acc[i][j] (the warp's 2 x 4 grid of 16 x 8 tiles) += As rows x Bs rows,
// both [64][kGLd] with k contiguous (B is the mma's col-major operand).
__device__ inline void tile_mma(const bf16* As, const bf16* Bs, float (&acc)[2][4][4],
                                int wm, int wn, int g, int t) {
  const unsigned* a32 = reinterpret_cast<const unsigned*>(As);
  const unsigned* b32 = reinterpret_cast<const unsigned*>(Bs);
#pragma unroll
  for (int kk = 0; kk < kGK; kk += 16) {
    unsigned a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm * 32 + i * 16 + g;
      a[i][0] = a32[(r * kGLd + kk + 2 * t) / 2];
      a[i][1] = a32[((r + 8) * kGLd + kk + 2 * t) / 2];
      a[i][2] = a32[(r * kGLd + kk + 2 * t + 8) / 2];
      a[i][3] = a32[((r + 8) * kGLd + kk + 2 * t + 8) / 2];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = wn * 32 + j * 8 + g;
      b[j][0] = b32[(n * kGLd + kk + 2 * t) / 2];
      b[j][1] = b32[(n * kGLd + kk + 2 * t + 8) / 2];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma16816(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b[j][0], b[j][1]);
  }
}

// out (M, N) = A (M x K) . B (K x N), A element (m, k) and B element (n, k)
// as their Operands say.  CTA (x, y, z) computes output tile (y, x) over K
// range [z * k_split, (z + 1) * k_split).  With `out` set, stores bf16 at
// out[m * o_ld + n]; otherwise stores the float32 partial into slab z of
// `part` (z * M * N + m * N + n).
__global__ void __launch_bounds__(kGThreads)
gemm_kernel(Operand A, Operand B, int M, int N, int K, int k_split,
            bf16* __restrict__ out, int o_ld, float* __restrict__ part) {
  __shared__ __align__(16) bf16 As[2][kGM * kGLd];
  __shared__ __align__(16) bf16 Bs[2][kGN * kGLd];
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int kb = blockIdx.z * k_split, ke = min(K, kb + k_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2, g = lane / 4, t = lane % 4;
  const bool a_kc = A.s_k == 1, b_kc = B.s_k == 1;
  const bool a_vec = aligned16(A.p) && (a_kc ? A.s_row : A.s_k) % 8 == 0;
  const bool b_vec = aligned16(B.p) && (b_kc ? B.s_row : B.s_k) % 8 == 0;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  const int nk = ke > kb ? (ke - kb + kGK - 1) / kGK : 0;
  uint4 ra[kVecs], rb[kVecs];
  if (nk > 0) {
    load_tile(A, m0, kb, ke, a_kc, a_vec, ra);
    load_tile(B, n0, kb, ke, b_kc, b_vec, rb);
    store_tile(As[0], a_kc, ra);
    store_tile(Bs[0], b_kc, rb);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) {  // the next tile's loads are in flight during this tile's MMAs
      load_tile(A, m0, kb + (kt + 1) * kGK, ke, a_kc, a_vec, ra);
      load_tile(B, n0, kb + (kt + 1) * kGK, ke, b_kc, b_vec, rb);
    }
    tile_mma(As[kt & 1], Bs[kt & 1], acc, wm, wn, g, t);
    if (more) {  // the other buffer was last read before the previous barrier
      store_tile(As[(kt + 1) & 1], a_kc, ra);
      store_tile(Bs[(kt + 1) & 1], b_kc, rb);
    }
    __syncthreads();
  }

  // acc[i][j][e]: row g (+8 for e >= 2), columns 2t, 2t+1 of 16 x 8 tile (i, j)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + i * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + j * 8 + 2 * t + (e & 1);
        if (m < M && n < N) {
          if (out != nullptr)
            out[(size_t)m * o_ld + n] = __float2bfloat16(acc[i][j][e]);
          else
            part[(size_t)blockIdx.z * M * N + (size_t)m * N + n] = acc[i][j][e];
        }
      }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// One K2 product into out (row stride o_ld), one split.
inline cudaError_t gemm(const Operand& A, const Operand& B, int M, int N, int K, bf16* out,
                        int o_ld, cudaStream_t stream) {
  const dim3 grid(cdiv(N, kGN), cdiv(M, kGM), 1);
  gemm_kernel<<<grid, kGThreads, 0, stream>>>(A, B, M, N, K, round_up(K, kGK), out, o_ld,
                                              nullptr);
  return cudaGetLastError();
}

// dt or t scratch: (M, r) with a row stride of ld = round_up(r, 8).
inline int scratch_ld(int r) { return round_up(r, 8); }

// --------------------------------------------------------------------------
// K3/K4: the Hopper design (see the note at the top)
// --------------------------------------------------------------------------

constexpr int kTThreads = 384;             // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kTBM = 64;                   // output rows per CTA: one wgmma M
constexpr int kTBN = 128;                  // output columns per CTA, 64 a consumer warpgroup
constexpr int kTBK = 128;                  // depth of a stage along the sum
constexpr int kTBox = 64 * 64 * 2;         // bytes of a 64 x 64 bf16 box (128-byte rows)
constexpr int kTOp = 2 * kTBox;            // one operand's 64 x kTBK tile of a stage
// The ring: stages of [A tile | B tile of each consumer warpgroup] (32 KB
// with kBN 64, 48 KB with 128), as many as 192 KB holds.  A stage costs
// about the same on the H100 however little it loads or multiplies, so
// stages are deep.
constexpr int kTRing = 192 * 1024;
constexpr int kTSlotsMax = kTRing / (2 * kTOp);
constexpr size_t kTSmem = 1024 + (size_t)kTRing + 2 * kTSlotsMax * 8;

// out (P x Q) = sum over k of A(p, k) B(k, q), k in this CTA's split of
// [0, K): whole kTBK stages [z nb / splits, (z + 1) nb / splits), nb =
// ceil(K / kTBK), as kernels/lowrank_bwd.py's split_rows.  A's map is over
// A stored (P, K) when K-major, (K, P) when MN-major; B's over B stored
// (Q, K) when K-major, (K, Q) when MN-major.  Boxes are 64 wide: 64 x 64
// K-major (two a stage, k and k + 64), 64 x 128 MN-major (one a stage).
struct TcArgs {
  int P, Q, K, splits;
  bf16* out;    // splits == 1: bf16 out[p * o_ld + q]
  int o_ld;
  float* part;  // splits > 1: float32 part[(z * P + p) * Q + q]
};

template <bool kAMN, bool kBMN, int kBN>
__device__ inline void tc_gemm(const TcArgs& a, const CUtensorMap* amap,
                               const CUtensorMap* bmap) {
  constexpr int sb = (kBN > 64 ? 3 : 2) * kTOp, ns = kTRing / sb;  // stage bytes, slots
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kTRing);
  uint64_t* empty = full + kTSlotsMax;
  const int q0 = blockIdx.x * kBN, p0 = blockIdx.y * kTBM, z = blockIdx.z;
  const int nb = (a.K + kTBK - 1) / kTBK;
  const int b0 = (int)((long long)z * nb / a.splits);
  const int nst = (int)((long long)(z + 1) * nb / a.splits) - b0;  // stages of this split
  const int nwg = kBN > 64 && a.Q - q0 > 64 ? 2 : 1;  // consumer warpgroups with columns
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full + s, 1);      // the producer thread arrives, with the TMA bytes
      mbar_init(empty + s, nwg);   // one thread per active consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  grid_dependents_may_launch();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---------------- producer: one thread issues every TMA load ----------------
    if (threadIdx.x != 256) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(amap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(bmap)) : "memory");
    // every global access of this CTA follows this wait (consumers read
    // only what these loads bring, and store after)
    grid_dependency_wait();
    for (int i = 0; i < nst; ++i) {
      const int slot = i % ns, k = (b0 + i) * kTBK;
      mbar_wait(empty + slot, ((i / ns) & 1) ^ 1);
      unsigned char* st = ring + slot * sb;
      // boxes past an edge, even wholly (k + 64 >= K), count whole and
      // land as zeros
      mbar_arrive_tx(full + slot, (1 + nwg) * kTOp);
      if (kAMN) {
        tma_load_2d(st, amap, p0, k, full + slot);
      } else {
        tma_load_2d(st, amap, k, p0, full + slot);
        tma_load_2d(st + kTBox, amap, k + 64, p0, full + slot);
      }
      for (int w = 0; w < nwg; ++w) {
        unsigned char* bt = st + (1 + w) * kTOp;
        const int qw = q0 + 64 * w;
        if (kBMN) {
          tma_load_2d(bt, bmap, qw, k, full + slot);
        } else {
          tma_load_2d(bt, bmap, k, qw, full + slot);
          tma_load_2d(bt + kTBox, bmap, k + 64, qw, full + slot);
        }
      }
    }
    return;
  }
  if (wg >= nwg) return;

  // ---------------- consumers: warpgroup wg, columns [q0 + 64 wg, +64) ----------------
  RingReader rd{full, empty, ns, sb, -1};
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  for (int i = 0; i < nst; ++i) {
    const unsigned char* st = rd.wait(ring, i);
    const unsigned char* bs = st + (1 + wg) * kTOp;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTBK / 16; ++ks) {
      // MN-major: 16 K rows are 2 KB (two 1 KB swizzle atoms); K-major: 16
      // K values are 32 bytes along a 128-byte row of box ks / 4.  Every
      // operand is one 64-wide atom across, so the MN-major atom stride
      // (lbo) is unused
      const int kb = (ks / 4) * kTBox + (ks % 4) * 32;
      const uint64_t ad = kAMN ? sw128_desc(st + ks * 2048, kTOp, 1024)
                               : sw128_desc(st + kb, 16, 1024);
      const uint64_t bd = kBMN ? sw128_desc(bs + ks * 2048, kTOp, 1024)
                               : sw128_desc(bs + kb, 16, 1024);
      wgmma_n64<kAMN ? 1 : 0, kBMN ? 1 : 0>(acc, ad, bd);
    }
    wgmma_commit();
    // each stage's group retires before the next is issued: with one left
    // in flight (RingReader::retire) ptxas serialises every wgmma here
    // (C7515); the other consumer warpgroup keeps the tensor cores busy
    rd.release_now(i);
    fence_regs(acc);
  }

  // epilogue: acc[4j + 2h + e] is row 16 w4 + lane / 4 + 8 h, column
  // 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 64 tile
  const int w4 = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int q = q0 + 64 * wg + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + 16 * w4 + lane / 4 + 8 * h;
      if (p >= a.P || q >= a.Q) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      const bool pair = q + 1 < a.Q;
      if (a.splits == 1) {
        bf16* dst = a.out + (size_t)p * a.o_ld + q;
        if (pair && (a.o_ld & 1) == 0) {
          *reinterpret_cast<unsigned*>(dst) = pack2(__float2bfloat16(v0), __float2bfloat16(v1));
        } else {
          dst[0] = __float2bfloat16(v0);
          if (pair) dst[1] = __float2bfloat16(v1);
        }
      } else {
        float* dst = a.part + ((size_t)z * a.P + p) * a.Q + q;
        if (pair && (a.Q & 1) == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (pair) dst[1] = v1;
        }
      }
    }
  }
}

// out[i] = bf16( sum over z in order of part[z * mn + i] ).
__device__ inline void reduce_splits(const float* __restrict__ part, int splits, size_t mn,
                                     bf16* __restrict__ out) {
  grid_dependency_wait();
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * mn + i];
    out[i] = __float2bfloat16(s);
  }
}

// dst (rows, ld) <- src (rows, cols), any alignment; columns [cols, ld)
// are not written (tensor maps stop at cols)
__device__ inline void pad_rows(const bf16* __restrict__ src, int rows, int cols,
                                bf16* __restrict__ dst, int ld) {
  grid_dependents_may_launch();
  grid_dependency_wait();  // ends after the grid before it: the chain completes in order
  const size_t n = (size_t)rows * cols;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[(i / cols) * ld + i % cols] = src[i];
}

// K3's and K4's kernels under names of their own, for profiles
#define REPRO_TC_KERNELS(op)                                                                  \
  template <bool kAMN, bool kBMN, int kBN>                                                    \
  __global__ void __launch_bounds__(kTThreads, 1)                                             \
      op##_gemm_kernel(const TcArgs a, const __grid_constant__ CUtensorMap amap,              \
                       const __grid_constant__ CUtensorMap bmap) {                            \
    tc_gemm<kAMN, kBMN, kBN>(a, &amap, &bmap);                                                \
  }                                                                                           \
  __global__ void op##_reduce_kernel(const float* __restrict__ part, int splits, size_t mn,   \
                                     bf16* __restrict__ out) {                                \
    reduce_splits(part, splits, mn, out);                                                     \
  }                                                                                           \
  __global__ void op##_pad_kernel(const bf16* __restrict__ src, int rows, int cols,           \
                                  bf16* __restrict__ dst, int ld) {                           \
    pad_rows(src, rows, cols, dst, ld);                                                       \
  }
REPRO_TC_KERNELS(k3)
REPRO_TC_KERNELS(k4)
#undef REPRO_TC_KERNELS

// A row-major bf16 operand (rows, cols) as the kernels read it: in place
// when TMA can, else from its padded copy in the scratch.
struct Src {
  const void* p;
  int rows, cols;
};

// Byte offsets in the scratch of one K3/K4 call: [intermediate (M x ld)
// bf16 | float32 partials (splits > 1) | padded copies of the operands TMA
// cannot read], each part 256-byte aligned.
struct TcScratch {
  size_t part, pad[3], total;
};
inline TcScratch tc_scratch(const Src (&src)[3], int M, int r, int P, int Q, int splits) {
  const auto up = [](size_t n) { return (n + 255) & ~(size_t)255; };
  TcScratch s;
  size_t off = up((size_t)M * scratch_ld(r) * 2);
  s.part = off;
  if (splits > 1) off += up((size_t)splits * P * Q * 4);
  for (int i = 0; i < 3; ++i) {
    s.pad[i] = off;
    if (!tma_ok(src[i].p, src[i].cols)) off += up((size_t)src[i].rows * round_up(src[i].cols, 8) * 2);
  }
  s.total = off;
  return s;
}

// Launch a tc_gemm kernel (kBN output columns a CTA) over the grid of its
// output tiles and splits; `dependent` as in launch_after.
template <auto Kernel, int kBN>
inline cudaError_t tc_launch(const TcArgs& a, const CUtensorMap& amap, const CUtensorMap& bmap,
                             bool dependent, cudaStream_t stream) {
  static size_t reserved = 0;
  cudaError_t e = reserve_smem(Kernel, kTSmem, &reserved);
  if (e != cudaSuccess) return e;
  const dim3 grid(cdiv(a.Q, kBN), cdiv(a.P, kTBM), a.splits);
  return launch_after(Kernel, grid, kTThreads, kTSmem, dependent, stream, a, amap, bmap);
}

// One K3 (kDU) or K4 call.  src: K4 {x (M, C), U (C, r), dy (M, S)}, K3
// {dy (M, S), V (r, S), x (M, C)}: phase 1's A and B, then phase 2's
// operand beside the intermediate.
template <bool kDU>
inline cudaError_t dudv(const Src (&src)[3], void* scratch, bf16* out, int M, int C, int r,
                        int S, int splits, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = bind_device(&dev);
  if (e != cudaSuccess) return e;
  const int P = kDU ? C : r, Q = kDU ? r : S, K1 = kDU ? S : C, ld = scratch_ld(r);
  if (splits < 1 || splits > cdiv(M, kTBK)) return cudaErrorInvalidValue;
  const TcScratch sc = tc_scratch(src, M, r, P, Q, splits);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  bf16* mid = reinterpret_cast<bf16*>(base);
  float* part = reinterpret_cast<float*>(base + sc.part);
  // the maps' view of each operand: in place, or padded first.  Every
  // launch after the call's first is a programmatic dependent of the one
  // before it (launch_after).
  int launches = 0;
  CUtensorMap map[3], mmap;
  for (int i = 0; i < 3; ++i) {
    const void* p = src[i].p;
    int pitch = src[i].cols;
    if (!tma_ok(p, pitch)) {
      bf16* dst = reinterpret_cast<bf16*>(base + sc.pad[i]);
      pitch = round_up(pitch, 8);
      const size_t n = (size_t)src[i].rows * src[i].cols;
      const int blocks = (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
      e = launch_after(kDU ? k3_pad_kernel : k4_pad_kernel, blocks, 256, 0, launches++ > 0,
                       stream, static_cast<const bf16*>(p), src[i].rows, src[i].cols, dst, pitch);
      if (e != cudaSuccess) return e;
      p = dst;
    }
    // MN-major (kTBK rows a box): U as K4's phase-1 B, and phase 2's operand
    const bool mn = i == 2 || (i == 1 && !kDU);
    if ((e = make_map(&map[i], p, src[i].rows, src[i].cols, mn ? kTBK : 64, pitch)) !=
        cudaSuccess)
      return e;
  }
  if ((e = make_map(&mmap, mid, M, r, kTBK, ld)) != cudaSuccess) return e;

  // phase 1: the intermediate (M x r), once, into the scratch; in 64-column
  // tiles (one consumer warpgroup a CTA) where those still fit one wave:
  // each CTA's walk over K is fed at a rate per SM, so more SMs finish
  // sooner
  int sms = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const bool narrow = cdiv(r, 64) * cdiv(M, kTBM) <= sms;
  const bool dep = launches++ > 0;
  TcArgs p1{M, r, K1, 1, mid, ld, nullptr};
  if (kDU)
    e = narrow ? tc_launch<k3_gemm_kernel<false, false, 64>, 64>(p1, map[0], map[1], dep, stream)
               : tc_launch<k3_gemm_kernel<false, false, kTBN>, kTBN>(p1, map[0], map[1], dep,
                                                                    stream);
  else
    e = narrow ? tc_launch<k4_gemm_kernel<false, true, 64>, 64>(p1, map[0], map[1], dep, stream)
               : tc_launch<k4_gemm_kernel<false, true, kTBN>, kTBN>(p1, map[0], map[1], dep,
                                                                   stream);
  if (e != cudaSuccess) return e;
  // phase 2: the sum over M, A and B both stored with M as their row
  TcArgs p2{P, Q, M, splits, out, Q, part};
  e = kDU ? tc_launch<k3_gemm_kernel<true, true, kTBN>, kTBN>(p2, map[2], mmap, true, stream)
          : tc_launch<k4_gemm_kernel<true, true, kTBN>, kTBN>(p2, mmap, map[2], true, stream);
  if (e != cudaSuccess || splits == 1) return e;
  // the partials' sum in split order
  const size_t mn = (size_t)P * Q;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  return launch_after(kDU ? k3_reduce_kernel : k4_reduce_kernel, blocks, 256, 0, true, stream,
                      static_cast<const float*>(part), splits, mn, out);
}

inline void du_srcs(Src (&s)[3], const void* x, const void* dy, const void* v, int M, int C,
                    int r, int S) {
  s[0] = Src{dy, M, S};
  s[1] = Src{v, r, S};
  s[2] = Src{x, M, C};
}
inline void dv_srcs(Src (&s)[3], const void* x, const void* u, const void* dy, int M, int C,
                    int r, int S) {
  s[0] = Src{x, M, C};
  s[1] = Src{u, C, r};
  s[2] = Src{dy, M, S};
}

}  // namespace bwd
}  // namespace repro

extern "C" {

// All operands bf16, row-major and contiguous.  Each launches on `stream`
// and returns the cudaError_t of its launches.

// K2: dx (M, C) = bf16( bf16(dy (M, S) . v (r, S)ᵀ) . u (C, r)ᵀ ); `scratch`
// holds M x round_up(r, 8) bf16.
int repro_lowrank_dx(const void* dy, const void* u, const void* v, void* scratch, void* dx,
                     int M, int C, int r, int S, void* stream) {
  using namespace repro::bwd;
  if (M <= 0 || C <= 0) return 0;
  if (r <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ld = scratch_ld(r);
  repro::bf16* dt = static_cast<repro::bf16*>(scratch);
  // dt (M, r): A = dy (m, k=s), B(n=j, k=s) = v[j, s]
  cudaError_t e = gemm(operand(dy, S, 1, M), operand(v, S, 1, r), M, r, S, dt, ld, st);
  if (e != cudaSuccess) return (int)e;
  // dx (M, C): A = dt (m, k=j), B(n=c, k=j) = u[c, j]
  return (int)gemm(operand(dt, ld, 1, M), operand(u, r, 1, C), M, C, r,
                   static_cast<repro::bf16*>(dx), C, st);
}

// Bytes of scratch repro_lowrank_du needs for these operands (their
// alignment decides which are copied) and `splits`.
long long repro_lowrank_du_scratch(const void* x, const void* dy, const void* v, int M, int C,
                                   int r, int S, int splits) {
  using namespace repro::bwd;
  Src s[3];
  du_srcs(s, x, dy, v, M, C, r, S);
  return (long long)tc_scratch(s, M, r, C, r, splits).total;
}

// K3: du (C, r) = bf16( x (M, C)ᵀ . bf16(dy (M, S) . v (r, S)ᵀ) ), the sum
// over M split `splits` ways (1 .. ceil(M / 128)); `scratch` holds
// repro_lowrank_du_scratch bytes, 256-byte aligned.
int repro_lowrank_du(const void* x, const void* dy, const void* v, void* scratch, void* du,
                     int M, int C, int r, int S, int splits, void* stream) {
  using namespace repro::bwd;
  if (C <= 0 || r <= 0) return 0;
  if (M <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  Src s[3];
  du_srcs(s, x, dy, v, M, C, r, S);
  return (int)dudv<true>(s, scratch, static_cast<repro::bf16*>(du), M, C, r, S, splits,
                         (cudaStream_t)stream);
}

// Bytes of scratch repro_lowrank_dv needs, as repro_lowrank_du_scratch.
long long repro_lowrank_dv_scratch(const void* x, const void* u, const void* dy, int M, int C,
                                   int r, int S, int splits) {
  using namespace repro::bwd;
  Src s[3];
  dv_srcs(s, x, u, dy, M, C, r, S);
  return (long long)tc_scratch(s, M, r, r, S, splits).total;
}

// K4: dv (r, S) = bf16( bf16(x (M, C) . u (C, r))ᵀ . dy (M, S) ), the sum
// over M split `splits` ways, as K3's; `scratch` holds
// repro_lowrank_dv_scratch bytes.
int repro_lowrank_dv(const void* x, const void* u, const void* dy, void* scratch, void* dv,
                     int M, int C, int r, int S, int splits, void* stream) {
  using namespace repro::bwd;
  if (r <= 0 || S <= 0) return 0;
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  Src s[3];
  dv_srcs(s, x, u, dy, M, C, r, S);
  return (int)dudv<false>(s, scratch, static_cast<repro::bf16*>(dv), M, C, r, S, splits,
                          (cudaStream_t)stream);
}

const char* repro_lowrank_bwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
