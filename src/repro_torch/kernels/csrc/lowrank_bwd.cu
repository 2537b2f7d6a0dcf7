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
//
// K2 (the Hopper design): phase 1 is K3's, dt = bf16(dy Vᵀ) into
// the scratch (tc_gemm, A = dy and B = V both K-major, the same narrow or
// wide tiles).  Phase 2, dx = bf16(dt Uᵀ), is a GEMM of depth r only (2-4
// stages of 128) with a wide output (2048 x 960 or x 2560), so a CTA a
// 64 x 128 tile would pay a whole prologue and epilogue for 2-3 stages.
// Instead a persistent grid of at most one wave (kernels/lowrank_bwd.py's
// dx_plan) gives each CTA a row block of dt, loaded into shared memory by
// TMA once, and a share of that block's 128-column tiles of dx, walked in
// turn (dx_tiles); U's rows of each tile stream through a TMA ring of
// 128-rank stages (A = dt and B = U both K-major: U's rows are Uᵀ's
// columns).  A row block is 128 rows, each consumer warpgroup 64 of them,
// both sharing every U stage (half the U traffic through L2 of 64-row
// blocks, which measured no faster at any train shape and slower where a
// CTA walks several tiles).  Each tile's
// epilogue rounds once into swizzled boxes in shared memory and leaves by
// TMA stores that drain while the next tile runs (stores straight from
// registers, the first version, were the largest cost of phase 2).  No
// split, so nothing to reduce: the same bits every call.  What bounds it
// (measured on the H100, in bring-up variants): the fixed cost of two
// launches from a cold L2, most of a call at the small shapes, then phase
// 1's walk over S; phase 2's loads and wgmmas are a small part.
// Each kernel's launches are named by its number (k2_*, k3_*, k4_*), so a
// profile tells them apart.

#include "common.cuh"

namespace repro {
namespace bwd {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

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

// Each kernel's tc_gemm and pad launches under names of its own, for
// profiles (K2's phase 1 is K3's, as k2_gemm_kernel)
#define REPRO_TC_KERNELS(op)                                                                  \
  template <bool kAMN, bool kBMN, int kBN>                                                    \
  __global__ void __launch_bounds__(kTThreads, 1)                                             \
      op##_gemm_kernel(const TcArgs a, const __grid_constant__ CUtensorMap amap,              \
                       const __grid_constant__ CUtensorMap bmap) {                            \
    tc_gemm<kAMN, kBMN, kBN>(a, &amap, &bmap);                                                \
  }                                                                                           \
  __global__ void op##_pad_kernel(const bf16* __restrict__ src, int rows, int cols,           \
                                  bf16* __restrict__ dst, int ld) {                           \
    pad_rows(src, rows, cols, dst, ld);                                                       \
  }
REPRO_TC_KERNELS(k2)
REPRO_TC_KERNELS(k3)
REPRO_TC_KERNELS(k4)
#undef REPRO_TC_KERNELS
__global__ void k3_reduce_kernel(const float* __restrict__ part, int splits, size_t mn,
                                 bf16* __restrict__ out) {
  reduce_splits(part, splits, mn, out);
}
__global__ void k4_reduce_kernel(const float* __restrict__ part, int splits, size_t mn,
                                 bf16* __restrict__ out) {
  reduce_splits(part, splits, mn, out);
}

// --------------------------------------------------------------------------
// K2's phase 2: dx = dt Uᵀ, persistent over each row block's column tiles
// --------------------------------------------------------------------------

constexpr int kXBN = 128;                // output columns a tile, 64 a half
constexpr int kXStage = 2 * 128 * 128;   // a stage: 128 rows of U x 128 ranks deep (two boxes)
constexpr int kXSlotsMax = 4;

// A row block is kXBM rows of dt: each consumer warpgroup takes 64 of them
// and both column halves of a tile (the two share every U stage).  Shared
// memory: [dt block: 2 boxes of kXBM rows a 128-deep stage of r][each
// warpgroup's two 64 x 64 output boxes][ring][full | empty | dt full | dt
// free], behind up to 1 KB of alignment slack.
constexpr int kXBM = 128;           // rows a block
constexpr int kXDtBox = kXBM * 128; // a kXBM x 64 bf16 box of dt
constexpr int kXOutBox = 64 * 128;  // a 64 x 64 bf16 box of dx
struct DxSmem {
  int dt_bytes, out_bytes, slots;
  size_t total;
};
__host__ __device__ inline DxSmem dx_smem(int r) {
  DxSmem L;
  L.dt_bytes = 2 * cdiv(r, 128) * kXDtBox;
  L.out_bytes = 2 * 2 * kXOutBox;
  const int bars = (2 * kXSlotsMax + 2) * 8;
  const int room = (kSmemMax - 1024 - L.dt_bytes - L.out_bytes - bars) / kXStage;
  L.slots = room < kXSlotsMax ? room : kXSlotsMax;
  L.total = 1024 + (size_t)L.dt_bytes + L.out_bytes + (size_t)L.slots * kXStage + bars;
  return L;
}

// CTA i of the grid walks column tiles j, j + g, ... (j = i % g) of row
// blocks i / g, i / g + gridDim / g, ...: kernels/lowrank_bwd.py's
// dx_tiles, which chooses g and the grid (dx_plan)
struct DxArgs {
  bf16* out;  // (M, C), row-major
  int M, C, r, g;
  int out_tma;  // dx by TMA stores (16-byte aligned rows), else straight from registers
};

__global__ void __launch_bounds__(kTThreads, 1)
k2_dx_kernel(const DxArgs a, const __grid_constant__ CUtensorMap tmap,
             const __grid_constant__ CUtensorMap umap, const __grid_constant__ CUtensorMap ymap) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const DxSmem L = dx_smem(a.r);
  const int ns = L.slots;
  unsigned char* ring = base + L.dt_bytes + L.out_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ns * kXStage);
  uint64_t* empty = full + kXSlotsMax;
  uint64_t* dt_full = empty + kXSlotsMax;
  uint64_t* dt_free = dt_full + 1;
  const int nst = cdiv(a.r, 128);  // stages a tile
  const int nrb = cdiv(a.M, kXBM), ntc = cdiv(a.C, kXBN);
  const int j0 = blockIdx.x % a.g, rb0 = blockIdx.x / a.g, rstep = gridDim.x / a.g;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full + s, 1);   // the producer thread arrives, with the TMA bytes
      mbar_init(empty + s, 2);  // one thread per consumer warpgroup
    }
    mbar_init(dt_full, 1);
    mbar_init(dt_free, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  grid_dependents_may_launch();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---------------- producer: one thread issues every TMA load ----------------
    if (threadIdx.x != 256) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&umap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&ymap)) : "memory");
    grid_dependency_wait();  // dt is phase 1's output
    int i = 0, round = 0;
    for (int rb = rb0; rb < nrb; rb += rstep, ++round) {
      // the row block's dt, every box (zeros past M and r), once the
      // consumers are done with the last one
      if (round) mbar_wait(dt_free, (round - 1) & 1);
      mbar_arrive_tx(dt_full, L.dt_bytes);
      for (int kb = 0; kb < L.dt_bytes / kXDtBox; ++kb)
        tma_load_2d(base + kb * kXDtBox, &tmap, 64 * kb, rb * kXBM, dt_full);
      // U's rows of each column tile, 128 ranks a stage (zeros past C and r)
      for (int tc = j0; tc < ntc; tc += a.g) {
        for (int st = 0; st < nst; ++st, ++i) {
          const int slot = i % ns;
          mbar_wait(empty + slot, ((i / ns) & 1) ^ 1);
          unsigned char* dst = ring + slot * kXStage;
          mbar_arrive_tx(full + slot, kXStage);
          tma_load_2d(dst, &umap, 128 * st, tc * kXBN, full + slot);
          tma_load_2d(dst + kXStage / 2, &umap, 128 * st + 64, tc * kXBN, full + slot);
        }
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup wg ----------------
  RingReader rd{full, empty, ns, kXStage, -1};
  const int w4 = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row0 = 64 * wg;  // this warpgroup's rows of the block
  int i = 0, round = 0;
  for (int rb = rb0; rb < nrb; rb += rstep, ++round) {
    mbar_wait(dt_full, round & 1);
    const unsigned char* at = base + row0 * 128;
    for (int tc = j0; tc < ntc; tc += a.g) {
      float acc[2][32];  // column half h of the tile
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[h][e] = 0.0f;
      for (int st = 0; st < nst; ++st, ++i) {
        const unsigned char* us = rd.wait(ring, i);
#pragma unroll
        for (int h = 0; h < 2; ++h) fence_regs(acc[h]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          // 16 ranks are 32 bytes along a 128-byte row of box ks / 4
          const uint64_t ad =
              sw128_desc(at + (2 * st + ks / 4) * kXDtBox + (ks % 4) * 32, 16, 1024);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            wgmma_n64<0, 0>(acc[h], ad,
                            sw128_desc(us + (ks / 4) * (kXStage / 2) + h * (64 * 128) +
                                           (ks % 4) * 32,
                                       16, 1024));
        }
        wgmma_commit();
        rd.release_now(i);
#pragma unroll
        for (int h = 0; h < 2; ++h) fence_regs(acc[h]);
      }
      // epilogue, one rounding an element, while the producer loads the
      // next tile's U: acc[h][4j + 2hh + e] is row 16 w4 + lane / 4 + 8 hh,
      // column 8 j + 2 (lane % 4) + e of its 64 x 64 quarter.  With an
      // aligned dx each quarter goes through a 128-byte swizzled box in
      // shared memory and one TMA store (clipped at M and C), which drains
      // during the next tile; else straight to dx, masked.
      const int m0 = rb * kXBM + row0;
      unsigned char* ot = base + L.dt_bytes + wg * 2 * kXOutBox;
      if (a.out_tma) {
        if (threadIdx.x % 128 == 0) tma_store_wait_read();  // the last tile's stores read ot
        warpgroup_sync(wg);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * (lane % 4);
          const int n = tc * kXBN + 64 * h + col;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = 16 * w4 + lane / 4 + 8 * hh;
            const float v0 = acc[h][4 * j + 2 * hh], v1 = acc[h][4 * j + 2 * hh + 1];
            const unsigned pair = pack2(__float2bfloat16(v0), __float2bfloat16(v1));
            if (a.out_tma) {
              *reinterpret_cast<unsigned*>(ot + h * kXOutBox + sw128_off(row, col)) = pair;
              continue;
            }
            const int m = m0 + row;
            if (m >= a.M || n >= a.C) continue;
            bf16* dst = a.out + (size_t)m * a.C + n;
            if (n + 1 < a.C && (a.C & 1) == 0) {
              *reinterpret_cast<unsigned*>(dst) = pair;
            } else {
              dst[0] = __float2bfloat16(v0);
              if (n + 1 < a.C) dst[1] = __float2bfloat16(v1);
            }
          }
        }
      if (a.out_tma) {
        fence_async_shared();
        warpgroup_sync(wg);
        if (threadIdx.x % 128 == 0)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tma_store_2d(&ymap, ot + h * kXOutBox, tc * kXBN + 64 * h, m0);
      }
    }
    if (threadIdx.x % 128 == 0) mbar_arrive(dt_free);  // the next row block's dt may land
  }
  // the output boxes' stores are done before shared memory goes
  if (a.out_tma && threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A row-major bf16 operand (rows, cols) as the kernels read it: in place
// when TMA can, else from its padded copy in the scratch.
struct Src {
  const void* p;
  int rows, cols;
};

// Byte offsets in the scratch of one K2/K3/K4 call: [intermediate (M x ld)
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

// Tensor maps of a call's three operands (src), each read in place or
// first copied by `Pad` into the scratch (base + sc.pad[i]) with rows
// padded to 8 elements; box_rows[i] rows a box.  Counts the launches.
template <auto Pad>
inline cudaError_t operand_maps(const Src (&src)[3], const int (&box_rows)[3], unsigned char* base,
                                const TcScratch& sc, CUtensorMap (&map)[3], int& launches,
                                cudaStream_t stream) {
  for (int i = 0; i < 3; ++i) {
    const void* p = src[i].p;
    int pitch = src[i].cols;
    if (!tma_ok(p, pitch)) {
      bf16* dst = reinterpret_cast<bf16*>(base + sc.pad[i]);
      pitch = round_up(pitch, 8);
      const size_t n = (size_t)src[i].rows * src[i].cols;
      const int blocks = (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
      cudaError_t e = launch_after(Pad, blocks, 256, 0, launches++ > 0, stream,
                                   static_cast<const bf16*>(p), src[i].rows, src[i].cols, dst,
                                   pitch);
      if (e != cudaSuccess) return e;
      p = dst;
    }
    cudaError_t e = make_map(&map[i], p, src[i].rows, src[i].cols, box_rows[i], pitch);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Phase 1 of K2 and K3, dt = dy Vᵀ (M x r) into `mid`; in 64-column tiles
// (one consumer warpgroup a CTA) where those still fit one wave: each
// CTA's walk over K is fed at a rate per SM, so more SMs finish sooner
template <auto Narrow, auto Wide>
inline cudaError_t dt_phase(const CUtensorMap& dymap, const CUtensorMap& vmap, bf16* mid, int M,
                            int r, int S, int sms, bool dep, cudaStream_t stream) {
  TcArgs p1{M, r, S, 1, mid, scratch_ld(r), nullptr};
  return cdiv(r, 64) * cdiv(M, kTBM) <= sms ? tc_launch<Narrow, 64>(p1, dymap, vmap, dep, stream)
                                            : tc_launch<Wide, kTBN>(p1, dymap, vmap, dep, stream);
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
  const int P = kDU ? C : r, Q = kDU ? r : S;
  if (splits < 1 || splits > cdiv(M, kTBK)) return cudaErrorInvalidValue;
  const TcScratch sc = tc_scratch(src, M, r, P, Q, splits);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  bf16* mid = reinterpret_cast<bf16*>(base);
  float* part = reinterpret_cast<float*>(base + sc.part);
  // the maps' view of each operand: in place, or padded first; MN-major
  // (kTBK rows a box): U as K4's phase-1 B, and phase 2's operand.  Every
  // launch after the call's first is a programmatic dependent of the one
  // before it (launch_after).
  int launches = 0;
  CUtensorMap map[3], mmap;
  const int box_rows[3] = {64, kDU ? 64 : kTBK, kTBK};
  if ((e = operand_maps<kDU ? k3_pad_kernel : k4_pad_kernel>(src, box_rows, base, sc, map,
                                                               launches, stream)) != cudaSuccess)
    return e;
  if ((e = make_map(&mmap, mid, M, r, kTBK, scratch_ld(r))) != cudaSuccess) return e;

  // phase 1: the intermediate (M x r), once, into the scratch
  int sms = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const bool dep = launches++ > 0;
  if (kDU) {
    e = dt_phase<k3_gemm_kernel<false, false, 64>, k3_gemm_kernel<false, false, kTBN>>(
        map[0], map[1], mid, M, r, S, sms, dep, stream);
  } else {
    TcArgs p1{M, r, C, 1, mid, scratch_ld(r), nullptr};
    e = cdiv(r, 64) * cdiv(M, kTBM) <= sms
            ? tc_launch<k4_gemm_kernel<false, true, 64>, 64>(p1, map[0], map[1], dep, stream)
            : tc_launch<k4_gemm_kernel<false, true, kTBN>, kTBN>(p1, map[0], map[1], dep, stream);
  }
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

// One K2 call, src {dy (M, S), V (r, S), U (C, r)}: phase 1 dt = dy Vᵀ as
// K3's, then phase 2 dx = dt Uᵀ (A = dt and B = U, both K-major: U's rows
// are Uᵀ's columns) in row blocks of kXBM rows on a grid of g x groups
// CTAs (dx_plan).
inline cudaError_t dx(const Src (&src)[3], void* scratch, bf16* out, int M, int C, int r, int S,
                      int g, int groups, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = bind_device(&dev);
  if (e != cudaSuccess) return e;
  if (g < 1 || groups < 1 || groups > cdiv(M, kXBM) || g > cdiv(C, kXBN))
    return cudaErrorInvalidValue;
  const DxSmem L = dx_smem(r);
  if (L.slots < 2) return cudaErrorInvalidValue;
  const TcScratch sc = tc_scratch(src, M, r, M, C, 1);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  bf16* dt = reinterpret_cast<bf16*>(base);
  int launches = 0;
  CUtensorMap map[3], tmap;
  const int box_rows[3] = {64, 64, 128};
  if ((e = operand_maps<k2_pad_kernel>(src, box_rows, base, sc, map, launches, stream)) !=
      cudaSuccess)
    return e;
  if ((e = make_map(&tmap, dt, M, r, kXBM, scratch_ld(r))) != cudaSuccess) return e;
  int sms = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const bool dep = launches++ > 0;
  e = dt_phase<k2_gemm_kernel<false, false, 64>, k2_gemm_kernel<false, false, kTBN>>(
      map[0], map[1], dt, M, r, S, sms, dep, stream);
  if (e != cudaSuccess) return e;
  const DxArgs a{out, M, C, r, g, tma_ok(out, C)};
  CUtensorMap ymap;
  memset(&ymap, 0, sizeof ymap);
  if (a.out_tma && (e = make_map(&ymap, out, M, C, 64)) != cudaSuccess) return e;
  static size_t reserved = 0;
  if ((e = reserve_smem(k2_dx_kernel, L.total, &reserved)) != cudaSuccess) return e;
  return launch_after(k2_dx_kernel, g * groups, kTThreads, L.total, true, stream, a, tmap,
                      map[2], ymap);
}

inline void dx_srcs(Src (&s)[3], const void* dy, const void* u, const void* v, int M, int C,
                    int r, int S) {
  s[0] = Src{dy, M, S};
  s[1] = Src{v, r, S};
  s[2] = Src{u, C, r};
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

// Bytes of scratch repro_lowrank_dx needs for these operands (their
// alignment decides which are copied).
long long repro_lowrank_dx_scratch(const void* dy, const void* u, const void* v, int M, int C,
                                   int r, int S) {
  using namespace repro::bwd;
  Src s[3];
  dx_srcs(s, dy, u, v, M, C, r, S);
  return (long long)tc_scratch(s, M, r, M, C, 1).total;
}

// K2: dx (M, C) = bf16( bf16(dy (M, S) . v (r, S)ᵀ) . u (C, r)ᵀ ), phase 2
// in 128-row blocks on g x groups CTAs (kernels/lowrank_bwd.py's
// dx_plan); `scratch` holds
// repro_lowrank_dx_scratch bytes, 256-byte aligned.
int repro_lowrank_dx(const void* dy, const void* u, const void* v, void* scratch, void* dx,
                     int M, int C, int r, int S, int g, int groups, void* stream) {
  using namespace repro::bwd;
  if (M <= 0 || C <= 0) return 0;
  if (r <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  Src s[3];
  dx_srcs(s, dy, u, v, M, C, r, S);
  return (int)repro::bwd::dx(s, scratch, static_cast<repro::bf16*>(dx), M, C, r, S, g, groups,
                             (cudaStream_t)stream);
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
