// K2-K4: the low-rank matmul's backward, y = bf16( bf16(x U) V ):
//
//   K2 (dx)  dx = bf16( bf16(dy Vᵀ) Uᵀ )        dy (M,S), U (C,r), V (r,S) -> (M,C)
//   K3 (dU)  dU = bf16( xᵀ bf16(dy Vᵀ) )        x (M,C), dy, V             -> (C,r)
//   K4 (dV)  dV = bf16( bf16(x U)ᵀ dy )         x, U, dy                   -> (r,S)
//
// float32 accumulation everywhere; the rank-r intermediate (dt or t) is
// rounded to bf16 once, after its full float32 sum, as the TPU kernels do.
//
// Replaces the TPU kernels of repro/kernels/lowrank_bwd.py:
// lowrank_matmul_dx (`_dx_kernel`, `_dx_kernel_db`), lowrank_matmul_du
// (`_du_kernel`) and lowrank_matmul_dv (`_dv_kernel`).  Their grids keep dt
// or t in a VMEM scratch and rebuild it once per C block (K3) or S block
// (K4): FLOPs on the idle MXU traded for HBM bytes.
//
// What bounds them on the H100: at the training shapes (M = B*S = 2048
// tokens, C and S <= 2560, r <= 349) each does 2-5 GFLOP on 5-17 MB, so
// the bf16 tensor-core peak and the HBM rate give bounds of the same
// order (a few us each); neither is far below the other.
//
// Design (simple first): every product is one launch of a generic tiled
// tensor-core GEMM (`gemm_kernel`: 64x64 output tile per CTA, 4 warps of
// 32x32, mma.sync m16n8k16, bf16 in, float32 accumulators, K walked in
// 32-deep tiles through two shared-memory buffers with the next tile
// prefetched into registers).  Operands are read in place, transposed or
// not: each names the strides of its (row, k) element, one of which is 1,
// and the loader copies 16-byte vectors along that dimension (element loads
// at ragged or unaligned edges) into a k-contiguous shared-memory tile, so
// Uᵀ, Vᵀ and xᵀ are never materialised.  The rank-r intermediate (dt or t,
// M x r bf16, 1.4 MB at M = 2048, r = 349) goes through a scratch buffer
// that the wrapper allocates: at these sizes it stays in the 50 MB L2, and
// computing it once costs fewer FLOPs than the TPU kernels' per-block
// recompute.  K3 and K4 contract over M, the largest dimension: their
// second product splits M over `splits` CTAs per output tile, each writing
// a float32 partial, and a second pass sums the partials in split order
// (fixed, so the result does not depend on the run; no atomics).  Next
// steps: keep dt/t in shared memory, TMA + wgmma pipelines.

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

// out[i] = bf16( sum over z in order of part[z * mn + i] ).
__global__ void reduce_splits_kernel(const float* __restrict__ part, int splits, size_t mn,
                                     bf16* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * mn + i];
    out[i] = __float2bfloat16(s);
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// One product; `splits` > 1 goes through `part` and the reduction pass
// into out (then dense, o_ld == N).
inline cudaError_t gemm(const Operand& A, const Operand& B, int M, int N, int K, int splits,
                        bf16* out, int o_ld, float* part, cudaStream_t stream) {
  splits = splits < 1 ? 1 : splits;
  const int k_split = round_up(cdiv(K, splits), kGK);
  const dim3 grid(cdiv(N, kGN), cdiv(M, kGM), splits);
  gemm_kernel<<<grid, kGThreads, 0, stream>>>(A, B, M, N, K, k_split,
                                              splits == 1 ? out : nullptr, o_ld, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  reduce_splits_kernel<<<blocks, 256, 0, stream>>>(part, splits, mn, out);
  return cudaGetLastError();
}

// dt or t scratch: (M, r) with a row stride of ld = round_up(r, 8).
inline int scratch_ld(int r) { return round_up(r, 8); }

}  // namespace bwd
}  // namespace repro

extern "C" {

// All operands bf16, row-major and contiguous; `scratch` holds M x
// round_up(r, 8) bf16.  Each launches on `stream` and returns the
// cudaError_t of its launches.

// K2: dx (M, C) = bf16( bf16(dy (M, S) . v (r, S)ᵀ) . u (C, r)ᵀ ).
int repro_lowrank_dx(const void* dy, const void* u, const void* v, void* scratch, void* dx,
                     int M, int C, int r, int S, void* stream) {
  using namespace repro::bwd;
  if (M <= 0 || C <= 0) return 0;
  if (r <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ld = scratch_ld(r);
  repro::bf16* dt = static_cast<repro::bf16*>(scratch);
  // dt (M, r): A = dy (m, k=s), B(n=j, k=s) = v[j, s]
  cudaError_t e = gemm(operand(dy, S, 1, M), operand(v, S, 1, r), M, r, S, 1, dt, ld,
                       nullptr, st);
  if (e != cudaSuccess) return (int)e;
  // dx (M, C): A = dt (m, k=j), B(n=c, k=j) = u[c, j]
  return (int)gemm(operand(dt, ld, 1, M), operand(u, r, 1, C), M, C, r, 1,
                   static_cast<repro::bf16*>(dx), C, nullptr, st);
}

// K3: du (C, r) = bf16( x (M, C)ᵀ . bf16(dy (M, S) . v (r, S)ᵀ) ); the sum
// over M is split `splits` ways through `part` (splits x C x r float32).
int repro_lowrank_du(const void* x, const void* dy, const void* v, void* scratch, void* part,
                     void* du, int M, int C, int r, int S, int splits, void* stream) {
  using namespace repro::bwd;
  if (C <= 0 || r <= 0) return 0;
  if (M <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ld = scratch_ld(r);
  repro::bf16* dt = static_cast<repro::bf16*>(scratch);
  cudaError_t e = gemm(operand(dy, S, 1, M), operand(v, S, 1, r), M, r, S, 1, dt, ld,
                       nullptr, st);
  if (e != cudaSuccess) return (int)e;
  // du (C, r): A(m=c, k=row) = x[row, c], B(n=j, k=row) = dt[row, j]
  return (int)gemm(operand(x, 1, C, C), operand(dt, 1, ld, r), C, r, M, splits,
                   static_cast<repro::bf16*>(du), r, static_cast<float*>(part), st);
}

// K4: dv (r, S) = bf16( bf16(x (M, C) . u (C, r))ᵀ . dy (M, S) ); the sum
// over M is split `splits` ways through `part` (splits x r x S float32).
int repro_lowrank_dv(const void* x, const void* u, const void* dy, void* scratch, void* part,
                     void* dv, int M, int C, int r, int S, int splits, void* stream) {
  using namespace repro::bwd;
  if (r <= 0 || S <= 0) return 0;
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ld = scratch_ld(r);
  repro::bf16* tt = static_cast<repro::bf16*>(scratch);
  // t (M, r): A = x (m, k=c), B(n=j, k=c) = u[c, j]
  cudaError_t e = gemm(operand(x, C, 1, M), operand(u, 1, r, r), M, r, C, 1, tt, ld,
                       nullptr, st);
  if (e != cudaSuccess) return (int)e;
  // dv (r, S): A(m=j, k=row) = t[row, j], B(n=s, k=row) = dy[row, s]
  return (int)gemm(operand(tt, 1, ld, r), operand(dy, 1, S, S), r, S, M, splits,
                   static_cast<repro::bf16*>(dv), S, static_cast<float*>(part), st);
}

const char* repro_lowrank_bwd_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
