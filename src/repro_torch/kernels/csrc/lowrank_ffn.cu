// K5: fused low-rank SwiGLU first half
//   y = bf16( silu(g) * u ),  g = bf16(x Ug) Vg,  u = bf16(x Uu) Vu,
// with g and u kept in float32 (never rounded) up to the one final rounding.
//
// Replaces the TPU kernel repro/kernels/lowrank_ffn.py::lowrank_gated_ffn
// (Pallas `_kernel`): grid (M/bm, F/bn, C/bk) with two (bm, r) float32 rank
// accumulators in VMEM, two second products and the gated product per
// output tile, so HBM sees x once and the gated activation once.  Two
// designs, chosen by the wrapper by M alone (kernels/lowrank_ffn.py,
// LARGE_M):
//
// The decode design (M < LARGE_M).  What bounds it on the H100: the bytes
// of the four factors.  At decode (M = 8) that is 2 (960*349 + 349*2560) *
// 2 B = 4.9 MB, about 1.5 us at 3.35 TB/s.  As in K1, what bounds the
// design is the latency of each CTA's walk over C.  The design is K1's
// (common.cuh): one CTA per (16-row, 64-column) tile of the output, 40 CTAs
// at F = 2560 in clusters of 8 that share both rank products (gate, then
// up, through the same U ring), each CTA keeping both intermediates in
// shared memory as bf16.  Per output tile it runs the two second products
// into two float32 accumulators and applies silu(g) * u in float32 before
// the store, so neither (M, F) branch reaches HBM.
//
// The large-M design (M >= LARGE_M), bound by operations (2 x K1's):
// K1's large design with both branches (second half of common.cuh).
//
// bf16 only, as K1.

#include "common.cuh"

namespace repro {

struct K5Smem {
  size_t xring, uring, tg, tu, vg, vu, stage, total;
};

__host__ __device__ inline K5Smem k5_layout(int rg, int ru) {
  K5Smem s;
  size_t off = 0;
  s.xring = off; off = align128(off + sizeof(bf16) * kStages * kXStage);
  s.uring = off; off = align128(off + (ring_bytes(rg) > ring_bytes(ru) ? ring_bytes(rg) : ring_bytes(ru)));
  s.tg = off; off = align128(off + sizeof(bf16) * kBM * rank_stride(padded_rank(rg)));
  s.tu = off; off = align128(off + sizeof(bf16) * kBM * rank_stride(padded_rank(ru)));
  s.vg = off; off = align128(off + sizeof(bf16) * kVStages * kVStage);
  s.vu = off; off = align128(off + sizeof(bf16) * kVStages * kVStage);
  s.stage = off; off = align128(off + sizeof(float) * 4 * kBM * kLdo);
  s.total = off;
  return s;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
lowrank_ffn_kernel(const bf16* __restrict__ x,
                   const bf16* __restrict__ gu, const bf16* __restrict__ gv,
                   const bf16* __restrict__ uu, const bf16* __restrict__ uv,
                   bf16* __restrict__ y, int M, int C, int rg, int ru, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rpg = padded_rank(rg), rpu = padded_rank(ru);
  const K5Smem L = k5_layout(rg, ru);
  bf16* xring = reinterpret_cast<bf16*>(smem + L.xring);
  bf16* uring = reinterpret_cast<bf16*>(smem + L.uring);
  bf16* tg = reinterpret_cast<bf16*>(smem + L.tg);
  bf16* tu = reinterpret_cast<bf16*>(smem + L.tu);
  bf16* vg = reinterpret_cast<bf16*>(smem + L.vg);
  bf16* vu = reinterpret_cast<bf16*>(smem + L.vu);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32;
  const bool g_vec = aligned16(x) && aligned16(gu) && C % 8 == 0;
  const bool u_vec = aligned16(x) && aligned16(uu) && C % 8 == 0;
  const bool gv_vec = aligned16(gv) && F % 8 == 0, uv_vec = aligned16(uv) && F % 8 == 0;
  const int rpm = rpg > rpu ? rpg : rpu;
  const int nv = (rpm + kRC - 1) / kRC;

  // Both branches' first V chunks do not depend on t: request them first.
  for (int i = 0; i < kVStages - 1 && i < nv; ++i) {
    v_fill(gv, rg, F, i * kRC, n0, gv_vec, vg + i * kVStage);
    v_fill(uv, ru, F, i * kRC, n0, uv_vec, vu + i * kVStage);
  }
  rank_product(x, gu, M, C, rg, m0, rpg, g_vec, xring, uring, tg);
  rank_product(x, uu, M, C, ru, m0, rpu, u_vec, xring, uring, tu);

  const int cf = warp % 4, kh = warp / 4;
  FragC acc_g, acc_u;
  wmma::fill_fragment(acc_g, 0.0f);
  wmma::fill_fragment(acc_u, 0.0f);
  for (int i = 0; i < nv; ++i) {
    cp_async_wait<kVStages - 2>();
    __syncthreads();  // chunk i landed; stage (i-1) % kVStages is free
    const int ni = i + kVStages - 1;
    if (ni < nv) {  // past a branch's rank the fill reads zeros
      v_fill(gv, rg, F, ni * kRC, n0, gv_vec, vg + (ni % kVStages) * kVStage);
      v_fill(uv, ru, F, ni * kRC, n0, uv_vec, vu + (ni % kVStages) * kVStage);
    }
    cp_async_commit();
    const int s = (i % kVStages) * kVStage;
    output_steps(acc_g, tg, rank_stride(rpg), rpg, vg + s, i * kRC, kh, cf);
    output_steps(acc_u, tu, rank_stride(rpu), rpu, vu + s, i * kRC, kh, cf);
  }
  // stage: [branch g|u][half 0|1][kBM][kLdo] float32
  float* sg = stage + kh * kBM * kLdo;
  float* su = stage + (2 + kh) * kBM * kLdo;
  wmma::store_matrix_sync(sg + cf * 16, acc_g, kLdo, wmma::mem_row_major);
  wmma::store_matrix_sync(su + cf * 16, acc_u, kLdo, wmma::mem_row_major);
  __syncthreads();
  const int half = kBM * kLdo;
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int row = i / kBN, col = i % kBN;
    const int m = m0 + row, n = n0 + col;
    if (m < M && n < F) {
      const int at = row * kLdo + col;
      const float g = stage[at] + stage[half + at];
      const float up = stage[2 * half + at] + stage[3 * half + at];
      const float silu = g / (1.0f + expf(-g));
      y[(size_t)m * F + n] = __float2bfloat16(silu * up);
    }
  }
}

// The large-M design (common.cuh, second half), K1's with both branches:
// groups of 4 CTAs own 64 rows, so both t (2 x 64 x 512 bf16 at most) fit
// beside the ring; CTA q computes columns [q N, (q+1) N) of the gate's t,
// then of the up branch's, then 128-column output tiles q, q + 4, ... with
// a float32 accumulator per branch and silu(g) * u in the epilogue.
__global__ void __launch_bounds__(kLThreads, 1)
lowrank_ffn_large_kernel(const LargeArgs a, const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap vmap0,
                         const __grid_constant__ CUtensorMap vmap1,
                         const __grid_constant__ CUtensorMap tmap0,
                         const __grid_constant__ CUtensorMap tmap1,
                         const __grid_constant__ CUtensorMap umap0,
                         const __grid_constant__ CUtensorMap umap1,
                         const __grid_constant__ CUtensorMap ymap) {
  large_body<2, true>(a, &xmap, &vmap0, &vmap1, &tmap0, &tmap1, &umap0, &umap1, &ymap);
}

}  // namespace repro

extern "C" {

// y (M, F) = silu((x gu) gv) * ((x uu) uv); x (M, C), gu (C, rg), gv (rg, F),
// uu (C, ru), uv (ru, F), all bf16, row-major and contiguous.  Launches on
// `stream` and returns the cudaError_t of the launch.
int repro_lowrank_ffn(const void* x, const void* gu, const void* gv,
                      const void* uu, const void* uv, void* y,
                      int M, int C, int rg, int ru, int F, void* stream) {
  using namespace repro;
  if (M <= 0 || F <= 0) return 0;
  if (C <= 0 || rg <= 0 || ru <= 0 || rg > kRMax || ru > kRMax)
    return (int)cudaErrorInvalidValue;
  const size_t smem = k5_layout(rg, ru).total;
  static size_t reserved = 0;
  cudaError_t e = reserve_smem(lowrank_ffn_kernel, smem, &reserved);
  if (e != cudaSuccess) return (int)e;
  // column blocks past F (up to a whole cluster) share the rank product
  // and store nothing
  const dim3 grid(round_up((F + kBN - 1) / kBN, kCluster), (M + kBM - 1) / kBM);
  lowrank_ffn_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)gu, (const bf16*)gv, (const bf16*)uu,
      (const bf16*)uv, (bf16*)y, M, C, rg, ru, F);
  return (int)cudaGetLastError();
}

// Bytes of global scratch repro_lowrank_ffn_large needs at (M, C, rg, ru).
long long repro_lowrank_ffn_large_scratch(int M, int C, int rg, int ru) {
  const int rr[2] = {rg, ru};
  return (long long)repro::large_scratch(M, C, rr, 2).total;
}

// The same function through the large-M design; `scratch` holds
// repro_lowrank_ffn_large_scratch(M, C, rg, ru) bytes, 16-byte aligned.
int repro_lowrank_ffn_large(const void* x, const void* gu, const void* gv,
                            const void* uu, const void* uv, void* y, void* scratch,
                            int M, int C, int rg, int ru, int F, void* stream) {
  using namespace repro;
  if (M <= 0 || F <= 0) return 0;
  if (C <= 0 || rg <= 0 || ru <= 0 || rg > kRMax || ru > kRMax)
    return (int)cudaErrorInvalidValue;
  LargeArgs a{};
  a.x = (const bf16*)x;
  a.u[0] = (const bf16*)gu, a.u[1] = (const bf16*)uu;
  a.v[0] = (const bf16*)gv, a.v[1] = (const bf16*)uv;
  a.y = (bf16*)y;
  a.M = M, a.C = C, a.S = F, a.r[0] = rg, a.r[1] = ru;
  static size_t reserved = 0;
  return (int)launch_large<2>(lowrank_ffn_large_kernel, a, scratch, (cudaStream_t)stream,
                              &reserved);
}

const char* repro_lowrank_ffn_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
