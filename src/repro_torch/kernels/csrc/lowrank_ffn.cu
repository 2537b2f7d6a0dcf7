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
// The decode design (M < LARGE_M), K1's (first half of common.cuh) with
// both branches.  What bounds it on the H100: the bytes of the four
// factors; at decode (M = 8) that is 2 (960*349 + 349*2560) * 2 B = 4.9 MB,
// about 1.5 us at 3.35 TB/s, and what a call costs is latency.  The rank
// kernel's tiles cover the gate's rank and then the up branch's, so one
// launch forms both t (bf16, into the scratch); the out kernel requests
// both V tiles of its columns before it waits for them, runs the two second
// products into two float32 accumulators and applies silu(g) * u in float32
// before the one rounding, so neither (M, F) branch reaches HBM.  Past 512
// rank rows (the VLM's 3185) it walks both branches' ranks in K1's pieces,
// adding each piece's float32 sums, and applies silu(g) * u to the whole
// sums after the last piece, as the TPU kernel does after its last C step.
//
// The large-M design (M >= LARGE_M), bound by operations (2 x K1's):
// K1's large design with both branches (second half of common.cuh).
//
// bf16 only, as K1.

#include "common.cuh"

namespace repro {

// The decode design's two phases (common.cuh): both branches' t into the
// scratch, then silu(t_g V_g) * (t_u V_u), in one piece of the rank
// (kPieces false) or, past 512 rank rows, in pieces
__global__ void __launch_bounds__(kDThreads) lowrank_ffn_rank_kernel(const DecodeRank a) {
  decode_rank_body(a);
}
template <bool kPieces>
__global__ void __launch_bounds__(kDThreads) lowrank_ffn_out_kernel(const DecodeOut a) {
  decode_out_body<2, true, kPieces>(a);
}

// The large-M design (common.cuh, second half), K1's with both branches:
// groups of 4 CTAs own 64 rows; both t stay in shared memory up to a padded
// rank of 512 (2 x 64 x 512 bf16) and past it stream through the ring, 64
// ranks of each branch a stage beside its V tiles; CTA q computes columns
// [q N, (q+1) N) of the gate's t, then of the up branch's, in passes of 128,
// then 128-column output tiles q, q + 4, ... with a float32 accumulator per
// branch over the whole rank and silu(g) * u in the epilogue.
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
// uu (C, ru), uv (ru, F), all bf16, row-major and contiguous, through the
// decode design: t the (2, M, rt) bf16 scratch (rt = max(rg, ru) rounded up
// to 8), (cs, kc, per, w1, w2) the wrapper's plan (decode_plan with two
// branches).  Launches both phases on `stream` and returns the cudaError_t
// of the launch.
int repro_lowrank_ffn(const void* x, const void* gu, const void* gv,
                      const void* uu, const void* uv, void* y, void* t,
                      int M, int C, int rg, int ru, int F, int cs, int kc, int per, int w1,
                      int w2, void* stream) {
  using namespace repro;
  if (M <= 0 || F <= 0) return 0;
  if (C <= 0 || rg <= 0 || ru <= 0 || rg > kRMax || ru > kRMax)
    return (int)cudaErrorInvalidValue;
  const bf16* us[2] = {(const bf16*)gu, (const bf16*)uu};
  const bf16* vs[2] = {(const bf16*)gv, (const bf16*)uv};
  const int rs[2] = {rg, ru};
  cudaError_t e = launch_decode<2>(lowrank_ffn_rank_kernel, lowrank_ffn_out_kernel<false>,
                                   lowrank_ffn_out_kernel<true>, (const bf16*)x, us, vs,
                                   (bf16*)y, (bf16*)t, M, C, rs, F, cs, kc, per, w1, w2,
                                   (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
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
