// K1: fused low-rank matmul  y = bf16( bf16(x U) V ), float32 accumulation.
//
// Replaces the TPU kernel repro/kernels/lowrank_matmul.py::lowrank_matmul
// (Pallas `_kernel` / `_kernel_db`): grid (M/bm, S/bn, C/bk) with a (bm, r)
// float32 accumulator in VMEM that is rounded to x's dtype and multiplied
// by V on the last C step.  Two designs, chosen by the wrapper by M alone
// (kernels/lowrank_matmul.py, LARGE_M):
//
// The decode design (M < LARGE_M: decode slots, speculative verify chunks,
// short prefills), first half of common.cuh.  What bounds it on the H100:
// at M = 8-40, C and S <= 28672 and r <= 4096 the work is far below the
// card's ~295 FLOP/byte ridge, so the floor is the bytes of U and V read
// from HBM (0.05-1.3 us up to the 2048-wide factors, about 80 us for the
// VLM's 28672 x 3185 down projection); below a few MB what a call costs is
// latency.  Two launches, each
// one trip to memory over about a wave of CTAs: the rank kernel forms t = x
// U once for all rows, clusters of CTAs splitting C and reducing through
// distributed shared memory in rank order into an L2 scratch; the out
// kernel, a programmatic dependent, fetches its tile of V while the rank
// kernel runs, then t, and multiplies.
//
// The large-M design (M >= LARGE_M: train steps, long prefills), bound by
// operations: groups of 4 CTAs compute each 64-row block's t once with
// wgmma fed by TMA and share it through L2, one wave of CTAs; see the
// second half of common.cuh.
//
// bf16 only: the tensor-core products have no float32 path, and float32
// would need a second one.

#include "common.cuh"

namespace repro {

// The decode design's two phases (common.cuh): t = bf16(x U) into the
// scratch, then y = bf16(t V), one branch
__global__ void __launch_bounds__(kDThreads) lowrank_matmul_rank_kernel(const DecodeRank a) {
  decode_rank_body(a);
}
__global__ void __launch_bounds__(kDThreads) lowrank_matmul_out_kernel(const DecodeOut a) {
  decode_out_body<1, false>(a);
}

// The large-M design (common.cuh, second half): groups of 4 CTAs own 64
// rows; CTA q computes t's columns [q N, (q+1) N) once (N = round_up(r,
// 128) / 4, in passes of 128), then 128-column output tiles q, q + 4, ...
__global__ void __launch_bounds__(kLThreads, 1)
lowrank_matmul_large_kernel(const LargeArgs a, const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap vmap0,
                            const __grid_constant__ CUtensorMap vmap1,
                            const __grid_constant__ CUtensorMap tmap0,
                            const __grid_constant__ CUtensorMap tmap1,
                            const __grid_constant__ CUtensorMap umap0,
                            const __grid_constant__ CUtensorMap umap1,
                            const __grid_constant__ CUtensorMap ymap) {
  large_body<1, false>(a, &xmap, &vmap0, &vmap1, &tmap0, &tmap1, &umap0, &umap1, &ymap);
}

}  // namespace repro

extern "C" {

// y (M, S) = (x (M, C) @ u (C, r)) @ v (r, S), all bf16, row-major and
// contiguous, through the decode design: t the (M, rt) bf16 scratch (rt = r
// rounded up to 8), (cs, kc, per, w1, w2) the wrapper's plan (decode_plan).
// Launches both phases on `stream` and returns the cudaError_t of the launch.
int repro_lowrank_matmul(const void* x, const void* u, const void* v, void* y, void* t,
                         int M, int C, int r, int S, int cs, int kc, int per, int w1, int w2,
                         void* stream) {
  using namespace repro;
  if (M <= 0 || S <= 0) return 0;
  if (C <= 0 || r <= 0 || r > kRMax) return (int)cudaErrorInvalidValue;
  const bf16* us[1] = {(const bf16*)u};
  const bf16* vs[1] = {(const bf16*)v};
  const int rs[1] = {r};
  cudaError_t e = launch_decode<1>(lowrank_matmul_rank_kernel, lowrank_matmul_out_kernel,
                                   lowrank_matmul_out_kernel, (const bf16*)x, us, vs, (bf16*)y,
                                   (bf16*)t, M, C, rs, S, cs, kc, per, w1, w2,
                                   (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Bytes of global scratch repro_lowrank_matmul_large needs at (M, C, r).
long long repro_lowrank_matmul_large_scratch(int M, int C, int r) {
  const int rr[2] = {r, 0};
  return (long long)repro::large_scratch(M, C, rr, 1).total;
}

// The same function through the large-M design; `scratch` holds
// repro_lowrank_matmul_large_scratch(M, C, r) bytes, 16-byte aligned.
int repro_lowrank_matmul_large(const void* x, const void* u, const void* v, void* y,
                               void* scratch, int M, int C, int r, int S, void* stream) {
  using namespace repro;
  if (M <= 0 || S <= 0) return 0;
  if (C <= 0 || r <= 0 || r > kRMax) return (int)cudaErrorInvalidValue;
  LargeArgs a{};
  a.x = (const bf16*)x;
  a.u[0] = (const bf16*)u;
  a.v[0] = (const bf16*)v;
  a.y = (bf16*)y;
  a.M = M, a.C = C, a.S = S, a.r[0] = r;
  static size_t reserved = 0;
  return (int)launch_large<1>(lowrank_matmul_large_kernel, a, scratch, (cudaStream_t)stream,
                              &reserved);
}

const char* repro_lowrank_matmul_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
