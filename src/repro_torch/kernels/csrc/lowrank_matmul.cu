// K1: fused low-rank matmul  y = bf16( bf16(x U) V ), float32 accumulation.
//
// Replaces the TPU kernel repro/kernels/lowrank_matmul.py::lowrank_matmul
// (Pallas `_kernel` / `_kernel_db`): grid (M/bm, S/bn, C/bk) with a (bm, r)
// float32 accumulator in VMEM that is rounded to x's dtype and multiplied
// by V on the last C step.  Two designs, chosen by the wrapper by M alone
// (kernels/lowrank_matmul.py, LARGE_M):
//
// The decode design (M < LARGE_M).  What bounds it on the H100: at the
// serving shapes (M = 8 decode slots or a 128-token prefill, C and S <=
// 2560, r <= 349) the work is far below the card's ~295 FLOP/byte ridge,
// so the floor is the bytes of U and V read from HBM (0.1-1 us).  What
// bounds this design is latency: a CTA walks its share of C chunk by
// chunk, and each chunk costs about one round trip to L2.  One CTA per
// (16-row, 64-column) output tile like the Pallas grid, but the 8 CTAs of
// a thread-block cluster share one rank product — each walks 1/8 of C and
// the float32 partials are reduced through distributed shared memory — so
// U is read once per cluster, spread over 8 SMs, and each CTA's walk is 8
// times shorter.  At decode that is 16 CTAs for S = 960 (15 column blocks
// padded to two clusters).
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

struct K1Smem {
  size_t xring, uring, ts, vring, stage, total;
};

__host__ __device__ inline K1Smem k1_layout(int r) {
  const int rp = padded_rank(r);
  K1Smem s;
  size_t off = 0;
  s.xring = off; off = align128(off + sizeof(bf16) * kStages * kXStage);
  s.uring = off; off = align128(off + ring_bytes(r));
  s.ts = off; off = align128(off + sizeof(bf16) * kBM * rank_stride(rp));
  s.vring = off; off = align128(off + sizeof(bf16) * kVStages * kVStage);
  s.stage = off; off = align128(off + sizeof(float) * 2 * kBM * kLdo);
  s.total = off;
  return s;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
lowrank_matmul_kernel(const bf16* __restrict__ x, const bf16* __restrict__ u,
                      const bf16* __restrict__ v, bf16* __restrict__ y,
                      int M, int C, int r, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rp = padded_rank(r), ldt = rank_stride(rp);
  const K1Smem L = k1_layout(r);
  bf16* xring = reinterpret_cast<bf16*>(smem + L.xring);
  bf16* uring = reinterpret_cast<bf16*>(smem + L.uring);
  bf16* ts = reinterpret_cast<bf16*>(smem + L.ts);
  bf16* vring = reinterpret_cast<bf16*>(smem + L.vring);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32;
  const bool xu_vec = aligned16(x) && aligned16(u) && C % 8 == 0;
  const bool v_vec = aligned16(v) && S % 8 == 0;
  const int nv = (rp + kRC - 1) / kRC;

  // V's first chunks do not depend on t: request them with U's first stage.
  for (int i = 0; i < kVStages - 1 && i < nv; ++i)
    v_fill(v, r, S, i * kRC, n0, v_vec, vring + i * kVStage);
  rank_product(x, u, M, C, r, m0, rp, xu_vec, xring, uring, ts);

  // Output tile: warp w owns column tile w % 4 and half w / 4 of every rank
  // chunk; the two halves are summed in float32 on the way out.
  const int cf = warp % 4, kh = warp / 4;
  FragC acc;
  wmma::fill_fragment(acc, 0.0f);
  for (int i = 0; i < nv; ++i) {
    cp_async_wait<kVStages - 2>();
    __syncthreads();  // chunk i landed; stage (i-1) % kVStages is free
    const int ni = i + kVStages - 1;
    if (ni < nv) v_fill(v, r, S, ni * kRC, n0, v_vec, vring + (ni % kVStages) * kVStage);
    cp_async_commit();
    output_steps(acc, ts, ldt, rp, vring + (i % kVStages) * kVStage, i * kRC, kh, cf);
  }
  wmma::store_matrix_sync(stage + kh * kBM * kLdo + cf * 16, acc, kLdo, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int row = i / kBN, col = i % kBN;
    const int m = m0 + row, n = n0 + col;
    if (m < M && n < S) {
      const float val = stage[row * kLdo + col] + stage[kBM * kLdo + row * kLdo + col];
      y[(size_t)m * S + n] = __float2bfloat16(val);
    }
  }
}

// The large-M design (common.cuh, second half): groups of 4 CTAs own 64
// rows; CTA q computes t's columns [q N, (q+1) N) once (N = round_up(r,
// 128) / 4 <= 128), then 128-column output tiles q, q + 4, ...
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
// contiguous.  Launches on `stream` and returns the cudaError_t of the launch.
int repro_lowrank_matmul(const void* x, const void* u, const void* v, void* y,
                         int M, int C, int r, int S, void* stream) {
  using namespace repro;
  if (M <= 0 || S <= 0) return 0;
  if (C <= 0 || r <= 0 || r > kRMax) return (int)cudaErrorInvalidValue;
  const size_t smem = k1_layout(r).total;
  static size_t reserved = 0;
  cudaError_t e = reserve_smem(lowrank_matmul_kernel, smem, &reserved);
  if (e != cudaSuccess) return (int)e;
  // column blocks past S (up to a whole cluster) share the rank product
  // and store nothing
  const dim3 grid(round_up((S + kBN - 1) / kBN, kCluster), (M + kBM - 1) / kBM);
  lowrank_matmul_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)u, (const bf16*)v, (bf16*)y, M, C, r, S);
  return (int)cudaGetLastError();
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
