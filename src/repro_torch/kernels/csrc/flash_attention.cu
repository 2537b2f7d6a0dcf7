// K8: flash-attention forward (causal or not) with grouped kv heads
//   o[b, i, h] = sum_j softmax_j(s[i, j]) v[b, j, h / g],
//   s[i, j] = (q'[b, i, h] . k[b, j, h / g]) * D**-0.5,  q' = bf16(q * q_mul),
// in the TPU kernel's arithmetic: logits in float32 times D**-0.5, -1e30
// where key j > query i under `causal`, running max m, denominator l and
// output accumulator in float32, p cast to bf16 before the p.v product,
// o = acc / max(l, 1e-30) rounded to bf16.  The exponentials are exp2 with
// log2(e) folded into D**-0.5 (one rounding more than exp on the scaled
// logits, far inside chip_smoke.py's per-row bound).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (Pallas `_kernel`): grid (B*H, Sq/bq, Sk/bkv) with the kv axis innermost
// and m / l / acc in VMEM scratch across it, future kv blocks skipped with
// pl.when; its wrapper (models/attention.py `_flash_path`) repeats the kv
// heads g times, swaps (B, S, H, D) to (B*H, S, D) and multiplies q by
// sqrt(D) to undo the projection's pre-scale.
//
// What bounds it on the H100: operations.  At the long-prompt prefill of
// smollm-360m (B 1, H 15, KV 5, Sq = Sk = 2016, D 64, causal) the two
// products are 4 B H D sum_i(i + 1) = 7.8 GFLOP, about 7.9 us at 989 TFLOP/s,
// against 10.3 MB of q, k, v and o, about 3.1 us at 3.35 TB/s.  At D = 64
// the exponentials come close behind: 64 keys of 64 rows are 4096 exp2 for
// 1 MFLOP of tensor work, 256 cycles of an SM's 16 exp2 a cycle against
// about 256 of its tensor cores.  Measured (bring-up variants, not kept):
// the softmax between the two products takes over a third of a call, the
// products and loads without it the rest.
//
// Design (the Hopper design, replacing a first 4-warp mma.sync kernel):
//   A CTA has kNW = 2 consumer warpgroups of 64 q rows each and one
//   producer warpgroup, whose first thread keeps a ring of k/v tiles (64
//   keys each) full by TMA with full/empty mbarriers, as tc_gemm does for
//   K3/K4.  A unit of work is 128 q rows of one head, so each k/v tile
//   brought in serves both warpgroups.  (Under GQA, packing the same 64
//   rows of the 3 q heads of a kv head into a unit measured slower at the
//   serve shape: PERF.md.)  The unit's q tiles come by TMA
//   into one of two buffers (the next unit's loads while this one runs),
//   and each warpgroup multiplies its tile by q_mul in bf16 in place, once,
//   then fences the generic proxy against wgmma's reads.
//   Per kv tile a warpgroup computes S = Q Kᵀ (64 x 64) with wgmma
//   m64n64k16 from shared memory, both operands K-major (D along the
//   128-byte swizzle row; D = 128 is two boxes), takes the online softmax
//   in registers (row max and sum across the 4 threads of a row), rounds p
//   to bf16 pairs in place of S's accumulator, which is the A fragment of
//   the next product, and adds P V with a register-A wgmma (V's tile keys x
//   D, D contiguous: B MN-major, transpose-B), so P never goes through
//   shared memory.  Tile j's S is issued before tile j - 1's P V, so that
//   P V runs on the tensor cores during tile j's softmax (the first tile is
//   peeled: a wgmma behind a branch is serialised by ptxas, C7518).  Only
//   the diagonal tile and the ragged last tile are masked; kv tiles past a
//   unit's last row are never loaded, and a warpgroup skips tiles wholly
//   past its own rows.
//   Scheduling: units in order of their kv tiles, heaviest first
//   (kernels/flash_attention.py's flash_units); CTA c of a persistent grid
//   of G <= one wave (flash_grid) takes positions c, 2G - 1 - c, 2G + c,
//   ... of that order (a snake, so the rounds even out: flash_plan).
// Layout: q (B, Sq, H, D), k/v (B, Sk, KV, D) and o (B, Sq, H, D),
// contiguous as the model's projections leave them, read through 3-D
// tensor maps over (heads x D, S, B) that fill zeros past S in each batch
// row; no transposed or repeated copy.  Any Sq and Sk; bf16 and D in
// {64, 128}; q, k and v 16-byte aligned.  No flag, atomic or counter
// crosses CTAs.

#include "common.cuh"

namespace repro {
namespace fa {

constexpr int kRows = 64;        // q rows a consumer warpgroup
constexpr int kNW = 2;           // consumer warpgroups a CTA
constexpr int kBK = 64;          // keys a kv tile
constexpr int kBox = 64 * 128;   // bytes of a 64-row x 64-column bf16 box
constexpr int kSlotsMax = 8;
constexpr float kNegInf = -1e30f;

// Shared memory: [two q buffers (every warpgroup's tile)][ring of k | v
// tiles][full | empty | q full | q free], behind up to 1 KB of alignment
// slack
template <int D>
struct Layout {
  static constexpr int kQ = kNW * (D / 64) * kBox;
  static constexpr int kStage = 2 * (D / 64) * kBox;
  static constexpr int kBars = (2 * kSlotsMax + 4) * 8;
  static constexpr int kRoom = (kSmemMax - 1024 - 2 * kQ - kBars) / kStage;
  static constexpr int kSlots = kRoom < kSlotsMax ? kRoom : kSlotsMax;
  static constexpr size_t kSmem = 1024 + 2 * (size_t)kQ + (size_t)kSlots * kStage + kBars;
  static_assert(kSlots >= 2, "the ring needs two slots");
};

struct Args {
  bf16* o;
  int B, Sq, Sk, H, KV;
  int causal;
  float q_mul, scale2;  // q's multiplier; D**-0.5 log2(e)
};

__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bf16(lo) | bf16(hi) << 16 in one conversion
__device__ inline unsigned pack_f2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// o (64 x D) += P (64 x 64 keys, bf16 A fragments in registers) V, V's tile
// at `st` after the k tile: keys x D, D contiguous (B MN-major)
template <int kC>
__device__ inline void pv_product(float (&o)[kC][32], const unsigned (&pa)[4][4],
                                  const unsigned char* st) {
#pragma unroll
  for (int c = 0; c < kC; ++c) fence_regs(o[c]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < kC; ++c)
      wgmma_rs_n64<1>(o[c], pa[kk], sw128_desc(st + (kC + c) * kBox + kk * 2048, kBox, 1024));
  wgmma_commit();
}

// issue sc (64 x 64 keys) = Q Kᵀ, both from shared memory, K-major (D
// along the 128-byte swizzle row, 64 a box): sc[4 jj + 2 hh + e] is row
// 16 w4 + lane / 4 + 8 hh, key 8 jj + 2 (lane % 4) + e of the tile
template <int D>
__device__ inline void s_product(float (&sc)[32], const unsigned char* qs,
                                 const unsigned char* st) {
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int off = (ks / 4) * kBox + (ks % 4) * 32;
    wgmma_n64<0, 0>(sc, sw128_desc(qs + off, 16, 1024), sw128_desc(st + off, 16, 1024));
  }
  wgmma_commit();
}

// The online softmax of one tile's logits, in place (sc becomes p): -1e30
// past Sk and, under causal, where key > row (only the diagonal and
// ragged tiles); the logits' scale folded into exp2's argument (an FMA),
// so the row max is taken of the raw logits.  m becomes the new running
// max, alpha the factor on what came before, sum this thread's sum of p.
__device__ inline void softmax_tile(float (&sc)[32], float (&m)[2], float (&alpha)[2],
                                    float (&sum)[2], const Args& a, int k0, int q0, int w4,
                                    int lane) {
  const int t = lane % 4;
  if (k0 + kBK > a.Sk || (a.causal && k0 + kBK - 1 > q0)) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int row = q0 + 16 * w4 + lane / 4 + 8 * ((i >> 1) & 1);
      if (key >= a.Sk || (a.causal && key > row)) sc[i] = kNegInf;
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float mn = fmaxf(m[hh], mx[hh] * a.scale2);
    alpha[hh] = ex2(m[hh] - mn);
    m[hh] = mn;
    sum[hh] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    sc[i] = ex2(fmaf(sc[i], a.scale2, -m[hh]));
    sum[hh] += sc[i];
  }
}

// P (bf16) as the A fragments of P V, 16 keys a step
__device__ inline void pack_p(unsigned (&pa)[4][4], const float (&sc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_f2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// after the wait for a P V: its accumulator and A registers were live
// until here (the wgmma read and wrote them asynchronously)
template <int kC>
__device__ inline void fence_pv(float (&o)[kC][32], unsigned (&pa)[4][4]) {
#pragma unroll
  for (int c = 0; c < kC; ++c) fence_regs(o[c]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pa[kk][r])::"memory");
}

// A unit of work: batch row, q head, q tile (kNW x 64 rows), its kv head
// and kv tiles; warpgroup w takes the tile's rows from q0(w).
struct Unit {
  int b, head, qt, hk, nk;
  __device__ int q0(int w) const { return (qt * kNW + w) * kRows; }
};

// Units, heaviest first: q tiles from the last (under `causal` the last
// rows see the most keys), each over every (batch row, head).
__device__ inline Unit unit_at(const Args& x, int p) {
  constexpr int span = kNW * kRows;
  const int nq = (x.Sq + span - 1) / span;
  Unit u;
  const int per = x.B * x.H;
  u.qt = nq - 1 - p / per;
  u.b = (p % per) / x.H;
  u.head = (p % per) % x.H;
  u.hk = u.head / (x.H / x.KV);
  const int nk_all = (x.Sk + kBK - 1) / kBK;
  const int last = min(u.qt * span + span, x.Sq) - 1;
  u.nk = x.causal ? min(nk_all, last / kBK + 1) : nk_all;
  return u;
}

__device__ inline int unit_count(const Args& x) {
  return x.B * x.H * ((x.Sq + kNW * kRows - 1) / (kNW * kRows));
}

// position of this CTA's k-th unit (the snake), or past the end
__device__ inline int unit_pos(int k) {
  const int G = gridDim.x, c = blockIdx.x;
  return k * G + (k & 1 ? G - 1 - c : c);
}

template <int D>
__global__ void __launch_bounds__(128 * (kNW + 1), 1)
flash_wgmma_kernel(const Args a, const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap) {
  using L = Layout<D>;
  constexpr int kC = D / 64;  // 64-wide boxes across D
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base + 2 * L::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::kSlots * L::kStage);
  uint64_t* empty = full + kSlotsMax;
  uint64_t* q_full = empty + kSlotsMax;
  uint64_t* q_free = q_full + 2;
  constexpr int ns = L::kSlots;
  const int nunits = unit_count(a);
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full + s, 1);    // the producer thread arrives, with the TMA bytes
      mbar_init(empty + s, kNW);  // one thread per consumer warpgroup
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_free + i, kNW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == kNW) {
    // ---------------- producer: one thread issues every TMA load ----------------
    if (threadIdx.x != 128 * kNW) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&qmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&kmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&vmap)) : "memory");
    int s = 0;
    for (int k = 0, p = unit_pos(0); p < nunits; p = unit_pos(++k)) {
      const Unit u = unit_at(a, p);
      const int qb = k & 1;
      if (k >= 2) mbar_wait(q_free + qb, ((k >> 1) - 1) & 1);
      mbar_arrive_tx(q_full + qb, L::kQ);
      for (int w = 0; w < kNW; ++w)
        for (int c = 0; c < kC; ++c)
          tma_load_3d(base + qb * L::kQ + (w * kC + c) * kBox, &qmap, u.head * D + 64 * c,
                      u.q0(w), u.b, q_full + qb);
      for (int j = 0; j < u.nk; ++j, ++s) {
        const int slot = s % ns;
        mbar_wait(empty + slot, ((s / ns) & 1) ^ 1);
        unsigned char* st = ring + slot * L::kStage;
        mbar_arrive_tx(full + slot, L::kStage);
        for (int c = 0; c < kC; ++c) {
          tma_load_3d(st + c * kBox, &kmap, u.hk * D + 64 * c, j * kBK, u.b, full + slot);
          tma_load_3d(st + (kC + c) * kBox, &vmap, u.hk * D + 64 * c, j * kBK, u.b, full + slot);
        }
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup wg, 64 q rows of one head ----------------
  RingReader rd{full, empty, ns, L::kStage, -1};
  const int w4 = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, t = lane % 4;
  int s = 0;
  for (int k = 0, p = unit_pos(0); p < nunits; p = unit_pos(++k)) {
    const Unit u = unit_at(a, p);
    const int head = u.head, q0 = u.q0(wg), qb = k & 1;
    unsigned char* qs = base + qb * L::kQ + wg * kC * kBox;
    mbar_wait(q_full + qb, (k >> 1) & 1);
    if (a.q_mul != 1.0f) {  // q' = bf16(q * q_mul), in place, before wgmma reads it
      for (int i = threadIdx.x % 128; i < kC * kBox / 16; i += 128) {
        uint4* qv = reinterpret_cast<uint4*>(qs) + i;
        uint4 v = *qv;
        unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 h2 = *reinterpret_cast<__nv_bfloat162*>(&w[e]);
          w[e] = pack_f2(__low2float(h2) * a.q_mul, __high2float(h2) * a.q_mul);
        }
        *qv = v;
      }
      fence_async_shared();
      warpgroup_sync(wg);
    }
    // kv tiles this warpgroup's rows see (none past Sq)
    const int last = min(q0 + kRows, a.Sq) - 1;
    const int nk_w = q0 >= a.Sq ? 0 : a.causal ? min(u.nk, last / kBK + 1) : u.nk;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // rows lane / 4 and + 8
    float o[kC][32];
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.0f;
    // Software pipeline, one kv tile deep: tile j's S = Q Kᵀ is issued
    // before tile j - 1's P V, and tile j's softmax runs while that P V is
    // on the tensor cores; only the rescale of o by alpha waits for it.  The
    // first tile is peeled, so no wgmma sits behind a branch in the loop
    // (ptxas serialises those, C7518).
    if (nk_w > 0) {
      unsigned pa[4][4];  // P of the tile before, bf16 pairs
      float sc[32], alpha[2], sum[2];
      const unsigned char* pv = rd.wait(ring, s);  // the stage of that tile
      s_product<D>(sc, qs, pv);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile(sc, m, alpha, sum, a, 0, q0, w4, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = sum[hh];
      pack_p(pa, sc);
      for (int j = 1; j < nk_w; ++j) {
        const unsigned char* st = rd.wait(ring, s + j);
        s_product<D>(sc, qs, st);
        pv_product<kC>(o, pa, pv);
        wgmma_wait<1>();  // S is done, P V may still run
        fence_regs(sc);
        softmax_tile(sc, m, alpha, sum, a, j * kBK, q0, w4, lane);
        wgmma_wait<0>();  // the tile before's P V: its stage is free, o is ours
        fence_pv<kC>(o, pa);
        if (threadIdx.x % 128 == 0) mbar_arrive(empty + (s + j - 1) % ns);
        // l sums this thread's columns; the 4 threads of a row add theirs
        // at the end (they share m, so the same alphas scale them)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + sum[hh];
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
        pack_p(pa, sc);
        pv = st;
      }
      pv_product<kC>(o, pa, pv);
      wgmma_wait<0>();
      fence_pv<kC>(o, pa);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty + (s + nk_w - 1) % ns);
      s += nk_w;
    }
    // tiles wholly past this warpgroup's rows: the other warpgroups' only
    for (int j = nk_w; j < u.nk; ++j, ++s) {
      rd.wait(ring, s);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty + s % ns);
    }
    // o = acc / max(l, 1e-30), rows past Sq not stored
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      l[hh] = fmaxf(l[hh], 1e-30f);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + 16 * w4 + lane / 4 + 8 * hh;
      if (row >= a.Sq) continue;
      bf16* dst = a.o + (((size_t)u.b * a.Sq + row) * a.H + head) * D + 2 * t;
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int i = 4 * jj + 2 * hh;
          *reinterpret_cast<unsigned*>(dst + 64 * c + 8 * jj) =
              pack_f2(o[c][i] / l[hh], o[c][i + 1] / l[hh]);
        }
    }
    if (threadIdx.x % 128 == 0) mbar_arrive(q_free + qb);  // the buffer may take the next unit
  }
}

// Tensor map of a contiguous (B, S, heads, D) bf16 tensor as 3-D (heads x
// D, S, B), read in 64-column x 64-row boxes with the 128-byte swizzle,
// zeros past S in each batch row.
inline cudaError_t make_map_bshd(CUtensorMap* map, const void* p, int B, int S, int heads, int D) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t row = (cuuint64_t)heads * D;
  const cuuint64_t dims[3] = {row, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {row * 2, row * 2 * S};
  const cuuint32_t box[3] = {64, kRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch(const Args& a, const void* q, const void* k, const void* v, int grid,
                   cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = bind_device(&dev);
  if (e != cudaSuccess) return e;
  CUtensorMap qmap, kmap, vmap;
  if ((e = make_map_bshd(&qmap, q, a.B, a.Sq, a.H, D)) != cudaSuccess ||
      (e = make_map_bshd(&kmap, k, a.B, a.Sk, a.KV, D)) != cudaSuccess ||
      (e = make_map_bshd(&vmap, v, a.B, a.Sk, a.KV, D)) != cudaSuccess)
    return e;
  static size_t reserved = 0;
  using L = Layout<D>;
  if ((e = reserve_smem(flash_wgmma_kernel<D>, L::kSmem, &reserved)) != cudaSuccess) return e;
  flash_wgmma_kernel<D><<<grid, 128 * (kNW + 1), L::kSmem, stream>>>(a, qmap, kmap, vmap);
  return cudaGetLastError();
}

}  // namespace fa
}  // namespace repro

extern "C" {

// o (B, Sq, H, D) = flash attention of q (B, Sq, H, D) against k, v (B, Sk,
// KV, D), all bf16, contiguous and 16-byte aligned.  `grid` CTAs walk the
// units (kernels/flash_attention.py's flash_grid and flash_plan).  Launches
// on `stream` and returns the cudaError_t of the launch.
int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                          int Sk, int H, int KV, int D, int causal, int grid, float q_mul,
                          float scale, void* stream) {
  using namespace repro::fa;
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk <= 0 || KV <= 0 || H % KV || grid <= 0) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, (const void*)o})
    if (reinterpret_cast<size_t>(p) & 15) return (int)cudaErrorMisalignedAddress;
  const Args a{(repro::bf16*)o, B, Sq, Sk, H, KV, causal, q_mul,
               scale * 1.4426950408889634f};
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (D == 64)
    e = launch<64>(a, q, k, v, grid, st);
  else if (D == 128)
    e = launch<128>(a, q, k, v, grid, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

const char* repro_flash_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
