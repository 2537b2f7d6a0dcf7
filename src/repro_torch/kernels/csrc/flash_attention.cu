// K8: flash-attention forward (causal or not) with grouped kv heads
//   o[b, i, h] = sum_j softmax_j(s[i, j]) v[b, j, h / g],
//   s[i, j] = (q'[b, i, h] . k[b, j, h / g]) * D**-0.5,  q' = bf16(q * q_mul),
// in the TPU kernel's arithmetic: logits in float32 times D**-0.5, -1e30
// where key j > query i under `causal`, running max m, denominator l and
// output accumulator in float32, p cast to bf16 before the p.v product,
// o = acc / max(l, 1e-30) rounded to bf16.
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
// against 10.3 MB of q, k, v and o, about 3.1 us at 3.35 TB/s.  What the
// design does about it: the (Sq, Sk) logits never leave registers, so HBM
// sees q, k, v once per CTA and o once; both products run on the tensor
// cores (bf16 mma.sync m16n8k16, float32 accumulators).
//
// Design (simple first; TMA, wgmma and warp specialisation are later work):
// one CTA of 4 warps per (64-row q tile, q head, batch row), heaviest causal
// tiles first.  The q tile is copied to shared memory (16-byte cp.async),
// multiplied by q_mul there, and each warp keeps the A fragments of its 16
// rows in registers.  64-row k/v tiles pass through a 2-stage cp.async ring.
// Per kv tile a warp forms its 16 x 64 logits in registers, updates m and l
// (row reductions across the 4 threads of an MMA quad), reuses the logits'
// accumulator registers as the A fragments of p (bf16), and reads v's B
// fragments with ldmatrix.trans.  kv tiles strictly above the diagonal are
// never loaded; the diagonal tile and the ragged last tile are masked.
//
// GQA in the kernel: q head h reads kv head h / (H / KV), with no repeated
// copy of k and v.  Layout: q (B, Sq, H, D), k/v (B, Sk, KV, D) as the
// model's projections leave them (contiguous, read through their strides),
// o (B, Sq, H, D) contiguous, with no transposed copy.  Any
// Sq and Sk: rows past the edge are zero-filled and masked or not stored.
// bf16 and D in {64, 128} only.

#include "common.cuh"

namespace repro {
namespace fa {

constexpr int kThreads = 128;  // 4 warps of 16 q rows
constexpr int kBQ = 64;        // q rows per CTA
constexpr int kBK = 64;        // keys per kv tile
constexpr float kNegInf = -1e30f;

template <int D>
struct Tile {
  static constexpr int kLd = D + 8;  // padded smem row (elements): conflict-free fragments
  static constexpr int kElems = kBQ * kLd;
  static constexpr size_t kSmem = sizeof(bf16) * 5 * kElems;  // q + 2 stages of k and v
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int B, Sq, Sk, H, KV;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal;
  float q_mul, scale;
};

// dst[kBQ][kLd] = rows [r0, r0 + kBQ) of one head of a strided (B, S, heads, D)
// tensor, zero past `rows`.
template <int D>
__device__ inline void fill_tile(bf16* dst, const bf16* base, long long row_stride,
                                 int r0, int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBQ * kChunks; c += kThreads) {
    const int row = c / kChunks, col = (c % kChunks) * 8;
    const bool in = r0 + row < rows;
    cp_async16(dst + row * Tile<D>::kLd + col,
               in ? base + (long long)(r0 + row) * row_stride + col : base, in ? 16 : 0);
  }
}

__device__ inline void ldmatrix_x4_trans(unsigned& r0, unsigned& r1, unsigned& r2,
                                         unsigned& r3, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

__device__ inline unsigned pack_f2(float lo, float hi) {
  return pack2(__float2bfloat16(lo), __float2bfloat16(hi));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  constexpr int kLd = Tile<D>::kLd;
  constexpr int kKS = D / 16;  // k-steps of q.k^T
  constexpr int kNT = D / 8;   // n-tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + Tile<D>::kElems;  // 2 stages
  bf16* vs = ks + 2 * Tile<D>::kElems;

  const int nq = (a.Sq + kBQ - 1) / kBQ;
  const int qt = nq - 1 - (int)blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.KV);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const bf16* qb = a.q + b * a.q_sb + h * a.q_sh;
  const bf16* kb = a.k + b * a.k_sb + hk * a.k_sh;
  const bf16* vb = a.v + b * a.v_sb + hk * a.v_sh;

  const int nk_all = (a.Sk + kBK - 1) / kBK;
  const int last_q = min(q0 + kBQ, a.Sq) - 1;
  const int nk = a.causal ? min(nk_all, last_q / kBK + 1) : nk_all;

  fill_tile<D>(qs, qb, a.q_ss, q0, a.Sq);
  cp_async_commit();
  if (nk > 0) {
    fill_tile<D>(ks, kb, a.k_ss, 0, a.Sk);
    fill_tile<D>(vs, vb, a.v_ss, 0, a.Sk);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // the q tile landed
  if (a.q_mul != 1.0f) {
    for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
      bf16* e = qs + (i / D) * kLd + i % D;
      *e = __float2bfloat16(__bfloat162float(*e) * a.q_mul);
    }
    __syncthreads();
  }
  unsigned qa[kKS][4];
  {
    const unsigned* qw = reinterpret_cast<const unsigned*>(qs);
    const int r = warp * 16 + g;
#pragma unroll
    for (int s = 0; s < kKS; ++s) {
      qa[s][0] = qw[(r * kLd + s * 16 + 2 * t) / 2];
      qa[s][1] = qw[((r + 8) * kLd + s * 16 + 2 * t) / 2];
      qa[s][2] = qw[(r * kLd + s * 16 + 8 + 2 * t) / 2];
      qa[s][3] = qw[((r + 8) * kLd + s * 16 + 8 + 2 * t) / 2];
    }
  }

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;  // rows g and g + 8
  const int qi0 = q0 + warp * 16 + g, qi1 = qi0 + 8;

  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {
      const int st = (j + 1) % 2;
      fill_tile<D>(ks + st * Tile<D>::kElems, kb, a.k_ss, (j + 1) * kBK, a.Sk);
      fill_tile<D>(vs + st * Tile<D>::kElems, vb, a.v_ss, (j + 1) * kBK, a.Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // kv tile j landed for every thread
    const bf16* kt = ks + (j % 2) * Tile<D>::kElems;
    const bf16* vt = vs + (j % 2) * Tile<D>::kElems;
    const unsigned* kw = reinterpret_cast<const unsigned*>(kt);

    // s = q k^T for this warp's 16 rows and the tile's 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      const int key = n * 8 + g;
#pragma unroll
      for (int st = 0; st < kKS; ++st) {
        const unsigned b0 = kw[(key * kLd + st * 16 + 2 * t) / 2];
        const unsigned b1 = kw[(key * kLd + st * 16 + 8 + 2 * t) / 2];
        mma16816(s[n], qa[st][0], qa[st][1], qa[st][2], qa[st][3], b0, b1);
      }
    }
    const int k0 = j * kBK;
    const bool masked = k0 + kBK > a.Sk || (a.causal && k0 + kBK - 1 > q0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * a.scale;
        if (masked) {
          const int kj = k0 + n * 8 + 2 * t + (e & 1);
          const int qi = e < 2 ? qi0 : qi1;
          if (kj >= a.Sk || (a.causal && kj > qi)) x = kNegInf;
        }
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    // acc += bf16(p) v: p's accumulator layout is the A fragment layout
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const unsigned pa0 = pack_f2(s[2 * kk][0], s[2 * kk][1]);
      const unsigned pa1 = pack_f2(s[2 * kk][2], s[2 * kk][3]);
      const unsigned pa2 = pack_f2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const unsigned pa3 = pack_f2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        unsigned b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, vt + vrow * kLd + np * 16 + (lane >> 4) * 8);
        mma16816(acc[2 * np], pa0, pa1, pa2, pa3, b0, b1);
        mma16816(acc[2 * np + 1], pa0, pa1, pa2, pa3, b2, b3);
      }
    }
    __syncthreads();  // every warp is done with stage j % 2 before it refills
  }
  cp_async_wait<0>();

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = n * 8 + 2 * t;
    if (qi0 < a.Sq) {
      bf16* dst = a.o + (((long long)b * a.Sq + qi0) * a.H + h) * D + col;
      *reinterpret_cast<unsigned*>(dst) = pack_f2(acc[n][0] / d0, acc[n][1] / d0);
    }
    if (qi1 < a.Sq) {
      bf16* dst = a.o + (((long long)b * a.Sq + qi1) * a.H + h) * D + col;
      *reinterpret_cast<unsigned*>(dst) = pack_f2(acc[n][2] / d1, acc[n][3] / d1);
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static size_t reserved = 0;
  cudaError_t e = reserve_smem(flash_kernel<D>, Tile<D>::kSmem, &reserved);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_kernel<D><<<grid, kThreads, Tile<D>::kSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace fa
}  // namespace repro

extern "C" {

// o (B, Sq, H, D) contiguous = flash attention of q (B, Sq, H, D) against
// k, v (B, Sk, KV, D), all bf16; the strides (in elements) of q, k and v's
// batch, sequence and head axes are given, their D axis is contiguous, and
// every pointer and stride is 16-byte aligned.  Launches on `stream` and
// returns the cudaError_t of the launch.
int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                          int Sq, int Sk, int H, int KV, int D, long long q_sb,
                          long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                          long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                          int causal, float q_mul, float scale, void* stream) {
  using namespace repro::fa;
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Sk <= 0 || KV <= 0 || H % KV || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{(const repro::bf16*)q, (const repro::bf16*)k, (const repro::bf16*)v,
               (repro::bf16*)o, B, Sq, Sk, H, KV, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
               v_sb, v_ss, v_sh, causal, q_mul, scale};
  cudaError_t e;
  if (D == 64)
    e = launch<64>(a, (cudaStream_t)stream);
  else if (D == 128)
    e = launch<128>(a, (cudaStream_t)stream);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

const char* repro_flash_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
