// Whisper encoder self-attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces distil_whisper_tpu/ops/encoder_attention.py::_attn_kernel (the
// Pallas TPU kernel behind encoder_attention / fused_self_attention).
// Computes non-causal attention over [T, 64] heads: fp32 scores q.k scaled by
// hd^-0.5 after the product, keys >= t_real masked with -inf, softmax with
// fp32 statistics, the UNnormalised probabilities cast to bf16 for p.v (fp32
// accumulation), and one division by the fp32 row sum at the end.
//
// What bounds it on this card: operations.  At (16, 20, 1500, 64) one layer is
// 4*B*H*T^2*D = 184 GFLOP of bf16 tensor-core work against ~250 MB of q/k/v/o.
//
// Design: one block of 4 warps per (query tile of 64, head, batch row); each
// warp owns 16 query rows.  A whole 1500-wide fp32 score row per query does not
// fit a block's shared memory (the TPU kernel kept it in VMEM), so keys are
// streamed in tiles of 64 through shared memory with an online softmax: a
// running row max and row sum in fp32, and the output accumulator rescaled
// whenever the max grows.  Same function as the TPU kernel's single whole-row
// softmax, different rounding (held to it at atol 2e-5 in fp32 on the CPU
// plain path; on the card bf16 output is compared at atol/rtol 1e-2).
// Products run on the tensor cores through mma.sync m16n8k16 (bf16 x bf16 ->
// fp32); the score accumulators are re-packed in registers as the A operand
// of p.v (no shared-memory round trip), V's B operand comes from ldmatrix
// .trans.  The kernel takes the real length T (1500) and masks the ragged
// query and key edges itself, so the caller needs no pad-to-block copy, and
// it takes strides so q/k/v/out can be [B, T, H, 64] views of merged
// projections.  Key tiles past t_real are skipped (they would add exp(-inf)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;          // head dim
constexpr int BQ = 64;         // queries per block
constexpr int BK = 64;         // keys per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr int SROW = D + 8;    // padded smem row (144 B): conflict-free fragments

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + 64) of one head ([T, 64], row stride `st`) into
// shared memory, zero-filling rows >= T.  16-byte vector loads.
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[SROW],
                                          const __nv_bfloat16* src,
                                          long long st, int row0, int T) {
  for (int i = threadIdx.x; i < 64 * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < T)
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * st + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = v;
  }
}

__global__ void __launch_bounds__(THREADS)
encoder_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int T, int t_real,
                         float scale_log2,
                         long long qsb, long long qsh, long long qst,
                         long long ksb, long long ksh, long long kst,
                         long long vsb, long long vsh, long long vst,
                         long long osb, long long osh, long long ost) {
  __shared__ __align__(16) __nv_bfloat16 sQ[BQ][SROW];
  __shared__ __align__(16) __nv_bfloat16 sK[BK][SROW];
  __shared__ __align__(16) __nv_bfloat16 sV[BK][SROW];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;   // mma fragment row group / column pair
  const __nv_bfloat16* qh = q + b * qsb + h * qsh;
  const __nv_bfloat16* kh = k + b * ksb + h * ksh;
  const __nv_bfloat16* vh = v + b * vsb + h * vsh;

  load_tile(sQ, qh, qst, q0, T);
  __syncthreads();
  // A fragments of this warp's 16 query rows, 4 chunks of 16 along D
  uint32_t qf[4][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int c = kc * 16 + tg * 2;
    qf[kc][0] = *reinterpret_cast<const uint32_t*>(&sQ[r0][c]);
    qf[kc][1] = *reinterpret_cast<const uint32_t*>(&sQ[r0 + 8][c]);
    qf[kc][2] = *reinterpret_cast<const uint32_t*>(&sQ[r0][c + 8]);
    qf[kc][3] = *reinterpret_cast<const uint32_t*>(&sQ[r0 + 8][c + 8]);
  }

  float m[2] = {-INFINITY, -INFINITY};   // running max (log2 domain), rows g, g+8
  float l[2] = {0.f, 0.f};               // running sum of fp32 p
  float acc[8][4];                       // O: 8 tiles of 8 along D
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int n_kt = (t_real + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                     // everyone is done with the last tile
    load_tile(sK, kh, kst, k0, T);
    load_tile(sV, vh, vst, k0, T);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const int c = kc * 16 + tg * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&sK[nt * 8 + g][c]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&sK[nt * 8 + g][c + 8]);
        mma_bf16(s[nt], qf[kc], b0, b1);
      }
    }

    // scale (fp32, after the product), key mask, tile row max
    float tmax[2] = {-INFINITY, -INFINITY};
    const bool ragged = k0 + BK > t_real;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[nt][j] * scale_log2;
        if (ragged && k0 + nt * 8 + tg * 2 + (j & 1) >= t_real) x = -INFINITY;
        s[nt][j] = x;
        tmax[j >> 1] = fmaxf(tmax[j >> 1], x);
      }
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;      // rows with no live key yet
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = m_new;
    }

    // p = exp(s - m) in fp32; the row sum takes fp32 p, p.v takes bf16 p
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[nt][j] - mu[j >> 1]);
        s[nt][j] = p;
        psum[j >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * alpha[r] + psum[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] *= alpha[0]; acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1]; acc[nt][3] *= alpha[1];
    }

    // O += P V: the C fragments of two key n-tiles form one A fragment
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        // matrices: keys kc*16 + {0..7, 8..15} x d of n-tiles nt, nt+1
        const int mat = lane / 8, r = lane % 8;
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &sV[kc * 16 + (mat & 1) * 8 + r][(nt + (mat >> 1)) * 8]);
        mma_bf16(acc[nt], pa, bf[0], bf[1]);
        mma_bf16(acc[nt + 1], pa, bf[2], bf[3]);
      }
    }
  }

  // out = pv / l, rows past T are not stored
  __nv_bfloat16* oh = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= T) continue;
    __nv_bfloat16* orow = oh + (long long)row * ost;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t val = pack_bf16(acc[nt][2 * r] / l[r], acc[nt][2 * r + 1] / l[r]);
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + tg * 2) = val;
    }
  }
}

}  // namespace

extern "C" int dw_encoder_attention(
    const void* q, const void* k, const void* v, void* o, int batch, int heads,
    int T, int t_real, float scale_log2,
    long long qsb, long long qsh, long long qst,
    long long ksb, long long ksh, long long kst,
    long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost, void* stream) {
  if (t_real < 1 || t_real > T) return (int)cudaErrorInvalidValue;
  dim3 grid((T + BQ - 1) / BQ, heads, batch);
  encoder_attention_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, T, t_real, scale_log2,
      qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost);
  return (int)cudaGetLastError();
}
