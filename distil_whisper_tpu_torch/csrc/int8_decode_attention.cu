// Single-token attention against int8 merged-layout K/V for Hopper (sm_90a).
//
// Replaces distil_whisper_tpu/ops/int8_decode_attention.py::_kernel (the
// Pallas TPU kernel behind int8_decode_attention; unwired from decode() in
// both packages).  Per (batch row b, head h), hd 64:
//   q8, qs = int8 of q[b, h] (absmax, floor 1e-12)
//   s[t]   = (q8 . K[b, t, h]) [int32] * (qs * k_head * hd^-0.5) * k_row[t]
//            + (mask[t] ? 0 : -1e30)
//   p      = (exp(s - max s) / sum) * v_row[t]            (fp32)
//   p8     = round(p / ps), ps = max(max p, 1e-12) / 127  (no clip)
//   out    = (p8 . V[b, :, h]) [int32] * (ps * v_head)    -> bf16
// Scales are per head ([B, H]: k_head/v_head, rows 1) or per token ([B, T]:
// k_row/v_row, heads 1), as the wrapper says.
//
// What bounds it on this card: bytes.  One call reads each int8 K and V byte
// once (2 x B x T x D: 63 MB at the cross shape B 16, T 1536, D 1280) for
// about 4 integer operations a byte.
//
// Design: the TPU kernel's block-diagonal q operand and head-selector matrix
// exist to feed the TPU's matrix unit and are not carried over; on Hopper
// this is a GEMV per (b, h), one block of 256 threads each.  Scores: four
// threads per key row, each a 16-byte load and four __dp4a, summed by two
// shuffles; fp32 scores live in shared memory (T x 4 bytes).  Softmax and
// the probability requantization are block reductions.  p.V: four threads per
// value row, each 16 values of int32 multiply-adds over every 64th row, then
// shuffles and shared memory across the 64 row groups.  The integer sums are
// exact in any order; the fp32 softmax sums in a tree, other than PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = IS_MAX ? fmaxf(v, u) : v + u;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? red[lane] : (IS_MAX ? -INFINITY : 0.f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v, o);
      v = IS_MAX ? fmaxf(v, u) : v + u;
    }
    if (lane == 0) red[WARPS] = v;
  }
  __syncthreads();
  v = red[WARPS];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(THREADS)
int8_decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                             const int8_t* __restrict__ kq,
                             const int8_t* __restrict__ vq,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             int k_per_head, int v_per_head,
                             const uint8_t* __restrict__ mask,
                             long long mask_bstride,
                             __nv_bfloat16* __restrict__ out, int H, int T,
                             float hd_scale) {
  extern __shared__ float s[];                         // [T] scores, then p
  int8_t* p8 = reinterpret_cast<int8_t*>(s + T);      // [T]
  __shared__ __align__(16) int8_t q8[HD];
  __shared__ float red[WARPS + 1];
  __shared__ float qs_sh;
  __shared__ int ored[WARPS][HD];

  const int h = blockIdx.x, b = blockIdx.y, D = H * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = (long long)b * T * D + h * HD;

  // q of this head to int8 (warp 0: two values a lane)
  if (warp == 0) {
    const float2 v = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(q + (long long)b * D + h * HD)[lane]);
    float amax = fmaxf(fabsf(v.x), fabsf(v.y));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float qs = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
    q8[2 * lane] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v.x, qs)), -127.f), 127.f);
    q8[2 * lane + 1] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v.y, qs)), -127.f), 127.f);
    if (lane == 0) qs_sh = qs;
  }
  __syncthreads();
  const float k_head = k_per_head ? k_scale[b * H + h] : 1.f;
  const float sfac = __fmul_rn(__fmul_rn(qs_sh, k_head), hd_scale);

  // scores: four threads a key row, 16 bytes each
  const int sub = tid & 3;
  const int4 qw = reinterpret_cast<const int4*>(q8)[sub];
  for (int t = tid >> 2; t < T; t += THREADS / 4) {
    const int4 kv = *reinterpret_cast<const int4*>(kq + base + (long long)t * D + sub * 16);
    int acc = __dp4a(kv.x, qw.x, 0);
    acc = __dp4a(kv.y, qw.y, acc);
    acc = __dp4a(kv.z, qw.z, acc);
    acc = __dp4a(kv.w, qw.w, acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (sub == 0) {
      const float k_row = k_per_head ? 1.f : k_scale[(long long)b * T + t];
      const float bias = (mask != nullptr && mask[b * mask_bstride + t] == 0) ? -1e30f : 0.f;
      s[t] = __fadd_rn(__fmul_rn(__fmul_rn((float)acc, sfac), k_row), bias);
    }
  }
  __syncthreads();

  // fp32 softmax, times the per-token V scale, then int8 per head
  float m = -INFINITY;
  for (int t = tid; t < T; t += THREADS) m = fmaxf(m, s[t]);
  m = block_reduce<true>(m, red);
  float sum = 0.f;
  for (int t = tid; t < T; t += THREADS) {
    const float p = expf(__fsub_rn(s[t], m));
    s[t] = p;
    sum += p;
  }
  sum = block_reduce<false>(sum, red);
  float pmax = 0.f;
  for (int t = tid; t < T; t += THREADS) {
    const float v_row = v_per_head ? 1.f : v_scale[(long long)b * T + t];
    const float p = __fmul_rn(__fdiv_rn(s[t], sum), v_row);
    s[t] = p;
    pmax = fmaxf(pmax, p);
  }
  pmax = block_reduce<true>(pmax, red);
  const float ps = __fdiv_rn(fmaxf(pmax, 1e-12f), 127.f);
  for (int t = tid; t < T; t += THREADS)
    p8[t] = (int8_t)rintf(__fdiv_rn(s[t], ps));
  __syncthreads();

  // p.V: four threads a value row (16 values each), 64 row groups
  int o[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j] = 0;
  for (int t = tid >> 2; t < T; t += THREADS / 4) {
    const int p = p8[t];
    const int4 vv = *reinterpret_cast<const int4*>(vq + base + (long long)t * D + sub * 16);
    const int w[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int j = 0; j < 16; ++j)
      o[j] += p * (int)(int8_t)((w[j >> 2] >> ((j & 3) * 8)) & 0xff);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int v = o[j];
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lane < 4) ored[warp][sub * 16 + j] = v;
  }
  __syncthreads();
  if (tid < HD) {
    int v = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += ored[w][tid];
    const float v_head = v_per_head ? v_scale[b * H + h] : 1.f;
    out[(long long)b * D + h * HD + tid] =
        __float2bfloat16_rn(__fmul_rn((float)v, __fmul_rn(ps, v_head)));
  }
}

}  // namespace

// q [B, H*64] bf16; kq/vq [B, T, H*64] int8; k_scale/v_scale fp32 [B, H]
// (per head) or [B, T] (per token); mask uint8 [B or 1, T] or null, batch
// stride mask_bstride (0 for one shared row); out [B, H*64] bf16.
extern "C" int dw_int8_decode_attention(
    const void* q, const void* kq, const void* vq, const void* k_scale,
    const void* v_scale, int k_per_head, int v_per_head, const void* mask,
    long long mask_bstride, void* out, int batch, int heads, int T,
    float hd_scale, void* stream) {
  if (T < 32 || T % 32 || T > 8192) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)T * (sizeof(float) + 1);
  int8_decode_attention_kernel<<<dim3(heads, batch), THREADS, smem,
                                 (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)kq, (const int8_t*)vq,
      (const float*)k_scale, (const float*)v_scale, k_per_head, v_per_head,
      (const uint8_t*)mask, mask_bstride, (__nv_bfloat16*)out, heads, T,
      hd_scale);
  return (int)cudaGetLastError();
}
