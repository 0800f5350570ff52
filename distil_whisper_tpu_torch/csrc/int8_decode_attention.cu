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
// this is a GEMV per (b, h).  One block a head (the first port) keeps few
// bytes in flight per SM, so each (b, h) is a thread-block cluster of CL
// CTAs (2 to 8, the wrapper's choice from T), each with a slice of T:
// - At the start one thread issues TMA loads of the slice's K rows (64-byte
//   head slices of 1280-byte rows, 3-D tensor maps (D, T, B), boxes of
//   64 B x up to 256 rows; TMA zero-fills past T) into shared memory; V
//   follows into the same buffer once the scores are done, and arrives
//   while the softmax reductions run.  One buffer a CTA (not one each for K
//   and V, loaded together) keeps more CTAs resident: all of the cross
//   shape's 63 MB cannot be, and CTAs that wait with their memory idle
//   while others stream is what the time goes to (0.040 against 0.051-0.055
//   ms with two buffers on the H100; a persistent grid that prefetched the
//   next head measured 0.064-0.069 ms, its reductions then serialized a
//   cluster's heads).
// - Scores: four threads a key row, each a 16-byte shared load and four
//   __dp4a, summed by two shuffles; fp32 scores stay in shared memory.
// - The per-token scales and the mask of the slice are staged in shared
//   memory while K is in flight.
// - The reductions run over the cluster in two rounds of one-sided sends
//   (st.async into every CTA's shared memory, counted by the receiver's
//   mbarrier; no cluster-wide barrier after the start): each slice's max
//   score and its sum of exp against that max, from which every CTA forms
//   the same max and sum (rank order); then each slice's max of p * v_row,
//   which sets ps.
// - p.V: four threads a value row, 16 int32 sums each, reduced over the
//   block; each CTA sends its 64 int32 partials into rank 0's shared
//   memory, and rank 0 adds them (integer sums are exact in any order) and
//   writes the output.  No second kernel, no global scratch.
// The fp32 softmax sum runs in another order than PyTorch's (a tree in each
// block, then the slices in rank order, each rescaled to the cluster's max);
// the probabilities themselves are exp(s - max) / sum as in the plain
// version.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int HD = 64;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CL = 8;

// What the CTAs of a cluster send each other: per rank, its (max score, sum
// of exp against that max), its max of p * v_row, and (to rank 0) its 64
// int32 p.V partials; one mbarrier a round, counting the bytes.
struct Cluster {
  float2 stats[MAX_CL];
  float pmax[MAX_CL];
  int4 part[MAX_CL][HD / 4];
  uint64_t round[3];
};

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
  v = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) v = IS_MAX ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(THREADS)
int8_decode_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __nv_bfloat16* __restrict__ q,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             int k_per_head, int v_per_head,
                             const uint8_t* __restrict__ mask,
                             long long mask_bstride,
                             __nv_bfloat16* __restrict__ out, int H, int T,
                             int cl, int slice, int box_rows, float hd_scale) {
  extern __shared__ uint8_t smem_raw[];
  // TMA destinations 128-byte aligned
  uint8_t* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  int8_t* sKV = reinterpret_cast<int8_t*>(smem);         // [slice][64]: K, then V
  float* s = reinterpret_cast<float*>(sKV + slice * HD);  // [slice] scores
  float* k_row = s + slice;                               // [slice]
  float* bias = k_row + slice;                            // [slice]
  float* v_row = bias + slice;                            // [slice]
  int8_t* p8 = reinterpret_cast<int8_t*>(v_row + slice);  // [slice]
  __shared__ __align__(8) uint64_t kbar, vbar;
  __shared__ __align__(16) int8_t q8[HD];
  __shared__ float red[WARPS];
  __shared__ float qs_sh;
  __shared__ int ored[WARPS][HD];
  __shared__ __align__(16) Cluster cs;

  const uint32_t rank = cluster_rank();
  const int h = blockIdx.x / cl, b = blockIdx.y, D = H * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = tid & 3;
  const int t0 = rank * slice;
  const int n = max(0, min(slice, T - t0));           // rows of this slice
  const int boxes = (n + box_rows - 1) / box_rows;

  if (tid == 0) {
    mbar_init(&kbar, 1);
    mbar_init(&vbar, 1);
    for (int r = 0; r < 3; ++r) mbar_init(&cs.round[r], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the other CTAs send into this one only once all have started and
  // initialised their barriers: arrive now, wait before the first send
  cluster_arrive_relaxed();
  // one thread: the slice of K (or V) into the buffer
  auto load = [&](const CUtensorMap* map, uint64_t* bar) {
    mbar_expect_tx(bar, boxes * box_rows * HD);
    for (int j = 0; j < boxes; ++j)
      tma_load_3d(sKV + j * box_rows * HD, map, bar, h * HD, t0 + j * box_rows, b);
  };
  if (tid == 0) {
    mbar_expect_tx(&cs.round[0], cl * sizeof(float2));
    mbar_expect_tx(&cs.round[1], cl * sizeof(float));
    if (rank == 0) mbar_expect_tx(&cs.round[2], cl * HD * sizeof(int));
    if (n > 0) load(&kmap, &kbar);
  }
  // per-token scales and the mask of the slice, while K is in flight
  for (int t = tid; t < n; t += THREADS) {
    const long long tg = (long long)b * T + t0 + t;
    k_row[t] = k_per_head ? 1.f : k_scale[tg];
    v_row[t] = v_per_head ? 1.f : v_scale[tg];
    bias[t] = (mask != nullptr && mask[b * mask_bstride + t0 + t] == 0) ? -1e30f : 0.f;
  }

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
  float m = -INFINITY;
  if (n > 0) {
    mbar_wait(&kbar, 0);
    const int4 qw = reinterpret_cast<const int4*>(q8)[sub];
    for (int t = tid >> 2; t < n; t += THREADS / 4) {
      const int4 kv = *reinterpret_cast<const int4*>(sKV + t * HD + sub * 16);
      int acc = __dp4a(kv.x, qw.x, 0);
      acc = __dp4a(kv.y, qw.y, acc);
      acc = __dp4a(kv.z, qw.z, acc);
      acc = __dp4a(kv.w, qw.w, acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      const float sc = __fadd_rn(__fmul_rn(__fmul_rn((float)acc, sfac), k_row[t]), bias[t]);
      if (sub == 0) s[t] = sc;
      m = fmaxf(m, sc);
    }
  }

  // softmax statistics of the slice: its max and its sum of exp against
  // that max; the cluster's max and sum follow from all ranks' pairs
  // (sum_r l_r exp(m_r - m), in rank order: the same value in every CTA).
  // The block reduction's barriers also end the reads of K, so V's copy
  // into the same buffer starts here and runs under the reductions.
  m = block_reduce<true>(m, red);
  if (tid == 0 && n > 0) {
    fence_async_smem();
    load(&vmap, &vbar);
  }
  float l = 0.f;
  for (int t = tid; t < n; t += THREADS) l += expf(__fsub_rn(s[t], m));
  l = block_reduce<false>(l, red);
  cluster_wait();
  if (tid < cl)
    st_async_f32x2(map_rank(smem_u32(&cs.stats[rank]), tid), m, l,
                   map_rank(smem_u32(&cs.round[0]), tid));
  mbar_wait_cluster(&cs.round[0], 0);
  m = cs.stats[0].x;
  for (int j = 1; j < cl; ++j) m = fmaxf(m, cs.stats[j].x);
  float sum = 0.f;
  for (int j = 0; j < cl; ++j)
    sum = __fadd_rn(sum, __fmul_rn(cs.stats[j].y, expf(__fsub_rn(cs.stats[j].x, m))));

  // p = softmax times the per-token V scale, then int8 per head against the
  // cluster's max of p
  float pmax = 0.f;
  for (int t = tid; t < n; t += THREADS) {
    const float p = __fmul_rn(__fdiv_rn(expf(__fsub_rn(s[t], m)), sum), v_row[t]);
    s[t] = p;
    pmax = fmaxf(pmax, p);
  }
  pmax = block_reduce<true>(pmax, red);
  if (tid < cl)
    st_async_f32(map_rank(smem_u32(&cs.pmax[rank]), tid), pmax,
                 map_rank(smem_u32(&cs.round[1]), tid));
  mbar_wait_cluster(&cs.round[1], 0);
  pmax = cs.pmax[0];
  for (int j = 1; j < cl; ++j) pmax = fmaxf(pmax, cs.pmax[j]);
  const float ps = __fdiv_rn(fmaxf(pmax, 1e-12f), 127.f);
  for (int t = tid; t < n; t += THREADS)
    p8[t] = (int8_t)rintf(__fdiv_rn(s[t], ps));
  __syncthreads();

  // p.V: four threads a value row (16 values each), 32 row groups
  int o[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j] = 0;
  if (n > 0) {
    mbar_wait(&vbar, 0);
    for (int t = tid >> 2; t < n; t += THREADS / 4) {
      const int p = p8[t];
      const int4 vv = *reinterpret_cast<const int4*>(sKV + t * HD + sub * 16);
      const int w[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        o[j] += p * (int)(int8_t)((w[j >> 2] >> ((j & 3) * 8)) & 0xff);
    }
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
  // the CTA's 64 partials into rank 0, four a thread; the other ranks are
  // done once they have sent
  if (tid < HD / 4) {
    int4 v = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      v.x += ored[w][4 * tid];
      v.y += ored[w][4 * tid + 1];
      v.z += ored[w][4 * tid + 2];
      v.w += ored[w][4 * tid + 3];
    }
    st_async_s32x4(map_rank(smem_u32(&cs.part[rank][tid]), 0), v,
                   map_rank(smem_u32(&cs.round[2]), 0));
  }
  if (rank != 0) return;
  mbar_wait_cluster(&cs.round[2], 0);
  if (tid < HD) {
    const int* part = reinterpret_cast<const int*>(cs.part);
    int v = 0;
    for (int j = 0; j < cl; ++j) v += part[j * HD + tid];
    const float v_head = v_per_head ? v_scale[b * H + h] : 1.f;
    out[(long long)b * D + h * HD + tid] =
        __float2bfloat16_rn(__fmul_rn((float)v, __fmul_rn(ps, v_head)));
  }
}

// dims (D, T, B) of an int8 [B, T, D] tensor; boxes of 64 B x box_rows.
int make_map(CUtensorMap* map, const void* ptr, int D, int T, int B,
             int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D, (cuuint64_t)T * D};
  const cuuint32_t box[3] = {HD, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, H*64] bf16; kq/vq [B, T, H*64] int8; k_scale/v_scale fp32 [B, H]
// (per head) or [B, T] (per token); mask uint8 [B or 1, T] or null, batch
// stride mask_bstride (0 for one shared row); out [B, H*64] bf16.  The
// cluster: cl CTAs a (b, h), CTA r taking rows [r * slice, (r + 1) * slice)
// of T in TMA boxes of box_rows rows (slice % box_rows == 0), as the
// wrapper's _cluster_split gives them.
extern "C" int dw_int8_decode_attention(
    const void* q, const void* kq, const void* vq, const void* k_scale,
    const void* v_scale, int k_per_head, int v_per_head, const void* mask,
    long long mask_bstride, void* out, int batch, int heads, int T,
    float hd_scale, int cl, int slice, int box_rows, void* stream) {
  if (T < 32 || T % 32 || T > 8192 || cl < 1 || cl > MAX_CL || box_rows < 1 ||
      box_rows > 256 || slice % box_rows || (long long)cl * slice < T)
    return (int)cudaErrorInvalidValue;
  const int D = heads * HD;
  CUtensorMap kmap, vmap;
  int err = make_map(&kmap, kq, D, T, batch, box_rows);
  if (!err) err = make_map(&vmap, vq, D, T, batch, box_rows);
  if (err) return err;
  const int smem = slice * (HD + 4 * (int)sizeof(float) + 1) + 128;
  err = (int)cudaFuncSetAttribute(int8_decode_attention_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
  if (err) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(heads * cl, batch);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(
      &config, int8_decode_attention_kernel, kmap, vmap,
      (const __nv_bfloat16*)q, (const float*)k_scale, (const float*)v_scale,
      k_per_head, v_per_head, (const uint8_t*)mask, mask_bstride,
      (__nv_bfloat16*)out, heads, T, cl, slice, box_rows, hd_scale);
  if (err) return err;
  return (int)cudaGetLastError();
}
