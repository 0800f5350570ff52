// Fused log-mel front-end for Hopper (sm_90a).
//
// Replaces distil_whisper_tpu/audio/mel_pallas.py::_mel_kernel (the Pallas TPU
// kernel behind log_mel_spectrogram_fused).  Computes, per 30 s window,
//   reflect pad (n_fft/2 each side) -> 400-sample frames at hop 160
//   -> windowed DFT (fp32) -> power re^2 + im^2 over 201 bins
//   -> @ [201, n_mels] slaney filters -> log10(max(mel, 1e-10)),
// written straight into the [B, n_mels, n_frames] layout the encoder reads.
// The per-sample max-8 clamp and the (x+4)/4 scaling stay outside (they need
// a max over the whole window), as in the JAX package.
//
// The DFT is folded.  The periodic Hann window is symmetric (w[n] = w[400-n])
// with w[0] = 0 and w[200] = 1, so with a[n] = x[n] + x[400-n] and
// d[n] = x[n] - x[400-n] (n = 1..199):
//   re_k = x[200] (-1)^k + sum_n a[n] w[n] cos(2 pi k n / 400)
//   im_k =               - sum_n d[n] w[n] sin(2 pi k n / 400)
// Row 0 of the folded basis (audio/mel.py::folded_stft_basis) carries the
// x[200] term, so both are products over 200 rows: half the dense DFT's
// multiply-adds.
//
// What bounds it on this card: operations.  Per frame the folded DFT is
// 2 x 201 x 199 multiply-adds and the mel projection 201 x n_mels, in fp32 on
// the CUDA cores (~67 TFLOP/s): 10.2 GFLOP for 16 windows at 128 mels, about
// 0.15 ms, against ~31 MB of bytes in and out.  The log-domain output is held
// to atol 2e-4, so the products stay plain fp32 FMA (no TF32 tensor cores).
//
// Design: one block of 208 threads per (window, tile of 32 frames), two
// blocks an SM, so that one block's barriers and loads hide behind the
// other's multiply-adds.
// 1. The tile's padded samples are staged once in shared memory (reflect
//    padding while staging), one pad word after every 160, so that the 32
//    frames a warp folds read 32 different banks.
// 2. The folded operands a and d are built in shared memory as [200][32]
//    (row n, frames contiguous).
// 3. The DFT is two fp32 products [32 x 200] @ [200 x 208] (bins padded to
//    208) with register micro-tiles: each thread owns 4 frames x 8 bins of re
//    and of im (64 accumulators) and per basis row does 6 16-byte shared
//    loads for 64 FMAs.  A warp spans 8 frame groups and 4 bin groups, so
//    each of its 16-byte loads reads one contiguous 128 B.  The folded basis
//    streams through a three-stage cp.async ring of 8-row chunks.
// 4. The power tile [208][32] stays in shared memory for the mel projection.
//    The slaney filters are triangles: a group of 8 mels has nonzero weights
//    only over a short band of bins, which the host passes in (about 225 of
//    16 x 201 rows at 128 mels).  A warp takes whole groups, one frame a
//    lane and 8 mels a thread, and multiplies over its group's band only,
//    the filter rows read through L1; the rows it skips would add exact
//    zeros, so the sums are those of the dense product in the same order.
//    Then log10 and a store coalesced along time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int PAD = N_FFT / 2;                         // reflect pad each side
constexpr int HALF = N_FFT / 2;                        // folded rows
constexpr int NB = 208;                                // bins, padded
constexpr int F = 32;                                  // frames per block
constexpr int SPAN = (F - 1) * HOP + N_FFT;            // 5360 staged samples
constexpr int SPAN_PADDED = (SPAN + SPAN / HOP + 4) / 4 * 4;  // a pad word per 160
constexpr int BIN_GROUPS = NB / 8;                     // 26
constexpr int FRAME_GROUPS = F / 4;                    // 8
constexpr int THREADS = BIN_GROUPS * FRAME_GROUPS;     // 208
constexpr int KC = 8;                                  // basis rows per chunk
constexpr int STAGES = 3;
constexpr int DFT_CHUNKS = HALF / KC;                  // 25
constexpr int STAGE_FLOATS = 2 * KC * NB;              // cos rows | sin rows
constexpr int MEL_WARPS = THREADS / 32;                // 6 whole warps
constexpr int SMEM_FLOATS = SPAN_PADDED + 2 * HALF * F + STAGES * STAGE_FLOATS;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

static_assert(HALF % KC == 0, "basis rows in whole chunks");
static_assert(F == 32, "the mel projection puts one frame on each lane");
static_assert(SPAN_PADDED % 4 == 0, "16-byte aligned regions");
static_assert(NB * F <= 2 * HALF * F, "power tile fits the fold region");

__device__ __forceinline__ int padded(int i) { return i + i / HOP; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// n floats (a multiple of 4) from global into shared memory
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n,
                                           int tid) {
  for (int i = 4 * tid; i < n; i += 4 * THREADS) cp_async16(dst + i, src + i);
}

// Ring chunk c: rows [8c, 8c+8) of the folded cos and sin bases.  One
// commit group per chunk, empty past the end, so that the wait counts stay
// uniform.
__device__ __forceinline__ void issue_chunk(float* ring, const float* basis,
                                            int c, int tid) {
  float* stage = ring + (c % STAGES) * STAGE_FLOATS;
  if (c < DFT_CHUNKS) {
    copy_async(stage, basis + c * KC * NB, KC * NB, tid);
    copy_async(stage + KC * NB, basis + (HALF + c * KC) * NB, KC * NB, tid);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(THREADS, 2)
log_mel_kernel(const float* __restrict__ audio,     // [B, n_samples]
               const float* __restrict__ basis,     // [2, 200, 208] folded
               const float* __restrict__ filters,   // [201, n_mels]
               const int* __restrict__ bands,       // [n_mels / 8][2]: nonzero rows
               float* __restrict__ out,             // [B, n_mels, n_frames]
               int n_samples, int n_frames, int n_mels) {
  extern __shared__ float4 smem4[];
  float* samples = reinterpret_cast<float*>(smem4);  // [SPAN_PADDED]
  float* fold = samples + SPAN_PADDED;               // a [200][32] | d [200][32]
  float* ring = fold + 2 * HALF * F;                 // [STAGES][STAGE_FLOATS]

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * F;
  const int b = blockIdx.y;
  const float* x = audio + (long long)b * n_samples;

  for (int c = 0; c < STAGES - 1; ++c)               // overlaps the staging
    issue_chunk(ring, basis, c, tid);

  // 1. padded samples of this tile (torch.stft center=True reflect); all
  //    loads in flight before the first store
  constexpr int STAGE_ITERS = (SPAN + THREADS - 1) / THREADS;
  float staged[STAGE_ITERS];
#pragma unroll
  for (int it = 0; it < STAGE_ITERS; ++it) {
    const int i = tid + it * THREADS;
    int a = f0 * HOP + min(i, SPAN - 1) - PAD;
    if (a < 0) a = -a;
    if (a >= n_samples) a = 2 * (n_samples - 1) - a;
    a = min(max(a, 0), n_samples - 1);               // frames past the end only
    staged[it] = __ldg(x + a);
  }
#pragma unroll
  for (int it = 0; it < STAGE_ITERS; ++it) {
    const int i = tid + it * THREADS;
    if (i < SPAN) samples[padded(i)] = staged[it];
  }
  __syncthreads();

  // 2. folded operands; a warp takes the 32 frames of one row n
  for (int i = tid; i < HALF * F; i += THREADS) {
    const int n = i / F, f = i % F;
    float a, d;
    if (n == 0) {
      a = d = samples[padded(f * HOP + HALF)];
    } else {
      const float lo = samples[padded(f * HOP + n)];
      const float hi = samples[padded(f * HOP + N_FFT - n)];
      a = lo + hi;
      d = lo - hi;
    }
    fold[n * F + f] = a;
    fold[HALF * F + n * F + f] = d;
  }

  // 3. folded DFT: 4 frames x 8 bins of re and im per thread
  const int fg = tid % FRAME_GROUPS, bg = tid / FRAME_GROUPS;
  float re[4][8], im[4][8];
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int i = 0; i < 8; ++i) re[f][i] = im[f][i] = 0.f;

  for (int c = 0; c < DFT_CHUNKS; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();          // chunk c landed; everyone is done with c - 1
    issue_chunk(ring, basis, c + STAGES - 1, tid);
    const float* cs = ring + (c % STAGES) * STAGE_FLOATS;
    const float* ss = cs + KC * NB;
#pragma unroll
    for (int r = 0; r < KC; ++r) {
      const int n = c * KC + r;
      const float4 av = *reinterpret_cast<const float4*>(fold + n * F + 4 * fg);
      const float4 dv = *reinterpret_cast<const float4*>(fold + HALF * F + n * F + 4 * fg);
      const float4 c0 = *reinterpret_cast<const float4*>(cs + r * NB + 8 * bg);
      const float4 c1 = *reinterpret_cast<const float4*>(cs + r * NB + 8 * bg + 4);
      const float4 s0 = *reinterpret_cast<const float4*>(ss + r * NB + 8 * bg);
      const float4 s1 = *reinterpret_cast<const float4*>(ss + r * NB + 8 * bg + 4);
      const float af[4] = {av.x, av.y, av.z, av.w};
      const float df[4] = {dv.x, dv.y, dv.z, dv.w};
      const float cb[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float sb[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int f = 0; f < 4; ++f)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          re[f][i] = fmaf(af[f], cb[i], re[f][i]);
          im[f][i] = fmaf(df[f], sb[i], im[f][i]);
        }
    }
  }
  __syncthreads();            // every thread is done with the fold region

  // 4. power tile [bin][frame] in the fold region
  float* power = fold;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float4 p;
    p.x = re[0][i] * re[0][i] + im[0][i] * im[0][i];
    p.y = re[1][i] * re[1][i] + im[1][i] * im[1][i];
    p.z = re[2][i] * re[2][i] + im[2][i] * im[2][i];
    p.w = re[3][i] * re[3][i] + im[3][i] * im[3][i];
    *reinterpret_cast<float4*>(power + (8 * bg + i) * F + 4 * fg) = p;
  }

  __syncthreads();

  // 5. mel projection: a warp per group of 8 mels, a frame per lane; each
  //    group over its band of nonzero filter rows only
  const int warp = tid / 32, lane = tid % 32;
  if (warp >= MEL_WARPS) return;
  const int fr = f0 + lane;
  for (int grp = warp; grp < n_mels / 8; grp += MEL_WARPS) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    const float* fil = filters + 8 * grp;
    const int hi = bands[2 * grp + 1];
#pragma unroll 4
    for (int k = bands[2 * grp]; k < hi; ++k) {
      const float pk = power[k * F + lane];
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(fil + k * n_mels));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(fil + k * n_mels + 4));
      const float wf[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(pk, wf[i], acc[i]);
    }
    if (fr < n_frames) {
      float* o = out + ((long long)b * n_mels + 8 * grp) * n_frames + fr;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o[(long long)i * n_frames] = log10f(fmaxf(acc[i], 1e-10f));
    }
  }
}

}  // namespace

extern "C" int dw_log_mel(const void* audio, const void* basis,
                          const void* filters, const void* bands, void* out,
                          int batch, int n_samples, int n_frames, int n_mels,
                          void* stream) {
  if (n_mels % 8 || n_samples <= PAD)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_frames + F - 1) / F, batch);
  log_mel_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)audio, (const float*)basis, (const float*)filters,
      (const int*)bands, (float*)out, n_samples, n_frames, n_mels);
  return (int)cudaGetLastError();
}
