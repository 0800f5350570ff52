// Fused log-mel front-end for Hopper (sm_90a).
//
// Replaces distil_whisper_tpu/audio/mel_pallas.py::_mel_kernel (the Pallas TPU
// kernel behind log_mel_spectrogram_fused).  Computes, per 30 s window,
//   reflect pad (n_fft/2 each side) -> 400-sample frames at hop 160
//   -> windowed DFT against the [402, 400] cos/-sin basis (fp32)
//   -> power re^2 + im^2 over 201 bins -> @ [201, n_mels] slaney filters
//   -> log10(max(mel, 1e-10)),
// written straight into the [B, n_mels, n_frames] layout the encoder reads.
// The per-sample max-8 clamp and the (x+4)/4 scaling stay outside (they need
// a max over the whole window), as in the JAX package.
//
// What bounds it on this card: operations.  The DFT is 3000 x 402 x 400 FMAs
// per window (0.965 GFLOP) plus 0.154 GFLOP of mel projection, in fp32 on the
// CUDA cores (~67 TFLOP/s), against ~3.5 MB of bytes in and out per window.
// The log-domain output is held to atol 2e-4, so the products stay plain fp32
// FMA (no TF32 tensor cores).
//
// Design: one block per (window, tile of FRAMES frames).  The tile's
// FRAMES*160 + 240 padded samples are staged once in shared memory (reflect
// padding is applied while staging, so no padded copy of the audio exists)
// and frames are read at stride 160 from there: the three shifted 160-wide
// views of the TPU kernel were a Mosaic layout workaround and are not needed.
// Thread k < 201 owns DFT bin k for every frame of the tile: it streams
// column k of the transposed basis (coalesced across threads; the 643 KB
// basis stays resident in L2) and reads each sample as a shared-memory
// broadcast, keeping 2 x FRAMES fp32 accumulators in registers.  The power
// tile stays in shared memory for the mel projection; the log-mel tile is
// staged again in shared memory so the store to [B, n_mels, T] is coalesced
// along time.

#include <cuda_runtime.h>

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int N_FREQ = N_FFT / 2 + 1;               // 201
constexpr int PAD = N_FFT / 2;                      // reflect pad each side
constexpr int FRAMES = 24;                          // frames per block
constexpr int SPAN = (FRAMES - 1) * HOP + N_FFT;    // 4080 staged samples
constexpr int THREADS = 224;                        // 7 warps >= 201 bins
constexpr int MAX_MELS = SPAN / FRAMES;             // log-mel tile fits in `samples`

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ audio,     // [B, n_samples]
               const float* __restrict__ basis_t,   // [400, 402]: re_k | im_k
               const float* __restrict__ filters,   // [201, n_mels]
               float* __restrict__ out,             // [B, n_mels, n_frames]
               int n_samples, int n_frames, int n_mels) {
  __shared__ float samples[SPAN];                   // reused for the log-mel tile
  __shared__ float power[FRAMES][N_FREQ];

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * FRAMES;
  const int b = blockIdx.y;
  const float* x = audio + (long long)b * n_samples;

  // 1. stage the padded samples of this tile (torch.stft center=True reflect)
  for (int i = tid; i < SPAN; i += THREADS) {
    int a = f0 * HOP + i - PAD;
    if (a < 0) a = -a;
    if (a >= n_samples) a = 2 * (n_samples - 1) - a;
    a = min(max(a, 0), n_samples - 1);              // frames past the end only
    samples[i] = x[a];
  }
  __syncthreads();

  // 2. windowed DFT + power: thread k owns bin k for all FRAMES frames
  if (tid < N_FREQ) {
    float re[FRAMES], im[FRAMES];
#pragma unroll
    for (int f = 0; f < FRAMES; ++f) { re[f] = 0.f; im[f] = 0.f; }
#pragma unroll 2
    for (int n = 0; n < N_FFT; ++n) {
      const float br = basis_t[n * (2 * N_FREQ) + tid];
      const float bi = basis_t[n * (2 * N_FREQ) + N_FREQ + tid];
#pragma unroll
      for (int f = 0; f < FRAMES; ++f) {
        const float s = samples[f * HOP + n];
        re[f] = fmaf(s, br, re[f]);
        im[f] = fmaf(s, bi, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < FRAMES; ++f) power[f][tid] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  // 3. mel projection + log10 into the (now free) sample buffer [n_mels][FRAMES]
  float* tile = samples;
  if (tid < n_mels) {
    float acc[FRAMES];
#pragma unroll
    for (int f = 0; f < FRAMES; ++f) acc[f] = 0.f;
    for (int k = 0; k < N_FREQ; ++k) {
      const float w = filters[k * n_mels + tid];
#pragma unroll
      for (int f = 0; f < FRAMES; ++f) acc[f] = fmaf(power[f][k], w, acc[f]);
    }
#pragma unroll
    for (int f = 0; f < FRAMES; ++f)
      tile[tid * FRAMES + f] = log10f(fmaxf(acc[f], 1e-10f));
  }
  __syncthreads();

  // 4. coalesced store along time
  float* o = out + (long long)b * n_mels * n_frames;
  for (int i = tid; i < n_mels * FRAMES; i += THREADS) {
    const int m = i / FRAMES, f = i % FRAMES;
    if (f0 + f < n_frames) o[(long long)m * n_frames + f0 + f] = tile[i];
  }
}

}  // namespace

extern "C" int dw_log_mel(const void* audio, const void* basis_t,
                          const void* filters, void* out, int batch,
                          int n_samples, int n_frames, int n_mels,
                          void* stream) {
  if (n_mels > THREADS || n_mels > MAX_MELS || n_samples <= PAD)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n_frames + FRAMES - 1) / FRAMES, batch);
  log_mel_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)audio, (const float*)basis_t, (const float*)filters,
      (float*)out, n_samples, n_frames, n_mels);
  return (int)cudaGetLastError();
}
