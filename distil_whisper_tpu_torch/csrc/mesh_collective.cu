// One-shot collectives among the ranks of a mesh group, for Hopper (sm_90a),
// that a CUDA graph can hold.
//
// Replaces no Pallas kernel.  It is the port's counterpart of the collectives
// that XLA compiles into JAX's meshed decode program (GSPMD's all-reduces of
// the row-parallel partials, the int8 scale maxima, the all-gathers of 2-D
// sharded layers): a program captured as a CUDA graph replays them with the
// decode, where gloo (host collectives) cannot be captured at all and NCCL
// needs a card per rank.  Ranks may share one card (time-sliced contexts) or
// sit on cards joined by NVLink.
//
// The protocol (parallel/device_comm.py holds the plain version: the same
// rank-ordered combine over torch.distributed's all_gather):
// 1. Each rank's workspace (one cudaMalloc, shared with the group by CUDA IPC
//    handles) holds two slots of `cap` bytes, a row of counting semaphores
//    [MAX_RANKS] and a control word pair (epoch, arrive).
// 2. A call is two kernels and a stream wait a peer.  The copy-in kernel
//    copies this rank's input into slot (epoch & 1) of its own workspace; its
//    last block signals each peer (a release add of 1 at system scope on the
//    peer's semaphore [me]).  Then one cuStreamWaitValue32 (>= 1) a peer on
//    its semaphore [j] (a graph holds them as memop nodes).  The combine
//    kernel reads the n slots and combines them IN RANK ORDER: every rank
//    computes the same sequence of fp32 operations on the same values, so
//    every rank gets the same bits (a ring's ranks each add in another
//    order); its last block consumes the signals (subtracts 1 each).
// 3. The epoch lives on the device and the combine advances it (its last
//    block), so a graph that replays fixed arguments still alternates the
//    slots.  Two slots make one barrier a call enough: a rank writes slot p
//    again two calls later, after its previous call waited for every peer's
//    signal of that call, which each peer sent only once its own call before
//    (the last one to read slot p) had ended, the calls of one rank running
//    in stream order.  The semaphores count, so a peer that signals the next
//    call before this rank consumed the last one is not lost, and a fixed
//    comparison (>= 1) serves every replay.
// 4. The stream wait has no bound of its own: the host bounds its read of
//    the device (parallel/device_comm.py::host_read).
//
// Modes: fp32 sum, int32 sum (exact, wrapping), fp32 max (NaN kept, as
// torch.maximum), all-gather in rank order (rows of a padded stride).
//
// Waiting on the stream, not spinning: ranks that share a card run in
// time-sliced contexts, and a spinning waiter holds the SMs until its
// context is switched out (2.15-2.29 ms a call between two ranks on one
// H100, against 0.16 ms waiting on the stream; PERF.md), where a stream wait
// leaves the card to the other context at once.
//
// What bounds it: bytes.  The function reads the n ranks' inputs and writes
// its result: for an all-reduce of B bytes a rank (n + 1) B, for a gather
// 2n B (on cards of their own, (n - 1) B of it over NVLink).  The copy into
// the slot is this design's own traffic.  At decode sizes (80 KB) the
// latency of the signals and, on one card, of the context switch, is most
// of a call.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_RANKS = 8;
constexpr int MAX_BLOCKS = 256;
constexpr int THREADS = 512;
constexpr long long SEM_BYTES = 256;
constexpr long long CTRL_BYTES = 256;

enum Mode { SUM_F32 = 0, SUM_I32 = 1, MAX_F32 = 2, GATHER = 3 };

struct Args {
  char* bases[MAX_RANKS];   // each rank's workspace, mapped in this process
  const char* x;            // this rank's input
  char* out;                // the result (gather: n rows of `stride` bytes)
  long long count;          // elements (4 bytes) to reduce, or bytes to gather
  long long stride;         // gather: bytes a rank's row, a multiple of 16
  long long cap;            // bytes of a slot
  int n, me, mode;
};

struct Ctrl {
  unsigned epoch;
  unsigned arrive;
};

// the semaphores of `rank`'s workspace: [j] counts rank j's signals
__device__ __forceinline__ int* sems(const Args& a, int rank) {
  return (int*)(a.bases[rank] + 2 * a.cap);
}

__device__ __forceinline__ Ctrl* ctrl(const Args& a) {
  return (Ctrl*)(a.bases[a.me] + 2 * a.cap + SEM_BYTES);
}

__device__ __forceinline__ void red_release_sys(int* p, int v) {
  asm volatile("red.release.sys.global.add.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ long long in_bytes(const Args& a) {
  return a.mode == GATHER ? a.count : a.count * 4;
}

// 16-byte units of the input (the last one partial when the input is not a
// multiple of 16 bytes); unit u belongs to block (u / THREADS) % grid
__device__ __forceinline__ long long units(const Args& a) {
  return (in_bytes(a) + 15) / 16;
}

__device__ __forceinline__ long long first_unit() {
  return (long long)blockIdx.x * THREADS + threadIdx.x;
}

__device__ __forceinline__ long long unit_step() {
  return (long long)gridDim.x * THREADS;
}

// this block's units of the input into this rank's slot `slot`
__device__ void copy_in(const Args& a, char* slot) {
  const long long nbytes = in_bytes(a), full = nbytes / 16;
  const long long total = units(a);
  for (long long u = first_unit(); u < total; u += unit_step()) {
    if (u < full) {
      ((uint4*)slot)[u] = ((const uint4*)a.x)[u];
    } else {
      for (long long k = u * 16; k < nbytes; ++k) slot[k] = a.x[k];
    }
  }
}

__device__ __forceinline__ float max_keep_nan(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

__device__ __forceinline__ float4 combine4(float4 acc, float4 v, int mode) {
  if (mode == SUM_F32) {
    acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
  } else {
    acc.x = max_keep_nan(acc.x, v.x); acc.y = max_keep_nan(acc.y, v.y);
    acc.z = max_keep_nan(acc.z, v.z); acc.w = max_keep_nan(acc.w, v.w);
  }
  return acc;
}

// this block's units of the combined result, read from the n slots at
// offset `off` in rank order
__device__ void combine(const Args& a, long long off) {
  const long long total = units(a);
  if (a.mode == GATHER) {
    // every unit whole: a slot and a row are padded to 16 bytes
    for (long long u = first_unit(); u < total; u += unit_step())
      for (int r = 0; r < a.n; ++r)
        ((uint4*)(a.out + r * a.stride))[u] =
            __ldcg((const uint4*)(a.bases[r] + off) + u);
    return;
  }
  const long long full = a.count / 4;
  for (long long u = first_unit(); u < total; u += unit_step()) {
    if (u < full) {
      if (a.mode == SUM_I32) {
        uint4 acc = __ldcg((const uint4*)(a.bases[0] + off) + u);
        for (int r = 1; r < a.n; ++r) {
          const uint4 v = __ldcg((const uint4*)(a.bases[r] + off) + u);
          acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
        }
        ((uint4*)a.out)[u] = acc;
      } else {
        float4 acc = __ldcg((const float4*)(a.bases[0] + off) + u);
        for (int r = 1; r < a.n; ++r)
          acc = combine4(acc, __ldcg((const float4*)(a.bases[r] + off) + u),
                         a.mode);
        ((float4*)a.out)[u] = acc;
      }
    } else {
      for (long long i = u * 4; i < a.count; ++i) {
        if (a.mode == SUM_I32) {
          unsigned acc = __ldcg((const unsigned*)(a.bases[0] + off) + i);
          for (int r = 1; r < a.n; ++r)
            acc += __ldcg((const unsigned*)(a.bases[r] + off) + i);
          ((unsigned*)a.out)[i] = acc;
        } else {
          float acc = __ldcg((const float*)(a.bases[0] + off) + i);
          for (int r = 1; r < a.n; ++r) {
            const float v = __ldcg((const float*)(a.bases[r] + off) + i);
            acc = a.mode == SUM_F32 ? acc + v : max_keep_nan(acc, v);
          }
          ((float*)a.out)[i] = acc;
        }
      }
    }
  }
}

// the copy-in; the last block to finish signals every peer
__global__ void __launch_bounds__(THREADS) put_kernel(Args a) {
  const unsigned epoch = *(volatile unsigned*)&ctrl(a)->epoch;
  copy_in(a, a.bases[a.me] + ((epoch & 1) ? a.cap : 0));
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    Ctrl* c = ctrl(a);
    if (atomicAdd(&c->arrive, 1u) == gridDim.x - 1) {
      c->arrive = 0;
      __threadfence_system();
      for (int j = 0; j < a.n; ++j)
        if (j != a.me) red_release_sys(sems(a, j) + a.me, 1);
    }
  }
}

// after the stream waits: the combine; the last block consumes the signals
// and advances the epoch
__global__ void __launch_bounds__(THREADS) combine_kernel(Args a) {
  const unsigned epoch = *(volatile unsigned*)&ctrl(a)->epoch;
  combine(a, (epoch & 1) ? a.cap : 0);
  __syncthreads();
  if (threadIdx.x == 0) {
    Ctrl* c = ctrl(a);
    __threadfence();
    if (atomicAdd(&c->arrive, 1u) == gridDim.x - 1) {
      for (int j = 0; j < a.n; ++j)
        if (j != a.me) atomicSub(sems(a, a.me) + j, 1);
      c->arrive = 0;
      c->epoch = epoch + 1;
      __threadfence();
    }
  }
}

typedef CUresult (*WaitValue32)(CUstream, CUdeviceptr, cuuint32_t,
                                unsigned int);

// cuStreamWaitValue32 from the driver through the runtime, so the library
// needs no link against libcuda
WaitValue32 wait_value32() {
  static WaitValue32 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuStreamWaitValue32", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuStreamWaitValue32", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = (WaitValue32)p;
  }
  return fn;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

}  // namespace

extern "C" int dw_mc_max_ranks() { return MAX_RANKS; }

// a zeroed workspace of two `cap`-byte slots, the semaphores and the control
// words on the current card (a comm keeps it for the process's life)
extern "C" int dw_mc_alloc(long long cap, void** base) {
  const long long bytes = 2 * cap + SEM_BYTES + CTRL_BYTES;
  cudaError_t err = cudaMalloc(base, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset(*base, 0, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}

extern "C" int dw_mc_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

extern "C" int dw_mc_ipc_handle(void* base, void* handle) {
  return (int)cudaIpcGetMemHandle((cudaIpcMemHandle_t*)handle, base);
}

extern "C" int dw_mc_ipc_open(const void* handle, void** base) {
  cudaIpcMemHandle_t h = *(const cudaIpcMemHandle_t*)handle;
  return (int)cudaIpcOpenMemHandle(base, h, cudaIpcMemLazyEnablePeerAccess);
}

// One collective on `stream`.  `bases`: the n workspaces as mapped here
// (this rank's at `me`); x and out 16-byte aligned; count: fp32/int32
// elements to reduce or bytes to gather; stride: a gathered row's bytes
// (count rounded up to 16).  Returns a cudaError_t (or 1 for a bad argument,
// 2 when the stream wait is missing, 1000 + a CUresult when it fails).
extern "C" int dw_mc_collective(const long long* bases, int n, int me,
                                long long cap, int mode, const void* x,
                                void* out, long long count, long long stride,
                                void* stream) {
  if (n < 1 || n > MAX_RANKS || me < 0 || me >= n || mode < 0 || mode > 3)
    return 1;
  Args a;
  for (int r = 0; r < MAX_RANKS; ++r)
    a.bases[r] = r < n ? (char*)bases[r] : nullptr;
  a.x = (const char*)x;
  a.out = (char*)out;
  a.count = count;
  a.stride = stride;
  a.cap = cap;
  a.n = n;
  a.me = me;
  a.mode = mode;
  const long long nbytes = mode == GATHER ? count : count * 4;
  if (nbytes > cap || (mode == GATHER && stride < nbytes)) return 1;
  const long long units = (nbytes + 15) / 16;
  long long grid = (units + THREADS - 1) / THREADS;
  const int limit = sm_count() < MAX_BLOCKS ? sm_count() : MAX_BLOCKS;
  if (grid > limit) grid = limit;
  if (grid < 1) grid = 1;
  cudaStream_t s = (cudaStream_t)stream;
  WaitValue32 wait = wait_value32();
  if (wait == nullptr) return 2;
  put_kernel<<<(int)grid, THREADS, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int* mine = (int*)((char*)bases[me] + 2 * cap);
  for (int j = 0; j < n; ++j) {
    if (j == me) continue;
    const CUresult r = wait((CUstream)s, (CUdeviceptr)(mine + j), 1,
                            CU_STREAM_WAIT_VALUE_GEQ);
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
  }
  combine_kernel<<<(int)grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
