// Backward of the Whisper encoder self-attention for Hopper (sm_90a), bf16.
//
// Replaces the recompute route of the backward of
// distil_whisper_tpu/ops/encoder_attention.py (`_bwd`, :238: jax.vjp of its
// einsum reference), which the port had run as autograd through the plain
// version, holding the fp32 [B, H, T, T] scores and probabilities of a layer
// in device memory.  For O = softmax(S) V, S = Q K^T D^-1/2, keys >= t_real
// masked, it computes from the forward's row statistics lse2 (the base-2
// log-sum-exp of the scaled scores, stored by csrc/encoder_attention.cu):
//   P     = exp2(S_raw * scale_log2 - lse2)     recomputed, never stored
//   dV    = P^T dO                              P rounded to bf16
//   dP    = dO V^T,  delta = rowsum(dO * O)
//   dS    = P * (dP - delta)                    rounded to bf16
//   dK    = dS^T Q * D^-1/2,  dQ = dS K * D^-1/2
// with fp32 accumulation and fp32 P, dP and dS before the roundings.  The
// plain version (ops/encoder_attention.py::encoder_attention_bwd_plain)
// does the same arithmetic; the two are held at atol/rtol 1e-2 in bf16 on
// the card.
//
// What bounds it on this card: operations.  The gradient takes five
// T x T x D products, 10*B*H*T^2*D (58 GFLOP, 0.058 ms at (2, 20, 1500, 64));
// this kernel does seven, 14*B*H*T^2*D (0.081 ms), since its dQ pass
// recomputes S and dP.  Every score also costs two ex2 (one a pass) on the
// special-function units, and q/k/v/o/dO are read from L2 many times over
// (a head's rows are 192 KB), never from device memory more than once.
//
// Design, three launches on the caller's stream:
// 1. prep: delta = rowsum(dO * O) in fp32 beside lse2, as (lse2, delta)
//    pairs in a scratch buffer [B, H, Tp] (Tp = T rounded up to 128, pad
//    rows zero), which the other two passes read whole 64-row slices of.
// 2. dK/dV: one block per (128-key tile, head, batch row); K and V arrive
//    once by TMA and stay in shared memory.  A producer warp streams 64-query
//    tiles of Q and dO and their (lse2, delta) slice through a 4-stage
//    mbarrier ring.  Two consumer warpgroups own 64 keys each and compute
//    the products transposed, keys as wgmma's M: S^T = K Q^T and
//    dP^T = V dO^T (m64n64k16, both operands K-major over D in shared
//    memory, as the forward's S); P^T and dS^T then sit in registers in
//    exactly the layout of wgmma's A fragment, so dV += P^T dO and
//    dK += dS^T Q take A from registers and B = dO, Q read MN-major through
//    the descriptor's transpose (as the forward reads V).  P and dS never
//    touch shared memory.  Keys >= t_real and query columns >= T are forced
//    to P = 0 (TMA's zero fill alone would leave exp2(-lse2) there); a tile
//    with no live key writes zeros and loads nothing.  dK is scaled by
//    D^-1/2 once, at the end.
// 3. dQ, deterministic by a second pass (no atomics, so two calls give the
//    same bits): one block per 128 queries (64 a consumer warpgroup) holds
//    Q and dO, walks the live 64-key tiles of K and V through a 4-stage
//    ring, recomputes S = Q K^T and dP = dO V^T (m64n64k16), and
//    accumulates dQ += dS K with dS from registers and K read MN-major.
//    (128-key tiles need S, dP, dQ and dS live at once: past the 168
//    registers a thread that ptxas allots at 384 threads a block, they
//    spilled and serialized the wgmmas.)
//    This route costs two of the seven products; per-key-tile fp32 partials
//    summed in a fixed order would cost 12 partial dQ arrays (184 MB at
//    (2, 20, 1500, 64)) written and read again, more than the products.
// Outputs are written with the caller's strides (the wrapper passes
// [B, H, T, 64] views of [B, T, H, 64] buffers), rows >= T not stored.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int D = 64;                           // head dim (128-byte rows)
constexpr int ROW_BYTES = D * 2;
constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);  // producer + consumers
constexpr int PRODUCER_REGS = 24;               // setmaxnreg, of the SM's 64K:
constexpr int CONSUMER_REGS = 240;              // 128 x 24 + 256 x 240 <= 65536
constexpr int LD_ALIGN = 128;                   // rows of the (lse2, delta) pad

// dK/dV pass
constexpr int KV_KEYS = 64 * CONSUMERS;         // keys a block
constexpr int KV_Q = 64;                        // queries a streamed tile
constexpr int KV_STAGES = 4;
constexpr int KV_TILE = KV_KEYS * ROW_BYTES;    // K or V of the block
constexpr int KV_QTILE = KV_Q * ROW_BYTES;      // Q or dO of a stage
constexpr int LD_BYTES = KV_Q * 8;              // (lse2, delta) of a stage
constexpr int KV_SMEM =
    2 * KV_TILE + KV_STAGES * (2 * KV_QTILE + LD_BYTES) + 256 + 1024;

// dQ pass
constexpr int DQ_Q = 64 * CONSUMERS;            // queries a block
constexpr int DQ_K = 64;                        // keys a streamed tile
constexpr int DQ_STAGES = 4;
constexpr int DQ_QTILE = DQ_Q * ROW_BYTES;      // Q or dO of the block
constexpr int DQ_KTILE = DQ_K * ROW_BYTES;      // K or V of a stage
constexpr int DQ_SMEM = 2 * DQ_QTILE + DQ_STAGES * 2 * DQ_KTILE + 256 + 1024;

struct KvBarriers {
  uint64_t kv_full;
  uint64_t full[KV_STAGES], empty[KV_STAGES];
};
struct DqBarriers {
  uint64_t q_full;
  uint64_t full[DQ_STAGES], empty[DQ_STAGES];
};

// One contiguous global -> shared copy by the bulk-copy engine, completing
// on an mbarrier's transaction count (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

#define DW_F8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[32] (+)= A[64x16] * B[16x64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DW_F8(0), DW_F8(8), DW_F8(16), DW_F8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A[64x16] * B[16x64]: A from registers (four packed bf16 pairs a
// thread, the accumulator layout of two n8 blocks), B stored with N (head
// dim) contiguous and read through the transpose flag.
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DW_F8(0), DW_F8(8), DW_F8(16), DW_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef DW_F8

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of k-step kk (16 columns: the accumulator's n8 blocks 2kk
// and 2kk+1) from an fp32 accumulator tile, rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// Rows r (0: g, 1: g + 8) of a 64 x D fp32 accumulator, scaled, as bf16
// pairs into a strided [rows][64] output.
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long st,
                                           int row0, int T, int tq,
                                           const float (&acc)[32],
                                           float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
    __nv_bfloat16* orow = out + (long long)row * st;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      *reinterpret_cast<uint32_t*>(orow + n8 * 8 + 2 * tq) =
          pack_bf16(acc[4 * n8 + 2 * r] * scale, acc[4 * n8 + 2 * r + 1] * scale);
  }
}

// ---- 1. (lse2, delta) of every row ------------------------------------------
// Eight threads a row, eight elements each; rows >= T (up to Tp) get zeros.
constexpr int PREP_ROWS = 32;                   // rows a block of 256 threads

__global__ void __launch_bounds__(256)
prep_kernel(const __nv_bfloat16* __restrict__ o,
            const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, float2* __restrict__ ld, int T,
            int Tp, int heads, long long o_sb, long long o_sh, long long o_st,
            long long d_sb, long long d_sh, long long d_st) {
  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int row = blockIdx.y * PREP_ROWS + threadIdx.x / 8;
  const int part = threadIdx.x % 8;
  float acc = 0.f;
  if (row < T) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * o_sb + h * o_sh + row * o_st + part * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dout + b * d_sb + h * d_sh + row * d_st + part * 8);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(op[i]), c = __bfloat1622float2(dp[i]);
      acc = fmaf(a.x, c.x, acc);
      acc = fmaf(a.y, c.y, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (part == 0 && row < Tp)
    ld[(long long)bh * Tp + row] =
        row < T ? make_float2(lse[(long long)bh * T + row], acc)
                : make_float2(0.f, 0.f);
}

// ---- 2. dK and dV -----------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(__grid_constant__ const CUtensorMap qmap,
            __grid_constant__ const CUtensorMap kmap,
            __grid_constant__ const CUtensorMap vmap,
            __grid_constant__ const CUtensorMap domap,
            const float2* __restrict__ ld, __nv_bfloat16* __restrict__ dk,
            __nv_bfloat16* __restrict__ dv, int T, int Tp, int t_real,
            int heads, float scale_log2, float scale, long long dk_sb,
            long long dk_sh, long long dk_st, long long dv_sb,
            long long dv_sh, long long dv_st) {
  const int key0 = blockIdx.x * KV_KEYS, h = blockIdx.y, b = blockIdx.z;
  dk += b * dk_sb + h * dk_sh;
  dv += b * dv_sb + h * dv_sh;
  if (key0 >= t_real) {
    // no live key in the tile: its gradients are zero
    for (int i = threadIdx.x; i < KV_KEYS * D / 2; i += THREADS) {
      const int key = key0 + i / (D / 2), col = 2 * (i % (D / 2));
      if (key >= T) continue;
      *reinterpret_cast<uint32_t*>(dk + key * dk_st + col) = 0u;
      *reinterpret_cast<uint32_t*>(dv + key * dv_st + col) = 0u;
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  // tiles 1024-aligned: the 128-byte swizzle pattern repeats every 1024 B
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;
  uint8_t* sV = sK + KV_TILE;
  uint8_t* sQ = sV + KV_TILE;
  uint8_t* sDO = sQ + KV_STAGES * KV_QTILE;
  float2* sLD = reinterpret_cast<float2*>(sDO + KV_STAGES * KV_QTILE);
  KvBarriers* bar = reinterpret_cast<KvBarriers*>(
      reinterpret_cast<uint8_t*>(sLD) + KV_STAGES * LD_BYTES);

  const int n_qt = (T + KV_Q - 1) / KV_Q;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(&bar->kv_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(&bar->full[s], 1);
      mbar_init(&bar->empty[s], 4 * CONSUMERS);   // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ===== producer: one thread loads K, V once, then the Q/dO ring =====
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar->kv_full, 2 * KV_TILE);
      tma_load_4d(sK, &kmap, &bar->kv_full, 0, key0, h, b);
      tma_load_4d(sV, &vmap, &bar->kv_full, 0, key0, h, b);
      const float2* ldh = ld + ((long long)b * heads + h) * Tp;
      int s = 0;
      uint32_t ph = 0;
      for (int i = 0; i < n_qt; ++i) {
        mbar_wait(&bar->empty[s], ph ^ 1);
        mbar_expect_tx(&bar->full[s], 2 * KV_QTILE + LD_BYTES);
        tma_load_4d(sQ + s * KV_QTILE, &qmap, &bar->full[s], 0, i * KV_Q, h, b);
        tma_load_4d(sDO + s * KV_QTILE, &domap, &bar->full[s], 0, i * KV_Q, h, b);
        bulk_load(sLD + s * KV_Q, ldh + i * KV_Q, LD_BYTES, &bar->full[s]);
        if (++s == KV_STAGES) { s = 0; ph ^= 1; }
      }
    }
  } else {
    // ===== consumers: 64 keys each =====
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int w = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;       // fragment row group / pair
    const uint32_t k_addr = smem_u32(sK) + c * (64 * ROW_BYTES);
    const uint32_t v_addr = smem_u32(sV) + c * (64 * ROW_BYTES);
    const uint32_t q_base = smem_u32(sQ), do_base = smem_u32(sDO);
    const int krow = key0 + 64 * c + 16 * w + g;   // this thread's keys: +0, +8
    const bool live[2] = {krow < t_real, krow + 8 < t_real};

    float dk_acc[32], dv_acc[32];  // n-block j8 -> keys g, g+8; dims 8 j8 + 2 tq + {0, 1}
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(&bar->kv_full, 0);

    int s = 0;
    uint32_t ph = 0;
    for (int i = 0; i < n_qt; ++i) {
      float st[32], dpt[32];       // S^T and dP^T: element e is key row
                                   // (e >> 1) & 1, query 8 (e / 4) + 2 tq + (e & 1)
      mbar_wait(&bar->full[s], ph);
      const uint32_t qa = q_base + s * KV_QTILE, da = do_base + s * KV_QTILE;
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss64(st, desc_sw128(k_addr + ks * 32), desc_sw128(qa + ks * 32), ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss64(dpt, desc_sw128(v_addr + ks * 32), desc_sw128(da + ks * 32), ks > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp2(S^T scale_log2 - lse2), dS^T = P^T (dP^T - delta); keys
      // >= t_real and queries >= T give 0
      const float2* ldt = sLD + s * KV_Q;
      const int q_valid = T - i * KV_Q;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * tq + e;
          const float2 lv = ldt[col];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int idx = 4 * j + 2 * r + e;
            float p = ex2(fmaf(st[idx], scale_log2, -lv.x));
            if (!live[r] || col >= q_valid) p = 0.f;
            st[idx] = p;
            dpt[idx] = p * (dpt[idx] - lv.y);
          }
        }
      uint32_t pa[4][4], sa[4][4];
      pack_a<64>(pa, st);
      pack_a<64>(sa, dpt);

      // dV += P^T dO, dK += dS^T Q: A from registers, B read transposed
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KV_Q / 16; ++kk)
        wgmma_rs64(dv_acc, pa[kk], desc_sw128(da + kk * 16 * ROW_BYTES));
#pragma unroll
      for (int kk = 0; kk < KV_Q / 16; ++kk)
        wgmma_rs64(dk_acc, sa[kk], desc_sw128(qa + kk * 16 * ROW_BYTES));
      wg_commit();
      wg_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar->empty[s]);
      if (++s == KV_STAGES) { s = 0; ph ^= 1; }
    }

    // keys in [t_real, T) store the zeros they accumulated
    store_rows(dk, dk_st, krow, T, tq, dk_acc, scale);
    store_rows(dv, dv_st, krow, T, tq, dv_acc, 1.f);
  }
}

// ---- 3. dQ, a second pass over the keys -------------------------------------
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(__grid_constant__ const CUtensorMap qmap,
          __grid_constant__ const CUtensorMap kmap,
          __grid_constant__ const CUtensorMap vmap,
          __grid_constant__ const CUtensorMap domap,
          const float2* __restrict__ ld, __nv_bfloat16* __restrict__ dq,
          int T, int Tp, int t_real, int heads, float scale_log2, float scale,
          long long dq_sb, long long dq_sh, long long dq_st) {
  const int q0 = blockIdx.x * DQ_Q, h = blockIdx.y, b = blockIdx.z;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sDO = sQ + DQ_QTILE;
  uint8_t* sK = sDO + DQ_QTILE;
  uint8_t* sV = sK + DQ_STAGES * DQ_KTILE;
  DqBarriers* bar = reinterpret_cast<DqBarriers*>(sV + DQ_STAGES * DQ_KTILE);

  const int n_kt = (t_real + DQ_K - 1) / DQ_K;   // key tiles with a live key
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(&bar->q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&bar->full[s], 1);
      mbar_init(&bar->empty[s], 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ===== producer: Q and dO once, then the K/V ring =====
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bar->q_full, 2 * DQ_QTILE);
      tma_load_4d(sQ, &qmap, &bar->q_full, 0, q0, h, b);
      tma_load_4d(sDO, &domap, &bar->q_full, 0, q0, h, b);
      int s = 0;
      uint32_t ph = 0;
      for (int j = 0; j < n_kt; ++j) {
        mbar_wait(&bar->empty[s], ph ^ 1);
        mbar_expect_tx(&bar->full[s], 2 * DQ_KTILE);
        tma_load_4d(sK + s * DQ_KTILE, &kmap, &bar->full[s], 0, j * DQ_K, h, b);
        tma_load_4d(sV + s * DQ_KTILE, &vmap, &bar->full[s], 0, j * DQ_K, h, b);
        if (++s == DQ_STAGES) { s = 0; ph ^= 1; }
      }
    }
  } else {
    // ===== consumers: 64 query rows each =====
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int w = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;
    const uint32_t q_addr = smem_u32(sQ) + c * (64 * ROW_BYTES);
    const uint32_t do_addr = smem_u32(sDO) + c * (64 * ROW_BYTES);
    const uint32_t k_base = smem_u32(sK), v_base = smem_u32(sV);
    const int qrow = q0 + 64 * c + 16 * w + g;    // this thread's rows: +0, +8
    // rows >= T read the zero pad (Tp >= q0 + DQ_Q) and are never stored
    const float2* ldh = ld + ((long long)b * heads + h) * Tp;
    const float2 lv[2] = {ldh[qrow], ldh[qrow + 8]};

    float dq_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
    mbar_wait(&bar->q_full, 0);

    int s = 0;
    uint32_t ph = 0;
    for (int j = 0; j < n_kt; ++j) {
      float s_acc[32], dp[32];     // element e: row (e >> 1) & 1, key 8 (e / 4) + 2 tq + (e & 1)
      mbar_wait(&bar->full[s], ph);
      const uint32_t ka = k_base + s * DQ_KTILE, va = v_base + s * DQ_KTILE;
      fence_regs(dq_acc);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss64(s_acc, desc_sw128(q_addr + ks * 32), desc_sw128(ka + ks * 32), ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss64(dp, desc_sw128(do_addr + ks * 32), desc_sw128(va + ks * 32), ks > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s_acc);
      fence_regs(dp);

      const int k_valid = t_real - j * DQ_K;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        float p = ex2(fmaf(s_acc[e], scale_log2, -lv[r].x));
        if (8 * (e / 4) + 2 * tq + (e & 1) >= k_valid) p = 0.f;
        dp[e] = p * (dp[e] - lv[r].y);
      }
      uint32_t sa[4][4];
      pack_a<64>(sa, dp);

      // dQ += dS K: A from registers, K read transposed
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_K / 16; ++kk)
        wgmma_rs64(dq_acc, sa[kk], desc_sw128(ka + kk * 16 * ROW_BYTES));
      wg_commit();
      wg_wait<0>();
      fence_regs(dq_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar->empty[s]);
      if (++s == DQ_STAGES) { s = 0; ph ^= 1; }
    }
    store_rows(dq + b * dq_sb + h * dq_sh, dq_st, qrow, T, tq, dq_acc, scale);
  }
}

// ---- host side --------------------------------------------------------------
// dims (64, T, H, B); byte strides of T, H and B; boxes of 64 x rows.
int make_map(CUtensorMap* map, const void* ptr, int T, int H, int B,
             long long st, long long sh, long long sb, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {D, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st, (cuuint64_t)sh, (cuuint64_t)sb};
  const cuuint32_t box[4] = {D, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// Byte strides come in (T, H, B) order for each of q, k, v, o, dout, dq, dk
// and dv, as the wrapper's _tma_geometry gives them.  lse: fp32 [B, H, T]
// contiguous, from the forward.  ld: fp32 scratch of B * H * Tp pairs, Tp a
// multiple of 128 not below T.  want_dq / want_dkdv skip a pass (dk and dv
// are written together).
extern "C" int dw_encoder_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ld, void* dq, void* dk, void* dv,
    int batch, int heads, int T, int Tp, int t_real, float scale_log2,
    float scale, int want_dq, int want_dkdv,
    long long q_st, long long q_sh, long long q_sb,
    long long k_st, long long k_sh, long long k_sb,
    long long v_st, long long v_sh, long long v_sb,
    long long o_st, long long o_sh, long long o_sb,
    long long d_st, long long d_sh, long long d_sb,
    long long dq_st, long long dq_sh, long long dq_sb,
    long long dk_st, long long dk_sh, long long dk_sb,
    long long dv_st, long long dv_sh, long long dv_sb, void* stream) {
  if (t_real < 1 || t_real > T || Tp < T || Tp % LD_ALIGN)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 prep_grid(batch * heads, Tp / PREP_ROWS);
  prep_kernel<<<prep_grid, 256, 0, st>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)lse,
      (float2*)ld, T, Tp, heads, o_sb / 2, o_sh / 2, o_st / 2, d_sb / 2,
      d_sh / 2, d_st / 2);
  int err = (int)cudaGetLastError();
  if (err) return err;

  CUtensorMap qmap, kmap, vmap, domap;
  if (want_dkdv) {
    err = make_map(&qmap, q, T, heads, batch, q_st, q_sh, q_sb, KV_Q);
    if (!err) err = make_map(&kmap, k, T, heads, batch, k_st, k_sh, k_sb, KV_KEYS);
    if (!err) err = make_map(&vmap, v, T, heads, batch, v_st, v_sh, v_sb, KV_KEYS);
    if (!err) err = make_map(&domap, dout, T, heads, batch, d_st, d_sh, d_sb, KV_Q);
    if (!err)
      err = (int)cudaFuncSetAttribute(
          dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM);
    if (err) return err;
    const dim3 grid((T + KV_KEYS - 1) / KV_KEYS, heads, batch);
    dkdv_kernel<<<grid, THREADS, KV_SMEM, st>>>(
        qmap, kmap, vmap, domap, (const float2*)ld, (__nv_bfloat16*)dk,
        (__nv_bfloat16*)dv, T, Tp, t_real, heads, scale_log2, scale,
        dk_sb / 2, dk_sh / 2, dk_st / 2, dv_sb / 2, dv_sh / 2, dv_st / 2);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (want_dq) {
    err = make_map(&qmap, q, T, heads, batch, q_st, q_sh, q_sb, DQ_Q);
    if (!err) err = make_map(&kmap, k, T, heads, batch, k_st, k_sh, k_sb, DQ_K);
    if (!err) err = make_map(&vmap, v, T, heads, batch, v_st, v_sh, v_sb, DQ_K);
    if (!err) err = make_map(&domap, dout, T, heads, batch, d_st, d_sh, d_sb, DQ_Q);
    if (!err)
      err = (int)cudaFuncSetAttribute(
          dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
    if (err) return err;
    const dim3 grid((T + DQ_Q - 1) / DQ_Q, heads, batch);
    dq_kernel<<<grid, THREADS, DQ_SMEM, st>>>(
        qmap, kmap, vmap, domap, (const float2*)ld, (__nv_bfloat16*)dq, T, Tp,
        t_real, heads, scale_log2, scale, dq_sb / 2, dq_sh / 2, dq_st / 2);
    err = (int)cudaGetLastError();
  }
  return err;
}
