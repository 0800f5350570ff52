// The route not taken for the encoder-attention backward's dQ on Hopper
// (sm_90a), kept as a measured prototype; the port does not build or call it.
//
// One pass computes dK and dV as csrc/encoder_attention_bwd.cu does and
// also each 128-key tile's dQ partial, dS K, with dS^T staged through shared
// memory, adding the partials into an fp32 [B, H, Tp, 64] buffer with fp32
// atomicAdd in whatever order the blocks reach them.  That drops the dQ
// pass's two recomputed products (S and dP) and its ex2, at the cost of the
// atomics (Tp / 128 * Tp * 64 adds a (batch row, head), 47 M at (2, 20,
// 1500, 64)), a ring of two stages beside two dS^T buffers in shared
// memory, and registers for the partials.  Plain atomics are not deterministic and are the fastest any
// ordering of the adds (a per-tile counter, or a cluster's distributed
// shared memory) could be, so this prototype's time bounds the route from
// below.  Before it, a dQ launch (this file's earlier, 64-key-tile revision
// of the dQ pass, with dq null) writes the (lse2, delta) pairs; after it, a
// conversion writes dq [B, T, H, 64] bf16 times D^-1/2.
//
//     python3 scripts/torch_attention_bwd_ablate.py --fused_route
//
// builds it and times it against the kernel of the checkout.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int D = 64;                           // head dim (128-byte rows)
constexpr int ROW_BYTES = D * 2;
constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);  // producer + consumers
constexpr int PRODUCER_REGS = 40;               // setmaxnreg, of the SM's 64K:
constexpr int CONSUMER_REGS = 232;              // 128 x 40 + 256 x 232 = 384 x 168
constexpr int ITEM = 128;                       // rows of a work item (= LD_ALIGN)
constexpr int SUB = 64;                         // rows of a TMA box, a streamed
                                                // tile and a consumer's share
constexpr int SUB_BYTES = SUB * ROW_BYTES;
constexpr int ITEM_BYTES = ITEM * ROW_BYTES;
constexpr int STAGES = 4;
constexpr int LD_BYTES = ITEM * 8;              // (lse2, delta) of a stage

// dQ pass: two buffers of an item's Q, dO and O; a ring of 128-key K/V tiles
constexpr int DQ_BUF = 3 * ITEM_BYTES;
constexpr int DQ_SMEM = 2 * DQ_BUF + STAGES * 2 * ITEM_BYTES + 256 + 1024;
// dK/dV pass: two buffers of an item's K and V; a ring of 128-query Q/dO
// tiles
constexpr int KV_BUF = 2 * ITEM_BYTES;
constexpr int KV_SMEM =
    2 * KV_BUF + STAGES * (2 * ITEM_BYTES + LD_BYTES) + 256 + 1024;

struct Barriers {
  uint64_t item_full[2], item_empty[2];
  uint64_t full[STAGES], empty[STAGES];
};

// A ring stage and the parity of its current phase.
template <int N>
struct RingT {
  int s = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next() {
    if (++s == N) { s = 0; ph ^= 1; }
  }
};
using Ring = RingT<STAGES>;

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

// ---- the consumers' turns at the tensor cores ------------------------------
// Consumer c waits on barrier 1 + c; the other arrives there when it has
// issued its products.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// The warpgroup of this thread, warp-uniform to the compiler, so that
// setmaxnreg's new limit reaches each branch of the role split.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

__device__ __forceinline__ void init_barriers(Barriers* bar) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bar->item_full[i], 1);
      mbar_init(&bar->item_empty[i], 4 * CONSUMERS);   // one arrive per warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bar->full[s], 1);
      mbar_init(&bar->empty[s], 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// An item's 128 rows as two 64-row boxes (one tensor map serves all loads).
__device__ __forceinline__ void load_item(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int h,
                                          int b) {
  tma_load_4d(dst, map, bar, 0, row0, h, b);
  tma_load_4d(dst + SUB_BYTES, map, bar, 0, row0 + SUB, h, b);
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

// d[64] (+)= A[64x16] * B[16x128], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : DW_F8(0), DW_F8(8), DW_F8(16), DW_F8(24), DW_F8(32), DW_F8(40),
        DW_F8(48), DW_F8(56)
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

// d += A B over a K of 16 KS rows: KS k-steps with A from registers and B
// a 16 KS x 64 tile stored [k][n] (128-byte rows) at `b_addr`.
template <int KS>
__device__ __forceinline__ void rs_tile(float (&d)[32],
                                        const uint32_t (&a)[KS][4],
                                        uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs64(d, a[kk], desc_sw128(b_addr + kk * 16 * ROW_BYTES));
}

// d = A B^T over D: A a 64-row and B a 64- or 128-row tile, both [row][D]
// (K-major).
__device__ __forceinline__ void ss_tile(float (&d)[32], uint32_t a_addr,
                                        uint32_t b_addr) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss64(d, desc_sw128(a_addr + ks * 32), desc_sw128(b_addr + ks * 32),
               ks > 0);
}
__device__ __forceinline__ void ss_tile(float (&d)[64], uint32_t a_addr,
                                        uint32_t b_addr) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss128(d, desc_sw128(a_addr + ks * 32), desc_sw128(b_addr + ks * 32),
                ks > 0);
}

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
// and 2kk+1) from an fp32 64 x 16 KS accumulator tile, rounded to bf16.
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4],
                                       const float (&x)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// Rows row0 and row0 + 8 of a 64 x D fp32 accumulator, scaled, as bf16
// pairs into a [rows][st] output; rows >= T not stored.
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

// dQ pass, rows = queries: dS = P (dP - delta), P = exp2(S scale_log2 -
// lse2), into bf16 A fragments.  Element e of the accumulators is row
// (e >> 1) & 1 (+0, +8), key 8 (e / 4) + 2 tq + (e & 1); with MASK keys
// >= k_valid give P = 0.
template <bool MASK, int KS>
__device__ __forceinline__ void ds_rows(uint32_t (&sa)[KS][4],
                                        const float (&s)[8 * KS],
                                        float (&dp)[8 * KS],
                                        const float2 (&lv)[2],
                                        float scale_log2, int k_valid,
                                        int tq) {
#pragma unroll
  for (int e = 0; e < 8 * KS; ++e) {
    const int r = (e >> 1) & 1;
    float p = ex2(fmaf(s[e], scale_log2, -lv[r].x));
    if (MASK && 8 * (e / 4) + 2 * tq + (e & 1) >= k_valid) p = 0.f;
    dp[e] = p * (dp[e] - lv[r].y);
  }
  pack_a(sa, dp);
}

// dK/dV pass, rows = keys: P^T and dS^T into bf16 A fragments.  Element e is
// key row (e >> 1) & 1, query 8 (e / 4) + 2 tq + (e & 1), whose (lse2,
// delta) is ldt[query]; with MASK dead keys and queries >= q_valid give 0.
template <bool MASK, int KS>
__device__ __forceinline__ void p_ds_cols(uint32_t (&pa)[KS][4],
                                          uint32_t (&sa)[KS][4],
                                          float (&st)[8 * KS],
                                          float (&dpt)[8 * KS],
                                          const float2* ldt, float scale_log2,
                                          const bool (&live)[2], int q_valid,
                                          int tq) {
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * tq + e;
      const float2 lv = ldt[col];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int idx = 4 * j + 2 * r + e;
        float p = ex2(fmaf(st[idx], scale_log2, -lv.x));
        if (MASK && (!live[r] || col >= q_valid)) p = 0.f;
        st[idx] = p;
        dpt[idx] = p * (dpt[idx] - lv.y);
      }
    }
  pack_a(pa, st);
  pack_a(sa, dpt);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  // the 128-byte swizzle pattern repeats every 1024 B
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---- 1. dQ, and (lse2, delta) of every row ----------------------------------
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(__grid_constant__ const CUtensorMap qmap,
          __grid_constant__ const CUtensorMap kmap,
          __grid_constant__ const CUtensorMap vmap,
          __grid_constant__ const CUtensorMap omap,
          __grid_constant__ const CUtensorMap domap,
          const float* __restrict__ lse, float2* __restrict__ ld,
          __nv_bfloat16* __restrict__ dq, int T, int t_real, int heads,
          int tiles, int n_items, float scale_log2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sItem = align_1024(smem_raw);          // [2][Q, dO, O]
  uint8_t* sK = sItem + 2 * DQ_BUF;
  uint8_t* sV = sK + STAGES * ITEM_BYTES;
  Barriers* bar = reinterpret_cast<Barriers*>(sV + STAGES * ITEM_BYTES);
  // 128-key tiles with a live key; none when only the pairs are wanted
  const int n_kt = dq == nullptr ? 0 : (t_real + ITEM - 1) / ITEM;
  init_barriers(bar);

  if (warpgroup() == 0) {
    // ===== producer: one thread; the item's Q, dO, O, then the K/V ring =====
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      Ring ring;
      for (int item = blockIdx.x, n = 0; item < n_items;
           item += gridDim.x, ++n) {
        const int qt = item % tiles, h = (item / tiles) % heads,
                  b = item / (tiles * heads);
        const int bi = n & 1;
        uint8_t* buf = sItem + bi * DQ_BUF;
        mbar_wait(&bar->item_empty[bi], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&bar->item_full[bi], DQ_BUF);
        load_item(buf, &qmap, &bar->item_full[bi], qt * ITEM, h, b);
        load_item(buf + ITEM_BYTES, &domap, &bar->item_full[bi], qt * ITEM, h, b);
        load_item(buf + 2 * ITEM_BYTES, &omap, &bar->item_full[bi], qt * ITEM, h, b);
        for (int j = 0; j < n_kt; ++j) {
          mbar_wait(&bar->empty[ring.s], ring.ph ^ 1);
          mbar_expect_tx(&bar->full[ring.s], 2 * ITEM_BYTES);
          load_item(sK + ring.s * ITEM_BYTES, &kmap, &bar->full[ring.s], j * ITEM, h, b);
          load_item(sV + ring.s * ITEM_BYTES, &vmap, &bar->full[ring.s], j * ITEM, h, b);
          ring.next();
        }
      }
    }
  } else {
    // ===== consumers: 64 query rows of the item each =====
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int c = warpgroup() - 1;
    const int tid = threadIdx.x % 128;
    const int w = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;       // fragment row group / pair
    const int rl = SUB * c + 16 * w + g;         // this thread's rows: +0, +8
    const uint32_t k_base = smem_u32(sK), v_base = smem_u32(sV);
    const int Tp = tiles * ITEM;
    const long long st = (long long)heads * D;   // row stride of dq
    Ring ring;
    if (n_kt > 0 && c == CONSUMERS - 1) bar_arrive(1);  // consumer 0 goes first
    for (int item = blockIdx.x, n = 0; item < n_items; item += gridDim.x, ++n) {
      const int qt = item % tiles, h = (item / tiles) % heads,
                b = item / (tiles * heads);
      const long long bh = (long long)b * heads + h;
      const int bi = n & 1;
      const uint8_t* buf = sItem + bi * DQ_BUF;
      mbar_wait(&bar->item_full[bi], (n >> 1) & 1);

      // delta = rowsum(dO * O) of rows rl and rl + 8, four threads a row
      // (16-byte chunks 2 tq, 2 tq + 1 of the swizzled 128-byte row), beside
      // the row's lse2; rows >= T (up to Tp) get zeros
      float2 lv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rl + 8 * r, grow = qt * ITEM + row;
        float acc = 0.f;
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int off = row * ROW_BYTES + (((2 * tq + cc) ^ (row % 8)) * 16);
          const uint4 dv4 = *reinterpret_cast<const uint4*>(buf + ITEM_BYTES + off);
          const uint4 ov4 = *reinterpret_cast<const uint4*>(buf + 2 * ITEM_BYTES + off);
          const __nv_bfloat162* dp2 = reinterpret_cast<const __nv_bfloat162*>(&dv4);
          const __nv_bfloat162* op2 = reinterpret_cast<const __nv_bfloat162*>(&ov4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 a = __bfloat1622float2(op2[i]), d = __bfloat1622float2(dp2[i]);
            acc = fmaf(a.x, d.x, acc);
            acc = fmaf(a.y, d.y, acc);
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        lv[r] = grow < T ? make_float2(lse[bh * T + grow], acc)
                         : make_float2(0.f, 0.f);
        if (tq == 0) ld[bh * Tp + grow] = lv[r];
      }
      if (n_kt == 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&bar->item_empty[bi]);
        continue;
      }

      const uint32_t q_addr = smem_u32(buf) + c * SUB_BYTES;
      const uint32_t do_addr = q_addr + ITEM_BYTES;
      // the last consumer's last turn of the block hands over to no one
      const bool hand_last = !(c == CONSUMERS - 1 && item + (int)gridDim.x >= n_items);
      float dq_acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
      uint32_t sa[8][4];
      int sp = 0;                                // stage of key tile j - 1
      for (int j = 0; j < n_kt; ++j) {
        float s_acc[64], dp[64];
        mbar_wait(&bar->full[ring.s], ring.ph);
        bar_sync(1 + c);                         // my turn at the tensor cores
        fence_regs(dq_acc);
        wg_fence();
        if (j > 0) rs_tile(dq_acc, sa, k_base + sp * ITEM_BYTES);
        ss_tile(s_acc, q_addr, k_base + ring.s * ITEM_BYTES);
        ss_tile(dp, do_addr, v_base + ring.s * ITEM_BYTES);
        wg_commit();
        bar_arrive(1 + (c + 1) % CONSUMERS);     // hand the turn over
        wg_wait<0>();
        fence_regs(s_acc);
        fence_regs(dp);
        fence_regs(dq_acc);
        if (j > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&bar->empty[sp]);
        }
        const int k_valid = t_real - j * ITEM;
        if (k_valid < ITEM)
          ds_rows<true>(sa, s_acc, dp, lv, scale_log2, k_valid, tq);
        else
          ds_rows<false>(sa, s_acc, dp, lv, scale_log2, k_valid, tq);
        sp = ring.s;
        ring.next();
      }
      // the last key tile's dQ += dS K
      bar_sync(1 + c);
      fence_regs(dq_acc);
      wg_fence();
      rs_tile(dq_acc, sa, k_base + sp * ITEM_BYTES);
      wg_commit();
      if (hand_last) bar_arrive(1 + (c + 1) % CONSUMERS);
      wg_wait<0>();
      fence_regs(dq_acc);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&bar->empty[sp]);
        mbar_arrive(&bar->item_empty[bi]);
      }
      store_rows(dq + (long long)b * T * st + h * D, st, qt * ITEM + rl, T, tq,
                 dq_acc, scale);
    }
  }
}

// ---- fused dK/dV/dQ prototype (dQ partials added with atomics) ------------
constexpr int FSTAGES = 2;
constexpr int DS_BYTES = ITEM * ITEM * 2;        // dS^T of a 128 x 128 tile
constexpr int FU_SMEM = 2 * KV_BUF + FSTAGES * (2 * ITEM_BYTES + LD_BYTES) +
                        2 * DS_BYTES + 512 + 1024;

struct FusedBarriers {
  uint64_t item_full[2], item_empty[2];
  uint64_t full[FSTAGES], empty[FSTAGES];
  uint64_t ds_full[2], ds_empty[2];
};

// d[32] (+)= A[64x16] * B[16x64], A and B both stored MN-major in shared
// memory (transposed reads of [k][m] and [k][n] tiles).
__device__ __forceinline__ void wgmma_tt64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}"
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(THREADS, 1)
fused_kernel(__grid_constant__ const CUtensorMap qmap,
             __grid_constant__ const CUtensorMap kmap,
             __grid_constant__ const CUtensorMap vmap,
             __grid_constant__ const CUtensorMap domap,
             const float2* __restrict__ ld, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, float* __restrict__ dq_acc,
             int T, int t_real, int heads, int tiles, int n_items,
             float scale_log2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sItem = align_1024(smem_raw);          // [2][K, V]
  uint8_t* sQ = sItem + 2 * KV_BUF;
  uint8_t* sDO = sQ + FSTAGES * ITEM_BYTES;
  uint8_t* sDS = sDO + FSTAGES * ITEM_BYTES;      // [2][query half][128 keys][64]
  float2* sLD = reinterpret_cast<float2*>(sDS + 2 * DS_BYTES);
  FusedBarriers* bar = reinterpret_cast<FusedBarriers*>(
      reinterpret_cast<uint8_t*>(sLD) + FSTAGES * LD_BYTES);
  const int n_qt = tiles;
  const int live_tiles = (t_real + ITEM - 1) / ITEM;
  const int Tp = tiles * ITEM;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bar->item_full[i], 1);
      mbar_init(&bar->item_empty[i], 4 * CONSUMERS);
      mbar_init(&bar->ds_full[i], 4 * CONSUMERS);
      mbar_init(&bar->ds_empty[i], 4 * CONSUMERS);
    }
    for (int s = 0; s < FSTAGES; ++s) {
      mbar_init(&bar->full[s], 1);
      mbar_init(&bar->empty[s], 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup() == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      RingT<FSTAGES> ring;
      int m = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int kt = item % tiles, h = (item / tiles) % heads,
                  b = item / (tiles * heads);
        if (kt >= live_tiles) continue;
        const int bi = m & 1;
        uint8_t* buf = sItem + bi * KV_BUF;
        mbar_wait(&bar->item_empty[bi], ((m >> 1) & 1) ^ 1);
        mbar_expect_tx(&bar->item_full[bi], KV_BUF);
        load_item(buf, &kmap, &bar->item_full[bi], kt * ITEM, h, b);
        load_item(buf + ITEM_BYTES, &vmap, &bar->item_full[bi], kt * ITEM, h, b);
        const float2* ldh = ld + ((long long)b * heads + h) * Tp;
        for (int i = 0; i < n_qt; ++i) {
          mbar_wait(&bar->empty[ring.s], ring.ph ^ 1);
          mbar_expect_tx(&bar->full[ring.s], 2 * ITEM_BYTES + LD_BYTES);
          load_item(sQ + ring.s * ITEM_BYTES, &qmap, &bar->full[ring.s], i * ITEM, h, b);
          load_item(sDO + ring.s * ITEM_BYTES, &domap, &bar->full[ring.s], i * ITEM, h, b);
          bulk_load(sLD + ring.s * ITEM, ldh + i * ITEM, LD_BYTES, &bar->full[ring.s]);
          ring.next();
        }
        ++m;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int c = warpgroup() - 1;
    const int tid = threadIdx.x % 128;
    const int w = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;
    const uint32_t q_base = smem_u32(sQ), do_base = smem_u32(sDO);
    const long long st = (long long)heads * D;
    auto next_live = [&](int from) {
      while (from < n_items && from % tiles >= live_tiles) from += gridDim.x;
      return from;
    };
    RingT<FSTAGES> ring;
    int m = 0;
    int u = 0;                                   // dS tiles stored so far
    if (c == CONSUMERS - 1 && next_live(blockIdx.x) < n_items) bar_arrive(1);
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int kt = item % tiles, h = (item / tiles) % heads,
                b = item / (tiles * heads);
      const long long bh = (long long)b * heads + h;
      const int krow = kt * ITEM + SUB * c + 16 * w + g;
      const long long off = (long long)b * T * st + h * D;
      float dk_acc[32], dv_acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      if (kt >= live_tiles) {
        store_rows(dk + off, st, krow, T, tq, dk_acc, 1.f);
        store_rows(dv + off, st, krow, T, tq, dv_acc, 1.f);
        continue;
      }
      const int bi = m & 1;
      const uint32_t kv_base = smem_u32(sItem + bi * KV_BUF);
      const uint32_t k_addr = kv_base + c * SUB_BYTES;
      const uint32_t v_addr = k_addr + ITEM_BYTES;
      const bool live[2] = {krow < t_real, krow + 8 < t_real};
      const bool key_edge = (kt + 1) * ITEM > t_real;
      const bool hand_last = !(c == CONSUMERS - 1 &&
                               next_live(item + (int)gridDim.x) >= n_items);
      mbar_wait(&bar->item_full[bi], (m >> 1) & 1);

      // dQ partial of query tile j (dS tile number uj) over the item's 128
      // keys: this consumer's 64 queries, both consumers' dS^T
      auto dq_tile = [&](int j, int uj) {
        const int db = uj & 1;
        mbar_wait(&bar->ds_full[db], (uj >> 1) & 1);
        float dqp[32];
        const uint32_t a_base = smem_u32(sDS + db * DS_BYTES) + c * (DS_BYTES / 2);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < ITEM / 16; ++ks)
          wgmma_tt64(dqp, desc_sw128(a_base + ks * 16 * ROW_BYTES),
                     desc_sw128(kv_base + ks * 16 * ROW_BYTES), ks > 0);
        wg_commit();
        wg_wait<0>();
        fence_regs(dqp);
        __syncwarp();
        if (lane == 0) mbar_arrive(&bar->ds_empty[db]);
        float* rowp = dq_acc + (bh * Tp + j * ITEM + SUB * c + 16 * w + g) * D;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int n8 = 0; n8 < D / 8; ++n8) {
            float* p = rowp + r * 8 * D + n8 * 8 + 2 * tq;
            atomicAdd(p, dqp[4 * n8 + 2 * r]);
            atomicAdd(p + 1, dqp[4 * n8 + 2 * r + 1]);
          }
      };

      uint32_t pa[8][4], sa[8][4];
      int sp = 0;
      for (int i = 0; i < n_qt; ++i) {
        float st_acc[64], dpt[64];
        mbar_wait(&bar->full[ring.s], ring.ph);
        bar_sync(1 + c);
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        wg_fence();
        if (i > 0) {
          rs_tile(dv_acc, pa, do_base + sp * ITEM_BYTES);
          rs_tile(dk_acc, sa, q_base + sp * ITEM_BYTES);
          wg_commit();
          wg_wait<0>();
          fence_regs(dk_acc);
          fence_regs(dv_acc);
          __syncwarp();
          if (lane == 0) mbar_arrive(&bar->empty[sp]);
        }
        ss_tile(st_acc, k_addr, q_base + ring.s * ITEM_BYTES);
        ss_tile(dpt, v_addr, do_base + ring.s * ITEM_BYTES);
        wg_commit();
        bar_arrive(1 + (c + 1) % CONSUMERS);
        wg_wait<0>();
        fence_regs(st_acc);
        fence_regs(dpt);
        const float2* ldt = sLD + ring.s * ITEM;
        const int q_valid = T - i * ITEM;
        if (key_edge || q_valid < ITEM)
          p_ds_cols<true>(pa, sa, st_acc, dpt, ldt, scale_log2, live, q_valid, tq);
        else
          p_ds_cols<false>(pa, sa, st_acc, dpt, ldt, scale_log2, live, q_valid, tq);
        // dS^T of this tile into shared memory, [query half][key][64 queries]
        {
          const int db = u & 1;
          mbar_wait(&bar->ds_empty[db], ((u >> 1) & 1) ^ 1);
          uint8_t* dsb = sDS + db * DS_BYTES;
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = 16 * kk + 8 * (e >> 1) + 2 * tq;
              const int kr = SUB * c + 16 * w + g + 8 * (e & 1);
              *reinterpret_cast<uint32_t*>(
                  dsb + (q >> 6) * (DS_BYTES / 2) + kr * ROW_BYTES +
                  ((((q & 63) >> 3) ^ (kr & 7)) << 4) + ((q & 7) << 1)) = sa[kk][e];
            }
          fence_async_smem();
          __syncwarp();
          if (lane == 0) mbar_arrive(&bar->ds_full[db]);
          ++u;
        }
        // the previous tile's dQ: both consumers' dS^T of it are stored by now
        if (i > 0) dq_tile(i - 1, u - 2);
        sp = ring.s;
        ring.next();
      }
      bar_sync(1 + c);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      wg_fence();
      rs_tile(dv_acc, pa, do_base + sp * ITEM_BYTES);
      rs_tile(dk_acc, sa, q_base + sp * ITEM_BYTES);
      wg_commit();
      if (hand_last) bar_arrive(1 + (c + 1) % CONSUMERS);
      wg_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar->empty[sp]);
      dq_tile(n_qt - 1, u - 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar->item_empty[bi]);
      store_rows(dk + off, st, krow, T, tq, dk_acc, scale);
      store_rows(dv + off, st, krow, T, tq, dv_acc, 1.f);
      ++m;
    }
  }
}

// dq [B, T, H, 64] bf16 = dq_acc [B, H, Tp, 64] fp32 * scale, rows < T
__global__ void dq_convert_kernel(const float* __restrict__ acc,
                                  __nv_bfloat16* __restrict__ dq, int T,
                                  int heads, int Tp, long long n, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int chunk = i % 8;
  const long long row = i / 8;
  const long long bh = row / T;
  const int t = row % T;
  const long long b = bh / heads, h = bh % heads;
  const float4* s = reinterpret_cast<const float4*>(acc + (bh * Tp + t) * D + chunk * 8);
  const float4 x = s[0], y = s[1];
  uint4 o;
  o.x = pack_bf16(x.x * scale, x.y * scale);
  o.y = pack_bf16(x.z * scale, x.w * scale);
  o.z = pack_bf16(y.x * scale, y.y * scale);
  o.w = pack_bf16(y.z * scale, y.w * scale);
  *reinterpret_cast<uint4*>(dq + ((b * T + t) * heads + h) * D + chunk * 8) = o;
}

// ---- host side --------------------------------------------------------------
// dims (64, T, H, B); byte strides of T, H and B; boxes of 64 x 64 rows.
int make_map(CUtensorMap* map, const void* ptr, int T, int H, int B,
             const long long* strides) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {D, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t st[3] = {(cuuint64_t)strides[0], (cuuint64_t)strides[1],
                            (cuuint64_t)strides[2]};
  const cuuint32_t box[4] = {D, SUB, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      st, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dw_encoder_attention_bwd_fused(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ld, void* dq_acc, void* dq,
    void* dk, void* dv, int batch, int heads, int T, int t_real, int grid,
    float scale_log2, float scale, const long long* strides, void* stream) {
  const int tiles = (T + ITEM - 1) / ITEM;
  const int n_items = tiles * heads * batch;
  if (t_real < 1 || t_real > T || grid < 1 || grid > n_items) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap qmap, kmap, vmap, omap, domap;
  int err = make_map(&qmap, q, T, heads, batch, strides);
  if (!err) err = make_map(&kmap, k, T, heads, batch, strides + 3);
  if (!err) err = make_map(&vmap, v, T, heads, batch, strides + 6);
  if (!err) err = make_map(&omap, o, T, heads, batch, strides + 9);
  if (!err) err = make_map(&domap, dout, T, heads, batch, strides + 12);
  if (!err) err = (int)cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (!err) err = (int)cudaFuncSetAttribute(fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FU_SMEM);
  if (!err) err = (int)cudaMemsetAsync(dq_acc, 0, (size_t)batch * heads * tiles * ITEM * D * 4, st);
  if (err) return err;
  dq_kernel<<<grid, THREADS, DQ_SMEM, st>>>(
      qmap, kmap, vmap, omap, domap, (const float*)lse, (float2*)ld,
      nullptr, T, t_real, heads, tiles, n_items, scale_log2, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  fused_kernel<<<grid, THREADS, FU_SMEM, st>>>(
      qmap, kmap, vmap, domap, (const float2*)ld, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, (float*)dq_acc, T, t_real, heads, tiles, n_items, scale_log2, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long n = (long long)batch * heads * T * 8;
  dq_convert_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const float*)dq_acc, (__nv_bfloat16*)dq, T, heads, tiles * ITEM, n, scale);
  return (int)cudaGetLastError();
}
