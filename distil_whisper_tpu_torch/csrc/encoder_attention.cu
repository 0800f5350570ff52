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
// At head dim 64 every score also costs one ex2 on the special-function units
// (16 a clock an SM), which on its own takes about as long as the products:
// a kernel that runs softmax and products one after the other cannot get
// under twice the tensor-core floor.
//
// Design, the usual Hopper attention forward:
// - A persistent grid, one block of four warpgroups an SM, walks over
//   (192 queries, head, batch row) tiles, query tiles fastest so that the
//   blocks in flight share heads in L2.  Warpgroup 0 is the producer: one
//   thread issues TMA loads of the tile's Q and of 128-key K and V tiles into
//   a ring of STAGES shared-memory stages, each guarded by a full and an empty
//   mbarrier; it runs ahead into the next tile while the consumers finish.
//   It gives up its registers (setmaxnreg) to three consumer warpgroups of
//   64 query rows each, so every K/V tile serves 192 queries.
// - Tensor maps are 4-D, (64, T, H, B) with the caller's byte strides, so the
//   kernel reads contiguous [B, H, T, 64] tensors and [B, H, T, 64] views of
//   [B, T, H*64] projections alike.  128-byte rows land in shared memory with
//   the 128-byte swizzle that wgmma reads; TMA zero-fills rows past T.
// - S = Q K^T is wgmma m64n128k16 with Q and K both K-major in shared memory.
//   P goes to shared memory as bf16 in the same swizzled K-major layout, and
//   O += P V is wgmma m64n64k16 with V transposed on the fly.  (P taken from
//   registers would need 32 more registers a thread than three consumers
//   have; with two consumers it measured no faster on the H100.)
// - Overlap for the ex2 floor: the consumers take turns at the tensor cores
//   (named barriers, round robin): while one runs its softmax, the others'
//   products run.  Within a consumer, key tile j's Q K^T is issued together
//   with tile j-1's P V, so the softmax of tile j runs beside P V.
// - Online softmax over key tiles (a running max and a running sum in fp32;
//   the output accumulator rescaled when the max grows): the same function
//   as the TPU kernel's whole-row softmax, with another rounding.  Held to the
//   plain version at atol/rtol 1e-2 in bf16 on the card.
// - Under training the epilogue also stores each row's log-sum-exp of the
//   scaled scores in base 2 (m * scale_log2 + log2 l, fp32 [B, H, T]), which
//   the backward (csrc/encoder_attention_bwd.cu) turns back into P without a
//   softmax of its own.  Inference passes no buffer and stores nothing; the
//   output's bits are the same either way.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int D = 64;                           // head dim (128-byte rows)
constexpr int CONSUMERS = 3;                    // consumer warpgroups
constexpr int BQ_WG = 64;                       // query rows per consumer
constexpr int BQ = BQ_WG * CONSUMERS;           // queries per block
constexpr int BK = 128;                         // keys per tile
constexpr int STAGES = 3;                       // K/V ring depth
constexpr int THREADS = 128 * (1 + CONSUMERS);  // producer + consumers
constexpr int PRODUCER_REGS = 24;               // setmaxnreg, of the SM's 64K:
constexpr int CONSUMER_REGS = 160;              // 128 x 24 + 384 x 160 <= 65536
constexpr int Q_BYTES = BQ * D * 2;
constexpr int TILE_BYTES = BK * D * 2;
constexpr int P_BYTES = BQ_WG * BK * 2;         // one consumer's bf16 P tile
constexpr int SMEM_BYTES =
    Q_BYTES + 2 * STAGES * TILE_BYTES + CONSUMERS * P_BYTES + 256 + 1024;

struct Barriers {
  uint64_t q_full, q_empty;
  uint64_t k_full[STAGES], v_full[STAGES];
  uint64_t k_empty[STAGES], v_empty[STAGES];
};

// ---- named barriers for the consumers' turns at the tensor cores ----------
// Consumer c waits on barrier 1 + c; the consumer before it in the round
// arrives there when it has issued its products.  Two warpgroups each.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

#define DW_F8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] (+)= A[64x16] * B[16x128]: S = Q K^T, A and B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
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

// d[32] += A[64x16] * B[16x64]: O += P V, P K-major in shared memory, V
// stored with N (head dim) contiguous and read through the transpose flag.
__device__ __forceinline__ void wgmma_pv(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}"
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : DW_F8(0), DW_F8(8), DW_F8(16), DW_F8(24)
      : "l"(da), "l"(db), "r"(1));
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

// Online softmax of one S tile (raw scores; the d^-1/2 scale goes into the
// exponent as scale_log2): keys >= t_real masked, the running max m and this
// thread's share of the row sum l updated, alpha = exp(m_old - m_new), and
// s overwritten with the fp32 probabilities.  Rows g and g+8 of the fragment;
// element i is row (i >> 1) & 1, key 8 (i / 4) + 2 tq + (i & 1).  Maxima and
// sums run as four interleaved chains a row, to shorten the dependences.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int t_real, int tq,
                                             float scale_log2) {
  if (k0 + BK > t_real) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (k0 + 8 * (i / 4) + 2 * tq + (i & 1) >= t_real) s[i] = -INFINITY;
  }
  float mx[2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)] = s[i];
#pragma unroll
  for (int i = 8; i < 64; ++i) {
    float& t = mx[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)];
    t = fmaxf(t, s[i]);
  }
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    x = fmaxf(x, m[r]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    alpha[r] = ex2((m[r] - x) * scale_log2);     // 0 on the first tile
    m[r] = x;
    neg[r] = -x * scale_log2;
  }
  float ps[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = ex2(fmaf(s[i], scale_log2, neg[(i >> 1) & 1]));
    s[i] = p;
    ps[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + ((ps[r][0] + ps[r][1]) + (ps[r][2] + ps[r][3]));
}

// The fp32 probabilities, cast to bf16, into this consumer's P buffer: the
// K-major, 128-byte-swizzled layout wgmma reads, as two 64-key halves of
// [64 rows][128 B].  Then make them visible to the async proxy and wait for
// the warpgroup's four warps.
__device__ __forceinline__ void store_p(uint8_t* sP, const float (&s)[64],
                                        int w, int g, int tq, int c) {
#pragma unroll
  for (int j8 = 0; j8 < 16; ++j8)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 16 * w + g + 8 * e;
      const int chunk = (j8 % 8) ^ (r % 8);
      *reinterpret_cast<uint32_t*>(sP + (j8 / 8) * 8192 + r * 128 + chunk * 16 + 4 * tq) =
          pack_bf16(s[4 * j8 + 2 * e], s[4 * j8 + 2 * e + 1]);
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + CONSUMERS + c) : "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
encoder_attention_kernel(__grid_constant__ const CUtensorMap qmap,
                         __grid_constant__ const CUtensorMap kmap,
                         __grid_constant__ const CUtensorMap vmap,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int T, int t_real,
                         int heads, int n_tiles, float scale_log2,
                         long long osb, long long osh, long long ost) {
  extern __shared__ uint8_t smem_raw[];
  // tiles 1024-aligned: the 128-byte swizzle pattern repeats every 1024 B
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + Q_BYTES;
  uint8_t* sV = sK + STAGES * TILE_BYTES;
  uint8_t* sP = sV + STAGES * TILE_BYTES;
  Barriers* bar = reinterpret_cast<Barriers*>(sP + CONSUMERS * P_BYTES);

  const int n_qt = (T + BQ - 1) / BQ;            // query tiles of a head
  const int n_kt = (t_real + BK - 1) / BK;       // key tiles with a live key
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&bar->q_full, 1);
    mbar_init(&bar->q_empty, 4 * CONSUMERS);      // one arrive per warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bar->k_full[s], 1);
      mbar_init(&bar->v_full[s], 1);
      mbar_init(&bar->k_empty[s], 4 * CONSUMERS);
      mbar_init(&bar->v_empty[s], 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Persistent: each block walks over (query tile, head, batch row) tiles,
  // query tile fastest, so that the blocks in flight share heads in L2.
  if (wg == 0) {
    // ===== producer: one thread keeps Q and the K/V ring full =====
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t ph = 0, qph = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int qt = tile % n_qt, h = (tile / n_qt) % heads, b = tile / (n_qt * heads);
        mbar_wait(&bar->q_empty, qph ^ 1);     // the last tile's Q K^T is done
        qph ^= 1;
        mbar_expect_tx(&bar->q_full, Q_BYTES);
        tma_load_4d(sQ, &qmap, &bar->q_full, 0, qt * BQ, h, b);
        for (int j = 0; j < n_kt; ++j) {
          mbar_wait(&bar->k_empty[s], ph ^ 1);
          mbar_expect_tx(&bar->k_full[s], TILE_BYTES);
          tma_load_4d(sK + s * TILE_BYTES, &kmap, &bar->k_full[s], 0, j * BK, h, b);
          mbar_wait(&bar->v_empty[s], ph ^ 1);
          mbar_expect_tx(&bar->v_full[s], TILE_BYTES);
          tma_load_4d(sV + s * TILE_BYTES, &vmap, &bar->v_full[s], 0, j * BK, h, b);
          if (++s == STAGES) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {
    // ===== consumers: 64 query rows each =====
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int w = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;       // fragment row group / pair
    const uint32_t q_addr = smem_u32(sQ) + c * (BQ_WG * D * 2);
    const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);
    uint8_t* my_p = sP + c * P_BYTES;
    const uint32_t p_addr = smem_u32(my_p);

    int s = 0;                             // ring stage and phase of key tile j
    uint32_t ph = 0, qph = 0;
    if (c == CONSUMERS - 1) bar_arrive(1);  // consumer 0 takes the first turn
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int qt = tile % n_qt, h = (tile / n_qt) % heads, b = tile / (n_qt * heads);
      // the last consumer's last turn of the block hands over to no one
      const bool hand_last = !(c == CONSUMERS - 1 && tile + (int)gridDim.x >= n_tiles);
      float o_acc[32];   // O: n-block j8 -> rows g, g+8; dims 8*j8+2tq+{0,1}
#pragma unroll
      for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};   // running max of raw scores
      float l[2] = {0.f, 0.f};               // this thread's share of the row sum
      float alpha[2];
      mbar_wait(&bar->q_full, qph);
      qph ^= 1;

      // key tile 0: S = Q K^T alone
      {
        float s_acc[64];
        mbar_wait(&bar->k_full[s], ph);
        bar_sync(1 + c);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_qk(s_acc, desc_sw128(q_addr + ks * 32),
                   desc_sw128(k_addr + s * TILE_BYTES + ks * 32), ks > 0);
        wg_commit();
        if (hand_last || n_kt > 1) bar_arrive(1 + (c + 1) % CONSUMERS);
        wg_wait<0>();
        fence_regs(s_acc);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&bar->k_empty[s]);
          if (n_kt == 1) mbar_arrive(&bar->q_empty);
        }
        softmax_tile(s_acc, m, l, alpha, 0, t_real, tq, scale_log2);
        store_p(my_p, s_acc, w, g, tq, c);
      }
      int sp = s;                          // stage and phase of key tile j-1
      uint32_t php = ph;
      if (++s == STAGES) { s = 0; ph ^= 1; }

      for (int j = 1; j < n_kt; ++j) {
        float s_acc[64];                   // fresh: no value flows into the wgmma
        mbar_wait(&bar->k_full[s], ph);
        mbar_wait(&bar->v_full[sp], php);
        bar_sync(1 + c);                   // my turn at the tensor cores
        fence_regs(o_acc);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_qk(s_acc, desc_sw128(q_addr + ks * 32),
                   desc_sw128(k_addr + s * TILE_BYTES + ks * 32), ks > 0);
        wg_commit();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_pv(o_acc, desc_sw128(p_addr + (kk / 4) * 8192 + (kk % 4) * 32),
                   desc_sw128(v_addr + sp * TILE_BYTES + kk * 16 * D * 2));
        wg_commit();
        if (hand_last || j < n_kt - 1)
          bar_arrive(1 + (c + 1) % CONSUMERS);   // hand the turn over
        wg_wait<1>();                      // S of key tile j is ready
        fence_regs(s_acc);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&bar->k_empty[s]);
          if (j == n_kt - 1) mbar_arrive(&bar->q_empty);
        }
        softmax_tile(s_acc, m, l, alpha, j * BK, t_real, tq, scale_log2);
        wg_wait<0>();                      // P V of key tile j-1 is done
        fence_regs(o_acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&bar->v_empty[sp]);
#pragma unroll
        for (int i = 0; i < 32; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
        store_p(my_p, s_acc, w, g, tq, c);
        sp = s;
        php = ph;
        if (++s == STAGES) { s = 0; ph ^= 1; }
      }

      // P V of the last key tile
      mbar_wait(&bar->v_full[sp], php);
      fence_regs(o_acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv(o_acc, desc_sw128(p_addr + (kk / 4) * 8192 + (kk % 4) * 32),
                 desc_sw128(v_addr + sp * TILE_BYTES + kk * 16 * D * 2));
      wg_commit();
      wg_wait<0>();
      fence_regs(o_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar->v_empty[sp]);

      // out = pv / l (the row sum reduced over the quad); rows >= T not stored
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      if (lse != nullptr && tq == 0) {
        // the row's log-sum-exp in base 2 (m is the quad's common max)
        float* lrow = lse + ((long long)b * heads + h) * T;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = qt * BQ + c * BQ_WG + w * 16 + g + 8 * r;
          if (row < T) lrow[row] = fmaf(m[r], scale_log2, log2f(l[r]));
        }
      }
      __nv_bfloat16* oh = o + b * osb + h * osh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qt * BQ + c * BQ_WG + w * 16 + g + 8 * r;
        if (row >= T) continue;
        __nv_bfloat16* orow = oh + (long long)row * ost;
#pragma unroll
        for (int n8 = 0; n8 < D / 8; ++n8)
          *reinterpret_cast<uint32_t*>(orow + n8 * 8 + 2 * tq) =
              pack_bf16(o_acc[4 * n8 + 2 * r] / l[r], o_acc[4 * n8 + 2 * r + 1] / l[r]);
      }
    }
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

// Byte strides come in (T, H, B) order for each of q, k, v and o, as the
// wrapper's _tma_geometry gives them.  lse: null, or fp32 [B, H, T]
// contiguous.
extern "C" int dw_encoder_attention(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int heads,
    int T, int t_real, float scale_log2,
    long long q_st, long long q_sh, long long q_sb,
    long long k_st, long long k_sh, long long k_sb,
    long long v_st, long long v_sh, long long v_sb,
    long long o_st, long long o_sh, long long o_sb, void* stream) {
  if (t_real < 1 || t_real > T) return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  int err = make_map(&qmap, q, T, heads, batch, q_st, q_sh, q_sb, BQ);
  if (!err) err = make_map(&kmap, k, T, heads, batch, k_st, k_sh, k_sb, BK);
  if (!err) err = make_map(&vmap, v, T, heads, batch, v_st, v_sh, v_sb, BK);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(encoder_attention_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM_BYTES);
  int device = 0, n_sm = 0;
  if (!err) err = (int)cudaGetDevice(&device);
  if (!err) err = (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err) return err;
  const int n_tiles = (T + BQ - 1) / BQ * heads * batch;
  encoder_attention_kernel<<<n_tiles < n_sm ? n_tiles : n_sm, THREADS, SMEM_BYTES,
                             (cudaStream_t)stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)o, (float*)lse, T, t_real, heads, n_tiles,
      scale_log2, o_sb / 2, o_sh / 2, o_st / 2);
  return (int)cudaGetLastError();
}
