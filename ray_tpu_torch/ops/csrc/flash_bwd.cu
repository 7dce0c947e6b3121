// Flash-attention backward for Hopper (sm_90a): bf16 in, f32 accumulation.
//
// Replaces ray_tpu/ops/flash_attention.py:_dq_kernel (K2) and _dkv_kernel
// (K3), both launched by flash_bwd_core. Same functions, given the row
// statistics lse and delta from outside (ring attention passes global ones):
//   p   = exp(scale * q k^T + mask - lse)        recomputed, f32
//   ds  = p * (do v^T - delta) * scale           f32, rounded to bf16
//   dq  = ds k                                   (K2)
//   dv  = p^T do,  dk = ds^T q                   (K3, p rounded to bf16)
// with the causal mask, the tail mask for keys >= S, padded rows read as
// zero, and the mask constant -1e30 (a masked p is 0). p and ds are rounded
// to bf16 before their products, as the TPU kernels round them; statistics
// stay in f32. K3 sums dk and dv over each kv head's group of query heads
// (the TPU version's segment sum, flash_attention.py:349-353).
//
// What bounds them on an H100: at the training shape of bench_350m (B=8,
// S=1024, H=16, D=64, causal) K2 does 3 products and K3 4, about 26 and 34
// GFLOP, against about 34 MB of q/k/v/do/lse/delta read and 8-16 MB
// written; at Llama-3-8B's (B=1, S=2048, H=32, KVH=8, D=128) 52 and 69
// GFLOP against 42 MB: both are bound by tensor-core operations, which
// only wgmma reaches. Both kernels take K1's shape (flash_fwd.cu):
//   - 384 threads a block: warpgroup 0 is the producer (setmaxnreg 24; one
//     thread issues every TMA load), warpgroups 1 and 2 the consumers, 64
//     rows each (setmaxnreg 240);
//   - q/k/v/do come through 4-D tensor maps (D, heads, S, B) built from the
//     callers' strides, 64-row boxes, 128-byte swizzle (64-byte at D=32):
//     rows past S are zero-filled inside each batch and never read from a
//     longer view; the streamed tiles go through a ring of stages with a
//     full and an empty mbarrier each, so loads overlap the products;
//   - every product is wgmma: the two score products (q k^T and do v^T, or
//     k q^T and v do^T) with both operands in shared memory, K-major; the
//     gradient products with the bf16 scores as the register A operand and
//     the streamed tile read MN-major through the descriptor's transpose
//     bit, so no tile is ever transposed by threads;
//   - causal blocks are dispatched heaviest first; tiles that the mask
//     empties are never loaded, and a consumer skips the products of a
//     loaded tile that the mask empties for its 64 rows.
// K2: one block per 128 query rows of one (head, batch); q and do are
//   loaded once, K/V tiles stream (128 keys, 64 at D=128, where s, dp and
//   dq take 32 + 32 + 64 registers a thread); dq stays in f32 registers and
//   is written once.
// K3: one block per 128 keys of one QUERY head: the GQA group is spread
//   over the blocks of one thread-block cluster (group blocks, or the
//   largest divisor of the group up to 8, each then taking group / cluster
//   heads), so a long causal row of tiles is not walked once per head by
//   one block. k and v are loaded once; q/do tiles of 64 rows stream with
//   their lse/delta rows (a 1-D tensor map over [B, H, S], whose box must
//   start on 16 bytes: it starts up to 3 values early); dk and dv stay
//   in f32 registers. At the end each block puts them in its shared
//   memory, and each block of the cluster sums one share of the elements
//   over the cluster's blocks through distributed shared memory, in rank
//   order, and stores it as bf16: no atomics, no f32 buffer in device
//   memory, and a result that does not depend on block order.
// Both kernels read the [B, S, H, D] model layout by strides, so q/k/v
// views of the fused projection go in without a copy.
// Registers (nvcc -Xptxas -v): 168 a thread at every D, no spill.
// Measured on an NVIDIA H100 80GB HBM3 at its 700 W power limit
// (chip_smoke.py, kernel_time, device time, causal): at B=8, S=1024, H=16,
// D=64 K2 takes 0.087 ms and K3 0.144 ms (the warp-level MMA kernels
// before them 0.186 and 0.300); at B=1, S=2048, H=32, KVH=8, D=128 0.101
// and 0.171 ms (before: 0.363 and 0.905-0.933), together 0.269 ms against
// 0.282 for cuDNN's SDPA backward. Later work: the next tile's score
// products overlapped with this tile's exponentials, dq fused into K3,
// persistent blocks.
//
// Each entry point launches on the caller's stream, allocates nothing, and
// returns the cudaError_t of the launch (0 when it was accepted).

#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 256;
constexpr int kBox = 64;        // rows of one TMA box
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kStages = 3;

struct BwdParams {
  const float* lse;    // [B, H, S] (K2 reads its rows directly)
  const float* delta;  // [B, H, S]
  __nv_bfloat16* out0;  // dq (K2) or dk (K3)
  __nv_bfloat16* out1;  // dv (K3)
  long long o0_sb, o0_ss, o0_sh;
  long long o1_sb, o1_ss, o1_sh;
  int S, H, KVH;
  int cluster;  // K3: blocks of one kv head's group (divides H / KVH)
  float scale;
  int causal;
};

// bf16 pairs of one accumulator (rows r_lo and r_lo + 8 of a warp's 16,
// D columns) into rows of a [.., D] bf16 output; rows >= S are skipped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           long long row_stride, int r_lo,
                                           int t, int S,
                                           const float (&acc)[D / 2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= S) continue;
    __nv_bfloat16* row = base + r * row_stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(row + j * 8 + 2 * t) =
          pack_bf16x2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------------ K2

template <int D>
struct DqCfg {
  static constexpr int kBlockM = 128;                  // query rows a block
  static constexpr int kBlockN = D == 128 ? 64 : 128;  // keys a K/V tile
  using Q = Tile<D, kBlockM>;
  using KV = Tile<D, kBlockN>;
  static constexpr int kSmem = 1024 + 2 * Q::kBytes
      + 2 * kStages * KV::kBytes + 8 * (2 * kStages + 1);
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const BwdParams p) {
  using C = DqCfg<D>;
  using QT = typename C::Q;
  using KT = typename C::KV;
  constexpr int kBlockM = C::kBlockM;
  constexpr int kBlockN = C::kBlockN;
  static_assert(D % 16 == 0 && D <= 128, "head_dim 32, 64 or 128");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + QT::kBytes;
  const uint32_t k_s = do_s + QT::kBytes;                 // kStages tiles
  const uint32_t v_s = k_s + kStages * KT::kBytes;        // kStages tiles
  const uint32_t bars = v_s + kStages * KT::kBytes;
  const uint32_t full = bars;                             // kStages
  const uint32_t empty = bars + 8 * kStages;              // kStages
  const uint32_t q_bar = bars + 16 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int m_block = gridDim.z - 1 - blockIdx.z;  // heaviest first
  const int m0 = m_block * kBlockM;
  const int S = p.S;
  const int n_all = (S + kBlockN - 1) / kBlockN;
  // Causal: K/V tiles whose first key lies past the block's last row are
  // never loaded.
  const int n_tiles = p.causal ? min(n_all, (m0 + kBlockM) / kBlockN) : n_all;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int kvh = h / (p.H / p.KVH);  // GQA: query head h reads h // group
      mbar_expect_tx(q_bar, 2 * QT::kBytes);
      for (int r = 0; r < kBlockM; r += kBox) {
        for (int c = 0; c < QT::kChunks; ++c) {
          const uint32_t off = c * QT::kChunkBytes + r * QT::kRowBytes;
          tma_load(q_s + off, &tq, c * QT::kCols, h, m0 + r, b, q_bar);
          tma_load(do_s + off, &tdo, c * QT::kCols, h, m0 + r, b, q_bar);
        }
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % kStages;
        if (it >= kStages) {  // wait for both consumers to free it
          mbar_wait(empty + 8 * stage, ((it / kStages) - 1) & 1);
        }
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, 2 * KT::kBytes);
        for (int r = 0; r < kBlockN; r += kBox) {
          for (int c = 0; c < KT::kChunks; ++c) {
            const uint32_t off = stage * KT::kBytes + c * KT::kChunkBytes
                               + r * KT::kRowBytes;
            const int row = it * kBlockN + r;
            tma_load(k_s + off, &tk, c * KT::kCols, kvh, row, b, bar);
            tma_load(v_s + off, &tv, c * KT::kCols, kvh, row, b, bar);
          }
        }
      }
    }
  } else {
    // ---------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup, 0 or 1
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane & 3;                // fragment column pair
    const int row_wg = m0 + cw * 64;       // this warpgroup's first row
    const int r_lo = row_wg + warp * 16 + (lane >> 2);  // this thread's rows
    const int r_hi = r_lo + 8;
    const float scale2 = p.scale * kLog2e;

    // lse (in log2 units) and delta of this thread's two rows, read once.
    const long long stat = ((long long)b * p.H + h) * S;
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? r_hi : r_lo;
      lse2[i] = r < S ? p.lse[stat + r] * kLog2e : 0.f;
      dl[i] = r < S ? p.delta[stat + r] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    mbar_wait(q_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % kStages;
      const int kv0 = it * kBlockN;
      const uint32_t k_t = k_s + stage * KT::kBytes;
      const uint32_t v_t = v_s + stage * KT::kBytes;
      mbar_wait(full + 8 * stage, (it / kStages) & 1);
      // Causal: a tile whose first key lies past this warpgroup's last row
      // is empty for it (the other warpgroup's rows reach it).
      if (!p.causal || kv0 <= row_wg + 63) {
        // s = q k^T and dp = do v^T, 64 rows x kBlockN keys in f32.
        float s[kBlockN / 2], dp[kBlockN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qo = cw * 64 * QT::kRowBytes + QT::col(kk * 16);
          const uint32_t ko = KT::col(kk * 16);
          wgmma_ss<kBlockN>(
              s, make_desc(q_s + qo, 16, QT::kSbo, QT::kLayout),
              make_desc(k_t + ko, 16, KT::kSbo, KT::kLayout), kk);
          wgmma_ss<kBlockN>(
              dp, make_desc(do_s + qo, 16, QT::kSbo, QT::kLayout),
              make_desc(v_t + ko, 16, KT::kSbo, KT::kLayout), kk);
        }
        wgmma_commit_and_wait();
        fence_regs(s);
        fence_regs(dp);

        // ds = p (dp - delta) scale, p = exp(scale s - lse) recomputed;
        // the causal and tail masks only on tiles that reach past a row or
        // past S.
        const bool mask = kv0 + kBlockN > S
            || (p.causal && kv0 + kBlockN - 1 > row_wg);
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          const int ri = (i >> 1) & 1;
          float pe = exp2_approx(fmaf(s[i], scale2, -lse2[ri]));
          if (mask) {
            const int c = kv0 + (i / 4) * 8 + 2 * t + (i & 1);
            const int r = ri ? r_hi : r_lo;
            if (c >= S || (p.causal && c > r)) pe = 0.f;
          }
          s[i] = pe * (dp[i] - dl[ri]) * p.scale;
        }
        // dq += ds k: ds rounded to bf16 here, as on the TPU; k read
        // MN-major (keys are the depth of this product).
        uint32_t da[kBlockN / 16][4];
        pack_a<kBlockN>(da, s);
        fence_regs(da);
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          wgmma_rs<D>(dq, da[kk],
                      make_desc(k_t + kk * 16 * KT::kRowBytes,
                                KT::kChunkBytes, KT::kSbo, KT::kLayout));
        }
        wgmma_commit_and_wait();
        fence_regs(dq);
        fence_regs(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);  // the stage is free
    }
    store_rows<D>(p.out0 + b * p.o0_sb + h * p.o0_sh, p.o0_ss, r_lo, t, S,
                  dq);
  }
}

// ------------------------------------------------------------------ K3

template <int D>
struct DkvCfg {
  static constexpr int kBlockN = 128;  // keys a block: 2 consumers x 64
  static constexpr int kBlockM = 64;   // query rows a q/do tile
  using KV = Tile<D, kBlockN>;
  using Q = Tile<D, kBlockM>;
  // lse or delta of a tile's rows: a 1-D TMA box starts on 16 bytes, so
  // it reaches up to 3 values before the first row and 4 more after.
  static constexpr int kStatBox = kBlockM + 4;
  static constexpr int kStatBytes = 512;  // room for one box
  // q tile, do tile, lse, delta; a stage keeps 1024-byte alignment.
  static constexpr int kStageBytes = 2 * Q::kBytes + 2 * kStatBytes;
  static constexpr int kMain = 2 * KV::kBytes + kStages * kStageBytes;
  // dk and dv of the 256 consumer threads in f32, for the group sum.
  static constexpr int kRed = 2 * kConsumers * (D / 2) * 4;
  static constexpr int kBars = kMain > kRed ? kMain : kRed;
  static constexpr int kSmem = 1024 + kBars + 8 * (2 * kStages + 1);
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tlse,
                     const __grid_constant__ CUtensorMap tdelta,
                     const BwdParams p) {
  using C = DkvCfg<D>;
  using KT = typename C::KV;
  using QT = typename C::Q;
  constexpr int kBlockM = C::kBlockM;
  static_assert(D % 16 == 0 && D <= 128, "head_dim 32, 64 or 128");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + KT::kBytes;
  const uint32_t ring = v_s + KT::kBytes;  // kStages x (q, do, lse, delta)
  const uint32_t bars = base + C::kBars;
  const uint32_t full = bars;                             // kStages
  const uint32_t empty = bars + 8 * kStages;              // kStages
  const uint32_t kv_bar = bars + 16 * kStages;

  const int group = p.H / p.KVH;
  const int csize = p.cluster;
  const int rank = static_cast<int>(cluster_rank());
  const int kvh = blockIdx.x / csize;
  const int heads = group / csize;  // this block: kvh*group + rank + csize*j
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * C::kBlockN;  // heaviest (causal) first
  const int S = p.S;
  const int n_q = (S + kBlockM - 1) / kBlockM;
  // Causal: q tiles whose last row lies before the block's first key are
  // never loaded.
  const int iq0 = p.causal ? k0 / kBlockM : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_bar, 2 * KT::kBytes);
      for (int r = 0; r < C::kBlockN; r += kBox) {
        for (int c = 0; c < KT::kChunks; ++c) {
          const uint32_t off = c * KT::kChunkBytes + r * KT::kRowBytes;
          tma_load(k_s + off, &tk, c * KT::kCols, kvh, k0 + r, b, kv_bar);
          tma_load(v_s + off, &tv, c * KT::kCols, kvh, k0 + r, b, kv_bar);
        }
      }
      int it = 0;
      for (int j = 0; j < heads; ++j) {
        const int h = kvh * group + rank + csize * j;
        for (int iq = iq0; iq < n_q; ++iq, ++it) {
          const int stage = it % kStages;
          if (it >= kStages) {  // wait for both consumers to free it
            mbar_wait(empty + 8 * stage, ((it / kStages) - 1) & 1);
          }
          const uint32_t bar = full + 8 * stage;
          const uint32_t q_t = ring + stage * C::kStageBytes;
          const uint32_t do_t = q_t + QT::kBytes;
          mbar_expect_tx(bar, 2 * QT::kBytes + 2 * C::kStatBox * 4);
          for (int c = 0; c < QT::kChunks; ++c) {
            const uint32_t off = c * QT::kChunkBytes;
            tma_load(q_t + off, &tq, c * QT::kCols, h, iq * kBlockM, b, bar);
            tma_load(do_t + off, &tdo, c * QT::kCols, h, iq * kBlockM, b,
                     bar);
          }
          // The first row's statistics, rounded down to 16 bytes.
          const int stat = ((b * p.H + h) * S + iq * kBlockM) & ~3;
          tma_load_1d(do_t + QT::kBytes, &tlse, stat, bar);
          tma_load_1d(do_t + QT::kBytes + C::kStatBytes, &tdelta, stat, bar);
        }
      }
    }
    cluster_sync();  // the consumers' dk/dv are in shared memory
    cluster_sync();  // every block of the cluster has read them
  } else {
    // ---------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup, 0 or 1
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane & 3;                // fragment column pair
    const int kw = k0 + cw * 64;           // this warpgroup's first key
    const int key_lo = kw + warp * 16 + (lane >> 2);  // this thread's keys
    const int key_hi = key_lo + 8;
    const float scale2 = p.scale * kLog2e;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_bar, 0);
    int it = 0;
    for (int j = 0; j < heads; ++j) {
      const int h = kvh * group + rank + csize * j;
      for (int iq = iq0; iq < n_q; ++iq, ++it) {
        const int stage = it % kStages;
        const int q0 = iq * kBlockM;
        const uint32_t q_t = ring + stage * C::kStageBytes;
        const uint32_t do_t = q_t + QT::kBytes;
        mbar_wait(full + 8 * stage, (it / kStages) & 1);
        // Causal: a tile whose last row lies before this warpgroup's first
        // key is empty for it (the other warpgroup's keys reach it).
        if (!p.causal || q0 + kBlockM - 1 >= kw) {
          // s^T = k q^T and dp^T = v do^T, 64 keys x 64 rows in f32.
          float st[kBlockM / 2], dpt[kBlockM / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t ko = cw * 64 * KT::kRowBytes + KT::col(kk * 16);
            const uint32_t qo = QT::col(kk * 16);
            wgmma_ss<kBlockM>(
                st, make_desc(k_s + ko, 16, KT::kSbo, KT::kLayout),
                make_desc(q_t + qo, 16, QT::kSbo, QT::kLayout), kk);
            wgmma_ss<kBlockM>(
                dpt, make_desc(v_s + ko, 16, KT::kSbo, KT::kLayout),
                make_desc(do_t + qo, 16, QT::kSbo, QT::kLayout), kk);
          }
          wgmma_commit_and_wait();
          fence_regs(st);
          fence_regs(dpt);

          // p^T = exp(scale s^T - lse), ds^T = p^T (dp^T - delta) scale,
          // with lse and delta of the tile's rows (columns here) from the
          // stage; the masks only on the diagonal and tail tiles (rows >= S
          // carry no statistics: their p is 0).
          const int skew = ((b * p.H + h) * S + q0) & 3;  // box start
          const float* lse_t = reinterpret_cast<const float*>(
              smem + (do_t + QT::kBytes - base)) + skew;
          const float* dl_t = lse_t + C::kStatBytes / 4;
          const bool mask = q0 + kBlockM > S
              || (p.causal && q0 < kw + 63);
#pragma unroll
          for (int i = 0; i < kBlockM / 2; ++i) {
            const int cl = (i / 4) * 8 + 2 * t + (i & 1);  // the tile's row
            float pe = exp2_approx(fmaf(st[i], scale2, -lse_t[cl] * kLog2e));
            if (mask) {
              const int row = q0 + cl;
              const int key = (i & 2) ? key_hi : key_lo;
              if (row >= S || (p.causal && row < key)) pe = 0.f;
            }
            st[i] = pe;
            dpt[i] = pe * (dpt[i] - dl_t[cl]) * p.scale;
          }
          // dv += p^T do and dk += ds^T q: p and ds rounded to bf16 here;
          // do and q read MN-major (rows are the depth of these products).
          uint32_t pa[kBlockM / 16][4], da[kBlockM / 16][4];
          pack_a<kBlockM>(pa, st);
          pack_a<kBlockM>(da, dpt);
          fence_regs(pa);
          fence_regs(da);
          fence_regs(dv);
          fence_regs(dk);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBlockM / 16; ++kk) {
            const uint32_t ro = kk * 16 * QT::kRowBytes;
            wgmma_rs<D>(dv, pa[kk], make_desc(do_t + ro, QT::kChunkBytes,
                                              QT::kSbo, QT::kLayout));
            wgmma_rs<D>(dk, da[kk], make_desc(q_t + ro, QT::kChunkBytes,
                                              QT::kSbo, QT::kLayout));
          }
          wgmma_commit_and_wait();
          fence_regs(dv);
          fence_regs(dk);
          fence_regs(pa);
          fence_regs(da);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * stage);  // the stage is free
      }
    }

    // The group sum. Both consumer warpgroups are past their last product
    // before the tiles' shared memory takes dk and dv: each thread's
    // fragment as float4s, thread-minor (conflict-free).
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
    const int ctid = threadIdx.x - 128;
    float4* red = reinterpret_cast<float4*>(smem);
#pragma unroll
    for (int q = 0; q < D / 8; ++q) {
      red[q * kConsumers + ctid] = make_float4(
          dk[4 * q], dk[4 * q + 1], dk[4 * q + 2], dk[4 * q + 3]);
      red[(D / 8 + q) * kConsumers + ctid] = make_float4(
          dv[4 * q], dv[4 * q + 1], dv[4 * q + 2], dv[4 * q + 3]);
    }
    cluster_sync();
    // Each block sums every csize-th float4 over the cluster's blocks in
    // rank order and stores it: the float4 of 8-column block q holds
    // columns q*8 + 2t, +1 of rows key_lo and key_hi.
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
      if (q % csize != rank) continue;
      const uint32_t addr = base + (q * kConsumers + ctid) * 16;
      float4 acc = ld_cluster_f32x4(addr, 0);
      for (int r = 1; r < csize; ++r) {
        const float4 x = ld_cluster_f32x4(addr, r);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      const bool is_dv = q >= D / 8;
      __nv_bfloat16* out = is_dv
          ? p.out1 + b * p.o1_sb + kvh * p.o1_sh
          : p.out0 + b * p.o0_sb + kvh * p.o0_sh;
      const long long rs = is_dv ? p.o1_ss : p.o0_ss;
      const int col = (q % (D / 8)) * 8 + 2 * t;
      if (key_lo < S) {
        *reinterpret_cast<uint32_t*>(out + key_lo * rs + col) =
            pack_bf16x2(acc.x, acc.y);
      }
      if (key_hi < S) {
        *reinterpret_cast<uint32_t*>(out + key_hi * rs + col) =
            pack_bf16x2(acc.z, acc.w);
      }
    }
    cluster_sync();
  }
}

// ------------------------------------------------------------------ host

struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int D>
bool make_maps(Maps* m, const void* q, const void* k, const void* v,
               const void* dout, int B, const BwdParams& p,
               const long long* st) {
  return make_map<D>(&m->q, q, B, p.S, p.H, st[0], st[1], st[2], kBox)
      && make_map<D>(&m->k, k, B, p.S, p.KVH, st[3], st[4], st[5], kBox)
      && make_map<D>(&m->v, v, B, p.S, p.KVH, st[6], st[7], st[8], kBox)
      && make_map<D>(&m->dout, dout, B, p.S, p.H, st[9], st[10], st[11],
                     kBox);
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, const void* q, const void* k,
                      const void* v, const void* dout, int B,
                      const long long* st, cudaStream_t stream) {
  Maps m;
  if (!make_maps<D>(&m, q, k, v, dout, B, p, st)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = DqCfg<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, B, (p.S + DqCfg<D>::kBlockM - 1) / DqCfg<D>::kBlockM);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(m.q, m.k, m.v,
                                                           m.dout, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const BwdParams& p, const void* q, const void* k,
                       const void* v, const void* dout, int B,
                       const long long* st, cudaStream_t stream) {
  Maps m;
  CUtensorMap tlse, tdelta;
  const long long n_stat = static_cast<long long>(B) * p.H * p.S;
  if (!make_maps<D>(&m, q, k, v, dout, B, p, st)
      || !make_map_f32(&tlse, p.lse, n_stat, DkvCfg<D>::kStatBox)
      || !make_map_f32(&tdelta, p.delta, n_stat, DkvCfg<D>::kStatBox)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = DkvCfg<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.KVH * p.cluster, B,
                     (p.S + DkvCfg<D>::kBlockN - 1) / DkvCfg<D>::kBlockN);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_kernel<D>, m.q, m.k, m.v,
                           m.dout, tlse, tdelta, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool fill_common(BwdParams& p, const void* lse, const void* delta, int B,
                 int S, int H, int KVH, float scale, int causal) {
  if (B <= 0 || S <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0
      || B > 65535 || (S + 127) / 128 > 65535
      || static_cast<long long>(B) * H * S > 0x7fffffffLL) {
    return false;
  }
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = p.out1 = nullptr;
  p.o0_sb = p.o0_ss = p.o0_sh = 0;
  p.o1_sb = p.o1_ss = p.o1_sh = 0;
  p.S = S;
  p.H = H;
  p.KVH = KVH;
  // K3's cluster: the largest divisor of the group up to the portable size.
  const int group = H / KVH;
  p.cluster = 1;
  for (int c = kMaxCluster; c > 1; --c) {
    if (group % c == 0) {
      p.cluster = c;
      break;
    }
  }
  p.scale = scale;
  p.causal = causal;
  return true;
}

}  // namespace

extern "C" int rtpu_flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq,
    int B, int S, int H, int KVH, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    float scale, int causal, void* stream) {
  BwdParams p;
  if (!fill_common(p, lse, delta, B, S, H, KVH, scale, causal)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.out0 = static_cast<__nv_bfloat16*>(dq);
  p.o0_sb = dq_sb; p.o0_ss = dq_ss; p.o0_sh = dq_sh;
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return static_cast<int>(launch_dq<32>(p, q, k, v, dout, B, st, cs));
    case 64:
      return static_cast<int>(launch_dq<64>(p, q, k, v, dout, B, st, cs));
    case 128:
      return static_cast<int>(launch_dq<128>(p, q, k, v, dout, B, st, cs));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int rtpu_flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int B, int S, int H, int KVH, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, int causal, void* stream) {
  BwdParams p;
  if (!fill_common(p, lse, delta, B, S, H, KVH, scale, causal)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.out0 = static_cast<__nv_bfloat16*>(dk);
  p.out1 = static_cast<__nv_bfloat16*>(dv);
  p.o0_sb = dk_sb; p.o0_ss = dk_ss; p.o0_sh = dk_sh;
  p.o1_sb = dv_sb; p.o1_ss = dv_ss; p.o1_sh = dv_sh;
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return static_cast<int>(launch_dkv<32>(p, q, k, v, dout, B, st, cs));
    case 64:
      return static_cast<int>(launch_dkv<64>(p, q, k, v, dout, B, st, cs));
    case 128:
      return static_cast<int>(launch_dkv<128>(p, q, k, v, dout, B, st, cs));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
