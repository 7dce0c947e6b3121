// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax state.
//
// Replaces ray_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _flash_fwd). Same function: o = softmax(scale * q k^T + mask) v with a
// causal mask and a tail mask for keys >= S at -1e30, key rows past S read
// as zero, p rounded to bf16 before p v, lse = m + log(l), and the l == 0
// guard that leaves a row with no valid key at o = 0 instead of NaN.
//
// What bounds it on an H100: at the prefill shapes of Llama-3-8B (H=32,
// KVH=8, D=128) one causal launch at S=2048 does about 4*H*D*S^2/2 = 34
// GFLOP against about 42 MB of q/k/v/o, so it is bound by tensor-core
// operations (0.035 ms at 989 TFLOP/s); at the training shape (B=8,
// S=1024, H=16, D=64) the bound is 0.020 ms of bytes; buckets of S <= 256
// are bound by bytes and launch time. Only wgmma reaches the dense rate.
//
// Design (one block per 128 query rows of one (head, batch)):
//   - warp specialised: warpgroup 0 is the producer (one thread issues
//     every copy, setmaxnreg down to 24 registers); warpgroups 1 and 2 are
//     consumers, 64 query rows each (setmaxnreg up to 240);
//   - every load is TMA: one 4-D tensor map (D, heads, S, B) each for q, k
//     and v, built from the caller's strides, so strided views of a fused
//     projection go in without a copy and rows past S are zero-filled by
//     the hardware inside each batch. Tiles are 128-byte swizzled (64
//     columns a box; D=128 is two boxes) or 64-byte swizzled for D=32;
//   - q is loaded once; K and V tiles of 128 keys stream through a ring of
//     stages (2 at D=128, 3 below) with a full and an empty mbarrier each;
//     a consumer warp frees a stage once its p v product has completed;
//   - s = q k^T is wgmma m64n128k16 with both operands in shared memory,
//     K-major; the online softmax runs in f32 registers (exp2 with log2(e)
//     folded into the scale; row max and sum over the 4 threads of a quad);
//     p is rounded to bf16 and packed in registers as the A operand of
//     o += p v, wgmma m64nDk16 with v read MN-major through the
//     descriptor's transpose bit: v is never transposed by threads;
//   - causal blocks launch heaviest first (q tiles in reverse), tiles past
//     the diagonal are never loaded, and only the diagonal and tail tiles
//     evaluate the mask;
//   - o = acc / l with the guard is stored as bf16 from registers to the
//     strided output; lse goes to [B, H, S].
// Registers (nvcc -Xptxas -v): 168 a thread at every D, no spill.
// Measured on an NVIDIA H100 80GB HBM3 at its 700 W power limit
// (chip_smoke.py, kernel_time, device time, causal): 0.090 ms at B=1,
// S=2048, H=32, KVH=8, D=128 (382 TFLOP/s, 39% of the 0.035 ms bound;
// the warp-level MMA kernel before it took 0.619 ms, cuDNN's SDPA 0.079)
// and 0.080 ms at the training shape B=8, S=1024, H=16, D=64 (SDPA 0.057
// ms). Later work: ping-pong between the two consumers, the softmax
// overlapped with the next product, persistent blocks.
//
// Launches on the caller's stream, allocates nothing, and returns the
// cudaError_t of the launch (0 when it was accepted).

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 128;   // query rows per block: 2 consumers x 64
constexpr int kBlockN = 128;   // keys per K/V tile
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;

template <int D>
struct Cfg {
  // bf16 columns of one swizzled shared-memory row (one TMA box), its
  // bytes, and the boxes that make one row of a tile.
  static constexpr int kCols = D >= 64 ? 64 : 32;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kChunks = D / kCols;
  static constexpr int kChunkBytes = kBlockN * kRowBytes;
  static constexpr int kTileBytes = kBlockN * D * 2;  // a q, k or v tile
  static constexpr int kStages = D == 128 ? 2 : 3;
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte.
  static constexpr uint64_t kLayout = D >= 64 ? 1 : 2;
  static constexpr int kSmem =
      1024 + (1 + 2 * kStages) * kTileBytes + 8 * (2 * kStages + 1);
};

struct FwdParams {
  __nv_bfloat16* o;
  float* lse;  // [B, H, S]
  int S, H, KVH;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// ---------------------------------------------------------------- kernel

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const FwdParams p) {
  using C = Cfg<D>;
  static_assert(kBlockM == kBlockN, "the q tile reuses the k/v box");
  static_assert(D % 16 == 0 && D / 2 <= 64, "head_dim 32, 64 or 128");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // 128-byte swizzled tiles must start on a 1024-byte boundary.
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + C::kTileBytes;                 // kStages tiles
  const uint32_t v_s = k_s + C::kStages * C::kTileBytes;    // kStages tiles
  const uint32_t bars = v_s + C::kStages * C::kTileBytes;
  const uint32_t full = bars;                               // kStages
  const uint32_t empty = bars + 8 * C::kStages;             // kStages
  const uint32_t q_bar = bars + 16 * C::kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int m_block = gridDim.z - 1 - blockIdx.z;  // heaviest first
  const int m0 = m_block * kBlockM;
  const int S = p.S;
  const int n_all = (S + kBlockN - 1) / kBlockN;
  // Causal: tiles whose first key lies past the block's last row are
  // never loaded (kBlockM == kBlockN, so the last one is the diagonal).
  const int n_tiles = p.causal ? min(n_all, m_block + 1) : n_all;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
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
      mbar_expect_tx(q_bar, C::kTileBytes);
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load(q_s + c * C::kChunkBytes, &tq, c * C::kCols, h, m0, b,
                 q_bar);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % C::kStages;
        if (it >= C::kStages) {  // wait for both consumers to free it
          mbar_wait(empty + 8 * stage, ((it / C::kStages) - 1) & 1);
        }
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, 2 * C::kTileBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          const uint32_t off = stage * C::kTileBytes + c * C::kChunkBytes;
          tma_load(k_s + off, &tk, c * C::kCols, kvh, it * kBlockN, b, bar);
          tma_load(v_s + off, &tv, c * C::kCols, kvh, it * kBlockN, b, bar);
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
    constexpr uint32_t kSbo = 8 * C::kRowBytes;  // 8-row groups

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};  // row max, log2 units
    float l_run[2] = {0.f, 0.f};          // this thread's part of the sum

    mbar_wait(q_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % C::kStages;
      const int kv0 = it * kBlockN;
      mbar_wait(full + 8 * stage, (it / C::kStages) & 1);

      // s = q k^T, 64 rows x 128 keys in f32, one wgmma per 16 of D.
      float s[kBlockN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk * 16 / C::kCols) * C::kChunkBytes
                           + (kk * 16 % C::kCols) * 2;
        const uint64_t da = make_desc(q_s + cw * 64 * C::kRowBytes + off,
                                      16, kSbo, C::kLayout);
        const uint64_t db = make_desc(k_s + stage * C::kTileBytes + off,
                                      16, kSbo, C::kLayout);
        wgmma_ss_n128(s, da, db, kk);
      }
      wgmma_commit_and_wait();
      fence_regs(s);

      // Scale after the f32 dot (log2 units); the causal and tail masks
      // only on the tiles that reach past a row or past S.
      const bool mask = kv0 + kBlockN > S
          || (p.causal && kv0 + kBlockN - 1 > row_wg);
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        float x = s[i] * scale2;
        if (mask) {
          const int c = kv0 + (i / 4) * 8 + 2 * t + (i & 1);
          const int r = (i & 2) ? r_hi : r_lo;
          if (c >= S || (p.causal && c > r)) x = kNegInf;
        }
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      }
      const float alpha[2] = {exp2_approx(m_run[0] - mx[0]),
                              exp2_approx(m_run[1] - mx[1])};
      m_run[0] = mx[0];
      m_run[1] = mx[1];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        const float pe = exp2_approx(s[i] - mx[(i >> 1) & 1]);
        s[i] = pe;
        rs[(i >> 1) & 1] += pe;
      }
      l_run[0] = l_run[0] * alpha[0] + rs[0];
      l_run[1] = l_run[1] * alpha[1] + rs[1];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // o += p v: p rounded to bf16 here, as on the TPU, and packed as the
      // register A operand (the accumulator layout of two 8-key blocks is
      // the A fragment of one 16-key step).
      uint32_t pa[kBlockN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        pa[kk][0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
      }
      fence_regs(pa);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        // 16 keys a step; the two 64-column chunks of D=128 lie
        // kChunkBytes apart (the leading byte offset).
        const uint64_t db = make_desc(
            v_s + stage * C::kTileBytes + kk * 16 * C::kRowBytes,
            C::kChunkBytes, kSbo, C::kLayout);
        wgmma_rs<D>(o, pa[kk], db);
      }
      wgmma_commit_and_wait();
      fence_regs(o);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);  // the stage is free
    }

    // Epilogue: o = acc / l with the l == 0 guard, lse = m + log(l).
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    }
    __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i ? r_hi : r_lo;
      if (r >= S) continue;
      const float l_safe = (l_run[i] == 0.f) ? 1.f : l_run[i];
      const float inv = 1.f / l_safe;
      __nv_bfloat16* orow = ob + r * p.o_ss;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) = pack_bf16x2(
            o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
      if (t == 0) {
        p.lse[((long long)b * p.H + h) * S + r] =
            (m_run[i] + log2f(l_safe)) * kLn2;
      }
    }
  }
}

// ------------------------------------------------------------------ host

template <int D>
cudaError_t launch(const FwdParams& p, const void* q, const void* k,
                   const void* v, int B, const long long* st,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, q, B, p.S, p.H, st[0], st[1], st[2], kBlockN)
      || !make_map<D>(&tk, k, B, p.S, p.KVH, st[3], st[4], st[5], kBlockN)
      || !make_map<D>(&tv, v, B, p.S, p.KVH, st[6], st[7], st[8],
                      kBlockN)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = Cfg<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, B, (p.S + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rtpu_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int S, int H, int KVH, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0
      || B > 65535 || (S + kBlockM - 1) / kBlockM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.S = S;
  p.H = H;
  p.KVH = KVH;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale;
  p.causal = causal;
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32>(p, q, k, v, B, st, cs); break;
    case 64: err = launch<64>(p, q, k, v, B, st, cs); break;
    case 128: err = launch<128>(p, q, k, v, B, st, cs); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
