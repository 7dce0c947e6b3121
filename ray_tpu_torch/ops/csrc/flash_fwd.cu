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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;   // query rows per block: 2 consumers x 64
constexpr int kBlockN = 128;   // keys per K/V tile
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask constant
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Arrive once and expect `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register reads and writes across an
// asynchronous wgmma that uses these registers.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16)
       | (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32)
       | (layout << 62);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats -> one register of two bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B in shared memory,
// both K-major; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] B[16 x 128]: A in registers, B in shared
// memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A in registers, B in shared
// memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 32] += A[64 x 16] B[16 x 32]: A in registers, B in shared
// memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 128) {
    wgmma_rs_n128(d, a, b);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(d, a, b);
  } else {
    wgmma_rs_n32(d, a, b);
  }
}

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

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(f);
  }();
  return fn;
}

// A 4-D map (D, heads, S, B) over a [B, S, heads, D] bf16 tensor with
// element strides (sb, ss, sh, 1); one box is kCols x 1 head x 128 rows.
// Rows past S, inside the batch, are zero-filled.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              long long sb, long long ss, long long sh) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {Cfg<D>::kCols, 1, kBlockN, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const FwdParams& p, const void* q, const void* k,
                   const void* v, int B, const long long* st,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, q, B, p.S, p.H, st[0], st[1], st[2])
      || !make_map<D>(&tk, k, B, p.S, p.KVH, st[3], st[4], st[5])
      || !make_map<D>(&tv, v, B, p.S, p.KVH, st[6], st[7], st[8])) {
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
