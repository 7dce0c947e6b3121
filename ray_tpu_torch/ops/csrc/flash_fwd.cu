// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax state.
//
// Replaces ray_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _flash_fwd). Same function: o = softmax(scale * q k^T + mask) v with a
// causal mask and a tail mask for keys >= S, padded key rows read as zero,
// lse = m + log(l), and the l == 0 guard that leaves a row with no valid key
// at o = 0 instead of NaN.
//
// What bounds it on an H100: at the prefill shapes of Llama-3-8B (H=32,
// KVH=8, D=128) one causal launch at S=2048 does about 4*H*D*S^2/2 = 34
// GFLOP against about 42 MB of q/k/v/o, so it is bound by tensor-core
// operations; at small buckets (S <= 256) it is bound by bytes and launch
// time. What the design does about it:
//   - the Pallas grid's sequential "arbitrary" KV dimension and its VMEM
//     accumulators become a loop over KV tiles inside one thread block, one
//     block per (q tile, head, batch); running max, running sum and the
//     output accumulator stay in f32 registers, so the S x S scores never
//     reach device memory;
//   - both products run on the tensor cores through mma.sync m16n8k16 (bf16
//     operands, f32 accumulation); the score fragment of q k^T is re-packed
//     in registers as the A operand of p v, so p never goes to shared memory;
//   - K and V^T tiles are staged in padded shared memory (conflict-free
//     fragment reads); q fragments are read once from device memory;
//   - causal tiles above the diagonal are never loaded.
// Not yet done (a later change): TMA/cp.async double buffering, wgmma,
// warp specialisation. Measured at S=2048 (B=1, H=32, KVH=8, D=128,
// causal) on an H100 80GB HBM3 at its 700 W limit: 0.64 ms, 5.4% of the
// 0.035 ms bound (chip_smoke.py; PERF.md). The kernel reads the
// [B, S, H, D] model layout by strides, so the transposes of the TPU
// version are not needed.
//
// Launches on the caller's stream, allocates nothing, and returns the
// cudaError_t of the launch (0 when it was accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block: 4 warps x 16 rows
constexpr int kBlockK = 64;   // keys per KV tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 elements of padding per smem row
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask constant

struct FwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // [B, H, S]
  int S, H, KVH;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats -> one register of two bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Two neighbouring bf16 of row `row` of q (zero past the sequence end).
__device__ __forceinline__ uint32_t load_q2(const __nv_bfloat16* qb,
                                            long long q_ss, int row, int col,
                                            int S) {
  if (row >= S) return 0u;
  return *reinterpret_cast<const uint32_t*>(qb + row * q_ss + col);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FwdParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kKC = D / 16;        // k-chunks of q k^T
  constexpr int kNT = kBlockK / 8;   // 8-key n-tiles of the score tile
  constexpr int kDT = D / 8;         // 8-wide n-tiles of the output
  constexpr int kVec = 8;            // bf16 per 16-byte load

  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vt_s[D][kBlockK + kPad];

  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);   // GQA: query head h reads h // group
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row within the 8-row group
  const int t = lane & 3;    // fragment column pair
  const int S = p.S;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  const int row0 = iq * kBlockQ + warp * 16;
  const int r_lo = row0 + g;       // this thread's two rows
  const int r_hi = row0 + g + 8;

  uint32_t qf[kKC][4];
#pragma unroll
  for (int kc = 0; kc < kKC; ++kc) {
    const int c = kc * 16 + 2 * t;
    qf[kc][0] = load_q2(qb, p.q_ss, r_lo, c, S);
    qf[kc][1] = load_q2(qb, p.q_ss, r_hi, c, S);
    qf[kc][2] = load_q2(qb, p.q_ss, r_lo, c + 8, S);
    qf[kc][3] = load_q2(qb, p.q_ss, r_hi, c + 8, S);
  }

  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  const int nk_all = (S + kBlockK - 1) / kBlockK;
  // Causal: tiles whose first key lies past the block's last row are skipped.
  const int nk = p.causal
      ? min(nk_all, (iq * kBlockQ + kBlockQ - 1) / kBlockK + 1)
      : nk_all;

  for (int ik = 0; ik < nk; ++ik) {
    const int kv0 = ik * kBlockK;
    __syncthreads();  // the previous tile is consumed by every warp
    for (int idx = threadIdx.x; idx < kBlockK * (D / kVec); idx += kThreads) {
      const int r = idx / (D / kVec);
      const int c = (idx % (D / kVec)) * kVec;
      const int key = kv0 + r;
      uint4 kval = make_uint4(0u, 0u, 0u, 0u);
      uint4 vval = make_uint4(0u, 0u, 0u, 0u);
      if (key < S) {  // padded key rows are zero, never garbage
        kval = *reinterpret_cast<const uint4*>(kb + key * p.k_ss + c);
        vval = *reinterpret_cast<const uint4*>(vb + key * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(&k_s[r][c]) = kval;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vval);
#pragma unroll
      for (int j = 0; j < kVec; ++j) vt_s[c + j][r] = ve[j];
    }
    __syncthreads();

    // s = q k^T for this warp's 16 rows x 64 keys, f32.
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(
            &k_s[nt * 8 + g][kc * 16 + 2 * t]);
        bf[1] = *reinterpret_cast<const uint32_t*>(
            &k_s[nt * 8 + g][kc * 16 + 2 * t + 8]);
        mma_bf16_16816(s[nt], qf[kc], bf);
      }
    }

    // Scale after the f32 dot, then the causal and tail masks.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (e < 2) ? r_lo : r_hi;
        const int c = kv0 + nt * 8 + 2 * t + (e & 1);
        const bool valid = c < S && (!p.causal || r >= c);
        const float x = valid ? s[nt][e] * p.scale : kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha[2] = {expf(m_run[0] - mx[0]), expf(m_run[1] - mx[1])};
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[nt][e] - mx[e >> 1]);
        s[nt][e] = pe;
        rs[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_run[i] = l_run[i] * alpha[i] + rs[i];
      m_run[i] = mx[i];
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // acc += p v: p is rounded to bf16 here, as on the TPU.
#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16x2(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16x2(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16x2(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(
            &vt_s[dt * 8 + g][j * 16 + 2 * t]);
        bf[1] = *reinterpret_cast<const uint32_t*>(
            &vt_s[dt * 8 + g][j * 16 + 2 * t + 8]);
        mma_bf16_16816(acc[dt], a, bf);
      }
    }
  }

  // Epilogue: o = acc / l with the l == 0 guard, lse = m + log(l).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? r_hi : r_lo;
    if (r >= S) continue;
    const float l_safe = (l_run[i] == 0.f) ? 1.f : l_run[i];
    __nv_bfloat16* orow = p.o + b * p.o_sb + r * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16x2(acc[dt][2 * i] / l_safe, acc[dt][2 * i + 1] / l_safe);
    }
    if (t == 0) {
      p.lse[((long long)b * p.H + h) * S + r] = m_run[i] + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch(const FwdParams& p, int B, cudaStream_t stream) {
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, p.H, B);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(p);
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
  if (B <= 0 || S <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.S = S;
  p.H = H;
  p.KVH = KVH;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32>(p, B, st); break;
    case 64: err = launch<64>(p, B, st); break;
    case 128: err = launch<128>(p, B, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
