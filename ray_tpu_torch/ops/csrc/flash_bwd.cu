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
// zero, and the mask constant -1e30. p and ds are rounded to bf16 before
// their products, as the TPU kernels round them; statistics stay in f32.
//
// What bounds them on an H100: at the training shape of bench_350m (B=8,
// S=1024, H=16, D=64, causal) K2 does 3 products and K3 4, about 26 and 34
// GFLOP, against about 34 MB of q/k/v/do/lse/delta read and 8-16 MB
// written: both are bound by tensor-core operations. What the design does:
//   - the Pallas grid's sequential "arbitrary" axis becomes a loop inside a
//     block: K2 takes one block per (q tile, head, batch) and loops over KV
//     tiles with dq in f32 registers; K3 takes one block per (kv tile, kv
//     head, batch) and loops over the GQA group's query heads and the q
//     tiles, with dk and dv in f32 registers, and writes them once at KVH
//     heads. So the per-query-head dk/dv buffers and the segment sum of the
//     TPU version are gone, and no atomics are used: the results do not
//     depend on block order;
//   - every product runs on the tensor cores through mma.sync m16n8k16
//     (bf16 operands, f32 accumulation); the score accumulators are
//     re-packed in registers as the A operand of the next product, so the
//     S x S tiles never reach shared or device memory;
//   - the operand each block keeps (q and do for K2, k and v for K3) sits in
//     registers as mma fragments; the streamed tiles are staged in padded
//     shared memory, whose transposed reads are free of bank conflicts;
//   - causal tiles that the mask empties are never loaded.
// Not yet done (a later change): cp.async/TMA double buffering, wgmma,
// ldmatrix. Both kernels read the [B, S, H, D] model layout by strides, so
// q/k/v views of the fused projection go in without a copy.
//
// Each entry point launches on the caller's stream, allocates nothing, and
// returns the cudaError_t of the launch (0 when it was accepted).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per tile
constexpr int kBlockK = 64;   // keys per tile
constexpr int kWarps = 4;     // each warp owns 16 rows (K2) or 16 keys (K3)
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;       // bf16 elements of padding per smem row
constexpr float kNegInf = -1e30f;  // the TPU kernels' mask constant

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // [B, H, S]
  const float* delta;  // [B, H, S]
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int S, H, KVH;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
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

// Two bf16 from two places (two rows of a tile) -> one register.
__device__ __forceinline__ uint32_t pack_raw(const __nv_bfloat16* lo,
                                             const __nv_bfloat16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi))
          << 16);
}

// Two neighbouring bf16 of row `row` (zero past the sequence end).
__device__ __forceinline__ uint32_t load_row2(const __nv_bfloat16* base,
                                              long long ss, int row, int col,
                                              int S) {
  if (row >= S) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * ss + col);
}

// The A-operand fragments of 16 rows (r_lo = row0 + g, r_hi = r_lo + 8)
// over all of D, read once from device memory.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (*f)[4],
                                             const __nv_bfloat16* base,
                                             long long ss, int r_lo, int t,
                                             int S) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    f[kc][0] = load_row2(base, ss, r_lo, c, S);
    f[kc][1] = load_row2(base, ss, r_lo + 8, c, S);
    f[kc][2] = load_row2(base, ss, r_lo, c + 8, S);
    f[kc][3] = load_row2(base, ss, r_lo + 8, c + 8, S);
  }
}

// A [64, D] tile of rows row0.. into padded shared memory, zero past S.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[D + kPad],
                                          const __nv_bfloat16* src,
                                          long long ss, int row0, int S) {
  constexpr int kVec = 8;  // bf16 per 16-byte load
  for (int idx = threadIdx.x; idx < 64 * (D / kVec); idx += kThreads) {
    const int r = idx / (D / kVec);
    const int c = (idx % (D / kVec)) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + c);
    }
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

// Accumulator rows -> bf16 output row (two columns per register pair).
template <int D>
__device__ __forceinline__ void store_row(__nv_bfloat16* row,
                                          const float (*acc)[4], int i,
                                          int t) {
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(row + dt * 8 + 2 * t) =
        pack_bf16x2(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
}

// K2: dq for one (q tile, head, batch); loops over the KV tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kKC = D / 16;
  constexpr int kDT = D / 8;

  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockK][D + kPad];

  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);   // GQA: query head h reads h // group
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int S = p.S;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  const int r_lo = iq * kBlockQ + warp * 16 + g;
  const int r_hi = r_lo + 8;

  uint32_t qf[kKC][4];
  uint32_t df[kKC][4];
  load_a_frags<D>(qf, qb, p.q_ss, r_lo, t, S);
  load_a_frags<D>(df, dob, p.do_ss, r_lo, t, S);

  const long long stat = ((long long)b * p.H + h) * S;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? r_hi : r_lo;
    lse_r[i] = r < S ? p.lse[stat + r] : 0.f;
    dl_r[i] = r < S ? p.delta[stat + r] : 0.f;
  }

  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }

  const int nk_all = (S + kBlockK - 1) / kBlockK;
  const int nk = p.causal
      ? min(nk_all, (iq * kBlockQ + kBlockQ - 1) / kBlockK + 1)
      : nk_all;

  for (int ik = 0; ik < nk; ++ik) {
    const int kv0 = ik * kBlockK;
    __syncthreads();  // the previous tile is consumed by every warp
    load_tile<D>(k_s, kb, p.k_ss, kv0, S);
    load_tile<D>(v_s, vb, p.v_ss, kv0, S);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kBlockK / 16; ++j) {
      // s = q k^T and dp = do v^T for 16 rows x 16 keys, f32.
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int key = j * 16 + nt * 8 + g;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc) {
          uint32_t bk[2], bv[2];
          bk[0] = *reinterpret_cast<const uint32_t*>(&k_s[key][kc * 16 + 2 * t]);
          bk[1] = *reinterpret_cast<const uint32_t*>(&k_s[key][kc * 16 + 2 * t + 8]);
          bv[0] = *reinterpret_cast<const uint32_t*>(&v_s[key][kc * 16 + 2 * t]);
          bv[1] = *reinterpret_cast<const uint32_t*>(&v_s[key][kc * 16 + 2 * t + 8]);
          mma_bf16_16816(s[nt], qf[kc], bk);
          mma_bf16_16816(dp[nt], df[kc], bv);
        }
      }
      // ds = p * (dp - delta) * scale, with p recomputed from lse.
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int r = i ? r_hi : r_lo;
          const int c = kv0 + j * 16 + nt * 8 + 2 * t + (e & 1);
          const bool valid = c < S && (!p.causal || r >= c);
          const float x = valid ? s[nt][e] * p.scale : kNegInf;
          const float pe = expf(x - lse_r[i]);
          s[nt][e] = pe * (dp[nt][e] - dl_r[i]) * p.scale;
        }
      }
      // dq += ds k: ds is rounded to bf16 here, as on the TPU.
      uint32_t a[4];
      a[0] = pack_bf16x2(s[0][0], s[0][1]);
      a[1] = pack_bf16x2(s[0][2], s[0][3]);
      a[2] = pack_bf16x2(s[1][0], s[1][1]);
      a[3] = pack_bf16x2(s[1][2], s[1][3]);
      const int kr = j * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const int c = dt * 8 + g;
        uint32_t bf[2];
        bf[0] = pack_raw(&k_s[kr][c], &k_s[kr + 1][c]);
        bf[1] = pack_raw(&k_s[kr + 8][c], &k_s[kr + 9][c]);
        mma_bf16_16816(acc[dt], a, bf);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? r_hi : r_lo;
    if (r >= S) continue;
    store_row<D>(p.dq + b * p.dq_sb + r * p.dq_ss + h * p.dq_sh, acc, i, t);
  }
}

// K3: dk and dv for one (kv tile, kv head, batch); loops over the GQA
// group's query heads and their q tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const BwdParams p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kKC = D / 16;
  constexpr int kDT = D / 8;

  __shared__ __align__(16) __nv_bfloat16 q_s[kBlockQ][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 do_s[kBlockQ][D + kPad];
  __shared__ float lse_s[kBlockQ];
  __shared__ float dl_s[kBlockQ];

  const int ik = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.H / p.KVH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int S = p.S;

  const int k_lo = ik * kBlockK + warp * 16 + g;   // this thread's two keys
  const int k_hi = k_lo + 8;

  uint32_t kf[kKC][4];
  uint32_t vf[kKC][4];
  load_a_frags<D>(kf, p.k + b * p.k_sb + kvh * p.k_sh, p.k_ss, k_lo, t, S);
  load_a_frags<D>(vf, p.v + b * p.v_sb + kvh * p.v_sh, p.v_ss, k_lo, t, S);

  float dk[kDT][4], dv[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
  }

  const int nq = (S + kBlockQ - 1) / kBlockQ;
  // Causal: q tiles whose last row lies before the tile's first key are
  // skipped (kBlockQ == kBlockK, so that is every tile before this one).
  const int iq0 = p.causal ? ik : 0;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* dob = p.dout + b * p.do_sb + h * p.do_sh;
    const long long stat = ((long long)b * p.H + h) * S;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * kBlockQ;
      __syncthreads();  // the previous tile is consumed by every warp
      load_tile<D>(q_s, qb, p.q_ss, q0, S);
      load_tile<D>(do_s, dob, p.do_ss, q0, S);
      if (threadIdx.x < kBlockQ) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < S ? p.lse[stat + r] : 0.f;
        dl_s[threadIdx.x] = r < S ? p.delta[stat + r] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int j = 0; j < kBlockQ / 16; ++j) {
        // s^T = k q^T and dp^T = v do^T for 16 keys x 16 rows, f32.
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int qr = j * 16 + nt * 8 + g;
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
          for (int kc = 0; kc < kKC; ++kc) {
            uint32_t bq[2], bd[2];
            bq[0] = *reinterpret_cast<const uint32_t*>(&q_s[qr][kc * 16 + 2 * t]);
            bq[1] = *reinterpret_cast<const uint32_t*>(&q_s[qr][kc * 16 + 2 * t + 8]);
            bd[0] = *reinterpret_cast<const uint32_t*>(&do_s[qr][kc * 16 + 2 * t]);
            bd[1] = *reinterpret_cast<const uint32_t*>(&do_s[qr][kc * 16 + 2 * t + 8]);
            mma_bf16_16816(st[nt], kf[kc], bq);
            mma_bf16_16816(dpt[nt], vf[kc], bd);
          }
        }
        // p^T from lse (rows >= S always masked: they carry no statistics),
        // ds^T = p^T * (dp^T - delta^T) * scale.
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = (e >> 1) ? k_hi : k_lo;
            const int rl = j * 16 + nt * 8 + 2 * t + (e & 1);
            const int row = q0 + rl;
            const bool valid = row < S && (!p.causal || row >= key);
            const float pt = valid ? expf(st[nt][e] * p.scale - lse_s[rl])
                                   : 0.f;
            st[nt][e] = pt;
            dpt[nt][e] = pt * (dpt[nt][e] - dl_s[rl]) * p.scale;
          }
        }
        // dv += p^T do and dk += ds^T q: p and ds rounded to bf16 here.
        uint32_t ap[4], ad[4];
        ap[0] = pack_bf16x2(st[0][0], st[0][1]);
        ap[1] = pack_bf16x2(st[0][2], st[0][3]);
        ap[2] = pack_bf16x2(st[1][0], st[1][1]);
        ap[3] = pack_bf16x2(st[1][2], st[1][3]);
        ad[0] = pack_bf16x2(dpt[0][0], dpt[0][1]);
        ad[1] = pack_bf16x2(dpt[0][2], dpt[0][3]);
        ad[2] = pack_bf16x2(dpt[1][0], dpt[1][1]);
        ad[3] = pack_bf16x2(dpt[1][2], dpt[1][3]);
        const int qr = j * 16 + 2 * t;
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          const int c = dt * 8 + g;
          uint32_t bd[2], bq[2];
          bd[0] = pack_raw(&do_s[qr][c], &do_s[qr + 1][c]);
          bd[1] = pack_raw(&do_s[qr + 8][c], &do_s[qr + 9][c]);
          bq[0] = pack_raw(&q_s[qr][c], &q_s[qr + 1][c]);
          bq[1] = pack_raw(&q_s[qr + 8][c], &q_s[qr + 9][c]);
          mma_bf16_16816(dv[dt], ap, bd);
          mma_bf16_16816(dk[dt], ad, bq);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = i ? k_hi : k_lo;
    if (key >= S) continue;
    store_row<D>(p.dk + b * p.dk_sb + key * p.dk_ss + kvh * p.dk_sh, dk, i, t);
    store_row<D>(p.dv + b * p.dv_sb + key * p.dv_ss + kvh * p.dv_sh, dv, i, t);
  }
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, int B, cudaStream_t stream) {
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, p.H, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const BwdParams& p, int B, cudaStream_t stream) {
  const dim3 grid((p.S + kBlockK - 1) / kBlockK, p.KVH, B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

bool fill_common(BwdParams& p, const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 int B, int S, int H, int KVH,
                 const long long* q_st, const long long* k_st,
                 const long long* v_st, const long long* do_st,
                 float scale, int causal) {
  if (B <= 0 || S <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0) return false;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.S = S;
  p.H = H;
  p.KVH = KVH;
  p.q_sb = q_st[0]; p.q_ss = q_st[1]; p.q_sh = q_st[2];
  p.k_sb = k_st[0]; p.k_ss = k_st[1]; p.k_sh = k_st[2];
  p.v_sb = v_st[0]; p.v_ss = v_st[1]; p.v_sh = v_st[2];
  p.do_sb = do_st[0]; p.do_ss = do_st[1]; p.do_sh = do_st[2];
  p.dq_sb = p.dq_ss = p.dq_sh = 0;
  p.dk_sb = p.dk_ss = p.dk_sh = 0;
  p.dv_sb = p.dv_ss = p.dv_sh = 0;
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
  const long long q_st[3] = {q_sb, q_ss, q_sh};
  const long long k_st[3] = {k_sb, k_ss, k_sh};
  const long long v_st[3] = {v_sb, v_ss, v_sh};
  const long long do_st[3] = {do_sb, do_ss, do_sh};
  BwdParams p;
  if (!fill_common(p, q, k, v, dout, lse, delta, B, S, H, KVH, q_st, k_st,
                   v_st, do_st, scale, causal)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_dq<32>(p, B, st));
    case 64: return static_cast<int>(launch_dq<64>(p, B, st));
    case 128: return static_cast<int>(launch_dq<128>(p, B, st));
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
  const long long q_st[3] = {q_sb, q_ss, q_sh};
  const long long k_st[3] = {k_sb, k_ss, k_sh};
  const long long v_st[3] = {v_sb, v_ss, v_sh};
  const long long do_st[3] = {do_sb, do_ss, do_sh};
  BwdParams p;
  if (!fill_common(p, q, k, v, dout, lse, delta, B, S, H, KVH, q_st, k_st,
                   v_st, do_st, scale, causal)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return static_cast<int>(launch_dkv<32>(p, B, st));
    case 64: return static_cast<int>(launch_dkv<64>(p, B, st));
    case 128: return static_cast<int>(launch_dkv<128>(p, B, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
