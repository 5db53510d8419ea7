// Flash attention for training on Hopper (sm_90a): the forward kernel, the
// dQ kernel and the dK/dV kernel. Built with nvcc into a shared library with
// a plain C interface and bound with ctypes (determined_tpu_torch/ops/
// _build.py, ops/flash_attention.py).
//
// Replaces the three TPU kernels of determined_tpu/ops/flash_attention.py:
//   flash_fwd_wgmma_kernel, flash_fwd_kernel  <- `_fwd_kernel` (`_flash_fwd`)
//   flash_dq_wgmma_kernel, flash_dq_kernel    <- `_dq_kernel`  (`_flash_bwd`)
//   flash_dkv_wgmma_kernel, flash_dkv_kernel  <- `_dkv_kernel` (`_flash_bwd`)
// and computes the same functions:
//
//   q, k, v, dout  [B, S, H, D]  fp32 or bf16, any strides with the last
//                                dim contiguous (q, k and v are the
//                                per-head views of the fused qkv product)
//   o, dq, dk, dv  [B, S, H, D]  contiguous, in the inputs' dtype
//   lse, delta     [B*H, S]      fp32: lse = m + log(l) of the forward,
//                                delta = rowsum(dO * O) from the wrapper
//
// Precision, as in the TPU kernels. Q.K^T and dO.V^T take the inputs as
// they are and sum in fp32. m, l, acc and lse are fp32. P.V (forward), and
// dS.K, P^T.dO and dS^T.Q (backward) run in fp32 unless `round_bf16` is set
// (the `bf16=True` option): then the probabilities and dS are rounded to
// bf16 first, and in the backward so is the other operand (the forward
// rounds P to the value dtype, which is bf16 only for bf16 inputs).
//
// Two routes, picked by `run` from the dtype and head dim alone (nothing is
// tried and caught):
//
//   tensor cores (wgmma): bf16 inputs at D 64, all three kernels. GPT-2
//     small through XL all have D 64.
//   FFMA on CUDA cores: fp32 inputs at every D, bf16 at D 128 and 256.
//
// The fp32 products on tensor cores: the exact three-way bf16 split. A
// float x is x1 + x2 + x3 with x1 = bf16(x), x2 = bf16(x - x1), x3 =
// bf16(x - x1 - x2), exactly: 24 bits of significand fit in three 8-bit
// pieces, and bf16 has fp32's exponent range (the differences are exact in
// fp32 by Sterbenz's lemma). A product of two bf16 values is exact in fp32,
// so for a bf16 y, x.y = x1.y + x2.y + x3.y, and three bf16 tensor-core
// products with fp32 accumulation compute the fp32 product up to the order
// of its sums. Every product with P or dS in it has a bf16 partner on this
// route (V, dO or Q), so it runs `TERMS` = 3 passes, or 1 with
// `round_bf16` (x1 alone is the rounded operand). The FFMA route serves
// fp32 inputs: there no operand is bf16, and the fp32 checks need its
// exactness.
//
// What bounds them on the H100: operations. At GPT-2 small's shape (BH 96,
// S 1024, D 64, causal, bf16) a product of S^2*D/2 per head is 6.45
// GFLOP. Counting each product with P or dS as three bf16 products (the
// least exact route on this card), the forward does 1 + 3, dQ 2 + 3 and
// dK/dV 2 + 3 + 3 products: 0.0261 / 0.0326 / 0.0522 ms at 989 TFLOP/s,
// against 0.0151 / 0.0190 / 0.0228 ms for their bytes at 3.35 TB/s. On
// CUDA cores the fp32 products alone run at 67 TFLOP/s: the FFMA route
// cannot beat 0.096 ms (forward) or 0.193 ms (dK/dV) at this shape.
//
// What the tensor-core design does about it: one warpgroup (128 threads)
// per 64-row tile, every product on `wgmma.mma_async m64n64k16` (bf16 x
// bf16 -> fp32). Q.K^T (forward), K.Q^T and V.dO^T (dK/dV: the transposed
// scores, so the accumulator holds keys as rows) and Q.K^T with dO.V^T (dQ)
// read both operands from shared memory. The products with P or dS take the
// accumulator of the scores, split, as the A operand straight from
// registers (the RS form), and V, dO, Q or K (dQ: the same K tile as its
// scores) as B with the transpose bit set, because the reduction runs over
// their rows. Tiles come to shared memory by 16-byte cp.async in
// a ring of two stages (the next tile's copy overlaps this tile's
// products). Softmax, masks and dS stay in registers. The notes marked (1)
// to (7) below mark where the hard parts are dealt with:
//   (1) the accumulator-to-A-fragment mapping (`split_fragments`);
//   (2) wgmma.fence before a wgmma reads registers that other instructions
//       wrote, commit/wait before the accumulators are read (`wg_*`);
//   (3) the descriptors must name the 128-byte swizzle the cp.async writes
//       apply (`swizzled`, `smem_desc`);
//   (4) 16-byte alignment of every row the cp.async copies reads (checked
//       in `run` and in the wrapper);
//   (5) a ragged S: zero-filled loads, masked columns, skipped stores;
//   (6) register pressure in dK/dV (64 accumulators held across the q
//       loop, 64 of scores, the split fragments) and dQ (32 held, 64 of
//       scores): ptxas -v prints it;
//   (7) TMA and warp specialisation are not used: TMA needs
//       cuTensorMapEncodeTiled from the driver API, which this ctypes
//       build does not link. They are left to a later change.
//
// The FFMA design (PR 2's): every product is FFMA from fp32 tiles in
// shared memory; each thread of a 256-thread block holds a register tile
// and reads its operands as 8- or 16-byte vectors from transposed or padded
// tiles. A product of bf16 values is exact in fp32, so FFMA with fp32 sums
// computes exactly what a bf16 tensor-core product with fp32 accumulation
// computes.
//
// Both routes: the causal frontier is a loop bound (the forward and dQ
// stop at the diagonal tile, dK/dV starts at the first visible q tile), so
// masked tiles cost nothing, and the heavy tiles of a causal grid are
// scheduled first. Nothing crosses blocks: the loop over k tiles (forward,
// dQ) or q tiles (dK/dV) runs inside one block, as the TPU's sequential
// grid axis did, and the JAX two-kernel split keeps the backward free of
// atomics, so every gradient is the same from run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16 threads: ty = tid / 16, tx = tid % 16
constexpr float kNegInf = -1e30f;  // masked logit, as ops/_softmax_common.py
constexpr int kPad = 4;            // floats of padding per shared row

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float (&r)[N]);
template <>
__device__ __forceinline__ void lds<2>(const float* p, float (&r)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  r[0] = t.x; r[1] = t.y;
}
template <>
__device__ __forceinline__ void lds<4>(const float* p, float (&r)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
}

// Reduction over the 16 threads of one row (a half warp: tx = lane % 16).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Element strides of one [B, S, H, D] tensor; the last dim is contiguous.
struct Str {
  long long b, s, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out0;      // o (forward) or dq or dk
  void* out1;      // dv
  float* lse_out;  // forward only
  Str sq, sk, sv, sdo;
  int B, H, S;
  float scale;
  int causal;
  int round_bf16;
};

// Load rows [row0, row0 + ROWS) of one head of `src` into shared memory as
// fp32: transposed (dst[d * ld + r]) when TRANSPOSE, else row-major
// (dst[r * ld + d]). Rows past S read as 0. ROUND rounds each value to bf16.
template <typename T, int D, int ROWS, bool TRANSPOSE>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, Str st,
                                          int b, int h, int row0, int S,
                                          float* dst, int ld, bool round) {
  const T* base = src + (long long)b * st.b + (long long)h * st.h;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int gr = row0 + r;
    float x = gr < S ? to_float(base[(long long)gr * st.s + d]) : 0.f;
    if (round) x = round_bf16(x);
    if (TRANSPOSE) {
      dst[d * ld + r] = x;
    } else {
      dst[r * ld + d] = x;
    }
  }
}

// --------------------------------------------------------------- forward

template <int D, int BQ, int BK>
struct FwdSmem {
  static constexpr int LQ = BQ + kPad, LK = BK + kPad, LD = D + kPad;
  static constexpr int kQt = 0;               // Qt [D][LQ]
  static constexpr int kKt = kQt + D * LQ;    // Kt [D][LK]
  static constexpr int kV = kKt + D * LK;     // V  [BK][LD]
  static constexpr int kPt = kV + BK * LD;    // Pt [BK][LQ]
  static constexpr int kFloats = kPt + BK * LQ;
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Args a) {
  using L = FwdSmem<D, BQ, BK>;
  constexpr int RQ = BQ / 16, CK = BK / 16, G = D / 64;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem + L::kQt;
  float* Kt = smem + L::kKt;
  float* Vs = smem + L::kV;
  float* Pt = smem + L::kPt;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nq = gridDim.x;
  const int qt = a.causal ? nq - 1 - blockIdx.x : blockIdx.x;  // heavy first
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int S = a.S, q0 = qt * BQ;
  const bool round_p = a.round_bf16 != 0;

  load_tile<T, D, BQ, true>(static_cast<const T*>(a.q), a.sq, b, h, q0, S,
                            Qt, L::LQ, false);

  float m[RQ], l[RQ], acc[RQ][4 * G];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(S, q0 + BQ) - 1;
  const int nk = a.causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Kt/V/Pt are no longer read
    load_tile<T, D, BK, true>(static_cast<const T*>(a.k), a.sk, b, h, k0, S,
                              Kt, L::LK, false);
    load_tile<T, D, BK, false>(static_cast<const T*>(a.v), a.sv, b, h, k0, S,
                               Vs, L::LD, false);
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[RQ], kb[CK];
      lds<RQ>(Qt + d * L::LQ + ty * RQ, qa);
      lds<CK>(Kt + d * L::LK + tx * CK, kb);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty * RQ + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int col = k0 + tx * CK + j;
        const bool ok = col < S && (!a.causal || col <= row);
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        Pt[(tx * CK + j) * L::LQ + ty * RQ + i] = round_p ? round_bf16(p) : p;
      }
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[RQ];
      lds<RQ>(Pt + c * L::LQ + ty * RQ, pa);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float vb[4];
        lds<4>(Vs + c * L::LD + g * 64 + tx * 4, vb);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = fmaf(pa[i], vb[j], acc[i][g * 4 + j]);
      }
    }
  }

  T* o = static_cast<T*>(a.out0);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= S) continue;
    T* orow = o + (((long long)b * S + row) * a.H + h) * D;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        from_float(acc[i][g * 4 + j] / l[i], orow + g * 64 + tx * 4 + j);
    if (tx == 0) a.lse_out[(long long)bh * S + row] = m[i] + logf(l[i]);
  }
}

// -------------------------------------------------------------------- dQ

template <int D, int BQ, int BK>
struct DqSmem {
  static constexpr int LQ = BQ + kPad, LK = BK + kPad, LD = D + kPad;
  static constexpr int kQt = 0;                // Qt  [D][LQ]
  static constexpr int kDOt = kQt + D * LQ;    // dOt [D][LQ]
  static constexpr int kKt = kDOt + D * LQ;    // Kt  [D][LK]
  static constexpr int kVt = kKt + D * LK;     // Vt  [D][LK]
  static constexpr int kK = kVt + D * LK;      // K   [BK][LD] (rounded)
  static constexpr int kDSt = kK + BK * LD;    // dSt [BK][LQ]
  static constexpr int kFloats = kDSt + BK * LQ;
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const Args a) {
  using L = DqSmem<D, BQ, BK>;
  constexpr int RQ = BQ / 16, CK = BK / 16, G = D / 64;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem + L::kQt;
  float* DOt = smem + L::kDOt;
  float* Kt = smem + L::kKt;
  float* Vt = smem + L::kVt;
  float* Ks = smem + L::kK;
  float* DSt = smem + L::kDSt;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nq = gridDim.x;
  const int qt = a.causal ? nq - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int S = a.S, q0 = qt * BQ;
  const bool rnd = a.round_bf16 != 0;

  load_tile<T, D, BQ, true>(static_cast<const T*>(a.q), a.sq, b, h, q0, S,
                            Qt, L::LQ, false);
  load_tile<T, D, BQ, true>(static_cast<const T*>(a.dout), a.sdo, b, h, q0,
                            S, DOt, L::LQ, false);
  float lse[RQ], delta[RQ], dq[RQ][4 * G];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    lse[i] = row < S ? a.lse_in[(long long)bh * S + row] : 0.f;
    delta[i] = row < S ? a.delta[(long long)bh * S + row] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) dq[i][c] = 0.f;
  }

  const int q_last = min(S, q0 + BQ) - 1;
  const int nk = a.causal ? q_last / BK + 1 : (S + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D, BK, true>(static_cast<const T*>(a.k), a.sk, b, h, k0, S,
                              Kt, L::LK, false);
    load_tile<T, D, BK, true>(static_cast<const T*>(a.v), a.sv, b, h, k0, S,
                              Vt, L::LK, false);
    load_tile<T, D, BK, false>(static_cast<const T*>(a.k), a.sk, b, h, k0, S,
                               Ks, L::LD, rnd);
    __syncthreads();

    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[RQ], oa[RQ], kb[CK], vb[CK];
      lds<RQ>(Qt + d * L::LQ + ty * RQ, qa);
      lds<RQ>(DOt + d * L::LQ + ty * RQ, oa);
      lds<CK>(Kt + d * L::LK + tx * CK, kb);
      lds<CK>(Vt + d * L::LK + tx * CK, vb);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty * RQ + i;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int col = k0 + tx * CK + j;
        const bool ok = col < S && (!a.causal || col <= row);
        const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        float ds = p * (dp[i][j] - delta[i]) * a.scale;
        if (rnd) ds = round_bf16(ds);
        DSt[(tx * CK + j) * L::LQ + ty * RQ + i] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float da[RQ];
      lds<RQ>(DSt + c * L::LQ + ty * RQ, da);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float kb[4];
        lds<4>(Ks + c * L::LD + g * 64 + tx * 4, kb);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dq[i][g * 4 + j] = fmaf(da[i], kb[j], dq[i][g * 4 + j]);
      }
    }
  }

  T* out = static_cast<T*>(a.out0);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= S) continue;
    T* orow = out + (((long long)b * S + row) * a.H + h) * D;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        from_float(dq[i][g * 4 + j], orow + g * 64 + tx * 4 + j);
  }
}

// ----------------------------------------------------------------- dK/dV

template <int D, int BQ, int BK>
struct DkvSmem {
  static constexpr int LQ = BQ + kPad, LK = BK + kPad, LD = D + kPad;
  static constexpr int kKt = 0;                // Kt  [D][LK]
  static constexpr int kVt = kKt + D * LK;     // Vt  [D][LK]
  static constexpr int kQt = kVt + D * LK;     // Qt  [D][LQ]
  static constexpr int kDOt = kQt + D * LQ;    // dOt [D][LQ]
  static constexpr int kQ = kDOt + D * LQ;     // Q   [BQ][LD] (rounded)
  static constexpr int kDO = kQ + BQ * LD;     // dO  [BQ][LD] (rounded)
  static constexpr int kP = kDO + BQ * LD;     // P   [BQ][LK]
  static constexpr int kDS = kP + BQ * LK;     // dS  [BQ][LK]
  static constexpr int kFloats = kDS + BQ * LK;
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const Args a) {
  using L = DkvSmem<D, BQ, BK>;
  constexpr int RK = BK / 16, CQ = BQ / 16, G = D / 64;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Kt = smem + L::kKt;
  float* Vt = smem + L::kVt;
  float* Qt = smem + L::kQt;
  float* DOt = smem + L::kDOt;
  float* Qs = smem + L::kQ;
  float* DOs = smem + L::kDO;
  float* Ps = smem + L::kP;
  float* DSs = smem + L::kDS;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kt = blockIdx.x;  // low k tiles see the most q tiles: first
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int S = a.S, k0 = kt * BK;
  const bool rnd = a.round_bf16 != 0;

  load_tile<T, D, BK, true>(static_cast<const T*>(a.k), a.sk, b, h, k0, S,
                            Kt, L::LK, false);
  load_tile<T, D, BK, true>(static_cast<const T*>(a.v), a.sv, b, h, k0, S,
                            Vt, L::LK, false);
  float dk[RK][4 * G], dv[RK][4 * G];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int nq = (S + BQ - 1) / BQ;
  // The first q tile that holds a row >= k0 (`_causal_q_index`).
  const int qt0 = a.causal ? k0 / BQ : 0;
  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<T, D, BQ, true>(static_cast<const T*>(a.q), a.sq, b, h, q0, S,
                              Qt, L::LQ, false);
    load_tile<T, D, BQ, true>(static_cast<const T*>(a.dout), a.sdo, b, h, q0,
                              S, DOt, L::LQ, false);
    load_tile<T, D, BQ, false>(static_cast<const T*>(a.q), a.sq, b, h, q0, S,
                               Qs, L::LD, rnd);
    load_tile<T, D, BQ, false>(static_cast<const T*>(a.dout), a.sdo, b, h,
                               q0, S, DOs, L::LD, rnd);
    __syncthreads();

    // S^T and dP^T for this thread's keys (rows) and queries (columns).
    float st[RK][CQ], dpt[RK][CQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CQ; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ka[RK], va[RK], qb[CQ], ob[CQ];
      lds<RK>(Kt + d * L::LK + ty * RK, ka);
      lds<RK>(Vt + d * L::LK + ty * RK, va);
      lds<CQ>(Qt + d * L::LQ + tx * CQ, qb);
      lds<CQ>(DOt + d * L::LQ + tx * CQ, ob);
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          st[i][j] = fmaf(ka[i], qb[j], st[i][j]);
          dpt[i][j] = fmaf(va[i], ob[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < CQ; ++j) {
      const int row = q0 + tx * CQ + j;  // query
      const bool row_ok = row < S;
      const float lse = row_ok ? a.lse_in[(long long)bh * S + row] : 0.f;
      const float delta = row_ok ? a.delta[(long long)bh * S + row] : 0.f;
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int col = k0 + ty * RK + i;  // key
        const bool ok = row_ok && col < S && (!a.causal || col <= row);
        const float p = ok ? expf(st[i][j] * a.scale - lse) : 0.f;
        float ds = p * (dpt[i][j] - delta) * a.scale;
        const int at = (tx * CQ + j) * L::LK + ty * RK + i;
        Ps[at] = rnd ? round_bf16(p) : p;
        DSs[at] = rnd ? round_bf16(ds) : ds;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pa[RK], da[RK];
      lds<RK>(Ps + r * L::LK + ty * RK, pa);
      lds<RK>(DSs + r * L::LK + ty * RK, da);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float ob[4], qb[4];
        lds<4>(DOs + r * L::LD + g * 64 + tx * 4, ob);
        lds<4>(Qs + r * L::LD + g * 64 + tx * 4, qb);
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dv[i][g * 4 + j] = fmaf(pa[i], ob[j], dv[i][g * 4 + j]);
            dk[i][g * 4 + j] = fmaf(da[i], qb[j], dk[i][g * 4 + j]);
          }
      }
    }
  }

  T* dk_out = static_cast<T*>(a.out0);
  T* dv_out = static_cast<T*>(a.out1);
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int row = k0 + ty * RK + i;
    if (row >= S) continue;
    const long long off = (((long long)b * S + row) * a.H + h) * D;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        from_float(dk[i][g * 4 + j], dk_out + off + g * 64 + tx * 4 + j);
        from_float(dv[i][g * 4 + j], dv_out + off + g * 64 + tx * 4 + j);
      }
  }
}

// ------------------------------------------------- tensor-core route (wgmma)
//
// bf16 inputs at D 64. A tile is 64 rows of one head, 64 bf16 = 128 bytes a
// row, 8 KB, in shared memory at a 1024-byte aligned address.

constexpr int kTcThreads = 128;         // one warpgroup
constexpr int kTcRows = 64;             // rows of a tile (one wgmma M, N)
constexpr int kTileBytes = kTcRows * 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// (3) The 128-byte swizzle: 16-byte chunk `c` (0..7) of row `r` sits at
// chunk c ^ (r % 8) of that row. This is the pattern the hardware applies to
// address bits [4, 7) from bits [7, 10) under layout type 1 of a wgmma
// descriptor, so the tile base must be 1024-byte aligned.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// (3) A wgmma shared-memory descriptor for a tile at shared address `addr`:
// start address >> 4 in bits [0, 14); leading byte offset 1 (unused: one
// swizzle atom spans the tile's 64 columns both as K and as N); stride byte
// offset 1024 >> 4 in bits [32, 46) (from one 8-row group to the next); the
// 128-byte swizzle in bits [62, 64). Adding 2 steps K-major operands by 16
// columns (32 bytes inside the swizzled row); adding 128 steps an operand
// read with the transpose bit by 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  // (5) src-size 0 zero-fills the 16 bytes: rows past S read as 0.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// The cp.async writes are generic-proxy writes; wgmma reads shared memory
// through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of one head (`src` points at its row 0, `ld` is
// the row stride in elements) into the swizzled tile at `dst`: 512 chunks of
// 16 bytes, 4 a thread, 8 neighbouring threads on one 128-byte row.
// (4) Each chunk's source address is 16-byte aligned because the pointer
// and the row stride are (`run` refuses anything else).
__device__ __forceinline__ void load_tile_async(const __nv_bfloat16* src,
                                                long long ld, int row0,
                                                int S, uint32_t dst) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + i * kTcThreads;
    const int r = idx >> 3, c = idx & 7;
    const bool ok = row0 + r < S;
    const __nv_bfloat16* p =
        src + (ok ? (long long)(row0 + r) * ld : 0) + c * 8;
    cp_async16(dst + swizzled(r, c), p, ok);
  }
}

// (2) wgmma.fence orders this thread's earlier register writes (the
// accumulators rescaled, the split fragments) and shared-memory reads
// before the wgmma ops that follow; commit closes a group; wait<0> returns
// once every group has finished writing its accumulators.
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// a wgmma or a wait: the asm claims to read and write each register.
__device__ __forceinline__ void wg_hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TC_D32(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define TC_D32_LIST                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d (+)= A.B over one k16 slice, m64n64k16, bf16 x bf16 -> fp32, both
// operands K-major in shared memory. `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TC_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A.B over one k16 slice with A from registers (four bf16x2 a thread)
// and B read with the transpose bit: B[k][n] is row k, column n of the
// tile, so the reduction runs over the tile's rows.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TC_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The exact split of the pair (x, y) into TERMS bf16x2 values: term t holds
// bf16 of what the earlier terms left. With TERMS 1 it is the rounding.
template <int TERMS>
__device__ __forceinline__ void split_pair(float x, float y,
                                           uint32_t (&out)[TERMS]) {
#pragma unroll
  for (int t = 0; t < TERMS; ++t) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    out[t] = *reinterpret_cast<const uint32_t*>(&v);
    x -= __low2float(v);  // exact (Sterbenz)
    y -= __high2float(v);
  }
}

// (1) Accumulator -> A fragments. In the m64nN fp32 accumulator a thread
// holds, for n8 block j, d[4j + e] at (row lane/4, column 8j + 2(lane%4) + e)
// and d[4j + 2 + e] at row lane/4 + 8 (its warp's 16 rows). The A fragment
// of a k16 slice kk takes (row lane/4, k 2(lane%4)+e), (row + 8, same k),
// (row, k + 8), (row + 8, k + 8) as its four bf16x2 registers, which are the
// accumulator pairs d[8kk + 2i], d[8kk + 2i + 1] for i = 0..3: no shuffle.
template <int TERMS>
__device__ __forceinline__ void split_fragments(
    const float (&d)[32], uint32_t (&f)[4][TERMS][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t t3[TERMS];
      split_pair<TERMS>(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1], t3);
#pragma unroll
      for (int t = 0; t < TERMS; ++t) f[kk][t][i] = t3[t];
    }
}

// d += (split A).B: TERMS passes of each of the four k16 slices. `desc_b`
// names a tile read with the transpose bit; slice kk starts 16 rows on.
template <int TERMS>
__device__ __forceinline__ void wgmma_split(float (&d)[32],
                                            const uint32_t (&f)[4][TERMS][4],
                                            uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int t = 0; t < TERMS; ++t) wgmma_rs(d, f[kk][t], desc_b + kk * 128);
}

// d = A.B^T over D 64 (four k16 slices), A and B row-major tiles.
__device__ __forceinline__ void wgmma_abt(float (&d)[32], uint32_t tile_a,
                                          uint32_t tile_b) {
  const uint64_t da = smem_desc(tile_a), db = smem_desc(tile_b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(d, da + 2 * kk, db + 2 * kk, kk);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// (5) Rows past S are not stored. Row `r` of one head of a contiguous
// [B, S, H, 64] output, this thread's 16 columns of it (`row_half` 0 or 1
// picks d[4j + e] or d[4j + 2 + e]), each divided by `div`.
__device__ __forceinline__ void store_row(__nv_bfloat16* row,
                                          const float (&d)[32], int row_half,
                                          float div, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(
        d[4 * j + 2 * row_half] / div, d[4 * j + 2 * row_half + 1] / div);
    *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * (lane & 3)) = v;
  }
}

template <int TERMS>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_wgmma_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;                   // Q tile
  const uint32_t sK = base + kTileBytes;      // K tiles, 2 stages
  const uint32_t sV = base + 3 * kTileBytes;  // V tiles, 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = gridDim.x;
  const int qt = a.causal ? nq - 1 - blockIdx.x : blockIdx.x;  // heavy first
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int S = a.S, q0 = qt * kTcRows;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                            b * a.sq.b + h * a.sq.h;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) +
                            b * a.sk.b + h * a.sk.h;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) +
                            b * a.sv.b + h * a.sv.h;

  const int q_last = min(S, q0 + kTcRows) - 1;
  const int nk = a.causal ? q_last / kTcRows + 1 : (S + kTcRows - 1) / kTcRows;
  load_tile_async(qg, a.sq.s, q0, S, sQ);
  load_tile_async(kg, a.sk.s, 0, S, sK);
  load_tile_async(vg, a.sv.s, 0, S, sV);
  cp_async_commit();

  // This thread's two query rows.
  const int r[2] = {q0 + warp * 16 + (lane >> 2),
                    q0 + warp * 16 + (lane >> 2) + 8};
  float o[32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * kTcRows;
    if (kt + 1 < nk) {  // the next tile's copy overlaps this tile's work
      load_tile_async(kg, a.sk.s, k0 + kTcRows, S, sK + (st ^ 1) * kTileBytes);
      load_tile_async(vg, a.sv.s, k0 + kTcRows, S, sV + (st ^ 1) * kTileBytes);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg_fence();
    wg_hold(s);
    wgmma_abt(s, sQ, sK + st * kTileBytes);  // S = Q.K^T
    wg_commit();
    wg_wait_all();
    wg_hold(s);

    // Scale, mask (5) and the online softmax, per row of the quad.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * (lane & 3) + e;
          const bool ok = col < S && (!a.causal || col <= r[hr]);
          float& x = s[4 * j + 2 * hr + e];
          x = ok ? x * a.scale : kNegInf;
          mt = fmaxf(mt, x);
        }
      const float m_new = fmaxf(m[hr], quad_max(mt));
      const float alpha = expf(m[hr] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hr + e];
          x = expf(x - m_new);
          ps += x;
          o[4 * j + 2 * hr + e] *= alpha;
        }
      l[hr] = l[hr] * alpha + quad_sum(ps);
      m[hr] = m_new;
    }

    // O += P.V: P split from the score registers (1), V read transposed.
    uint32_t f[4][TERMS][4];
    split_fragments<TERMS>(s, f);
    wg_fence();  // (2) the fragments and the rescaled o were written above
    wg_hold(o);
    wgmma_split<TERMS>(o, f, smem_desc(sV + st * kTileBytes));
    wg_commit();
    wg_wait_all();
    wg_hold(o);
    __syncthreads();  // this stage is free for the copy two tiles on
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out0);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (r[hr] >= S) continue;
    store_row(out + (((long long)b * S + r[hr]) * a.H + h) * 64, o, hr, l[hr],
              lane);
    if ((lane & 3) == 0)
      a.lse_out[(long long)bh * S + r[hr]] = m[hr] + logf(l[hr]);
  }
}

// dQ = sum over k tiles of dS.K, dS = P (dP - delta) scale. The forward's
// loop with dO beside Q and K in V's place: S = Q.K^T and dP = dO.V^T from
// shared memory, P and dS in registers, then the split dS as the register
// A operand and the same K tile, read with the transpose bit, as B.
template <int TERMS>
__global__ void __launch_bounds__(kTcThreads)
flash_dq_wgmma_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;                   // Q tile
  const uint32_t sO = base + kTileBytes;      // dO tile
  const uint32_t sK = base + 2 * kTileBytes;  // K tiles, 2 stages
  const uint32_t sV = base + 4 * kTileBytes;  // V tiles, 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = gridDim.x;
  const int qt = a.causal ? nq - 1 - blockIdx.x : blockIdx.x;  // heavy first
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int S = a.S, q0 = qt * kTcRows;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                            b * a.sq.b + h * a.sq.h;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) +
                            b * a.sk.b + h * a.sk.h;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) +
                            b * a.sv.b + h * a.sv.h;
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(a.dout) +
                             b * a.sdo.b + h * a.sdo.h;

  const int q_last = min(S, q0 + kTcRows) - 1;
  const int nk = a.causal ? q_last / kTcRows + 1 : (S + kTcRows - 1) / kTcRows;
  load_tile_async(qg, a.sq.s, q0, S, sQ);
  load_tile_async(dog, a.sdo.s, q0, S, sO);
  load_tile_async(kg, a.sk.s, 0, S, sK);
  load_tile_async(vg, a.sv.s, 0, S, sV);
  cp_async_commit();

  // This thread's two query rows, their lse and delta.
  const int r[2] = {q0 + warp * 16 + (lane >> 2),
                    q0 + warp * 16 + (lane >> 2) + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    lse[hr] = r[hr] < S ? a.lse_in[(long long)bh * S + r[hr]] : 0.f;
    delta[hr] = r[hr] < S ? a.delta[(long long)bh * S + r[hr]] : 0.f;
  }
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * kTcRows;
    if (kt + 1 < nk) {  // the next tile's copy overlaps this tile's work
      load_tile_async(kg, a.sk.s, k0 + kTcRows, S, sK + (st ^ 1) * kTileBytes);
      load_tile_async(vg, a.sv.s, k0 + kTcRows, S, sV + (st ^ 1) * kTileBytes);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // S = Q.K^T and dP = dO.V^T: queries as rows, keys as columns.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg_fence();
    wg_hold(s);
    wg_hold(dp);
    wgmma_abt(s, sQ, sK + st * kTileBytes);
    wgmma_abt(dp, sO, sV + st * kTileBytes);
    wg_commit();
    wg_wait_all();
    wg_hold(s);
    wg_hold(dp);

    // P = exp(scale S - lse) and dS = P (dP - delta) scale, in place in s;
    // masked (5) entries are 0.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * (lane & 3) + e;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const bool ok = col < S && (!a.causal || col <= r[hr]);
          const int i = 4 * j + 2 * hr + e;
          const float p = ok ? expf(s[i] * a.scale - lse[hr]) : 0.f;
          s[i] = p * (dp[i] - delta[hr]) * a.scale;
        }
      }

    // dQ += dS.K: dS split from the score registers (1), K read transposed.
    uint32_t f[4][TERMS][4];
    split_fragments<TERMS>(s, f);
    wg_fence();  // (2) the fragments were written above
    wg_hold(dq);
    wgmma_split<TERMS>(dq, f, smem_desc(sK + st * kTileBytes));
    wg_commit();
    wg_wait_all();
    wg_hold(dq);
    __syncthreads();  // this stage is free for the copy two tiles on
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out0);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (r[hr] >= S) continue;  // (5)
    store_row(out + (((long long)b * S + r[hr]) * a.H + h) * 64, dq, hr, 1.f,
              lane);
  }
}

template <int TERMS>
__global__ void __launch_bounds__(kTcThreads)
flash_dkv_wgmma_kernel(const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = base;                    // K tile
  const uint32_t sV = base + kTileBytes;       // V tile
  const uint32_t sQ = base + 2 * kTileBytes;   // Q tiles, 2 stages
  const uint32_t sO = base + 4 * kTileBytes;   // dO tiles, 2 stages
  // lse and delta of a q tile, 2 stages: stat[stage][0..63] lse, [64..127]
  // delta (per query, so per column of the transposed scores).
  float* stat = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + 6 * kTileBytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kt = blockIdx.x;  // low k tiles see the most q tiles: first
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int S = a.S, k0 = kt * kTcRows;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                            b * a.sq.b + h * a.sq.h;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) +
                            b * a.sk.b + h * a.sk.h;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) +
                            b * a.sv.b + h * a.sv.h;
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(a.dout) +
                             b * a.sdo.b + h * a.sdo.h;
  // Thread tid carries stat entry tid of a stage: lse (tid < 64) or delta.
  const float* stat_src = (tid < 64 ? a.lse_in : a.delta) + (long long)bh * S;

  const int nq = (S + kTcRows - 1) / kTcRows;
  // The first q tile that holds a row >= k0 (`_causal_q_index`).
  const int qt0 = a.causal ? k0 / kTcRows : 0;
  load_tile_async(kg, a.sk.s, k0, S, sK);
  load_tile_async(vg, a.sv.s, k0, S, sV);
  load_tile_async(qg, a.sq.s, qt0 * kTcRows, S, sQ);
  load_tile_async(dog, a.sdo.s, qt0 * kTcRows, S, sO);
  cp_async_commit();
  {
    const int row = qt0 * kTcRows + (tid & 63);
    stat[tid] = row < S ? stat_src[row] : 0.f;
  }

  // This thread's two keys (rows of the transposed scores).
  const int kr[2] = {k0 + warp * 16 + (lane >> 2),
                     k0 + warp * 16 + (lane >> 2) + 8};
  // (6) dk and dv stay in registers across the whole q loop.
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) & 1, q0 = qt * kTcRows;
    float next_stat = 0.f;
    if (qt + 1 < nq) {  // the next tile's copy overlaps this tile's work
      load_tile_async(qg, a.sq.s, q0 + kTcRows, S, sQ + (st ^ 1) * kTileBytes);
      load_tile_async(dog, a.sdo.s, q0 + kTcRows, S,
                      sO + (st ^ 1) * kTileBytes);
      cp_async_commit();
      const int row = q0 + kTcRows + (tid & 63);
      next_stat = row < S ? stat_src[row] : 0.f;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // S^T = K.Q^T and dP^T = V.dO^T: keys as rows, queries as columns.
    float sT[32], dpT[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sT[i] = dpT[i] = 0.f;
    wg_fence();
    wg_hold(sT);
    wg_hold(dpT);
    wgmma_abt(sT, sK, sQ + st * kTileBytes);
    wgmma_abt(dpT, sV, sO + st * kTileBytes);
    wg_commit();
    wg_wait_all();
    wg_hold(sT);
    wg_hold(dpT);

    // P^T = exp(scale S^T - lse[q]) and dS^T = P^T (dP^T - delta[q]) scale,
    // in place; masked (5) and out-of-range entries are 0.
    const float* lse_t = stat + st * 128;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + c);
      const float2 del2 = *reinterpret_cast<const float2*>(lse_t + 64 + c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = q0 + c + e;
        const float lse = e ? lse2.y : lse2.x, delta = e ? del2.y : del2.x;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const bool ok = qc < S && kr[hr] < S && (!a.causal || kr[hr] <= qc);
          const int i = 4 * j + 2 * hr + e;
          const float p = ok ? expf(sT[i] * a.scale - lse) : 0.f;
          dpT[i] = p * (dpT[i] - delta) * a.scale;
          sT[i] = p;
        }
      }
    }

    // dV += P^T.dO and dK += dS^T.Q, A split from registers (1), dO and Q
    // read transposed.
    uint32_t fp[4][TERMS][4];
    split_fragments<TERMS>(sT, fp);
    wg_fence();  // (2)
    wg_hold(dv);
    wgmma_split<TERMS>(dv, fp, smem_desc(sO + st * kTileBytes));
    wg_commit();
    uint32_t fd[4][TERMS][4];
    split_fragments<TERMS>(dpT, fd);
    wg_fence();  // (2) fd was written after the fence above
    wg_hold(dk);
    wgmma_split<TERMS>(dk, fd, smem_desc(sQ + st * kTileBytes));
    wg_commit();
    wg_wait_all();
    wg_hold(dk);
    wg_hold(dv);

    if (qt + 1 < nq) stat[(st ^ 1) * 128 + tid] = next_stat;
    __syncthreads();  // this stage is free for the copy two tiles on
  }

  __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(a.out0);
  __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(a.out1);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (kr[hr] >= S) continue;
    const long long off = (((long long)b * S + kr[hr]) * a.H + h) * 64;
    store_row(dk_out + off, dk, hr, 1.f, lane);
    store_row(dv_out + off, dv, hr, 1.f, lane);
  }
}

constexpr size_t kFwdTcSmem = 5 * kTileBytes + 1024;
constexpr size_t kDqTcSmem = 6 * kTileBytes + 1024;
constexpr size_t kDkvTcSmem = 6 * kTileBytes + 2 * 128 * sizeof(float) + 1024;

// ---------------------------------------------------------------- launch

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// Tile edges (BQ, BK) per head dim: 64 x 64 at D 64; smaller where the
// fp32 tiles of D 128 and 256 would not fit 227 KB of shared memory.
template <int D> struct Tiles;
template <> struct Tiles<64> {
  static constexpr int kFwdQ = 64, kFwdK = 64, kDqQ = 64, kDqK = 64,
                       kDkvQ = 32, kDkvK = 64;
};
template <> struct Tiles<128> {
  static constexpr int kFwdQ = 64, kFwdK = 32, kDqQ = 64, kDqK = 32,
                       kDkvQ = 32, kDkvK = 32;
};
template <> struct Tiles<256> {
  static constexpr int kFwdQ = 32, kFwdK = 32, kDqQ = 32, kDqK = 32,
                       kDkvQ = 32, kDkvK = 32;
};

template <typename KernelT>
cudaError_t launch_with_smem(KernelT kernel, dim3 grid, int threads,
                             size_t bytes, const Args& a,
                             cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(Kind kind, const Args& a, cudaStream_t stream) {
  using TL = Tiles<D>;
  const int BH = a.B * a.H;
  if (kind == kFwd) {
    constexpr int BQ = TL::kFwdQ, BK = TL::kFwdK;
    dim3 grid((a.S + BQ - 1) / BQ, BH);
    return launch_with_smem(flash_fwd_kernel<T, D, BQ, BK>, grid, kThreads,
                            FwdSmem<D, BQ, BK>::kFloats * sizeof(float), a,
                            stream);
  }
  if (kind == kDq) {
    constexpr int BQ = TL::kDqQ, BK = TL::kDqK;
    dim3 grid((a.S + BQ - 1) / BQ, BH);
    return launch_with_smem(flash_dq_kernel<T, D, BQ, BK>, grid, kThreads,
                            DqSmem<D, BQ, BK>::kFloats * sizeof(float), a,
                            stream);
  }
  constexpr int BQ = TL::kDkvQ, BK = TL::kDkvK;
  dim3 grid((a.S + BK - 1) / BK, BH);
  return launch_with_smem(flash_dkv_kernel<T, D, BQ, BK>, grid, kThreads,
                          DkvSmem<D, BQ, BK>::kFloats * sizeof(float), a,
                          stream);
}

// The tensor-core route: bf16 at D 64, all three kernels. (4) Every row a
// cp.async copy reads must start on 16 bytes: the pointers and the
// (batch, seq, head) strides of q, k, v (and dout) must be multiples of 16
// bytes (8 elements). Anything else is refused, never rerouted.
cudaError_t launch_tc(Kind kind, const Args& a, cudaStream_t stream) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const Str strs[4] = {a.sq, a.sk, a.sv, a.sdo};
  for (int i = 0; i < (kind == kFwd ? 3 : 4); ++i) {
    if ((reinterpret_cast<uintptr_t>(ptrs[i]) & 15) != 0 ||
        (strs[i].b & 7) != 0 || (strs[i].s & 7) != 0 || (strs[i].h & 7) != 0) {
      return cudaErrorMisalignedAddress;
    }
  }
  dim3 grid((a.S + kTcRows - 1) / kTcRows, a.B * a.H);
  const bool one = a.round_bf16 != 0;
  if (kind == kFwd) {
    return one ? launch_with_smem(flash_fwd_wgmma_kernel<1>, grid, kTcThreads,
                                  kFwdTcSmem, a, stream)
               : launch_with_smem(flash_fwd_wgmma_kernel<3>, grid, kTcThreads,
                                  kFwdTcSmem, a, stream);
  }
  if (kind == kDq) {
    return one ? launch_with_smem(flash_dq_wgmma_kernel<1>, grid, kTcThreads,
                                  kDqTcSmem, a, stream)
               : launch_with_smem(flash_dq_wgmma_kernel<3>, grid, kTcThreads,
                                  kDqTcSmem, a, stream);
  }
  return one ? launch_with_smem(flash_dkv_wgmma_kernel<1>, grid, kTcThreads,
                                kDkvTcSmem, a, stream)
             : launch_with_smem(flash_dkv_wgmma_kernel<3>, grid, kTcThreads,
                                kDkvTcSmem, a, stream);
}

template <typename T>
cudaError_t dispatch_d(Kind kind, int head_dim, const Args& a,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(kind, a, stream);
    case 128:
      return launch<T, 128>(kind, a, stream);
    case 256:
      return launch<T, 256>(kind, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(Kind kind, Args& a, const long long* strides, int head_dim,
        int dtype, void* stream) {
  if (a.B <= 0 || a.H <= 0 || a.S <= 0 || (long long)a.B * a.H > 65535) {
    return cudaErrorInvalidValue;
  }
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.sdo = {strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The route, from the dtype and head dim alone (see the note at the top).
  if (dtype == 1 && head_dim == 64) return launch_tc(kind, a, s);
  if (dtype == 0) return dispatch_d<float>(kind, head_dim, a, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(kind, head_dim, a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// All three return a cudaError_t (0 = success): cudaErrorInvalidValue for
// a shape or dtype the kernels do not take, else the launch's error.
// dtype: 0 = float32, 1 = bfloat16. `strides` holds 12 element strides,
// (batch, seq, head) of q, k, v and dout in that order (the forward reads
// the first 9).

int dtt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, const long long* strides, int B, int H, int S,
                  int head_dim, int dtype, int causal, int round_bf16,
                  float scale, void* stream) {
  long long st[12];
  for (int i = 0; i < 9; ++i) st[i] = strides[i];
  st[9] = st[10] = st[11] = 0;
  Args a = {q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse,
            {}, {}, {}, {}, B, H, S, scale, causal, round_bf16};
  return run(kFwd, a, st, head_dim, dtype, stream);
}

int dtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, const long long* strides, int B, int H, int S,
                     int head_dim, int dtype, int causal, int round_bf16,
                     float scale, void* stream) {
  Args a = {q, k, v, dout, lse, delta, dq, nullptr, nullptr,
            {}, {}, {}, {}, B, H, S, scale, causal, round_bf16};
  return run(kDq, a, strides, head_dim, dtype, stream);
}

int dtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, const long long* strides, int B,
                      int H, int S, int head_dim, int dtype, int causal,
                      int round_bf16, float scale, void* stream) {
  Args a = {q, k, v, dout, lse, delta, dk, dv, nullptr,
            {}, {}, {}, {}, B, H, S, scale, causal, round_bf16};
  return run(kDkv, a, strides, head_dim, dtype, stream);
}

const char* dtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
