// Flash attention for training on Hopper (sm_90a): the forward kernel, the
// dQ kernel and the dK/dV kernel. Built with nvcc into a shared library with
// a plain C interface and bound with ctypes (determined_tpu_torch/ops/
// _build.py, ops/flash_attention.py).
//
// Replaces the three TPU kernels of determined_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- `_fwd_kernel` (launched by `_flash_fwd`)
//   flash_dq_kernel   <- `_dq_kernel`  (launched by `_flash_bwd`)
//   flash_dkv_kernel  <- `_dkv_kernel` (launched by `_flash_bwd`)
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
// rounds P to the value dtype, which is bf16 only for bf16 inputs). A
// product of bf16 values is exact in fp32, so FFMA with fp32 sums computes
// exactly what a bf16 tensor-core product with fp32 accumulation computes.
//
// What bounds them on the H100: operations. At GPT-2 small's shape (BH 96,
// S 1024, D 64, causal) the forward does 2 products of S^2*D/2 per head
// on 50 MB of inputs and outputs: ~250 operations a byte, and half of them
// (P.V) are fp32 products, which the card runs at 67 TFLOP/s outside the
// tensor cores, not at the bf16 rate of 989. The backward is worse: three
// of its five products are fp32.
//
// What this design does about it: the first, simple version. Every product
// is FFMA on CUDA cores from shared memory, with fp32 operands; each
// thread of a 256-thread block holds a register tile and reads its operands
// as 8- or 16-byte vectors from transposed or padded tiles, so that each
// shared-memory load feeds several FMAs. The causal frontier is a loop
// bound (forward and dQ stop at the diagonal tile, dK/dV starts at the
// first visible q tile), so masked tiles cost nothing, and the heavy tiles
// of a causal grid are scheduled first. Nothing crosses blocks: the loop
// over k tiles (forward, dQ) or q tiles (dK/dV) runs inside one block, as
// the TPU's sequential grid axis did, and the JAX two-kernel split keeps
// the backward free of atomics, so every gradient is the same from run to
// run. bf16 Q.K^T and dO.V^T on tensor cores (mma.sync / wgmma), cp.async
// or TMA double buffering, and a faster path for the fp32 products are
// left to later changes.

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
cudaError_t launch_with_smem(KernelT kernel, dim3 grid, size_t bytes,
                             const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(Kind kind, const Args& a, cudaStream_t stream) {
  using TL = Tiles<D>;
  const int BH = a.B * a.H;
  if (kind == kFwd) {
    constexpr int BQ = TL::kFwdQ, BK = TL::kFwdK;
    dim3 grid((a.S + BQ - 1) / BQ, BH);
    return launch_with_smem(flash_fwd_kernel<T, D, BQ, BK>, grid,
                            FwdSmem<D, BQ, BK>::kFloats * sizeof(float), a,
                            stream);
  }
  if (kind == kDq) {
    constexpr int BQ = TL::kDqQ, BK = TL::kDqK;
    dim3 grid((a.S + BQ - 1) / BQ, BH);
    return launch_with_smem(flash_dq_kernel<T, D, BQ, BK>, grid,
                            DqSmem<D, BQ, BK>::kFloats * sizeof(float), a,
                            stream);
  }
  constexpr int BQ = TL::kDkvQ, BK = TL::kDkvK;
  dim3 grid((a.S + BK - 1) / BK, BH);
  return launch_with_smem(flash_dkv_kernel<T, D, BQ, BK>, grid,
                          DkvSmem<D, BQ, BK>::kFloats * sizeof(float), a,
                          stream);
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
