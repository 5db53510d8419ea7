// Paged decode attention for Hopper (sm_90a), built with nvcc into a shared
// library with a plain C interface and bound with ctypes
// (determined_tpu_torch/ops/_build.py, ops/paged_attention.py).
//
// Replaces the TPU kernel `_paged_kernel` in
// determined_tpu/ops/paged_attention.py (launched by
// `paged_attention_pallas`). It computes, for every (slot, head), one decode
// query's attention over the keys `idx <= positions[slot]` of a sequence
// whose K/V live in a block pool addressed through the slot's block table:
//
//   q            [slots, H, Dh]          fp32 or bf16
//   k_pool/v_pool[P, bs, H, Dh]          same dtype (one layer; the last
//                                        block is the trash block)
//   block_tables [slots, mb]  int32      logical block i -> pool block
//   positions    [slots]      int32      index written this step
//   out          [slots, H, Dh]          q's dtype
//
// The logits, the running max m, the normaliser l and the accumulator acc
// are fp32, and P.V accumulates in fp32, as the TPU kernel does when it
// casts v to f32 before the product.
//
// What bounds it on the H100: decode attention is bandwidth-bound. A slot
// at position pos must read 2 * (pos + 1) * H * Dh * itemsize bytes of K/V
// and does about 4 * (pos + 1) * H * Dh flops on them: one flop per byte
// in bf16, against the ~295 the card needs before compute is the limit.
// The least time is those bytes over 3.35 TB/s.
//
// What this design does about it: it reads nothing it does not need. One
// thread block per (slot, head) loads its own table entries and position
// (the GPU has no scalar prefetch) and walks logical blocks 0..pos/bs only;
// the TPU's static grid had to visit all mb blocks. Each K/V row is read
// once, from the pool, with no gathered lane in device memory. It is the
// first, simple version: the speed work (a warp per key block, 16-byte
// vector loads, splitting long contexts across SMs so that a small batch
// fills all 132 of them) is left to a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlockSize = 128;
constexpr float kNegInf = -1e30f;  // masked logit, as ops/_softmax_common.py

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ block_tables,
                       const int32_t* __restrict__ positions,
                       T* __restrict__ out, int heads, int block_size,
                       int max_blocks, int num_pool_blocks, float scale) {
  constexpr int kPerThread = (DH + kThreads - 1) / kThreads;
  __shared__ float q_s[DH];
  __shared__ float s_s[kMaxBlockSize];  // this block's scaled logits
  __shared__ float p_s[kMaxBlockSize];  // exp(s - m_new)

  const int slot = blockIdx.x;
  const int head = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int64_t q_off = ((int64_t)slot * heads + head) * DH;
  for (int d = tid; d < DH; d += kThreads) q_s[d] = to_float(q[q_off + d]);

  const int pos = positions[slot];
  int n_blocks = pos / block_size + 1;  // logical blocks holding idx <= pos
  if (n_blocks > max_blocks) n_blocks = max_blocks;
  if (pos < 0) n_blocks = 0;
  const int32_t* table = block_tables + (int64_t)slot * max_blocks;
  // Elements between consecutive keys of one head in the pool.
  const int64_t row = (int64_t)heads * DH;

  float m = kNegInf;
  float l = 0.f;
  float acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int b = 0; b < n_blocks; ++b) {
    int blk = table[b];
    // Clamp like a jnp gather: an index outside the pool reads its edge.
    blk = blk < 0 ? 0 : (blk >= num_pool_blocks ? num_pool_blocks - 1 : blk);
    const int64_t base = (int64_t)blk * block_size * row + (int64_t)head * DH;

    // Logits: one warp per key, lanes split the head dimension.
    for (int j = warp; j < block_size; j += kWarps) {
      const T* k_row = k_pool + base + j * row;
      float dot = 0.f;
      for (int d = lane; d < DH; d += 32) dot += q_s[d] * to_float(k_row[d]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        const int idx = b * block_size + j;
        s_s[j] = idx <= pos ? dot * scale : kNegInf;
      }
    }
    __syncthreads();

    // Fold the block into (m, l): every thread keeps the same copy.
    float m_blk = kNegInf;
    for (int j = 0; j < block_size; ++j) m_blk = fmaxf(m_blk, s_s[j]);
    const float m_new = fmaxf(m, m_blk);
    const float alpha = expf(m - m_new);
    for (int j = tid; j < block_size; j += kThreads) p_s[j] = expf(s_s[j] - m_new);
    __syncthreads();

    float p_sum = 0.f;
    for (int j = 0; j < block_size; ++j) p_sum += p_s[j];
    l = l * alpha + p_sum;
    m = m_new;

    // acc = acc * alpha + P.V, one output lane per thread, fp32 throughout.
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int d = tid + i * kThreads;
      if (d < DH) {
        float a = acc[i] * alpha;
        const T* v_col = v_pool + base + d;
        for (int j = 0; j < block_size; ++j) a += p_s[j] * to_float(v_col[j * row]);
        acc[i] = a;
      }
    }
    __syncthreads();  // s_s / p_s are rewritten by the next block
  }

  const float inv_l = 1.f / l;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int d = tid + i * kThreads;
    if (d < DH) from_float(acc[i] * inv_l, out + q_off + d);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* tables, const int32_t* positions, void* out,
                   int slots, int heads, int block_size, int max_blocks,
                   int num_pool_blocks, float scale, cudaStream_t stream) {
  dim3 grid(slots, heads);
  paged_attention_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, positions, static_cast<T*>(out),
      heads, block_size, max_blocks, num_pool_blocks, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int head_dim, const void* q, const void* k,
                        const void* v, const int32_t* tables,
                        const int32_t* positions, void* out, int slots,
                        int heads, int block_size, int max_blocks,
                        int num_pool_blocks, float scale, cudaStream_t stream) {
#define DTT_CASE(DH)                                                        \
  case DH:                                                                  \
    return launch<T, DH>(q, k, v, tables, positions, out, slots, heads,     \
                         block_size, max_blocks, num_pool_blocks, scale,    \
                         stream);
  switch (head_dim) {
    DTT_CASE(16)
    DTT_CASE(32)
    DTT_CASE(64)
    DTT_CASE(128)
    DTT_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef DTT_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success):
// cudaErrorInvalidValue for a shape the kernel does not take, otherwise
// cudaGetLastError() right after the launch.
int dtt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                        const void* block_tables, const void* positions,
                        void* out, int slots, int heads, int head_dim,
                        int block_size, int max_blocks, int num_pool_blocks,
                        int dtype, float scale, void* stream) {
  if (slots <= 0 || heads <= 0 || max_blocks <= 0 || num_pool_blocks <= 0 ||
      block_size <= 0 || block_size > kMaxBlockSize ||
      (block_size & (block_size - 1)) != 0 || heads > 65535) {
    return cudaErrorInvalidValue;
  }
  const int32_t* tables = static_cast<const int32_t*>(block_tables);
  const int32_t* pos = static_cast<const int32_t*>(positions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_dh<float>(head_dim, q, k_pool, v_pool, tables, pos, out,
                              slots, heads, block_size, max_blocks,
                              num_pool_blocks, scale, s);
  }
  if (dtype == 1) {
    return dispatch_dh<__nv_bfloat16>(head_dim, q, k_pool, v_pool, tables,
                                      pos, out, slots, heads, block_size,
                                      max_blocks, num_pool_blocks, scale, s);
  }
  return cudaErrorInvalidValue;
}

const char* dtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
