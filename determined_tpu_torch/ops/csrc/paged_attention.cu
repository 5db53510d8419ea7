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
//   workspace    fp32, slots * H * n_splits * (Dh + 2), from the wrapper
//
// The logits, the running max m, the normaliser l and the accumulator acc
// are fp32, and P.V accumulates in fp32, as the TPU kernel does when it
// casts v to f32 before the product.
//
// What bounds it on the H100: bytes. A slot at position pos must read
// 2 * (pos + 1) * H * Dh * itemsize bytes of K/V and does about 4 * (pos +
// 1) * H * Dh flops on them: one flop per byte in bf16, against the ~295
// the card needs before compute is the limit. The least time is those bytes
// over 3.35 TB/s (8 slots at position 1023, H 12, Dh 64, bf16: 25.2 MB,
// 7.5 us). So the design has to keep enough loads in flight on all 132 SMs
// and do little else between them.
//
// What this design does about it:
//
// - The split (flash-decoding). Each context is cut into chunks of
//   `split_keys` keys (a multiple of the block size; the wrapper passes
//   512), and the grid is (slots, H, n_splits) with n_splits =
//   ceil(mb * bs / split_keys): 8 slots at 4096 keys give 768 blocks
//   where one block per (slot, head) gave 96. The chunk depends on the
//   shapes alone: of 128, 256 and 512 keys, 512 was the fastest at most
//   of 1 and 8 slots and 321 to 4096 keys on an H100
//   (tools/paged_split_variants.py, PERF.md), with fewer partials to
//   merge and no combine for a context of up to 512 keys. A block whose
//   chunk starts past the slot's position exits at once. Each block
//   keeps its own online softmax and writes its partial (m, l, acc[Dh])
//   in fp32 to the workspace.
// - The loads. Each key row is read with 16-byte loads by a group of G
//   neighbouring lanes (Dh 64 bf16: 128 bytes = 8 lanes, so one warp load
//   covers 4 keys), each lane owning the same E elements of q (fp32, in
//   registers), of the K and V rows and of acc. A group takes every
//   NG-th key of the chunk (NG = groups in the block), U keys at a time:
//   the U K rows and U V rows of one step are all loaded before any is
//   used, 2U loads in flight a lane (Dh 64 bf16: 256 threads, 8 keys a
//   group, so a chunk of 512 keys is two steps). V rows are read like K
//   rows, not column by column. The loads skip L1 and mark their L2 lines
//   evict-first: each row is read once.
// - No barrier per key block. The dot products are reduced with shuffles
//   inside each group; each group keeps its own (m, l, acc) over its keys.
//   The block's position, table entries and q are loaded together, the
//   table entries go to shared memory (one barrier), and the groups are
//   merged once, at the end: by shuffles inside each warp, then the
//   warps through shared memory (one more).
// - The combine. Per (slot, head) the visible splits are merged in split
//   order with the usual rescale by a second small kernel, launched as a
//   programmatic dependent of the first so that its launch overlaps it.
//   Every merge (groups, warps, splits) has a fixed order, so two
//   launches on the same inputs give bit-identical outputs. A slot with
//   one visible split has that split's block write `out` itself; when
//   mb * bs <= split_keys no slot has more than one and the combine is
//   not launched.
//
// Pool indices are clamped like a jnp gather: an index outside the pool
// reads its edge.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlockSize = 128;
constexpr int kMaxSplitKeys = 512;
constexpr float kNegInf = -1e30f;  // masked logit, as ops/_softmax_common.py

__device__ __forceinline__ void from_float(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// 16 bytes of T as fp32: 4 floats, or 8 bf16 (a bf16 is the top half of an
// fp32 word, so widening is a shift).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kElems = 4;
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// The lane layout of one head's row of DH elements of T.
template <typename T, int DH>
struct Layout {
  static constexpr int kVec = Vec<T>::kElems;        // elements a load
  static constexpr int kRowVecs = DH / kVec;         // 16-byte pieces a row
  static constexpr int G = kRowVecs < 32 ? kRowVecs : 32;  // lanes a key
  static constexpr int NV = kRowVecs / G;            // loads a lane a row
  static constexpr int E = NV * kVec;                // elements a lane
  static constexpr int NG = kThreads / G;            // key groups a block
  static constexpr int U = NV == 1 ? 8 : 4;          // keys a group a step
  static_assert(kRowVecs % G == 0, "row must split evenly over the lanes");
};

// K/V rows are read once: a 16-byte load that allocates nothing in L1 and
// marks its L2 line first to be evicted, so the stream of keys does not
// push other data out of L2 (nor, when L2 holds dirty lines, make each
// read write one back).
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}
__device__ __forceinline__ uint4 ld_stream(const uint4* p, uint64_t policy) {
  uint4 r;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, "
      "[%4], %5;"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p), "l"(policy));
  return r;
}

// Number of splits that hold a key idx <= pos (0 for pos < 0).
__device__ __forceinline__ int visible_splits(int pos, int keys,
                                              int split_keys) {
  if (pos < 0) return 0;
  const int last = pos < keys ? pos : keys - 1;
  return last / split_keys + 1;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const int32_t* __restrict__ block_tables,
                   const int32_t* __restrict__ positions,
                   T* __restrict__ out, float* __restrict__ ws, int heads,
                   int block_size, int log2_bs, int max_blocks,
                   int num_pool_blocks, int split_keys, float scale) {
  using L = Layout<T, DH>;
  constexpr int G = L::G, NV = L::NV, E = L::E, NG = L::NG, U = L::U;
  __shared__ int32_t tbl_s[kMaxSplitKeys];  // this chunk's pool blocks
  __shared__ float m_s[kWarps], l_s[kWarps];
  __shared__ float acc_s[kWarps][DH];
  // The combine kernel may be scheduled now; it waits for this grid to
  // finish before it reads the workspace.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  const int slot = blockIdx.x, head = blockIdx.y, split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int tid = threadIdx.x;
  const int group = tid / G, sub = tid % G;
  const int keys = max_blocks * block_size;
  const int c0 = split * split_keys;  // first key of the chunk
  const int b0 = c0 >> log2_bs;       // its first logical block
  // The position, this chunk's table entries and q are loaded together:
  // none waits for another.
  const int pos = positions[slot];
  int n_tbl = split_keys >> log2_bs;
  if (n_tbl > max_blocks - b0) n_tbl = max_blocks - b0;
  const int32_t* table = block_tables + (int64_t)slot * max_blocks + b0;
  int32_t blk[kMaxSplitKeys / kThreads];
#pragma unroll
  for (int i = 0; i < kMaxSplitKeys / kThreads; ++i) {
    const int t = tid + i * kThreads;
    blk[i] = t < n_tbl ? table[t] : 0;
  }
  // This lane's E elements of q, of every K/V row and of acc: the NV
  // 16-byte pieces sub, sub + G, ... of the row.
  const T* q_row = q + ((int64_t)slot * heads + head) * DH;
  uint4 qv[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v)
    qv[v] = __ldg(reinterpret_cast<const uint4*>(q_row) + sub + v * G);

  const int nvs = visible_splits(pos, keys, split_keys);
  // Split 0 always runs, so a slot with no visible key still writes out.
  if (split >= (nvs > 1 ? nvs : 1)) return;
  int n_vis = (pos < keys ? pos + 1 : keys) - c0;  // visible keys here
  if (n_vis > split_keys) n_vis = split_keys;
#pragma unroll
  for (int i = 0; i < kMaxSplitKeys / kThreads; ++i) {
    const int t = tid + i * kThreads;
    // Clamp like a jnp gather: an index outside the pool reads its edge.
    if (t < n_tbl)
      tbl_s[t] = blk[i] < 0 ? 0
                            : (blk[i] >= num_pool_blocks ? num_pool_blocks - 1
                                                         : blk[i]);
  }
  float qf[E];
#pragma unroll
  for (int v = 0; v < NV; ++v) Vec<T>::unpack(qv[v], qf + v * L::kVec);
  float m = kNegInf, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  __syncthreads();  // tbl_s

  const int64_t row = (int64_t)heads * DH;  // elements between keys
  const uint64_t policy = evict_first_policy();
  const T* k_head = k_pool + (int64_t)head * DH;
  const T* v_head = v_pool + (int64_t)head * DH;
  // The trip count is the same for every thread: the shuffles below need
  // all 32 lanes of each warp.
  for (int base = 0; base < n_vis; base += NG * U) {
    // Every load of the step first: 2 U rows in flight.
    uint4 kr[U][NV], vr[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * NG + group;
      if (j < n_vis) {
        const int64_t off =
            ((int64_t)tbl_s[j >> log2_bs] * block_size +
             (j & (block_size - 1))) * row;
        const uint4* kp = reinterpret_cast<const uint4*>(k_head + off) + sub;
        const uint4* vp = reinterpret_cast<const uint4*>(v_head + off) + sub;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          kr[u][v] = ld_stream(kp + v * G, policy);
          vr[u][v] = ld_stream(vp + v * G, policy);
        }
      }
    }
    // Logits: each lane's partial dot, summed over the group's G lanes.
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
#pragma unroll
      for (int v = 0; v < NV; ++v) Vec<T>::unpack(kr[u][v], kf + v * L::kVec);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(qf[e], kf[e], dot);
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[u] = base + u * NG + group < n_vis ? dot * scale : kNegInf;
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < U; ++u) m_new = fmaxf(m_new, s[u]);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * NG + group < n_vis) {
        const float p = expf(s[u] - m_new);
        l += p;
        float vf[E];
#pragma unroll
        for (int v = 0; v < NV; ++v)
          Vec<T>::unpack(vr[u][v], vf + v * L::kVec);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
      }
    }
    m = m_new;
  }

  // Merge the groups: first the 32 / G groups of each warp, by shuffles
  // between the lanes that own the same elements, then the warps' results
  // through shared memory in warp order. The pattern is fixed, so the sums
  // are the same from run to run.
  float m_w = m;
#pragma unroll
  for (int o = G; o < 32; o <<= 1)
    m_w = fmaxf(m_w, __shfl_xor_sync(0xffffffffu, m_w, o));
  const float w = expf(m - m_w);
  l *= w;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] *= w;
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  const int warp = tid >> 5;
  if (tid % 32 < G) {  // the warp's first group writes its merged state
    if (sub == 0) {
      m_s[warp] = m_w;
      l_s[warp] = l;
    }
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int i = 0; i < L::kVec; ++i)
        acc_s[warp][(sub + v * G) * L::kVec + i] = acc[v * L::kVec + i];
  }
  __syncthreads();
  float mx = kNegInf, wt[kWarps];
#pragma unroll
  for (int g = 0; g < kWarps; ++g) mx = fmaxf(mx, m_s[g]);
  float lt = 0.f;
#pragma unroll
  for (int g = 0; g < kWarps; ++g) {
    wt[g] = expf(m_s[g] - mx);
    lt += wt[g] * l_s[g];
  }

  const int64_t sh = (int64_t)slot * heads + head;
  // The partial of this split: acc[DH], then m and l.
  float* part = ws + (sh * n_splits + split) * (DH + 2);
  for (int d = tid; d < DH; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < kWarps; ++g) a += wt[g] * acc_s[g][d];
    if (nvs <= 1) {
      from_float(a * (1.f / lt), out + sh * DH + d);
    } else {
      part[d] = a;
    }
  }
  if (nvs > 1 && tid == 0) {
    part[DH] = mx;
    part[DH + 1] = lt;
  }
}

// Merge the visible splits of each (slot, head), in split order: one block
// of DH threads per (slot, head), thread d owns output element d. Launched
// as a programmatic dependent of the split kernel, so its launch overlaps
// that kernel; griddepcontrol.wait returns once the split kernel has
// finished and its writes are visible. Every block waits, so this grid
// never ends before the split kernel does.
template <typename T, int DH>
__global__ void __launch_bounds__(DH)
paged_combine_kernel(const int32_t* __restrict__ positions,
                     const float* __restrict__ ws, T* __restrict__ out,
                     int heads, int keys, int split_keys, int n_splits) {
  const int slot = blockIdx.x, head = blockIdx.y, d = threadIdx.x;
  const int nvs = visible_splits(positions[slot], keys, split_keys);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (nvs <= 1) return;  // the split wrote out itself
  const int64_t sh = (int64_t)slot * heads + head;
  const float* part = ws + sh * n_splits * (DH + 2);
  float mx = kNegInf;
  for (int s = 0; s < nvs; ++s) mx = fmaxf(mx, part[s * (DH + 2) + DH]);
  float lt = 0.f, a = 0.f;
  for (int s = 0; s < nvs; ++s) {
    const float* p = part + s * (DH + 2);
    const float w = expf(p[DH] - mx);
    lt += w * p[DH + 1];
    a += w * p[d];
  }
  from_float(a * (1.f / lt), out + sh * DH + d);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* tables, const int32_t* positions, void* out,
                   float* ws, int slots, int heads, int block_size,
                   int max_blocks, int num_pool_blocks, int split_keys,
                   float scale, cudaStream_t stream) {
  const int keys = max_blocks * block_size;
  const int n_splits = (keys + split_keys - 1) / split_keys;
  if (n_splits > 65535 || (n_splits > 1 && ws == nullptr)) {
    return cudaErrorInvalidValue;
  }
  int log2_bs = 0;
  while ((1 << log2_bs) < block_size) ++log2_bs;
  paged_split_kernel<T, DH><<<dim3(slots, heads, n_splits), kThreads, 0,
                              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, positions, static_cast<T*>(out), ws,
      heads, block_size, log2_bs, max_blocks, num_pool_blocks, split_keys,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slots, heads);
  cfg.blockDim = dim3(DH);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_combine_kernel<T, DH>, positions,
                            static_cast<const float*>(ws),
                            static_cast<T*>(out), heads, keys, split_keys,
                            n_splits);
}

template <typename T>
cudaError_t dispatch_dh(int head_dim, const void* q, const void* k,
                        const void* v, const int32_t* tables,
                        const int32_t* positions, void* out, float* ws,
                        int slots, int heads, int block_size, int max_blocks,
                        int num_pool_blocks, int split_keys, float scale,
                        cudaStream_t stream) {
#define DTT_CASE(DH)                                                        \
  case DH:                                                                  \
    return launch<T, DH>(q, k, v, tables, positions, out, ws, slots, heads, \
                         block_size, max_blocks, num_pool_blocks,           \
                         split_keys, scale, stream);
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

// dtype: 0 = float32, 1 = bfloat16. `workspace` holds slots * heads *
// n_splits * (head_dim + 2) floats, n_splits = ceil(max_blocks * block_size
// / split_keys) (may be null when that is 1). Returns a cudaError_t (0 =
// success): cudaErrorInvalidValue for a shape the kernels do not take,
// cudaErrorMisalignedAddress for a q, pool or out pointer that is not
// 16-byte aligned, otherwise cudaGetLastError() right after each launch.
int dtt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                        const void* block_tables, const void* positions,
                        void* out, void* workspace, int slots, int heads,
                        int head_dim, int block_size, int max_blocks,
                        int num_pool_blocks, int split_keys, int dtype,
                        float scale, void* stream) {
  if (slots <= 0 || heads <= 0 || max_blocks <= 0 || num_pool_blocks <= 0 ||
      block_size <= 0 || block_size > kMaxBlockSize ||
      (block_size & (block_size - 1)) != 0 || heads > 65535 ||
      split_keys <= 0 || split_keys > kMaxSplitKeys ||
      split_keys % block_size != 0) {
    return cudaErrorInvalidValue;
  }
  const void* vec[4] = {q, k_pool, v_pool, out};
  for (const void* p : vec) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) != 0) {
      return cudaErrorMisalignedAddress;
    }
  }
  const int32_t* tables = static_cast<const int32_t*>(block_tables);
  const int32_t* pos = static_cast<const int32_t*>(positions);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_dh<float>(head_dim, q, k_pool, v_pool, tables, pos, out,
                              ws, slots, heads, block_size, max_blocks,
                              num_pool_blocks, split_keys, scale, s);
  }
  if (dtype == 1) {
    return dispatch_dh<__nv_bfloat16>(head_dim, q, k_pool, v_pool, tables,
                                      pos, out, ws, slots, heads, block_size,
                                      max_blocks, num_pool_blocks, split_keys,
                                      scale, s);
  }
  return cudaErrorInvalidValue;
}

const char* dtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
