// Per-chunk L1 census for Hopper (sm_90a): the port of the Pallas kernel
// repro/kernels/chunk_l1norm.py::chunk_l1norm (body _kernel).
//
// norms[c] = sum_i |pool[c * chunk + i]|, accumulated in f32, for an f32 or
// bf16 pool viewed as (C, chunk). CSC selects next step's chunks from these
// norms, so the sum must come out the same bits on every run.
//
// Bound: bytes. Each element is read once (4 B f32, 2 B bf16) for one abs and
// one add; the f32[C] output is negligible. At 4106 x 32768 f32 that is
// 538 MB, 0.161 ms at 3.35 TB/s, against 0.004 ms of f32 operations at
// 67 TFLOP/s. Design: one block per chunk (grid-stride over chunks past the
// grid's size); each thread walks the chunk with 16-byte loads (4 f32 or
// 8 bf16) where the row's bytes and the pool's base allow it, else one
// element at a time, and keeps one f32 partial sum. The block then reduces in
// a fixed order: a butterfly of warp shuffles, then thread 0 adds the
// per-warp sums from shared memory in warp order. No atomics, so the result
// does not depend on scheduling.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 1LL << 20;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// |x| summed over one 16-byte vector of the element type.
__device__ __forceinline__ float vec_abs_sum(uint4 u, float) {
  return fabsf(__uint_as_float(u.x)) + fabsf(__uint_as_float(u.y)) +
         fabsf(__uint_as_float(u.z)) + fabsf(__uint_as_float(u.w));
}
// A bf16 value is the high half of the f32 with the same bits.
__device__ __forceinline__ float bf16_pair_abs_sum(unsigned w) {
  return fabsf(__uint_as_float(w << 16)) +
         fabsf(__uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float vec_abs_sum(uint4 u, __nv_bfloat16) {
  return bf16_pair_abs_sum(u.x) + bf16_pair_abs_sum(u.y) +
         bf16_pair_abs_sum(u.z) + bf16_pair_abs_sum(u.w);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
chunk_l1norm_kernel(const T* __restrict__ pool, long long num_chunks,
                    long long chunk, float* __restrict__ norms) {
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long c = blockIdx.x; c < num_chunks; c += gridDim.x) {
    const T* row = pool + c * chunk;
    float acc = 0.f;
    if (kVec) {
      constexpr int kPerVec = 16 / sizeof(T);
      const uint4* vrow = reinterpret_cast<const uint4*>(row);
      const long long nvec = chunk / kPerVec;
#pragma unroll 4
      for (long long i = threadIdx.x; i < nvec; i += kThreads)
        acc += vec_abs_sum(vrow[i], T());
    } else {
      for (long long i = threadIdx.x; i < chunk; i += kThreads)
        acc += fabsf(to_float(row[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
      norms[c] = s;
    }
    __syncthreads();  // warp_sums is reused by the block's next chunk
  }
}

template <typename T>
void launch(const void* pool, long long num_chunks, long long chunk,
            float* norms, cudaStream_t stream) {
  const int grid = static_cast<int>(num_chunks < kMaxBlocks ? num_chunks
                                                            : kMaxBlocks);
  const bool vec = (chunk * static_cast<long long>(sizeof(T))) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(pool) % 16 == 0;
  const T* p = static_cast<const T*>(pool);
  if (vec)
    chunk_l1norm_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        p, num_chunks, chunk, norms);
  else
    chunk_l1norm_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        p, num_chunks, chunk, norms);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for bad arguments.
extern "C" int chunk_l1norm_launch(const void* pool, long long num_chunks,
                                   long long chunk_elems, int dtype,
                                   void* norms, void* stream) {
  if (num_chunks <= 0 || chunk_elems <= 0 || dtype < 0 || dtype > 1 ||
      pool == nullptr || norms == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(norms);
  if (dtype == 0)
    launch<float>(pool, num_chunks, chunk_elems, out, s);
  else
    launch<__nv_bfloat16>(pool, num_chunks, chunk_elems, out, s);
  return static_cast<int>(cudaGetLastError());
}
