// Gradient-pool pack for Hopper (sm_90a): the port of the Pallas kernel
// repro/kernels/pool_pack.py::pool_pack (body _kernel).
//
// Gathers the 1-D leaves into the padded pool at their offsets, casts each
// value to the wire dtype (bf16 rounds to nearest even), writes zeros past
// the last leaf and, with chunk_elems > 0, writes the per-chunk f32 L1
// census of the wire values.
//
// Bound: bytes. Each element is read once in the source dtype and written
// once in the wire dtype (6 B for f32 -> bf16, 8 B for f32 -> f32); the
// arithmetic is one cast and one add. Design: blocks walk pool tiles in a
// grid-stride loop; consecutive threads touch consecutive pool elements, so
// both the leaf reads and the pool writes are coalesced. A block finds the
// first segment of its tile by binary search over the segment table; each
// thread then advances its own cursor as its elements cross leaf ends. With
// a census each tile is one chunk, and the block reduces its threads'
// partial sums with a fixed-order tree in shared memory, so the census is
// deterministic. Vectorised 16-byte access and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;     // 64 census values a thread per chunk
constexpr long long kTile = 8192;     // pool elements per tile, no census
constexpr long long kMaxBlocks = 132 * 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Index of the first segment whose end lies past element p (segment ends
// are non-decreasing); n when p lies past every segment.
__device__ int first_segment(const long long* offsets, const long long* sizes,
                             int n, long long p) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (offsets[mid] + sizes[mid] <= p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// table = [leaf pointers | offsets | sizes], n entries each.
template <typename SrcT, typename WireT>
__global__ void __launch_bounds__(kThreads)
pool_pack_kernel(const long long* __restrict__ table, int n, long long covered,
                 long long pool_size, long long tile, long long num_tiles,
                 WireT* __restrict__ out, float* __restrict__ norms) {
  const long long* ptrs = table;
  const long long* offsets = table + n;
  const long long* sizes = table + 2 * n;
  __shared__ int first;
  __shared__ float partial[kThreads];
  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long long start = t * tile;
    const long long end = min(start + tile, pool_size);
    if (threadIdx.x == 0) first = first_segment(offsets, sizes, n, start);
    __syncthreads();
    int seg = first;
    float acc = 0.f;
    for (long long p = start + threadIdx.x; p < end; p += kThreads) {
      while (seg < n && offsets[seg] + sizes[seg] <= p) ++seg;
      float v = 0.f;
      if (p < covered) {
        const SrcT* src = reinterpret_cast<const SrcT*>(ptrs[seg]);
        v = to_float(src[p - offsets[seg]]);
      }
      const WireT w = from_float<WireT>(v);
      out[p] = w;
      acc += fabsf(to_float(w));
    }
    if (norms != nullptr) {
      partial[threadIdx.x] = acc;
      __syncthreads();
      for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) partial[threadIdx.x] += partial[threadIdx.x + s];
        __syncthreads();
      }
      if (threadIdx.x == 0) norms[t] = partial[0];
    }
    __syncthreads();  // `first` and `partial` are reused by the next tile
  }
}

template <typename SrcT, typename WireT>
void launch(const long long* table, int n, long long covered,
            long long pool_size, long long tile, long long num_tiles,
            void* out, float* norms, cudaStream_t stream) {
  const int grid = static_cast<int>(num_tiles < kMaxBlocks ? num_tiles
                                                           : kMaxBlocks);
  pool_pack_kernel<SrcT, WireT><<<grid, kThreads, 0, stream>>>(
      table, n, covered, pool_size, tile, num_tiles,
      static_cast<WireT*>(out), norms);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for bad arguments.
extern "C" int pool_pack_launch(const void* table, int n_leaves,
                                long long covered, long long pool_size,
                                int src_dtype, int wire_dtype, void* out,
                                void* norms, long long chunk_elems,
                                void* stream) {
  if (pool_size <= 0 || n_leaves < 0 || covered > pool_size ||
      (chunk_elems > 0 && pool_size % chunk_elems != 0) ||
      src_dtype < 0 || src_dtype > 1 || wire_dtype < 0 || wire_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tile = chunk_elems > 0 ? chunk_elems : kTile;
  const long long num_tiles = (pool_size + tile - 1) / tile;
  const long long* tab = static_cast<const long long*>(table);
  float* nrm = chunk_elems > 0 ? static_cast<float*>(norms) : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_dtype == 0 && wire_dtype == 0)
    launch<float, float>(tab, n_leaves, covered, pool_size, tile, num_tiles,
                         out, nrm, s);
  else if (src_dtype == 0 && wire_dtype == 1)
    launch<float, __nv_bfloat16>(tab, n_leaves, covered, pool_size, tile,
                                 num_tiles, out, nrm, s);
  else if (src_dtype == 1 && wire_dtype == 0)
    launch<__nv_bfloat16, float>(tab, n_leaves, covered, pool_size, tile,
                                 num_tiles, out, nrm, s);
  else
    launch<__nv_bfloat16, __nv_bfloat16>(tab, n_leaves, covered, pool_size,
                                         tile, num_tiles, out, nrm, s);
  return static_cast<int>(cudaGetLastError());
}
