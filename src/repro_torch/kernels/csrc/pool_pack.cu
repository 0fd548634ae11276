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
// arithmetic is one cast (and one add for the census). The pools do not
// fit in the 50 MB L2, so the design is about keeping enough 16-byte
// accesses in flight and spending nothing else on device memory:
// - Tiles. Blocks walk pool tiles in a grid-stride loop (two blocks an SM,
//   512 threads each). A tile is kTile elements, or one chunk with a
//   census.
// - Segment runs in shared memory. Thread 0 finds the segment that holds
//   the tile's first element by binary search over the table; the block
//   then stages the runs that cross the tile (pointer, pool offset, size;
//   a prefix of the table from there, up to kMaxRuns) in shared memory, so
//   no element reads the table from device memory. A tile crossed by more
//   runs reads them from the table instead (same code, other pointers).
// - Groups. A thread moves aligned groups of 8 pool elements (consecutive
//   threads, consecutive groups: coalesced), kInFlight groups' loads
//   before their stores. A group inside one leaf whose source is 16-byte
//   aligned goes as vectors: two float4 loads (f32 source) or one uint4
//   (bf16), and one (bf16 wire) or two (f32 wire) 16-byte stores to a
//   16-byte aligned destination. Padding groups are zero vectors. A group
//   that straddles a leaf end or the last leaf's end, or whose source or
//   destination is misaligned, goes element by element. Offsets are back
//   to back, so a leaf whose size is not a multiple of 8 sends its
//   neighbours' groups down that path; smollm-135m's leaves all take the
//   vector path.
// - Streaming hints: loads are __ldcs and stores __stcs (each byte is
//   touched once).
// - Census: each tile is one chunk; a thread sums its groups' wire values
//   in a fixed order and the block reduces its threads' sums with a
//   fixed-order tree in shared memory, so the census is the same bits on
//   every launch (no atomics).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kGroup = 8;            // pool elements a thread moves at once
constexpr int kInFlight = 4;         // groups loaded before their stores
constexpr long long kTile = 32768;   // pool elements per tile, no census
constexpr int kMaxRuns = 256;        // segment runs staged per tile
constexpr int kBlocksPerSm = 2;
static_assert(kMaxRuns < kThreads, "thread kMaxRuns probes for overflow");

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

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// Eight source elements from a 16-byte aligned address.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// Eight wire elements to a 16-byte aligned address.
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1,
         make_float4(v[4], v[5], v[6], v[7]));
}
__device__ __forceinline__ unsigned int bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[8]) {
  unsigned int w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = bf16_bits(v[2 * i]) | (bf16_bits(v[2 * i + 1]) << 16);
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
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

// The tile's segment runs: pointers, pool offsets and sizes of `count`
// runs in pool order (in shared memory, or in the table).
struct Runs {
  const long long* ptr;
  const long long* off;
  const long long* size;
  int count;
};

// Loads the group of `cnt` <= 8 pool elements at p0 into v (zeros past
// the last leaf). `cur` is the thread's run cursor: a thread's groups only
// move forward through the pool.
template <typename SrcT>
__device__ __forceinline__ void load_group(float (&v)[8], long long p0,
                                           int cnt, long long covered,
                                           const Runs& runs, int& cur) {
  if (p0 >= covered) {
#pragma unroll
    for (int q = 0; q < kGroup; ++q) v[q] = 0.f;
    return;
  }
  while (cur + 1 < runs.count && runs.off[cur] + runs.size[cur] <= p0) ++cur;
  const long long off = runs.off[cur];
  const SrcT* src = reinterpret_cast<const SrcT*>(runs.ptr[cur]) + (p0 - off);
  if (cnt == kGroup && p0 + kGroup <= off + runs.size[cur] &&
      aligned16(src)) {
    load8(src, v);
    return;
  }
  int r = cur;
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    const long long p = p0 + q;
    v[q] = 0.f;
    if (q < cnt && p < covered) {
      while (r + 1 < runs.count && runs.off[r] + runs.size[r] <= p) ++r;
      v[q] = to_float(
          reinterpret_cast<const SrcT*>(runs.ptr[r])[p - runs.off[r]]);
    }
  }
}

// Stores the group at p0 in the wire dtype; returns the L1 sum of its
// wire values (kCensus) in element order.
template <typename WireT, bool kCensus>
__device__ __forceinline__ float store_group(WireT* out, long long p0,
                                             int cnt, const float (&v)[8],
                                             float acc) {
  WireT* dst = out + p0;
  if (cnt == kGroup && aligned16(dst)) {
    store8(dst, v);
  } else {
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
      if (q < cnt) dst[q] = from_float<WireT>(v[q]);
  }
  if (kCensus) {
#pragma unroll
    for (int q = 0; q < kGroup; ++q)
      if (q < cnt) acc += fabsf(to_float(from_float<WireT>(v[q])));
  }
  return acc;
}

// table = [leaf pointers | offsets | sizes], n entries each.
template <typename SrcT, typename WireT, bool kCensus>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
pool_pack_kernel(const long long* __restrict__ table, int n, long long covered,
                 long long pool_size, long long tile, long long num_tiles,
                 WireT* __restrict__ out, float* __restrict__ norms) {
  const long long* ptrs = table;
  const long long* offsets = table + n;
  const long long* sizes = table + 2 * n;
  __shared__ long long run_ptr[kMaxRuns], run_off[kMaxRuns],
      run_size[kMaxRuns];
  __shared__ int first_run;
  __shared__ float partial[kThreads];
  const int tid = threadIdx.x;
  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long long start = t * tile;
    const long long end = min(start + tile, pool_size);
    const long long live = min(end, covered);  // past it: padding
    if (tid == 0)
      first_run = start < covered ? first_segment(offsets, sizes, n, start)
                                  : n;
    __syncthreads();
    // The runs that cross [start, live) are a prefix of the table from
    // `first`; thread kMaxRuns only probes whether there are more.
    const int first = first_run;
    const int i = first + tid;
    const bool crosses = tid <= kMaxRuns && i < n && offsets[i] < live;
    if (crosses && tid < kMaxRuns) {
      run_ptr[tid] = ptrs[i];
      run_off[tid] = offsets[i];
      run_size[tid] = sizes[i];
    }
    const int count = __syncthreads_count(crosses);
    const Runs runs = count <= kMaxRuns
                          ? Runs{run_ptr, run_off, run_size, count}
                          : Runs{ptrs + first, offsets + first, sizes + first,
                                 n - first};
    float acc = 0.f;
    int cur = 0;
    const long long groups = (end - start + kGroup - 1) / kGroup;
    for (long long g0 = tid; g0 < groups; g0 += kThreads * kInFlight) {
      float v[kInFlight][kGroup];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const long long g = g0 + u * kThreads;
        if (g < groups) {
          const long long p0 = start + g * kGroup;
          load_group<SrcT>(v[u], p0, static_cast<int>(min(
                               static_cast<long long>(kGroup), end - p0)),
                           covered, runs, cur);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const long long g = g0 + u * kThreads;
        if (g < groups) {
          const long long p0 = start + g * kGroup;
          acc = store_group<WireT, kCensus>(
              out, p0, static_cast<int>(min(static_cast<long long>(kGroup),
                                            end - p0)),
              v[u], acc);
        }
      }
    }
    if (kCensus) {
      partial[tid] = acc;
      __syncthreads();
      for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (tid < s) partial[tid] += partial[tid + s];
        __syncthreads();
      }
      if (tid == 0) norms[t] = partial[0];
    }
    // No barrier here: every thread has read first_run before the count
    // barrier above, and the next tile stages its runs only after its
    // first barrier, which every thread reaches after its last read here.
  }
}

template <typename SrcT, typename WireT>
int launch(const long long* table, int n, long long covered,
           long long pool_size, long long tile, long long num_tiles,
           void* out, float* norms, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const int grid = static_cast<int>(num_tiles < cap ? num_tiles : cap);
  WireT* o = static_cast<WireT*>(out);
  if (norms != nullptr)
    pool_pack_kernel<SrcT, WireT, true><<<grid, kThreads, 0, stream>>>(
        table, n, covered, pool_size, tile, num_tiles, o, norms);
  else
    pool_pack_kernel<SrcT, WireT, false><<<grid, kThreads, 0, stream>>>(
        table, n, covered, pool_size, tile, num_tiles, o, nullptr);
  return static_cast<int>(cudaGetLastError());
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
    return launch<float, float>(tab, n_leaves, covered, pool_size, tile,
                                num_tiles, out, nrm, s);
  if (src_dtype == 0 && wire_dtype == 1)
    return launch<float, __nv_bfloat16>(tab, n_leaves, covered, pool_size,
                                        tile, num_tiles, out, nrm, s);
  if (src_dtype == 1 && wire_dtype == 0)
    return launch<__nv_bfloat16, float>(tab, n_leaves, covered, pool_size,
                                        tile, num_tiles, out, nrm, s);
  return launch<__nv_bfloat16, __nv_bfloat16>(tab, n_leaves, covered,
                                               pool_size, tile, num_tiles,
                                               out, nrm, s);
}
