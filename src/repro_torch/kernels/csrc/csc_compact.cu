// CSC chunk gather for Hopper (sm_90a): the port of the Pallas kernel
// repro/kernels/csc_compact.py::csc_compact (body _kernel).
//
// wire[j] = pool_chunks[idx[j]] for the k selected chunk ids: packs the
// chunks CSC transmits into one dense wire buffer. Pure data movement, so
// the copy works on raw bytes and the result is bit-exact for any dtype.
//
// Bound: bytes. Each selected row is read once and written once:
// 2 x k x 32768 x 4 B at f32, 0.048 ms at k = 616 and 0.253 ms at k = 3233 on
// 3.35 TB/s; no arithmetic. Design: a 2-D grid, blockIdx.x the output row j
// and blockIdx.y a slice of the row. The TPU kernel prefetched the indices
// into SMEM ahead of the grid; here each block loads its own index. An index
// outside [0, C) traps the kernel (the launch's stream then reports an
// error) instead of reading out of bounds. Copies use the widest unit, up to
// 16 bytes, that divides the row's bytes and both base addresses; each
// thread loads kUnitsPerThread units into registers before it stores any, so
// that many loads are in flight at once.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 8;
constexpr long long kMaxSlices = 65535;

template <typename U>
__global__ void __launch_bounds__(kThreads)
csc_compact_kernel(const U* __restrict__ src, const long long* __restrict__ idx,
                   long long num_chunks, long long row_units,
                   U* __restrict__ dst) {
  const long long j = blockIdx.x;
  const long long c = idx[j];
  if (c < 0 || c >= num_chunks) __trap();
  const U* s = src + c * row_units;
  U* d = dst + j * row_units;
  constexpr long long kSpan = static_cast<long long>(kThreads) *
                              kUnitsPerThread;
  for (long long base = blockIdx.y * kSpan; base < row_units;
       base += gridDim.y * kSpan) {
    U v[kUnitsPerThread];
#pragma unroll
    for (int i = 0; i < kUnitsPerThread; ++i) {
      const long long u = base + i * kThreads + threadIdx.x;
      if (u < row_units) v[i] = s[u];
    }
#pragma unroll
    for (int i = 0; i < kUnitsPerThread; ++i) {
      const long long u = base + i * kThreads + threadIdx.x;
      if (u < row_units) d[u] = v[i];
    }
  }
}

template <typename U>
void launch(const void* src, const long long* idx, long long k,
            long long num_chunks, long long row_bytes, void* dst,
            cudaStream_t stream) {
  const long long row_units = row_bytes / static_cast<long long>(sizeof(U));
  const long long span = static_cast<long long>(kThreads) * kUnitsPerThread;
  long long slices = (row_units + span - 1) / span;
  if (slices > kMaxSlices) slices = kMaxSlices;
  const dim3 grid(static_cast<unsigned>(k), static_cast<unsigned>(slices));
  csc_compact_kernel<U><<<grid, kThreads, 0, stream>>>(
      static_cast<const U*>(src), idx, num_chunks, row_units,
      static_cast<U*>(dst));
}

}  // namespace

// Gathers k rows of row_bytes each from a pool of num_chunks rows. idx is
// int64 on the device. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for bad arguments.
extern "C" int csc_compact_launch(const void* pool, const void* idx,
                                  long long k, long long num_chunks,
                                  long long row_bytes, void* out,
                                  void* stream) {
  if (k <= 0 || k > 0x7fffffffLL || num_chunks <= 0 || row_bytes <= 0 ||
      pool == nullptr || idx == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long align =
      reinterpret_cast<unsigned long long>(pool) |
      reinterpret_cast<unsigned long long>(out) |
      static_cast<unsigned long long>(row_bytes);
  const long long* ids = static_cast<const long long*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0)
    launch<uint4>(pool, ids, k, num_chunks, row_bytes, out, s);
  else if (align % 8 == 0)
    launch<uint2>(pool, ids, k, num_chunks, row_bytes, out, s);
  else if (align % 4 == 0)
    launch<unsigned int>(pool, ids, k, num_chunks, row_bytes, out, s);
  else if (align % 2 == 0)
    launch<unsigned short>(pool, ids, k, num_chunks, row_bytes, out, s);
  else
    launch<unsigned char>(pool, ids, k, num_chunks, row_bytes, out, s);
  return static_cast<int>(cudaGetLastError());
}
