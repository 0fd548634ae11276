// Pool unpack + momentum-SGD update for Hopper (sm_90a): the port of the
// Pallas kernel repro/kernels/pool_unpack.py::pool_unpack_update (body
// _kernel, math fused_update.update_math).
//
// Per element: g = grads + wd*master, times scale (per element) or the
// owning tensor's ratio (per tensor; padding takes the trailing ratio if
// one is passed, else 1.0); u = m*mom + lr*g; new_mom = mask ? u : mom;
// new_master = mask ? master - u : master. new_mom goes to mom_out (which
// may alias mom_in: each element is read and written by one thread);
// new_master goes straight into the leaf that owns the element, so the new
// master pool is never written. Padding has no leaf and is not written.
//
// The guard's predicate: `ok` (one device byte, may be null) is the
// step's health verdict. When it is false every CTA returns before it
// reads or writes anything else, so a rejected step leaves the leaves and
// the momentum as they were (the caller must pass the live parameters and
// momentum as the outputs) without a pool-sized select pass.
//
// Each step rounds on its own (__fmul_rn / __fadd_rn / __fsub_rn), so nvcc
// cannot contract a multiply-add into an FMA and the result matches the
// plain PyTorch version bit for bit.
//
// Bound: bytes. An element reads master, grads and momentum (4 B each) and
// the mask (1 B), and writes the momentum and the leaf (4 B each): 21 B for
// seven flops. Design: grid-stride over pool tiles, consecutive threads on
// consecutive elements (coalesced reads and writes; leaf writes stay
// contiguous within a leaf), first segment of a tile by binary search,
// then a per-thread cursor across leaf ends. Vectorised 16-byte access is
// later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kTile = 8192;
constexpr long long kMaxBlocks = 132 * 16;

__device__ int first_segment(const long long* offsets, const long long* sizes,
                             int n, long long p) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (offsets[mid] + sizes[mid] <= p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// table = [leaf pointers | offsets | sizes], n entries each; leaves are f32.
__global__ void __launch_bounds__(kThreads)
pool_unpack_update_kernel(const long long* __restrict__ table, int n,
                          long long covered, long long size,
                          long long num_tiles,
                          const float* __restrict__ master,
                          const float* __restrict__ grads,
                          const float* mom_in, float* mom_out,
                          const unsigned char* __restrict__ mask,
                          const float* __restrict__ lr_ptr, float momentum,
                          float weight_decay,
                          const float* __restrict__ scale,
                          const float* __restrict__ ratios, int n_ratios,
                          const unsigned char* __restrict__ ok) {
  if (ok != nullptr && *ok == 0) return;
  const long long* ptrs = table;
  const long long* offsets = table + n;
  const long long* sizes = table + 2 * n;
  const float lr = *lr_ptr;
  const float pad_ratio = (ratios != nullptr && n_ratios > n) ? ratios[n]
                                                              : 1.0f;
  __shared__ int first;
  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long long start = t * kTile;
    const long long end = min(start + kTile, size);
    if (threadIdx.x == 0) first = first_segment(offsets, sizes, n, start);
    __syncthreads();
    int seg = first;
    for (long long p = start + threadIdx.x; p < end; p += kThreads) {
      while (seg < n && offsets[seg] + sizes[seg] <= p) ++seg;
      const bool in_leaf = p < covered;
      const float w = master[p];
      float g = __fadd_rn(grads[p], __fmul_rn(weight_decay, w));
      if (scale != nullptr) {
        g = __fmul_rn(g, scale[p]);
      } else if (ratios != nullptr) {
        g = __fmul_rn(g, in_leaf ? ratios[seg] : pad_ratio);
      }
      const float m = mom_in[p];
      const float u = __fadd_rn(__fmul_rn(momentum, m), __fmul_rn(lr, g));
      const bool on = mask[p] != 0;
      mom_out[p] = on ? u : m;
      if (in_leaf) {
        float* dst = reinterpret_cast<float*>(ptrs[seg]);
        dst[p - offsets[seg]] = on ? __fsub_rn(w, u) : w;
      }
    }
    __syncthreads();  // `first` is reused by the next tile
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for bad arguments. scale and ratios may be null
// (at most one is given); lr points to one f32 on the device; ok is null
// (unguarded) or one bool byte on the device.
extern "C" int pool_unpack_update_launch(
    const void* table, int n_leaves, long long covered, long long size,
    const void* master, const void* grads, const void* mom_in, void* mom_out,
    const void* mask, const void* lr, float momentum, float weight_decay,
    const void* scale, const void* ratios, int n_ratios, const void* ok,
    void* stream) {
  if (size <= 0 || n_leaves < 0 || covered > size ||
      (scale != nullptr && ratios != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long num_tiles = (size + kTile - 1) / kTile;
  const int grid = static_cast<int>(num_tiles < kMaxBlocks ? num_tiles
                                                           : kMaxBlocks);
  pool_unpack_update_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n_leaves, covered, size,
      num_tiles, static_cast<const float*>(master),
      static_cast<const float*>(grads), static_cast<const float*>(mom_in),
      static_cast<float*>(mom_out), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(lr), momentum, weight_decay,
      static_cast<const float*>(scale), static_cast<const float*>(ratios),
      n_ratios, static_cast<const unsigned char*>(ok));
  return static_cast<int>(cudaGetLastError());
}
