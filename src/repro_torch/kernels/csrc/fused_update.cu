// Fused momentum-SGD update for Hopper (sm_90a): the port of the Pallas
// kernel repro/kernels/fused_update.py::fused_update (body _kernel, math
// update_math).
//
// Per element of a flat pool: g = grads + wd*master, times scale when one
// is given; u = m*mom + lr*g; new_mom = mask ? u : mom; new_master =
// mask ? master - u : master. Each step rounds on its own (__fmul_rn /
// __fadd_rn / __fsub_rn), as in pool_unpack.cu, so nvcc cannot contract a
// multiply-add into an FMA and the result equals the plain PyTorch version
// bit for bit. The optional scale is a separate template instance.
//
// Bound: bytes. An element reads master, grads and momentum (4 B each), the
// mask (1 B) and the scale when given (4 B), and writes the new master and
// momentum (4 B each): 21 B, or 25 B with the scale, for seven flops.
// Design: a grid-stride loop in which each thread moves four elements with
// 16-byte loads and stores (float4; the four mask bytes as one 32-bit
// word) when every pointer is 16-byte aligned; the ragged tail, and
// unaligned pools, take one element at a time.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;

struct Out2 {
  float w, m;
};

__device__ __forceinline__ Out2 step(float w, float g, float m, bool on,
                                     float s, bool has_scale, float lr,
                                     float momentum, float wd) {
  g = __fadd_rn(g, __fmul_rn(wd, w));
  if (has_scale) g = __fmul_rn(g, s);
  const float u = __fadd_rn(__fmul_rn(momentum, m), __fmul_rn(lr, g));
  return Out2{on ? __fsub_rn(w, u) : w, on ? u : m};
}

template <bool kScale, bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(long long n, const float* __restrict__ master,
                    const float* __restrict__ grads,
                    const float* __restrict__ mom,
                    const unsigned char* __restrict__ mask,
                    const float* __restrict__ scale,
                    const float* __restrict__ lr_ptr, float momentum,
                    float wd, float* __restrict__ new_master,
                    float* __restrict__ new_mom) {
  const float lr = *lr_ptr;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x;
         i < n4; i += stride) {
      const float4 w = reinterpret_cast<const float4*>(master)[i];
      const float4 g = reinterpret_cast<const float4*>(grads)[i];
      const float4 m = reinterpret_cast<const float4*>(mom)[i];
      const unsigned int k = reinterpret_cast<const unsigned int*>(mask)[i];
      float4 s = make_float4(1.f, 1.f, 1.f, 1.f);
      if (kScale) s = reinterpret_cast<const float4*>(scale)[i];
      const Out2 a = step(w.x, g.x, m.x, k & 0xFFu, s.x, kScale, lr,
                          momentum, wd);
      const Out2 b = step(w.y, g.y, m.y, (k >> 8) & 0xFFu, s.y, kScale, lr,
                          momentum, wd);
      const Out2 c = step(w.z, g.z, m.z, (k >> 16) & 0xFFu, s.z, kScale, lr,
                          momentum, wd);
      const Out2 d = step(w.w, g.w, m.w, k >> 24, s.w, kScale, lr, momentum,
                          wd);
      reinterpret_cast<float4*>(new_master)[i] = make_float4(a.w, b.w, c.w,
                                                             d.w);
      reinterpret_cast<float4*>(new_mom)[i] = make_float4(a.m, b.m, c.m,
                                                          d.m);
    }
    done = n4 * 4;
  }
  for (long long p = done + blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       p < n; p += stride) {
    const Out2 r = step(master[p], grads[p], mom[p], mask[p] != 0,
                        kScale ? scale[p] : 1.f, kScale, lr, momentum, wd);
    new_master[p] = r.w;
    new_mom[p] = r.m;
  }
}

template <bool kScale>
void launch(bool vec, int grid, cudaStream_t s, long long n,
            const float* w, const float* g, const float* m,
            const unsigned char* k, const float* sc, const float* lr,
            float momentum, float wd, float* nw, float* nm) {
  if (vec)
    fused_update_kernel<kScale, true><<<grid, kThreads, 0, s>>>(
        n, w, g, m, k, sc, lr, momentum, wd, nw, nm);
  else
    fused_update_kernel<kScale, false><<<grid, kThreads, 0, s>>>(
        n, w, g, m, k, sc, lr, momentum, wd, nw, nm);
}

}  // namespace

// n elements; scale may be null; lr points to one f32 on the device.
// new_master / new_mom must not overlap the inputs (every pointer is
// __restrict__). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for bad arguments.
extern "C" int fused_update_launch(long long n, const void* master,
                                   const void* grads, const void* mom,
                                   const void* mask, const void* scale,
                                   const void* lr, float momentum, float wd,
                                   void* new_master, void* new_mom,
                                   void* stream) {
  if (n <= 0 || !master || !grads || !mom || !mask || !lr || !new_master ||
      !new_mom)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long align =
      reinterpret_cast<unsigned long long>(master) |
      reinterpret_cast<unsigned long long>(grads) |
      reinterpret_cast<unsigned long long>(mom) |
      reinterpret_cast<unsigned long long>(new_master) |
      reinterpret_cast<unsigned long long>(new_mom) |
      (reinterpret_cast<unsigned long long>(scale) & 15ULL);
  // The mask needs 4-byte alignment for its 32-bit word of four flags.
  const bool vec = align % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(mask) % 4 == 0;
  long long work = vec ? (n / 4 + kThreads - 1) / kThreads
                       : (n + kThreads - 1) / kThreads;
  if (work < 1) work = 1;
  const int grid = static_cast<int>(work < kMaxBlocks ? work : kMaxBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(master);
  const float* g = static_cast<const float*>(grads);
  const float* m = static_cast<const float*>(mom);
  const unsigned char* k = static_cast<const unsigned char*>(mask);
  const float* sc = static_cast<const float*>(scale);
  const float* l = static_cast<const float*>(lr);
  float* nw = static_cast<float*>(new_master);
  float* nm = static_cast<float*>(new_mom);
  if (scale != nullptr)
    launch<true>(vec, grid, s, n, w, g, m, k, sc, l, momentum, wd, nw, nm);
  else
    launch<false>(vec, grid, s, n, w, g, m, k, sc, l, momentum, wd, nw, nm);
  return static_cast<int>(cudaGetLastError());
}
