// Grouped matrix products over the experts one chip holds (Hopper,
// sm_90a): moe_gmm_fwd (Y = X W_e over each expert's rows of X; dX =
// dY W_e^T is the same kernel reading W transposed) and moe_gmm_dw
// (dW_e = X_e^T dY_e, summed over the expert's rows).
//
// Replaces no Pallas kernel: the JAX package's MoE layer runs its experts
// as one batched product over capacity-bounded buffers. Added for afmoe's
// dropless routing (models/layers/moe.py:apply_sigmoid): a chip's slots
// are sorted by expert, and each expert's rows, however many the routing
// sends, go through its own weights with nothing dropped and no padding
// computed.
//
// Bound: the tensor cores. At the benchmark's shapes (32 experts of
// 2048 x 1024, ~2,048 rows an expert) a product does 2 R d f FLOPs
// against (R (d + f) + E d f) x 2 bytes, ~680 FLOP a byte, above the
// card's ~295 ridge. Design: one CTA of 8 warps a 128 x 256 output tile,
// bf16 operands through a ring of 3 stages of 64-deep tiles in shared
// memory fed by cp.async (16 bytes a thread, zero-filled past the
// operands' edges), each warp a 64 x 64 block of the tile in 16 x 16 x 16
// WMMA products (mma.sync) summed in f32; lines of the ring are padded by
// 16 bytes, so the fragment loads hit every bank once. The f32 tile is
// staged through shared memory and rounded to bf16 once, written 16
// bytes a thread. One CTA an SM (~160 KB of shared memory). Of the tiles
// measured at the benchmark's shapes (PERF.md, kernel table), 128 x 256 x
// 64 ran 8-19 % faster than 128 x 128 at 32 or 64 deep with two CTAs an
// SM; all run far below the tensor cores' rate, which takes wgmma fed by
// TMA on Hopper.
//
// Rows are sorted by expert: expert e owns rows offs[e] ..
// offs[e] + counts[e] - 1, and tile_end[e] is the inclusive cumulative sum
// of its ceil(counts[e] / 128) row tiles; all three are int32 device
// arrays of E entries, so nothing is read back to the host and a CUDA
// graph captures the launch. The forward's grid is static and covers the
// worst case, every row on one expert plus a partial tile at each
// expert's end: ceil(R / 128) + E + 1 row tiles. A CTA finds its expert
// from tile_end; the tiles past the last expert's write zeros over the
// rows no held expert takes (the slots routed to other chips), so those
// rows read 0 and pass a zero gradient on, and the CTAs past them exit.
// dW has one CTA an (N tile, K tile, expert), which sums the expert's rows
// in order: no atomics, every output element is written by one CTA, so a
// run repeats bit for bit; an expert without rows writes zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kThreads = 256;                 // 8 warps, 2 x 4 over a tile
constexpr int kTileM = 128, kTileN = 256, kTileK = 64;
constexpr int kStages = 3;
constexpr int kPad = 8;                       // bf16 elements a line
constexpr int kWarpM = 64, kWarpN = 64;
constexpr int kFragM = kWarpM / 16, kFragN = kWarpN / 16;
constexpr int kCLd = kTileN + 4;              // f32 staging of the output
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One tile of kLines lines of kWidth elements into shared memory (lines
// kWidth + kPad apart): line l, column c from g[l * stride + c], zeros
// where l >= lines or c >= width (width a multiple of 8). safe is an
// address of the operand that a zero-filled copy names instead.
template <int kLines, int kWidth>
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* g,
                                          long long stride, int lines,
                                          int width, const bf16* safe) {
  constexpr int kPerLine = kWidth / 8;
  constexpr int kChunks = kLines * kPerLine;
  static_assert(kChunks % kThreads == 0, "tile chunks per thread");
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int line = c / kPerLine, col = (c % kPerLine) * 8;
    const bool ok = line < lines && col < width;
    cp_async16(smem + line * (kWidth + kPad) + col,
               ok ? g + line * stride + col : safe, ok);
  }
}

// C (kTileM x kTileN) = sum over k < kred of A(m, k) B(k, n), A and B in
// bf16, C in f32 in each warp's fragments. A(m, k) is a[m * lda + k], or
// a[k * lda + m] when kAT; B(k, n) is b[k * ldb + n], or b[n * ldb + k]
// when kBT. Rows m >= m_valid and columns n >= n_valid read zeros.
template <bool kAT, bool kBT>
struct Tile {
  static constexpr int kALines = kAT ? kTileK : kTileM;
  static constexpr int kAWidth = kAT ? kTileM : kTileK;
  static constexpr int kBLines = kBT ? kTileN : kTileK;
  static constexpr int kBWidth = kBT ? kTileK : kTileN;
  static constexpr int kAElems = kALines * (kAWidth + kPad);
  static constexpr int kBElems = kBLines * (kBWidth + kPad);
  static constexpr int kStageElems = kAElems + kBElems;
  static constexpr int kRingBytes = kStages * kStageElems * 2;
  static constexpr int kOutBytes = kTileM * kCLd * 4;
  static constexpr int kSmemBytes =
      kRingBytes > kOutBytes ? kRingBytes : kOutBytes;
  using ALayout =
      typename std::conditional<kAT, wmma::col_major, wmma::row_major>::type;
  using BLayout =
      typename std::conditional<kBT, wmma::col_major, wmma::row_major>::type;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  __device__ static void load_stage(bf16* st, const bf16* a, long long lda,
                                    const bf16* b, long long ldb, int k0,
                                    int kred, int m_valid, int n_valid) {
    const int kleft = kred - k0;
    if (kAT)
      load_tile<kALines, kAWidth>(st, a + k0 * lda, lda, kleft, m_valid, a);
    else
      load_tile<kALines, kAWidth>(st, a + k0, lda, m_valid, kleft, a);
    if (kBT)
      load_tile<kBLines, kBWidth>(st + kAElems, b + k0, ldb, n_valid, kleft,
                                  b);
    else
      load_tile<kBLines, kBWidth>(st + kAElems, b + k0 * ldb, ldb, kleft,
                                  n_valid, b);
  }

  __device__ static void run(bf16* smem, const bf16* a, long long lda,
                             const bf16* b, long long ldb, int kred,
                             int m_valid, int n_valid,
                             Acc (&acc)[kFragM][kFragN]) {
    const int warp = threadIdx.x / 32;
    const int wm0 = (warp / 4) * kWarpM, wn0 = (warp % 4) * kWarpN;
#pragma unroll
    for (int i = 0; i < kFragM; ++i)
#pragma unroll
      for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    const int steps = (kred + kTileK - 1) / kTileK;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < steps)
        load_stage(smem + s * kStageElems, a, lda, b, ldb, s * kTileK, kred,
                   m_valid, n_valid);
      cp_async_commit();
    }
    for (int t = 0; t < steps; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      // The stage refilled here was read in step t - 1, which every warp
      // has finished at the barrier above.
      const int next = t + kStages - 1;
      if (next < steps)
        load_stage(smem + (next % kStages) * kStageElems, a, lda, b, ldb,
                   next * kTileK, kred, m_valid, n_valid);
      cp_async_commit();
      const bf16* as = smem + (t % kStages) * kStageElems;
      const bf16* bs = as + kAElems;
#pragma unroll
      for (int kk = 0; kk < kTileK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[kFragM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[kFragN];
#pragma unroll
        for (int i = 0; i < kFragM; ++i) {
          const int m = wm0 + i * 16;
          if (kAT)
            wmma::load_matrix_sync(fa[i], as + kk * (kAWidth + kPad) + m,
                                   kAWidth + kPad);
          else
            wmma::load_matrix_sync(fa[i], as + m * (kAWidth + kPad) + kk,
                                   kAWidth + kPad);
        }
#pragma unroll
        for (int j = 0; j < kFragN; ++j) {
          const int n = wn0 + j * 16;
          if (kBT)
            wmma::load_matrix_sync(fb[j], bs + n * (kBWidth + kPad) + kk,
                                   kBWidth + kPad);
          else
            wmma::load_matrix_sync(fb[j], bs + kk * (kBWidth + kPad) + n,
                                   kBWidth + kPad);
        }
#pragma unroll
        for (int i = 0; i < kFragM; ++i)
#pragma unroll
          for (int j = 0; j < kFragN; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // The f32 tile rounded to bf16 into out (rows ldc apart), rows below
  // m_valid and columns below n_valid (a multiple of 8). The ring is
  // drained and every warp past it (run's last barrier).
  __device__ static void store(bf16* smem, Acc (&acc)[kFragM][kFragN],
                               bf16* out, long long ldc, int m_valid,
                               int n_valid) {
    float* cs = reinterpret_cast<float*>(smem);
    const int warp = threadIdx.x / 32;
    const int wm0 = (warp / 4) * kWarpM, wn0 = (warp % 4) * kWarpN;
#pragma unroll
    for (int i = 0; i < kFragM; ++i)
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::store_matrix_sync(cs + (wm0 + i * 16) * kCLd + wn0 + j * 16,
                                acc[i][j], kCLd, wmma::mem_row_major);
    __syncthreads();
    for (int c = threadIdx.x; c < kTileM * kTileN / 8; c += kThreads) {
      const int row = c / (kTileN / 8), col = (c % (kTileN / 8)) * 8;
      if (row >= m_valid || col >= n_valid) continue;
      const float4 lo = *reinterpret_cast<const float4*>(cs + row * kCLd + col);
      const float4 hi =
          *reinterpret_cast<const float4*>(cs + row * kCLd + col + 4);
      __nv_bfloat162 v[4] = {__floats2bfloat162_rn(lo.x, lo.y),
                             __floats2bfloat162_rn(lo.z, lo.w),
                             __floats2bfloat162_rn(hi.x, hi.y),
                             __floats2bfloat162_rn(hi.z, hi.w)};
      *reinterpret_cast<uint4*>(out + row * ldc + col) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
};

template <bool kBT>
__global__ void __launch_bounds__(kThreads, 1)
moe_gmm_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   bf16* __restrict__ y, const int* __restrict__ offs,
                   const int* __restrict__ counts,
                   const int* __restrict__ tile_end, long long rows,
                   int k, int n, long long sxr, long long swe,
                   long long ldb, int experts) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int g = blockIdx.y, n0 = blockIdx.x * kTileN;
  int e = 0;
  for (int i = 0; i < experts; ++i) e += tile_end[i] <= g;
  const int n_valid = n - n0;
  if (e == experts) {
    // Zeros over the rows past the last expert's.
    const long long total = offs[experts - 1] + counts[experts - 1];
    const long long r0 =
        total + static_cast<long long>(g - tile_end[experts - 1]) * kTileM;
    if (r0 >= rows) return;
    const long long m_valid = rows - r0;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int c = threadIdx.x; c < kTileM * kTileN / 8; c += kThreads) {
      const int row = c / (kTileN / 8), col = (c % (kTileN / 8)) * 8;
      if (row < m_valid && col < n_valid)
        *reinterpret_cast<uint4*>(y + (r0 + row) * n + n0 + col) = zero;
    }
    return;
  }
  const int first = tile_end[e] - (counts[e] + kTileM - 1) / kTileM;
  const long long r0 = offs[e] + static_cast<long long>(g - first) * kTileM;
  const int m_valid = static_cast<int>(offs[e] + counts[e] - r0);
  const bf16* b = w + e * swe + (kBT ? n0 * ldb : n0);
  using T = Tile<false, kBT>;
  typename T::Acc acc[kFragM][kFragN];
  T::run(smem, x + r0 * sxr, sxr, b, ldb, k, m_valid, n_valid, acc);
  T::store(smem, acc, y + r0 * n + n0, n, m_valid, n_valid);
}

__global__ void __launch_bounds__(kThreads, 1)
moe_gmm_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  bf16* __restrict__ dw, const int* __restrict__ offs,
                  const int* __restrict__ counts, int k, int n,
                  long long sxr, long long sdyr) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.y * kTileM;
  const int e = blockIdx.z;
  const long long r0 = offs[e];
  using T = Tile<true, false>;
  typename T::Acc acc[kFragM][kFragN];
  T::run(smem, x + r0 * sxr + m0, sxr, dy + r0 * sdyr + n0, sdyr, counts[e],
         k - m0, n - n0, acc);
  T::store(smem, acc,
           dw + static_cast<long long>(e) * k * n +
               static_cast<long long>(m0) * n + n0,
           n, k - m0, n - n0);
}

// Dynamic shared memory above 48 KB is granted once a kernel and device.
template <typename Kernel>
int grant(Kernel kernel, int bytes, bool (&granted)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidValue);
  if (!granted[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted[dev] = true;
  }
  return 0;
}

bool aligned(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <bool kBT>
int launch_fwd(const void* x, const void* w, void* y, const int* offs,
               const int* counts, const int* tile_end, long long rows,
               int k, int n, long long sxr, long long swe, long long ldb,
               int experts, long long grid_rows, cudaStream_t stream) {
  static bool granted[kMaxDevices];
  constexpr int bytes = Tile<false, kBT>::kSmemBytes;
  const int err = grant(moe_gmm_fwd_kernel<kBT>, bytes, granted);
  if (err) return err;
  const dim3 grid(static_cast<unsigned>((n + kTileN - 1) / kTileN),
                  static_cast<unsigned>(grid_rows));
  moe_gmm_fwd_kernel<kBT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), offs, counts, tile_end, rows, k, n, sxr, swe,
      ldb, experts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (rows, n) = each expert's rows of x (rows, k; row stride sxr) times
// its w: w[e * swe + kk * ldb + j] (b_trans 0) or w[e * swe + j * ldb +
// kk] (b_trans 1, W_e^T). offs, counts, tile_end: int32 device arrays of
// `experts` entries (the file's note); grid_rows the static grid's row
// tiles. Every operand bf16, x, w and y 16-byte aligned, k, n and the
// strides multiples of 8 elements, y contiguous. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int moe_gmm_fwd_launch(const void* x, const void* w, void* y,
                                  const void* offs, const void* counts,
                                  const void* tile_end, long long rows,
                                  long long k, long long n, long long sxr,
                                  long long swe, long long ldb, int b_trans,
                                  int experts, long long grid_rows,
                                  void* stream) {
  if (rows <= 0 || k <= 0 || n <= 0 || experts <= 0 || k % 8 || n % 8 ||
      sxr % 8 || swe % 8 || ldb % 8 || grid_rows <= 0 ||
      grid_rows > 65535 || k > 0x7fffffffLL || n > 0x7fffffffLL ||
      !aligned(x) || !aligned(w) || !aligned(y))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(offs);
  const int* c = static_cast<const int*>(counts);
  const int* t = static_cast<const int*>(tile_end);
  const int ki = static_cast<int>(k), ni = static_cast<int>(n);
  return b_trans ? launch_fwd<true>(x, w, y, o, c, t, rows, ki, ni, sxr, swe,
                                    ldb, experts, grid_rows, s)
                 : launch_fwd<false>(x, w, y, o, c, t, rows, ki, ni, sxr,
                                     swe, ldb, experts, grid_rows, s);
}

// dw (experts, k, n) contiguous = for each expert e the sum over its rows
// (offs[e] .. offs[e] + counts[e] - 1) of x's row (row stride sxr)^T times
// dy's (row stride sdyr). Every operand bf16 and 16-byte aligned, k, n and
// the strides multiples of 8 elements. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int moe_gmm_dw_launch(const void* x, const void* dy, void* dw,
                                 const void* offs, const void* counts,
                                 long long k, long long n, long long sxr,
                                 long long sdyr, int experts, void* stream) {
  if (k <= 0 || n <= 0 || experts <= 0 || experts > 65535 || k % 8 ||
      n % 8 || sxr % 8 || sdyr % 8 || k > 0x7fffffffLL ||
      n > 0x7fffffffLL || !aligned(x) || !aligned(dy) || !aligned(dw))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool granted[kMaxDevices];
  constexpr int bytes = Tile<true, false>::kSmemBytes;
  const int err = grant(moe_gmm_dw_kernel, bytes, granted);
  if (err) return err;
  const dim3 grid(static_cast<unsigned>((n + kTileN - 1) / kTileN),
                  static_cast<unsigned>((k + kTileM - 1) / kTileM),
                  static_cast<unsigned>(experts));
  moe_gmm_dw_kernel<<<grid, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dw), static_cast<const int*>(offs),
      static_cast<const int*>(counts), static_cast<int>(k),
      static_cast<int>(n), sxr, sdyr);
  return static_cast<int>(cudaGetLastError());
}
