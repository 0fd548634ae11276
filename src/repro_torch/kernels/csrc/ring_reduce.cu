// Ring all-reduce for Hopper (sm_90a): the port of the Pallas kernel
// repro/kernels/ring_reduce.py::ring_allreduce (body _kernel). One launch
// per rank; the N ranks of a ring run at the same time, on one card (each
// on its own stream) or in N processes (peer memory through CUDA IPC).
//
// Rank d of N over a zero-padded buffer of N segments of `seg` elements:
//   seed     acc = float(x) (x in its own dtype; padding 0)
//   RS t     send segment (d-t)%N, receive (d-t-1)%N, acc += received
//   round    segment (d+1)%N through the wire dtype once (non-f32 wires)
//   AG t     send segment (d+1-t)%N, receive (d-t)%N, acc = received
//   out      x's dtype of acc
// Segments move in the wire dtype (f32, bf16, int8 words, fp8-e4m3 words);
// the accumulator is f32 in device memory.
//
// Design. A segment is cut into sub-tiles of gridDim.x lanes of kLane
// elements; CTA b owns lane b of every sub-tile of every segment and runs
// its own ring of kSlots slots with CTA b of its neighbours, so no CTA ever
// waits for another CTA of its own rank and no grid-wide barrier is needed.
// Each lane has, in every rank's workspace, kSlots receive slots, a "full" word
// (written by the left neighbour), a "credit" word (written by the right
// neighbour) and a sequence word (this lane's count of sub-tiles, kept
// across launches). Sub-tiles are numbered by a global sequence g that
// grows across launches from the lane's sequence word, so no flag is ever
// cleared:
//   send g: if g >= S, wait until own credit >= g-S+1 (the right neighbour
//           drained g-S from slot g%S); store the requantized lane into the
//           right neighbour's slot g%S; release-store g+1 to its full word.
//   recv g: acquire-wait own full >= g+1; drain slot g%S (add in RS,
//           overwrite in AG; the last RS step also rounds the rank's own
//           segment through the wire); release-store g+1 to the left's
//           credit word.
// The Pallas kernel has two slots (S = 2); here S = 4, and a lane sends up
// to S-1 sub-tiles ahead of the one it waits for, unless a sub-tile needs
// what its previous step is still receiving, so the sender seldom waits
// for a credit and the receiver seldom for data. Slots and the accumulator
// move 8 elements a thread as one vector; one thread writes each flag
// (st.release.sys) after the CTA's barrier, which orders the other
// threads' stores before it.
// This is the Pallas kernel's credit rule plus the "data landed" signal
// that the TPU's DMA semaphores gave. Flags use system-scope release /
// acquire, because a peer may be another process. Every wait is bounded by
// %globaltimer and traps after timeout_ns, so a deadlock becomes a CUDA
// error. A rank's grid has at most floor(4 * SMs / N) CTAs (an SM holds
// four at once), so all N ranks' CTAs are resident on one card together.
//
// Bound: bytes. Per rank: read x, write the output, and on each exchange
// step write a segment into the neighbour's slots and read one from its
// own. The f32 accumulator in device memory (the seed pass, its reads and
// writes on every step, the output cast) is this kernel's own cost, not
// the function's: a received segment could be added, requantized and sent
// on in registers. Every rank shares one HBM when the ring runs on one
// card.
//
// Rounding: int8 requant rounds half to even (__float2int_rn, as
// jnp.round); bf16 rounds to nearest even and fp8-e4m3fn follows PyTorch's
// own conversion (c10's fp8e4m3fn_from_fp32_value), with the overflow rule
// of the PyTorch build in use (saturate to 448, or NaN), chosen by
// fp8_saturate, so the kernel equals the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdio.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLane = 2048;  // elements of a lane of one sub-tile
constexpr int kPerThread = kLane / kThreads;
constexpr int kSlots = 4;    // receive slots per lane
typedef unsigned long long u64;

__device__ __forceinline__ u64 globaltimer() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void st_release_sys(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 ld_acquire_sys(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ void wait_geq(const u64* p, u64 want, u64 timeout_ns,
                         const char* what, int me, int lane) {
  const u64 t0 = globaltimer();
  u64 have;
  for (int spin = 0; (have = ld_acquire_sys(p)) < want; ++spin) {
    if (spin < 256) continue;
    if (globaltimer() - t0 > timeout_ns) {
      printf("ring_allreduce: rank %d lane %d timed out waiting for %s "
             ">= %llu (have %llu)\n", me, lane, what, want, have);
      __trap();
    }
    __nanosleep(64);
  }
}

// -- element types: raw bits <-> f32 ------------------------------------------

struct F32 {
  typedef unsigned int bits;
  __device__ static float to_f(bits b) { return __uint_as_float(b); }
  __device__ static bits requant(float f, int) { return __float_as_uint(f); }
  __device__ static bits cast(float f, int) { return __float_as_uint(f); }
};

struct BF16 {  // c10's round_to_nearest_even
  typedef unsigned short bits;
  __device__ static float to_f(bits b) {
    return __uint_as_float(static_cast<unsigned int>(b) << 16);
  }
  __device__ static bits requant(float f, int) {
    if (f != f) return 0x7FC0;
    const unsigned int u = __float_as_uint(f);
    return static_cast<bits>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
  }
  __device__ static bits cast(float f, int s) { return requant(f, s); }
};

struct I8 {
  typedef unsigned char bits;
  __device__ static float to_f(bits b) {
    return static_cast<float>(static_cast<signed char>(b));
  }
  // The wire requant rounds half to even (jnp.round / torch.round).
  __device__ static bits requant(float f, int) {
    return static_cast<bits>(static_cast<signed char>(__float2int_rn(f)));
  }
  // The output cast truncates, as a float -> int8 cast does.
  __device__ static bits cast(float f, int) {
    return static_cast<bits>(static_cast<signed char>(__float2int_rz(f)));
  }
};

struct F8 {  // float8_e4m3fn
  typedef unsigned char bits;
  __device__ static float to_f(bits b) {
    const float sign = (b & 0x80) ? -1.0f : 1.0f;
    const int e = (b >> 3) & 0xF, m = b & 7;
    if (e == 15 && m == 7)  // NaN, with c10's payload and the sign
      return __uint_as_float(0x7FF00000u | ((b & 0x80u) << 24));
    if (e == 0) return sign * ldexpf(static_cast<float>(m), -9);
    return sign * ldexpf(static_cast<float>(8 + m), e - 10);
  }
  // c10::detail::fp8e4m3fn_from_fp32_value; `sat` picks the overflow rule.
  __device__ static bits requant(float f, int sat) {
    const unsigned int fp8_max = 1087u << 20;      // 480.0f
    const unsigned int denorm_mask = 141u << 23;
    unsigned int f_bits = __float_as_uint(f);
    const unsigned int sign = f_bits & 0x80000000u;
    f_bits ^= sign;
    unsigned char result;
    if (f_bits >= fp8_max) {
      result = (sat && f_bits <= 0x7F800000u) ? 0x7e : 0x7f;
    } else if (f_bits < (121u << 23)) {
      f_bits = __float_as_uint(__fadd_rn(__uint_as_float(f_bits),
                                         __uint_as_float(denorm_mask)));
      result = static_cast<unsigned char>(f_bits - denorm_mask);
    } else {
      const unsigned int mant_odd = (f_bits >> 20) & 1u;
      f_bits += (static_cast<unsigned int>(7 - 127) << 23) + 0x7FFFFu;
      f_bits += mant_odd;
      result = static_cast<unsigned char>(f_bits >> 20);
      if (sat && result == 0x7f) result = 0x7e;
    }
    return static_cast<bits>(result | static_cast<unsigned char>(sign >> 24));
  }
  __device__ static bits cast(float f, int sat) { return requant(f, sat); }
};

struct RingArgs {
  const void* x;
  void* out;               // may alias x
  float* acc;              // nranks * seg floats
  long long n;             // elements of x
  long long seg;           // segment elements, a multiple of the sub-tile
  int nranks, me, tiles_per_seg, ws_lanes, fp8_saturate;
  u64 timeout_ns;
  u64* my_flags;           // [full | credit | seq] x ws_lanes
  unsigned char* my_slots;
  u64* right_flags;
  unsigned char* right_slots;
  u64* left_flags;
};

// Eight wire elements as one vector of 8, 16 or 32 bytes.
template <typename B>
struct VecOf;
template <>
struct VecOf<unsigned char> {
  typedef uint2 type;
  static const int n = 1;
};
template <>
struct VecOf<unsigned short> {
  typedef uint4 type;
  static const int n = 1;
};
template <>
struct VecOf<unsigned int> {
  typedef uint4 type;
  static const int n = 2;
};
template <typename B>
union Vec8 {
  B w[8];
  typename VecOf<B>::type v[VecOf<B>::n];
};

// Slot loads bypass L1 (ld.global.cg): a slot is rewritten by a peer
// between two reads of this SM.
template <typename B>
__device__ __forceinline__ Vec8<B> load_cg(const B* p) {
  Vec8<B> d;
  const typename VecOf<B>::type* q =
      reinterpret_cast<const typename VecOf<B>::type*>(p);
#pragma unroll
  for (int i = 0; i < VecOf<B>::n; ++i) d.v[i] = __ldcg(q + i);
  return d;
}

template <typename X, typename W>
__global__ void __launch_bounds__(kThreads)
ring_kernel(const RingArgs a) {
  typedef typename X::bits XB;
  typedef typename W::bits WB;
  typedef Vec8<WB> V;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int N = a.nranks, me = a.me, T = a.tiles_per_seg;
  const int K = 2 * (N - 1) * T;  // sub-tiles this lane sends and receives
  const long long tile = static_cast<long long>(gridDim.x) * kLane;
  const long long lane0 = static_cast<long long>(b) * kLane;
  const int L = a.ws_lanes;
  u64* my_full = a.my_flags + b;
  u64* my_seq = a.my_flags + 2 * L + b;
  const u64* my_credit = a.my_flags + L + b;
  u64* right_full = a.right_flags + b;
  u64* left_credit = a.left_flags + L + b;
  WB* my_slot = reinterpret_cast<WB*>(a.my_slots) +
                static_cast<long long>(kSlots) * b * kLane;
  WB* right_slot = reinterpret_cast<WB*>(a.right_slots) +
                   static_cast<long long>(kSlots) * b * kLane;
  const XB* x = static_cast<const XB*>(a.x);
  XB* out = static_cast<XB*>(a.out);
  float* acc = a.acc;
  const u64 base = *my_seq;  // only this CTA writes it, in earlier launches

  // Seed this lane of every sub-tile of every segment.
  for (int s = 0; s < N; ++s)
    for (int j = 0; j < T; ++j) {
      const long long e0 = s * a.seg + j * tile + lane0;
#pragma unroll 4
      for (int i = 0; i < kPerThread; ++i) {
        const long long e = e0 + i * kThreads + tid;
        acc[e] = e < a.n ? X::to_f(x[e]) : 0.0f;
      }
    }

  // Sub-tile k of this launch: step k / T, sub-tile k % T of the step's
  // segment; its global sequence number is base + k.
  auto lane_of = [&](int seg_idx, int k) {
    return acc + seg_idx * a.seg + (k % T) * tile + lane0;
  };
  auto send = [&](int k) {
    const u64 g = base + k;
    const int step = k / T;
    const int idx = step < N - 1 ? ((me - step) % N + N) % N
                                 : ((me + 1 - (step - (N - 1))) % N + N) % N;
    if (tid == 0 && g >= kSlots)
      wait_geq(my_credit, g - kSlots + 1, a.timeout_ns, "credit", me, b);
    __syncthreads();
    const float* src = lane_of(idx, k);
    WB* dst = right_slot + (g % kSlots) * kLane;
#pragma unroll
    for (int i = 0; i < kPerThread / 8; ++i) {
      const int e = (i * kThreads + tid) * 8;
      const float4 lo = *reinterpret_cast<const float4*>(src + e);
      const float4 hi = *reinterpret_cast<const float4*>(src + e + 4);
      const float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      V v;
#pragma unroll
      for (int q = 0; q < 8; ++q) v.w[q] = W::requant(f[q], a.fp8_saturate);
      *reinterpret_cast<V*>(dst + e) = v;
    }
    __syncthreads();
    if (tid == 0) st_release_sys(right_full, g + 1);
  };
  auto recv = [&](int k) {
    const u64 g = base + k;
    const int step = k / T;
    const bool rs = step < N - 1;
    const int idx = rs ? ((me - step - 1) % N + N) % N
                       : ((me - (step - (N - 1))) % N + N) % N;
    // The last reduce-scatter step completes this rank's own segment:
    // round it through the wire once (non-f32 wires).
    const bool own_round = step == N - 2 && sizeof(WB) != 4;
    if (tid == 0) wait_geq(my_full, g + 1, a.timeout_ns, "data", me, b);
    __syncthreads();
    float* dst = lane_of(idx, k);
    const WB* src = my_slot + (g % kSlots) * kLane;
#pragma unroll
    for (int i = 0; i < kPerThread / 8; ++i) {
      const int e = (i * kThreads + tid) * 8;
      const V v = load_cg(src + e);
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (rs) {
        lo = *reinterpret_cast<const float4*>(dst + e);
        hi = *reinterpret_cast<const float4*>(dst + e + 4);
      }
      float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float r = W::to_f(v.w[q]);
        f[q] = rs ? __fadd_rn(f[q], r) : r;
        if (own_round) f[q] = W::to_f(W::requant(f[q], a.fp8_saturate));
      }
      *reinterpret_cast<float4*>(dst + e) = make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(dst + e + 4) =
          make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();
    if (tid == 0) st_release_sys(left_credit, g + 1);
  };

  // Send ahead: up to sub-tile k+S-1 goes out before sub-tile k is
  // received, unless it needs a sub-tile still to be received (the same
  // sub-tile of the previous step, next-T, must have arrived).
  int next = 0;
  for (int k = 0; k < K; ++k) {
    while (next < K && next < k + kSlots && (next < T || next - T < k)) {
      send(next);
      ++next;
    }
    recv(k);
  }
  if (tid == 0) *my_seq = base + K;

  for (int s = 0; s < N; ++s)
    for (int j = 0; j < T; ++j) {
      const long long e0 = s * a.seg + j * tile + lane0;
#pragma unroll 4
      for (int i = 0; i < kPerThread; ++i) {
        const long long e = e0 + i * kThreads + tid;
        if (e < a.n) out[e] = X::cast(acc[e], a.fp8_saturate);
      }
    }
}

template <typename X>
void launch_x(const RingArgs& a, int w, int grid, cudaStream_t s) {
  switch (w) {
    case 0: ring_kernel<X, F32><<<grid, kThreads, 0, s>>>(a); break;
    case 1: ring_kernel<X, BF16><<<grid, kThreads, 0, s>>>(a); break;
    case 2: ring_kernel<X, I8><<<grid, kThreads, 0, s>>>(a); break;
    default: ring_kernel<X, F8><<<grid, kThreads, 0, s>>>(a); break;
  }
}

}  // namespace

// Dtype codes: 0 f32, 1 bf16, 2 int8, 3 float8_e4m3fn. grid CTAs, each
// owning one lane of lane_elems elements of every sub-tile; the sub-tile
// is grid * lane_elems and seg a whole number of sub-tiles. A workspace
// holds the three flag words of each of ws_lanes >= grid lanes (full,
// credit, sequence; rounded up to 256 B), then kSlots slots of kLane
// f32-sized elements per lane (ring_reduce.workspace_bytes in Python).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue.
extern "C" int ring_allreduce_launch(
    const void* x, void* out, void* acc, long long n, long long seg,
    int nranks, int me, int grid, int lane_elems, int x_code, int w_code,
    void* my_ws, void* right_ws, void* left_ws, int ws_lanes,
    long long timeout_ns, int fp8_saturate, void* stream) {
  if (lane_elems != kLane || nranks < 2 || me < 0 || me >= nranks ||
      grid < 1 || grid > ws_lanes || seg <= 0 ||
      seg % (static_cast<long long>(grid) * kLane) != 0 ||
      seg * nranks < n || x_code < 0 || x_code > 3 || w_code < 0 ||
      w_code > 3 || !x || !out || !acc || !my_ws || !right_ws || !left_ws)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long flag_bytes = (3LL * ws_lanes * 8 + 255) / 256 * 256;
  RingArgs a;
  a.x = x;
  a.out = out;
  a.acc = static_cast<float*>(acc);
  a.n = n;
  a.seg = seg;
  a.nranks = nranks;
  a.me = me;
  a.tiles_per_seg = static_cast<int>(seg / (static_cast<long long>(grid) *
                                            kLane));
  a.ws_lanes = ws_lanes;
  a.fp8_saturate = fp8_saturate;
  a.timeout_ns = static_cast<u64>(timeout_ns);
  a.my_flags = static_cast<u64*>(my_ws);
  a.my_slots = static_cast<unsigned char*>(my_ws) + flag_bytes;
  a.right_flags = static_cast<u64*>(right_ws);
  a.right_slots = static_cast<unsigned char*>(right_ws) + flag_bytes;
  a.left_flags = static_cast<u64*>(left_ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_code) {
    case 0: launch_x<F32>(a, w_code, grid, s); break;
    case 1: launch_x<BF16>(a, w_code, grid, s); break;
    case 2: launch_x<I8>(a, w_code, grid, s); break;
    default: launch_x<F8>(a, w_code, grid, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// -- cross-process workspaces (CUDA IPC) ---------------------------------------

// Allocates a zeroed workspace of `bytes` on `device` with cudaMalloc (an
// IPC handle names a whole allocation).
extern "C" int ring_ipc_alloc(int device, long long bytes, void** ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return static_cast<int>(e);
}

// Writes the allocation's 64-byte IPC handle to `handle`.
extern "C" int ring_ipc_handle(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return static_cast<int>(e);
}

extern "C" int ring_ipc_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

// Maps a peer's allocation into this process.
extern "C" int ring_ipc_open(int device, const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  return static_cast<int>(e);
}

extern "C" int ring_ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

extern "C" int ring_ipc_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}
