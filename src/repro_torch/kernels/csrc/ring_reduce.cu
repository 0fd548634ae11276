// Ring all-reduce for Hopper (sm_90a): the port of the Pallas kernel
// repro/kernels/ring_reduce.py::ring_allreduce (body _kernel). One launch
// per rank; the N ranks of a ring run at the same time, on one card (each
// on its own stream) or in N processes (peer memory through CUDA IPC).
//
// Rank d of N over a zero-padded buffer of N segments of `seg` elements:
//   RS t     send segment (d-t)%N, receive (d-t-1)%N, add in f32
//            (x first); the next step sends requant(sum)
//   owned    segment (d+1)%N, rounded through the wire dtype once
//   AG t     send segment (d+1-t)%N, receive (d-t)%N, keep it
//   out      x's dtype of each segment's final value
// Segments move in the wire dtype (f32, bf16, int8 words, fp8-e4m3 words).
//
// Bound: bytes. The function reads x once, writes the output once and, on
// each of the 2(N-1) steps, writes one wire segment into the neighbour's
// slots and reads one out of its own (ring_reduce.bound_bytes). Every
// segment gets exactly one add a rank, so its f32 value lives only between
// a receive and the next send: this kernel keeps it in registers and has
// no accumulator in device memory. What bounds it in practice is the
// latency of the handshakes, above all the system-scope fence of each
// release, so the design spends one pass, two CTA barriers and one fence
// a step of a round (G sub-tiles of the lane), not a sub-tile.
//
// Lanes. A segment is cut into sub-tiles of gridDim.x lanes of kLane
// elements; CTA b owns lane b of every sub-tile of every segment and runs
// its own ring with CTA b of its neighbours, so no CTA waits for another
// CTA of its own rank. Each lane has, in every rank's workspace, kSlots
// receive slots, a "full" word (written by the left neighbour), a "credit"
// word (written by the right one) and a sequence word (this lane's count
// of sub-tiles, kept across launches, so no flag is ever cleared).
//
// Rounds (NCCL's ring primitives). A round is G = kRound sub-tiles of the
// lane; it runs all 2(N-1) steps of those sub-tiles before the next round.
// Sends and receives each follow one monotone sequence, in (round, step,
// sub-tile) order, numbered from the lane's sequence word; sub-tile p uses
// slot p % S. A step of a round moves g <= G sub-tiles, p0..p0+g-1 in and
// q0 = p0+g.. out.
//   step 0   one pass: x of segment d for the round's g sub-tiles,
//            requantized, into the right neighbour's slots.
//   later    one fused pass: the x loads (reduce-scatter only) start
//            first, as x depends on no peer; thread 0 waits for the data
//            (own full >= p0+g) and for the outgoing credit (own credit >=
//            q0+g-S); one barrier; the g slots are read (ld.global.cg) and
//            - RS t < N-2: sum = x + recv, requantized, sent on;
//            - RS t = N-2 (the owned segment): the same sum, requantized
//              once; out is written from that word and the word is sent
//              as all-gather step 0;
//            - AG: out is written from the received word, which is
//              forwarded with its bits unchanged (not on the last step).
//              Every word on the wire came out of requant, and requant
//              maps to_f(w) back to w for each such word, so forwarding
//              the bits is re-quantizing the value.
//            Then one barrier and two flag stores behind one fence: full
//            to the right (q0+g), credit to the left (p0+g). The `out`
//            stores come after the release (they are this rank's own), so
//            the fence does not wait for them.
// Deadlock freedom: a step's sends reach g sub-tiles past its receives, so
// it needs the right neighbour to have drained up to q0+g-S = p0+2g-S. A
// rank that has finished step t-1 has drained p0, so the rank furthest
// behind can always move when 2g <= S. So 2G <= S (static_assert below;
// tests/test_torch_ring.py models the schedule and its deadlock past
// that); G = S/2 as in NCCL.
//
// In place (out may be x): every element's x is read in its round's
// reduce-scatter (step 0 or the receive of its segment), by the thread
// that later in the same round writes its out; no element of another
// round is touched.
//
// Flags use release/acquire at system scope, as a peer may be another
// process (CUDA IPC); in-process rings run the same build. One thread
// writes each flag after the CTA's barrier, which orders the other
// threads' slot stores (and slot reads, for the credit) before it. Every
// wait is bounded by %globaltimer and traps after timeout_ns, so a
// deadlock becomes a CUDA error. A rank's grid has at most
// floor(ctas_per_sm * SMs / N) CTAs, so the N ranks' CTAs are resident
// together; the launcher refuses a launch when fewer than ctas_per_sm
// CTAs of the kernel fit on an SM.
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
constexpr int kVecs = kLane / (kThreads * 8);  // 8-element vectors a thread
constexpr int kSlots = 8;    // S: receive slots per lane
constexpr int kRound = 4;    // G: sub-tiles of a lane per round
constexpr int kMinCtas = 4;  // CTAs an SM must hold (ring_reduce.CTAS_PER_SM)
static_assert(kLane % (kThreads * 8) == 0, "a lane is whole vectors");
static_assert(kRound >= 1 && 2 * kRound <= kSlots,
              "deadlock freedom needs 2G <= S");
typedef unsigned long long u64;

__device__ __forceinline__ u64 globaltimer() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.sys;" ::: "memory");
}

__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ void wait_geq(const u64* p, u64 want, u64 timeout_ns,
                         const char* what, int me, int lane) {
  const u64 t0 = globaltimer();
  u64 have;
  for (int spin = 0; (have = ld_acquire(p)) < want; ++spin) {
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
  __device__ static float to_f(bits b) {  // the f32 bits, built directly
    const unsigned int sign = (b & 0x80u) << 24;
    const unsigned int e = (b >> 3) & 0xFu, m = b & 7u;
    if (e == 15 && m == 7)  // NaN, with c10's payload and the sign
      return __uint_as_float(0x7FF00000u | sign);
    if (e == 0)  // subnormal: m * 2^-9, exact
      return __uint_as_float(
          __float_as_uint(static_cast<float>(m) * 0.001953125f) | sign);
    return __uint_as_float(sign | ((e + 120u) << 23) | (m << 20));
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
  long long n;             // elements of x
  long long seg;           // segment elements, a multiple of the sub-tile
  int nranks, me, tiles_per_seg, ws_lanes, fp8_saturate;
  int vec_io;              // x and out 16-byte aligned: vector access
  u64 timeout_ns;
  u64* my_flags;           // [full | credit | seq] x ws_lanes
  unsigned char* my_slots;
  u64* right_flags;
  unsigned char* right_slots;
  u64* left_flags;
};

// Eight elements as one vector of 8, 16 or 32 bytes.
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

template <typename B>
__device__ __forceinline__ void store(B* p, const Vec8<B>& d) {
  typename VecOf<B>::type* q = reinterpret_cast<typename VecOf<B>::type*>(p);
#pragma unroll
  for (int i = 0; i < VecOf<B>::n; ++i) q[i] = d.v[i];
}

// x and out stream through once: __ldcs / __stcs. Elements at or past n
// (the padding) read as zero bits and are not written.
template <typename B>
__device__ __forceinline__ Vec8<B> load_x(const B* x, long long e,
                                          long long n, bool vec) {
  Vec8<B> d;
  if (vec && e + 8 <= n) {
    const typename VecOf<B>::type* q =
        reinterpret_cast<const typename VecOf<B>::type*>(x + e);
#pragma unroll
    for (int i = 0; i < VecOf<B>::n; ++i) d.v[i] = __ldcs(q + i);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) d.w[i] = e + i < n ? x[e + i] : B(0);
  }
  return d;
}

template <typename B>
__device__ __forceinline__ void store_out(B* out, long long e, long long n,
                                          bool vec, const Vec8<B>& d) {
  if (vec && e + 8 <= n) {
    typename VecOf<B>::type* q =
        reinterpret_cast<typename VecOf<B>::type*>(out + e);
#pragma unroll
    for (int i = 0; i < VecOf<B>::n; ++i) __stcs(q + i, d.v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (e + i < n) out[e + i] = d.w[i];
  }
}

__device__ __forceinline__ int mod(int a, int n) { return ((a % n) + n) % n; }

template <typename X, typename W>
__global__ void __launch_bounds__(kThreads, kMinCtas)
ring_kernel(const RingArgs a) {
  typedef typename X::bits XB;
  typedef typename W::bits WB;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int N = a.nranks, me = a.me, T = a.tiles_per_seg;
  const int steps = 2 * (N - 1);
  const bool vec = a.vec_io != 0;
  const long long tile = static_cast<long long>(gridDim.x) * kLane;
  const long long lane0 = static_cast<long long>(b) * kLane;
  const int L = a.ws_lanes;
  const u64* my_full = a.my_flags + b;
  const u64* my_credit = a.my_flags + L + b;
  u64* my_seq = a.my_flags + 2 * L + b;
  u64* right_full = a.right_flags + b;
  u64* left_credit = a.left_flags + L + b;
  const WB* my_slot = reinterpret_cast<const WB*>(a.my_slots) +
                      static_cast<long long>(kSlots) * b * kLane;
  WB* right_slot = reinterpret_cast<WB*>(a.right_slots) +
                   static_cast<long long>(kSlots) * b * kLane;
  const XB* x = static_cast<const XB*>(a.x);
  XB* out = static_cast<XB*>(a.out);
  // This thread's element of vector v: (v * kThreads + tid) * 8 in the lane.
  auto elem = [&](int s, int j, int v) {
    return s * a.seg + j * tile + lane0 +
           static_cast<long long>(v * kThreads + tid) * 8;
  };
  auto slot_at = [&](auto* base, u64 p, int v) {
    return base + static_cast<long long>(p % kSlots) * kLane +
           (v * kThreads + tid) * 8;
  };
  // Only this CTA writes its sequence word, in earlier launches.
  u64 pos = *my_seq;  // the sequence number of this round's first sub-tile

  for (int j0 = 0; j0 < T; j0 += kRound) {
    const int g = min(kRound, T - j0);

    // Step 0: x of segment `me` for the round's g sub-tiles goes out (x is
    // loaded before the credit wait).
    {
      Vec8<XB> xv[kRound][kVecs];
#pragma unroll
      for (int i = 0; i < kRound; ++i)
#pragma unroll
        for (int v = 0; v < kVecs; ++v)
          if (i < g) xv[i][v] = load_x(x, elem(me, j0 + i, v), a.n, vec);
      const u64 last = pos + g - 1;
      if (tid == 0 && last >= kSlots)
        wait_geq(my_credit, last - kSlots + 1, a.timeout_ns, "credit", me, b);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kRound; ++i)
#pragma unroll
        for (int v = 0; v < kVecs; ++v)
          if (i < g) {
            Vec8<WB> w;
#pragma unroll
            for (int q = 0; q < 8; ++q)
              w.w[q] = W::requant(X::to_f(xv[i][v].w[q]), a.fp8_saturate);
            store(slot_at(right_slot, pos + i, v), w);
          }
      __syncthreads();
      if (tid == 0) {
        fence_acq_rel();
        st_relaxed(right_full, pos + g);
      }
    }

    // Every later step of the round: one fused pass over its g sub-tiles,
    // with one handshake for them all.
    for (int t = 0; t < steps; ++t) {
      const bool rs = t < N - 1;
      const bool send = t < steps - 1;
      const bool writes_out = t >= N - 2;
      const int s = rs ? mod(me - t - 1, N) : mod(me - (t - (N - 1)), N);
      const u64 p0 = pos + static_cast<u64>(t) * g;  // this step's receives
      const u64 q0 = p0 + g;                         // the sends they feed
      Vec8<XB> xv[kRound][kVecs];
      if (rs) {
#pragma unroll
        for (int i = 0; i < kRound; ++i)
#pragma unroll
          for (int v = 0; v < kVecs; ++v)
            if (i < g) xv[i][v] = load_x(x, elem(s, j0 + i, v), a.n, vec);
      }
      if (tid == 0) {
        wait_geq(my_full, p0 + g, a.timeout_ns, "data", me, b);
        if (send && q0 + g > kSlots)
          wait_geq(my_credit, q0 + g - kSlots, a.timeout_ns, "credit", me,
                   b);
      }
      __syncthreads();
      Vec8<WB> o[kRound][kVecs];  // out's words, cast after the release
#pragma unroll
      for (int i = 0; i < kRound; ++i)
#pragma unroll
        for (int v = 0; v < kVecs; ++v)
          if (i < g) {
            Vec8<WB> w = load_cg(slot_at(my_slot, p0 + i, v));
            if (rs) {
#pragma unroll
              for (int k = 0; k < 8; ++k)
                w.w[k] = W::requant(
                    __fadd_rn(X::to_f(xv[i][v].w[k]), W::to_f(w.w[k])),
                    a.fp8_saturate);
            }
            if (send) store(slot_at(right_slot, q0 + i, v), w);
            if (writes_out) o[i][v] = w;
          }
      __syncthreads();
      if (tid == 0) {
        fence_acq_rel();
        if (send) st_relaxed(right_full, q0 + g);
        st_relaxed(left_credit, p0 + g);
      }
      // out is this rank's own: its stores stay behind the release, off
      // the fence's wait.
      if (writes_out) {
#pragma unroll
        for (int i = 0; i < kRound; ++i)
#pragma unroll
          for (int v = 0; v < kVecs; ++v)
            if (i < g) {
              Vec8<XB> ov;
#pragma unroll
              for (int k = 0; k < 8; ++k)
                ov.w[k] = X::cast(W::to_f(o[i][v].w[k]), a.fp8_saturate);
              store_out(out, elem(s, j0 + i, v), a.n, vec, ov);
            }
      }
    }
    pos += static_cast<u64>(steps) * g;
  }
  if (tid == 0) *my_seq = pos;
}

typedef void (*KernelFn)(const RingArgs);

template <typename X>
KernelFn pick_wire(int w) {
  switch (w) {
    case 0: return ring_kernel<X, F32>;
    case 1: return ring_kernel<X, BF16>;
    case 2: return ring_kernel<X, I8>;
    default: return ring_kernel<X, F8>;
  }
}

KernelFn pick(int x, int w) {
  switch (x) {
    case 0: return pick_wire<F32>(w);
    case 1: return pick_wire<BF16>(w);
    case 2: return pick_wire<I8>(w);
    default: return pick_wire<F8>(w);
  }
}

bool bad_codes(int x_code, int w_code) {
  return x_code < 0 || x_code > 3 || w_code < 0 || w_code > 3;
}

// CTAs of an instance one SM of the current device holds, asked once per
// device and instance (the launcher checks it on every launch).
constexpr int kMaxDevices = 64;
int occupancy_seen[kMaxDevices][4][4];  // 0: not asked yet

cudaError_t occupancy(int x_code, int w_code, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int* seen = dev < kMaxDevices ? &occupancy_seen[dev][x_code][w_code]
                                : nullptr;
  if (seen && *seen > 0) {
    *blocks = *seen;
    return cudaSuccess;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, reinterpret_cast<const void*>(pick(x_code, w_code)),
      kThreads, 0);
  if (e == cudaSuccess && seen) *seen = *blocks;
  return e;
}

}  // namespace

// CTAs of the kernel instance (x_code, w_code) that one SM holds at once,
// into *blocks.
extern "C" int ring_allreduce_occupancy(int x_code, int w_code,
                                        int* blocks) {
  if (bad_codes(x_code, w_code) || !blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(occupancy(x_code, w_code, blocks));
}

// Dtype codes: 0 f32, 1 bf16, 2 int8, 3 float8_e4m3fn. grid CTAs, each
// owning one lane of lane_elems elements of every sub-tile; the sub-tile
// is grid * lane_elems and seg a whole number of sub-tiles. lane_elems,
// slots, round_tiles and ctas_per_sm must be this source's kLane, kSlots,
// kRound and kMinCtas (ring_reduce.LANE_ELEMS, SLOTS, ROUND_TILES and
// CTAS_PER_SM in Python). A workspace holds the three flag words of each
// of ws_lanes >= grid lanes (full, credit, sequence; rounded up to
// 256 B), then kSlots slots of kLane f32-sized elements per lane
// (ring_reduce.workspace_bytes). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for bad
// arguments, or cudaErrorLaunchOutOfResources when fewer than ctas_per_sm
// CTAs fit on an SM (the N ranks' CTAs would not all be resident).
extern "C" int ring_allreduce_launch(
    const void* x, void* out, long long n, long long seg, int nranks,
    int me, int grid, int lane_elems, int slots, int round_tiles,
    int ctas_per_sm, int x_code, int w_code, void* my_ws, void* right_ws,
    void* left_ws, int ws_lanes, long long timeout_ns,
    int fp8_saturate, void* stream) {
  if (lane_elems != kLane || slots != kSlots || round_tiles != kRound ||
      ctas_per_sm != kMinCtas || nranks < 2 || me < 0 || me >= nranks ||
      grid < 1 || grid > ws_lanes || seg <= 0 ||
      seg % (static_cast<long long>(grid) * kLane) != 0 ||
      seg * nranks < n || bad_codes(x_code, w_code) || !x || !out ||
      !my_ws || !right_ws || !left_ws)
    return static_cast<int>(cudaErrorInvalidValue);
  int fit = 0;
  cudaError_t e = occupancy(x_code, w_code, &fit);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (fit < ctas_per_sm)
    return static_cast<int>(cudaErrorLaunchOutOfResources);
  const long long flag_bytes = (3LL * ws_lanes * 8 + 255) / 256 * 256;
  RingArgs a;
  a.x = x;
  a.out = out;
  a.n = n;
  a.seg = seg;
  a.nranks = nranks;
  a.me = me;
  a.tiles_per_seg = static_cast<int>(seg / (static_cast<long long>(grid) *
                                            kLane));
  a.ws_lanes = ws_lanes;
  a.fp8_saturate = fp8_saturate;
  a.vec_io = (reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
              reinterpret_cast<unsigned long long>(out) % 16 == 0);
  a.timeout_ns = static_cast<u64>(timeout_ns);
  a.my_flags = static_cast<u64*>(my_ws);
  a.my_slots = static_cast<unsigned char*>(my_ws) + flag_bytes;
  a.right_flags = static_cast<u64*>(right_ws);
  a.right_slots = static_cast<unsigned char*>(right_ws) + flag_bytes;
  a.left_flags = static_cast<u64*>(left_ws);
  void* args[] = {&a};
  const void* fn = reinterpret_cast<const void*>(pick(x_code, w_code));
  e = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, 0,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
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
