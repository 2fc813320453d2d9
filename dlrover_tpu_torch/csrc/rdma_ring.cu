// The whole exact ring reduce-scatter as ONE kernel over peer memory, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _rdma_ring_kernel of
// dlrover_tpu/ops/pallas/ring_reduce_scatter.py (:257; pallas_call :342 in
// rdma_ring_reduce_scatter).  There each replica holds x of shape
// (world, width) and ends with its row of the sum, sum_j x_j[me], after
// world - 1 hops: a packet starts as x[(me - 1) % W], moves one hop right
// per step through a 2-slot double-buffered remote copy, and on arrival
// gets x[(me - t - 2) % W] added.  The add order is the reference's, so
// the result is bit-identical to the jax-level ring (and to the port's
// `ring` and `ring_pallas` tiers).
//
// What the TPU runtime gave the kernel, a window gives it here: each rank
// owns one cudaMalloc allocation (its window) holding an error record, 8
// flag words per CTA (the barrier semaphore, the two handshake semaphores,
// the two receive semaphores) and the two receive slots of `cap` floats.
// The kernel reaches its left and right neighbours' windows through
// pointers: opened with cudaIpcOpenMemHandle when each rank has a card of
// its own, or inside one allocation when W ranks share one card.
//
// Protocol, per CTA (each CTA owns a contiguous column range of the row and
// runs an independent ring with the CTA of the same index on its
// neighbours; the columns are elementwise independent, so no barrier across
// the grid is needed).  Flags are never reset: a call carries a generation
// g = 1, 2, ... and every wait targets that generation's count.
//   1. entry barrier: signal both neighbours' barrier words, wait for my own
//      to reach 2g.  A neighbour signals only once it has left call g - 1,
//      so hop 0 below never lands in a slot it still reads.
//   2. hop t = 0 .. W - 2: signal hand[1] on the left and hand[0] on the
//      right, wait for both of mine to reach (g - 1)(W - 1) + t + 1: the
//      right neighbour has left hop t - 1, so it no longer reads the slot
//      (t + 1) % 2 that I write now.  For t > 0 wait for the packet of hop
//      t - 1 in my slot t % 2.  Then store acc = slot + x[(me - t - 1) % W]
//      (hop 0: x[(me - 1) % W]) straight into the right neighbour's slot
//      (t + 1) % 2: the reference's local staging copy and DMA become one
//      store.  __syncthreads(), then one thread makes the stores visible
//      (__threadfence_system) and releases the neighbour's recv[(t + 1) % 2]
//      with a .sys-scope release add.
//   3. wait for the last packet, write out = slot + x[me].
// One thread per CTA waits (acquire loads at .sys scope, then
// __syncthreads), and slot data is read with ld.global.cg (L2, not a stale
// L1 line).  Every wait is bounded by clock64 (the window's timeout, a
// minute by default): a wait that runs out writes the window's error
// record (rank, CTA, stage, hop) and the CTA leaves.  The record is never
// cleared, and a CTA whose window has one leaves before it signals, so a
// stuck peer costs one timeout and not one per call.  The host reads the
// record once per step (the windows' check()) and raises: a stuck peer
// gives an error and never a hang.
//
// Two launch forms of the one __global__, both with
// cudaLaunchCooperativeKernel, which refuses a grid that cannot be resident
// all at once (CTAs that wait on each other must all run):
//   one rank per card: grid = C CTAs, windows opened over IPC;
//   W ranks on one card: grid = W * C CTAs, rank = blockIdx.x / C, the W
//     windows in one allocation (the check of the protocol on one card).
// C comes from cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs / ranks
// on the card.
//
// Precondition (the wrapper checks it): x and out contiguous fp32, 16-byte
// aligned, width % 4 == 0 (the reference's width % 128 rule picks the tier),
// width <= cap.
//
// Bound.  The function reads x once and writes out once: (W + 1) * width *
// 4 bytes per rank over 3.35 TB/s, (W + 1) * W * width * 4 for W ranks on
// one card.  With one rank per card the (W - 1) packets of width fp32 that
// each rank must send over NVLink (450 GB/s one way) bound it as well.
// The ring moves more than the function needs: per hop each rank writes a
// packet and reads it back, (3W - 1) * W * width * 4 bytes on one card.
// Design: float4 loads and stores, one store and one load per packet
// element, no staging buffer; the handshake costs one flag round trip per
// hop, which a credit scheme could hide (as the reference notes).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr int FLAG_WORDS = 8;  // per CTA
constexpr int BARRIER = 0, HAND0 = 1, HAND1 = 2, RECV0 = 3;  // RECV0 + slot
constexpr long long HEADER_BYTES = 256;  // the error record: 4 words
constexpr int ERROR_WORDS = 4;           // stage, rank, CTA, hop

enum Stage {
  STAGE_BARRIER = 1,
  STAGE_HAND_LEFT = 2,
  STAGE_HAND_RIGHT = 3,
  STAGE_ARRIVAL = 4,
};

struct Layout {
  long long flags_off, slots_off, slot_elems, total;
};

inline long long round_up(long long v, long long m) {
  return (v + m - 1) / m * m;
}

Layout window_layout(int ctas, long long cap) {
  Layout l;
  l.flags_off = HEADER_BYTES;
  l.slots_off = round_up(HEADER_BYTES + (long long)ctas * FLAG_WORDS * 4, 256);
  l.slot_elems = round_up(cap, 64);
  l.total = l.slots_off + 2 * l.slot_elems * 4;
  return l;
}

struct RingParams {
  const float* x;   // local rank l's (world, width) rows at x + l * x_rank_elems
  float* out;       // local rank l's (width,) output at out + l * width
  char* base;       // one card: rank r's window at base + r * window_bytes
  char* self;       // one rank per card: the three windows
  char* left;
  char* right;
  long long window_bytes, width, x_rank_elems;
  long long flags_off, slots_off, slot_elems;
  long long timeout_cycles;
  unsigned gen;
  int rank;  // one rank per card: this rank
  int world;
  int ctas;  // CTAs per rank
  int one_card;
};

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.sys.add.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// true once *flag reaches target (wrap-safe), false after budget cycles
__device__ bool wait_for(const unsigned* flag, unsigned target,
                         long long budget) {
  const long long start = clock64();
  while ((int)(load_acquire(flag) - target) < 0) {
    if (clock64() - start > budget) return false;
    __nanosleep(64);
  }
  return true;
}

__device__ void report(unsigned* err, int rank, int cta, int stage, int hop) {
  if (atomicCAS(err, 0u, (unsigned)stage) == 0u) {
    err[1] = (unsigned)rank;
    err[2] = (unsigned)cta;
    err[3] = (unsigned)hop;
    __threadfence_system();
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__global__ void __launch_bounds__(THREADS)
rdma_ring_kernel(RingParams p) {
  __shared__ int abort_flag;
  const int local = blockIdx.x / p.ctas;
  const int cta = blockIdx.x % p.ctas;
  const int W = p.world;
  const int me = p.one_card ? local : p.rank;
  const int left = (me + W - 1) % W;
  const int right = (me + 1) % W;
  char* self_w = p.one_card ? p.base + me * p.window_bytes : p.self;
  char* left_w = p.one_card ? p.base + left * p.window_bytes : p.left;
  char* right_w = p.one_card ? p.base + right * p.window_bytes : p.right;
  unsigned* err = reinterpret_cast<unsigned*>(self_w);
  unsigned* mine =
      reinterpret_cast<unsigned*>(self_w + p.flags_off) + cta * FLAG_WORDS;
  unsigned* to_left =
      reinterpret_cast<unsigned*>(left_w + p.flags_off) + cta * FLAG_WORDS;
  unsigned* to_right =
      reinterpret_cast<unsigned*>(right_w + p.flags_off) + cta * FLAG_WORDS;
  const float4* my_slots =
      reinterpret_cast<const float4*>(self_w + p.slots_off);
  float4* right_slots = reinterpret_cast<float4*>(right_w + p.slots_off);
  const float* x = p.x + local * p.x_rank_elems;
  float4* out = reinterpret_cast<float4*>(p.out + local * p.width);

  // this CTA's columns, in float4 groups
  const long long groups = p.width / 4;
  const long long slot_groups = p.slot_elems / 4;
  const long long per = (groups + p.ctas - 1) / p.ctas;
  const long long g0 = min(groups, (long long)cta * per);
  const long long g1 = min(groups, g0 + per);

  const unsigned g = p.gen;
  const unsigned hops = (unsigned)(W - 1);
  // packets per call into slot 0 and slot 1 (hop t lands in (t + 1) % 2)
  const unsigned per_slot[2] = {(unsigned)(W - 1) / 2, (unsigned)W / 2};
  auto arrival = [&](int t) {  // recv count once hop t's packet is in
    return (g - 1) * per_slot[(t + 1) % 2] + (unsigned)(t / 2) + 1;
  };

  if (threadIdx.x == 0) {
    abort_flag = 0;
    if (load_acquire(err) != 0u) {
      abort_flag = 1;  // the window is broken: leave before signalling
    } else {
      add_release(to_left + BARRIER, 1);
      add_release(to_right + BARRIER, 1);
      if (!wait_for(mine + BARRIER, 2u * g, p.timeout_cycles)) {
        report(err, me, cta, STAGE_BARRIER, 0);
        abort_flag = 1;
      }
    }
  }
  __syncthreads();
  if (abort_flag) return;

  for (int t = 0; t < W - 1; ++t) {
    if (threadIdx.x == 0) {
      const unsigned hand = (g - 1) * hops + (unsigned)t + 1;
      add_release(to_left + HAND1, 1);
      add_release(to_right + HAND0, 1);
      int stage = 0;
      if (!wait_for(mine + HAND0, hand, p.timeout_cycles)) {
        stage = STAGE_HAND_LEFT;
      } else if (!wait_for(mine + HAND1, hand, p.timeout_cycles)) {
        stage = STAGE_HAND_RIGHT;
      } else if (t > 0 && !wait_for(mine + RECV0 + t % 2, arrival(t - 1),
                                    p.timeout_cycles)) {
        stage = STAGE_ARRIVAL;
      }
      if (stage) {
        report(err, me, cta, stage, t);
        abort_flag = 1;
      }
    }
    __syncthreads();
    if (abort_flag) return;
    const float4* row = reinterpret_cast<const float4*>(
        x + (long long)((me - t - 1 + W) % W) * p.width);
    const float4* in = my_slots + (long long)(t % 2) * slot_groups;
    float4* dst = right_slots + (long long)((t + 1) % 2) * slot_groups;
    for (long long i = g0 + threadIdx.x; i < g1; i += THREADS) {
      float4 v = __ldg(row + i);
      if (t > 0) v = add4(__ldcg(in + i), v);
      __stcg(dst + i, v);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence_system();
      add_release(to_right + RECV0 + (t + 1) % 2, 1);
    }
  }

  if (threadIdx.x == 0 &&
      !wait_for(mine + RECV0 + (W - 1) % 2, arrival(W - 2),
                p.timeout_cycles)) {
    report(err, me, cta, STAGE_ARRIVAL, W - 1);
    abort_flag = 1;
  }
  __syncthreads();
  if (abort_flag) return;
  const float4* row =
      reinterpret_cast<const float4*>(x + (long long)me * p.width);
  const float4* in = my_slots + (long long)((W - 1) % 2) * slot_groups;
  for (long long i = g0 + threadIdx.x; i < g1; i += THREADS)
    out[i] = add4(__ldcg(in + i), __ldg(row + i));
}

}  // namespace

extern "C" {

// [flags offset, slots offset, elements per slot, total bytes] of a window
int dlrover_rdma_layout(int ctas, long long cap, long long* layout) {
  if (ctas <= 0 || cap <= 0) return (int)cudaErrorInvalidValue;
  const Layout l = window_layout(ctas, cap);
  layout[0] = l.flags_off;
  layout[1] = l.slots_off;
  layout[2] = l.slot_elems;
  layout[3] = l.total;
  return 0;
}

// CTAs per rank such that `ranks_on_card` ranks' grids are resident
// together on the current device; and the cycles of about `seconds`
int dlrover_rdma_launch_shape(int ranks_on_card, double seconds, int* ctas,
                              long long* timeout_cycles) {
  int dev = 0, sms = 0, per_sm = 0, clock_khz = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rdma_ring_kernel, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  long long c = (long long)per_sm * sms / ranks_on_card;
  if (c > 2LL * sms) c = 2LL * sms;
  if (c < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *ctas = (int)c;
  *timeout_cycles = (long long)(seconds * clock_khz * 1000.0);
  return 0;
}

// device memory of `bytes`, zeroed before it returns
int dlrover_rdma_alloc(long long bytes, void** ptr) {
  cudaError_t e = cudaMalloc(ptr, (size_t)bytes);
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, (size_t)bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

int dlrover_rdma_free(void* ptr) { return (int)cudaFree(ptr); }

int dlrover_rdma_ipc_handle(void* ptr, void* handle) {
  return (int)cudaIpcGetMemHandle((cudaIpcMemHandle_t*)handle, ptr);
}

int dlrover_rdma_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int dlrover_rdma_ipc_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

int dlrover_rdma_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// synchronous copy between device pointers (peer windows included)
int dlrover_rdma_copy(void* dst, const void* src, long long bytes) {
  return (int)cudaMemcpy(dst, src, (size_t)bytes, cudaMemcpyDefault);
}

int dlrover_rdma_ring(const void* x, void* out, void* base, void* self,
                      void* left, void* right, long long window_bytes,
                      long long width, long long cap, int rank, int world,
                      int ctas, unsigned gen, int one_card,
                      long long timeout_cycles, void* stream) {
  if (world < 2 || width <= 0 || width % 4 || width > cap || ctas <= 0 ||
      gen == 0)
    return (int)cudaErrorInvalidValue;
  const Layout l = window_layout(ctas, cap);
  if (l.total > window_bytes) return (int)cudaErrorInvalidValue;
  RingParams p;
  p.x = (const float*)x;
  p.out = (float*)out;
  p.base = (char*)base;
  p.self = (char*)self;
  p.left = (char*)left;
  p.right = (char*)right;
  p.window_bytes = window_bytes;
  p.width = width;
  p.x_rank_elems = (long long)world * width;
  p.flags_off = l.flags_off;
  p.slots_off = l.slots_off;
  p.slot_elems = l.slot_elems;
  p.timeout_cycles = timeout_cycles;
  p.gen = gen;
  p.rank = rank;
  p.world = world;
  p.ctas = ctas;
  p.one_card = one_card;
  void* args[] = {&p};
  const unsigned grid = (unsigned)(one_card ? world * ctas : ctas);
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)rdma_ring_kernel, dim3(grid), dim3(THREADS), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the error records of `windows` windows spaced window_bytes apart, into
// host[4 * windows], after the stream's work so far
int dlrover_rdma_errors(const void* base, long long window_bytes, int windows,
                        unsigned* host, void* stream) {
  cudaError_t e = cudaMemcpy2DAsync(
      host, ERROR_WORDS * sizeof(unsigned), base, (size_t)window_bytes,
      ERROR_WORDS * sizeof(unsigned), (size_t)windows, cudaMemcpyDeviceToHost,
      (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaStreamSynchronize((cudaStream_t)stream);
  return (int)e;
}

}  // extern "C"
