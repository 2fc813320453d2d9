// The whole exact ring reduce-scatter as ONE kernel over peer memory, for
// Hopper (sm_90a): packets cut into chunks and passed under credits.
//
// Replaces the Pallas TPU kernel _rdma_ring_kernel of
// dlrover_tpu/ops/pallas/ring_reduce_scatter.py (:257; pallas_call :342 in
// rdma_ring_reduce_scatter).  There each replica holds x of shape
// (world, width) and ends with its row of the sum, sum_j x_j[me], after
// world - 1 hops: a packet starts as x[(me - 1) % W], moves one hop right
// per step through a 2-slot double-buffered remote copy, and on arrival
// gets x[(me - t - 2) % W] added.  The add order is the reference's, so
// the result is bit-identical to the jax-level ring (and to the port's
// `ring` and `ring_pallas` tiers): every add is __fadd_rn(packet, row),
// in hop order, and no element's adds are reordered across chunks.
//
// What the TPU runtime gave the kernel, a window gives it here: each rank
// owns one cudaMalloc allocation (its window) holding an error record, 8
// flag words per CTA (the barrier, arrival and credit counters) and a ring
// of `slots` chunk-sized receive slots per CTA.  The kernel reaches its left
// and right neighbours' windows through pointers: opened with
// cudaIpcOpenMemHandle when each rank has a card of its own, or inside one
// allocation when W ranks share one card.
//
// Bound.  The function reads x once and writes out once: (W + 1) * width *
// 4 bytes per rank over 3.35 TB/s, (W + 1) * W * width * 4 for W ranks on
// one card.  With one rank per card the (W - 1) packets of width fp32 that
// each rank must send over NVLink (450 GB/s one way) bound it as well.
// The ring adds a write and a read of every packet on every hop,
// 2 (W - 1) * W * width * 4 bytes on one card.  This kernel's first design
// moved a CTA's whole column range through a slot of `cap` floats per hop,
// so at the dp leg's 16,384,000-wide row W = 4 ranks held 524 MB of slots:
// every packet went to HBM and back, (3W - 1) * W * width * 4 = 2.88 GB
// where the function needs 1.31 GB, and it ran at 1.07 ms against the
// 0.39 ms bound (NVIDIA H100 80GB HBM3, 700 W; PERF.md row 9).
//
// Design.  The row is cut into chunks of CHUNK_GROUPS float4s (8 KB).
// CTA c owns chunks c, c + C, c + 2C, ... (C CTAs per rank), so every CTA
// of every rank runs the same `chunks` = ceil(ceil(width / 2048) / C)
// chunk steps per call; a CTA whose chunk lies past the row still runs the
// protocol and moves no data.  The packets run through a ring of S slots
// per CTA in the right neighbour's window under credits:
//   * a wavefront: at step s a CTA does hop t of chunk s - t for every
//     t in 0 .. W - 1 whose chunk exists (hop 0 sends
//     x[(me - 1) % W]; hop t in 1 .. W - 2 adds x[(me - t - 1) % W] to
//     the packet of hop t - 1 in its slot and sends it on; hop W - 1 adds
//     x[me] and writes out).  So step s takes exactly the packets that the
//     left neighbour sent at its step s - 1, in the same hop order, and
//     the packets of one step wait on one flag of the left neighbour, not
//     on a chain of W - 1 hops (a chunk-major order would pay W - 1 flag
//     latencies per chunk);
//   * counters: each CTA numbers its packets from the window's running
//     count `base` (the host adds chunks * (W - 1) per call, the same on
//     every rank and CTA); packet q goes into slot q % S.  Before step s a
//     CTA waits until its arrival counter (raised by the left neighbour
//     after its stores) covers the packets it takes, and until its credit
//     counter (raised by the right neighbour after it drained them) shows
//     that the slots it writes are free: drained >= sent + n_out - S.
//     Once the step is done, n_out goes to the right neighbour's arrivals
//     and n_in to the left neighbour's credits.  The counters are never
//     reset and every wait is wrap-safe ((int)(a - b) < 0), so calls of
//     any widths follow each other on one window;
//   * S = SLOT_STEPS * (W - 1) with SLOT_STEPS >= 2: with every CTA of
//     the ring done with step s - 1, step s finds its arrivals (sent at
//     s - 1) and its credits (the right neighbour drained everything sent
//     before s - 1), so no CTA waits on a cycle; a slot fewer deadlocks.
//     The host takes SLOT_STEPS 3, a step of slack on the credits (PERF.md:
//     2 ran 0.80 ms, 3 0.72 at W = 4, width 16,384,000).
//     tests/test_torch_rdma_protocol.py
//     runs a Python model of exactly these counters, slots and targets
//     under random interleavings (W = 2, 3, 4, 8; no deadlock, no
//     overwrite of an undrained slot, adds in hop order, the plain
//     version's bits);
//   * the slots stay in L2: the host caps the CTAs so that the slots of
//     every rank on a card take at most 24 MB of its 50 MB (W = 4 on one
//     card: 4 ranks x 66 CTAs x 9 slots x 8 KB = 19.5 MB), and a packet is
//     read back about a step after it was written.  out, written once, is
//     stored with st.global.cs (evict first); slots go through
//     ld/st.global.cg (L2, never a stale L1 line) under an L2 evict_last
//     policy (createpolicy; no device-wide L2 state is touched);
//   * bytes in flight: every thread issues the loads of up to HOP_BATCH
//     hops (x with ld.global.cs, evict first: it is read once; the packet
//     from its slot) before it adds and stores any, 16 float4s at W = 4;
//   * fences by scope, one kernel body: the one-card form acquires and
//     releases at .gpu scope, the form with a card per rank at .sys scope
//     (template parameter SYS).  One thread per CTA waits (an acquire
//     load, then __syncthreads()); after the step's stores, __syncthreads()
//     and one release add by that thread (release is cumulative) raise the
//     neighbours' counters.
//
// What bounds it on one card (PERF.md): L2, not HBM.  Each packet is
// written to a slot and read back, so the one-card form moves x (1.05 GB
// at W = 4, width 16,384,000), out (0.26 GB) and the packets (2 x 0.79 GB)
// through L2: 2.88 GB, of which 1.31 GB reach HBM.  It ran at 0.69-0.72 ms
// (~4.1 TB/s through L2; NVIDIA H100 80GB HBM3, 700 W).  A variant that fed
// x through shared memory with TMA and gave the waits and the releases
// warps of their own ran no faster (0.70 ms); without its packets' loads
// and stores it ran at 0.49 ms, and so it did without x's loads.  With a
// card per rank the packets leave the card over NVLink instead.
//
// The protocol around the steps is the reference's.  1. Entry barrier:
// signal both neighbours' barrier words, wait for my own to reach 2g (g =
// 1, 2, ... the windows' generation).  2. The steps above.  Every wait is
// bounded by clock64 (the window's timeout, a minute by default): a wait
// that runs out writes the window's error record (stage, rank, CTA, step)
// and the CTA leaves.  The record is never cleared, and a CTA whose window
// has one leaves before it signals, so a stuck peer costs one timeout and
// not one per call.  The host reads the record once per step (the
// windows' check()) and raises: a stuck peer gives an error, never a hang.
//
// Two launch forms of the one __global__, both with
// cudaLaunchCooperativeKernel, which refuses a grid that cannot be resident
// all at once (CTAs that wait on each other must all run):
//   one rank per card: grid = C CTAs, windows opened over IPC, .sys scope;
//   W ranks on one card: grid = W * C CTAs, rank = blockIdx.x / C, the W
//     windows in one allocation, .gpu scope (the check of the protocol on
//     one card).
// C = min(occupancy, ctas_per_sm) x SMs / ranks on the card, capped by the
// host's slot budget.
//
// Precondition (the wrapper checks it): x and out contiguous fp32, 16-byte
// aligned, width % 4 == 0 (the reference's width % 128 rule picks the tier).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr int GPT = 2;  // float4s a thread moves per packet
constexpr int CHUNK_GROUPS = GPT * THREADS;  // float4s per chunk: 8 KB
constexpr int HOP_BATCH = 4;  // hops whose loads are in flight together
constexpr int FLAG_WORDS = 8;  // per CTA
constexpr int BARRIER = 0, ARRIVED = 1, CREDITS = 2;
constexpr long long HEADER_BYTES = 256;  // the error record: 4 words
constexpr int ERROR_WORDS = 4;           // stage, rank, CTA, step

enum Stage {
  STAGE_BARRIER = 1,
  STAGE_ARRIVAL = 2,
  STAGE_CREDIT = 3,
};

struct Layout {
  long long flags_off, slots_off, total;
};

inline long long round_up(long long v, long long m) {
  return (v + m - 1) / m * m;
}

Layout window_layout(int ctas, int slots) {
  Layout l;
  l.flags_off = HEADER_BYTES;
  l.slots_off = round_up(HEADER_BYTES + (long long)ctas * FLAG_WORDS * 4, 256);
  l.total = l.slots_off + (long long)ctas * slots * CHUNK_GROUPS * 16;
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
  long long flags_off, slots_off;
  long long timeout_cycles;
  unsigned long long packets;  // packets each CTA sent before this call
  unsigned gen;
  int rank;  // one rank per card: this rank
  int world;
  int ctas;    // CTAs per rank
  int chunks;  // chunk steps per CTA in this call
  int slots;   // slots per CTA
};

template <bool SYS>
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  if constexpr (SYS)
    asm volatile("ld.acquire.sys.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <bool SYS>
__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  if constexpr (SYS)
    asm volatile("red.release.sys.add.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
  else
    asm volatile("red.release.gpu.add.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

// true once *flag reaches target (wrap-safe), false after budget cycles
template <bool SYS>
__device__ bool wait_for(const unsigned* flag, unsigned target,
                         long long budget) {
  if ((int)(load_acquire<SYS>(flag) - target) >= 0) return true;
  const long long start = clock64();
  while ((int)(load_acquire<SYS>(flag) - target) < 0) {
    if (clock64() - start > budget) return false;
    __nanosleep(32);
  }
  return true;
}

__device__ void report(unsigned* err, int rank, int cta, int stage, int step) {
  if (atomicCAS(err, 0u, (unsigned)stage) == 0u) {
    err[1] = (unsigned)rank;
    err[2] = (unsigned)cta;
    err[3] = (unsigned)step;
    __threadfence_system();
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ float4 load_slot(const float4* p, uint64_t policy) {
  float4 v;
  asm volatile("ld.global.cg.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p), "l"(policy)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_slot(float4* p, float4 v,
                                           uint64_t policy) {
  asm volatile(
      "st.global.cg.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;"
      :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(policy)
      : "memory");
}

// SYS: one rank per card (windows over IPC, .sys scope); else W ranks on
// one card (.gpu scope)
template <bool SYS>
__global__ void __launch_bounds__(THREADS, 2)
rdma_ring_kernel(RingParams p) {
  __shared__ int abort_flag;
  const int local = blockIdx.x / p.ctas;
  const int cta = blockIdx.x % p.ctas;
  const int W = p.world;
  const int me = SYS ? p.rank : local;
  const int left = (me + W - 1) % W;
  const int right = (me + 1) % W;
  char* self_w = SYS ? p.self : p.base + me * p.window_bytes;
  char* left_w = SYS ? p.left : p.base + left * p.window_bytes;
  char* right_w = SYS ? p.right : p.base + right * p.window_bytes;
  unsigned* err = reinterpret_cast<unsigned*>(self_w);
  unsigned* mine =
      reinterpret_cast<unsigned*>(self_w + p.flags_off) + cta * FLAG_WORDS;
  unsigned* to_left =
      reinterpret_cast<unsigned*>(left_w + p.flags_off) + cta * FLAG_WORDS;
  unsigned* to_right =
      reinterpret_cast<unsigned*>(right_w + p.flags_off) + cta * FLAG_WORDS;
  const long long my_ring = (long long)cta * p.slots * CHUNK_GROUPS;
  const float4* my_slots =
      reinterpret_cast<const float4*>(self_w + p.slots_off) + my_ring;
  float4* right_slots = reinterpret_cast<float4*>(right_w + p.slots_off) +
                        my_ring;
  const long long groups = p.width / 4;
  const float4* x =
      reinterpret_cast<const float4*>(p.x + local * p.x_rank_elems);
  float4* out = reinterpret_cast<float4*>(p.out + local * p.width);
  const uint64_t policy = evict_last_policy();

  if (threadIdx.x == 0) {
    abort_flag = 0;
    if (load_acquire<SYS>(err) != 0u) {
      abort_flag = 1;  // the window is broken: leave before signalling
    } else {
      add_release<SYS>(to_left + BARRIER, 1);
      add_release<SYS>(to_right + BARRIER, 1);
      if (!wait_for<SYS>(mine + BARRIER, 2u * p.gen, p.timeout_cycles)) {
        report(err, me, cta, STAGE_BARRIER, 0);
        abort_flag = 1;
      }
    }
  }
  __syncthreads();
  if (abort_flag) return;

  const int n = p.chunks, S = p.slots;
  // packets sent and taken so far, counted from the window's base; the
  // slot of the next packet out and of the next packet in
  unsigned sent = (unsigned)p.packets, taken = (unsigned)p.packets;
  int out_slot = (int)(p.packets % (unsigned long long)S);
  int in_slot = out_slot;
  const int steps = n + W - 1;
  for (int s = 0; s < steps; ++s) {
    // step s does hop t of chunk s - t for t in [lo, hi]; hops up to W - 2
    // send a packet, hops from 1 take one
    const int lo = max(0, s - n + 1);
    const int hi = min(W - 1, s);
    const int in_lo = max(lo, 1);
    const int n_out = max(0, min(hi, W - 2) - lo + 1);
    const int n_in = max(0, hi - in_lo + 1);
    if (threadIdx.x == 0) {
      int stage = 0;
      if (n_in && !wait_for<SYS>(mine + ARRIVED, taken + (unsigned)n_in,
                                 p.timeout_cycles)) {
        stage = STAGE_ARRIVAL;
      } else if (n_out &&
                 !wait_for<SYS>(mine + CREDITS,
                                sent + (unsigned)n_out - (unsigned)S,
                                p.timeout_cycles)) {
        stage = STAGE_CREDIT;
      }
      if (stage) {
        report(err, me, cta, stage, s);
        abort_flag = 1;
      }
    }
    __syncthreads();
    if (abort_flag) return;

    for (int t0 = lo; t0 <= hi; t0 += HOP_BATCH) {
      float4 xv[HOP_BATCH][GPT], sv[HOP_BATCH][GPT];
      long long col[HOP_BATCH];
#pragma unroll
      for (int u = 0; u < HOP_BATCH; ++u) {
        const int t = t0 + u;
        col[u] = ((long long)(s - t) * p.ctas + cta) * CHUNK_GROUPS +
                 threadIdx.x;
        if (t > hi) continue;
        const float4* row = x + (long long)((me - t - 1 + W) % W) * groups;
        int k = in_slot + t - in_lo;
        if (k >= S) k -= S;
        const float4* in = my_slots + (long long)k * CHUNK_GROUPS +
                           threadIdx.x;
#pragma unroll
        for (int g = 0; g < GPT; ++g) {
          const long long i = col[u] + g * THREADS;
          if (i < groups) {
            xv[u][g] = __ldcs(row + i);
            if (t > 0) sv[u][g] = load_slot(in + g * THREADS, policy);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < HOP_BATCH; ++u) {
        const int t = t0 + u;
        if (t > hi) continue;
        int k = out_slot + t - lo;
        if (k >= S) k -= S;
        float4* dst = right_slots + (long long)k * CHUNK_GROUPS + threadIdx.x;
#pragma unroll
        for (int g = 0; g < GPT; ++g) {
          const long long i = col[u] + g * THREADS;
          if (i < groups) {
            const float4 v = t > 0 ? add4(sv[u][g], xv[u][g]) : xv[u][g];
            if (t < W - 1)
              store_slot(dst + g * THREADS, v, policy);
            else
              __stcs(out + i, v);
          }
        }
      }
    }

    __syncthreads();
    if (threadIdx.x == 0) {
      if (n_out) add_release<SYS>(to_right + ARRIVED, (unsigned)n_out);
      if (n_in) add_release<SYS>(to_left + CREDITS, (unsigned)n_in);
    }
    sent += (unsigned)n_out;
    taken += (unsigned)n_in;
    out_slot = (out_slot + n_out) % S;
    in_slot = (in_slot + n_in) % S;
  }
}

}  // namespace

extern "C" {

// fp32 elements per chunk (the host's chunk plan must use the same)
int dlrover_rdma_chunk_elems() { return CHUNK_GROUPS * 4; }

// [flags offset, slots offset, total bytes] of a window
int dlrover_rdma_layout(int ctas, int slots, long long* layout) {
  if (ctas <= 0 || slots <= 0) return (int)cudaErrorInvalidValue;
  const Layout l = window_layout(ctas, slots);
  layout[0] = l.flags_off;
  layout[1] = l.slots_off;
  layout[2] = l.total;
  return 0;
}

// CTAs per rank such that `ranks_on_card` ranks' grids are resident
// together on the current device, at most `ctas_per_sm` a multiprocessor;
// and the cycles of about `seconds`
int dlrover_rdma_launch_shape(int ranks_on_card, int ctas_per_sm,
                              double seconds, int* ctas,
                              long long* timeout_cycles) {
  int dev = 0, sms = 0, per_sm = 0, clock_khz = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, dev);
  // both instances take the same resources; ask for the tighter
  int per_sm_gpu = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rdma_ring_kernel<true>, THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm_gpu, rdma_ring_kernel<false>, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm_gpu < per_sm) per_sm = per_sm_gpu;
  if (ctas_per_sm > 0 && ctas_per_sm < per_sm) per_sm = ctas_per_sm;
  const long long c = (long long)per_sm * sms / ranks_on_card;
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

// one call of the ring: `chunks` chunk steps per CTA (the host's chunk
// plan), packets numbered from `packets`, entry barrier generation `gen`
int dlrover_rdma_ring(const void* x, void* out, void* base, void* self,
                      void* left, void* right, long long window_bytes,
                      long long width, int rank, int world, int ctas,
                      int slots, int chunks,
                      unsigned long long packets, unsigned gen, int one_card,
                      long long timeout_cycles, void* stream) {
  if (world < 2 || width <= 0 || width % 4 || ctas <= 0 || gen == 0 ||
      slots < 2 * (world - 1) || chunks < 1 ||
      (long long)chunks * ctas * CHUNK_GROUPS * 4 < width)
    return (int)cudaErrorInvalidValue;
  const Layout l = window_layout(ctas, slots);
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
  p.timeout_cycles = timeout_cycles;
  p.packets = packets;
  p.gen = gen;
  p.rank = rank;
  p.world = world;
  p.ctas = ctas;
  p.chunks = chunks;
  p.slots = slots;
  void* args[] = {&p};
  const unsigned grid = (unsigned)(one_card ? world * ctas : ctas);
  const void* kernel = one_card ? (const void*)rdma_ring_kernel<false>
                                : (const void*)rdma_ring_kernel<true>;
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(THREADS), args, 0, (cudaStream_t)stream);
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
