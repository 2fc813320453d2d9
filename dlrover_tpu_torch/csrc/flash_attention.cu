// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of
// dlrover_tpu/ops/pallas/flash_attention.py:
//   fa_fwd_kernel     <- _flash_fwd_kernel     (:64, pallas_call :158)
//   fa_bwd_dq_kernel  <- _flash_bwd_dq_kernel  (:195, pallas_call :324)
//   fa_bwd_dkv_kernel <- _flash_bwd_dkv_kernel (:239, pallas_call :352)
// and computes in fp32 what they compute: scores S = QK^T * scale with the
// causal mask filled with NEG_INF = -1e30, an online softmax with running
// (m, l) and the l == 0 guard, LSE = m + log(l) as the backward residual,
// P = exp(S - LSE), dS = P * (dO V^T - delta) * scale, dQ = dS K,
// dV = P^T dO and dK = dS^T Q.  delta = rowsum(dO * O) is computed by the
// caller, as on the TPU.
//
// Layout: q/out/dout/dq/dk/dv are [B, S, H, D] and k/v are [B, S, Hkv, D],
// row-major and contiguous, read in place (no head transpose).  GQA maps
// q head h to kv head h / (H / Hkv).  LSE and delta are [B*H, S] fp32 (the
// TPU's 128-lane broadcast of these residuals was a tiling artifact).
// Inputs are bf16; D is 64 or 128; any S works (rows past S are
// zero-filled on load and masked as keys, never stored).
//
// Bound on an H100 SXM: at the training shape (B=4, S=2048, H=16, D=128,
// causal) the forward does 2 products of 2*B*H*D*S(S+1)/2 flop each
// (~69 GFLOP, ~70 us at 989 TFLOP/s bf16) against ~134 MB of traffic
// (~40 us at 3.35 TB/s); dQ does 3 such products and dK/dV 4, against
// similar traffic (dQ: 103 GFLOP, ~104 us).  All three kernels are bound by
// tensor-core operations, not bytes, and only wgmma reaches the tensor
// cores' full rate on Hopper.
//
// All three kernels (hopper.cuh has the building blocks) are
// warp-specialised: one producer warp keeps TMA loads of 128-byte-swizzled
// tiles in flight through 2-stage rings (a full and an empty mbarrier per
// stage) while two consumer warpgroups run wgmma on the tiles that have
// arrived, scores and accumulators in registers (setmaxnreg gives the
// consumers 240 registers a thread and leaves the producer 24).
//   forward: a CTA holds a 128-row Q tile (64 rows per consumer) and
//     streams 128-row K and V tiles, each through a ring of its own;
//     S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
//     memory, the online softmax (exp2 with a log2(e)-prescaled scale)
//     works on the accumulator, and O += P V is wgmma with P re-packed
//     from the S accumulator as the register A operand and V read
//     MN-major.  The loop is software-pipelined: tile j's softmax runs
//     while P_{j-1} V_{j-1} is on the tensor cores, and a K stage is
//     released as soon as its Q K^T is done.
//   dK/dV: a CTA holds a 128-row K/V tile (64 kv rows per consumer) and
//     streams 64-row Q/dO tiles with their lse/delta rows; S^T = K Q^T and
//     dP^T = V dO^T are wgmma m64n64k16 (K-major), then P^T = exp(S^T scale
//     - lse), dS^T = P^T (dP^T - delta) scale, and dV += P^T dO,
//     dK += dS^T Q are wgmma with A from registers and B = dO, Q MN-major;
//     dK and dV stay in registers for the whole kernel.
//   dQ, the forward's mirror: a CTA holds a 128-row Q tile and a 128-row
//     dO tile (64 rows per consumer), loaded once, and streams 128-row K
//     and V tiles through a ring each; S = Q K^T and dP = dO V^T are wgmma
//     m64n128k16 with both operands K-major, then P = exp(S scale - lse)
//     and dS = P (dP - delta) scale on the accumulators (lse and delta of
//     the thread's two rows sit in registers), and dQ += dS K is wgmma with
//     dS re-packed as the register A operand and K read MN-major, as the
//     forward reads V.  A V stage is released once dP is done, a K stage
//     once dS K is.  dQ stays in registers; a warpgroup whose rows are all
//     past S skips the products.  The consumer's arrays take dQ (D/2) + S
//     and dP (BN/2 each) + dS packed (BN/4) = 224 registers a thread at
//     D = 128 and BN = 128, without spills under 240.  The loop is not
//     software-pipelined: issuing tile j+1's S and dP while dS_j K_j runs
//     measured slower (and spills at BN = 128).
// Under the causal mask, tiles past the diagonal are never loaded and only
// the diagonal (and a ragged last) tile is masked; the forward and dQ
// launch their longest q tiles first, the dK/dV its longest kv tiles
// first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using hopper::pack_bf16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------

constexpr int WG = 128;                   // threads of a warpgroup
constexpr int HOPPER_THREADS = 3 * WG;    // 2 consumer warpgroups, 1 producer
constexpr int CONSUMER_REGS = 240;        // (2 * 240 + 24) / 3 = 168 a thread
constexpr int PRODUCER_REGS = 24;

// Fill the masked entries of a 64 x N accumulator tile with NEG_INF.  The
// thread's entry d[4n + e] sits at row mrow + 8 * (e >> 1), column
// ncol + 8n + (e & 1).  Forward and dQ (TRANS false; rows are queries,
// columns keys): a key past S, or past the query under the causal mask, is
// masked.  dK/dV (TRANS true; rows are keys, columns queries): a query past
// S, or a query before the key under the causal mask.
template <int N, bool TRANS>
__device__ __forceinline__ void mask_tile(float (&d)[N / 2], int mrow, int ncol,
                                          int S, bool causal) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = mrow + 8 * (e >> 1);
      const int col = ncol + 8 * n + (e & 1);
      const bool future = TRANS ? row > col : col > row;
      if (col >= S || (causal && future)) d[4 * n + e] = NEG_INF;
    }
  }
}

// Store a warpgroup's 64 x D fp32 accumulator (times mul[row half]) as
// bf16 rows row + g and row + g + 8 of a [.., D] global tensor with row
// stride gstride; rows >= S are skipped.
template <int D>
__device__ __forceinline__ void store_acc(bf16* base, long gstride, int row,
                                          int S, const float (&acc)[D / 2],
                                          const float (&mul)[2], int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= S) continue;
    bf16* dst = base + (long)(row + 8 * h) * gstride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack_bf16(
          acc[4 * n + 2 * h] * mul[h], acc[4 * n + 2 * h + 1] * mul[h]);
    }
  }
}

// 1024-byte aligned start of the dynamic shared memory (the swizzle atoms
// need it; the launch asks for 1 KB more than the layout uses).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = hopper::smem_u32(raw);
  return raw + (((a + 1023) & ~1023u) - a);
}

// ---------------------------------------------------------------------------
// forward: grid (B*H, ceil(S/128)), the longest causal q tiles first;
// writes out [B,S,H,D] and lse [B*H, S]
// ---------------------------------------------------------------------------

constexpr int FWD_BM = 128;    // q rows per CTA, 64 per consumer warpgroup
constexpr int FWD_BN = 128;    // kv rows per streamed tile
constexpr int FWD_STAGES = 2;  // depth of the K ring and of the V ring

template <int D>
struct FwdSmem {
  static constexpr int Q = 0;
  static constexpr int TILE = FWD_BN * D * 2;
  static constexpr int K = FWD_BM * D * 2;           // FWD_STAGES K tiles
  static constexpr int V = K + FWD_STAGES * TILE;    // FWD_STAGES V tiles
  static constexpr int BARS = V + FWD_STAGES * TILE;
  // q_full, then full and empty of each K stage and of each V stage
  static constexpr int BYTES = BARS + (1 + 4 * FWD_STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
    fa_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  bf16* __restrict__ out, float* __restrict__ lse, int S,
                  int H, int Hkv, float scale, int causal) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem + FwdSmem<D>::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + FwdSmem<D>::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + FwdSmem<D>::V);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + FwdSmem<D>::BARS);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + FWD_STAGES;
  uint64_t* v_full = k_empty + FWD_STAGES;
  uint64_t* v_empty = v_full + FWD_STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int n_q = gridDim.y;
  const int q0 = (n_q - 1 - blockIdx.y) * FWD_BM;
  const int n_kv = (S + FWD_BN - 1) / FWD_BN;
  // causal block skip: kv tile j is needed iff j*BN <= q0 + BM - 1
  const int kv_end = causal ? min(n_kv, (q0 + FWD_BM - 1) / FWD_BN + 1) : n_kv;
  // the last tile carries the mask: the diagonal, or keys past S
  const bool last_masked = causal || kv_end * FWD_BN > S;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 2 * WG);
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 2 * WG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG) {
    // producer warpgroup: one thread issues every copy, in the order the
    // consumers take the tiles (K_0, then K_j before V_{j-1})
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      auto load = [&](const CUtensorMap* map, bf16* ring, uint64_t* full,
                      uint64_t* empty, int j) {
        const int st = j % FWD_STAGES;
        mbar_wait(&empty[st], ((j / FWD_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], FWD_BN * D * 2);
        tma_load_tile<D, FWD_BN>(ring + st * FWD_BN * D, map, hk, j * FWD_BN,
                                 b, &full[st]);
      };
      mbar_arrive_expect_tx(q_full, FWD_BM * D * 2);
      tma_load_tile<D, FWD_BM>(Qs, &tm_q, h, q0, b, q_full);
      load(&tm_k, Ks, k_full, k_empty, 0);
      for (int j = 1; j < kv_end; ++j) {
        load(&tm_k, Ks, k_full, k_empty, j);
        load(&tm_v, Vs, v_full, v_empty, j - 1);
      }
      load(&tm_v, Vs, v_full, v_empty, kv_end - 1);
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int row = q0 + wg * 64 + (tid / 32) * 16 + g;  // and row + 8
    const float scale_log2 = scale * LOG2E;
    const uint32_t q_base = smem_u32(Qs);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};  // m in log2 units
    float s[FWD_BN / 2];         // scores of tile j, then its probabilities
    uint32_t p[FWD_BN / 16][4];  // P of tile j - 1 as the A operand of P V
    auto issue_qk = [&](int j) {  // s = Q K_j^T
      const uint32_t k_base = smem_u32(Ks + (j % FWD_STAGES) * FWD_BN * D);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<FWD_BN>::ss(s, desc_k(q_base, FWD_BM, wg * 64, kk),
                          desc_k(k_base, FWD_BN, 0, kk), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {  // o += P_j V_j
      const uint32_t v_base = smem_u32(Vs + (j % FWD_STAGES) * FWD_BN * D);
#pragma unroll
      for (int kk = 0; kk < FWD_BN / 16; ++kk) {
        Wgmma<D>::rs(o, p[kk], desc_mn(v_base, FWD_BN, kk), 1);
      }
      wgmma_commit();
    };
    // Online softmax of tile j on s (in place: s becomes P_j, unrounded);
    // returns the factor that rescales what O has summed so far.
    auto softmax = [&](int j, float (&corr)[2]) {
      if (j == kv_end - 1 && last_masked) {
        mask_tile<FWD_BN, false>(s, row, j * FWD_BN + 2 * t, S, causal);
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < FWD_BN / 2; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
      float neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_i[r], mx[r] * scale_log2);
        corr[r] = exp2f(m_i[r] - m_new);
        m_i[r] = m_new;
        neg_m[r] = -m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < FWD_BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2f(fmaf(s[i], scale_log2, neg_m[r]));
        rs[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l_i[r] = l_i[r] * corr[r] + rs[r];
      }
    };

    // Software pipeline: while the softmax of tile j runs, the tensor
    // cores work on P_{j-1} V_{j-1}.  K_j's stage is released as soon as
    // Q K_j^T is done, V_{j-1}'s once P_{j-1} V_{j-1} is.
    auto wait_tile = [&](uint64_t* full, int j) {
      mbar_wait(&full[j % FWD_STAGES], (j / FWD_STAGES) & 1);
    };
    mbar_wait(q_full, 0);
    wait_tile(k_full, 0);
    wgmma_fence();
    issue_qk(0);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(&k_empty[0]);
    {
      float corr[2];
      softmax(0, corr);  // o is still zero: nothing to rescale
    }
    pack_a<FWD_BN>(p, s);
    for (int j = 1; j < kv_end; ++j) {
      wait_tile(k_full, j);
      wait_tile(v_full, j - 1);
      wgmma_fence();
      issue_qk(j);
      issue_pv(j - 1);
      wgmma_wait<1>();  // s = Q K_j^T has landed
      fence_regs(s);
      mbar_arrive(&k_empty[j % FWD_STAGES]);
      float corr[2];
      softmax(j, corr);
      wgmma_wait<0>();  // o += P_{j-1} V_{j-1} has landed
      fence_regs(o);
      fence_regs(p);
      mbar_arrive(&v_empty[(j - 1) % FWD_STAGES]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      pack_a<FWD_BN>(p, s);
    }
    wait_tile(v_full, kv_end - 1);
    wgmma_fence();
    issue_pv(kv_end - 1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    mbar_arrive(&v_empty[(kv_end - 1) % FWD_STAGES]);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float safe_l = (l_i[r] == 0.f) ? 1.f : l_i[r];
      inv[r] = 1.f / safe_l;
      const int rr = row + 8 * r;
      if (t == 0 && rr < S) {
        lse[(long)bh * S + rr] = m_i[r] * LN2 + logf(safe_l);
      }
    }
    const long qstride = (long)H * D;
    store_acc<D>(out + ((long)b * S * H + h) * D, qstride, row, S, o, inv, t);
  }
}

// ---------------------------------------------------------------------------
// dQ: grid (B*H, ceil(S/128)), the longest causal q tiles first; a 128-row
// Q/dO tile resident, 128-row K/V tiles streamed.  Writes dq [B,S,H,D].
// ---------------------------------------------------------------------------

constexpr int DQ_BM = 128;    // q rows per CTA, 64 per consumer warpgroup
constexpr int DQ_BN = 128;    // kv rows per streamed tile
constexpr int DQ_STAGES = 2;  // depth of the K ring and of the V ring
// With K/V tiles as tall as the Q tile, each warpgroup's rows see every
// tile up to the CTA's last, and only the last carries the mask.
static_assert(DQ_BN == DQ_BM, "the dQ tile loop assumes square tiles");

template <int D>
struct DqSmem {
  static constexpr int Q = 0;
  static constexpr int DO = DQ_BM * D * 2;
  static constexpr int TILE = DQ_BN * D * 2;
  static constexpr int K = 2 * DQ_BM * D * 2;     // DQ_STAGES K tiles
  static constexpr int V = K + DQ_STAGES * TILE;  // DQ_STAGES V tiles
  static constexpr int BARS = V + DQ_STAGES * TILE;
  // qdo_full, then full and empty of each K stage and of each V stage
  static constexpr int BYTES = BARS + (1 + 4 * DQ_STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
    fa_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int S, int H, int Hkv, float scale, int causal) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem + DqSmem<D>::Q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + DqSmem<D>::DO);
  bf16* Ks = reinterpret_cast<bf16*>(smem + DqSmem<D>::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + DqSmem<D>::V);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + DqSmem<D>::BARS);
  uint64_t* k_full = qdo_full + 1;
  uint64_t* k_empty = k_full + DQ_STAGES;
  uint64_t* v_full = k_empty + DQ_STAGES;
  uint64_t* v_empty = v_full + DQ_STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BM;
  const int n_kv = (S + DQ_BN - 1) / DQ_BN;
  // causal block skip: kv tile j is needed iff j*BN <= q0 + BM - 1
  const int kv_end = causal ? min(n_kv, (q0 + DQ_BM - 1) / DQ_BN + 1) : n_kv;
  // the last tile carries the mask: the diagonal, or keys past S
  const bool last_masked = causal || kv_end * DQ_BN > S;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 2 * WG);
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 2 * WG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG) {
    // producer warpgroup: one thread starts every copy, Q and dO once,
    // then K_j before V_j
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      auto load = [&](const CUtensorMap* map, bf16* ring, uint64_t* full,
                      uint64_t* empty, int j) {
        const int st = j % DQ_STAGES;
        mbar_wait(&empty[st], ((j / DQ_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], DQ_BN * D * 2);
        tma_load_tile<D, DQ_BN>(ring + st * DQ_BN * D, map, hk, j * DQ_BN, b,
                                &full[st]);
      };
      mbar_arrive_expect_tx(qdo_full, 2 * DQ_BM * D * 2);
      tma_load_tile<D, DQ_BM>(Qs, &tm_q, h, q0, b, qdo_full);
      tma_load_tile<D, DQ_BM>(dOs, &tm_do, h, q0, b, qdo_full);
      for (int j = 0; j < kv_end; ++j) {
        load(&tm_k, Ks, k_full, k_empty, j);
        load(&tm_v, Vs, v_full, v_empty, j);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + wg * 64;               // this warpgroup's first row
    const int row = r0 + (tid / 32) * 16 + g;  // and row + 8
    const float scale_log2 = scale * LOG2E;
    const uint32_t q_base = smem_u32(Qs), do_base = smem_u32(dOs);
    const bool idle = r0 >= S;  // every row of this warpgroup is past S
    float lse2[2], dlt[2];  // lse (log2 units) and delta of the two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row + 8 * r;
      lse2[r] = rr < S ? lse[(long)bh * S + rr] * LOG2E : 0.f;
      dlt[r] = rr < S ? delta[(long)bh * S + rr] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(qdo_full, 0);

    for (int j = 0; j < kv_end; ++j) {
      const int st = j % DQ_STAGES;
      const uint32_t parity = (j / DQ_STAGES) & 1;
      mbar_wait(&k_full[st], parity);
      mbar_wait(&v_full[st], parity);
      if (idle) {
        // release the tile once it has arrived (an early arrival would
        // count toward the stage's previous phase)
        mbar_arrive(&v_empty[st]);
        mbar_arrive(&k_empty[st]);
        continue;
      }
      const uint32_t k_base = smem_u32(Ks + st * DQ_BN * D);
      const uint32_t v_base = smem_u32(Vs + st * DQ_BN * D);

      float s[DQ_BN / 2], dp[DQ_BN / 2];  // S = Q K^T, dP = dO V^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<DQ_BN>::ss(s, desc_k(q_base, DQ_BM, wg * 64, kk),
                         desc_k(k_base, DQ_BN, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<DQ_BN>::ss(dp, desc_k(do_base, DQ_BM, wg * 64, kk),
                         desc_k(v_base, DQ_BN, 0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      mbar_arrive(&v_empty[st]);
      if (j == kv_end - 1 && last_masked) {
        mask_tile<DQ_BN, false>(s, row, j * DQ_BN + 2 * t, S, causal);
      }
#pragma unroll
      for (int i = 0; i < DQ_BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float p = exp2f(fmaf(s[i], scale_log2, -lse2[r]));
        s[i] = p * (dp[i] - dlt[r]) * scale;  // dS
      }
      uint32_t da[DQ_BN / 16][4];  // dS as the A operand of dS K
      pack_a<DQ_BN>(da, s);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BN / 16; ++kk) {
        Wgmma<D>::rs(acc, da[kk], desc_mn(k_base, DQ_BN, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      mbar_arrive(&k_empty[st]);
    }

    const float one[2] = {1.f, 1.f};
    const long qstride = (long)H * D;
    store_acc<D>(dq + ((long)b * S * H + h) * D, qstride, row, S, acc, one,
                 t);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: grid (B*H, ceil(S/128)), the longest causal kv tiles first; a
// 128-row kv tile resident, 64-row q tiles streamed.  Writes dk/dv per q
// head ([B,S,H,D]); the caller sums them over each GQA group.
// ---------------------------------------------------------------------------

constexpr int DKV_BN = 128;  // kv rows per CTA, 64 per consumer warpgroup
constexpr int DKV_BM = 64;   // q rows per streamed tile
constexpr int DKV_STAGES = 2;  // Q/dO ring depth

template <int D>
struct DkvSmem {
  static constexpr int K = 0;
  static constexpr int V = DKV_BN * D * 2;
  static constexpr int QDO = 2 * DKV_BN * D * 2;  // DKV_STAGES x (Q, dO)
  static constexpr int TILE = DKV_BM * D * 2;
  // DKV_STAGES x (lse, delta rows)
  static constexpr int ROWS = QDO + DKV_STAGES * 2 * TILE;
  static constexpr int BARS = ROWS + DKV_STAGES * 2 * DKV_BM * 4;
  static constexpr int BYTES = BARS + (1 + 2 * DKV_STAGES) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
    fa_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int S, int H, int Hkv,
                      float scale, int causal) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem + DkvSmem<D>::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + DkvSmem<D>::V);
  bf16* QdOs = reinterpret_cast<bf16*>(smem + DkvSmem<D>::QDO);
  float* rows_s = reinterpret_cast<float*>(smem + DkvSmem<D>::ROWS);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + DkvSmem<D>::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + DKV_STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int k0 = blockIdx.y * DKV_BN;
  const int n_q = (S + DKV_BM - 1) / DKV_BM;
  // causal block skip: q tile i is needed iff k0 <= i*BM + BM - 1
  const int i_begin = causal ? k0 / DKV_BM : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 2 * WG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG) {
    // producer warp: lane 0 issues the TMA copies, every lane brings two
    // lse and two delta values of the q tile (lse prescaled by log2(e),
    // zero past S)
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 2 * WG + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * DKV_BN * D * 2);
        tma_load_tile<D, DKV_BN>(Ks, &tm_k, hk, k0, b, kv_full);
        tma_load_tile<D, DKV_BN>(Vs, &tm_v, hk, k0, b, kv_full);
      }
      const float* lse_bh = lse + (long)bh * S;
      const float* delta_bh = delta + (long)bh * S;
      for (int i = i_begin; i < n_q; ++i) {
        const int it = i - i_begin, st = it % DKV_STAGES;
        mbar_wait(&empty[st], ((it / DKV_STAGES) & 1) ^ 1);
        if (lane == 0) {
          bf16* Qs = QdOs + st * 2 * DKV_BM * D;
          mbar_expect_tx(&full[st], 2 * DKV_BM * D * 2);
          tma_load_tile<D, DKV_BM>(Qs, &tm_q, h, i * DKV_BM, b, &full[st]);
          tma_load_tile<D, DKV_BM>(Qs + DKV_BM * D, &tm_do, h, i * DKV_BM, b,
                                   &full[st]);
        }
        float* lse_s = rows_s + st * 2 * DKV_BM;
#pragma unroll
        for (int c = lane; c < DKV_BM; c += 32) {
          const int qi = i * DKV_BM + c;
          lse_s[c] = qi < S ? lse_bh[qi] * LOG2E : 0.f;
          lse_s[DKV_BM + c] = qi < S ? delta_bh[qi] : 0.f;
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int kv0 = k0 + wg * 64;              // this warpgroup's kv rows
    const int row = kv0 + (tid / 32) * 16 + g;  // and row + 8
    const float scale_log2 = scale * LOG2E;
    const uint32_t k_base = smem_u32(Ks), v_base = smem_u32(Vs);
    // causal: q tiles before this warpgroup's diagonal see none of its keys
    const int i_first = causal ? kv0 / DKV_BM : 0;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int i = i_begin; i < n_q; ++i) {
      const int it = i - i_begin, st = it % DKV_STAGES;
      mbar_wait(&full[st], (it / DKV_STAGES) & 1);
      if (i < i_first) {
        mbar_arrive(&empty[st]);
        continue;
      }
      const int q0 = i * DKV_BM;
      const uint32_t q_base = smem_u32(QdOs + st * 2 * DKV_BM * D);
      const uint32_t do_base = q_base + DKV_BM * D * 2;
      const float* lse_s = rows_s + st * 2 * DKV_BM;
      const float* delta_s = lse_s + DKV_BM;

      float st_acc[DKV_BM / 2], dpt[DKV_BM / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<DKV_BM>::ss(st_acc, desc_k(k_base, DKV_BN, wg * 64, kk),
                          desc_k(q_base, DKV_BM, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<DKV_BM>::ss(dpt, desc_k(v_base, DKV_BN, wg * 64, kk),
                          desc_k(do_base, DKV_BM, 0, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st_acc);
      fence_regs(dpt);
      if ((causal && i == i_first) || q0 + DKV_BM > S) {
        mask_tile<DKV_BM, true>(st_acc, row, q0 + 2 * t, S, causal);
      }
#pragma unroll
      for (int n = 0; n < DKV_BM / 8; ++n) {
        const int c = 8 * n + 2 * t;  // this thread's q columns c, c + 1
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(st_acc[4 * n + e], scale_log2,
                                     -((e & 1) ? l2.y : l2.x)));
          st_acc[4 * n + e] = p;                                       // P^T
          dpt[4 * n + e] = p * (dpt[4 * n + e] - ((e & 1) ? dl.y : dl.x)) *
                           scale;                                      // dS^T
        }
      }
      uint32_t pa[DKV_BM / 16][4], da[DKV_BM / 16][4];
      pack_a<DKV_BM>(pa, st_acc);
      pack_a<DKV_BM>(da, dpt);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BM / 16; ++kk) {
        Wgmma<D>::rs(dv_acc, pa[kk], desc_mn(do_base, DKV_BM, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < DKV_BM / 16; ++kk) {
        Wgmma<D>::rs(dk_acc, da[kk], desc_mn(q_base, DKV_BM, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive(&empty[st]);
    }

    const float one[2] = {1.f, 1.f};
    const long qstride = (long)H * D;
    const long qoff = ((long)b * S * H + h) * D;
    store_acc<D>(dk + qoff, qstride, row, S, dk_acc, one, t);
    store_acc<D>(dv + qoff, qstride, row, S, dv_acc, one, t);
  }
}

constexpr int MAX_DEVICES = 64;

// Raise a kernel's dynamic shared-memory limit once per device: the
// attribute is set in each device's context, and done[] is a static of the
// calling launch_* instantiation, so later launches skip the call.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int S, int H, int Hkv, float scale,
               int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = hopper::make_bshd_map(&tq, q, B, S, H, D, FWD_BM);
  if (!rc) rc = hopper::make_bshd_map(&tk, k, B, S, Hkv, D, FWD_BN);
  if (!rc) rc = hopper::make_bshd_map(&tv, v, B, S, Hkv, D, FWD_BN);
  if (rc) return rc;
  constexpr int smem = FwdSmem<D>::BYTES;
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = set_smem_once(fa_fwd_kernel<D>, smem, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + FWD_BM - 1) / FWD_BM);
  fa_fwd_kernel<D><<<grid, HOPPER_THREADS, smem, stream>>>(
      tq, tk, tv, (bf16*)out, (float*)lse, S, H, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int H, int Hkv, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = hopper::make_bshd_map(&tq, q, B, S, H, D, DQ_BM);
  if (!rc) rc = hopper::make_bshd_map(&tdo, dout, B, S, H, D, DQ_BM);
  if (!rc) rc = hopper::make_bshd_map(&tk, k, B, S, Hkv, D, DQ_BN);
  if (!rc) rc = hopper::make_bshd_map(&tv, v, B, S, Hkv, D, DQ_BN);
  if (rc) return rc;
  constexpr int smem = DqSmem<D>::BYTES;
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = set_smem_once(fa_bwd_dq_kernel<D>, smem, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + DQ_BM - 1) / DQ_BM);
  fa_bwd_dq_kernel<D><<<grid, HOPPER_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dq, S,
      H, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int S, int H, int Hkv, float scale, int causal,
               cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = hopper::make_bshd_map(&tq, q, B, S, H, D, DKV_BM);
  if (!rc) rc = hopper::make_bshd_map(&tdo, dout, B, S, H, D, DKV_BM);
  if (!rc) rc = hopper::make_bshd_map(&tk, k, B, S, Hkv, D, DKV_BN);
  if (!rc) rc = hopper::make_bshd_map(&tv, v, B, S, Hkv, D, DKV_BN);
  if (rc) return rc;
  constexpr int smem = DkvSmem<D>::BYTES;
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = set_smem_once(fa_bwd_dkv_kernel<D>, smem, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (S + DKV_BN - 1) / DKV_BN);
  fa_bwd_dkv_kernel<D><<<grid, HOPPER_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, S, H, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Each returns the cudaError_t of the
// launch (0 = cudaSuccess); an unsupported head_dim returns
// cudaErrorInvalidValue without launching.
extern "C" {

int dlrover_fa_fwd(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int S, int H, int Hkv, int D,
                   float scale, int causal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128) return launch_fwd<128>(q, k, v, out, lse, B, S, H, Hkv, scale, causal, st);
  if (D == 64) return launch_fwd<64>(q, k, v, out, lse, B, S, H, Hkv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

int dlrover_fa_bwd_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int S, int H, int Hkv, int D,
                      float scale, int causal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128) return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, scale, causal, st);
  if (D == 64) return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

int dlrover_fa_bwd_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int S, int H, int Hkv,
                       int D, float scale, int causal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128) return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv, scale, causal, st);
  if (D == 64) return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
