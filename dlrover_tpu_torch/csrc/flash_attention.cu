// FA2 flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
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
// similar traffic.  All three kernels are bound by tensor-core operations,
// not bytes.  What the design does about it: every product runs on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate) with operands
// fed by ldmatrix from padded (conflict-free) shared memory; scores,
// probabilities and accumulators stay in registers (the C fragment of S is
// re-packed as the A fragment of P V, so P never touches memory); the
// S x S matrix never leaves the SM; causal tiles above the diagonal are
// skipped, so the work done is what the data needs; the streamed tiles are
// double-buffered, cp.async bringing tile j+1 while the warps compute on
// tile j; exponentials use the __expf intrinsic (a few ulp of fp32, far
// below the bf16 rounding of P).  One CTA of 4 warps per (64-row tile,
// b*h), each warp owning 16 rows.  Not done yet, and next toward the bound:
// wider warp tiles (each ldmatrix'd K/V fragment now feeds 16 rows, so
// shared-memory traffic rivals the tensor-core time), TMA and wgmma.
//
// Fragment layouts (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4):
// A (16x16): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
// a3 = (g+8, 2t+8..); B (16x8): b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., g);
// C (16x8 fp32): c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;           // query rows per tile
constexpr int BN = 64;           // key rows per tile
constexpr int WR = 16;           // rows per warp
constexpr int NWARPS = BM / WR;  // 4
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// This lane's ldmatrix.x4 row address for the 16x16 block at (row0, col0)
// of a row-major tile with stride ld, in A order: matrices (rows 0-7,
// cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).  Loaded plainly it is
// an A fragment; loaded with .trans from a [k][n] tile it is the B
// fragments of n-tiles col0 (r0, r1) and col0 + 8 (r2, r3).
__device__ __forceinline__ int a_off(int row0, int col0, int ld, int lane) {
  return (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + col0 +
         (lane >> 4) * 8;
}

// This lane's ldmatrix.x4 row address for B fragments read from an [n][k]
// tile (rows = n): r0, r1 = n-tile n0 and r2, r3 = n-tile n0 + 8, over
// k0..k0+15.
__device__ __forceinline__ int b_off(int n0, int k0, int ld, int lane) {
  return (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}

// cp.async copies, global -> shared, bypassing registers.  With valid
// false the source is not read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying ROWS rows of D bf16 from global row r0 (row stride gstride
// elements) into shared memory with row stride D + 8; rows >= S become
// zero.  The caller commits the group and waits for it.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long gstride, int r0, int S) {
  constexpr int LDH = D + 8;
  constexpr int VEC = 8;  // bf16 per 16-byte copy
  constexpr int PER_ROW = D / VEC;
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += NTHREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VEC;
    const bool in = r0 + r < S;
    cp_async16(dst + r * LDH + c, src + (long)(in ? r0 + r : 0) * gstride + c,
               in);
  }
}

// Start copying rows r0.. r0+ROWS-1 of a [B*H, S] fp32 residual row (zero
// past S).
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0,
                                          int S) {
  for (int c = threadIdx.x; c < ROWS; c += NTHREADS) {
    const bool in = r0 + c < S;
    cp_async4(dst + c, src + (in ? r0 + c : 0), in);
  }
}

// acc (16 x N fp32, N/8 C fragments) = A (16 rows of `a`, row-major,
// stride LDH) times the transpose of N rows of `b` (row-major, stride
// LDH), over D columns.
template <int D, int N>
__device__ __forceinline__ void warp_abt(float (&acc)[N / 8][4],
                                         const bf16* a, const bf16* b,
                                         int lane) {
  constexpr int LDH = D + 8;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4];
    ldmatrix_x4(fa, a + a_off(0, kk * 16, LDH, lane));
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t fb[4];
      ldmatrix_x4(fb, b + b_off(np * 16, kk * 16, LDH, lane));
      mma_bf16(acc[2 * np], fa, fb[0], fb[1]);
      mma_bf16(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// acc (16 x D fp32) += P (16 x K, given as its fp32 C fragments, rounded
// to bf16 here) times K rows of `b` (row-major [K][D], stride LDH).
template <int D, int K>
__device__ __forceinline__ void warp_pb(float (&acc)[D / 8][4],
                                        const float (&p)[K / 8][4],
                                        const bf16* b, int lane) {
  constexpr int LDH = D + 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t fa[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]),
        pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]),
    };
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t fb[4];
      ldmatrix_x4_trans(fb, b + a_off(kk * 16, dn * 16, LDH, lane));
      mma_bf16(acc[2 * dn], fa, fb[0], fb[1]);
      mma_bf16(acc[2 * dn + 1], fa, fb[2], fb[3]);
    }
  }
}

// Store a warp's 16 x D fp32 accumulator (times mul[row half]) as bf16
// rows row0 and row0 + 8 (this lane's g rows) of a [.., D] global tensor
// with row stride gstride; rows >= S are skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long gstride, int row0,
                                           int S, const float (&acc)[D / 8][4],
                                           const float (&mul)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + h * 8;
    if (row >= S) continue;
    bf16* dst = base + (long)row * gstride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(acc[n][2 * h] * mul[h], acc[n][2 * h + 1] * mul[h]);
    }
  }
}

template <int D>
constexpr int tile_bytes() {
  return BM * (D + 8) * 2;
}

// ---------------------------------------------------------------------------
// forward: grid (ceil(S/BM), B*H); writes out [B,S,H,D] and lse [B*H, S]
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    fa_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out,
                  float* __restrict__ lse, int S, int H, int Hkv, float scale,
                  int causal) {
  constexpr int LDH = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KVs = Qs + BM * LDH;  // two buffers of (K tile, V tile)

  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const long qstride = (long)H * D, kvstride = (long)Hkv * D;
  const long qoff = ((long)b * S * H + h) * D;
  const bf16* kb = k + ((long)b * S * Hkv + hk) * D;
  const bf16* vb = v + ((long)b * S * Hkv + hk) * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * WR;  // this lane's rows: row0 + g (+ 8)

  const int n_kv = (S + BN - 1) / BN;
  // causal block skip: kv tile j is needed iff j*BN <= q0 + BM - 1
  const int kv_end = causal ? min(n_kv, (q0 + BM - 1) / BN + 1) : n_kv;

  load_tile<D, BM>(Qs, q + qoff, qstride, q0, S);
  cp_async_commit();
  load_tile<D, BN>(KVs, kb, kvstride, 0, S);
  load_tile<D, BN>(KVs + BN * LDH, vb, kvstride, 0, S);
  cp_async_commit();
  cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();
  uint32_t qf[D / 16][4];  // the warp's Q rows as A fragments, kept
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(qf[kk], Qs + a_off(warp * WR, kk * 16, LDH, lane));
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};

  for (int j = 0; j < kv_end; ++j) {
    const int k0 = j * BN;
    const bf16* Ks = KVs + (j & 1) * 2 * BN * LDH;
    const bf16* Vs = Ks + BN * LDH;
    if (j + 1 < kv_end) {  // prefetch the next K/V tile into the other buffer
      bf16* next = KVs + ((j + 1) & 1) * 2 * BN * LDH;
      load_tile<D, BN>(next, kb, kvstride, k0 + BN, S);
      load_tile<D, BN>(next + BN * LDH, vb, kvstride, k0 + BN, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j has landed for every thread

    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t fb[4];
        ldmatrix_x4(fb, Ks + b_off(np * 16, kk * 16, LDH, lane));
        mma_bf16(s[2 * np], qf[kk], fb[0], fb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], fb[2], fb[3]);
      }
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = row0 + g + (e >> 1) * 8;
        float x = s[n][e] * scale;
        if (col >= S || (causal && col > row)) x = NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      corr[r] = __expf(m_i[r] - m_new);
      m_i[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - m_i[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_i[r] = l_i[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
    }
    warp_pb<D, BN>(o, s, Vs, lane);  // O += P V
    __syncthreads();  // every warp is done with this buffer
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float safe_l = (l_i[r] == 0.f) ? 1.f : l_i[r];
    inv[r] = 1.f / safe_l;
    const int row = row0 + g + r * 8;
    if (t == 0 && row < S) lse[(long)bh * S + row] = m_i[r] + logf(safe_l);
  }
  store_rows<D>(out + qoff, qstride, row0, S, o, inv, lane);
}

// ---------------------------------------------------------------------------
// dQ: grid (ceil(S/BM), B*H); q tile resident, kv tiles streamed
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    fa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     int S, int H, int Hkv, float scale, int causal) {
  constexpr int LDH = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BM * LDH;
  bf16* KVs = dOs + BM * LDH;  // two buffers of (K tile, V tile)

  const int q0 = blockIdx.x * BM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const long qstride = (long)H * D, kvstride = (long)Hkv * D;
  const long qoff = ((long)b * S * H + h) * D;
  const bf16* kb = k + ((long)b * S * Hkv + hk) * D;
  const bf16* vb = v + ((long)b * S * Hkv + hk) * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * WR;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + r * 8;
    lse_r[r] = row < S ? lse[(long)bh * S + row] : 0.f;
    delta_r[r] = row < S ? delta[(long)bh * S + row] : 0.f;
  }

  load_tile<D, BM>(Qs, q + qoff, qstride, q0, S);
  load_tile<D, BM>(dOs, dout + qoff, qstride, q0, S);
  load_tile<D, BN>(KVs, kb, kvstride, 0, S);
  load_tile<D, BN>(KVs + BN * LDH, vb, kvstride, 0, S);
  cp_async_commit();
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  const int n_kv = (S + BN - 1) / BN;
  const int kv_end = causal ? min(n_kv, (q0 + BM - 1) / BN + 1) : n_kv;
  for (int j = 0; j < kv_end; ++j) {
    const int k0 = j * BN;
    const bf16* Ks = KVs + (j & 1) * 2 * BN * LDH;
    const bf16* Vs = Ks + BN * LDH;
    if (j + 1 < kv_end) {  // prefetch the next K/V tile into the other buffer
      bf16* next = KVs + ((j + 1) & 1) * 2 * BN * LDH;
      load_tile<D, BN>(next, kb, kvstride, k0 + BN, S);
      load_tile<D, BN>(next + BN * LDH, vb, kvstride, k0 + BN, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and, first time, Q/dO) has landed
    float s[BN / 8][4], dp[BN / 8][4];
    warp_abt<D, BN>(s, Qs + warp * WR * LDH, Ks, lane);    // Q K^T
    warp_abt<D, BN>(dp, dOs + warp * WR * LDH, Vs, lane);  // dO V^T
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = row0 + g + (e >> 1) * 8;
        float x = s[n][e] * scale;
        if (col >= S || (causal && col > row)) x = NEG_INF;
        const float p = __expf(x - lse_r[e >> 1]);
        s[n][e] = p * (dp[n][e] - delta_r[e >> 1]) * scale;  // dS
      }
    }
    warp_pb<D, BN>(acc, s, Ks, lane);  // dQ_w += dS_w K
    __syncthreads();  // every warp is done with this buffer
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq + qoff, qstride, row0, S, acc, one, lane);
}

// ---------------------------------------------------------------------------
// dK/dV: grid (ceil(S/BN), B*H); kv tile resident, q tiles streamed.  Each
// warp owns 16 kv rows and works in the transposed orientation (S^T = K Q^T,
// dP^T = V dO^T), so dV = P^T dO and dK = dS^T Q need no transpose; a q
// tile is taken in two halves of 32 columns to keep the register count
// down.  Writes dk/dv per q head ([B,S,H,D]); the caller sums them over
// each GQA group.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    fa_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int S, int H, int Hkv,
                      float scale, int causal) {
  constexpr int LDH = D + 8;
  constexpr int QH = BM / 2;  // q columns per half tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BN * LDH;
  bf16* QdOs = Vs + BN * LDH;  // two buffers of (Q tile, dO tile)
  float* rows_s = reinterpret_cast<float*>(QdOs + 4 * BM * LDH);
  // ... and two buffers of (lse rows, delta rows)

  const int k0 = blockIdx.x * BN;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const long qstride = (long)H * D, kvstride = (long)Hkv * D;
  const long qoff = ((long)b * S * H + h) * D;
  const long kvoff = ((long)b * S * Hkv + hk) * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = k0 + warp * WR;  // this lane's kv rows: row0 + g (+ 8)

  const int n_q = (S + BM - 1) / BM;
  // causal block skip: q tile i is needed iff k0 <= i*BM + BM - 1
  const int i_begin = causal ? k0 / BM : 0;
  // stage q tile i into buffer i & 1: Q, dO, lse rows, delta rows
  auto stage = [&](int i) {
    bf16* qbuf = QdOs + (i & 1) * 2 * BM * LDH;
    float* rbuf = rows_s + (i & 1) * 2 * BM;
    load_tile<D, BM>(qbuf, q + qoff, qstride, i * BM, S);
    load_tile<D, BM>(qbuf + BM * LDH, dout + qoff, qstride, i * BM, S);
    load_rows<BM>(rbuf, lse + (long)bh * S, i * BM, S);
    load_rows<BM>(rbuf + BM, delta + (long)bh * S, i * BM, S);
  };
  load_tile<D, BN>(Ks, k + kvoff, kvstride, k0, S);
  load_tile<D, BN>(Vs, v + kvoff, kvstride, k0, S);
  stage(i_begin);
  cp_async_commit();
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  for (int i = i_begin; i < n_q; ++i) {
    const int q0 = i * BM;
    const bf16* Qs = QdOs + (i & 1) * 2 * BM * LDH;
    const bf16* dOs = Qs + BM * LDH;
    const float* lse_s = rows_s + (i & 1) * 2 * BM;
    const float* delta_s = lse_s + BM;
    if (i + 1 < n_q) {  // prefetch the next q tile into the other buffer
      stage(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // q tile i (and, first time, K/V) has landed
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qc0 = half * QH;
      float st[QH / 8][4], dpt[QH / 8][4];
      warp_abt<D, QH>(st, Ks + warp * WR * LDH, Qs + qc0 * LDH, lane);
      warp_abt<D, QH>(dpt, Vs + warp * WR * LDH, dOs + qc0 * LDH, lane);
#pragma unroll
      for (int n = 0; n < QH / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = qc0 + n * 8 + 2 * t + (e & 1);  // q column in tile
          const int qi = q0 + c;
          const int kj = row0 + g + (e >> 1) * 8;
          float x = st[n][e] * scale;
          if (qi >= S || (causal && kj > qi)) x = NEG_INF;
          const float p = __expf(x - lse_s[c]);
          st[n][e] = p;                                        // P^T
          dpt[n][e] = p * (dpt[n][e] - delta_s[c]) * scale;    // dS^T
        }
      }
      warp_pb<D, QH>(dv_acc, st, dOs + qc0 * LDH, lane);  // dV_w += P^T dO
      warp_pb<D, QH>(dk_acc, dpt, Qs + qc0 * LDH, lane);  // dK_w += dS^T Q
    }
    __syncthreads();  // every warp is done with this buffer
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk + qoff, qstride, row0, S, dk_acc, one, lane);
  store_rows<D>(dv + qoff, qstride, row0, S, dv_acc, one, lane);
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
  constexpr int smem = 5 * tile_bytes<D>();  // Q, 2 x (K, V)
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = set_smem_once(fa_fwd_kernel<D>, smem, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BM - 1) / BM, B * H);
  fa_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
      (float*)lse, S, H, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int H, int Hkv, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = 6 * tile_bytes<D>();  // Q, dO, 2 x (K, V)
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = set_smem_once(fa_bwd_dq_kernel<D>, smem, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BM - 1) / BM, B * H);
  fa_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, S, H, Hkv, scale,
      causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int S, int H, int Hkv, float scale, int causal,
               cudaStream_t stream) {
  // K, V, 2 x (Q, dO), 2 x (lse, delta rows)
  constexpr int smem = 6 * tile_bytes<D>() + 4 * BM * 4;
  static bool done[MAX_DEVICES] = {};
  cudaError_t err = set_smem_once(fa_bwd_dkv_kernel<D>, smem, done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BN - 1) / BN, B * H);
  fa_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, S, H,
      Hkv, scale, causal);
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
