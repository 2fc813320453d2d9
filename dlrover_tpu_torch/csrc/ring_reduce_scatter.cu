// The per-hop kernels of the grad-sync rings, for Hopper (sm_90a): the
// fused quantize and fused dequant-accumulate of the ring_pallas_q ring and
// the plain accumulate of the exact ring_pallas ring.
//
// Replaces five Pallas TPU kernels of
// dlrover_tpu/ops/pallas/ring_reduce_scatter.py:
//   add_kernel       <- _add_kernel       (:81, pallas_call :90)
//   q8_encode_kernel <- _q8_encode_kernel (:113, pallas_call :178)
//   q4_encode_kernel <- _q4_encode_kernel (:123, pallas_call :178)
//   q8_accum_kernel  <- _q8_accum_kernel  (:141, pallas_call :206)
//   q4_accum_kernel  <- _q4_accum_kernel  (:145, pallas_call :206)
//
// Encode: x is (rows, block) fp32, one quantization block per row.  Per row
// scale = max|x| * (1/QMAX), safe = scale > 0 ? scale : 1,
// code = clamp(rint(x / safe), -QMAX, QMAX), dequant = code * scale, with
// QMAX 127 (int8 codes) or 7 (int4 codes, two per byte, the even element
// in the low nibble; the dequant is read back through the packed byte with
// arithmetic shifts).  Accumulate: out = acc + code * scale for one
// arriving chunk of (nblk, block), one scale per row; out may alias acc.
//
// Every rounding is pinned, because the error-feedback residual is taken
// from this dequant and must be bit-identical to the reference's, and the
// ring's sum to its accumulate.  The reference as it runs (JAX jit on the
// CPU, Pallas in interpret mode) computes max|x| / 127.0 as a multiply by
// the fp32 constant 1/127 (XLA rewrites division by a constant), divides
// x by safe in IEEE fp32, rounds half to even, and contracts the
// accumulate's multiply-add into one fused multiply-add.  So: scale =
// __fmul_rn(m, 1.0f / QMAX), code = rintf(__fdiv_rn(x, safe)), dequant =
// __fmul_rn(code, scale) and out = __fmaf_rn(code, scale, acc).  The max is
// exact in any order.  Inputs are finite.
//
// Bound on an H100 SXM: bytes.  The encode reads 4 bytes and writes 4 + 1
// (int8) or 4 + 0.5 (int4) bytes per element, the accumulate reads 4 + 1
// (or 0.5) and writes 4; a few flop per element against 3.35 TB/s.  What
// the design does about it: one pass over the data with 16-byte loads and
// stores, each code written once, no intermediate buffer.  Encode: one
// warp per block row; each lane holds 8 consecutive elements of a 256-wide
// part (two float4), takes its max, and a 5-step __shfl_xor_sync finishes
// the row max; a row of 512 or more loops over its parts.  int8 codes go
// out as one 8-byte store per lane, int4 as one 4-byte store.  Accumulate:
// a grid-stride loop over groups of 8 elements (two float4 of acc, 8 or 4
// bytes of codes).  Launch overhead dominates small buckets; a later PR
// could fuse the buckets of a step into one launch.
//
// Add: out = a + b on fp32 vectors of any length n >= 1, one IEEE rounding
// per element (__fadd_rn, the add XLA does); out may alias a, so a ring hop
// accumulates in place.  Precondition, checked by the wrapper: a, b and out
// contiguous fp32, each 16-byte aligned (the float4 loads and stores).  The
// reference's width % 1024 rule is a TPU tiling rule and only picks the
// tier; this kernel takes any n.  Bound: bytes, 12 per element (read two,
// write one) against 3.35 TB/s and one flop per element.  Design: each
// thread loads ADD_UNROLL float4 of a and of b, all before any add, with
// streaming cache hints (every byte is touched once: the 196 MB of a large
// hop pass through the 50 MB L2 without staying), and the grid covers the
// vector once; the first threads of the grid add the n % 4 tail.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PART = 256;  // elements of a row one warp covers per pass
constexpr int THREADS = 256;

__device__ __forceinline__ int quantize(float x, float safe, float qmax) {
  float t = rintf(__fdiv_rn(x, safe));
  return (int)fminf(fmaxf(t, -qmax), qmax);
}

__device__ __forceinline__ int low_nibble(uint32_t byte) {
  return (int)(int8_t)(uint8_t)(byte << 4) >> 4;
}

__device__ __forceinline__ int high_nibble(uint32_t byte) {
  return (int)(int8_t)(uint8_t)byte >> 4;
}

template <int QMAX>
__global__ void __launch_bounds__(THREADS)
encode_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
              float* __restrict__ s, float* __restrict__ d, long long rows,
              int block) {
  const long long row =
      ((long long)blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const float* xr = x + row * block;
  float m = 0.0f;
  for (int base = lane * 8; base < block; base += PART) {
    const float4 a = *reinterpret_cast<const float4*>(xr + base);
    const float4 b = *reinterpret_cast<const float4*>(xr + base + 4);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)),
                       fmaxf(fabsf(a.z), fabsf(a.w))));
    m = fmaxf(m, fmaxf(fmaxf(fabsf(b.x), fabsf(b.y)),
                       fmaxf(fabsf(b.z), fabsf(b.w))));
  }
  for (int offset = 16; offset; offset >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, offset));
  const float scale = __fmul_rn(m, 1.0f / (float)QMAX);
  const float safe = scale > 0.0f ? scale : 1.0f;
  const float qmax = (float)QMAX;
  float* dr = d + row * block;
  for (int base = lane * 8; base < block; base += PART) {
    const float4 a = *reinterpret_cast<const float4*>(xr + base);
    const float4 b = *reinterpret_cast<const float4*>(xr + base + 4);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    int c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = quantize(v[j], safe, qmax);
    float out[8];
    if (QMAX == 127) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo |= (uint32_t)(uint8_t)(int8_t)c[j] << (8 * j);
        hi |= (uint32_t)(uint8_t)(int8_t)c[j + 4] << (8 * j);
      }
      *reinterpret_cast<uint2*>(q + row * block + base) = make_uint2(lo, hi);
#pragma unroll
      for (int j = 0; j < 8; ++j) out[j] = __fmul_rn((float)c[j], scale);
    } else {
      uint32_t packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t byte =
            ((uint32_t)c[2 * j] & 0xFu) | (((uint32_t)c[2 * j + 1] << 4) & 0xF0u);
        packed |= byte << (8 * j);
        out[2 * j] = __fmul_rn((float)low_nibble(byte), scale);
        out[2 * j + 1] = __fmul_rn((float)high_nibble(byte), scale);
      }
      *reinterpret_cast<uint32_t*>(q + row * (block / 2) + base / 2) = packed;
    }
    *reinterpret_cast<float4*>(dr + base) =
        make_float4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<float4*>(dr + base + 4) =
        make_float4(out[4], out[5], out[6], out[7]);
  }
  if (lane == 0) s[row] = scale;
}

// acc and out are not __restrict__: out may be acc (in-place accumulate);
// each thread reads its 8 elements of acc before it writes them.
template <bool INT4>
__global__ void __launch_bounds__(THREADS)
accum_kernel(const float* acc, const int8_t* __restrict__ q,
             const float* __restrict__ s, float* out, long long groups,
             int block) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
       g < groups; g += stride) {
    const long long e = g * 8;
    const float sc = s[e / block];
    int c[8];
    if (INT4) {
      const uint32_t packed = *reinterpret_cast<const uint32_t*>(q + e / 2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t byte = (packed >> (8 * j)) & 0xFFu;
        c[2 * j] = low_nibble(byte);
        c[2 * j + 1] = high_nibble(byte);
      }
    } else {
      const uint2 packed = *reinterpret_cast<const uint2*>(q + e);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = (int)(int8_t)(uint8_t)(packed.x >> (8 * j));
        c[j + 4] = (int)(int8_t)(uint8_t)(packed.y >> (8 * j));
      }
    }
    const float4 a = *reinterpret_cast<const float4*>(acc + e);
    const float4 b = *reinterpret_cast<const float4*>(acc + e + 4);
    *reinterpret_cast<float4*>(out + e) = make_float4(
        __fmaf_rn((float)c[0], sc, a.x), __fmaf_rn((float)c[1], sc, a.y),
        __fmaf_rn((float)c[2], sc, a.z), __fmaf_rn((float)c[3], sc, a.w));
    *reinterpret_cast<float4*>(out + e + 4) = make_float4(
        __fmaf_rn((float)c[4], sc, b.x), __fmaf_rn((float)c[5], sc, b.y),
        __fmaf_rn((float)c[6], sc, b.z), __fmaf_rn((float)c[7], sc, b.w));
  }
}

// a and out are not __restrict__: out may be a (in-place accumulate)
constexpr int ADD_UNROLL = 4;  // independent float4 loads of each input
__global__ void __launch_bounds__(THREADS)
add_kernel(const float* a, const float* __restrict__ b, float* out,
           long long n) {
  const long long groups = n / 4;
  const long long first =
      (long long)blockIdx.x * THREADS * ADD_UNROLL + threadIdx.x;
  float4 x[ADD_UNROLL], y[ADD_UNROLL];
#pragma unroll
  for (int u = 0; u < ADD_UNROLL; ++u) {
    const long long g = first + u * THREADS;
    if (g < groups) {
      x[u] = __ldcs(reinterpret_cast<const float4*>(a) + g);
      y[u] = __ldcs(reinterpret_cast<const float4*>(b) + g);
    }
  }
#pragma unroll
  for (int u = 0; u < ADD_UNROLL; ++u) {
    const long long g = first + u * THREADS;
    if (g < groups) {
      __stcs(reinterpret_cast<float4*>(out) + g,
             make_float4(__fadd_rn(x[u].x, y[u].x), __fadd_rn(x[u].y, y[u].y),
                         __fadd_rn(x[u].z, y[u].z), __fadd_rn(x[u].w, y[u].w)));
    }
  }
  // the n % 4 tail, by the first threads of the grid
  const long long i =
      groups * 4 + (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = __fadd_rn(a[i], b[i]);
}

template <int QMAX>
int launch_encode(const void* x, void* q, void* s, void* d, long long rows,
                  int block, cudaStream_t stream) {
  if (rows <= 0 || block <= 0 || block % PART) return (int)cudaErrorInvalidValue;
  const long long warps_per_cta = THREADS / 32;
  const long long grid = (rows + warps_per_cta - 1) / warps_per_cta;
  encode_kernel<QMAX><<<(unsigned)grid, THREADS, 0, stream>>>(
      (const float*)x, (int8_t*)q, (float*)s, (float*)d, rows, block);
  return (int)cudaGetLastError();
}

template <bool INT4>
int launch_accum(const void* acc, const void* q, const void* s, void* out,
                 long long nblk, int block, cudaStream_t stream) {
  if (nblk <= 0 || block <= 0 || block % PART) return (int)cudaErrorInvalidValue;
  const long long groups = nblk * block / 8;
  long long grid = (groups + THREADS - 1) / THREADS;
  if (grid > 132 * 16) grid = 132 * 16;  // 16 CTAs per SM, grid-stride
  accum_kernel<INT4><<<(unsigned)grid, THREADS, 0, stream>>>(
      (const float*)acc, (const int8_t*)q, (const float*)s, (float*)out,
      groups, block);
  return (int)cudaGetLastError();
}

int launch_add(const void* a, const void* b, void* out, long long n,
               cudaStream_t stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long per_cta = THREADS * ADD_UNROLL;  // float4 groups
  long long grid = (n / 4 + per_cta - 1) / per_cta;
  if (grid < 1) grid = 1;
  add_kernel<<<(unsigned)grid, THREADS, 0, stream>>>(
      (const float*)a, (const float*)b, (float*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dlrover_rrs_add(const void* a, const void* b, void* out, long long n,
                    void* stream) {
  return launch_add(a, b, out, n, (cudaStream_t)stream);
}

int dlrover_rrs_q8_encode(const void* x, void* q, void* s, void* d,
                          long long rows, int block, void* stream) {
  return launch_encode<127>(x, q, s, d, rows, block, (cudaStream_t)stream);
}

int dlrover_rrs_q4_encode(const void* x, void* q, void* s, void* d,
                          long long rows, int block, void* stream) {
  return launch_encode<7>(x, q, s, d, rows, block, (cudaStream_t)stream);
}

int dlrover_rrs_q8_accum(const void* acc, const void* q, const void* s,
                         void* out, long long nblk, int block, void* stream) {
  return launch_accum<false>(acc, q, s, out, nblk, block, (cudaStream_t)stream);
}

int dlrover_rrs_q4_accum(const void* acc, const void* q, const void* s,
                         void* out, long long nblk, int block, void* stream) {
  return launch_accum<true>(acc, q, s, out, nblk, block, (cudaStream_t)stream);
}

}  // extern "C"
