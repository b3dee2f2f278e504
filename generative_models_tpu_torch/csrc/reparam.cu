// Fused VAE sampling for Hopper (sm_90a): eps drawn in the kernel,
// z = mu + exp(logvar / 2) * eps, and the per-row KL, in one pass.
//
// Replaces: generative_models_tpu/ops/pallas_reparam.py::_reparam_kernel
// with ::_fwd_impl (the TPU kernel; its backward is analytic in array
// ops there and in torch ops here, ops/cuda_reparam.py::ReparamFunction).
//
// What it computes, for mu, logvar [B, L] float32:
//   eps[r, c] ~ N(0, 1), never stored
//   z[r, c]   = mu[r, c] + exp(0.5 * logvar[r, c]) * eps[r, c]
//   kl[r]     = -0.5 * sum_c (1 + logvar - mu^2 - exp(logvar))
//
// The noise. The TPU kernel reads its chip's hardware generator; this
// card has none a kernel can read, so the generator is written out
// here: Philox4x32-10 (Salmon et al. 2011), counter-based, so an
// element's noise depends only on (seed, offset, row, column) and the
// plain version (ops/cuda_reparam.py::philox_normal_plain) reproduces
// it with integer tensor ops. Key = the call's two seed words; counter
// = (row, column pair g, offset low, offset high). One counter gives
// four words w0..w3 and so two normals, for columns 2g (from w0, w1)
// and 2g + 1 (from w2, w3): each word's top 23 bits become the mantissa
// of a float in [1, 2), minus 1 (the TPU kernel's _uniform_from_bits);
// then Box-Muller, sqrt(-2 log1p(-u1)) cos(2 pi u2), where 1 - u1 in
// (0, 1] keeps the log finite. Compiled without --use_fast_math, so
// log1pf, cosf, expf and sqrtf are the accurate ones.
//
// Design. One warp per row: lane j takes the column pairs j, j + 32,
// ... (L = 20 is ten lanes, one pair each), and a shuffle tree sums the
// row's KL terms in a fixed order, so a run is deterministic. The seed
// words are read from device memory, so the wrapper never waits for the
// host to see them.
//
// Bound on the H100: bytes. mu and logvar read once, z and kl written
// once: 4 (3 B L + B) bytes — 24.4 KB at B 100, L 20 (7.3 ns at 3.35
// TB/s), 1.97 MB at B 8192 (0.59 us). The ~150 integer operations and
// four transcendentals an element are far below that; at these sizes
// the launch itself (a few microseconds) is what the kernel costs.

#include <cuda_runtime.h>

#define RP_THREADS 256
#define RP_WARPS (RP_THREADS / 32)

__device__ __forceinline__ void philox4x32_10(unsigned c0, unsigned c1,
                                              unsigned c2, unsigned c3,
                                              unsigned k0, unsigned k1,
                                              unsigned w[4]) {
  const unsigned M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const unsigned W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const unsigned hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const unsigned hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    const unsigned n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  w[0] = c0;
  w[1] = c1;
  w[2] = c2;
  w[3] = c3;
}

__device__ __forceinline__ float uniform01(unsigned bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ float box_muller(unsigned a, unsigned b) {
  const float u1 = uniform01(a), u2 = uniform01(b);
  return sqrtf(-2.0f * log1pf(-u1)) * cosf(6.283185307179586f * u2);
}

__global__ void __launch_bounds__(RP_THREADS)
reparam_kernel(const float* __restrict__ mu, const float* __restrict__ lv,
               const long long* __restrict__ seed, float* __restrict__ z,
               float* __restrict__ kl, int B, int L,
               unsigned long long offset) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * RP_WARPS + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warps leave: the shuffles below are full
  const unsigned k0 = (unsigned)seed[0], k1 = (unsigned)seed[1];
  const unsigned o_lo = (unsigned)offset, o_hi = (unsigned)(offset >> 32);
  const size_t base = (size_t)row * L;
  const int groups = (L + 1) / 2;
  float acc = 0.0f;
  for (int g = lane; g < groups; g += 32) {
    unsigned w[4];
    philox4x32_10((unsigned)row, (unsigned)g, o_lo, o_hi, k0, k1, w);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * g + h;
      if (c < L) {
        const float m = mu[base + c], l = lv[base + c];
        const float eps = box_muller(w[2 * h], w[2 * h + 1]);
        z[base + c] = m + expf(0.5f * l) * eps;
        acc += 1.0f + l - m * m - expf(l);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) kl[row] = -0.5f * acc;
}

// Launches the kernel on `stream`; `seed` points at two 64-bit words in
// device memory whose low 32 bits are the key. Allocates nothing, does
// not synchronise; returns the CUDA error code of the launch (0 = queued).
extern "C" int gm_reparam(const float* mu, const float* lv,
                          const long long* seed, float* z, float* kl, int B,
                          int L, unsigned long long offset, void* stream) {
  if (B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (B + RP_WARPS - 1) / RP_WARPS;
  reparam_kernel<<<blocks, RP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      mu, lv, seed, z, kl, B, L, offset);
  return (int)cudaGetLastError();
}
