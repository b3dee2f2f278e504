// Fused VAE sampling for Hopper (sm_90a): eps drawn in the kernel,
// z = mu + exp(logvar / 2) * eps, and the per-row KL, in one pass; and
// its backward in one pass.
//
// Replaces: generative_models_tpu/ops/pallas_reparam.py::_reparam_kernel
// with ::_fwd_impl (the TPU kernel), and ::_vjp_bwd (its backward, array
// ops there; a kernel here, so that a VAE step's backward is one launch).
//
// What it computes, for mu, logvar [B, L] float32:
//   eps[r, c] ~ N(0, 1), never stored
//   z[r, c]   = mu[r, c] + exp(0.5 * logvar[r, c]) * eps[r, c]
//   kl[r]     = -0.5 * sum_c (1 + logvar - mu^2 - exp(logvar))
// and, given the cotangents dz [B, L] and dkl [B] (any row stride):
//   dmu     = dz + dkl * mu
//   dlogvar = dz * 0.5 * (z - mu) - dkl * 0.5 * (1 - exp(logvar))
//
// The noise. The TPU kernel reads its chip's hardware generator; this
// card has none a kernel can read, so the generator is written out
// here: Philox4x32-10 (Salmon et al. 2011), counter-based, so an
// element's noise depends only on (seed, offset, row, column) and the
// plain version (ops/cuda_reparam.py::philox_normal_plain) reproduces
// it with integer tensor ops. Key = the call's two seed words (the low
// 32 bits of each int64); counter = (row, column pair g, offset low,
// offset high). One counter gives four words w0..w3 and so two normals,
// for columns 2g (from w0, w1) and 2g + 1 (from w2, w3): each word's top
// 23 bits become the mantissa of a float in [1, 2), minus 1 (the TPU
// kernel's _uniform_from_bits); then Box-Muller, sqrt(-2 log1p(-u1))
// cos(2 pi u2), where 1 - u1 in (0, 1] keeps the log finite. Compiled
// without --use_fast_math, so log1pf, cosf, expf and sqrtf are the
// accurate ones.
//
// Design. A thread a column pair, flat: a block covers `rows` whole
// rows, and its threads take the block's pairs in order across row
// boundaries, so neighbouring threads touch neighbouring 8-byte pairs
// (float2 loads and stores when L is even and the pointers 8-byte
// aligned, 4-byte ones otherwise). The launch plan
// (ops/cuda_reparam.py::launch_plan) takes at most B / SMs rows a block,
// so the grid covers every SM (B 100: 100 blocks of one row; B 8192, L 20:
// 25 rows, 250 of 256 threads busy, 328 blocks), and one row a block of
// 256 threads looping over its pairs where a row holds more than 256.
// Each thread's KL terms go to a shared slot, and a warp a row sums the
// row's slots in a fixed order (lane j: slots j, j + 32, ...; then a
// shuffle tree), so a run's z and kl repeat bit for bit. No atomics.
//
// Bound on the H100: bytes. Forward: mu and logvar read once, z and kl
// written once, 4 (3 B L + B) bytes: 24.4 KB at [100, 20] (7.3 ns at
// 3.35 TB/s), 1.97 MB at [8192, 20] (0.59 us). The ~150 integer
// operations and four transcendentals an element are below that only
// per byte; at these sizes a launch (a few microseconds) and one
// thread's chain of Philox and Box-Muller are what the kernel costs.
// Backward: dz, mu, logvar, z read, dmu and dlogvar written, dkl read:
// 4 (6 B L + B) bytes.

#include <cuda_runtime.h>

#define RP_MAX_THREADS 256

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

__device__ __forceinline__ float kl_term(float m, float l) {
  return 1.0f + l - m * m - expf(l);
}

// The block's rows: row0 = blockIdx.x * rows, the last block fewer.
__global__ void __launch_bounds__(RP_MAX_THREADS)
reparam_kernel(const float* __restrict__ mu, const float* __restrict__ lv,
               const long long* __restrict__ seed, float* __restrict__ z,
               float* __restrict__ kl, int B, int L, int rows, int vec,
               unsigned long long offset) {
  __shared__ float part[RP_MAX_THREADS];
  const int G = (L + 1) >> 1, T = blockDim.x, tid = threadIdx.x;
  const int row0 = blockIdx.x * rows;
  const int here = min(rows, B - row0);
  const int S = min(G, T);  // a row's slots: rows > 1 means rows * G <= T
  const unsigned k0 = (unsigned)seed[0], k1 = (unsigned)seed[1];
  const unsigned o_lo = (unsigned)offset, o_hi = (unsigned)(offset >> 32);
  float acc = 0.0f;
  for (int p = tid; p < here * G; p += T) {
    const int r = p / G, g = p - r * G, row = row0 + r;
    unsigned w[4];
    philox4x32_10((unsigned)row, (unsigned)g, o_lo, o_hi, k0, k1, w);
    const float e0 = box_muller(w[0], w[1]), e1 = box_muller(w[2], w[3]);
    if (vec) {  // L = 2G: the block's pairs are one run of float2
      const size_t q = (size_t)row0 * G + p;
      const float2 m = reinterpret_cast<const float2*>(mu)[q];
      const float2 l = reinterpret_cast<const float2*>(lv)[q];
      reinterpret_cast<float2*>(z)[q] =
          make_float2(m.x + expf(0.5f * l.x) * e0, m.y + expf(0.5f * l.y) * e1);
      acc += kl_term(m.x, l.x) + kl_term(m.y, l.y);
    } else {
      const size_t i = (size_t)row * L + 2 * g;
      const float m0 = mu[i], l0 = lv[i];
      z[i] = m0 + expf(0.5f * l0) * e0;
      float t = kl_term(m0, l0);
      if (2 * g + 1 < L) {
        const float m1 = mu[i + 1], l1 = lv[i + 1];
        z[i + 1] = m1 + expf(0.5f * l1) * e1;
        t += kl_term(m1, l1);
      }
      acc += t;
    }
  }
  part[tid] = acc;  // thread r * S + j holds slot j of row r
  __syncthreads();
  const int lane = tid & 31, nw = T >> 5;
  for (int r = tid >> 5; r < here; r += nw) {  // whole warps: T % 32 == 0
    float s = 0.0f;
    for (int j = lane; j < S; j += 32) s += part[r * S + j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) kl[row0 + r] = -0.5f * s;
  }
}

__global__ void __launch_bounds__(RP_MAX_THREADS)
reparam_bwd_kernel(const float* __restrict__ dz, const float* __restrict__ dkl,
                   long long dkl_stride, const float* __restrict__ mu,
                   const float* __restrict__ lv, const float* __restrict__ z,
                   float* __restrict__ dmu, float* __restrict__ dlv, int B,
                   int L, int rows, int vec) {
  const int G = (L + 1) >> 1, T = blockDim.x;
  const int row0 = blockIdx.x * rows;
  const int here = min(rows, B - row0);
  for (int p = threadIdx.x; p < here * G; p += T) {
    const int r = p / G, g = p - r * G, row = row0 + r;
    const float k = dkl[(long long)row * dkl_stride], hk = k * 0.5f;
    if (vec) {
      const size_t q = (size_t)row0 * G + p;
      const float2 d = reinterpret_cast<const float2*>(dz)[q];
      const float2 m = reinterpret_cast<const float2*>(mu)[q];
      const float2 l = reinterpret_cast<const float2*>(lv)[q];
      const float2 y = reinterpret_cast<const float2*>(z)[q];
      reinterpret_cast<float2*>(dmu)[q] = make_float2(d.x + k * m.x,
                                                      d.y + k * m.y);
      reinterpret_cast<float2*>(dlv)[q] = make_float2(
          d.x * 0.5f * (y.x - m.x) - hk * (1.0f - expf(l.x)),
          d.y * 0.5f * (y.y - m.y) - hk * (1.0f - expf(l.y)));
    } else {
      const size_t i = (size_t)row * L + 2 * g;
      const int n = (2 * g + 1 < L) ? 2 : 1;
      for (int h = 0; h < n; ++h) {
        const float d = dz[i + h], m = mu[i + h];
        dmu[i + h] = d + k * m;
        dlv[i + h] = d * 0.5f * (z[i + h] - m) - hk * (1.0f - expf(lv[i + h]));
      }
    }
  }
}

// A plan the kernels can run: `threads` a multiple of 32 up to
// RP_MAX_THREADS, and a block of several rows holding all their pairs.
static bool plan_ok(int B, int L, int rows, int threads) {
  const long long G = (L + 1) / 2;
  return B >= 1 && L >= 1 && rows >= 1 && threads >= 32 &&
         threads <= RP_MAX_THREADS && threads % 32 == 0 &&
         (rows == 1 || rows * G <= threads);
}

// Launch on `stream`; `seed` points at two 64-bit words in device memory
// whose low 32 bits are the key; `vec` = L even and every pointer 8-byte
// aligned. Allocates nothing, does not synchronise; returns the CUDA
// error code of the launch (0 = queued).
extern "C" int gm_reparam(const float* mu, const float* lv,
                          const long long* seed, float* z, float* kl, int B,
                          int L, int rows, int threads, int vec,
                          unsigned long long offset, void* stream) {
  if (!plan_ok(B, L, rows, threads) || (vec && L % 2))
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + rows - 1) / rows;
  reparam_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      mu, lv, seed, z, kl, B, L, rows, vec, offset);
  return (int)cudaGetLastError();
}

extern "C" int gm_reparam_bwd(const float* dz, const float* dkl,
                              long long dkl_stride, const float* mu,
                              const float* lv, const float* z, float* dmu,
                              float* dlv, int B, int L, int rows, int threads,
                              int vec, void* stream) {
  if (!plan_ok(B, L, rows, threads) || (vec && L % 2))
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + rows - 1) / rows;
  reparam_bwd_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      dz, dkl, dkl_stride, mu, lv, z, dmu, dlv, B, L, rows, vec);
  return (int)cudaGetLastError();
}
