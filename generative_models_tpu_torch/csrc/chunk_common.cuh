// What the whole-chunk training kernels share (gan_chunk.cu, vae_chunk.cu):
// the product job and its tile loop, Adam, the EMA step, the bf16 operand
// rounding, and the warp sum.
//
// A kernel's argument struct `A` carries its state planes and Adam's
// constants: float* p[], mu[], nu[]; float b1, b2, omb1, omb2, eps,
// log_b1, log_b2. Each source defines epilogue<A> for its argument types
// before its kernel.
//
// Products: 16x32 output tiles, 256 threads. The depth is split over the
// block's 8 warps (16-deep slices, each warp's staged in its own shared
// memory with the next slice's loads in flight), a lane keeps one column
// of 16 rows, and the 8 partial tiles are summed in a fixed order: at
// B = 100 the products are short and deep (K up to 784 for 100 rows),
// so the depth, not the tile count, is what must run in parallel.
//
// Built with -DGM_BF16=1 (a library of its own), every product takes its
// two operands rounded to bfloat16 (round to nearest even) and sums them
// in float32, as the TPU kernels' Config.dtype="bfloat16" path
// (pallas_train.py::_make_dots, pallas_dp.py:128,214): the tiles round
// where they stage an operand into shared memory, and a source's own
// row-warp products round through opnd(). A product of two bf16 values is
// exact in float32, so only the order of the float32 sums differs from
// the reference. Elementwise work stays float32.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef GM_BF16
#define GM_BF16 0
#endif
constexpr bool BF16 = GM_BF16 != 0;

#define CT 256               // threads a block
#define WARPS (CT / 32)
#define TM 16                // output tile rows
#define TN 32                // output tile columns, one a lane
#define SK 16                // depth of a warp's staged slice
#define A_PER_LANE (TM * SK / 32)
#define B_PER_LANE (SK * TN / 32)
#define WARP_SMEM (SK * TM + SK * (TN + 1))

struct Mat {  // element (i, j) at p[i * rs + j * cs]
  const float* p;
  int rs, cs;
};

// The kernels that run these jobs sit at 254-255 registers, and a tile
// keeps its job in registers: one more pointer here slowed all three
// chunk kernels by 5-16% on the H100, so an epilogue with a second
// output finds it from `out` (vae_chunk.cu, EPI_LOSS).
struct Gemm {  // C [M, N] = A [M, K] B [K, N], then the epilogue
  Mat a, b;
  int M, N, K;
  int epi;            // the source's own epilogue code
  const float* bias;  // epilogues that add a bias row
  const float* aux;   // epilogues that read a second [M, ldo] operand
  float* out;
  int ldo;
  int param;          // Adam epilogue: which state tensor ([M, N])
};

__device__ __forceinline__ float ld(const float* p) { return *p; }

// v rounded to the nearest bfloat16 (ties to even), as a float
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// An operand of a product: rounded to bfloat16 in the bf16 builds.
__device__ __forceinline__ float opnd(float v) {
  if constexpr (BF16) return bf16r(v);
  return v;
}

// One EMA step, ema <- d ema + (1 - d) p, the TPU kernels' order
// (pallas_train.py:761-762, 1522-1524): two float32 products, one sum, no
// fused multiply-add; omd is 1 - d rounded once from double.
__device__ __forceinline__ float ema_step(float d, float e, float omd,
                                          float p) {
  return __fadd_rn(__fmul_rn(d, e), __fmul_rn(omd, p));
}

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float softplus(float u) {
  return fmaxf(u, 0.0f) + log1pf(expf(-fabsf(u)));
}

struct AdamT {  // one update's learning rate and bias corrections
  float lr, bc1, bc2;
};

template <class A>
__device__ __forceinline__ AdamT adam_t(const A& a, float lr, float t) {
  AdamT r;
  r.lr = lr;
  r.bc1 = 1.0f - expf(t * a.log_b1);
  r.bc2 = 1.0f - expf(t * a.log_b2);
  return r;
}

// One Adam step on element i of state tensor q; returns the new
// parameter (for an EMA plane).
template <class A>
__device__ __forceinline__ float adam(const A& a, int q, size_t i, float g,
                                      const AdamT& t) {
  const float m = a.b1 * ld(a.mu[q] + i) + a.omb1 * g;
  const float v = a.b2 * ld(a.nu[q] + i) + (a.omb2 * g) * g;
  a.mu[q][i] = m;
  a.nu[q][i] = v;
  const float mhat = m / t.bc1;
  const float vhat = v / t.bc2;
  const float p = ld(a.p[q] + i) - (t.lr * mhat) / (sqrtf(vhat) + a.eps);
  a.p[q][i] = p;
  return p;
}

__device__ __forceinline__ int tiles_of(const Gemm& g) {
  return ((g.M + TM - 1) / TM) * ((g.N + TN - 1) / TN);
}

// What becomes of element (m, n) of a job's product, c: each source
// defines this for its argument types.
template <class A>
__device__ __forceinline__ void epilogue(const A& a, const Gemm& g, int m,
                                         int n, float c, const AdamT& at);

// One TM x TN output tile, the depth split over the block's warps: warp
// w takes the SK-deep slices w, w + WARPS, ... (staged in its own corner
// of shared memory, the next slice's loads in flight while it computes
// this one), lane l keeps column n0 + l of all TM rows, and the warps'
// partial tiles are summed in a fixed order at the end (bf16 builds:
// each operand rounded as it is staged). The job is
// copied to registers once and every load is unconditional (an element
// past the edge reads the operand's first element and is zeroed), so
// the loads issue back to back.
template <class A>
__device__ void gemm_tile(const A& a, const Gemm& job, int tile,
                          const AdamT& at, float* smem) {
  const Gemm g = job;
  const int tiles_n = (g.N + TN - 1) / TN;
  const int m0 = (tile / tiles_n) * TM;
  const int n0 = (tile % tiles_n) * TN;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int lo = lane & 15, hi = lane >> 4;
  float* const As = smem + w * WARP_SMEM;  // [SK][TM]
  float* const Bs = As + SK * TM;          // [SK][TN + 1]
  // this lane's A elements: q-th at row am0 + q*adm, depth ak0 + q*adk
  const bool a_kc = g.a.cs == 1;           // A's k is contiguous
  const int am0 = a_kc ? hi : lo, ak0 = a_kc ? lo : hi;
  const int adm = a_kc ? 2 : 0, adk = a_kc ? 0 : 2;
  // B elements: q-th at depth bk0 + q*bdk, column bn0 + q*bdn
  const bool b_nc = g.b.cs == 1;           // B's n is contiguous
  const int bk0 = b_nc ? 0 : lo, bn0 = b_nc ? lane : hi;
  const int bdk = b_nc ? 1 : 0, bdn = b_nc ? 0 : 2;
  const int slices = (g.K + SK - 1) / SK;
  float ra[A_PER_LANE], rb[B_PER_LANE];
  float acc[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) acc[m] = 0.0f;

  auto load = [&](int s) {
    const int k0 = s * SK;
#pragma unroll
    for (int q = 0; q < A_PER_LANE; ++q) {
      const int m = m0 + am0 + q * adm, k = k0 + ak0 + q * adk;
      const bool ok = m < g.M && k < g.K;
      const float v = ld(g.a.p + (ok ? m * g.a.rs + k * g.a.cs : 0));
      ra[q] = ok ? v : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < B_PER_LANE; ++q) {
      const int k = k0 + bk0 + q * bdk, n = n0 + bn0 + q * bdn;
      const bool ok = n < g.N && k < g.K;
      const float v = ld(g.b.p + (ok ? k * g.b.rs + n * g.b.cs : 0));
      rb[q] = ok ? v : 0.0f;
    }
  };

  if (w < slices) load(w);
  for (int s = w; s < slices; s += WARPS) {
    __syncwarp();  // every lane is done reading the previous slice
#pragma unroll
    for (int q = 0; q < A_PER_LANE; ++q)
      As[(ak0 + q * adk) * TM + am0 + q * adm] = opnd(ra[q]);
#pragma unroll
    for (int q = 0; q < B_PER_LANE; ++q)
      Bs[(bk0 + q * bdk) * (TN + 1) + bn0 + q * bdn] = opnd(rb[q]);
    __syncwarp();
    if (s + WARPS < slices) load(s + WARPS);
#pragma unroll
    for (int kk = 0; kk < SK; ++kk) {
      const float4* ar = reinterpret_cast<const float4*>(As + kk * TM);
      const float bv = Bs[kk * (TN + 1) + lane];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 av = ar[q];
        acc[4 * q + 0] = fmaf(av.x, bv, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(av.y, bv, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(av.z, bv, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(av.w, bv, acc[4 * q + 3]);
      }
    }
  }

  __syncthreads();  // the staging area becomes the partial tiles
  float* const red = smem;  // [WARPS][TM][TN]
#pragma unroll
  for (int m = 0; m < TM; ++m) red[(w * TM + m) * TN + lane] = acc[m];
  __syncthreads();
  for (int o = threadIdx.x; o < TM * TN; o += CT) {
    const int mm = o / TN, nn = o % TN;
    float c = 0.0f;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) c += red[(v * TM + mm) * TN + nn];
    const int m = m0 + mm, n = n0 + nn;
    if (m < g.M && n < g.N) epilogue(a, g, m, n, c, at);
  }
  __syncthreads();  // before the next tile stages into the same memory
}

// The phase's product tiles, spread over the grid.
template <class A>
__device__ void run_gemms(const A& a, const Gemm* jobs, int njobs,
                          const AdamT& at, float* smem) {
  int total = 0;
  for (int j = 0; j < njobs; ++j) total += tiles_of(jobs[j]);
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int j = 0, s = t;
    while (s >= tiles_of(jobs[j])) s -= tiles_of(jobs[j++]);
    gemm_tile(a, jobs[j], s, at, smem);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
