// Whole-MLP forward in one launch, for Hopper (sm_90a): the row chain
// for stacks and small batches, and a tiled float32 GEMM for one layer
// at thousands of rows (the GEMM route, below the chain's note).
//
// Replaces: generative_models_tpu/ops/pallas_mlp.py::_make_kernel and
// ::_fwd_call (the TPU kernel reached through mlp_pallas /
// mlp_apply_pallas), and through it ops/pallas_linear.py::linear_pallas
// (the same kernel with one layer).
//
// What it computes, per row r of x [B, K0] and per layer l = 0..n-1:
//     h_{l+1} = act_l(h_l @ W_l + b_l),   h_0 = x,  W_l [K_l, K_{l+1}]
// and it stores every h_1..h_{n-1} and the output h_n in float32 (the
// hiddens are what the backward kernel consumes). With bf16 != 0 both
// matmul operands are rounded to bfloat16 (round to nearest even) and
// the products are summed in float32; the bias and the activation stay
// float32 — the TPU kernel's bf16 path (pallas_mlp.py:92-95).
//
// Design: the row chain of mlp_chain.cuh. A cluster of C CTAs owns a
// tile of TM rows; each CTA computes one column slice of every layer.
// At small batches the hidden tile stays on chip and each CTA hands its
// slice to the whole cluster through distributed shared memory; at
// large batches (streamed mode) the layer's input streams back from
// device memory beside W, so a CTA can take more rows. Widths are the
// true ones: columns are cut in groups of 4 and balanced over the
// ranks, and ragged rows of the last tile are computed and not stored.
// The launch plan (item rows TR, row groups, C, chunk depth, streamed)
// comes from ops/cuda_mlp.py::fwd_plan; this entry recomputes the
// shared bytes and refuses a plan it cannot run.
//
// Bound on the H100 (SXM, 700 W data-sheet peaks): nsgan G at B = 8192
// does 2*8192*(128*400 + 400*784) = 5.98 GFLOP and must move about
// 43 MB (z 4.2 MB in; h 13.1 MB and out 25.7 MB out; 1.46 MB of
// weights). The FMAs run on the float32 pipes (not the tensor cores)
// in both modes, so the bound is operations: 5.98 GFLOP / 67 TFLOP/s
// = 89 us, against 43 MB / 3.35 TB/s = 13 us for the bytes. At G B 64-100
// the bound is ~1 us, far under a launch: the plan spreads each layer
// over clusters of 8 (~100 CTAs at B 100) with
// one row an item, and the W stream is in flight from the first
// instruction. At B 8192 a thread keeps an 8 x 8 register tile whose
// operands both come from shared memory. What is still left (PERF.md):
// at B 8192 the kernel runs at ~1/4 of the float32 peak, half of
// what the library's separate GEMMs reach, held back by W re-read from
// L2 for every row tile, a fixed cost per chunk and per CTA (staging,
// epilogue, barriers), and shared-memory reads at 16 FMAs each; and the
// FMAs stay on the float32 pipes in bf16 mode
// (mma.sync on the bf16 operands would lift its bound 15x).

// The GEMM route (gm_mlp_gemm). Replaces no TPU kernel beyond
// ops/pallas_linear.py::linear_pallas, which it serves: one
// act(x @ W + b) layer, float32 operands and products, whose batch is at
// least ops/cuda_mlp.py::GEMM_MIN_ROWS (the chain's crossover, measured
// by tools/mlp_ab.py --sweep). Such a call gets nothing from the chain's
// hidden tile on chip and pays all of its costs, so it has its own
// kernel, which shares no tile logic with the chain.
//
// Bound: operations. The diffusion net's reverse step at n = 10,000
// runs eight such layers, 1,537,024 multiply-adds a row: 30.7 GFLOP,
// 0.459 ms at the float32 peak of 67 TFLOP/s. The largest, skip
// (784 -> 784), does 12.3 GFLOP (183 us) and moves 65 MB (x and out
// 31.4 MB each, W 2.5 MB: 19 us at 3.35 TB/s); the smallest, 128 -> 128,
// 0.33 GFLOP (4.9 us) against 10.3 MB (3.1 us). The FMAs stay on the
// float32 pipes: no TF32, no split products, no bf16.
//
// Design. A CTA owns a BM x BN output tile (64 x 128, 128 x 112 or
// 128 x 128), one thread an 8 x 8 register tile: rows tr*4 + i and
// BM/2 + tr*4 + i, columns tc*4 + j and BN/2 + tc*4 + j (i, j < 4), so
// each 16-byte fragment load of a warp touches neighbouring addresses.
// Each 16-deep step of K lands in a ring of GM_STAGES slots by 16-byte
// cp.async (three steps in flight behind the FMAs): W's rows as they
// lie, x's rows as four k-quad planes (row m's four k at 4m of a plane,
// planes 8 floats apart, so a quarter-warp's copies and its fragment
// loads hit distinct banks). Each thread copies fixed rows and columns,
// so its copy addresses are one pointer each and a step's copies cost a
// few instructions. Per four k a thread reads 8 float4 of x and 8 of W
// and runs 256 FMAs. Registers are capped at 168 a thread (at 128 the
// compiler spills), which keeps three 64 x 128 CTAs (12 warps) on an
// SM; one CTA's waits, barriers and epilogue hide behind the others'
// FMAs. Epilogue: bias, then the act code, float4 stores where the
// width allows; ragged rows, columns and depth are masked (zero-filled
// copies, skipped stores; 4-byte copies where a width is not a
// multiple of 4 or a pointer is not 16-byte aligned).
//
// What bounds it on the card (tools/mlp_ab.py --sweep, H100 700 W):
// shared memory feeds a thread's 8 + 8 operands of every 64 FMAs, 128
// bytes a clock an SM, as fast as the FMA pipes eat them, so with no
// copies at all this loop ran at 50% of the float32 peak; registers
// alone (no shared memory) reach 76%. The route runs at 43-48% at
// n 10,000 (the chain 24-29%).
//
// Tile and wave plan (ops/cuda_mlp.py::gemm_plan): a plain grid, tiles
// columns first, so a row panel of x is read from device memory once
// and then from L2 while its column tiles run, and W stays in L2. The
// planner takes the tile that leaves the fullest SM the least time, by
// its rounds of resident CTAs at the rate their warps were measured to
// reach: at n 10,000 the 64 x 128 tile for every width (1099 tiles for
// 784, three an SM at a time); the 128-row tiles, one an SM, where they
// fill the SMs in fewer rounds (400 wide at 4096-8192 rows). Tiles
// fitted to 400 (80 wide) took 160 threads, which at 168 registers fit
// two CTAs an SM and ran 17-23% slower than the 128-wide tile with its
// 112 padded columns; the padded columns are zero-filled and cost FMAs
// only.

#include "mlp_chain.cuh"

template <int TR>
__global__ void __launch_bounds__(CH_THREADS, 1)
mlp_fwd_kernel(const ChainArgs a) {
  chain_body<TR, false>(a);
}

using ChainKernel = void (*)(const ChainArgs);

static ChainKernel chain_kernel(int tr) {
  switch (tr) {
    case 1: return mlp_fwd_kernel<1>;
    case 4: return mlp_fwd_kernel<4>;
    default: return mlp_fwd_kernel<8>;
  }
}

// Launches the kernel on `stream`; allocates nothing and does not
// synchronise. plan: {tr, rg, cluster, kc, smem bytes, streamed} from
// ops/cuda_mlp.py::fwd_plan. Returns the CUDA error code of the launch
// (0 = queued); cudaErrorInvalidValue for a plan it cannot run.
extern "C" int gm_mlp_fwd(const float* x, int batch, int n_layers,
                          const int* dims, void* const* ws,
                          void* const* bs, void* const* outs,
                          const int* acts, float slope, int bf16,
                          const int* plan, void* stream) {
  if (n_layers < 1 || n_layers > CH_MAX_LAYERS || batch < 1)
    return (int)cudaErrorInvalidValue;
  ChainArgs a = {};
  a.in = x;
  a.n_layers = n_layers;
  a.batch = batch;
  a.slope = slope;
  a.bf16 = bf16 ? 1 : 0;
  a.width[0] = dims[0];
  if (dims[0] < 1) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_layers; ++l) {
    if (dims[l + 1] < 1 || acts[l] < ACT_NONE || acts[l] > ACT_TANH)
      return (int)cudaErrorInvalidValue;
    a.w[l] = static_cast<const float*>(ws[l]);
    a.bias[l] = static_cast<const float*>(bs[l]);
    a.out[l] = static_cast<float*>(outs[l]);
    a.width[l + 1] = dims[l + 1];
    a.act[l] = acts[l];
    a.vec_w[l] = dims[l + 1] % 4 == 0 && aligned16(ws[l]);
    a.vec_out[l] = dims[l + 1] % 4 == 0 && aligned16(outs[l]);
  }
  a.vec_in = dims[0] % 4 == 0 && aligned16(x);
  for (int l = 0; l < n_layers; ++l) {  // streamed: layer l's input
    a.a_src[l] = l == 0 ? x : a.out[l - 1];
    a.vec_a[l] = dims[l] % 4 == 0 && aligned16(a.a_src[l]);
  }
  const int tr = plan[0], csize = plan[2];
  a.rg = plan[1];
  a.kc = plan[3];
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = chain_plan(a, tr, csize, false, plan[5], (size_t)optin);
  if (smem == 0 || smem != (size_t)plan[4]) return (int)cudaErrorInvalidValue;
  const int tm = a.rg * tr;
  const int grid = (batch + tm - 1) / tm * csize;
  return (int)launch_cluster(chain_kernel(tr), a, grid, csize, smem,
                             static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------
// The GEMM route: out = act(x @ W + b) for one layer
// ---------------------------------------------------------------------

#define GM_BK 16      // depth of a ring slot (ops/cuda_mlp.py GEMM_DEPTH)
#define GM_STAGES 4   // ring slots (GEMM_STAGES)

struct GemmArgs {
  const float* x;     // [m, k]
  const float* w;     // [k, n]
  const float* bias;  // [n]
  float* out;         // [m, n]
  int m, k, n;
  int col_tiles;      // tiles across n; tile t is (t / col_tiles, t % col_tiles)
  int act;
  float slope;
  int vec_x;          // x rows may be read 16 bytes at a time
  int vec_w;          // W rows may be read 16 bytes at a time
  int vec_out;        // out rows may be written as float4
};

// CTAs an SM that the launch bounds ask registers for: up to 168 a
// thread, which the 8 x 8 tile, its operands and the copy pointers take
// without spilling (at 128 they spill).
__host__ __device__ constexpr int gemm_min_blocks(int threads) {
  return 65536 / (168 * threads) > 1 ? 65536 / (168 * threads) : 1;
}

__device__ __forceinline__ float f4_at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int BM, int BN>
__global__ void __launch_bounds__(BM * BN / 64, gemm_min_blocks(BM * BN / 64))
mlp_fwd_kernel(const GemmArgs a) {
  constexpr int THREADS = BM * BN / 64;
  constexpr int TCN = BN / 8;               // threads across a tile's columns
  constexpr int PLANE = 4 * BM + 8;         // floats of one k-quad plane of x
  constexpr int A_SLOT = GM_BK / 4 * PLANE; // x's planes, then W's rows
  constexpr int SLOT = A_SLOT + GM_BK * BN;
  constexpr int A_TASKS = BM * GM_BK / 4;   // float4 of x a slot
  constexpr int W_TASKS = GM_BK * BN / 4;   // float4 of W a slot
  static_assert(BM % 8 == 0 && BN % 8 == 0, "8 x 8 register tiles");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int row0 = (int)(blockIdx.x / a.col_tiles) * BM;
  const int col0 = (int)(blockIdx.x % a.col_tiles) * BN;
  const int k_steps = (a.k + GM_BK - 1) / GM_BK;

  // Ring slot <- depth step ks. x's [BM][GM_BK] block lands as four
  // k-quad planes [BM][4] (row m's k0 + 4q .. + 3 at q * PLANE + 4m):
  // four neighbouring lanes read one row's 64 bytes, and the planes'
  // 8-float pad puts the quarter-warp's two rows x four planes on
  // distinct banks. W's [GM_BK][BN] block lands as it lies. A thread
  // copies x's quad xq of rows xr + j THREADS / 4 and W's columns
  // wc .. wc + 3 of rows wk + j THREADS / (BN / 4), so one pointer and
  // one bound each carry over the steps.
  static_assert(THREADS % (BN / 4) == 0, "whole W rows a pass");
  const int xr = tid >> 2, xq = tid & 3;
  const int wk = tid / (BN / 4), wc = tid % (BN / 4) * 4;
  const float* xp = a.x + (size_t)(row0 + xr) * a.k + 4 * xq;
  const float* wp = a.w + (size_t)wk * a.n + col0 + wc;
  const int x_rows = a.m - row0 - xr;  // passes j * THREADS / 4 below it
  const bool w_col = col0 + wc < a.n;
  auto issue = [&](int ks) {
    float* xs = smem + (ks % GM_STAGES) * SLOT;
    float* ws = xs + A_SLOT;
    const int k0 = ks * GM_BK;
#pragma unroll
    for (int j = 0; j < (A_TASKS + THREADS - 1) / THREADS; ++j) {
      if (A_TASKS % THREADS && tid + j * THREADS >= A_TASKS) break;
      const int gk = k0 + 4 * xq;
      const bool row_ok = j * (THREADS / 4) < x_rows;
      const float* src = xp + (size_t)j * (THREADS / 4) * a.k + k0;
      float* dst = xs + xq * PLANE + 4 * (xr + j * (THREADS / 4));
      if (a.vec_x) {
        const bool ok = row_ok && gk < a.k;
        cp_async16(dst, ok ? src : a.x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = row_ok && gk + e < a.k;
          cp_async4(dst + e, ok ? src + e : a.x, ok);
        }
      }
    }
    if (a.vec_w) {
#pragma unroll
      for (int j = 0; j < (W_TASKS + THREADS - 1) / THREADS; ++j) {
        if (W_TASKS % THREADS && tid + j * THREADS >= W_TASKS) break;
        const int k = wk + j * (THREADS / (BN / 4));
        const bool ok = w_col && k0 + k < a.k;
        cp_async16(ws + k * BN + wc,
                   ok ? wp + (size_t)(k0 + j * (THREADS / (BN / 4))) * a.n
                      : a.w,
                   ok);
      }
    } else {
      for (int t = tid; t < GM_BK * BN; t += THREADS) {
        const int k = t / BN, c = t % BN;
        const int gk = k0 + k, gn = col0 + c;
        const bool ok = gk < a.k && gn < a.n;
        cp_async4(ws + k * BN + c, ok ? a.w + (size_t)gk * a.n + gn : a.w,
                  ok);
      }
    }
  };

  const int tc = tid % TCN, tr = tid / TCN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < GM_STAGES - 1; ++s) {
    if (s < k_steps) issue(s);
    cp_async_commit();
  }
  for (int ks = 0; ks < k_steps; ++ks) {
    cp_async_wait<GM_STAGES - 2>();  // step ks has landed
    __syncthreads();                 // ... for every thread; slot ks - 1 is free
    if (ks + GM_STAGES - 1 < k_steps) issue(ks + GM_STAGES - 1);
    cp_async_commit();
    const float* xs = smem + (ks % GM_STAGES) * SLOT;
    const float* ws = xs + A_SLOT;
#pragma unroll
    for (int q = 0; q < GM_BK / 4; ++q) {
      float4 x4[8];  // the thread's 8 rows at depth 4q .. 4q + 3
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x4[i] = *reinterpret_cast<const float4*>(
            xs + q * PLANE + 4 * ((i >> 2) * (BM / 2) + tr * 4 + (i & 3)));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * q + e;
        const float4 b0 =
            *reinterpret_cast<const float4*>(ws + k * BN + tc * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(ws + k * BN + BN / 2 + tc * 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = f4_at(x4[i], e);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: bias, act, store; rows past m and columns past n skipped.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = col0 + h * (BN / 2) + tc * 4;
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bias[j] = c + j < a.n ? __ldg(a.bias + c + j) : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + (i >> 2) * (BM / 2) + tr * 4 + (i & 3);
      if (row >= a.m || c >= a.n) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = apply_act(acc[i][h * 4 + j] + bias[j], a.act, a.slope);
      float* o = a.out + (size_t)row * a.n + c;
      if (a.vec_out) {  // n % 4 == 0: the whole float4 lies in the row
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < a.n) o[j] = v[j];
      }
    }
  }
}

using GemmKernel = void (*)(const GemmArgs);

// The route's instantiations, (BM, BN) as ops/cuda_mlp.py::GEMM_TILES
// lists them; nullptr for any other.
static GemmKernel gemm_kernel(int bm, int bn) {
  if (bm == 64 && bn == 128) return mlp_fwd_kernel<64, 128>;
  if (bm == 128 && bn == 112) return mlp_fwd_kernel<128, 112>;
  if (bm == 128 && bn == 128) return mlp_fwd_kernel<128, 128>;
  return nullptr;
}

// Launches the GEMM route on `stream`: out [m, n] = act(x [m, k] @
// w [k, n] + b). plan: {BM, BN, smem bytes} from
// ops/cuda_mlp.py::gemm_plan. Returns the CUDA error code of the launch
// (0 = queued); cudaErrorInvalidValue for a plan or shape it cannot run.
extern "C" int gm_mlp_gemm(const float* x, int m, int k, int n,
                           const float* w, const float* b, float* out,
                           int act, float slope, const int* plan,
                           void* stream) {
  const int bm = plan[0], bn = plan[1];
  const GemmKernel kern = gemm_kernel(bm, bn);
  const size_t smem =
      sizeof(float) * GM_STAGES * (GM_BK * (size_t)(bm + bn) + 2 * GM_BK);
  if (kern == nullptr || m < 1 || k < 1 || n < 1 || act < ACT_NONE ||
      act > ACT_TANH || smem != (size_t)plan[2])
    return (int)cudaErrorInvalidValue;
  GemmArgs a = {};
  a.x = x;
  a.w = w;
  a.bias = b;
  a.out = out;
  a.m = m;
  a.k = k;
  a.n = n;
  a.col_tiles = (n + bn - 1) / bn;
  a.act = act;
  a.slope = slope;
  a.vec_x = k % 4 == 0 && aligned16(x);
  a.vec_w = n % 4 == 0 && aligned16(w);
  a.vec_out = n % 4 == 0 && aligned16(out);
  const long long tiles = (long long)((m + bm - 1) / bm) * a.col_tiles;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles, 1, 1);
  cfg.blockDim = dim3(bm * bn / 64, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
