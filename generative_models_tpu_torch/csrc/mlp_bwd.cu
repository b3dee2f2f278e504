// Whole-MLP backward, for Hopper (sm_90a): every dW, db and dx of an
// MLP stack from one C entry (two launches on one stream, three when the
// batch is split into slices).
//
// Replaces: generative_models_tpu/ops/pallas_mlp.py::_make_bwd_kernel and
// ::_bwd_call (the TPU kernel behind mlp_pallas's custom VJP, _vjp_bwd).
//
// What it computes. Layers l = 0..n-1, W_l [K_l, K_{l+1}], act_l, and the
// forward's h_0 = x, h_1..h_{n-1} (hiddens), h_n = out. Given dy [B, K_n]:
//     g_{n-1} = dy * act'_{n-1}(out)                 (derivative from the
//     dW_l    = h_l^T g_l,  db_l = sum_rows g_l       layer's OUTPUT, as
//     g_{l-1} = (g_l W_l^T) * act'_{l-1}(h_l)        pallas_mlp.py:68-79)
//     dx      = g_0 W_0^T
// With bf16 != 0 both operands of every product are rounded to bfloat16
// (round to nearest even) and the sums stay float32; db sums the float32
// g, as the TPU kernel's `cast` does (pallas_mlp.py:241-242).
//
// Design. On the TPU the grid runs in order and dW accumulates in VMEM
// across batch tiles. Hopper blocks run in no order, so the cross-row sum
// gets passes of its own and every sum has one owner and a fixed order
// (deterministic, no atomics):
//   pass 1, mlp_bwd_rows: the row chain of mlp_chain.cuh run down the
//     stack through W^T (a cluster of C CTAs a row tile, each a column
//     slice of every layer; W staged by coalesced rows and read
//     transposed from shared memory; streamed at large batches); it
//     stores every g_l to a scratch the caller allocates, and dx;
//   pass 2, mlp_bwd_dw: a block owns one 64x128 tile of one dW_l and one
//     slice of the batch rows; h_l and g_l arrive in 32-row chunks through
//     a 4-deep cp.async ring, and a thread keeps a 4x8 register tile (32
//     FMAs for three float4 reads, the next row's read while they run).
//     The blocks of the first row of tiles also sum their slice of db_l's
//     columns. With one slice (small B) they write dW and db; with S
//     slices they write partials to [S, K, N] and [S, N] scratch, and
//   pass 3, mlp_bwd_sum, adds the S partials of every element in slice
//     order.
// The launch plan (the chain's TR, row groups, C, chunk depth; S and the
// rows a slice) comes from ops/cuda_mlp.py::bwd_plan; this entry
// recomputes the shared bytes and the scratch size and refuses a plan it
// cannot run.
//
// Bound on the H100 (SXM, 700 W data-sheet peaks). The products run on
// the float32 FMA pipes in both modes, 67 TFLOP/s. nsgan D (784->400->1)
// at B = 100: 125.6 MFLOP, 1.9 us; nsgan G (128->400->784) at B = 100:
// 145.9 MFLOP, 2.2 us — far under one launch's latency, so at training
// batches the kernel is bound by latency: pass 1 spreads each layer over
// C CTAs with every W chunk in flight ahead of use, and pass 2 runs with
// one slice (two launches, as before). G at B = 8192: 11.95 GFLOP,
// 0.178 ms (operations; its bytes, ~100 MB, take 0.03 ms): pass 2 takes
// S slices, ~8 blocks an SM. What is still left (PERF.md): pass 1
// at B 8192 is held back as the forward is (W re-read for every row
// tile, a fixed cost per chunk and CTA), 64x128 tiles waste the edges of
// 400- and 784-wide layers (78-89% of the FMAs useful), the three passes
// run one after the other, and the FMAs stay on the float32 pipes in
// bf16 mode.

#include "mlp_chain.cuh"

#define DW_TK 64
#define DW_TN 128
#define DW_RC 32
#define DW_STAGES 4

template <int TR>
__global__ void __launch_bounds__(CH_THREADS, 1)
mlp_bwd_rows(const ChainArgs a) {
  chain_body<TR, true>(a);
}

struct DwArgs {
  const float* h[CH_MAX_LAYERS];  // h_0 = x, h_1..h_{n-1}
  const float* g[CH_MAX_LAYERS];  // g_l [B, K_{l+1}]
  float* dw[CH_MAX_LAYERS];       // dW_l, or its [S, K, N] partials
  float* db[CH_MAX_LAYERS];       // db_l, or its [S, N] partials
  int dims[CH_MAX_LAYERS + 1];
  int tile_start[CH_MAX_LAYERS + 1];
  int vec_h[CH_MAX_LAYERS];
  int vec_g[CH_MAX_LAYERS];
  int vec_dw[CH_MAX_LAYERS];
  int n_layers;
  int batch;
  int slice_rows;  // a multiple of DW_RC
  int slices;
  int bf16;
};

__global__ void __launch_bounds__(CH_THREADS)
mlp_bwd_dw(const DwArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // k: 4 ty .. 4 ty + 3
  const int tx = tid % 16;  // n: 4 tx .. +3 and 64 + 4 tx .. +3
  int l = 0;
  while ((int)blockIdx.x >= a.tile_start[l + 1]) ++l;
  const int K = a.dims[l];
  const int N = a.dims[l + 1];
  const int tiles_n = (N + DW_TN - 1) / DW_TN;
  const int t = blockIdx.x - a.tile_start[l];
  const int k0 = (t / tiles_n) * DW_TK;
  const int n0 = (t % tiles_n) * DW_TN;
  const int s = blockIdx.y;
  const int r_begin = s * a.slice_rows;
  int r_end = r_begin + a.slice_rows;
  r_end = r_end < a.batch ? r_end : a.batch;
  const int chunks = (r_end - r_begin + DW_RC - 1) / DW_RC;
  const float* __restrict__ H = a.h[l];
  const float* __restrict__ G = a.g[l];
  const int stage = DW_RC * (DW_TK + DW_TN);
  const bool vh = a.vec_h[l], vg = a.vec_g[l];

  auto issue = [&](int c) {
    if (c >= chunks) return;
    float* hs = smem + (c % DW_STAGES) * stage;
    float* gs = hs + DW_RC * DW_TK;
    const int rb = r_begin + c * DW_RC;
    if (vh) {
      for (int e = tid; e < DW_RC * DW_TK / 4; e += CH_THREADS) {
        const int rr = e / (DW_TK / 4), c4 = e - rr * (DW_TK / 4);
        const int r = rb + rr, k = k0 + 4 * c4;
        const bool ok = r < r_end && k < K;
        cp_async16(hs + rr * DW_TK + 4 * c4, ok ? H + (size_t)r * K + k : H,
                   ok);
      }
    } else {
      for (int e = tid; e < DW_RC * DW_TK; e += CH_THREADS) {
        const int rr = e / DW_TK, cc = e - rr * DW_TK;
        const int r = rb + rr, k = k0 + cc;
        const bool ok = r < r_end && k < K;
        cp_async4(hs + e, ok ? H + (size_t)r * K + k : H, ok);
      }
    }
    if (vg) {
      for (int e = tid; e < DW_RC * DW_TN / 4; e += CH_THREADS) {
        const int rr = e / (DW_TN / 4), c4 = e - rr * (DW_TN / 4);
        const int r = rb + rr, nn = n0 + 4 * c4;
        const bool ok = r < r_end && nn < N;
        cp_async16(gs + rr * DW_TN + 4 * c4, ok ? G + (size_t)r * N + nn : G,
                   ok);
      }
    } else {
      for (int e = tid; e < DW_RC * DW_TN; e += CH_THREADS) {
        const int rr = e / DW_TN, cc = e - rr * DW_TN;
        const int r = rb + rr, nn = n0 + cc;
        const bool ok = r < r_end && nn < N;
        cp_async4(gs + e, ok ? G + (size_t)r * N + nn : G, ok);
      }
    }
  };

  for (int c = 0; c < DW_STAGES - 1; ++c) {
    issue(c);
    cp_async_commit();
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const bool db_thread = k0 == 0 && tid < DW_TN;
  float dbs = 0.0f;

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();
    issue(c + DW_STAGES - 1);
    cp_async_commit();
    float* hs = smem + (c % DW_STAGES) * stage;
    float* gs = hs + DW_RC * DW_TK;
    if (db_thread) {  // db sums the float32 g; zero-filled rows add 0
#pragma unroll
      for (int rr = 0; rr < DW_RC; ++rr) dbs += gs[rr * DW_TN + tid];
    }
    if (a.bf16) {
      __syncthreads();
      for (int e = tid; e < stage; e += CH_THREADS) hs[e] = round_bf16(hs[e]);
      __syncthreads();
    }
    // the next row's fragments load while this row's FMAs run
    float4 hv = *reinterpret_cast<const float4*>(hs + 4 * ty);
    float4 g0 = *reinterpret_cast<const float4*>(gs + 4 * tx);
    float4 g1 = *reinterpret_cast<const float4*>(gs + 64 + 4 * tx);
#pragma unroll 4
    for (int rr = 0; rr < DW_RC; ++rr) {
      const int rn = rr + 1 < DW_RC ? rr + 1 : rr;
      const float4 hn = *reinterpret_cast<const float4*>(hs + rn * DW_TK + 4 * ty);
      const float4 gn0 = *reinterpret_cast<const float4*>(gs + rn * DW_TN + 4 * tx);
      const float4 gn1 =
          *reinterpret_cast<const float4*>(gs + rn * DW_TN + 64 + 4 * tx);
      const float hh[4] = {hv.x, hv.y, hv.z, hv.w};
      const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(hh[i], gg[j], acc[i][j]);
      hv = hn;
      g0 = gn0;
      g1 = gn1;
    }
  }
  cp_async_wait<0>();

  const size_t part = a.slices > 1 ? (size_t)s * K * N : 0;
  float* const dW = a.dw[l] + part;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
    if (k >= K) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nb = n0 + 64 * half + 4 * tx;
      float* dst = dW + (size_t)k * N + nb;
      if (a.vec_dw[l] && nb < N) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * half], acc[i][4 * half + 1],
                        acc[i][4 * half + 2], acc[i][4 * half + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nb + j < N) dst[j] = acc[i][4 * half + j];
      }
    }
  }
  if (db_thread && n0 + tid < N)
    a.db[l][(a.slices > 1 ? (size_t)s * N : 0) + n0 + tid] = dbs;
}

struct SumArgs {
  const float* part[CH_MAX_LAYERS];  // [S, K*N] then [S, N] of layer l
  float* dw[CH_MAX_LAYERS];
  float* db[CH_MAX_LAYERS];
  int kn[CH_MAX_LAYERS];      // K_l * N_l
  int nn[CH_MAX_LAYERS];      // N_l
  int start[CH_MAX_LAYERS + 1];  // first element of layer l (dW then db)
  int n_layers;
  int slices;
};

// dW and db as the sum of their S slice partials, in slice order.
__global__ void __launch_bounds__(CH_THREADS)
mlp_bwd_sum(const SumArgs a) {
  const int total = a.start[a.n_layers];
  for (int e = blockIdx.x * CH_THREADS + threadIdx.x; e < total;
       e += gridDim.x * CH_THREADS) {
    int l = 0;
    while (e >= a.start[l + 1]) ++l;
    const int i = e - a.start[l];
    const bool is_w = i < a.kn[l];
    const float* src = is_w ? a.part[l] + i
                            : a.part[l] + (size_t)a.slices * a.kn[l] +
                                  (i - a.kn[l]);
    const size_t step = is_w ? a.kn[l] : a.nn[l];
    float v = 0.0f;
    for (int s = 0; s < a.slices; ++s) v += src[s * step];
    if (is_w) a.dw[l][i] = v;
    else a.db[l][i - a.kn[l]] = v;
  }
}

// Floats of scratch the sliced pass 2 needs (0 with one slice); each
// layer's partials start on a 16-byte boundary. The same formula as
// ops/cuda_mlp.py::bwd_plan.
static size_t scratch_floats(const int* dims, int n, int slices,
                             size_t* offs) {
  size_t total = 0;
  for (int l = 0; l < n; ++l) {
    if (offs) offs[l] = total;
    if (slices > 1)
      total += ((size_t)slices * (dims[l] * (size_t)dims[l + 1] + dims[l + 1])
                + 3) / 4 * 4;
  }
  return total;
}

template <int TR>
static cudaError_t launch_rows(const ChainArgs& a, int grid, int csize,
                               size_t smem, cudaStream_t s) {
  return launch_cluster(mlp_bwd_rows<TR>, a, grid, csize, smem, s);
}

// Launches the passes on `stream`; allocates nothing and does not
// synchronise. hiddens: h_1..h_{n-1}; gs: n scratch buffers g_l
// [batch, dims[l+1]]; plan: {tr, rg, cluster, kc, smem bytes, streamed,
// slices, slice rows, scratch floats} from ops/cuda_mlp.py::bwd_plan; scratch:
// that many floats (unused with one slice). Returns the CUDA error code
// (0 = queued); cudaErrorInvalidValue for a plan it cannot run.
extern "C" int gm_mlp_bwd(const float* x, int batch, int n_layers,
                          const int* dims, void* const* ws,
                          void* const* hiddens, const float* out,
                          const float* dy, void* const* gs, void* const* dws,
                          void* const* dbs, float* dx, const int* acts,
                          float slope, int bf16, const int* plan,
                          float* scratch, void* stream) {
  if (n_layers < 1 || n_layers > CH_MAX_LAYERS || batch < 1)
    return (int)cudaErrorInvalidValue;
  const int n = n_layers;
  for (int l = 0; l <= n; ++l)
    if (dims[l] < 1) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n; ++l)
    if (acts[l] < ACT_NONE || acts[l] > ACT_TANH)
      return (int)cudaErrorInvalidValue;
  const float* h[CH_MAX_LAYERS];
  h[0] = x;
  for (int l = 1; l < n; ++l) h[l] = static_cast<const float*>(hiddens[l - 1]);

  // pass 1: the chain runs layer n-1 first (chain layer i = layer n-1-i)
  ChainArgs a = {};
  a.in = dy;
  a.in_act = out;
  a.in_act_code = acts[n - 1];
  a.in_store = static_cast<float*>(gs[n - 1]);
  a.n_layers = n;
  a.batch = batch;
  a.slope = slope;
  a.bf16 = bf16 ? 1 : 0;
  for (int i = 0; i <= n; ++i) a.width[i] = dims[n - i];
  for (int i = 0; i < n; ++i) {
    const int l = n - 1 - i;
    a.w[i] = static_cast<const float*>(ws[l]);
    a.vec_w[i] = dims[l + 1] % 4 == 0 && aligned16(ws[l]);
    if (l > 0) {
      a.hact[i] = h[l];
      a.act[i] = acts[l - 1];
      a.out[i] = static_cast<float*>(gs[l - 1]);
    } else {
      a.out[i] = dx;
    }
  }
  for (int i = 0; i < n; ++i) {  // streamed: chain layer i's input g_l
    a.a_src[i] = static_cast<const float*>(gs[n - 1 - i]);
    a.vec_a[i] = a.width[i] % 4 == 0 && aligned16(a.a_src[i]);
  }
  a.vec_in = dims[n] % 4 == 0 && aligned16(dy);
  a.vec_in_act = dims[n] % 4 == 0 && aligned16(out);
  const int tr = plan[0], csize = plan[2];
  a.rg = plan[1];
  a.kc = plan[3];
  const int slices = plan[6], slice_rows = plan[7];
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = chain_plan(a, tr, csize, true, plan[5], (size_t)optin);
  if (smem == 0 || smem != (size_t)plan[4]) return (int)cudaErrorInvalidValue;
  if (slices < 1 || slice_rows < DW_RC || slice_rows % DW_RC ||
      (size_t)slices * slice_rows < (size_t)batch ||
      (size_t)(slices - 1) * slice_rows >= (size_t)batch)
    return (int)cudaErrorInvalidValue;
  size_t offs[CH_MAX_LAYERS];
  if (scratch_floats(dims, n, slices, offs) != (size_t)(unsigned)plan[8] ||
      (slices > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tm = a.rg * tr;
  const int grid = (batch + tm - 1) / tm * csize;
  switch (tr) {
    case 1: e = launch_rows<1>(a, grid, csize, smem, s); break;
    case 4: e = launch_rows<4>(a, grid, csize, smem, s); break;
    default: e = launch_rows<8>(a, grid, csize, smem, s); break;
  }
  if (e != cudaSuccess) return (int)e;

  // pass 2: dW and db tiles, one slice of the rows each
  DwArgs d = {};
  d.n_layers = n;
  d.batch = batch;
  d.slices = slices;
  d.slice_rows = slice_rows;
  d.bf16 = a.bf16;
  int tiles = 0;
  SumArgs sa = {};
  sa.n_layers = n;
  sa.slices = slices;
  sa.start[0] = 0;
  for (int l = 0; l < n; ++l) {
    const int K = dims[l], N = dims[l + 1];
    d.dims[l] = K;
    d.h[l] = h[l];
    d.g[l] = static_cast<const float*>(gs[l]);
    if (slices > 1) {
      d.dw[l] = scratch + offs[l];
      d.db[l] = scratch + offs[l] + (size_t)slices * K * N;
    } else {
      d.dw[l] = static_cast<float*>(dws[l]);
      d.db[l] = static_cast<float*>(dbs[l]);
    }
    d.vec_h[l] = K % 4 == 0 && aligned16(h[l]);
    d.vec_g[l] = N % 4 == 0 && aligned16(gs[l]);
    d.vec_dw[l] = N % 4 == 0 && aligned16(d.dw[l]);
    d.tile_start[l] = tiles;
    tiles += ((K + DW_TK - 1) / DW_TK) * ((N + DW_TN - 1) / DW_TN);
    sa.part[l] = scratch + offs[l];
    sa.dw[l] = static_cast<float*>(dws[l]);
    sa.db[l] = static_cast<float*>(dbs[l]);
    sa.kn[l] = K * N;
    sa.nn[l] = N;
    sa.start[l + 1] = sa.start[l] + K * N + N;
  }
  d.dims[n] = dims[n];
  d.tile_start[n] = tiles;
  const size_t dw_smem = sizeof(float) * DW_STAGES * DW_RC * (DW_TK + DW_TN);
  e = cudaFuncSetAttribute(mlp_bwd_dw,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dw_smem);
  if (e != cudaSuccess) return (int)e;
  mlp_bwd_dw<<<dim3(tiles, slices, 1), CH_THREADS, dw_smem, s>>>(d);
  e = cudaGetLastError();
  if (e != cudaSuccess || slices == 1) return (int)e;

  // pass 3: the slices' partials, summed in slice order
  int blocks = (sa.start[n] + CH_THREADS - 1) / CH_THREADS;
  blocks = blocks < 1024 ? blocks : 1024;
  mlp_bwd_sum<<<blocks, CH_THREADS, 0, s>>>(sa);
  return (int)cudaGetLastError();
}
