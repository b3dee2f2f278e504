// Whole-MLP backward, for Hopper (sm_90a): every dW, db and dx of an
// MLP stack from one C entry (two launches on one stream).
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
// gets its own pass and every sum has one owner (deterministic, no
// atomics):
//   pass 1, row-parallel: a block owns TM rows and carries g down the
//     stack with the current g tile in shared memory (two alternating
//     buffers, as in mlp_fwd.cu); it stores every g_l to a scratch the
//     caller allocates, and dx;
//   pass 2, column-tiled: a block owns a 64x64 tile of one dW_l, loops
//     over all B rows in chunks of 32 (h_l and g_l chunks staged in
//     shared memory, coalesced) and keeps a 4x4 register tile a thread;
//     the blocks of the first row of tiles also sum db_l.
//
// Bound on the H100 (SXM, 700 W data-sheet peaks). The products run on
// the float32 FMA pipes in both modes, 67 TFLOP/s. nsgan D (784->400->1)
// at B = 100: 125.6 MFLOP, 1.9 us; nsgan G (128->400->784) at B = 100:
// 145.9 MFLOP, 2.2 us — far under one launch's latency, so at training
// batches the kernel is bound by latency, not by the card. G at B = 8192:
// 11.95 GFLOP, 0.178 ms (operations; its bytes, ~100 MB, take 0.03 ms).
// What the design gives away: pass 1 reads W_l row-wise per thread (not
// coalesced across a warp; W is L2-resident), and at small B pass 1 has
// few blocks. Tensor-core tiles are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define BWD_MAX_LAYERS 8
#define BWD_THREADS 256
#define BWD_COLS 2
#define DW_TILE 64
#define DW_ROWS 32

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY_RELU = 2, ACT_SIGMOID = 3,
       ACT_TANH = 4 };

struct BwdArgs {
  const float* x;
  const float* h[BWD_MAX_LAYERS + 1];  // h_0 = x, h_1..h_{n-1}, h_n = out
  const float* dy;
  const float* w[BWD_MAX_LAYERS];
  float* g[BWD_MAX_LAYERS];            // g_l [B, K_{l+1}] (scratch)
  float* dw[BWD_MAX_LAYERS];
  float* db[BWD_MAX_LAYERS];
  float* dx;
  int dims[BWD_MAX_LAYERS + 1];
  int acts[BWD_MAX_LAYERS];
  int tile_start[BWD_MAX_LAYERS + 1];  // pass 2: first tile of each layer
  int n_layers;
  int batch;
  int stride_a;  // shared row stride of g_{n-1}, g_{n-3}, ...
  int stride_b;  // ... of g_{n-2}, g_{n-4}, ...
  float slope;
  int bf16;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// act'(pre-activation) written through the activation's output y
__device__ __forceinline__ float act_deriv(float y, int act, float slope) {
  switch (act) {
    case ACT_RELU: return y > 0.0f ? 1.0f : 0.0f;
    case ACT_LEAKY_RELU: return y >= 0.0f ? 1.0f : slope;
    case ACT_SIGMOID: return y * (1.0f - y);
    case ACT_TANH: return 1.0f - y * y;
    default: return 1.0f;
  }
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

template <int TM>
__global__ void __launch_bounds__(BWD_THREADS)
mlp_bwd_rows(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* const buf_a = smem;
  float* const buf_b = smem + TM * a.stride_a;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  const int n = a.n_layers;

  {  // g_{n-1} = dy * act'(out); ragged rows and the column tail are zero
    const int K = a.dims[n];
    const int S = a.stride_a;
    const float* out = a.h[n];
    for (int i = tid; i < TM * S; i += BWD_THREADS) {
      const int m = i / S;
      const int k = i - m * S;
      const int r = row0 + m;
      float v = 0.0f;
      if (r < a.batch && k < K) {
        const size_t o = (size_t)r * K + k;
        v = a.dy[o] * act_deriv(out[o], a.acts[n - 1], a.slope);
        a.g[n - 1][o] = v;
      }
      buf_a[i] = a.bf16 ? round_bf16(v) : v;
    }
  }
  __syncthreads();

  for (int l = n - 1; l >= 0; --l) {
    const int N = a.dims[l + 1];  // width of g_l (the product's depth)
    const int K = a.dims[l];      // width of the product's output
    const int Np = round4(N);
    const bool first = (l == 0);
    const bool odd = (n - 1 - l) & 1;
    const float* __restrict__ in = odd ? buf_b : buf_a;
    const int in_stride = odd ? a.stride_b : a.stride_a;
    float* nxt = odd ? buf_a : buf_b;
    const int nxt_stride = odd ? a.stride_a : a.stride_b;
    const float* __restrict__ W = a.w[l];
    const int k_end = first ? K : round4(K);

    for (int k0 = 0; k0 < k_end; k0 += BWD_THREADS * BWD_COLS) {
      int k[BWD_COLS];
      bool ok[BWD_COLS];
      float acc[TM][BWD_COLS];
#pragma unroll
      for (int c = 0; c < BWD_COLS; ++c) {
        k[c] = k0 + c * BWD_THREADS + tid;
        ok[c] = k[c] < K;
#pragma unroll
        for (int m = 0; m < TM; ++m) acc[m][c] = 0.0f;
      }
      for (int j0 = 0; j0 < Np; j0 += 4) {
        float w[BWD_COLS][4];
#pragma unroll
        for (int c = 0; c < BWD_COLS; ++c) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v = (ok[c] && j0 + j < N)
                          ? __ldg(W + (size_t)k[c] * N + j0 + j) : 0.0f;
            w[c][j] = a.bf16 ? round_bf16(v) : v;
          }
        }
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float4 v =
              *reinterpret_cast<const float4*>(in + m * in_stride + j0);
#pragma unroll
          for (int c = 0; c < BWD_COLS; ++c) {
            acc[m][c] = fmaf(v.x, w[c][0], acc[m][c]);
            acc[m][c] = fmaf(v.y, w[c][1], acc[m][c]);
            acc[m][c] = fmaf(v.z, w[c][2], acc[m][c]);
            acc[m][c] = fmaf(v.w, w[c][3], acc[m][c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < BWD_COLS; ++c) {
        if (k[c] >= k_end) continue;
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const int r = row0 + m;
          float v = 0.0f;
          if (ok[c] && r < a.batch) {
            const size_t o = (size_t)r * K + k[c];
            if (first) {
              a.dx[o] = acc[m][c];
            } else {
              v = acc[m][c] * act_deriv(a.h[l][o], a.acts[l - 1], a.slope);
              a.g[l - 1][o] = v;
            }
          }
          if (!first) nxt[m * nxt_stride + k[c]] = a.bf16 ? round_bf16(v) : v;
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(BWD_THREADS)
mlp_bwd_dw(const BwdArgs a) {
  __shared__ float hs[DW_ROWS][DW_TILE];
  __shared__ float gs[DW_ROWS][DW_TILE];
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  int l = 0;
  while (blockIdx.x >= a.tile_start[l + 1]) ++l;
  const int K = a.dims[l];
  const int N = a.dims[l + 1];
  const int tiles_n = (N + DW_TILE - 1) / DW_TILE;
  const int t = blockIdx.x - a.tile_start[l];
  const int k0 = (t / tiles_n) * DW_TILE;
  const int n0 = (t % tiles_n) * DW_TILE;
  const float* __restrict__ H = a.h[l];
  const float* __restrict__ G = a.g[l];

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int r0 = 0; r0 < a.batch; r0 += DW_ROWS) {
    for (int i = tid; i < DW_ROWS * DW_TILE; i += BWD_THREADS) {
      const int rr = i / DW_TILE;
      const int cc = i - rr * DW_TILE;
      const int r = r0 + rr;
      float hv = 0.0f, gv = 0.0f;
      if (r < a.batch) {
        if (k0 + cc < K) hv = H[(size_t)r * K + k0 + cc];
        if (n0 + cc < N) gv = G[(size_t)r * N + n0 + cc];
      }
      hs[rr][cc] = a.bf16 ? round_bf16(hv) : hv;
      gs[rr][cc] = a.bf16 ? round_bf16(gv) : gv;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < DW_ROWS; ++rr) {
      float hv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = hs[rr][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = gs[rr][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(hv[i], gv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx + 16 * j;
      if (nn < N) a.dw[l][(size_t)k * N + nn] = acc[i][j];
    }
  }
  if (k0 == 0 && tid < DW_TILE && n0 + tid < N) {  // db_l: float32 g
    float s = 0.0f;
    for (int r = 0; r < a.batch; ++r) s += G[(size_t)r * N + n0 + tid];
    a.db[l][n0 + tid] = s;
  }
}

template <int TM>
static cudaError_t launch_rows(const BwdArgs& a, size_t smem,
                               cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mlp_bwd_rows<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = (a.batch + TM - 1) / TM;
  mlp_bwd_rows<TM><<<grid, BWD_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Launches both passes on `stream`; allocates nothing and does not
// synchronise. hiddens: h_1..h_{n-1}; gs: n scratch buffers g_l
// [batch, dims[l+1]]. Returns the CUDA error code (0 = queued).
extern "C" int gm_mlp_bwd(const float* x, int batch, int n_layers,
                          const int* dims, void* const* ws,
                          void* const* hiddens, const float* out,
                          const float* dy, void* const* gs, void* const* dws,
                          void* const* dbs, float* dx, const int* acts,
                          float slope, int bf16, int tile_rows, void* stream) {
  if (n_layers < 1 || n_layers > BWD_MAX_LAYERS || batch < 1 ||
      (tile_rows != 16 && tile_rows != 32))
    return (int)cudaErrorInvalidValue;
  BwdArgs a = {};
  a.x = x;
  a.dy = dy;
  a.dx = dx;
  a.n_layers = n_layers;
  a.batch = batch;
  a.slope = slope;
  a.bf16 = bf16 ? 1 : 0;
  a.h[0] = x;
  a.h[n_layers] = out;
  a.dims[0] = dims[0];
  int tiles = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (dims[l] < 1 || dims[l + 1] < 1 || acts[l] < ACT_NONE ||
        acts[l] > ACT_TANH)
      return (int)cudaErrorInvalidValue;
    a.dims[l + 1] = dims[l + 1];
    a.acts[l] = acts[l];
    a.w[l] = static_cast<const float*>(ws[l]);
    a.g[l] = static_cast<float*>(gs[l]);
    a.dw[l] = static_cast<float*>(dws[l]);
    a.db[l] = static_cast<float*>(dbs[l]);
    if (l > 0) a.h[l] = static_cast<const float*>(hiddens[l - 1]);
    const int s = round4(dims[l + 1]);
    if ((n_layers - 1 - l) & 1) a.stride_b = s > a.stride_b ? s : a.stride_b;
    else a.stride_a = s > a.stride_a ? s : a.stride_a;
    a.tile_start[l] = tiles;
    tiles += ((dims[l] + DW_TILE - 1) / DW_TILE) *
             ((dims[l + 1] + DW_TILE - 1) / DW_TILE);
  }
  a.tile_start[n_layers] = tiles;
  // two alternating g tiles (ops/cuda_mlp.py::bwd_smem_bytes)
  const size_t smem =
      (size_t)tile_rows * (a.stride_a + a.stride_b) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = tile_rows == 32 ? launch_rows<32>(a, smem, s)
                      : launch_rows<16>(a, smem, s);
  if (e != cudaSuccess) return (int)e;
  mlp_bwd_dw<<<tiles, BWD_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
