// Whole-MLP forward in one launch, for Hopper (sm_90a).
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
// Design. Each block owns TM rows of the batch. It stages its x tile in
// shared memory and keeps each hidden tile there, so layer l+1 reads
// layer l's output without a round trip through device memory; the
// hiddens are still written out once, because the caller needs them.
// Two shared buffers alternate between the layers: buffer A holds the
// inputs of the even layers, buffer B those of the odd layers, each at
// a row stride rounded up to 4 floats (zero-filled tail) so that a row
// can be read as float4. The output of the last layer goes straight to
// device memory. Weights are read through L2 (nsgan G holds 1.46 MB of
// float32 weights, which stay resident in the 50 MB L2 across blocks).
// Widths are the true ones: no feature or batch padding is visible to
// the caller; ragged rows of the last tile are computed and not stored.
//
// Work split inside a block: 256 threads; thread t owns the output
// columns n0 + t and n0 + 256 + t of a pass over the layer's width and
// all TM rows of the tile, i.e. a TM x 2 register tile of float32
// accumulators. Per group of 4 k, each thread loads 8 weights (coalesced
// across the warp) and reads TM float4 of the input tile (a broadcast:
// every lane reads the same address), then does 8*TM FMAs.
//
// Bound on the H100 (SXM, 700 W data-sheet peaks): nsgan G at B = 8192
// does 2*8192*(128*400 + 400*784) = 5.98 GFLOP and must move about
// 43 MB (z 4.2 MB in; h 13.1 MB and out 25.7 MB out; 1.46 MB of
// weights). The FMAs run on the float32 pipes (not the tensor cores)
// in both modes, so the bound is operations: 5.98 GFLOP / 67 TFLOP/s
// = 89 us, against 43 MB / 3.35 TB/s = 13 us for the bytes. The design
// answers that bound by keeping the FMA pipes fed: the hidden tile never
// leaves the SM, every shared-memory read feeds 8 FMAs, and every weight
// read from L2 feeds TM rows. What it gives away: columns past the layer
// width in the last pass of 512 (78% of the FMAs are useful for the
// 400- and 784-wide layers), and at small batches the grid is smaller
// than the card. Tensor-core tiles (wgmma, TF32/bf16) and TMA are left
// for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MLP_MAX_LAYERS 8
#define MLP_THREADS 256
#define MLP_COLS 2

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY_RELU = 2, ACT_SIGMOID = 3,
       ACT_TANH = 4 };

struct MlpArgs {
  const float* x;
  const float* w[MLP_MAX_LAYERS];
  const float* b[MLP_MAX_LAYERS];
  float* out[MLP_MAX_LAYERS];  // h_1 .. h_{n-1}, then the output
  int dims[MLP_MAX_LAYERS + 1];
  int acts[MLP_MAX_LAYERS];
  int n_layers;
  int batch;
  int stride_a;  // shared row stride (floats) of the even layers' inputs
  int stride_b;  // ... of the odd layers' inputs (0 when n_layers == 1)
  float slope;
  int bf16;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float apply_act(float v, int act, float slope) {
  switch (act) {
    case ACT_RELU: return fmaxf(v, 0.0f);
    case ACT_LEAKY_RELU: return v >= 0.0f ? v : slope * v;
    case ACT_SIGMOID: return 1.0f / (1.0f + expf(-v));
    case ACT_TANH: return tanhf(v);
    default: return v;
  }
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

template <int TM>
__global__ void __launch_bounds__(MLP_THREADS)
mlp_fwd_kernel(const MlpArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* const buf_a = smem;
  float* const buf_b = smem + TM * a.stride_a;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TM;

  {  // stage the x tile; ragged rows and the k tail are zero
    const int K = a.dims[0];
    const int S = a.stride_a;
    for (int i = tid; i < TM * S; i += MLP_THREADS) {
      const int m = i / S;
      const int k = i - m * S;
      const int r = row0 + m;
      float v = (r < a.batch && k < K) ? a.x[(size_t)r * K + k] : 0.0f;
      buf_a[i] = a.bf16 ? round_bf16(v) : v;
    }
  }
  __syncthreads();

  for (int l = 0; l < a.n_layers; ++l) {
    const int K = a.dims[l];
    const int N = a.dims[l + 1];
    const int Kp = round4(K);
    const bool last = (l == a.n_layers - 1);
    const bool odd = l & 1;
    const float* __restrict__ in = odd ? buf_b : buf_a;
    const int in_stride = odd ? a.stride_b : a.stride_a;
    float* nxt = odd ? buf_a : buf_b;
    const int nxt_stride = odd ? a.stride_a : a.stride_b;
    const float* __restrict__ W = a.w[l];
    const float* __restrict__ bias = a.b[l];
    float* __restrict__ O = a.out[l];
    const int act = a.acts[l];
    // the next layer reads this tile up to its rounded width: the
    // columns in [N, round4(N)) are written as zeros
    const int n_end = last ? N : round4(N);

    for (int n0 = 0; n0 < n_end; n0 += MLP_THREADS * MLP_COLS) {
      int n[MLP_COLS];
      bool ok[MLP_COLS];
      float acc[TM][MLP_COLS];
#pragma unroll
      for (int c = 0; c < MLP_COLS; ++c) {
        n[c] = n0 + c * MLP_THREADS + tid;
        ok[c] = n[c] < N;
#pragma unroll
        for (int m = 0; m < TM; ++m) acc[m][c] = 0.0f;
      }

      for (int k = 0; k < Kp; k += 4) {
        float w[MLP_COLS][4];
#pragma unroll
        for (int c = 0; c < MLP_COLS; ++c) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v = (ok[c] && k + j < K)
                          ? __ldg(W + (size_t)(k + j) * N + n[c]) : 0.0f;
            w[c][j] = a.bf16 ? round_bf16(v) : v;
          }
        }
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float4 v =
              *reinterpret_cast<const float4*>(in + m * in_stride + k);
#pragma unroll
          for (int c = 0; c < MLP_COLS; ++c) {
            acc[m][c] = fmaf(v.x, w[c][0], acc[m][c]);
            acc[m][c] = fmaf(v.y, w[c][1], acc[m][c]);
            acc[m][c] = fmaf(v.z, w[c][2], acc[m][c]);
            acc[m][c] = fmaf(v.w, w[c][3], acc[m][c]);
          }
        }
      }

#pragma unroll
      for (int c = 0; c < MLP_COLS; ++c) {
        if (n[c] >= n_end) continue;
        const float bn = ok[c] ? bias[n[c]] : 0.0f;
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const int r = row0 + m;
          float v = 0.0f;
          if (ok[c]) {
            v = apply_act(acc[m][c] + bn, act, a.slope);
            if (r < a.batch) O[(size_t)r * N + n[c]] = v;
          }
          if (!last) nxt[m * nxt_stride + n[c]] = a.bf16 ? round_bf16(v) : v;
        }
      }
    }
    __syncthreads();
  }
}

template <int TM>
static cudaError_t launch(const MlpArgs& a, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mlp_fwd_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int grid = (a.batch + TM - 1) / TM;
  mlp_fwd_kernel<TM><<<grid, MLP_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Launches the kernel on `stream`; allocates nothing and does not
// synchronise. Returns the CUDA error code of the launch (0 = queued).
extern "C" int gm_mlp_fwd(const float* x, int batch, int n_layers,
                          const int* dims, void* const* ws,
                          void* const* bs, void* const* outs,
                          const int* acts, float slope, int bf16,
                          int tile_rows, void* stream) {
  if (n_layers < 1 || n_layers > MLP_MAX_LAYERS || batch < 1 ||
      (tile_rows != 16 && tile_rows != 32))
    return (int)cudaErrorInvalidValue;
  MlpArgs a = {};
  a.x = x;
  a.n_layers = n_layers;
  a.batch = batch;
  a.slope = slope;
  a.bf16 = bf16 ? 1 : 0;
  a.dims[0] = dims[0];
  for (int l = 0; l < n_layers; ++l) {
    if (dims[l] < 1 || dims[l + 1] < 1 || acts[l] < ACT_NONE ||
        acts[l] > ACT_TANH)
      return (int)cudaErrorInvalidValue;
    a.w[l] = static_cast<const float*>(ws[l]);
    a.b[l] = static_cast<const float*>(bs[l]);
    a.out[l] = static_cast<float*>(outs[l]);
    a.dims[l + 1] = dims[l + 1];
    a.acts[l] = acts[l];
    const int s = round4(dims[l]);
    if (l & 1) a.stride_b = s > a.stride_b ? s : a.stride_b;
    else a.stride_a = s > a.stride_a ? s : a.stride_a;
  }
  // two alternating input tiles (ops/cuda_mlp.py::smem_bytes)
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
  e = tile_rows == 32 ? launch<32>(a, smem, s) : launch<16>(a, smem, s);
  return (int)e;
}
