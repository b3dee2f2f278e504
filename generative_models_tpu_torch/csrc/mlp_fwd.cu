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

#include "mlp_chain.cuh"

template <int TR>
__global__ void __launch_bounds__(CH_THREADS, 1)
mlp_fwd_kernel(const ChainArgs a) {
  chain_body<TR, false>(a);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tr) {
    case 1: return (int)launch_cluster(mlp_fwd_kernel<1>, a, grid, csize, smem, s);
    case 4: return (int)launch_cluster(mlp_fwd_kernel<4>, a, grid, csize, smem, s);
    default: return (int)launch_cluster(mlp_fwd_kernel<8>, a, grid, csize, smem, s);
  }
}
