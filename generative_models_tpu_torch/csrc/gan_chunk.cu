// Whole-chunk NS-GAN / MM-GAN training in one launch, for Hopper (sm_90a).
//
// Replaces: generative_models_tpu/ops/pallas_train.py::_make_kernel with
// ::_fused_chunk_call (the TPU chunk kernel), for the BCE critic hooks of
// nsgan and mmgan (_make_variant_hooks, pallas_train.py:407-412, 430-432,
// 479-481), Adam, float32, no EMA plane.
//
// What it computes, for k = 0..steps-1 (one outer step each):
//   for i = 0..ds-1 (a critic update on a fresh batch; td = t_d+k*ds+i+1):
//     hgd = relu(zd W1g + b1g), fake = sigmoid(hgd W2g + b2g)
//     hr = leaky(x W1d + b1d), lr = hr w2d + b2d; hf, lf likewise on fake
//     glr = (sig(lr) - 1)/B, glf = sig(lf)/B
//     dW2d = hr^T glr + hf^T glf, db2d = sum(glr + glf)
//     dhr = glr w2d^T * leaky'(hr), dhf likewise
//     dW1d = x^T dhr + fake^T dhf, db1d = sum(dhr + dhf);  Adam on D
//   one G update against the post-update critic (tg = t_g + k + 1):
//     hg, fake2 from zg; hf2, lf2 through D
//     gl = (sig(lf2) - 1)/B (nsgan) or -sig(lf2)/B (mmgan)
//     dh2 = gl w2d^T * leaky'(hf2), dx = dh2 W1d^T,
//     gu2 = dx * fake2 * (1 - fake2), dW2g = hg^T gu2, db2g = sum gu2,
//     dhg = gu2 W2g^T * (hg > 0), dW1g = zg^T dhg, db1g = sum dhg; Adam G
//   one metrics row [d_loss, d_real, d_fake, g_loss] (last critic update)
// Adam is the TPU kernel's `update` (pallas_train.py:602-619), with the
// bias corrections 1 - exp(t * log b) as its _pow (:128-130).
//
// Design. The TPU kernel keeps all state in VMEM for the chunk. Here the
// state (680,385 parameters x 3 planes = 8.16 MB at the flagship widths)
// is far over a block's 227 KB but well inside the 50 MB L2, so it is
// UPDATED IN PLACE in device memory and stays L2-resident for the chunk.
// One cooperative launch (cudaLaunchCooperativeKernel, the grid no larger
// than the blocks that can be co-resident, or the launch is refused and
// no block waits forever) runs the whole chunk; each phase below is a
// grid-stride loop over output tiles or rows, and a grid barrier
// (cooperative_groups grid sync) separates the phases, 10 per step at
// ds = 1:
//   A  hgd, hr (and at i = 0 hg); copy x beside fake
//   B  fake (and at i = 0 fake2)
//   C  hf
//   DE one warp per row: logit, its gradient, and the row of dh
//   F  dW1d with Adam in the tile's epilogue; dW2d, db1d, db2d with Adam
//      and the critic's metrics, one warp per column
//   G1 hf2;  G23 one warp per row: lf2, gl, dh2;  G4 dx -> gu2, g_loss
//   G5 dhg;  G6 dW2g, dW1g with Adam in the epilogue; db2g, db1g with
//      Adam, one warp per column
// Every output element has one owner and every sum a fixed order (a sum
// over rows: a warp's lanes stride the rows, then a shuffle tree), so a
// run is deterministic. State and scratch, which other SMs write between
// phases, are read with ordinary (L1-cached) loads: the grid barrier is
// an acquire — its spin ends in CCTL.IVALL, an invalidation of the SM's
// L1, in the SASS nvcc 12.8 emits — so a line written in an earlier
// phase is read afresh. (A dependent L2 load on an H100: 220 ns with
// ld.global.cg, 146 ns without; tools/chunk_phases.py measures both.)
// Widths are the true ones: no lane padding, so the TPU kernel's padded
// lane hazards (pallas_train.py:92-102) do not arise.
//
// Products: the 16x32 split-depth tiles of chunk_common.cuh, which this
// source shares with vae_chunk.cu.
//
// Bound on the H100 (SXM, 700 W data-sheet peaks), per step at B 100,
// ds 1, flagship widths: D update 324.3 MFLOP, G update 334.2 MFLOP,
// 658.6 MFLOP = 9.83 us at the 67 TFLOP/s float32 FMA peak, against
// 416 KB of streams (x 313.6 KB, zd 51.2 KB, zg 51.2 KB) = 0.12 us from
// HBM: the kernel is bound by operations. It gives away the FMA rate
// (no tensor cores; small tiles at B = 100 leave SMs idle in the narrow
// phases) and about 10 grid barriers a step.

#include "chunk_common.cuh"

namespace cg = cooperative_groups;

enum { P_G_W1 = 0, P_G_B1, P_G_W2, P_G_B2, P_D_W1, P_D_B1, P_D_W2, P_D_B2,
       N_PARAMS };
enum { EPI_RELU, EPI_LEAKY, EPI_SIGMOID, EPI_SIGD, EPI_RELUD, EPI_ADAM };

struct Args {
  const float* xs;  // [steps*ds*B, X]
  const float* zd;  // [steps*ds*B, Z]
  const float* zg;  // [steps*B, Z]
  float* p[N_PARAMS];
  float* mu[N_PARAMS];
  float* nu[N_PARAMS];
  float* metrics;   // [steps, 4]
  // scratch
  float *hgd, *hgg, *xin, *fk2, *hd, *gl, *lg, *dh, *hf2, *gl2, *lf2, *dh2,
      *gu2, *dhg;
  int steps, ds, B, Z, H, X, Hd;
  int t_g, t_d;
  float g_lr, d_lr, b1, b2, omb1, omb2, eps, log_b1, log_b2, slope, inv_b;
  int mmgan;
};

__device__ __forceinline__ float leaky(float v, float s) {
  return v >= 0.0f ? v : s * v;
}

__device__ __forceinline__ float dleaky(float h, float s) {
  return h >= 0.0f ? 1.0f : s;
}

template <>
__device__ __forceinline__ void epilogue<Args>(const Args& a, const Gemm& g,
                                               int m, int n, float c,
                                               const AdamT& at) {
  const size_t o = (size_t)m * g.ldo + n;
  switch (g.epi) {
    case EPI_RELU: g.out[o] = fmaxf(c + ld(g.bias + n), 0.0f); break;
    case EPI_LEAKY: g.out[o] = leaky(c + ld(g.bias + n), a.slope); break;
    case EPI_SIGMOID: g.out[o] = sigm(c + ld(g.bias + n)); break;
    case EPI_SIGD: {
      const float f = ld(g.aux + o);
      g.out[o] = (c * f) * (1.0f - f);
      break;
    }
    case EPI_RELUD: g.out[o] = c * (ld(g.aux + o) > 0.0f ? 1.0f : 0.0f); break;
    default: adam(a, g.param, (size_t)m * g.N + n, c, at); break;
  }
}

// One warp per row r < rows of h [rows, Hd]: the logit h.w2d + b2d, its
// gradient (via `grad`), and the row of dh = gl w2d^T * leaky'(h).
template <class Grad>
__device__ void logit_rows(const Args& a, const float* h, int rows,
                           float* logit, float* glo, float* dh, Grad grad) {
  const float* w2 = a.p[P_D_W2];
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * CT + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * CT) >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    const float* hr = h + (size_t)r * a.Hd;
    float s = 0.0f;
    for (int j = lane; j < a.Hd; j += 32) s = fmaf(ld(hr + j), ld(w2 + j), s);
    const float l = warp_sum(s) + ld(a.p[P_D_B2]);
    const float g = grad(r, l);
    if (lane == 0) {
      logit[r] = l;
      glo[r] = g;
    }
    for (int j = lane; j < a.Hd; j += 32)
      dh[(size_t)r * a.Hd + j] = (g * ld(w2 + j)) * dleaky(ld(hr + j), a.slope);
  }
}

__global__ void __launch_bounds__(CT) gan_chunk_kernel(const Args a) {
  __shared__ __align__(16) float smem[WARPS * WARP_SMEM];
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * CT + threadIdx.x;
  const int gsz = gridDim.x * CT;
  const int lane = threadIdx.x & 31;
  const int gwarp = gtid >> 5;
  const int nwarps = gsz >> 5;
  const int B = a.B, Z = a.Z, H = a.H, X = a.X, Hd = a.Hd;
  const AdamT none = {0.0f, 1.0f, 1.0f};
  float* const fake = a.xin + (size_t)B * X;  // rows B..2B-1 of xin

  for (int k = 0; k < a.steps; ++k) {
    const float* zg = a.zg + (size_t)k * B * Z;
    const AdamT tg = adam_t(a, a.g_lr, (float)(a.t_g + k + 1));

    for (int i = 0; i < a.ds; ++i) {
      const size_t row0 = (size_t)(k * a.ds + i) * B;
      const float* x = a.xs + row0 * X;
      const float* zd = a.zd + row0 * Z;
      const AdamT td = adam_t(a, a.d_lr, (float)(a.t_d + k * a.ds + i + 1));

      {  // A: hgd, hr (and hg); x beside fake
        Gemm jobs[3] = {
            {{zd, Z, 1}, {a.p[P_G_W1], H, 1}, B, H, Z, EPI_RELU,
             a.p[P_G_B1], nullptr, a.hgd, H, 0},
            {{x, X, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, X, EPI_LEAKY,
             a.p[P_D_B1], nullptr, a.hd, Hd, 0},
            {{zg, Z, 1}, {a.p[P_G_W1], H, 1}, B, H, Z, EPI_RELU,
             a.p[P_G_B1], nullptr, a.hgg, H, 0}};
        run_gemms(a, jobs, i == 0 ? 3 : 2, none, smem);
        for (size_t e = gtid; e < (size_t)B * X; e += gsz) a.xin[e] = ld(x + e);
      }
      grid.sync();
      {  // B: fake (and fake2)
        Gemm jobs[2] = {
            {{a.hgd, H, 1}, {a.p[P_G_W2], X, 1}, B, X, H, EPI_SIGMOID,
             a.p[P_G_B2], nullptr, fake, X, 0},
            {{a.hgg, H, 1}, {a.p[P_G_W2], X, 1}, B, X, H, EPI_SIGMOID,
             a.p[P_G_B2], nullptr, a.fk2, X, 0}};
        run_gemms(a, jobs, i == 0 ? 2 : 1, none, smem);
      }
      grid.sync();
      {  // C: hf
        Gemm job = {{fake, X, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, X, EPI_LEAKY,
                    a.p[P_D_B1], nullptr, a.hd + (size_t)B * Hd, Hd, 0};
        run_gemms(a, &job, 1, none, smem);
      }
      grid.sync();
      // DE: logits of [hr; hf], their gradients, dh = [dhr; dhf]
      logit_rows(a, a.hd, 2 * B, a.lg, a.gl, a.dh, [&](int r, float l) {
        return r < B ? (sigm(l) - 1.0f) * a.inv_b : sigm(l) * a.inv_b;
      });
      grid.sync();
      {  // F: dW1d = [x; fake]^T [dhr; dhf] with Adam; the small grads
        Gemm job = {{a.xin, 1, X}, {a.dh, Hd, 1}, X, Hd, 2 * B, EPI_ADAM,
                    nullptr, nullptr, nullptr, Hd, P_D_W1};
        run_gemms(a, &job, 1, td, smem);
        // one warp per column (lanes over the rows, then a fixed-order
        // shuffle sum): dW2d and db1d for column v < Hd, db2d at v = Hd,
        // the critic's metrics from this (the last) update at v = Hd + 1
        for (int v = gwarp; v < Hd + 2; v += nwarps) {
          if (v < Hd) {
            float dw = 0.0f, db = 0.0f;
            for (int r = lane; r < 2 * B; r += 32) {
              dw = fmaf(ld(a.hd + (size_t)r * Hd + v), ld(a.gl + r), dw);
              db += ld(a.dh + (size_t)r * Hd + v);
            }
            dw = warp_sum(dw);
            db = warp_sum(db);
            if (lane == 0) {
              adam(a, P_D_W2, v, dw, td);
              adam(a, P_D_B1, v, db, td);
            }
          } else if (v == Hd) {
            float db = 0.0f;
            for (int r = lane; r < 2 * B; r += 32) db += ld(a.gl + r);
            db = warp_sum(db);
            if (lane == 0) adam(a, P_D_B2, 0, db, td);
          } else {
            float sp = 0.0f, sr = 0.0f, sf = 0.0f;
            for (int r = lane; r < B; r += 32) {
              const float lr = ld(a.lg + r), lf = ld(a.lg + B + r);
              sp += softplus(-lr) + softplus(lf);
              sr += lr;
              sf += lf;
            }
            sp = warp_sum(sp);
            sr = warp_sum(sr);
            sf = warp_sum(sf);
            if (lane == 0) {
              a.metrics[(size_t)k * 4 + 0] = sp * a.inv_b;
              a.metrics[(size_t)k * 4 + 1] = sr * a.inv_b;
              a.metrics[(size_t)k * 4 + 2] = sf * a.inv_b;
            }
          }
        }
      }
      grid.sync();
    }

    {  // G1: hf2 through the post-update critic
      Gemm job = {{a.fk2, X, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, X, EPI_LEAKY,
                  a.p[P_D_B1], nullptr, a.hf2, Hd, 0};
      run_gemms(a, &job, 1, none, smem);
    }
    grid.sync();
    // G23: lf2, gl, dh2
    logit_rows(a, a.hf2, B, a.lf2, a.gl2, a.dh2, [&](int, float l) {
      return a.mmgan ? -sigm(l) * a.inv_b : (sigm(l) - 1.0f) * a.inv_b;
    });
    grid.sync();
    {  // G4: dx = dh2 W1d^T -> gu2 = dx * fake2 * (1 - fake2); g_loss
      Gemm job = {{a.dh2, Hd, 1}, {a.p[P_D_W1], 1, Hd}, B, X, Hd, EPI_SIGD,
                  nullptr, a.fk2, a.gu2, X, 0};
      run_gemms(a, &job, 1, none, smem);
      if (gwarp == 0) {
        float s = 0.0f;
        for (int r = lane; r < B; r += 32) {
          const float l = ld(a.lf2 + r);
          s += a.mmgan ? softplus(l) : softplus(-l);
        }
        s = warp_sum(s);
        if (lane == 0)
          a.metrics[(size_t)k * 4 + 3] = a.mmgan ? -s * a.inv_b : s * a.inv_b;
      }
    }
    grid.sync();
    {  // G5: dhg = gu2 W2g^T * (hg > 0)
      Gemm job = {{a.gu2, X, 1}, {a.p[P_G_W2], 1, X}, B, H, X, EPI_RELUD,
                  nullptr, a.hgg, a.dhg, H, 0};
      run_gemms(a, &job, 1, none, smem);
    }
    grid.sync();
    {  // G6: dW2g = hg^T gu2, dW1g = zg^T dhg with Adam; db2g, db1g
      Gemm jobs[2] = {
          {{a.hgg, 1, H}, {a.gu2, X, 1}, H, X, B, EPI_ADAM, nullptr, nullptr,
           nullptr, X, P_G_W2},
          {{zg, 1, Z}, {a.dhg, H, 1}, Z, H, B, EPI_ADAM, nullptr, nullptr,
           nullptr, H, P_G_W1}};
      run_gemms(a, jobs, 2, tg, smem);
      for (int v = gwarp; v < X + H; v += nwarps) {  // a warp per column
        const float* src = v < X ? a.gu2 + v : a.dhg + (v - X);
        const int stride = v < X ? X : H;
        float db = 0.0f;
        for (int r = lane; r < B; r += 32) db += ld(src + (size_t)r * stride);
        db = warp_sum(db);
        if (lane == 0) {
          if (v < X) adam(a, P_G_B2, v, db, tg);
          else adam(a, P_G_B1, v - X, db, tg);
        }
      }
    }
    grid.sync();
  }
}

// Floats of scratch a launch needs at these widths (the wrapper
// allocates it).
extern "C" long long gm_gan_chunk_scratch_floats(int B, int Z, int H, int X,
                                                 int Hd) {
  (void)Z;
  const long long b = B;  // the layout gm_gan_chunk cuts it into
  return 3 * b * H + 4 * b * X + 6 * b * Hd + 6 * b;
}

// The grid a launch uses: every SM's co-resident blocks, at most
// blocks_per_sm each. Returns 0 when the query fails.
extern "C" int gm_gan_chunk_grid(int blocks_per_sm) {
  int dev = 0, sms = 0, occ = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, gan_chunk_kernel,
                                                    CT, 0) != cudaSuccess)
    return 0;
  if (occ > blocks_per_sm) occ = blocks_per_sm;
  return occ * sms;
}

// Launches one cooperative kernel on `stream` that runs `steps` outer
// steps and updates the 8 state tensors' planes (p, mu, nu: `state` holds
// 24 pointers, planes in that order, tensors g_w1 g_b1 g_w2 g_b2 d_w1
// d_b1 d_w2 d_b2) in place. Allocates nothing, does not synchronise;
// returns the CUDA error code of the launch (0 = queued).
extern "C" int gm_gan_chunk(const float* xs, const float* zd, const float* zg,
                            void* const* state, float* scratch,
                            float* metrics, int steps, int ds, int B, int Z,
                            int H, int X, int Hd, int t_g, int t_d,
                            float g_lr, float d_lr, float b1, float b2,
                            float omb1, float omb2, float eps, float log_b1,
                            float log_b2, float slope, float inv_b,
                            int mmgan, int grid, void* stream) {
  if (steps < 1 || ds < 1 || B < 1 || Z < 1 || H < 1 || X < 1 || Hd < 1 ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.xs = xs;
  a.zd = zd;
  a.zg = zg;
  for (int q = 0; q < N_PARAMS; ++q) {
    a.p[q] = static_cast<float*>(state[q]);
    a.mu[q] = static_cast<float*>(state[N_PARAMS + q]);
    a.nu[q] = static_cast<float*>(state[2 * N_PARAMS + q]);
  }
  a.metrics = metrics;
  const size_t b = B;
  float* s = scratch;
  a.hgd = s; s += b * H;
  a.hgg = s; s += b * H;
  a.xin = s; s += 2 * b * X;
  a.fk2 = s; s += b * X;
  a.hd = s; s += 2 * b * Hd;
  a.gl = s; s += 2 * b;
  a.lg = s; s += 2 * b;
  a.dh = s; s += 2 * b * Hd;
  a.hf2 = s; s += b * Hd;
  a.gl2 = s; s += b;
  a.lf2 = s; s += b;
  a.dh2 = s; s += b * Hd;
  a.gu2 = s; s += b * X;
  a.dhg = s;
  a.steps = steps;
  a.ds = ds;
  a.B = B;
  a.Z = Z;
  a.H = H;
  a.X = X;
  a.Hd = Hd;
  a.t_g = t_g;
  a.t_d = t_d;
  a.g_lr = g_lr;
  a.d_lr = d_lr;
  a.b1 = b1;
  a.b2 = b2;
  a.omb1 = omb1;
  a.omb2 = omb2;
  a.eps = eps;
  a.log_b1 = log_b1;
  a.log_b2 = log_b2;
  a.slope = slope;
  a.inv_b = inv_b;
  a.mmgan = mmgan;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)gan_chunk_kernel, dim3(grid), dim3(CT), args, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
