// Whole-chunk VAE and BIR-VAE training in one launch, for Hopper (sm_90a).
//
// Replaces: generative_models_tpu/ops/pallas_train.py::_make_vae_kernel
// with ::_fused_vae_chunk_call, and ::_make_birvae_kernel with
// ::_fused_birvae_chunk_call (the TPU chunk kernels of the single-model
// family), Adam, the EMA plane of every tensor (pallas_train.py:1522-1524,
// 1903-1905), float32 or, built with -DGM_BF16=1 (a library of its own),
// bf16 operands in every product (:1497-1511, 1878-1892; see
// chunk_common.cuh). One source, the BIR-VAE a compile-time variant of
// the same kernel (template <bool EMA, bool BIR>; EMA the kernels that
// step the EMA plane).
//
// What it computes, for k = 0..steps-1 (one step each, t = t0 + k + 1),
// on the step's batch x [B, X] and streamed noise e [B, L]:
//   henc = relu(x Wtr + btr), mu = henc Wmu + bmu
//   VAE:     lv = henc Wlv + blv, z = mu + exp(lv / 2) e,
//            kl = -1/2 sum(1 + lv - mu^2 - exp(lv)) / B
//   BIR-VAE: per latent dim over the batch, mean = E[mu], var =
//            max(E[mu^2] - mean^2, 0), r = rsqrt(var + 1e-5),
//            muh = (mu - mean) r, z = muh + sigma_n e,
//            latent_power = sum(muh^2) / (B L)
//   hd = relu(z W1 + b1), lg = hd W2 + b2
//   bce: recon = sum(softplus(lg) - lg x) / B, glg = (sig(lg) - x) / B
//   mse: out = sig(lg), recon = sum((out - x)^2) / B,
//        glg = 2 (out - x) out (1 - out) / B
//   dW2 = hd^T glg, db2 = sum glg, dhd = glg W2^T * (hd > 0)
//   dW1 = z^T dhd, db1 = sum dhd, dz = dhd W1^T
//   VAE:     g_mu = dz + mu / B,
//            g_lv = dz (z - mu) / 2 + (exp(lv) - 1) / (2 B)
//   BIR-VAE: g_mu = r (dz - mean_B(dz) - muh mean_B(dz muh))
//   dWmu = henc^T g_mu, dbmu = sum g_mu (and dWlv, dblv from g_lv)
//   dhe = (g_mu Wmu^T [+ g_lv Wlv^T]) * (henc > 0)
//   dWtr = x^T dhe, dbtr = sum dhe;  Adam on every tensor; the EMA
//   kernels then ema <- d ema + (1 - d) p on each element right after
//   its update
//   one metrics row: VAE [recon + kl, recon, kl];
//                    BIR-VAE [recon, recon, latent_power]
// Adam is the TPU kernel's `update` (pallas_train.py:1513-1521), with the
// bias corrections 1 - exp(t * log b) as its _pow (:128-130).
//
// Design, as gan_chunk.cu's: the state (652,824 parameters x 3 planes =
// 7.8 MB at the flagship widths 784-400-20) is far over a block's 227 KB
// and well inside the 50 MB L2, so it is updated in place in device
// memory and stays L2-resident for the chunk. One cooperative launch
// runs the whole chunk; each phase is a grid-stride loop over output
// tiles, rows or columns, and a grid barrier separates the phases (11 a
// step for the VAE, 10 for the BIR-VAE):
//   1  henc
//   2  mu (and lv)
//   3  VAE: one warp per row: z, the row's KL terms.  BIR-VAE: one warp
//      per latent dim: the batch moments, muh, z, the dim's power
//   4  hd
//   5  lg -> glg and the per-pixel loss, in the product's epilogue
//   6  dhd; one warp per row: the row's loss sum
//   7  dW2, db2 with Adam; dz; the metrics row
//   8  dW1, db1 with Adam; g_mu (and g_lv): elementwise for the VAE, one
//      warp per latent dim (the two batch means) for the BIR-VAE
//   9  dhe = (g_mu Wmu^T) * (henc > 0)
//   9b VAE only: dhe += (g_lv Wlv^T) * (henc > 0); dWmu, dbmu with Adam
//   10 dWlv, dblv (BIR-VAE: dWmu, dbmu) and dWtr, dbtr with Adam
// The products run on chunk_common.cuh's engine; a phase's bias sums
// (bias_adam: a block per 64 columns) and its row or metrics work take
// blocks of their own beside the tiles.
// The TPU kernel computes every gradient before its first update. Here
// an Adam epilogue writes its weight in place, so no phase updates a
// weight that a product of the same phase reads: W2 is read in 5 and 6
// and written in 7, W1 read in 4 and 7 and written in 8, Wmu read in 2
// and 9 and written in 9b (10), Wlv read in 2 and 9b and written in 10,
// Wtr read in 1 and written in 10. Every output element has one owner
// and every sum a fixed order, so a run is deterministic. Widths are
// the true ones, so the TPU kernel's row, column and bias-row masks
// have no counterpart.
//
// Bound on the H100 (SXM, 700 W data-sheet peaks), per step at B 100,
// widths 784-400-20: forward 2 B W = 130.2 MFLOP (W = 651,200 weights),
// the dW products 130.2, the dx products of every layer but the trunk
// 67.5: 328.0 MFLOP = 4.90 us at the 67 TFLOP/s float32 FMA peak,
// against 321.6 KB of streams (x 313.6, e 8.0) = 0.10 us from HBM: the
// kernel is bound by operations. The BIR-VAE has no lv head: 323.2
// MFLOP. What holds it back on the card is latency, as in gan_chunk.cu:
// 156.5 us a step on the parent design (tools/chunk_phases.py; phase 2,
// 14 tiles of 16x32 at K 400, took 13.8 us of serial L2 round trips) and
// 10-11 grid barriers a step; the engine keeps loads in flight (see
// chunk_common.cuh), one block an SM. The bf16 build's bound is the same work at the 989
// TFLOP/s dense bf16 tensor-core peak (0.33 us a step), on mma.sync. The EMA plane adds a read and a write of every parameter a
// step (5.2 MB, 1.56 us at 3.35 TB/s; the state stays L2-resident).


#include "chunk_common.cuh"

namespace cg = cooperative_groups;

enum { P_TR_W = 0, P_TR_B, P_MU_W, P_MU_B, P_LV_W, P_LV_B, P_D1_W, P_D1_B,
       P_D2_W, P_D2_B, N_PARAMS };
enum { EPI_RELU, EPI_BIAS, EPI_STORE, EPI_LOSS, EPI_RELUD, EPI_RELUD_ACC,
       EPI_ADAM };

struct VaeArgs {
  const float* xs;  // [steps*B, X]
  const float* es;  // [steps*B, L]
  float* p[N_PARAMS];   // the BIR-VAE leaves the lv slots null
  float* mu[N_PARAMS];
  float* nu[N_PARAMS];
  float* ema[N_PARAMS];  // the EMA kernels' plane (lv slots null: BIR-VAE)
  float ema_d, ema_omd;  // d and 1 - d
  float* metrics;   // [steps, 3]
  // scratch
  float *henc, *m, *lv, *z, *muh, *hd, *glg, *ppx, *dhd, *dz, *gmu, *glv,
      *dhe, *rrow, *krow, *colr, *colp;
  int steps, B, X, H, L;
  int t0;
  float lr, b1, b2, omb1, omb2, eps, log_b1, log_b2, inv_b, sigma_n;
  int mse;
};

// The arguments typed by whether the kernel steps the EMA plane, so that
// the product tiles' epilogue is chosen at compile time (chunk_common.cuh's
// epilogue<A>).
template <bool E>
struct VArgs : VaeArgs {
  static constexpr bool EMA = E;
};

// Adam on element i of tensor q, and with EMA its EMA step from the new
// parameter.
template <bool EMA>
__device__ __forceinline__ void vae_adam(const VaeArgs& a, int q, size_t i,
                                         float g, const AdamT& at) {
  const float p = adam(a, q, i, g, at);
  if constexpr (EMA)
    a.ema[q][i] = ema_step(a.ema_d, ld(a.ema[q] + i), a.ema_omd, p);
}

// Element (m, n) of a product that does not step Adam, with its bias-row
// value bv and aux value xv loaded (0 where the job has none).
__device__ __forceinline__ void vae_epi(const VaeArgs& a, const Gemm& g,
                                        int m, int n, float c, float bv,
                                        float xv) {
  const size_t o = (size_t)m * g.ldo + n;
  switch (g.epi) {
    case EPI_RELU: g.out[o] = fmaxf(c + bv, 0.0f); break;
    case EPI_BIAS: g.out[o] = c + bv; break;
    case EPI_STORE: g.out[o] = c; break;
    case EPI_LOSS: {  // out = glg, then the pixels' losses ppx; aux = x
      const float l = c + bv;
      const float x = xv;
      float* const ppx = g.out + (size_t)g.M * g.ldo;  // scratch: glg, ppx
      if (a.mse) {
        const float s = sigm(l), d = s - x;
        g.out[o] = ((2.0f * d) * s) * (1.0f - s) * a.inv_b;
        ppx[o] = d * d;
      } else {
        g.out[o] = (sigm(l) - x) * a.inv_b;
        ppx[o] = softplus(l) - l * x;
      }
      break;
    }
    case EPI_RELUD: g.out[o] = c * (xv > 0.0f ? 1.0f : 0.0f); break;
    default:  // EPI_RELUD_ACC
      g.out[o] = ld(g.out + o) + c * (xv > 0.0f ? 1.0f : 0.0f);
      break;
  }
}

// A batch of Adam's elements (vae_adam<> for each, every load of the
// batch before its first store); the other epilogues element by element.
template <int EB, class A>
__device__ __forceinline__ void epilogue(const A& a, const Gemm& g,
                                         const int (&m)[EB],
                                         const int (&n)[EB],
                                         const float (&c)[EB],
                                         const bool (&ok)[EB],
                                         const AdamT& at) {
  if (g.epi != EPI_ADAM) {  // the bias and aux values first, then each
    float bv[EB], xv[EB];
#pragma unroll
    for (int k = 0; k < EB; ++k) {
      bv[k] = ok[k] && g.bias ? ld(g.bias + n[k]) : 0.0f;
      xv[k] = ok[k] && g.aux ? ld(g.aux + (size_t)m[k] * g.ldo + n[k]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < EB; ++k)
      if (ok[k]) vae_epi(a, g, m[k], n[k], c[k], bv[k], xv[k]);
    return;
  }
  const int q = g.param;
  float* const pp = a.p[q];
  float* const mu = a.mu[q];
  float* const nu = a.nu[q];
  float* const em = A::EMA ? a.ema[q] : nullptr;
  size_t i[EB];
  float p0[EB], m0[EB], v0[EB], e0[EB];
#pragma unroll
  for (int k = 0; k < EB; ++k) {
    i[k] = (size_t)m[k] * g.N + n[k];
    if (ok[k]) {
      p0[k] = ld(pp + i[k]);
      m0[k] = ld(mu + i[k]);
      v0[k] = ld(nu + i[k]);
      e0[k] = em ? ld(em + i[k]) : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < EB; ++k)
    if (ok[k]) {
      float mk, vk;
      const float p = adam_step(a, at, c[k], m0[k], v0[k], p0[k], mk, vk);
      mu[i[k]] = mk;
      nu[i[k]] = vk;
      pp[i[k]] = p;
      if (em) em[i[k]] = ema_step(a.ema_d, e0[k], a.ema_omd, p);
    }
}

// Column sums over the B rows of src [B, ld] with Adam on bias tensor q,
// by blocks b0 .. b0 + col_blocks(n) - 1 (col_sums: a lane a column, the
// warps over the rows, summed in warp order).
template <bool EMA>
__device__ __forceinline__ void bias_adam(const VaeArgs& a, const float* src,
                                          int ld_, int n, int q,
                                          const AdamT& at, int b0,
                                          float* smem) {
  col_sums<1>(
      n, a.B, b0, smem,
      [&](int r, int v, float(&s)[1]) { s[0] += ld(src + (size_t)r * ld_ + v); },
      [&](int v, float(&s)[1]) { vae_adam<EMA>(a, q, v, s[0], at); });
}

template <bool EMA, bool BIR>
__global__ void __launch_bounds__(CT, MIN_BLOCKS)
    vae_chunk_kernel(const __grid_constant__ VArgs<EMA> a) {
  extern __shared__ __align__(16) float smem[];  // SMEM_BYTES
  // the arguments in shared memory for the tile walker (which reads them
  // at every element of an epilogue)
  __shared__ VArgs<EMA> sa;
  copy_args(sa, a);
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * CT + threadIdx.x;
  const int gsz = gridDim.x * CT;
  const int lane = threadIdx.x & 31;
  const int gwarp = gtid >> 5;
  const int nwarps = gsz >> 5;
  const int B = a.B, X = a.X, H = a.H, L = a.L;
  const AdamT none = {0.0f, 1.0f, 1.0f};

  for (int k = 0; k < a.steps; ++k) {
    const float* x = a.xs + (size_t)k * B * X;
    const float* e = a.es + (size_t)k * B * L;
    const AdamT at = adam_t(a, a.lr, (float)(a.t0 + k + 1));

    {  // 1: henc
      Gemm job = {{x, X, 1}, {a.p[P_TR_W], H, 1}, B, H, X, EPI_RELU,
                  a.p[P_TR_B], nullptr, a.henc, H, 0};
      run_gemms(sa, &job, 1, none, smem);
    }
    grid.sync();
    {  // 2: mu (and lv)
      Gemm jobs[2] = {
          {{a.henc, H, 1}, {a.p[P_MU_W], L, 1}, B, L, H, EPI_BIAS,
           a.p[P_MU_B], nullptr, a.m, L, 0},
          {{a.henc, H, 1}, {a.p[P_LV_W], L, 1}, B, L, H, EPI_BIAS,
           a.p[P_LV_B], nullptr, a.lv, L, 0}};
      run_gemms(sa, jobs, BIR ? 1 : 2, none, smem);
    }
    grid.sync();
    if (BIR) {
      // 3: one warp per latent dim: moments over the batch, muh, z
      for (int c = gwarp; c < L; c += nwarps) {
        float s1 = 0.0f, s2 = 0.0f;
        for (int r = lane; r < B; r += 32) {
          const float v = ld(a.m + (size_t)r * L + c);
          s1 += v;
          s2 = fmaf(v, v, s2);
        }
        const float mean = warp_sum(s1) * a.inv_b;
        const float var = fmaxf(warp_sum(s2) * a.inv_b - mean * mean, 0.0f);
        const float rr = rsqrtf(var + 1e-5f);
        float pw = 0.0f;
        for (int r = lane; r < B; r += 32) {
          const size_t o = (size_t)r * L + c;
          const float h = (ld(a.m + o) - mean) * rr;
          a.muh[o] = h;
          a.z[o] = h + a.sigma_n * ld(e + o);
          pw = fmaf(h, h, pw);
        }
        pw = warp_sum(pw);
        if (lane == 0) {
          a.colr[c] = rr;
          a.colp[c] = pw;
        }
      }
    } else {
      // 3: one warp per row: z and the row's KL terms
      for (int r = gwarp; r < B; r += nwarps) {
        float s = 0.0f;
        for (int c = lane; c < L; c += 32) {
          const size_t o = (size_t)r * L + c;
          const float m = ld(a.m + o), l = ld(a.lv + o);
          a.z[o] = m + expf(0.5f * l) * ld(e + o);
          s += 1.0f + l - m * m - expf(l);
        }
        s = warp_sum(s);
        if (lane == 0) a.krow[r] = s;
      }
    }
    grid.sync();
    {  // 4: hd
      Gemm job = {{a.z, L, 1}, {a.p[P_D1_W], H, 1}, B, H, L, EPI_RELU,
                  a.p[P_D1_B], nullptr, a.hd, H, 0};
      run_gemms(sa, &job, 1, none, smem);
    }
    grid.sync();
    {  // 5: lg -> glg, the pixels' losses
      Gemm job = {{a.hd, H, 1}, {a.p[P_D2_W], X, 1}, B, X, H, EPI_LOSS,
                  a.p[P_D2_B], x, a.glg, X, 0};
      run_gemms(sa, &job, 1, none, smem);
    }
    grid.sync();
    {  // 6: dhd = glg W2^T * (hd > 0); the rows' loss sums
      Gemm job = {{a.glg, X, 1}, {a.p[P_D2_W], 1, X}, B, H, X, EPI_RELUD,
                  nullptr, a.hd, a.dhd, H, 0};
      run_gemms(sa, &job, 1, none, smem);
      // from the far end of the grid: the tiles take the first blocks
      for (int r = nwarps - 1 - gwarp; r < B; r += nwarps) {
        float s = 0.0f;
        for (int c = lane; c < X; c += 32) s += ld(a.ppx + (size_t)r * X + c);
        s = warp_sum(s);
        if (lane == 0) a.rrow[r] = s;
      }
    }
    grid.sync();
    {  // 7: dW2, db2 with Adam; dz = dhd W1^T; the metrics row (db2 on
       // blocks of their own, the metrics on the block after them, the
       // tiles beside)
      const int ncb = col_blocks(X);
      bias_adam<EMA>(a, a.glg, X, X, P_D2_B, at, 0, smem);
      if ((int)blockIdx.x == ncb && threadIdx.x < 32) {
        float sr = 0.0f, s2 = 0.0f;
        for (int r = lane; r < B; r += 32) sr += ld(a.rrow + r);
        if (BIR) {
          for (int c = lane; c < L; c += 32) s2 += ld(a.colp + c);
        } else {
          for (int r = lane; r < B; r += 32) s2 += ld(a.krow + r);
        }
        sr = warp_sum(sr) * a.inv_b;
        s2 = warp_sum(s2);
        if (lane == 0) {
          float* row = a.metrics + (size_t)k * 3;
          if (BIR) {
            row[0] = sr;
            row[1] = sr;
            row[2] = s2 * a.inv_b / (float)L;
          } else {
            const float kl = -0.5f * s2 * a.inv_b;
            row[0] = sr + kl;
            row[1] = sr;
            row[2] = kl;
          }
        }
      }
      Gemm jobs[2] = {
          {{a.hd, 1, H}, {a.glg, X, 1}, H, X, B, EPI_ADAM, nullptr, nullptr,
           nullptr, X, P_D2_W},
          {{a.dhd, H, 1}, {a.p[P_D1_W], 1, H}, B, L, H, EPI_STORE, nullptr,
           nullptr, a.dz, L, 0}};
      run_gemms(sa, jobs, 2, at, smem, ncb + 1);
    }
    grid.sync();
    {  // 8: dW1, db1 with Adam; g_mu (and g_lv)
      bias_adam<EMA>(a, a.dhd, H, H, P_D1_B, at, 0, smem);
      Gemm job = {{a.z, 1, L}, {a.dhd, H, 1}, L, H, B, EPI_ADAM, nullptr,
                  nullptr, nullptr, H, P_D1_W};
      run_gemms(sa, &job, 1, at, smem, col_blocks(H));
      if (BIR) {
        // one warp per latent dim, from the far end of the grid: the two
        // batch means of the normalisation's backward
        for (int c = nwarps - 1 - gwarp; c < L; c += nwarps) {
          float s1 = 0.0f, s2 = 0.0f;
          for (int r = lane; r < B; r += 32) {
            const size_t o = (size_t)r * L + c;
            const float d = ld(a.dz + o);
            s1 += d;
            s2 = fmaf(d, ld(a.muh + o), s2);
          }
          const float mg = warp_sum(s1) * a.inv_b;
          const float mgy = warp_sum(s2) * a.inv_b;
          const float rr = ld(a.colr + c);
          for (int r = lane; r < B; r += 32) {
            const size_t o = (size_t)r * L + c;
            a.gmu[o] = rr * (ld(a.dz + o) - mg - ld(a.muh + o) * mgy);
          }
        }
      } else {
        for (int o = gsz - 1 - gtid; o < B * L; o += gsz) {
          const float d = ld(a.dz + o), m = ld(a.m + o), l = ld(a.lv + o);
          a.gmu[o] = d + m * a.inv_b;
          a.glv[o] = (d * 0.5f) * (ld(a.z + o) - m)
                     + (0.5f * (expf(l) - 1.0f)) * a.inv_b;
        }
      }
    }
    grid.sync();
    {  // 9: dhe = (g_mu Wmu^T) * (henc > 0)
      Gemm job = {{a.gmu, L, 1}, {a.p[P_MU_W], 1, L}, B, H, L, EPI_RELUD,
                  nullptr, a.henc, a.dhe, H, 0};
      run_gemms(sa, &job, 1, none, smem);
    }
    grid.sync();
    if (!BIR) {
      // 9b: dhe += (g_lv Wlv^T) * (henc > 0); dWmu, dbmu with Adam
      Gemm jobs[2] = {
          {{a.glv, L, 1}, {a.p[P_LV_W], 1, L}, B, H, L, EPI_RELUD_ACC,
           nullptr, a.henc, a.dhe, H, 0},
          {{a.henc, 1, H}, {a.gmu, L, 1}, H, L, B, EPI_ADAM, nullptr, nullptr,
           nullptr, L, P_MU_W}};
      bias_adam<EMA>(a, a.gmu, L, L, P_MU_B, at, 0, smem);
      run_gemms(sa, jobs, 2, at, smem, col_blocks(L));
      grid.sync();
    }
    {  // 10: the last head's and the trunk's dW, db with Adam
      const float* gh = BIR ? a.gmu : a.glv;
      Gemm jobs[2] = {
          {{x, 1, X}, {a.dhe, H, 1}, X, H, B, EPI_ADAM, nullptr, nullptr,
           nullptr, H, P_TR_W},
          {{a.henc, 1, H}, {gh, L, 1}, H, L, B, EPI_ADAM, nullptr, nullptr,
           nullptr, L, BIR ? P_MU_W : P_LV_W}};
      bias_adam<EMA>(a, a.dhe, H, H, P_TR_B, at, 0, smem);
      bias_adam<EMA>(a, gh, L, L, BIR ? P_MU_B : P_LV_B, at, col_blocks(H),
                     smem);
      run_gemms(sa, jobs, 2, at, smem, col_blocks(H) + col_blocks(L));
    }
    grid.sync();
  }
}

// Floats of scratch a launch needs at these widths (the wrapper
// allocates it).
extern "C" long long gm_vae_chunk_scratch_floats(int B, int X, int H, int L) {
  const long long b = B;  // the layout gm_vae_chunk cuts it into
  return b * (4 * H + 2 * X + 7 * L + 2) + 2 * L;
}

static const void* kernel_of(int birvae, int ema) {
  if (ema)
    return birvae ? (const void*)vae_chunk_kernel<true, true>
                  : (const void*)vae_chunk_kernel<true, false>;
  return birvae ? (const void*)vae_chunk_kernel<false, true>
                : (const void*)vae_chunk_kernel<false, false>;
}

// Whether this library's products take bf16 operands (GM_BF16).
extern "C" int gm_vae_chunk_bf16() { return GM_BF16; }

// The grid a launch of the VAE or BIR-VAE kernel, with or without the
// EMA plane, uses: every SM's co-resident blocks, at most blocks_per_sm
// each. Returns 0 when the query fails.
extern "C" int gm_vae_chunk_grid(int blocks_per_sm, int birvae, int ema) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  int occ = chunk_occupancy(kernel_of(birvae, ema));
  if (occ > blocks_per_sm) occ = blocks_per_sm;
  return occ * sms;
}

// The blocks an SM holds of that kernel (the occupancy query, at
// gm_vae_chunk_smem_bytes of dynamic shared memory a block; 0 on
// failure), and those bytes.
extern "C" int gm_vae_chunk_blocks_per_sm(int birvae, int ema) {
  return chunk_occupancy(kernel_of(birvae, ema));
}
extern "C" int gm_vae_chunk_smem_bytes() { return SMEM_BYTES; }

// Launches one cooperative kernel on `stream` that runs `steps` steps and
// updates the state tensors' planes (p, mu, nu, and with ema the EMA
// plane: `state` holds 40 pointers, planes in that order, tensors tr_w
// tr_b mu_w mu_b lv_w lv_b d1_w d1_b d2_w d2_b; the BIR-VAE's lv pointers
// are null, and without ema the EMA plane's) in place.
// Allocates nothing, does not synchronise; returns the CUDA error code
// of the launch (0 = queued).
extern "C" int gm_vae_chunk(const float* xs, const float* es,
                            void* const* state, float* scratch,
                            float* metrics, int steps, int B, int X, int H,
                            int L, int t0, float lr, float b1, float b2,
                            float omb1, float omb2, float eps, float log_b1,
                            float log_b2, float inv_b, float sigma_n,
                            int mse, int birvae, int ema, float ema_d,
                            float ema_omd, int grid, void* stream) {
  if (steps < 1 || B < 1 || X < 1 || H < 1 || L < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  VaeArgs a = {};
  a.xs = xs;
  a.es = es;
  for (int q = 0; q < N_PARAMS; ++q) {
    a.p[q] = static_cast<float*>(state[q]);
    a.mu[q] = static_cast<float*>(state[N_PARAMS + q]);
    a.nu[q] = static_cast<float*>(state[2 * N_PARAMS + q]);
    a.ema[q] = static_cast<float*>(state[3 * N_PARAMS + q]);
    const bool lv = q == P_LV_W || q == P_LV_B;
    if (ema && !a.ema[q] && !(birvae && lv)) return (int)cudaErrorInvalidValue;
  }
  a.ema_d = ema_d;
  a.ema_omd = ema_omd;
  a.metrics = metrics;
  const size_t b = B;
  float* s = scratch;
  a.henc = s; s += b * H;
  a.hd = s; s += b * H;
  a.dhd = s; s += b * H;
  a.dhe = s; s += b * H;
  a.glg = s; s += b * X;
  a.ppx = s; s += b * X;  // right behind glg: the loss epilogue counts on it
  a.m = s; s += b * L;
  a.lv = s; s += b * L;
  a.z = s; s += b * L;
  a.muh = s; s += b * L;
  a.dz = s; s += b * L;
  a.gmu = s; s += b * L;
  a.glv = s; s += b * L;
  a.rrow = s; s += b;
  a.krow = s; s += b;
  a.colr = s; s += L;
  a.colp = s;
  a.steps = steps;
  a.B = B;
  a.X = X;
  a.H = H;
  a.L = L;
  a.t0 = t0;
  a.lr = lr;
  a.b1 = b1;
  a.b2 = b2;
  a.omb1 = omb1;
  a.omb2 = omb2;
  a.eps = eps;
  a.log_b1 = log_b1;
  a.log_b2 = log_b2;
  a.inv_b = inv_b;
  a.sigma_n = sigma_n;
  a.mse = mse;
  void* args[] = {&a};
  return chunk_launch(kernel_of(birvae, ema), args, grid, stream);
}
