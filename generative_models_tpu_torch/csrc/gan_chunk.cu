// Whole-chunk GAN training in one launch, for Hopper (sm_90a): nsgan,
// mmgan, lsgan, wgan, fgan, ragan and fishergan.
//
// Replaces: generative_models_tpu/ops/pallas_train.py::_make_kernel with
// ::_fused_chunk_call (the TPU chunk kernel) and the critic hooks of
// ::_make_variant_hooks for these variants (pallas_train.py:314-353,
// 374-391, 407-412, 422-432, 443-467, 479-481), Adam or RMSprop, wgan's
// clip, fishergan's carried multiplier, float32, no EMA plane.
//
// One source, one library a hook: -DGM_HOOK=0..5 picks the critic (bce:
// nsgan and mmgan; ls; w; f: all seven divergences; ra; fi) at compile
// time, and each library holds an Adam and an RMSprop kernel, so no hot
// loop carries a run-time switch of another variant.
//
// What it computes, for k = 0..steps-1 (one outer step each):
//   for i = 0..ds-1 (a critic update on a fresh batch; td = t_d+k*ds+i+1):
//     hgd = relu(zd W1g + b1g), fake = sigmoid(hgd W2g + b2g)
//     hr = leaky(x W1d + b1d), lr = hr w2d + b2d; hf, lf likewise on fake
//     glr, glf = dL_D/dlr, dL_D/dlf by the hook, e.g. bce:
//       glr = (sig(lr) - 1)/B, glf = sig(lf)/B
//     dW2d = hr^T glr + hf^T glf, db2d = sum(glr + glf)
//     dhr = glr w2d^T * leaky'(hr), dhf likewise
//     dW1d = x^T dhr + fake^T dhf, db1d = sum(dhr + dhf);  optimizer on D;
//     wgan: every D tensor clipped to [-clip, clip];
//     fishergan: lam <- lam - rho (1 - Omega)
//   one G update against the post-update critic (tg = t_g + k + 1):
//     hg, fake2 from zg; hf2, lf2 through D (ragan: also lr2, the critic
//     on the last critic batch's x)
//     gl = dL_G/dlf2 by the hook, e.g. (sig(lf2) - 1)/B (nsgan)
//     dh2 = gl w2d^T * leaky'(hf2), dx = dh2 W1d^T,
//     gu2 = dx * fake2 * (1 - fake2), dW2g = hg^T gu2, db2g = sum gu2,
//     dhg = gu2 W2g^T * (hg > 0), dW1g = zg^T dhg, db1g = sum dhg;
//     optimizer on G
//   one metrics row of 8 lanes, those of the TPU kernel: d_loss, the real
//   and fake logit means (fishergan: ipm, Omega), g_loss, -, -,
//   fishergan's constraint 1 - Omega, lam after the step; the critic's
//   lanes are those of the step's last critic update
// The hooks' formulas stand at d_grad, g_grad, d_term and g_term below.
// Adam is the TPU kernel's `update` (pallas_train.py:602-619), with the
// bias corrections 1 - exp(t * log b) as its _pow (:128-130); RMSprop is
// its other branch: nu = 0.99 nu + 0.01 g^2, p -= lr g / (sqrt(nu) +
// 1e-8), two planes, no count.
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
//   F  dW1d with the optimizer in the tile's epilogue; dW2d, db1d, db2d
//      with the optimizer and the critic's metrics, one warp per column
//   G1 hf2;  G23 one warp per row: lf2, gl, dh2;  G4 dx -> gu2, g_loss
//   G5 dhg;  G6 dW2g, dW1g with the optimizer in the epilogue; db2g, db1g
//      one warp per column
// ragan's and fishergan's gradients need batch means of all 2B logits
// (ragan: the means, then means of sigmoids of the centred logits), so
// for them DE is two phases: the logits, a grid barrier, then every warp
// recomputes the few scalars from the 2B logits in one fixed order (all
// warps hold the same bits) and goes on to its rows' gradients. ragan's
// G loss reads real data: G1's product has 2B rows, fake2's and then x's
// (still in rows 0..B-1 of `xin` from the last critic update, which
// follow fake2 in the scratch), and G23 is split the same way. fishergan's lam is a
// device scalar: the gradient phase reads it, and the one warp that
// writes the critic's metrics in phase F, a barrier later, descends it,
// so no warp sees the new value early.
// Every output element has one owner and every sum a fixed order (a sum
// over rows: a warp's lanes stride the rows, then a shuffle tree), so a
// run is deterministic. State and scratch, which other SMs write between
// phases, are read with ordinary (L1-cached) loads: the grid barrier is
// an acquire — its spin ends in CCTL.IVALL, an invalidation of the SM's
// L1, in the SASS nvcc 12.8 emits — so a line written in an earlier
// phase is read afresh. (A dependent L2 load on an H100: 220 ns with
// ld.global.cg, 146 ns without; tools/chunk_phases.py measures both.)
// Widths are the true ones: no lane padding, so the TPU kernel's padded
// lane hazards (pallas_train.py:92-102) and its lane0/rowm/xcols masks
// have no counterpart.
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

#ifndef GM_HOOK
#define GM_HOOK 0
#endif

enum { HOOK_BCE = 0, HOOK_LS, HOOK_W, HOOK_F, HOOK_RA, HOOK_FI };
enum { DIV_TV = 0, DIV_KL, DIV_RKL, DIV_PEARSON, DIV_HELLINGER, DIV_JS,
       DIV_GAN };
constexpr int HOOK = GM_HOOK;
static_assert(HOOK >= HOOK_BCE && HOOK <= HOOK_FI, "GM_HOOK must be 0..5");
// the gradient of a logit needs sums over the whole batch
constexpr bool COUPLED_D = HOOK == HOOK_RA || HOOK == HOOK_FI;
constexpr bool COUPLED_G = HOOK == HOOK_RA;

enum { P_G_W1 = 0, P_G_B1, P_G_W2, P_G_B2, P_D_W1, P_D_B1, P_D_W2, P_D_B2,
       N_PARAMS };
enum { EPI_RELU, EPI_LEAKY, EPI_SIGMOID, EPI_SIGD, EPI_RELUD, EPI_OPT };
enum { LANES = 8 };  // floats of a metrics row

#define RMS_DECAY 0.99f
#define RMS_OMD ((float)(1.0 - 0.99))
#define RMS_EPS 1e-8f

struct Args {
  const float* xs;  // [steps*ds*B, X]
  const float* zd;  // [steps*ds*B, Z]
  const float* zg;  // [steps*B, Z]
  float* p[N_PARAMS];
  float* mu[N_PARAMS];  // null with RMSprop
  float* nu[N_PARAMS];
  float* metrics;   // [steps, LANES]
  float* lam;       // fishergan's multiplier, in and out
  // scratch; hf2 and lf2 hold 2B rows (ragan: the fake rows, then x's)
  float *hgd, *hgg, *xin, *fk2, *hd, *gl, *lg, *dh, *hf2, *gl2, *lf2, *dh2,
      *gu2, *dhg;
  int steps, ds, B, Z, H, X, Hd;
  int t_g, t_d;
  float g_lr, d_lr, b1, b2, omb1, omb2, eps, log_b1, log_b2, slope, inv_b;
  float clip, rho;
  int alt;  // bce: mmgan's saturating G loss; f: the non-saturating one
  int div;  // f: which divergence
};

// The same arguments for the RMSprop kernel: a type of its own, so that
// the product tiles' epilogue is chosen at compile time.
struct ArgsRms : Args {};

__device__ __forceinline__ float leaky(float v, float s) {
  return v >= 0.0f ? v : s * v;
}

__device__ __forceinline__ float dleaky(float h, float s) {
  return h >= 0.0f ? 1.0f : s;
}

// `v`, as a value the compiler must take here and now. A phase's tile
// count is the same in every step, so the compiler computes it once
// before the step loop and keeps it for the whole kernel; with ragan's
// and fishergan's extra phases one such count no longer had a register
// under RMSprop and was spilled. Counting the jobs through this keeps
// that phase's count inside the loop.
__device__ __forceinline__ int fresh(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// One optimizer step on element i of state tensor q with gradient g;
// wgan clips the critic's tensors (q >= P_D_W1) right after it.
template <bool RMS>
__device__ __forceinline__ void update(const Args& a, int q, size_t i,
                                       float g, const AdamT& t) {
  if (RMS) {
    const float v = RMS_DECAY * ld(a.nu[q] + i) + (RMS_OMD * g) * g;
    a.nu[q][i] = v;
    // the rate comes from the arguments, not from `t`: nothing of `t`
    // then stays live through a product tile
    const float lr = q >= P_D_W1 ? a.d_lr : a.g_lr;
    float p = ld(a.p[q] + i) - (lr * g) / (sqrtf(v) + RMS_EPS);
    if (HOOK == HOOK_W && q >= P_D_W1 && a.clip > 0.0f)
      p = fminf(fmaxf(p, -a.clip), a.clip);
    a.p[q][i] = p;
  } else {
    adam(a, q, i, g, t);
    if (HOOK == HOOK_W && q >= P_D_W1 && a.clip > 0.0f)
      a.p[q][i] = fminf(fmaxf(ld(a.p[q] + i), -a.clip), a.clip);
  }
}

template <bool RMS>
__device__ __forceinline__ AdamT step_t(const Args& a, float lr, int t) {
  if (RMS) return AdamT{0.0f, 1.0f, 1.0f};
  return adam_t(a, lr, (float)t);
}

template <bool RMS>
__device__ __forceinline__ void epi(const Args& a, const Gemm& g, int m, int n,
                                    float c, const AdamT& at) {
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
    default: update<RMS>(a, g.param, (size_t)m * g.N + n, c, at); break;
  }
}

template <>
__device__ __forceinline__ void epilogue<Args>(const Args& a, const Gemm& g,
                                               int m, int n, float c,
                                               const AdamT& at) {
  epi<false>(a, g, m, n, c, at);
}

template <>
__device__ __forceinline__ void epilogue<ArgsRms>(const ArgsRms& a,
                                                  const Gemm& g, int m, int n,
                                                  float c, const AdamT& at) {
  epi<true>(a, g, m, n, c, at);
}

// f-GAN: the output activation g_f, its derivative, the conjugate f* and
// its derivative (Nowozin et al. 2016, Tables 2 and 6; the TPU kernel's
// _FGAN_TABLE, pallas_train.py:153-189).
__device__ __forceinline__ float f_g(int div, float v) {
  switch (div) {
    case DIV_TV: return 0.5f * tanhf(v);
    case DIV_KL: case DIV_PEARSON: return v;
    case DIV_RKL: return -expf(-v);
    case DIV_HELLINGER: return 1.0f - expf(-v);
    case DIV_JS: return 0.69314718055994531f - softplus(-v);
    default: return -softplus(-v);
  }
}

__device__ __forceinline__ float f_gp(int div, float v) {
  switch (div) {
    case DIV_TV: { const float t = tanhf(v); return 0.5f * (1.0f - t * t); }
    case DIV_KL: case DIV_PEARSON: return 1.0f;
    case DIV_RKL: case DIV_HELLINGER: return expf(-v);
    default: return sigm(-v);
  }
}

__device__ __forceinline__ float f_star(int div, float t) {
  switch (div) {
    case DIV_TV: return t;
    case DIV_KL: return expf(t - 1.0f);
    case DIV_RKL: return -1.0f - logf(-t);
    case DIV_PEARSON: return (0.25f * t) * t + t;
    case DIV_HELLINGER: return t / (1.0f - t);
    case DIV_JS: return -logf(2.0f - expf(t));
    default: return -logf(1.0f - expf(t));
  }
}

__device__ __forceinline__ float f_starp(int div, float t) {
  switch (div) {
    case DIV_TV: return 1.0f;
    case DIV_KL: return expf(t - 1.0f);
    case DIV_RKL: return -1.0f / t;
    case DIV_PEARSON: return 0.5f * t + 1.0f;
    case DIV_HELLINGER: { const float u = 1.0f - t; return 1.0f / (u * u); }
    case DIV_JS: { const float e = expf(t); return e / (2.0f - e); }
    default: { const float e = expf(t); return e / (1.0f - e); }
  }
}

// The pointwise hooks (bce, ls, w, f). dL_D/dlogit of a real or a fake
// row's logit l, and that row's term of B * d_loss:
//   bce: softplus(-lr) + softplus(lf)     ls: (lr - 1)^2/2 + lf^2/2
//   w:   lf - lr                          f:  -g_f(lr) + f*(g_f(lf))
__device__ __forceinline__ float d_grad(const Args& a, bool real, float l) {
  if (HOOK == HOOK_LS) return real ? (l - 1.0f) * a.inv_b : l * a.inv_b;
  if (HOOK == HOOK_W) return real ? -a.inv_b : a.inv_b;
  if (HOOK == HOOK_F)
    return real ? -f_gp(a.div, l) * a.inv_b
                : (f_starp(a.div, f_g(a.div, l)) * f_gp(a.div, l)) * a.inv_b;
  return real ? (sigm(l) - 1.0f) * a.inv_b : sigm(l) * a.inv_b;
}

__device__ __forceinline__ float d_term(const Args& a, bool real, float l) {
  if (HOOK == HOOK_LS)
    return real ? 0.5f * ((l - 1.0f) * (l - 1.0f)) : 0.5f * (l * l);
  if (HOOK == HOOK_W) return real ? -l : l;
  if (HOOK == HOOK_F)
    return real ? -f_g(a.div, l) : f_star(a.div, f_g(a.div, l));
  return real ? softplus(-l) : softplus(l);
}

// dL_G/dlf2 of a fake row's logit and its term of B * g_loss:
//   nsgan softplus(-l); mmgan -softplus(l); ls (l - 1)^2/2; w, fi -l;
//   f: -f*(g_f(l)), or -g_f(l) for the non-saturating loss
__device__ __forceinline__ float g_grad(const Args& a, float l) {
  if (HOOK == HOOK_LS) return (l - 1.0f) * a.inv_b;
  if (HOOK == HOOK_W || HOOK == HOOK_FI) return -a.inv_b;
  if (HOOK == HOOK_F)
    return a.alt ? -f_gp(a.div, l) * a.inv_b
                 : (-f_starp(a.div, f_g(a.div, l)) * f_gp(a.div, l)) * a.inv_b;
  return a.alt ? -sigm(l) * a.inv_b : (sigm(l) - 1.0f) * a.inv_b;
}

__device__ __forceinline__ float g_term(const Args& a, float l) {
  if (HOOK == HOOK_LS) return 0.5f * ((l - 1.0f) * (l - 1.0f));
  if (HOOK == HOOK_W || HOOK == HOOK_FI) return -l;
  if (HOOK == HOOK_F)
    return a.alt ? -f_g(a.div, l) : -f_star(a.div, f_g(a.div, l));
  return a.alt ? -softplus(l) : softplus(-l);
}

// ragan: the batch means its gradients share, from the B real logits lr
// and the B fake logits lf. Every warp that calls this sums in the same
// order, so all hold the same bits.
//   m_r, m_f: mean(lr), mean(lf)
//   s_r, s_f: mean(sig(lr - m_f) - off), mean(sig(lf - m_r))
struct RaStats {
  float m_r, m_f, s_r, s_f;
};

__device__ __forceinline__ RaStats ra_stats(const Args& a, const float* lr,
                                            const float* lf, float off) {
  const int lane = threadIdx.x & 31;
  RaStats s;
  float x = 0.0f, y = 0.0f;
  for (int r = lane; r < a.B; r += 32) {
    x += ld(lr + r);
    y += ld(lf + r);
  }
  s.m_r = warp_sum(x) * a.inv_b;
  s.m_f = warp_sum(y) * a.inv_b;
  x = 0.0f;
  y = 0.0f;
  for (int r = lane; r < a.B; r += 32) {
    x += sigm(ld(lr + r) - s.m_f) - off;
    y += sigm(ld(lf + r) - s.m_r);
  }
  s.s_r = warp_sum(x) * a.inv_b;
  s.s_f = warp_sum(y) * a.inv_b;
  return s;
}

// fishergan: ipm = mean(lr) - mean(lf) and Omega = mean(lr^2 + lf^2)/2,
// summed in one order by every warp that calls this.
__device__ __forceinline__ void fi_stats(const Args& a, const float* lr,
                                         const float* lf, float& ipm,
                                         float& omega) {
  const int lane = threadIdx.x & 31;
  float x = 0.0f, y = 0.0f;
  for (int r = lane; r < a.B; r += 32) {
    const float u = ld(lr + r), v = ld(lf + r);
    x += u - v;
    y += u * u + v * v;
  }
  ipm = warp_sum(x) * a.inv_b;
  omega = 0.5f * warp_sum(y) * a.inv_b;
}

// One warp per row r < rows of h [rows, Hd]: the logit h.w2d + b2d.
__device__ void logits_only(const Args& a, const float* h, int rows,
                            float* logit) {
  const float* w2 = a.p[P_D_W2];
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * CT + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * CT) >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    const float* hr = h + (size_t)r * a.Hd;
    float s = 0.0f;
    for (int j = lane; j < a.Hd; j += 32) s = fmaf(ld(hr + j), ld(w2 + j), s);
    s = warp_sum(s) + ld(a.p[P_D_B2]);
    if (lane == 0) logit[r] = s;
  }
}

// One warp per row r < rows: from the stored logit its gradient (via
// `grad`), and the row of dh = gl w2d^T * leaky'(h).
template <class Grad>
__device__ void grad_rows(const Args& a, const float* h, int rows,
                          const float* logit, float* glo, float* dh,
                          Grad grad) {
  const float* w2 = a.p[P_D_W2];
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * CT + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * CT) >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    const float* hr = h + (size_t)r * a.Hd;
    const float g = grad(r, ld(logit + r));
    if (lane == 0) glo[r] = g;
    for (int j = lane; j < a.Hd; j += 32)
      dh[(size_t)r * a.Hd + j] = (g * ld(w2 + j)) * dleaky(ld(hr + j), a.slope);
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

// The critic's lanes of step k's metrics row, by one warp, from the 2B
// logits of this critic update; fishergan's lam descends here.
__device__ void critic_metrics(const Args& a, int k) {
  const int lane = threadIdx.x & 31;
  const int B = a.B;
  float* row = a.metrics + (size_t)k * LANES;
  if (HOOK == HOOK_FI) {
    float ipm, omega;
    fi_stats(a, a.lg, a.lg + B, ipm, omega);
    if (lane == 0) {
      const float lam = ld(a.lam), c = 1.0f - omega;
      row[0] = -(ipm + lam * c - ((0.5f * a.rho) * c) * c);
      row[1] = ipm;
      row[2] = omega;
      row[6] = c;
      row[7] = lam - a.rho * c;
      a.lam[0] = lam - a.rho * c;
    }
    return;
  }
  RaStats st = {};
  if (HOOK == HOOK_RA) st = ra_stats(a, a.lg, a.lg + B, 1.0f);
  float sp = 0.0f, sr = 0.0f, sf = 0.0f;
  for (int r = lane; r < B; r += 32) {
    const float lr = ld(a.lg + r), lf = ld(a.lg + B + r);
    if (HOOK == HOOK_RA)
      sp += softplus(-(lr - st.m_f)) + softplus(lf - st.m_r);
    else
      sp += d_term(a, true, lr) + d_term(a, false, lf);
    sr += lr;
    sf += lf;
  }
  sp = warp_sum(sp);
  sr = warp_sum(sr);
  sf = warp_sum(sf);
  if (lane == 0) {
    row[0] = sp * a.inv_b;
    row[1] = sr * a.inv_b;
    row[2] = sf * a.inv_b;
  }
}

// g_loss of step k, by one warp, from the B logits lf2 (ragan: and lr2).
__device__ void g_metrics(const Args& a, int k) {
  const int lane = threadIdx.x & 31;
  RaStats st = {};
  if (HOOK == HOOK_RA) st = ra_stats(a, a.lf2 + a.B, a.lf2, 0.0f);
  float s = 0.0f;
  for (int r = lane; r < a.B; r += 32) {
    const float l = ld(a.lf2 + r);
    if (HOOK == HOOK_RA)
      s += softplus(-(l - st.m_r)) + softplus(ld(a.lf2 + a.B + r) - st.m_f);
    else if (HOOK == HOOK_BCE)
      s += a.alt ? softplus(l) : softplus(-l);
    else
      s += g_term(a, l);
  }
  s = warp_sum(s);
  if (lane == 0)
    a.metrics[(size_t)k * LANES + 3] =
        (HOOK == HOOK_BCE && a.alt) ? -s * a.inv_b : s * a.inv_b;
}

template <class A, bool RMS>
__global__ void __launch_bounds__(CT) gan_chunk_kernel(const A a) {
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

    for (int i = 0; i < a.ds; ++i) {
      const size_t row0 = (size_t)(k * a.ds + i) * B;
      const float* x = a.xs + row0 * X;
      const float* zd = a.zd + row0 * Z;

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
      if (COUPLED_D) {
        logits_only(a, a.hd, 2 * B, a.lg);
        grid.sync();
        // a warp with rows: the batch's scalars first, parked in the
        // warp's corner of shared memory (idle between product phases)
        // so that the row loop holds no register for them
        if (gwarp < 2 * B) {
          if (HOOK == HOOK_RA) {
            RaStats* const st =
                reinterpret_cast<RaStats*>(smem) + (threadIdx.x >> 5);
            {
              const RaStats s0 = ra_stats(a, a.lg, a.lg + B, 1.0f);
              if (lane == 0) *st = s0;
            }
            __syncwarp();
            grad_rows(a, a.hd, 2 * B, a.lg, a.gl, a.dh, [=](int r, float l) {
              return r < a.B ? ((sigm(l - st->m_f) - 1.0f) - st->s_f) * a.inv_b
                             : (sigm(l - st->m_r) - st->s_r) * a.inv_b;
            });
          } else {  // fishergan, with lam as it was before this update
            float ipm, omega;
            fi_stats(a, a.lg, a.lg + B, ipm, omega);
            float* const mu_f = smem + (threadIdx.x >> 5);
            if (lane == 0) *mu_f = ld(a.lam) - a.rho * (1.0f - omega);
            __syncwarp();
            grad_rows(a, a.hd, 2 * B, a.lg, a.gl, a.dh, [=](int r, float l) {
              return r < a.B ? (-1.0f + *mu_f * l) * a.inv_b
                             : (1.0f + *mu_f * l) * a.inv_b;
            });
          }
        }
      } else {
        logit_rows(a, a.hd, 2 * B, a.lg, a.gl, a.dh,
                   [&](int r, float l) { return d_grad(a, r < B, l); });
      }
      grid.sync();
      {  // F: dW1d = [x; fake]^T [dhr; dhf] with the optimizer; small grads
        const AdamT td = step_t<RMS>(a, a.d_lr, a.t_d + k * a.ds + i + 1);
        Gemm job = {{a.xin, 1, X}, {a.dh, Hd, 1}, X, Hd, 2 * B, EPI_OPT,
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
              update<RMS>(a, P_D_W2, v, dw, td);
              update<RMS>(a, P_D_B1, v, db, td);
            }
          } else if (v == Hd) {
            float db = 0.0f;
            for (int r = lane; r < 2 * B; r += 32) db += ld(a.gl + r);
            db = warp_sum(db);
            if (lane == 0) update<RMS>(a, P_D_B2, 0, db, td);
          } else {
            critic_metrics(a, k);
          }
        }
      }
      grid.sync();
    }

    {  // G1: hf2 through the post-update critic; ragan: also the hidden
       // of x, whose rows follow fake2's in the scratch, so one product of
       // 2B rows gives [hf2; hr2]
      Gemm job = {{a.fk2, X, 1}, {a.p[P_D_W1], Hd, 1}, COUPLED_G ? 2 * B : B,
                  Hd, X, EPI_LEAKY, a.p[P_D_B1], nullptr, a.hf2, Hd, 0};
      run_gemms(a, &job, 1, none, smem);
    }
    grid.sync();
    // G23: lf2, gl, dh2
    if (COUPLED_G) {
      logits_only(a, a.hf2, 2 * B, a.lf2);  // [lf2; lr2]
      grid.sync();
      if (gwarp < B) {
        const RaStats st = ra_stats(a, a.lf2 + B, a.lf2, 0.0f);
        grad_rows(a, a.hf2, B, a.lf2, a.gl2, a.dh2, [&](int, float l) {
          return ((sigm(l - st.m_r) - 1.0f) - st.s_r) * a.inv_b;
        });
      }
    } else {
      logit_rows(a, a.hf2, B, a.lf2, a.gl2, a.dh2,
                 [&](int, float l) { return g_grad(a, l); });
    }
    grid.sync();
    {  // G4: dx = dh2 W1d^T -> gu2 = dx * fake2 * (1 - fake2); g_loss
      Gemm job = {{a.dh2, Hd, 1}, {a.p[P_D_W1], 1, Hd}, B, X, Hd, EPI_SIGD,
                  nullptr, a.fk2, a.gu2, X, 0};
      run_gemms(a, &job, 1, none, smem);
      if (gwarp == 0) g_metrics(a, k);
    }
    grid.sync();
    {  // G5: dhg = gu2 W2g^T * (hg > 0)
      Gemm job = {{a.gu2, X, 1}, {a.p[P_G_W2], 1, X}, B, H, X, EPI_RELUD,
                  nullptr, a.hgg, a.dhg, H, 0};
      run_gemms(a, &job, 1, none, smem);
    }
    grid.sync();
    {  // G6: dW2g = hg^T gu2, dW1g = zg^T dhg with the optimizer; db2g, db1g
      const AdamT tg = step_t<RMS>(a, a.g_lr, a.t_g + k + 1);
      Gemm jobs[2] = {
          {{a.hgg, 1, H}, {a.gu2, X, 1}, H, X, B, EPI_OPT, nullptr, nullptr,
           nullptr, X, P_G_W2},
          {{zg, 1, Z}, {a.dhg, H, 1}, Z, H, B, EPI_OPT, nullptr, nullptr,
           nullptr, H, P_G_W1}};
      run_gemms(a, jobs, COUPLED_D ? fresh(2) : 2, tg, smem);
      for (int v = gwarp; v < X + H; v += nwarps) {  // a warp per column
        const float* src = v < X ? a.gu2 + v : a.dhg + (v - X);
        const int stride = v < X ? X : H;
        float db = 0.0f;
        for (int r = lane; r < B; r += 32) db += ld(src + (size_t)r * stride);
        db = warp_sum(db);
        if (lane == 0) {
          if (v < X) update<RMS>(a, P_G_B2, v, db, tg);
          else update<RMS>(a, P_G_B1, v - X, db, tg);
        }
      }
    }
    grid.sync();
  }
}

static const void* kernel_of(int rmsprop) {
  return rmsprop ? (const void*)gan_chunk_kernel<ArgsRms, true>
                 : (const void*)gan_chunk_kernel<Args, false>;
}

// The hook this library was compiled for (GM_HOOK).
extern "C" int gm_gan_chunk_hook() { return HOOK; }

// Floats of scratch a launch needs at these widths (the wrapper
// allocates it).
extern "C" long long gm_gan_chunk_scratch_floats(int B, int Z, int H, int X,
                                                 int Hd) {
  (void)Z;
  const long long b = B;  // the layout gm_gan_chunk cuts it into
  return 3 * b * H + 4 * b * X + 7 * b * Hd + 7 * b;
}

// The grid a launch of the Adam (rmsprop = 0) or RMSprop kernel uses:
// every SM's co-resident blocks, at most blocks_per_sm each. Returns 0
// when the query fails.
extern "C" int gm_gan_chunk_grid(int blocks_per_sm, int rmsprop) {
  int dev = 0, sms = 0, occ = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, kernel_of(rmsprop), CT, 0) != cudaSuccess)
    return 0;
  if (occ > blocks_per_sm) occ = blocks_per_sm;
  return occ * sms;
}

// The chunk's sizes, counts and hyperparameters, as the wrapper hands
// them over (ops/cuda_train.py::_Hyper mirrors this field for field).
struct GanChunkHyper {
  int steps, ds, B, Z, H, X, Hd, t_g, t_d, rmsprop, alt, div;
  float g_lr, d_lr, b1, b2, omb1, omb2, eps, log_b1, log_b2, slope, inv_b,
      clip, rho;
};

// Launches one cooperative kernel on `stream` that runs `steps` outer
// steps and updates the 8 state tensors' planes (p, mu, nu: `state` holds
// 24 pointers, planes in that order, tensors g_w1 g_b1 g_w2 g_b2 d_w1
// d_b1 d_w2 d_b2; with RMSprop the mu pointers are null) and `lam` (one
// float: fishergan's multiplier) in place. Allocates nothing, does not
// synchronise; returns the CUDA error code of the launch (0 = queued).
extern "C" int gm_gan_chunk(const float* xs, const float* zd, const float* zg,
                            void* const* state, float* scratch,
                            float* metrics, float* lam,
                            const GanChunkHyper* h, int grid, void* stream) {
  if (h->steps < 1 || h->ds < 1 || h->B < 1 || h->Z < 1 || h->H < 1 ||
      h->X < 1 || h->Hd < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  ArgsRms a = {};
  a.xs = xs;
  a.zd = zd;
  a.zg = zg;
  for (int q = 0; q < N_PARAMS; ++q) {
    a.p[q] = static_cast<float*>(state[q]);
    a.mu[q] = static_cast<float*>(state[N_PARAMS + q]);
    a.nu[q] = static_cast<float*>(state[2 * N_PARAMS + q]);
    if (!a.p[q] || !a.nu[q] || (!h->rmsprop && !a.mu[q]))
      return (int)cudaErrorInvalidValue;
  }
  a.metrics = metrics;
  a.lam = lam;
  const size_t b = h->B;
  const size_t H = h->H, X = h->X, Hd = h->Hd;
  float* s = scratch;
  a.hgd = s; s += b * H;
  a.hgg = s; s += b * H;
  a.fk2 = s; s += b * X;  // fake2, then [x; fake]: G1 reads [fake2; x]
  a.xin = s; s += 2 * b * X;
  a.hd = s; s += 2 * b * Hd;
  a.gl = s; s += 2 * b;
  a.lg = s; s += 2 * b;
  a.dh = s; s += 2 * b * Hd;
  a.hf2 = s; s += 2 * b * Hd;
  a.gl2 = s; s += b;
  a.lf2 = s; s += 2 * b;
  a.dh2 = s; s += b * Hd;
  a.gu2 = s; s += b * X;
  a.dhg = s;
  a.steps = h->steps;
  a.ds = h->ds;
  a.B = h->B;
  a.Z = h->Z;
  a.H = h->H;
  a.X = h->X;
  a.Hd = h->Hd;
  a.t_g = h->t_g;
  a.t_d = h->t_d;
  a.g_lr = h->g_lr;
  a.d_lr = h->d_lr;
  a.b1 = h->b1;
  a.b2 = h->b2;
  a.omb1 = h->omb1;
  a.omb2 = h->omb2;
  a.eps = h->eps;
  a.log_b1 = h->log_b1;
  a.log_b2 = h->log_b2;
  a.slope = h->slope;
  a.inv_b = h->inv_b;
  a.clip = h->clip;
  a.rho = h->rho;
  a.alt = h->alt;
  a.div = h->div;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      kernel_of(h->rmsprop), dim3(grid), dim3(CT), args, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
