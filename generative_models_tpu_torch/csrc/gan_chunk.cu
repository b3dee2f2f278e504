// Whole-chunk GAN training in one launch, for Hopper (sm_90a): nsgan,
// mmgan, lsgan, wgan, fgan, ragan, fishergan, wgangp, dragan, cgan,
// infogan and began.
//
// Replaces: generative_models_tpu/ops/pallas_train.py::_make_kernel with
// ::_fused_chunk_call (the TPU chunk kernel) and the critic hooks of
// ::_make_variant_hooks (pallas_train.py:271-484), the gradient penalty's
// double backward ::_gp_backward (:227-245, math :525-535) with its xtra
// stream, cgan's label lanes (:594-595, 669-672, 718-721), infogan's Q
// head (:271-310, 392-406, 468-478, lane 6 :735-736), began's
// autoencoder critic, its direct L1 path into G (dx_extra, :740-741) and
// its k_t law (:764-772), Adam or RMSprop, wgan's clip, the carried
// scalar (fishergan's multiplier, began's k_t), the G EMA plane
// (:755-762), float32 or bf16 operands (_make_dots, :192-211).
//
// One source, one library a hook: -DGM_HOOK=0..10 picks the critic (bce:
// nsgan and mmgan; ls; w; f: all seven divergences; ra; fi; gpw: w with
// the penalty, wgangp; gpb: bce with the penalty, dragan; cond: bce on
// label-carrying rows, cgan; info: bce with the Q head, infogan; be: the
// autoencoder, began) at compile time, and each library holds an Adam
// and an RMSprop kernel, each also with the G EMA plane, so no hot loop
// carries a run-time switch of another variant. With -DGM_BF16=1
// (libraries of their own) every product takes
// bf16-rounded operands (chunk_common.cuh), the tiles' and the row warps'
// alike: the heads' logits and rows of dh, dW2d's column sums, infogan's
// MI targets (the reference's tq = mm(zrow, mselq)), and the penalty's
// u = leaky'(hh) w2d (w2row = dotT_rhs(lane0, w2d)) and its dw2d terms.
// Built with -DGM_PHASE=1, a hook's library holds instead its two phase
// kernels for data-parallel training (see gan_phase_kernel): one critic
// update's gradients and one G update's, which the caller all-reduces
// before its optimizer runs.
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
//     optimizer on G; the EMA kernels then step the G EMA plane,
//     ema <- d ema + (1 - d) p, element by element right after each G
//     parameter's update (the reference reads p after the update too)
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
//   F  dW1d with the optimizer in the tile's epilogue; beside it dW2d,
//      db1d, db2d with the optimizer, a block per 64 columns, and the
//      critic's metrics
//   G1 hf2;  G23 one warp per row: lf2, gl, dh2;  G4 dx -> gu2, g_loss
//   G5 dhg;  G6 dW2g, dW1g with the optimizer in the epilogue; beside
//      them db2g, db1g, a block per 64 columns
// The gradient penalty (gpw, gpb), per critic update, at x_hat (gpw: eps
// x + (1 - eps) fake, formed in B's epilogue from the xtra stream's eps
// column; gpb: streamed rows, dragan's perturbed real batch):
//   hh = x_hat W1d + b1d -> u = leaky'(hh) * w2d^T (and leaky'(hh) kept),
//     in the product's epilogue (gpw: phase C; gpb: phase A)
//   g = u W1d^T [B, X] (gpw: in DE; gpb: in C)
//   n_i = sqrt(sum g_i^2 + 1e-12), c_i = 2 lam (n_i - 1) / (B n_i), one
//     warp a row, which writes the row c_i g_i below [x; fake] in `xin`
//   s = g W1d [B, Hd] (beside those rows: gpw in a phase N of its own
//     after DE, gpb in DE)
//   dW1d += (c g)^T u: F's product runs K = 3B, [x; fake; c g]^T
//     [dhr; dhf; u]; dw2d += sum_i c_i leaky'(hh_i) s_i in F's column sums;
//     db1d, db2d get nothing; d_loss += gp = lam mean((n - 1)^2), lanes 4
//     and 5 hold gp and mean(n)
// A phase with both row (or column) work and product tiles gives the
// tiles to the blocks past it (run_gemms' `first`). cgan's rows are x + label
// (Xd = X + n_cls wide) and z + label; fake and fake2 take the label of
// their x row and zg row (copied in phase A), D's products run K = Xd,
// and G4's dx covers G's X columns only: with true widths no selection
// matrix is needed.
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
// Every output element has one owner and every sum a fixed order (a row
// warp's sum: its lanes stride the row, then a shuffle tree; a column
// sum: col_sums' warps in order; a product: chunk_common.cuh), so a run
// is deterministic. State and scratch, which other SMs write between
// phases, are read with ordinary (L1-cached) loads and the tiles'
// cp.async.ca copies, which go through L1 too: the grid barrier is an
// acquire — its spin ends in CCTL.IVALL, an invalidation of the SM's L1,
// in the SASS nvcc 12.8 emits — so a line written in an earlier phase is
// read afresh. (A dependent L2 load on an H100: 197-220 ns with
// ld.global.cg, 145 ns without; tools/chunk_phases.py measures both.)
// infogan: the critic's head is L = 1 + cat + 2 cont wide (lane 0 the D
// logit, then Q's categorical logits, means and log-variances: the
// d_head and q_head side by side in W2d [Hd, L]), and the z rows are G's
// code rows z ⊕ onehot(cat) ⊕ cont (Z wide, the codes in the last cat +
// cont lanes), so the MI targets are read straight from the rows: no
// selection matrix. DE and G23 stay one warp a row: the lanes take the L
// outputs (up to 4 a lane), a warp's max and sums give the softmax over
// the cat lanes, and the gradient vector
//   lane 0 the bce rule; cat lanes lam (softmax - onehot)/B; mean lanes
//   lam (mu - c)/(B cont); log-variance lanes 0 (the fixed variance)
// is parked in the warp's corner of shared memory for its row of dh.
// F's dW2d is then a product ([hr; hf]^T gl, K = 2B) with the optimizer
// in its epilogue; each row's MI term goes to the metrics warps (lane 1
// the critic's, lane 6 G's).
// began: the critic is an autoencoder, W2d [Hd, X] with a sigmoid, so
// its head is products, not row warps. Per critic update:
//   R  rec = sigmoid([hr; hf] W2d + b2d); the epilogue writes the logit
//      gradient sign(r - v) r (1 - r)/(B X) (fake rows: times -k) with v
//      the row's pixel of [x; fake], and |v - r|
//   E  dh = g W2d^T * leaky'(h), beside it one warp a row sums |v - r|
//   F  dW1d, dW2d = [hr; hf]^T g (K = 2B) with the optimizer; db1d, db2d
//      a block per 64 columns
// and for G: G2 rf2 = sigmoid(hf2 W2d + b2d), whose epilogue writes gl =
// -s2 rf2 (1 - rf2) and d2 = fake2 - rf2 (s2 = sign(d2)/(B X)); G3 dh2 =
// gl W2d^T * leaky'(hf2), beside it the rows of |d2|; G4's epilogue adds
// s2 to dx (the direct path) before the sigmoid's derivative; its one
// metrics warp then applies the k_t law k <- clip(k + lambda_k (gamma
// L(x) - L(G(z))), 0, 1), M = L(x) + |gamma L(x) - L(G(z))|, L(x) from
// the step's last critic update. k is a device scalar like fishergan's
// multiplier. |.| is differentiated through sign (0 at 0), as the TPU
// kernel does.
// Widths are the true ones: no lane padding, so the TPU kernel's padded
// lane hazards (pallas_train.py:92-102) and its lane0/rowm/xcols masks
// have no counterpart.
//
// Products: the engine of chunk_common.cuh (tile classes by job, depth
// groups, a cp.async ring running on across a block's tiles, the
// 16-byte copies along the contiguous index, mma.sync in the bf16 builds), which
// this source shares with vae_chunk.cu.
//
// Bound on the H100 (SXM, 700 W data-sheet peaks), per step at B 100,
// ds 1, flagship widths: D update 324.3 MFLOP, G update 334.2 MFLOP,
// 658.6 MFLOP = 9.83 us at the 67 TFLOP/s float32 FMA peak, against
// 416 KB of streams (x 313.6 KB, zd 51.2 KB, zg 51.2 KB) = 0.12 us from
// HBM: the kernel is bound by operations. What holds it back on the
// card is latency: a product of 5-63 MFMA is ~1-3 us of FMA work over 132
// SMs, and each of the ~10 phases a step ends in a grid barrier (1.1-1.3
// us). The parent design lost ~5 us a tile to serial L2 round trips (a
// slice's loads, then its FMAs, then the next; the epilogue's dependent
// loads; one 255-register block an SM): 173.8 us a step in
// tools/chunk_phases.py, against 9.83 of operations. The engine keeps the
// loads in flight instead (see chunk_common.cuh), one block an SM, each
// phase's tiles in one round at the flagship widths. The bf16 builds do the
// same work on bf16 operands, whose bound is the 989 TFLOP/s dense bf16
// tensor-core peak (0.67 us a step), on mma.sync. The EMA plane adds a
// read and a write of G's 4 tensors a step (2.93 MB), 0.87 us at 3.35
// TB/s.


#include "chunk_common.cuh"

namespace cg = cooperative_groups;

#ifndef GM_HOOK
#define GM_HOOK 0
#endif
// GM_PHASE=1 builds the data-parallel phase kernels of the hook instead of
// its chunk kernels (see "Phase kernels" below).
#ifndef GM_PHASE
#define GM_PHASE 0
#endif

enum { HOOK_BCE = 0, HOOK_LS, HOOK_W, HOOK_F, HOOK_RA, HOOK_FI, HOOK_GPW,
       HOOK_GPB, HOOK_COND, HOOK_INFO, HOOK_BEGAN };
enum { DIV_TV = 0, DIV_KL, DIV_RKL, DIV_PEARSON, DIV_HELLINGER, DIV_JS,
       DIV_GAN };
constexpr int HOOK = GM_HOOK;
constexpr bool PHASE = GM_PHASE != 0;
// what a phase kernel computes (the mode of gm_gan_phase_plan): one
// critic update's gradients, or one G update's
enum { M_D = 1, M_G };
static_assert(HOOK >= HOOK_BCE && HOOK <= HOOK_BEGAN,
              "GM_HOOK must be 0..10");
// the gradient penalty's hooks, cgan's label lanes, infogan's Q head,
// began's autoencoder
constexpr bool GP = HOOK == HOOK_GPW || HOOK == HOOK_GPB;
constexpr bool COND = HOOK == HOOK_COND;
constexpr bool INFO = HOOK == HOOK_INFO;
constexpr bool BEGAN = HOOK == HOOK_BEGAN;
// the logit rule of the critic and of G: gpw is w's, gpb, cond and info
// (lane 0) bce's
constexpr int CRIT = HOOK == HOOK_GPW ? HOOK_W
                     : (HOOK == HOOK_GPB || COND || INFO) ? HOOK_BCE : HOOK;
// infogan: head outputs a lane keeps (L <= 32 * QPL), and the columns a
// row warp sums at once
constexpr int QPL = 4;
constexpr int QC = 16;
// the gradient of a logit needs sums over the whole batch
constexpr bool COUPLED_D = HOOK == HOOK_RA || HOOK == HOOK_FI;
constexpr bool COUPLED_G = HOOK == HOOK_RA;

enum { P_G_W1 = 0, P_G_B1, P_G_W2, P_G_B2, P_D_W1, P_D_B1, P_D_W2, P_D_B2,
       N_PARAMS };
enum { EPI_RELU, EPI_LEAKY, EPI_SIGMOID, EPI_SIGD, EPI_RELUD, EPI_OPT,
       EPI_STORE, EPI_GPU, EPI_SIGXH,          // the penalty's
       EPI_BGR, EPI_BGD, EPI_BGG, EPI_BGX };   // began's
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
  float* lam;       // fishergan's multiplier, began's k_t: in and out
  // scratch; hf2 and lf2 hold 2B rows (ragan: the fake rows, then x's);
  // gl [2B, L] and gl2 [B, L] the head's gradients
  float *hgd, *hgg, *xin, *fk2, *hd, *gl, *lg, *dh, *hf2, *gl2, *lf2, *dh2,
      *gu2, *dhg;
  int steps, ds, B, Z, H, X, Hd;
  int t_g, t_d;
  float g_lr, d_lr, b1, b2, omb1, omb2, eps, log_b1, log_b2, slope, inv_b;
  float clip, rho;
  int alt;  // bce: mmgan's saturating G loss; f: the non-saturating one
  int div;  // f: which divergence
  // the penalty (gpw, gpb): its stream [rows, 1] (eps) or [rows, X]
  // (x_hat), and its scratch: x_hat (gpw), g [B, X], s [B, Hd],
  // leaky'(hh) [B, Hd], n then c [2B], this update's eps [B]
  const float* xtra;
  float *xh, *gbuf, *sbuf, *dph, *nrm, *epsb;
  float gp_lam;
  int n_cls, Xd;  // cond: the label lanes, and D's input width X + n_cls
  // the critic head's width: 1; infogan 1 + cat + 2 cont; began X
  int L;
  // infogan: the code lanes, where they start in a z row, the MI weight,
  // and each row's MI term (critic: the fake rows; G: its rows)
  int n_cat, n_cont, Zc;
  float info_lam;
  float *mib, *mib2;
  // began: gamma, lambda_k, 1/(B X); |v - r| [2B, X], d2 = fake2 - rf2
  // [B, X], and their row sums [2B], [B]
  float gamma, lambda_k, inv_bx;
  float *ab, *d2, *erow, *erow2;
  // the EMA kernels: G's EMA plane (g_w1 g_b1 g_w2 g_b2), its decay d and
  // 1 - d
  float* ema[4];
  float ema_d, ema_omd;
  // the phase kernels: where each state tensor's gradient goes (segments
  // of one flat buffer), in place of its optimizer step; and the carried
  // scalar by value where `lam` is null
#if GM_PHASE
  float* gr[N_PARAMS];
  float lam_v;
#endif
};

// The arguments typed by the kernel's optimizer (RMSprop or Adam) and
// whether it steps the G EMA plane, so that the product tiles' epilogue
// is chosen at compile time (chunk_common.cuh's epilogue<A>).
template <bool R, bool E>
struct KArgs : Args {
  static constexpr bool RMS = R, EMA = E;
};

// The carried scalar (began's k_t): through `lam`, or in the phase
// kernels by value when the caller passed no pointer.
__device__ __forceinline__ float carried(const Args& a) {
#if GM_PHASE
  return a.lam ? ld(a.lam) : a.lam_v;
#else
  return ld(a.lam);
#endif
}

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

// A job count or a job's row count, which the penalty kernels take
// through fresh(): with their extra phases, tile counts hoisted out of
// the step loop were spilled (4 to 20 bytes). The other kernels take the
// value as it is.
__device__ __forceinline__ int gp_fresh(int n) {
  if constexpr (GP) return fresh(n);
  return n;
}

// One optimizer step on element i of state tensor q with gradient g;
// wgan clips the critic's tensors (q >= P_D_W1) right after it; the EMA
// kernels step G's EMA plane (q < P_D_W1) from the new parameter.
template <bool RMS, bool EMA = false>
__device__ __forceinline__ void update(const Args& a, int q, size_t i,
                                       float g, const AdamT& t) {
#if GM_PHASE  // the gradient itself; the optimizer runs after the
  a.gr[q][i] = g;  // all-reduce, outside the kernel
#else
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
    if constexpr (EMA)
      if (q < P_D_W1)
        a.ema[q][i] = ema_step(a.ema_d, ld(a.ema[q] + i), a.ema_omd, p);
  } else {
    const float p = adam(a, q, i, g, t);
    if (HOOK == HOOK_W && q >= P_D_W1 && a.clip > 0.0f)
      a.p[q][i] = fminf(fmaxf(p, -a.clip), a.clip);
    if constexpr (EMA)
      if (q < P_D_W1)
        a.ema[q][i] = ema_step(a.ema_d, ld(a.ema[q] + i), a.ema_omd, p);
  }
#endif
}

template <bool RMS>
__device__ __forceinline__ AdamT step_t(const Args& a, float lr, int t) {
  if (RMS) return AdamT{0.0f, 1.0f, 1.0f};
  return adam_t(a, lr, (float)t);
}

// The penalty's epilogues: a plain store (g, s); hh -> u = leaky'(hh)
// w2d (`aux` = w2d) with leaky'(hh) kept in `dph`; the fake with x_hat =
// eps x + (1 - eps) fake beside it (gpw).
__device__ __forceinline__ void gp_epi(const Args& a, const Gemm& g, int m,
                                       int n, float c, float bv, float xv) {
  const size_t o = (size_t)m * g.ldo + n;
  if (g.epi == EPI_STORE) {
    g.out[o] = c;
  } else if (g.epi == EPI_GPU) {
    const float d = dleaky(c + bv, a.slope);
    g.out[o] = d * opnd(xv);
    a.dph[o] = d;
  } else {
    const float f = sigm(c + bv);
    const float e = ld(a.epsb + m);
    g.out[o] = f;
    a.xh[o] = e * ld(a.xin + o) + (1.0f - e) * f;
  }
}

__device__ __forceinline__ float sgn(float v) {
  return (float)(v > 0.0f) - (float)(v < 0.0f);
}

// began's epilogues (`out` at row stride ldo):
//   BGR: the logit gradient of rec = sigmoid(c + b2d) against v = aux
//        ([x; fake]): sign(r - v) r (1 - r)/(B X), fake rows (m >= B)
//        times -k; |v - r| to `ab`
//   BGD: c * leaky'(aux)  (dh, dh2)
//   BGG: rf2 = sigmoid(c + b2d) against f = aux (fake2): d2 = f - rf2 to
//        `d2`, gl = -sign(d2)/(B X) rf2 (1 - rf2)
//   BGX: (c + sign(d2)/(B X)) f (1 - f), f = aux (fake2): gu2 with the
//        direct L1 path
__device__ __forceinline__ void be_epi(const Args& a, const Gemm& g, int m,
                                       int n, float c, float bv, float xv) {
  const size_t o = (size_t)m * g.ldo + n;
  if (g.epi == EPI_BGR) {
    const float r = sigm(c + bv);
    const float v = xv;
    float gr = ((sgn(r - v) * r) * (1.0f - r)) * a.inv_bx;
    if (m >= a.B) gr = -carried(a) * gr;
    g.out[o] = gr;
    a.ab[o] = fabsf(v - r);
  } else if (g.epi == EPI_BGD) {
    g.out[o] = c * dleaky(xv, a.slope);
  } else if (g.epi == EPI_BGG) {
    const float r = sigm(c + bv);
    const float d = xv - r;
    a.d2[o] = d;
    g.out[o] = ((-(sgn(d) * a.inv_bx) * r) * (1.0f - r));
  } else {
    const float f = xv;
    const float dx = c + sgn(ld(a.d2 + o)) * a.inv_bx;
    g.out[o] = (dx * f) * (1.0f - f);
  }
}

// Element (m, n) of a product that does not step the optimizer, with its
// bias-row value bv and aux value xv loaded (0 where the job has none).
__device__ __forceinline__ void epi(const Args& a, const Gemm& g, int m, int n,
                                    float c, float bv, float xv) {
  if constexpr (GP) {
    if (g.epi > EPI_OPT) {
      gp_epi(a, g, m, n, c, bv, xv);
      return;
    }
  }
  if constexpr (BEGAN) {
    if (g.epi > EPI_OPT) {
      be_epi(a, g, m, n, c, bv, xv);
      return;
    }
  }
  const size_t o = (size_t)m * g.ldo + n;
  switch (g.epi) {
    case EPI_RELU: g.out[o] = fmaxf(c + bv, 0.0f); break;
    case EPI_LEAKY: g.out[o] = leaky(c + bv, a.slope); break;
    case EPI_SIGMOID: g.out[o] = sigm(c + bv); break;
    case EPI_SIGD: g.out[o] = (c * xv) * (1.0f - xv); break;
    default: g.out[o] = c * (xv > 0.0f ? 1.0f : 0.0f); break;  // EPI_RELUD
  }
}

// A batch of the optimizer's elements (update<> for each, every load of
// the batch before its first store); the other epilogues element by
// element.
template <int EB, class A>
__device__ __forceinline__ void epilogue(const A& a, const Gemm& g,
                                         const int (&m)[EB],
                                         const int (&n)[EB],
                                         const float (&c)[EB],
                                         const bool (&ok)[EB],
                                         const AdamT& at) {
  if (g.epi != EPI_OPT) {  // the bias and aux values first, then each
    float bv[EB], xv[EB];
#pragma unroll
    for (int k = 0; k < EB; ++k) {
      bv[k] = ok[k] && g.bias ? ld(g.bias + n[k]) : 0.0f;
      xv[k] = ok[k] && g.aux ? ld(g.aux + (g.epi == EPI_GPU
                                               ? (size_t)n[k]
                                               : (size_t)m[k] * g.ldo + n[k]))
                             : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < EB; ++k)
      if (ok[k]) epi(a, g, m[k], n[k], c[k], bv[k], xv[k]);
    return;
  }
  const int q = g.param;
  size_t i[EB];
#pragma unroll
  for (int k = 0; k < EB; ++k) i[k] = (size_t)m[k] * g.N + n[k];
#if GM_PHASE  // the gradients themselves
#pragma unroll
  for (int k = 0; k < EB; ++k)
    if (ok[k]) a.gr[q][i[k]] = c[k];
#else
  constexpr bool RMS = A::RMS, EMA = A::EMA;
  float* const pp = a.p[q];
  float* const nu = a.nu[q];
  float* const mu = RMS ? nullptr : a.mu[q];
  float* const em = EMA && q < P_D_W1 ? a.ema[q] : nullptr;
  const bool clipped = HOOK == HOOK_W && q >= P_D_W1 && a.clip > 0.0f;
  float p0[EB], v0[EB], m0[EB], e0[EB];
#pragma unroll
  for (int k = 0; k < EB; ++k)
    if (ok[k]) {
      p0[k] = ld(pp + i[k]);
      v0[k] = ld(nu + i[k]);
      m0[k] = RMS ? 0.0f : ld(mu + i[k]);
      e0[k] = em ? ld(em + i[k]) : 0.0f;
    }
#pragma unroll
  for (int k = 0; k < EB; ++k)
    if (ok[k]) {  // update<>'s arithmetic
      const float gk = c[k];
      float p, v;
      if (RMS) {
        const float lr = q >= P_D_W1 ? a.d_lr : a.g_lr;
        v = RMS_DECAY * v0[k] + (RMS_OMD * gk) * gk;
        p = p0[k] - (lr * gk) / (sqrtf(v) + RMS_EPS);
      } else {
        float mk;
        p = adam_step(a, at, gk, m0[k], v0[k], p0[k], mk, v);
        mu[i[k]] = mk;
      }
      nu[i[k]] = v;
      pp[i[k]] = clipped ? fminf(fmaxf(p, -a.clip), a.clip) : p;
      if (em) em[i[k]] = ema_step(a.ema_d, e0[k], a.ema_omd, p);
    }
#endif
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
  if (CRIT == HOOK_LS) return real ? (l - 1.0f) * a.inv_b : l * a.inv_b;
  if (CRIT == HOOK_W) return real ? -a.inv_b : a.inv_b;
  if (CRIT == HOOK_F)
    return real ? -f_gp(a.div, l) * a.inv_b
                : (f_starp(a.div, f_g(a.div, l)) * f_gp(a.div, l)) * a.inv_b;
  return real ? (sigm(l) - 1.0f) * a.inv_b : sigm(l) * a.inv_b;
}

__device__ __forceinline__ float d_term(const Args& a, bool real, float l) {
  if (CRIT == HOOK_LS)
    return real ? 0.5f * ((l - 1.0f) * (l - 1.0f)) : 0.5f * (l * l);
  if (CRIT == HOOK_W) return real ? -l : l;
  if (CRIT == HOOK_F)
    return real ? -f_g(a.div, l) : f_star(a.div, f_g(a.div, l));
  return real ? softplus(-l) : softplus(l);
}

// dL_G/dlf2 of a fake row's logit and its term of B * g_loss:
//   nsgan softplus(-l); mmgan -softplus(l); ls (l - 1)^2/2; w, fi -l;
//   f: -f*(g_f(l)), or -g_f(l) for the non-saturating loss
__device__ __forceinline__ float g_grad(const Args& a, float l) {
  if (CRIT == HOOK_LS) return (l - 1.0f) * a.inv_b;
  if (CRIT == HOOK_W || CRIT == HOOK_FI) return -a.inv_b;
  if (CRIT == HOOK_F)
    return a.alt ? -f_gp(a.div, l) * a.inv_b
                 : (-f_starp(a.div, f_g(a.div, l)) * f_gp(a.div, l)) * a.inv_b;
  return a.alt ? -sigm(l) * a.inv_b : (sigm(l) - 1.0f) * a.inv_b;
}

__device__ __forceinline__ float g_term(const Args& a, float l) {
  if (CRIT == HOOK_LS) return 0.5f * ((l - 1.0f) * (l - 1.0f));
  if (CRIT == HOOK_W || CRIT == HOOK_FI) return -l;
  if (CRIT == HOOK_F)
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
    for (int j = lane; j < a.Hd; j += 32)
      s = fmaf(opnd(ld(hr + j)), opnd(ld(w2 + j)), s);
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
      dh[(size_t)r * a.Hd + j] =
          (opnd(g) * opnd(ld(w2 + j))) * dleaky(ld(hr + j), a.slope);
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
    for (int j = lane; j < a.Hd; j += 32)
      s = fmaf(opnd(ld(hr + j)), opnd(ld(w2 + j)), s);
    const float l = warp_sum(s) + ld(a.p[P_D_B2]);
    const float g = grad(r, l);
    if (lane == 0) {
      logit[r] = l;
      glo[r] = g;
    }
    for (int j = lane; j < a.Hd; j += 32)
      dh[(size_t)r * a.Hd + j] =
          (opnd(g) * opnd(ld(w2 + j))) * dleaky(ld(hr + j), a.slope);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// infogan: one warp for row r of h [., Hd] (a real row of the critic's,
// a fake row of the critic's with its code row `zrow`, or a row of G's
// with its code row): the L head outputs o = h W2d + b2d (then lane l
// keeps outputs l, l + 32, ...), the gradient vector into glo[r L ..], the
// logit o_0 into logit[r], the row's MI term (fake rows) into *mi, and
// the row of dh = gl W2d^T * leaky'(h):
//   lane 0: critic real (sig - 1)/B, critic fake sig/B, G (sig - 1)/B
//   cat lanes: lam (softmax - onehot)/B; mean lanes: lam (mu - c)/(B cont)
//   MI term: -sum_cat onehot log softmax + sum_mean (c - mu)^2 / (2 cont)
// The gradient vector is parked in the warp's corner of shared memory
// (`gs`, idle in this phase) for the row of dh.
__device__ void info_row(const Args& a, const float* h, int r, bool real,
                         bool toward_real, const float* zrow, float* glo,
                         float* logit, float* dh, float* mi, float* gs) {
  const float* w2 = a.p[P_D_W2];
  const float* b2 = a.p[P_D_B2];
  const int lane = threadIdx.x & 31;
  const int L = a.L, Hd = a.Hd, nc = a.n_cat, nm = a.n_cont;
  const float* hr = h + (size_t)r * Hd;
  // the outputs, QC at a time: the lanes stride the hidden units (each
  // load of h once, the row of W2d's QC columns beside it), then a warp
  // sum a column, parked in gs
  for (int c0 = 0; c0 < L; c0 += QC) {
    float acc[QC];
#pragma unroll
    for (int c = 0; c < QC; ++c) acc[c] = 0.0f;
    for (int j = lane; j < Hd; j += 32) {
      const float hj = opnd(ld(hr + j));
      const float* wj = w2 + (size_t)j * L + c0;
#pragma unroll
      for (int c = 0; c < QC; ++c)
        if (c0 + c < L) acc[c] = fmaf(hj, opnd(ld(wj + c)), acc[c]);
    }
#pragma unroll
    for (int c = 0; c < QC; ++c) {
      const float v = warp_sum(acc[c]);
      if (lane == c && c0 + c < L) gs[c0 + c] = v + ld(b2 + c0 + c);
    }
  }
  __syncwarp();
  float o[QPL];
#pragma unroll
  for (int q = 0; q < QPL; ++q) {
    const int c = lane + 32 * q;
    o[q] = c < L ? gs[c] : 0.0f;
  }
  // the softmax over the cat lanes 1 .. nc
  float mx = -INFINITY;
#pragma unroll
  for (int q = 0; q < QPL; ++q) {
    const int c = lane + 32 * q;
    if (c >= 1 && c <= nc) mx = fmaxf(mx, o[q]);
  }
  mx = warp_max(mx);
  float se = 0.0f;
#pragma unroll
  for (int q = 0; q < QPL; ++q) {
    const int c = lane + 32 * q;
    if (c >= 1 && c <= nc) se += expf(o[q] - mx);
  }
  se = warp_sum(se);
  const float lse = logf(se);
  const float inv_bc = a.inv_b / (float)(nm > 0 ? nm : 1);
  float term = 0.0f;
#pragma unroll
  for (int q = 0; q < QPL; ++q) {
    const int c = lane + 32 * q;
    float g = 0.0f;
    if (c == 0) {
      g = (real || toward_real) ? (sigm(o[q]) - 1.0f) * a.inv_b
                                : sigm(o[q]) * a.inv_b;
    } else if (!real && c <= nc + nm) {
      const float t = opnd(ld(zrow + a.Zc + c - 1));  // tq = mm(zrow, ..)
      if (c <= nc) {
        g = (a.info_lam * (expf(o[q] - mx) / se - t)) * a.inv_b;
        term -= ((o[q] - mx) - lse) * t;
      } else {
        const float d = o[q] - t;
        g = (a.info_lam * d) * inv_bc;
        term += (0.5f * (d * d)) / (float)nm;
      }
    }
    if (c < L) {
      gs[c] = g;
      glo[(size_t)r * L + c] = g;
    }
  }
  term = warp_sum(term);
  if (lane == 0) {
    logit[r] = o[0];
    if (!real) *mi = term;
  }
  __syncwarp();
  for (int j = lane; j < Hd; j += 32) {
    const float* wj = w2 + (size_t)j * L;
    float acc = 0.0f;
    for (int c = 0; c < L; ++c) acc = fmaf(opnd(gs[c]), opnd(ld(wj + c)), acc);
    dh[(size_t)r * Hd + j] = acc * dleaky(ld(hr + j), a.slope);
  }
  __syncwarp();  // every lane is done with gs before the next row's
}

// The critic's lanes of step k's metrics row, by one warp, from the 2B
// logits of this critic update; fishergan's lam descends here.
__device__ void critic_metrics(const Args& a, int k) {
  const int lane = threadIdx.x & 31;
  const int B = a.B;
  float* row = a.metrics + (size_t)k * LANES;
  if constexpr (PHASE)  // the carried scalar the update read (began's k)
    if (lane == 0) row[7] = carried(a);
  if constexpr (BEGAN) {  // the energies L(x), L(G(z)); k_t before G
    float er = 0.0f, ef = 0.0f;
    for (int r = lane; r < B; r += 32) {
      er += ld(a.erow + r);
      ef += ld(a.erow + B + r);
    }
    er = warp_sum(er) * a.inv_bx;
    ef = warp_sum(ef) * a.inv_bx;
    if (lane == 0) {
      row[0] = er - carried(a) * ef;
      row[1] = er;
      row[2] = ef;
    }
    return;
  }
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
  if constexpr (GP) {  // gp = lam mean((n - 1)^2), and mean(n)
    float q = 0.0f, sn = 0.0f;
    for (int r = lane; r < B; r += 32) {
      const float n = ld(a.nrm + r);
      q = fmaf(n - 1.0f, n - 1.0f, q);
      sn += n;
    }
    const float gp = a.gp_lam * warp_sum(q) * a.inv_b;
    sn = warp_sum(sn);
    if (lane == 0) {
      row[0] = sp * a.inv_b + gp;
      row[1] = sr * a.inv_b;
      row[2] = sf * a.inv_b;
      row[4] = gp;
      row[5] = sn * a.inv_b;
    }
  } else if constexpr (INFO) {  // d_loss = bce + lam mi; lane 1 = mi
    float mi = 0.0f;
    for (int r = lane; r < B; r += 32) mi += ld(a.mib + r);
    mi = warp_sum(mi) * a.inv_b;
    if (lane == 0) {
      row[0] = sp * a.inv_b + a.info_lam * mi;
      row[1] = mi;
      row[2] = 0.0f;
    }
  } else if (lane == 0) {
    row[0] = sp * a.inv_b;
    row[1] = sr * a.inv_b;
    row[2] = sf * a.inv_b;
  }
}

// g_loss of step k, by one warp, from the B logits lf2 (ragan: and lr2;
// infogan: and G's MI terms, lane 6); began: from the rows of |d2|, then
// the k_t law (lanes 6 and 7, and k itself).
__device__ void g_metrics(const Args& a, int k) {
  const int lane = threadIdx.x & 31;
  if constexpr (BEGAN) {
    float e = 0.0f;
    for (int r = lane; r < a.B; r += 32) e += ld(a.erow2 + r);
    e = warp_sum(e) * a.inv_bx;
    if constexpr (PHASE) {  // g_loss only: the k_t law runs after the
      if (lane == 0) a.metrics[(size_t)k * LANES + 3] = e;  // all-reduce
      return;
    }
    if (lane == 0) {
      float* row = a.metrics + (size_t)k * LANES;
      const float l_real = ld(row + 1);
      const float bal = a.gamma * l_real - e;
      const float kn =
          fminf(fmaxf(ld(a.lam) + a.lambda_k * bal, 0.0f), 1.0f);
      row[3] = e;
      row[6] = l_real + fabsf(bal);
      row[7] = kn;
      a.lam[0] = kn;
    }
    return;
  }
  RaStats st = {};
  if (HOOK == HOOK_RA) st = ra_stats(a, a.lf2 + a.B, a.lf2, 0.0f);
  float s = 0.0f;
  for (int r = lane; r < a.B; r += 32) {
    const float l = ld(a.lf2 + r);
    if (HOOK == HOOK_RA)
      s += softplus(-(l - st.m_r)) + softplus(ld(a.lf2 + a.B + r) - st.m_f);
    else if (CRIT == HOOK_BCE)
      s += a.alt ? softplus(l) : softplus(-l);
    else
      s += g_term(a, l);
  }
  s = warp_sum(s);
  if constexpr (INFO) {  // g_loss = bce + lam mi2; lane 6 = mi2
    float mi = 0.0f;
    for (int r = lane; r < a.B; r += 32) mi += ld(a.mib2 + r);
    mi = warp_sum(mi) * a.inv_b;
    if (lane == 0) {
      a.metrics[(size_t)k * LANES + 3] = s * a.inv_b + a.info_lam * mi;
      a.metrics[(size_t)k * LANES + 6] = mi;
    }
    return;
  }
  if (lane == 0)
    a.metrics[(size_t)k * LANES + 3] =
        (CRIT == HOOK_BCE && a.alt) ? -s * a.inv_b : s * a.inv_b;
}

// The penalty's row r of g: n_r = |g_r| (with 1e-12 inside the root),
// c_r = 2 lam (n_r - 1) / (B n_r), and the row c_r g_r at row 2B + r of
// `xin` (below x and fake, for F's product), by one warp.
__device__ void norm_row(const Args& a, int r) {
  const int lane = threadIdx.x & 31;
  const float* g = a.gbuf + (size_t)r * a.X;
  float q = 0.0f;
  for (int j = lane; j < a.X; j += 32) {
    const float v = ld(g + j);
    q = fmaf(v, v, q);
  }
  const float n = sqrtf(warp_sum(q) + 1e-12f);
  const float c = ((2.0f * a.gp_lam * a.inv_b) * (n - 1.0f)) / n;
  float* const cg = a.xin + (size_t)(2 * a.B + r) * a.X;
  for (int j = lane; j < a.X; j += 32) cg[j] = c * ld(g + j);
  if (lane == 0) {
    a.nrm[r] = n;
    a.nrm[a.B + r] = c;
  }
}

// The penalty hooks' row phase: one warp a row, rows 0..2B-1 the logits
// of [hr; hf] with their gradients and rows of dh, rows 2B.. (`norms` of
// them) the penalty's norm rows.
__device__ void gp_rows(const Args& a, int norms) {
  const float* w2 = a.p[P_D_W2];
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * CT + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * CT) >> 5;
  const int B = a.B, Hd = a.Hd;
  for (int r = warp; r < 2 * B + norms; r += nwarps) {
    if (r >= 2 * B) {
      norm_row(a, r - 2 * B);
      continue;
    }
    const float* hr = a.hd + (size_t)r * Hd;
    float s = 0.0f;
    for (int j = lane; j < Hd; j += 32)
      s = fmaf(opnd(ld(hr + j)), opnd(ld(w2 + j)), s);
    const float l = warp_sum(s) + ld(a.p[P_D_B2]);
    const float g = d_grad(a, r < B, l);
    if (lane == 0) {
      a.lg[r] = l;
      a.gl[r] = g;
    }
    for (int j = lane; j < Hd; j += 32)
      a.dh[(size_t)r * Hd + j] =
          (opnd(g) * opnd(ld(w2 + j))) * dleaky(ld(hr + j), a.slope);
  }
}

template <bool RMS, bool EMA>
__global__ void __launch_bounds__(CT, MIN_BLOCKS)
    gan_chunk_kernel(const __grid_constant__ KArgs<RMS, EMA> a) {
  extern __shared__ __align__(16) float smem[];  // SMEM_BYTES
  // the arguments in shared memory for the tile walker (which reads them
  // at every element of an epilogue)
  __shared__ KArgs<RMS, EMA> sa;
  copy_args(sa, a);
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * CT + threadIdx.x;
  const int gsz = gridDim.x * CT;
  const int lane = threadIdx.x & 31;
  const int gwarp = gtid >> 5;
  const int nwarps = gsz >> 5;
  const int B = a.B, Z = a.Z, H = a.H, X = a.X, Hd = a.Hd;
  const AdamT none = {0.0f, 1.0f, 1.0f};
  // D's input width: cgan's x rows end in their label lanes
  const int Xd = COND ? a.Xd : X;
  float* const fake = a.xin + (size_t)B * Xd;  // rows B..2B-1 of xin

  for (int k = 0; k < a.steps; ++k) {
    const float* zg = a.zg + (size_t)k * B * Z;

    for (int i = 0; i < a.ds; ++i) {
      const size_t row0 = (size_t)(k * a.ds + i) * B;
      const float* x = a.xs + row0 * Xd;
      const float* zd = a.zd + row0 * Z;
      // G's hidden and fake2 beside the first update
      const bool g0 = i == 0;

      {  // A: hgd, hr (and hg; dragan: the penalty's hh -> u); x beside fake
        if constexpr (HOOK == HOOK_GPB) {
          const int B = fresh(a.B);  // (see fresh: nothing hoisted here)
          Gemm jobs[4] = {
              {{zd, Z, 1}, {a.p[P_G_W1], H, 1}, B, H, Z, EPI_RELU,
               a.p[P_G_B1], nullptr, a.hgd, H, 0},
              {{x, X, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, X, EPI_LEAKY,
               a.p[P_D_B1], nullptr, a.hd, Hd, 0},
              {{a.xtra + row0 * X, X, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, X,
               EPI_GPU, a.p[P_D_B1], a.p[P_D_W2],
               a.dh + (size_t)2 * B * Hd, Hd, 0},
              {{zg, Z, 1}, {a.p[P_G_W1], H, 1}, B, H, Z, EPI_RELU,
               a.p[P_G_B1], nullptr, a.hgg, H, 0}};
          run_gemms(sa, jobs, g0 ? 4 : 3, none, smem);
        } else {
          const int B = gp_fresh(a.B);
          Gemm jobs[3] = {
              {{zd, Z, 1}, {a.p[P_G_W1], H, 1}, B, H, Z, EPI_RELU,
               a.p[P_G_B1], nullptr, a.hgd, H, 0},
              {{x, Xd, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, Xd, EPI_LEAKY,
               a.p[P_D_B1], nullptr, a.hd, Hd, 0},
              {{zg, Z, 1}, {a.p[P_G_W1], H, 1}, B, H, Z, EPI_RELU,
               a.p[P_G_B1], nullptr, a.hgg, H, 0}};
          run_gemms(sa, jobs, g0 ? 3 : 2, none, smem);
        }
        for (size_t e = gtid; e < (size_t)B * Xd; e += gsz) a.xin[e] = ld(x + e);
        if constexpr (COND) {  // the labels of fake (x's) and fake2 (zg's)
          const int nc = a.n_cls;
          for (int e = gtid; e < B * nc; e += gsz) {
            const int r = e / nc, j = e % nc;
            a.xin[(size_t)(B + r) * Xd + X + j] = ld(x + (size_t)r * Xd + X + j);
            if (g0)
              a.fk2[(size_t)r * Xd + X + j] = ld(zg + (size_t)r * Z + Z - nc + j);
          }
        }
        if constexpr (HOOK == HOOK_GPW)  // this update's eps
          for (int r = gtid, n = gp_fresh(B); r < n; r += gsz)
            a.epsb[r] = ld(a.xtra + row0 + r);
      }
      grid.sync();
      {  // B: fake (wgangp: and x_hat beside it) (and fake2)
        const int B = gp_fresh(a.B);
        Gemm jobs[2] = {
            {{a.hgd, H, 1}, {a.p[P_G_W2], X, 1}, B, X, H,
             HOOK == HOOK_GPW ? EPI_SIGXH : EPI_SIGMOID, a.p[P_G_B2], nullptr,
             fake, Xd, 0},
            {{a.hgg, H, 1}, {a.p[P_G_W2], X, 1}, B, X, H, EPI_SIGMOID,
             a.p[P_G_B2], nullptr, a.fk2, Xd, 0}};
        run_gemms(sa, jobs, g0 ? 2 : 1, none, smem);
      }
      grid.sync();
      {  // C: hf (wgangp: and the penalty's hh -> u; dragan: and g = u W1d^T)
        const Gemm hf = {{fake, Xd, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, Xd,
                         EPI_LEAKY, a.p[P_D_B1], nullptr, a.hd + (size_t)B * Hd,
                         Hd, 0};
        if constexpr (HOOK == HOOK_GPW) {
          const int B = fresh(a.B);
          Gemm jobs[2] = {hf,
                          {{a.xh, X, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, X,
                           EPI_GPU, a.p[P_D_B1], a.p[P_D_W2],
                           a.dh + (size_t)2 * B * Hd, Hd, 0}};
          run_gemms(sa, jobs, gp_fresh(2), none, smem);
        } else if constexpr (HOOK == HOOK_GPB) {
          const int B = fresh(a.B);
          Gemm jobs[2] = {hf,
                          {{a.dh + (size_t)2 * B * Hd, Hd, 1},
                           {a.p[P_D_W1], 1, Hd}, B, X, Hd, EPI_STORE, nullptr,
                           nullptr, a.gbuf, X, 0}};
          run_gemms(sa, jobs, gp_fresh(2), none, smem);
        } else {
          run_gemms(sa, &hf, 1, none, smem);
        }
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
      } else if constexpr (GP) {
        // beside the logit rows: wgangp g = u W1d^T, then (phase N) the
        // norm rows beside s = g W1d; dragan the norm rows and s at once
        const int B = fresh(a.B);
        const Gemm gj = {{a.dh + (size_t)2 * B * Hd, Hd, 1},
                         {a.p[P_D_W1], 1, Hd}, B, X, Hd, EPI_STORE, nullptr,
                         nullptr, a.gbuf, X, 0};
        const Gemm sj = {{a.gbuf, X, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, X,
                         EPI_STORE, nullptr, nullptr, a.sbuf, Hd, 0};
        if constexpr (HOOK == HOOK_GPW) {
          gp_rows(a, 0);
          run_gemms(sa, &gj, gp_fresh(1), none, smem, row_blocks(2 * B));
          grid.sync();
          for (int r = gwarp, n = gp_fresh(B); r < n; r += nwarps) norm_row(a, r);
          run_gemms(sa, &sj, gp_fresh(1), none, smem, row_blocks(B));
        } else {
          gp_rows(a, B);
          run_gemms(sa, &sj, gp_fresh(1), none, smem, row_blocks(3 * B));
        }
      } else if constexpr (INFO) {  // the head's L outputs a row
        float* const gs = smem + (threadIdx.x >> 5) * WARP_SMEM;
        for (int r = gwarp; r < 2 * B; r += nwarps)
          info_row(a, a.hd, r, r < B, false,
                   r < B ? nullptr : zd + (size_t)(r - B) * Z, a.gl, a.lg,
                   a.dh, r < B ? nullptr : a.mib + (r - B), gs);
      } else if constexpr (BEGAN) {
        {  // R: rec of [hr; hf], the logit gradient and |v - r|
          const Gemm rj = {{a.hd, Hd, 1}, {a.p[P_D_W2], X, 1}, 2 * B, X, Hd,
                           EPI_BGR, a.p[P_D_B2], a.xin, a.gl, X, 0};
          run_gemms(sa, &rj, fresh(1), none, smem);
        }
        grid.sync();
        {  // E: dh = g W2d^T * leaky'(h); beside it the rows of |v - r|
          const Gemm ej = {{a.gl, X, 1}, {a.p[P_D_W2], 1, X}, 2 * B, Hd, X,
                           EPI_BGD, nullptr, a.hd, a.dh, Hd, 0};
          for (int r = gwarp; r < 2 * B; r += nwarps) {
            float e = 0.0f;
            for (int n = lane; n < X; n += 32) e += ld(a.ab + (size_t)r * X + n);
            e = warp_sum(e);
            if (lane == 0) a.erow[r] = e;
          }
          run_gemms(sa, &ej, fresh(1), none, smem, row_blocks(2 * B));
        }
      } else {
        logit_rows(a, a.hd, 2 * B, a.lg, a.gl, a.dh,
                   [&](int r, float l) { return d_grad(a, r < B, l); });
      }
      grid.sync();
      if constexpr (INFO || BEGAN) {  // F: dW1d and dW2d = [hr; hf]^T gl
        // with the optimizer; db1d, db2d a block per 64 columns, the
        // metrics on the block after them, the tiles beside
        const AdamT td = step_t<RMS>(a, a.d_lr, a.t_d + k * a.ds + i + 1);
        const int L = fresh(a.L);
        const int ncb = col_blocks(Hd + L);
        col_sums<1>(
            Hd + L, 2 * B, 0, smem,
            [&](int r, int v, float(&s)[1]) {
              s[0] += v < Hd ? ld(a.dh + (size_t)r * Hd + v)
                             : ld(a.gl + (size_t)r * L + (v - Hd));
            },
            [&](int v, float(&s)[1]) {
              if (v < Hd) update<RMS, EMA>(a, P_D_B1, v, s[0], td);
              else update<RMS, EMA>(a, P_D_B2, v - Hd, s[0], td);
            });
        if ((int)blockIdx.x == ncb && threadIdx.x < 32) critic_metrics(a, k);
        Gemm jobs[2] = {{{a.xin, 1, Xd}, {a.dh, Hd, 1}, Xd, Hd, 2 * B, EPI_OPT,
                         nullptr, nullptr, nullptr, Hd, P_D_W1},
                        {{a.hd, 1, Hd}, {a.gl, L, 1}, Hd, L, 2 * B, EPI_OPT,
                         nullptr, nullptr, nullptr, L, P_D_W2}};
        run_gemms(sa, jobs, fresh(2), td, smem, ncb + 1);
      } else {  // F
        const AdamT td = step_t<RMS>(a, a.d_lr, a.t_d + k * a.ds + i + 1);
        // a block per 64 columns (a lane a column, the warps over the rows):
        // dW2d and db1d for column v < Hd, db2d at v = Hd; the critic's
        // metrics from this (the last) update on the block after them
        constexpr int NF = GP ? 3 : 2;
        const int ncb = col_blocks(Hd + 1);
        col_sums<NF>(
            Hd + 1, 2 * B, 0, smem,
            [&](int r, int v, float(&s)[NF]) {
              if (v < Hd) {
                const size_t o = (size_t)r * Hd + v;
                s[0] = fmaf(opnd(ld(a.hd + o)), opnd(ld(a.gl + r)), s[0]);
                s[1] += ld(a.dh + o);
                if constexpr (GP) {  // sum_i c_i leaky'(hh_i) s_i
                  if (r < B) {
                    if constexpr (BF16)  // dotT_lhs(c dph s, lane0): one
                      s[NF - 1] += bf16r(  // rounded operand a term
                          (ld(a.nrm + B + r) * ld(a.dph + o)) * ld(a.sbuf + o));
                    else
                      s[NF - 1] = fmaf(ld(a.nrm + B + r) * ld(a.dph + o),
                                       ld(a.sbuf + o), s[NF - 1]);
                  }
                }
              } else {
                s[1] += ld(a.gl + r);
              }
            },
            [&](int v, float(&s)[NF]) {
              if (v < Hd) {
                float dw = s[0];
                if constexpr (GP) dw += s[NF - 1];
                update<RMS, EMA>(a, P_D_W2, v, dw, td);
                update<RMS, EMA>(a, P_D_B1, v, s[1], td);
              } else {
                update<RMS, EMA>(a, P_D_B2, 0, s[1], td);
              }
            });
        if ((int)blockIdx.x == ncb && threadIdx.x < 32) critic_metrics(a, k);
        // dW1d = [x; fake]^T [dhr; dhf] with the optimizer (the penalty:
        // K = 3B, [x; fake; c g]^T [dhr; dhf; u]), beside them
        Gemm job = {{a.xin, 1, Xd}, {a.dh, Hd, 1}, Xd, Hd,
                    GP ? 3 * fresh(B) : 2 * B, EPI_OPT, nullptr, nullptr,
                    nullptr, Hd, P_D_W1};
        run_gemms(sa, &job, gp_fresh(1), td, smem, ncb + 1);
      }
      grid.sync();
    }

    {  // G1: hf2 through the post-update critic; ragan: also the hidden
       // of x, whose rows follow fake2's in the scratch, so one product of
       // 2B rows gives [hf2; hr2]
      Gemm job = {{a.fk2, Xd, 1}, {a.p[P_D_W1], Hd, 1}, COUPLED_G ? 2 * B : B,
                  Hd, Xd, EPI_LEAKY, a.p[P_D_B1], nullptr, a.hf2, Hd, 0};
      run_gemms(sa, &job, gp_fresh(1), none, smem);
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
    } else if constexpr (INFO) {  // G's rows: bce toward 1 and the MI
      float* const gs = smem + (threadIdx.x >> 5) * WARP_SMEM;
      for (int r = gwarp; r < B; r += nwarps)
        info_row(a, a.hf2, r, false, true, zg + (size_t)r * Z, a.gl2, a.lf2,
                 a.dh2, a.mib2 + r, gs);
    } else if constexpr (BEGAN) {
      {  // G2: rf2 of hf2; gl = -s2 rf2 (1 - rf2) and d2 = fake2 - rf2
        const Gemm rj = {{a.hf2, Hd, 1}, {a.p[P_D_W2], X, 1}, B, X, Hd,
                         EPI_BGG, a.p[P_D_B2], a.fk2, a.gl2, X, 0};
        run_gemms(sa, &rj, fresh(1), none, smem);
      }
      grid.sync();
      {  // G3: dh2 = gl W2d^T * leaky'(hf2); beside it the rows of |d2|
        const Gemm ej = {{a.gl2, X, 1}, {a.p[P_D_W2], 1, X}, B, Hd, X,
                         EPI_BGD, nullptr, a.hf2, a.dh2, Hd, 0};
        for (int r = gwarp; r < B; r += nwarps) {
          float e = 0.0f;
          for (int n = lane; n < X; n += 32)
            e += fabsf(ld(a.d2 + (size_t)r * X + n));
          e = warp_sum(e);
          if (lane == 0) a.erow2[r] = e;
        }
        run_gemms(sa, &ej, fresh(1), none, smem, row_blocks(B));
      }
    } else {
      logit_rows(a, a.hf2, B, a.lf2, a.gl2, a.dh2,
                 [&](int, float l) { return g_grad(a, l); });
    }
    grid.sync();
    {  // G4: dx = dh2 W1d^T -> gu2 = dx * fake2 * (1 - fake2); g_loss
       // (cgan: G's X columns only; the label lanes carry nothing to G;
       // began: dx + s2, the direct L1 path, then the k_t law)
      Gemm job = {{a.dh2, Hd, 1}, {a.p[P_D_W1], 1, Hd}, B, X, Hd,
                  BEGAN ? EPI_BGX : EPI_SIGD, nullptr, a.fk2, a.gu2, Xd, 0};
      if ((int)blockIdx.x == (int)gridDim.x - 1 && threadIdx.x < 32)
        g_metrics(a, k);
      run_gemms(sa, &job, gp_fresh(1), none, smem);
    }
    grid.sync();
    {  // G5: dhg = gu2 W2g^T * (hg > 0)
      Gemm job = {{a.gu2, Xd, 1}, {a.p[P_G_W2], 1, X}, B, H, X, EPI_RELUD,
                  nullptr, a.hgg, a.dhg, H, 0};
      run_gemms(sa, &job, gp_fresh(1), none, smem);
    }
    grid.sync();
    {  // G6: dW2g = hg^T gu2, dW1g = zg^T dhg with the optimizer; db2g, db1g
      const AdamT tg = step_t<RMS>(a, a.g_lr, a.t_g + k + 1);
      Gemm jobs[2] = {
          {{a.hgg, 1, H}, {a.gu2, Xd, 1}, H, X, B, EPI_OPT, nullptr, nullptr,
           nullptr, X, P_G_W2},
          {{zg, 1, Z}, {a.dhg, H, 1}, Z, H, B, EPI_OPT, nullptr, nullptr,
           nullptr, H, P_G_W1}};
      // (db2g, db1g: a block per 64 columns, the tiles beside)
      col_sums<1>(
          X + H, B, 0, smem,
          [&](int r, int v, float(&s)[1]) {
            s[0] += v < X ? ld(a.gu2 + (size_t)r * Xd + v)
                          : ld(a.dhg + (size_t)r * H + (v - X));
          },
          [&](int v, float(&s)[1]) {
            if (v < X) update<RMS, EMA>(a, P_G_B2, v, s[0], tg);
            else update<RMS, EMA>(a, P_G_B1, v - X, s[0], tg);
          });
      run_gemms(sa, jobs, COUPLED_D ? fresh(2) : gp_fresh(2), tg, smem,
                col_blocks(X + H));
    }
    grid.sync();
  }
}

// The chunk's sizes, counts and hyperparameters, as the wrapper hands
// them over (ops/cuda_train.py::_Hyper mirrors this field for field).
struct GanChunkHyper {
  int steps, ds, B, Z, H, X, Hd, t_g, t_d, rmsprop, alt, div, n_cls, Xd, L,
      n_cat, n_cont, ema;
  float g_lr, d_lr, b1, b2, omb1, omb2, eps, log_b1, log_b2, slope, inv_b,
      clip, rho, gp_lam, info_lam, gamma, lambda_k, ema_d, ema_omd;
};

// Floats of scratch a launch needs at these widths; Xd is D's input width
// (cgan: X + n_cls; else X), L the critic head's (1; infogan 1 + cat + 2
// cont; began X).
static long long scratch_floats(int B, int H, int X, int Hd, int Xd, int L) {
  const long long b = B;  // the layout set_args cuts it into
  const long long xd = COND ? Xd : X;
  const long long base = 3 * b * H + 4 * b * xd + 7 * b * Hd + 3 * b * L +
                         4 * b;
  if (GP)  // xin and dh a third block of rows; x_hat, g, s, leaky', n, c, eps
    return base + b * xd + 3 * b * Hd + 3 * b + 2 * b * X;
  if (INFO) return base + 2 * b;           // the rows' MI terms
  if (BEGAN) return base + 3 * b * X + 3 * b;  // |v - r|, d2, row sums
  return base;
}

// Everything of `a` but the state planes, from the streams and `h`, with
// `scratch` cut into its buffers. False when the sizes do not fit the
// hook (or a penalty hook that needs it has no xtra stream).
static bool set_args(Args& a, const float* xs, const float* zd,
                     const float* zg, const float* xtra, float* scratch,
                     float* metrics, float* lam, const GanChunkHyper* h,
                     bool needs_xtra) {
  if (h->steps < 1 || h->ds < 1 || h->B < 1 || h->Z < 1 || h->H < 1 ||
      h->X < 1 || h->Hd < 1 || (GP && needs_xtra && !xtra) ||
      (COND ? h->n_cls < 1 || h->Z <= h->n_cls || h->Xd != h->X + h->n_cls
            : h->n_cls != 0 || h->Xd != h->X) ||
      (INFO ? h->n_cat < 1 || h->n_cont < 0 ||
                  h->L != 1 + h->n_cat + 2 * h->n_cont || h->L > 32 * QPL ||
                  h->Z <= h->n_cat + h->n_cont
            : BEGAN ? h->L != h->X : h->L != 1))
    return false;
  a.xs = xs;
  a.zd = zd;
  a.zg = zg;
  a.xtra = xtra;
  a.metrics = metrics;
  a.lam = lam;
  const size_t b = h->B;
  const size_t H = h->H, X = h->X, Hd = h->Hd, Xd = h->Xd, L = h->L;
  const size_t rows = GP ? 3 : 2;  // xin and dh: the penalty's third block
  float* s = scratch;
  a.hgd = s; s += b * H;
  a.hgg = s; s += b * H;
  a.fk2 = s; s += b * Xd;  // fake2, then [x; fake]: G1 reads [fake2; x]
  a.xin = s; s += rows * b * Xd;
  a.hd = s; s += 2 * b * Hd;
  a.gl = s; s += 2 * b * L;
  a.lg = s; s += 2 * b;
  a.dh = s; s += rows * b * Hd;
  a.hf2 = s; s += 2 * b * Hd;
  a.gl2 = s; s += b * L;
  a.lf2 = s; s += 2 * b;
  a.dh2 = s; s += b * Hd;
  a.gu2 = s; s += b * Xd;
  a.dhg = s; s += b * H;
  if (GP) {
    a.xh = s; s += b * X;
    a.gbuf = s; s += b * X;
    a.sbuf = s; s += b * Hd;
    a.dph = s; s += b * Hd;
    a.nrm = s; s += 2 * b;
    a.epsb = s;
  }
  if (INFO) {
    a.mib = s; s += b;
    a.mib2 = s;
  }
  if (BEGAN) {
    a.ab = s; s += 2 * b * X;
    a.d2 = s; s += b * X;
    a.erow = s; s += 2 * b;
    a.erow2 = s;
  }
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
  a.gp_lam = h->gp_lam;
  a.n_cls = h->n_cls;
  a.Xd = h->Xd;
  a.L = h->L;
  a.n_cat = h->n_cat;
  a.n_cont = h->n_cont;
  a.Zc = h->Z - h->n_cat - h->n_cont;
  a.info_lam = h->info_lam;
  a.gamma = h->gamma;
  a.lambda_k = h->lambda_k;
  a.inv_bx = h->inv_b / (float)h->X;
  a.ema_d = h->ema_d;
  a.ema_omd = h->ema_omd;
  return true;
}

#if GM_PHASE
// Phase kernels (the data-parallel path, ops/cuda_dp.py). Replaces:
// generative_models_tpu/ops/pallas_dp.py::_make_d_phase_kernel (:107,
// launched at :324) and ::_make_g_phase_kernel (:195, launched at :337).
// One update a launch on the rank's local rows (B = b), no optimizer, no
// state written:
//   M_D: one critic update; where the chunk steps the optimizer, the
//     kernel writes the gradient (dW1d, db1d, dW2d, db2d) into `gr`, and
//     the whole metrics row: lanes 0, 1, 2 (4, 5 the penalty's), 7 the
//     carried k it read, the others 0
//   M_G: hg and fake2, then G1-G6 through the critic it is given, the G
//     gradients (dW1g, db1g, dW2g, db2g) into `gr`, the whole metrics row:
//     lane 3 g_loss (infogan: lane 6 its MI term), the others 0; began's
//     k_t law is left to the caller
// The all-reduce, the optimizer, wgan's clip, began's law and the G EMA
// run after the launch, as the TPU path runs them outside its kernels
// (pallas_dp.py:525-527). A -DGM_BF16=1 build takes bf16 operands in
// every product, as _make_d_phase_kernel and _make_g_phase_kernel do
// (pallas_dp.py:128, 214).
//
// Design. A kernel of each mode's own (gan_phase_kernel<MODE>): its
// phases and nothing else of the chunk (no step loop, no optimizer, no
// EMA plane, not the other mode's phases), each phase a run_gemms of the
// chunk's engine (chunk_common.cuh) or the chunk's row warps, a grid
// barrier between phases: D runs A, B, C, DE, F (the penalty and began
// one more), G runs hg, fake2, G1, G23, G4, G5, G6 (began G2 and G3 in
// place of G23). A product phase pays ~5 us of fixed cost (the barrier,
// the phase table, the first stage's and the epilogue's L2 round trips;
// tools/phase_trace.py, PERF.md §6), so the phases carry their work
// where it waits least: hr, the critic on the real rows, beside hf in C
// (the penalty hooks: in A), leaving A hgd alone; G5 dW2g and db2g, which
// need only gu2 (G4's), beside dhg, leaving G6 dW1g and db1g. That bounds
// these kernels on the H100: latency, at ~4-8% of the float32 FMA bound
// (H100 SXM: D 0.0048 ms of operations at b 100). What a call costs the
// host was the other half (0.09-0.22 ms a call against 0.04-0.12 ms on
// the card): a launch plan (gm_gan_phase_plan) holds everything of a
// launch that does not change from call to call (the arguments' sizes
// and hyperparameters, the scratch cut into its buffers, the grid, the
// kernel's attributes, set once), and gm_gan_phase_run fills in the
// call's pointers and launches: no occupancy query, no argument struct
// built in Python, no memset (every gradient element and metrics lane
// has a writer), no copy of the carried scalar (a pointer to the
// caller's, or the value).
#ifndef PHASE_MARK  // tools/phase_trace.py: a timer read in block 0
#define PHASE_MARK()
#endif
#ifndef PHASE_END   // tools/phase_trace.py: a last barrier, then a mark
#define PHASE_END()
#endif

// Every lane of the metrics row to 0, by one warp, before its writers.
__device__ __forceinline__ void clear_lanes(const Args& a) {
  if ((threadIdx.x & 31) < LANES) a.metrics[threadIdx.x & 31] = 0.0f;
  __syncwarp();
}

template <int MODE>
__global__ void __launch_bounds__(CT, MIN_BLOCKS)
    gan_phase_kernel(const __grid_constant__ KArgs<true, false> a) {
  extern __shared__ __align__(16) float smem[];  // SMEM_BYTES
  __shared__ KArgs<true, false> sa;
  copy_args(sa, a);
  PHASE_MARK();
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * CT + threadIdx.x;
  const int gsz = gridDim.x * CT;
  const int lane = threadIdx.x & 31;
  const int gwarp = gtid >> 5;
  const int nwarps = gsz >> 5;
  const int B = a.B, Z = a.Z, H = a.H, X = a.X, Hd = a.Hd;
  const AdamT none = {0.0f, 1.0f, 1.0f};
  const int Xd = COND ? a.Xd : X;

  if constexpr (MODE == M_D) {
    float* const fake = a.xin + (size_t)B * Xd;  // rows B..2B-1 of xin
    const float* x = a.xs;
    const float* zd = a.zd;
    // hr, the critic on the real rows, waits for nothing: it runs beside
    // hf in C (A then holds hgd alone, a short phase), but for the penalty
    // hooks, whose C holds the penalty's product already, in A
    // (tools/phase_trace.py at b 100: nsgan A 14.7 -> 6.4, C 12.8 -> 18.7
    // us; in C wgangp's C 20.3 -> 31.9, dragan's 20.3 -> 41.8)
    const Gemm hr = {{x, Xd, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, Xd, EPI_LEAKY,
                     a.p[P_D_B1], nullptr, a.hd, Hd, 0};
    {  // A: hgd (dragan: the penalty's hh -> u; the penalty hooks: hr);
       // x beside fake
      const Gemm hgd = {{zd, Z, 1}, {a.p[P_G_W1], H, 1}, B, H, Z, EPI_RELU,
                        a.p[P_G_B1], nullptr, a.hgd, H, 0};
      if constexpr (HOOK == HOOK_GPB) {
        Gemm jobs[3] = {
            hgd,
            {{a.xtra, X, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, X, EPI_GPU,
             a.p[P_D_B1], a.p[P_D_W2], a.dh + (size_t)2 * B * Hd, Hd, 0},
            hr};
        run_gemms(sa, jobs, 3, none, smem);
      } else if constexpr (HOOK == HOOK_GPW) {
        Gemm jobs[2] = {hgd, hr};
        run_gemms(sa, jobs, 2, none, smem);
      } else {
        run_gemms(sa, &hgd, 1, none, smem);
      }
      for (size_t e = gtid; e < (size_t)B * Xd; e += gsz) a.xin[e] = ld(x + e);
      if constexpr (COND) {  // fake's labels: its x row's
        const int nc = a.n_cls;
        for (int e = gtid; e < B * nc; e += gsz) {
          const int r = e / nc, j = e % nc;
          a.xin[(size_t)(B + r) * Xd + X + j] =
              ld(x + (size_t)r * Xd + X + j);
        }
      }
      if constexpr (HOOK == HOOK_GPW)  // this update's eps
        for (int r = gtid; r < B; r += gsz) a.epsb[r] = ld(a.xtra + r);
    }
    grid.sync();
    PHASE_MARK();
    {  // B: fake (wgangp: and x_hat beside it)
      const Gemm job = {{a.hgd, H, 1}, {a.p[P_G_W2], X, 1}, B, X, H,
                        HOOK == HOOK_GPW ? EPI_SIGXH : EPI_SIGMOID,
                        a.p[P_G_B2], nullptr, fake, Xd, 0};
      run_gemms(sa, &job, 1, none, smem);
    }
    grid.sync();
    PHASE_MARK();
    {  // C: hf, hr (wgangp: hf and the penalty's hh -> u; dragan: hf and
       // g = u W1d^T)
      const Gemm hf = {{fake, Xd, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, Xd,
                       EPI_LEAKY, a.p[P_D_B1], nullptr, a.hd + (size_t)B * Hd,
                       Hd, 0};
      if constexpr (HOOK == HOOK_GPW) {
        Gemm jobs[2] = {hf,
                        {{a.xh, X, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, X,
                         EPI_GPU, a.p[P_D_B1], a.p[P_D_W2],
                         a.dh + (size_t)2 * B * Hd, Hd, 0}};
        run_gemms(sa, jobs, 2, none, smem);
      } else if constexpr (HOOK == HOOK_GPB) {
        Gemm jobs[2] = {hf,
                        {{a.dh + (size_t)2 * B * Hd, Hd, 1},
                         {a.p[P_D_W1], 1, Hd}, B, X, Hd, EPI_STORE, nullptr,
                         nullptr, a.gbuf, X, 0}};
        run_gemms(sa, jobs, 2, none, smem);
      } else {
        Gemm jobs[2] = {hf, hr};
        run_gemms(sa, jobs, 2, none, smem);
      }
    }
    grid.sync();
    PHASE_MARK();
    // DE: logits of [hr; hf], their gradients, dh = [dhr; dhf]
    if constexpr (GP) {
      // beside the logit rows: wgangp g = u W1d^T, then (phase N) the
      // norm rows beside s = g W1d; dragan the norm rows and s at once
      const Gemm gj = {{a.dh + (size_t)2 * B * Hd, Hd, 1},
                       {a.p[P_D_W1], 1, Hd}, B, X, Hd, EPI_STORE, nullptr,
                       nullptr, a.gbuf, X, 0};
      const Gemm sj = {{a.gbuf, X, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, X,
                       EPI_STORE, nullptr, nullptr, a.sbuf, Hd, 0};
      if constexpr (HOOK == HOOK_GPW) {
        gp_rows(a, 0);
        run_gemms(sa, &gj, 1, none, smem, row_blocks(2 * B));
        grid.sync();
        PHASE_MARK();
        for (int r = gwarp; r < B; r += nwarps) norm_row(a, r);
        run_gemms(sa, &sj, 1, none, smem, row_blocks(B));
      } else {
        gp_rows(a, B);
        run_gemms(sa, &sj, 1, none, smem, row_blocks(3 * B));
      }
    } else if constexpr (INFO) {  // the head's L outputs a row
      float* const gs = smem + (threadIdx.x >> 5) * WARP_SMEM;
      for (int r = gwarp; r < 2 * B; r += nwarps)
        info_row(a, a.hd, r, r < B, false,
                 r < B ? nullptr : zd + (size_t)(r - B) * Z, a.gl, a.lg,
                 a.dh, r < B ? nullptr : a.mib + (r - B), gs);
    } else if constexpr (BEGAN) {
      {  // R: rec of [hr; hf], the logit gradient and |v - r|
        const Gemm rj = {{a.hd, Hd, 1}, {a.p[P_D_W2], X, 1}, 2 * B, X, Hd,
                         EPI_BGR, a.p[P_D_B2], a.xin, a.gl, X, 0};
        run_gemms(sa, &rj, 1, none, smem);
      }
      grid.sync();
      PHASE_MARK();
      {  // E: dh = g W2d^T * leaky'(h); beside it the rows of |v - r|
        const Gemm ej = {{a.gl, X, 1}, {a.p[P_D_W2], 1, X}, 2 * B, Hd, X,
                         EPI_BGD, nullptr, a.hd, a.dh, Hd, 0};
        for (int r = gwarp; r < 2 * B; r += nwarps) {
          float e = 0.0f;
          for (int n = lane; n < X; n += 32) e += ld(a.ab + (size_t)r * X + n);
          e = warp_sum(e);
          if (lane == 0) a.erow[r] = e;
        }
        run_gemms(sa, &ej, 1, none, smem, row_blocks(2 * B));
      }
    } else {
      logit_rows(a, a.hd, 2 * B, a.lg, a.gl, a.dh,
                 [&](int r, float l) { return d_grad(a, r < B, l); });
    }
    grid.sync();
    PHASE_MARK();
    if constexpr (INFO || BEGAN) {  // F: dW1d and dW2d = [hr; hf]^T gl;
      // db1d, db2d a block per 64 columns, the metrics on the block after
      // them, the tiles beside
      const int L = a.L;
      const int ncb = col_blocks(Hd + L);
      col_sums<1>(
          Hd + L, 2 * B, 0, smem,
          [&](int r, int v, float(&s)[1]) {
            s[0] += v < Hd ? ld(a.dh + (size_t)r * Hd + v)
                           : ld(a.gl + (size_t)r * L + (v - Hd));
          },
          [&](int v, float(&s)[1]) {
            if (v < Hd) update<true>(a, P_D_B1, v, s[0], none);
            else update<true>(a, P_D_B2, v - Hd, s[0], none);
          });
      if ((int)blockIdx.x == ncb && threadIdx.x < 32) {
        clear_lanes(a);
        critic_metrics(a, 0);
      }
      Gemm jobs[2] = {{{a.xin, 1, Xd}, {a.dh, Hd, 1}, Xd, Hd, 2 * B, EPI_OPT,
                       nullptr, nullptr, nullptr, Hd, P_D_W1},
                      {{a.hd, 1, Hd}, {a.gl, L, 1}, Hd, L, 2 * B, EPI_OPT,
                       nullptr, nullptr, nullptr, L, P_D_W2}};
      run_gemms(sa, jobs, 2, none, smem, ncb + 1);
    } else {  // F
      // a block per 64 columns (a lane a column, the warps over the rows):
      // dW2d and db1d for column v < Hd, db2d at v = Hd; the critic's
      // metrics on the block after them
      constexpr int NF = GP ? 3 : 2;
      const int ncb = col_blocks(Hd + 1);
      col_sums<NF>(
          Hd + 1, 2 * B, 0, smem,
          [&](int r, int v, float(&s)[NF]) {
            if (v < Hd) {
              const size_t o = (size_t)r * Hd + v;
              s[0] = fmaf(opnd(ld(a.hd + o)), opnd(ld(a.gl + r)), s[0]);
              s[1] += ld(a.dh + o);
              if constexpr (GP) {  // sum_i c_i leaky'(hh_i) s_i
                if (r < B) {
                  if constexpr (BF16)  // dotT_lhs(c dph s, lane0): one
                    s[NF - 1] += bf16r(  // rounded operand a term
                        (ld(a.nrm + B + r) * ld(a.dph + o)) * ld(a.sbuf + o));
                  else
                    s[NF - 1] = fmaf(ld(a.nrm + B + r) * ld(a.dph + o),
                                     ld(a.sbuf + o), s[NF - 1]);
                }
              }
            } else {
              s[1] += ld(a.gl + r);
            }
          },
          [&](int v, float(&s)[NF]) {
            if (v < Hd) {
              float dw = s[0];
              if constexpr (GP) dw += s[NF - 1];
              update<true>(a, P_D_W2, v, dw, none);
              update<true>(a, P_D_B1, v, s[1], none);
            } else {
              update<true>(a, P_D_B2, 0, s[1], none);
            }
          });
      if ((int)blockIdx.x == ncb && threadIdx.x < 32) {
        clear_lanes(a);
        critic_metrics(a, 0);
      }
      // dW1d = [x; fake]^T [dhr; dhf] (the penalty: K = 3B, [x; fake;
      // c g]^T [dhr; dhf; u]), beside them
      const Gemm job = {{a.xin, 1, Xd}, {a.dh, Hd, 1}, Xd, Hd,
                        GP ? 3 * B : 2 * B, EPI_OPT, nullptr, nullptr,
                        nullptr, Hd, P_D_W1};
      run_gemms(sa, &job, 1, none, smem, ncb + 1);
    }
    PHASE_END();
  } else {
    const float* zg = a.zg;
    {  // hg (cgan: fake2's label lanes, zg's)
      const Gemm job = {{zg, Z, 1}, {a.p[P_G_W1], H, 1}, B, H, Z, EPI_RELU,
                        a.p[P_G_B1], nullptr, a.hgg, H, 0};
      run_gemms(sa, &job, 1, none, smem);
      if constexpr (COND)
        for (int e = gtid; e < B * a.n_cls; e += gsz) {
          const int r = e / a.n_cls, j = e % a.n_cls;
          a.fk2[(size_t)r * Xd + X + j] =
              ld(zg + (size_t)r * Z + Z - a.n_cls + j);
        }
    }
    grid.sync();
    PHASE_MARK();
    {  // fake2
      const Gemm job = {{a.hgg, H, 1}, {a.p[P_G_W2], X, 1}, B, X, H,
                        EPI_SIGMOID, a.p[P_G_B2], nullptr, a.fk2, Xd, 0};
      run_gemms(sa, &job, 1, none, smem);
    }
    grid.sync();
    PHASE_MARK();
    {  // G1: hf2 through the critic
      const Gemm job = {{a.fk2, Xd, 1}, {a.p[P_D_W1], Hd, 1}, B, Hd, Xd,
                        EPI_LEAKY, a.p[P_D_B1], nullptr, a.hf2, Hd, 0};
      run_gemms(sa, &job, 1, none, smem);
    }
    grid.sync();
    PHASE_MARK();
    // G23: lf2, gl, dh2
    if constexpr (INFO) {  // G's rows: bce toward 1 and the MI
      float* const gs = smem + (threadIdx.x >> 5) * WARP_SMEM;
      for (int r = gwarp; r < B; r += nwarps)
        info_row(a, a.hf2, r, false, true, zg + (size_t)r * Z, a.gl2, a.lf2,
                 a.dh2, a.mib2 + r, gs);
    } else if constexpr (BEGAN) {
      {  // G2: rf2 of hf2; gl = -s2 rf2 (1 - rf2) and d2 = fake2 - rf2
        const Gemm rj = {{a.hf2, Hd, 1}, {a.p[P_D_W2], X, 1}, B, X, Hd,
                         EPI_BGG, a.p[P_D_B2], a.fk2, a.gl2, X, 0};
        run_gemms(sa, &rj, 1, none, smem);
      }
      grid.sync();
      PHASE_MARK();
      {  // G3: dh2 = gl W2d^T * leaky'(hf2); beside it the rows of |d2|
        const Gemm ej = {{a.gl2, X, 1}, {a.p[P_D_W2], 1, X}, B, Hd, X,
                         EPI_BGD, nullptr, a.hf2, a.dh2, Hd, 0};
        for (int r = gwarp; r < B; r += nwarps) {
          float e = 0.0f;
          for (int n = lane; n < X; n += 32)
            e += fabsf(ld(a.d2 + (size_t)r * X + n));
          e = warp_sum(e);
          if (lane == 0) a.erow2[r] = e;
        }
        run_gemms(sa, &ej, 1, none, smem, row_blocks(B));
      }
    } else {
      logit_rows(a, a.hf2, B, a.lf2, a.gl2, a.dh2,
                 [&](int, float l) { return g_grad(a, l); });
    }
    grid.sync();
    PHASE_MARK();
    {  // G4: dx = dh2 W1d^T -> gu2 = dx * fake2 * (1 - fake2); the metrics
       // row (cgan: G's X columns only; began: dx + s2, the direct L1 path)
      const Gemm job = {{a.dh2, Hd, 1}, {a.p[P_D_W1], 1, Hd}, B, X, Hd,
                        BEGAN ? EPI_BGX : EPI_SIGD, nullptr, a.fk2, a.gu2, Xd,
                        0};
      if ((int)blockIdx.x == (int)gridDim.x - 1 && threadIdx.x < 32) {
        clear_lanes(a);
        g_metrics(a, 0);
      }
      run_gemms(sa, &job, 1, none, smem);
    }
    grid.sync();
    PHASE_MARK();
    {  // G5: dhg = gu2 W2g^T * (hg > 0); beside it dW2g = hg^T gu2, and
       // db2g a block per 64 columns
      Gemm jobs[2] = {{{a.gu2, Xd, 1}, {a.p[P_G_W2], 1, X}, B, H, X,
                       EPI_RELUD, nullptr, a.hgg, a.dhg, H, 0},
                      {{a.hgg, 1, H}, {a.gu2, Xd, 1}, H, X, B, EPI_OPT,
                       nullptr, nullptr, nullptr, X, P_G_W2}};
      col_sums<1>(
          X, B, 0, smem,
          [&](int r, int v, float(&s)[1]) {
            s[0] += ld(a.gu2 + (size_t)r * Xd + v);
          },
          [&](int v, float(&s)[1]) {
            update<true>(a, P_G_B2, v, s[0], none);
          });
      run_gemms(sa, jobs, 2, none, smem, col_blocks(X));
    }
    grid.sync();
    PHASE_MARK();
    {  // G6: dW1g = zg^T dhg; db1g a block per 64 columns
      const Gemm job = {{zg, 1, Z}, {a.dhg, H, 1}, Z, H, B, EPI_OPT, nullptr,
                        nullptr, nullptr, H, P_G_W1};
      col_sums<1>(
          H, B, 0, smem,
          [&](int r, int v, float(&s)[1]) {
            s[0] += ld(a.dhg + (size_t)r * H + v);
          },
          [&](int v, float(&s)[1]) {
            update<true>(a, P_G_B1, v, s[0], none);
          });
      run_gemms(sa, &job, 1, none, smem, col_blocks(H));
    }
    PHASE_END();
  }
}

static const void* phase_kernel_of(int mode) {
  if (mode == M_D) return (const void*)gan_phase_kernel<M_D>;
  if (mode == M_G) return (const void*)gan_phase_kernel<M_G>;
  return nullptr;
}

// The phases of each mode, as tools/phase_trace.py names its marks
// (separated by ';').
extern "C" const char* gm_gan_phase_names(int mode) {
  if (mode == M_D)
    return HOOK == HOOK_GPW   ? "A;B (+x_hat);C (+hh);DE (+g);N (norms, s);F"
           : HOOK == HOOK_GPB ? "A (+hh);B;C (+g);DE (+norms, s);F"
           : BEGAN            ? "A;B;C;R rec;E dh;F"
                              : "A;B;C;DE;F";
  return BEGAN ? "hg;fake2;G1;G2 rf2;G3 dh2;G4;G5 (+dW2g);G6"
               : "hg;fake2;G1;G23;G4;G5 (+dW2g);G6";
}

// The hook this library was compiled for (GM_HOOK), and whether its
// products take bf16 operands (GM_BF16).
extern "C" int gm_gan_phase_hook() { return HOOK; }
extern "C" int gm_gan_phase_bf16() { return GM_BF16; }

extern "C" long long gm_gan_phase_scratch_floats(int B, int H, int X, int Hd,
                                                 int Xd, int L) {
  return scratch_floats(B, H, X, Hd, Xd, L);
}

// The blocks an SM holds of the mode's kernel (the occupancy query, at
// gm_gan_phase_smem_bytes of dynamic shared memory a block; 0 on failure),
// and those bytes.
extern "C" int gm_gan_phase_blocks_per_sm(int mode) {
  return chunk_occupancy(phase_kernel_of(mode));
}
extern "C" int gm_gan_phase_smem_bytes() { return SMEM_BYTES; }

// The fewest blocks a grid of the mode's kernel may have: every column
// sum's block (col_sums returns on the blocks past its columns and none
// takes a second), and D's metrics block, the one after them; on fewer,
// floats of the flat buffer would be left unwritten
// (ops/chunk_plan.py::dp_min_grid mirrors it).
extern "C" int gm_gan_phase_min_grid(int mode, int X, int H, int Hd, int L) {
  if (mode == M_D) return col_blocks(Hd + L) + 1;
  const int gx = col_blocks(X), gh = col_blocks(H);
  return gx > gh ? gx : gh;
}

// A launch plan: the arguments but the call's pointers, the kernel, its
// grid, and where each gradient and the metrics row sit in the caller's
// flat buffer (in floats).
struct PhasePlan {
  KArgs<true, false> a;
  const void* kernel;
  int grid, mode;
  long long off[5];
};

// The plan of the mode's kernel (1: D, 2: G) at these sizes (h->steps and
// h->ds 1, no EMA) with `scratch` (gm_gan_phase_scratch_floats floats,
// which the caller keeps for the plan's life) on the current device: the
// kernel's attributes set, its grid every SM's co-resident blocks (at
// most blocks_per_sm each). Null when the sizes do not fit the hook, the
// occupancy query fails or the grid is below gm_gan_phase_min_grid. A
// plan lives as long as the process.
extern "C" void* gm_gan_phase_plan(int mode, const GanChunkHyper* h,
                                   float* scratch, int blocks_per_sm) {
  const void* kernel = phase_kernel_of(mode);
  int dev = 0, sms = 0;
  if (!kernel || !scratch || blocks_per_sm < 1 || h->steps != 1 ||
      h->ds != 1 || h->ema || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return nullptr;
  PhasePlan* p = new PhasePlan();
  if (!set_args(p->a, nullptr, nullptr, nullptr, nullptr, scratch, nullptr,
                nullptr, h, false)) {
    delete p;
    return nullptr;
  }
  int occ = chunk_occupancy(kernel);
  if (occ > blocks_per_sm) occ = blocks_per_sm;
  p->kernel = kernel;
  p->grid = occ * sms;
  p->mode = mode;
  const long long Xd = h->Xd, L = h->L;
  const long long sz[4] = {
      mode == M_D ? Xd * h->Hd : (long long)h->Z * h->H,
      mode == M_D ? h->Hd : h->H,
      mode == M_D ? (long long)h->Hd * L : (long long)h->H * h->X,
      mode == M_D ? L : h->X};
  p->off[0] = 0;
  for (int q = 0; q < 4; ++q) p->off[q + 1] = p->off[q] + sz[q];
  if (p->grid < 1 ||
      p->grid < gm_gan_phase_min_grid(mode, h->X, h->H, h->Hd, h->L)) {
    delete p;
    return nullptr;
  }
  return p;
}

// The floats of the plan's flat buffer: the four gradients, then the
// LANES of the metrics row.
extern "C" long long gm_gan_phase_plan_floats(const void* plan) {
  return static_cast<const PhasePlan*>(plan)->off[4] + LANES;
}

// One launch of the plan's kernel on `stream`: mode 1 from x [B, Xd], zd
// [B, Z] (and xtra: gpw eps [B, 1], gpb x_hat [B, X]), mode 2 from zg [B,
// Z]; p0..p7 the parameters (g_w1 g_b1 g_w2 g_b2 d_w1 d_b1 d_w2 d_b2),
// read only; `flat` the output, every float of it written (the mode's
// four gradients at the plan's offsets, then the metrics row); the carried
// scalar (began's k) read from `lam`, or lam_v when `lam` is null. The
// current device must be the plan's. Allocates nothing, does not
// synchronise; returns the CUDA error code of the launch (0 = queued).
extern "C" int gm_gan_phase_run(const void* plan, const float* x,
                                const float* zd, const float* zg,
                                const float* xtra, const float* p0,
                                const float* p1, const float* p2,
                                const float* p3, const float* p4,
                                const float* p5, const float* p6,
                                const float* p7, float* flat,
                                const float* lam, float lam_v, void* stream) {
  const PhasePlan& pl = *static_cast<const PhasePlan*>(plan);
  KArgs<true, false> a = pl.a;
  const float* ps[N_PARAMS] = {p0, p1, p2, p3, p4, p5, p6, p7};
  for (int q = 0; q < N_PARAMS; ++q) {
    if (!ps[q]) return (int)cudaErrorInvalidValue;
    a.p[q] = const_cast<float*>(ps[q]);
  }
  if (!flat || (pl.mode == M_D ? !x || !zd || (GP && !xtra) : !zg))
    return (int)cudaErrorInvalidValue;
  a.xs = x;
  a.zd = zd;
  a.zg = zg;
  a.xtra = xtra;
  const int q0 = pl.mode == M_D ? P_D_W1 : P_G_W1;
  for (int q = 0; q < 4; ++q) a.gr[q0 + q] = flat + pl.off[q];
  a.metrics = flat + pl.off[4];
  a.lam = const_cast<float*>(lam);
  a.lam_v = lam_v;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      pl.kernel, dim3(pl.grid), dim3(CT), args, SMEM_BYTES,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
#else
// Every SM's co-resident blocks of `kernel`, at most blocks_per_sm each;
// 0 when the query fails.
static int grid_of(const void* kernel, int blocks_per_sm) {
  int dev = 0, sms = 0;
  if (!kernel || cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  int occ = chunk_occupancy(kernel);
  if (occ > blocks_per_sm) occ = blocks_per_sm;
  return occ * sms;
}

// One cooperative launch of `kernel` on `stream` (the grid no larger than
// what is co-resident, or the launch is refused); the CUDA error code.
static int launch(const void* kernel, Args& a, int grid, void* stream) {
  void* args[] = {&a};
  return chunk_launch(kernel, args, grid, stream);
}

// The Adam (rmsprop = 0) or RMSprop kernel, without or with (ema = 1) the
// G EMA plane.
static const void* kernel_of(int rmsprop, int ema) {
  if (ema)
    return rmsprop ? (const void*)gan_chunk_kernel<true, true>
                   : (const void*)gan_chunk_kernel<false, true>;
  return rmsprop ? (const void*)gan_chunk_kernel<true, false>
                 : (const void*)gan_chunk_kernel<false, false>;
}

// The hook this library was compiled for (GM_HOOK), and whether its
// products take bf16 operands (GM_BF16).
extern "C" int gm_gan_chunk_hook() { return HOOK; }
extern "C" int gm_gan_chunk_bf16() { return GM_BF16; }

// Floats of scratch a launch needs at these widths (the wrapper
// allocates it); see scratch_floats.
extern "C" long long gm_gan_chunk_scratch_floats(int B, int Z, int H, int X,
                                                 int Hd, int Xd, int L) {
  (void)Z;
  return scratch_floats(B, H, X, Hd, Xd, L);
}

// The grid a launch of the Adam (rmsprop = 0) or RMSprop kernel, with or
// without the EMA plane, uses: every SM's co-resident blocks, at most
// blocks_per_sm each. Returns 0 when the query fails.
extern "C" int gm_gan_chunk_grid(int blocks_per_sm, int rmsprop, int ema) {
  return grid_of(kernel_of(rmsprop, ema), blocks_per_sm);
}

// The blocks an SM holds of that kernel (the occupancy query, at
// gm_gan_chunk_smem_bytes of dynamic shared memory a block; 0 on
// failure), and those bytes.
extern "C" int gm_gan_chunk_blocks_per_sm(int rmsprop, int ema) {
  return chunk_occupancy(kernel_of(rmsprop, ema));
}
extern "C" int gm_gan_chunk_smem_bytes() { return SMEM_BYTES; }

// The product engine's tile class of an M x N x K job given nb blocks
// (chunk_common.cuh::tile_class; ops/chunk_plan.py mirrors it).
extern "C" int gm_gan_chunk_tile_class(int M, int N, int K, int nb) {
  return nb < 1 ? -1 : tile_class(M, N, K, nb);
}

// Launches one cooperative kernel on `stream` that runs `steps` outer
// steps and updates the 8 state tensors' planes (p, mu, nu: `state` holds
// 24 pointers, planes in that order, tensors g_w1 g_b1 g_w2 g_b2 d_w1
// d_b1 d_w2 d_b2; with RMSprop the mu pointers are null; with h->ema 4
// more, G's EMA plane g_w1 g_b1 g_w2 g_b2) and `lam` (one
// float: fishergan's multiplier, began's k_t) in place. `xtra` is the penalty's
// stream (gpw: eps [rows, 1]; gpb: x_hat [rows, X]), null for the other
// hooks; cgan's xs rows are Xd = X + n_cls wide and its zd, zg rows Z
// (G's input, the last n_cls the label); infogan's zd, zg rows are Z
// wide code rows (the last n_cat + n_cont lanes the codes), its W2d
// [Hd, L] the D and Q heads side by side; began's W2d is [Hd, X] (L = X).
// Allocates nothing, does not
// synchronise; returns the CUDA error code of the launch (0 = queued).
extern "C" int gm_gan_chunk(const float* xs, const float* zd, const float* zg,
                            const float* xtra, void* const* state,
                            float* scratch, float* metrics, float* lam,
                            const GanChunkHyper* h, int grid, void* stream) {
  Args a = {};
  if (grid < 1 || !kernel_of(h->rmsprop, h->ema) ||
      !set_args(a, xs, zd, zg, xtra, scratch, metrics, lam, h, true))
    return (int)cudaErrorInvalidValue;
  for (int q = 0; q < N_PARAMS; ++q) {
    a.p[q] = static_cast<float*>(state[q]);
    a.mu[q] = static_cast<float*>(state[N_PARAMS + q]);
    a.nu[q] = static_cast<float*>(state[2 * N_PARAMS + q]);
    if (!a.p[q] || !a.nu[q] || (!h->rmsprop && !a.mu[q]))
      return (int)cudaErrorInvalidValue;
  }
  for (int q = 0; h->ema && q < 4; ++q) {
    a.ema[q] = static_cast<float*>(state[3 * N_PARAMS + q]);
    if (!a.ema[q]) return (int)cudaErrorInvalidValue;
  }
  return launch(kernel_of(h->rmsprop, h->ema), a, grid, stream);
}
#endif
