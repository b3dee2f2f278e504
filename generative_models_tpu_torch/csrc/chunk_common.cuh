// What the whole-chunk training kernels share (gan_chunk.cu, vae_chunk.cu):
// the product engine, the column sums, Adam, the EMA step, the bf16
// operand rounding, and the warp sum.
//
// A kernel's argument struct `A` carries its state planes and Adam's
// constants: float* p[], mu[], nu[]; float b1, b2, omb1, omb2, eps,
// log_b1, log_b2. Each source defines epilogue<A> for its argument types
// before its kernel.
//
// What bounds these kernels on an H100 is latency, not operations: at
// B = 100 a step is ~12 products of 5-63 MFMA each, every one behind a
// grid barrier, so a product has ~1-3 us of FMA work spread over 132 SMs
// and every L2 round trip it waits for (~0.15-0.5 us, more under load) is
// a visible share of it. The engine below keeps loads in flight instead
// of waiting on them, and each choice was read off tools/chunk_phases.py
// on the card (PERF.md §6):
//
// - Products: a phase's jobs are cut into output tiles of one of four
//   classes (T1 64x64, T2 32x64, T4 16x64, T8 16x32; tile_class() picks
//   one a job, a rule that ops/chunk_plan.py mirrors), so that a phase's
//   tiles fill the grid in one round. The block's 8 warps form KS groups
//   that split the depth (group v takes the 16-deep stages v, v + KS,
//   ...), each group's warps a grid of 16x32 warp tiles, and each group
//   streams its stages through a ring of NS stages in shared memory (NS -
//   1 stages in flight while one is computed). A stage is copied with
//   16-byte cp.async.cg along whichever index of the operand is
//   contiguous in device memory, into shared memory laid out the same way
//   (4-byte copies only where rows are not 16-byte aligned). The ring runs
//   on across the block's tiles, so the next tile's first stages load
//   while this one computes its last stage, sums the groups' partials (in
//   group order, through shared memory) and runs its epilogue.
// - Epilogues take a thread's elements four at a time and load every
//   operand of the four (the optimizer's planes, a bias row, an aux
//   operand) before the first store: one element after another, each
//   element's loads waited behind the stores of the one before (they may
//   alias), which cost the Adam phases ~10 us each.
// - The tile walker is one function a class and kernel (not inlined: 21
//   inlined call sites made a library build for over 25 minutes); it reads
//   the kernel's arguments from a copy in shared memory.
// - The tiles of a phase go to its blocks in a snake order (round r to
//   blocks 0.. when r is even and back from the last block when odd), so a
//   second round lands on the blocks that had the light tiles.
// - The column sums (bias gradients, dW2d) are one block per 64 columns,
//   a lane two columns, the 8 warps splitting the rows, summed in warp
//   order: each load is a warp's 128 contiguous bytes, not a lane's own
//   sector. They run on blocks of their own beside the phase's tiles.
// - One 256-thread block an SM, 255 registers a thread (at two blocks and
//   128 registers every kernel spilled), SMEM_BYTES of dynamic shared
//   memory and a carveout no larger than that, the rest L1.
//
// Built with -DGM_BF16=1 (a library of its own), every product takes its
// two operands rounded to bfloat16 (round to nearest even) and sums them
// in float32, as the TPU kernels' Config.dtype="bfloat16" path
// (pallas_train.py::_make_dots, pallas_dp.py:128,214): the tiles multiply
// on the tensor cores (mma.sync m16n8k16, bf16 operands rounded as they
// are packed from shared memory, float32 accumulators), and a source's own
// row-warp products round through opnd(). A product of two bf16 values is
// exact in float32, so only the order of the float32 sums differs from the
// reference. The float32 builds multiply on the FMA pipes (no TF32).
// Elementwise work stays float32.
//
// Every output element has one owner and every sum a fixed order (a
// group's stages in order, the groups' partials in group order), so a run
// is bitwise deterministic.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GM_BF16
#define GM_BF16 0
#endif
constexpr bool BF16 = GM_BF16 != 0;

#define CT 256               // threads a block
#define WARPS (CT / 32)
#define SK 16                // depth of a stage
#define MAXJ 4               // product jobs a phase
#define WARP_SMEM 512        // floats of a warp's scratch in row phases
// Blocks an SM the launch bounds ask for: one, so a thread may take 255
// registers. At two (128 registers) every chunk kernel spilled 100-430
// bytes, and its row phases slowed by the spill reloads (PERF.md §6).
constexpr int MIN_BLOCKS = 1;

struct Mat {  // element (i, j) at p[i * rs + j * cs]
  const float* p;
  int rs, cs;
};

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

// A tile class: TM x TN output tiles; the 8 warps in KS groups that split
// the depth, each group's GW warps a (TM/16) x (TN/32) grid of 16x32 warp
// tiles; a group's ring holds NS stages. An operand's stage is kept with
// its contiguous index contiguous in shared memory: depth-contiguous rows
// [TM or TN][LDK] when its depth is contiguous in device memory, else
// rows of depth [SK][TM or TN + 4] (rows padded by 4 floats: 16-byte
// aligned, and the warps' reads fall in distinct banks).
#define LDK (SK + 4)
template <int TM_, int TN_, int KS_, int NS_>
struct Tile {
  static constexpr int TM = TM_, TN = TN_, KS = KS_, NS = NS_;
  static constexpr int WN = TN / 32, GW = (TM / 16) * WN, GT = GW * 32;
  static constexpr int LDA = TM + 4, LDB = TN + 4;
  static constexpr int A_FLOATS = SK * LDA > TM * LDK ? SK * LDA : TM * LDK;
  static constexpr int B_FLOATS = SK * LDB > TN * LDK ? SK * LDB : TN * LDK;
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr int RING = NS * STAGE;
  static constexpr int PER = TM * TN / CT;  // elements a thread finishes
  static_assert(GW * KS == WARPS, "a class's groups are the block's warps");
  static_assert((TM * SK / 4) % GT == 0 && (TN * SK / 4) % GT == 0,
                "a stage's 16-byte vectors divide among a group's threads");
};
using T1 = Tile<64, 64, 1, 4>;
using T2 = Tile<32, 64, 2, 4>;
using T4 = Tile<16, 64, 4, 3>;
using T8 = Tile<16, 32, 8, 3>;
constexpr int N_CLASSES = 4;  // class ids 0 (T1), 1 (T2), 2 (T4), 3 (T8)

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int RING_FLOATS =
    cmax(cmax(T1::KS * T1::RING, T2::KS * T2::RING),
         cmax(T4::KS * T4::RING, T8::KS * T8::RING));
constexpr int RED_FLOATS =
    cmax(cmax(T1::KS * T1::TM * T1::TN, T2::KS * T2::TM * T2::TN),
         cmax(T4::KS * T4::TM * T4::TN, T8::KS * T8::TM * T8::TN));
// the dynamic shared memory of a block: the rings, then the partial tiles
constexpr int SMEM_BYTES = (RING_FLOATS + RED_FLOATS) * 4;
static_assert(WARPS * WARP_SMEM <= RING_FLOATS, "row scratch fits");

// The tile class of a job of M x N x K whose phase gives it `nb` blocks:
// the class with the least rounds x (stages a group + 2), the larger tile
// on a tie. ops/chunk_plan.py::tile_class is this rule.
__host__ __device__ inline int tile_class(int M, int N, int K, int nb) {
  const int tm[N_CLASSES] = {T1::TM, T2::TM, T4::TM, T8::TM};
  const int tn[N_CLASSES] = {T1::TN, T2::TN, T4::TN, T8::TN};
  const int ks[N_CLASSES] = {T1::KS, T2::KS, T4::KS, T8::KS};
  const int st = (K + SK - 1) / SK;
  int best = 0, best_cost = -1;
  for (int c = 0; c < N_CLASSES; ++c) {
    const int tiles = ((M + tm[c] - 1) / tm[c]) * ((N + tn[c] - 1) / tn[c]);
    const int cost = ((tiles + nb - 1) / nb) * ((st + ks[c] - 1) / ks[c] + 2);
    if (best_cost < 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best;
}

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

// One Adam step of an element from its moments m0, v0 and parameter p0
// with gradient g: the new moments into m, v; returns the new parameter.
template <class A>
__device__ __forceinline__ float adam_step(const A& a, const AdamT& t,
                                           float g, float m0, float v0,
                                           float p0, float& m, float& v) {
  m = a.b1 * m0 + a.omb1 * g;
  v = a.b2 * v0 + (a.omb2 * g) * g;
  const float mhat = m / t.bc1;
  const float vhat = v / t.bc2;
  return p0 - (t.lr * mhat) / (sqrtf(vhat) + a.eps);
}

// One Adam step on element i of state tensor q; returns the new
// parameter (for an EMA plane).
template <class A>
__device__ __forceinline__ float adam(const A& a, int q, size_t i, float g,
                                      const AdamT& t) {
  float m, v;
  const float p = adam_step(a, t, g, ld(a.mu[q] + i), ld(a.nu[q] + i),
                            ld(a.p[q] + i), m, v);
  a.mu[q][i] = m;
  a.nu[q][i] = v;
  a.p[q][i] = p;
  return p;
}

// A batch of an epilogue's elements (m[k], n[k]) with products c[k],
// those with ok[k]: the engine hands a thread's elements over EB at a
// time, so that an epilogue can load every operand of the batch before
// its first store (a store may alias a later load, which otherwise
// chained each element's loads behind the element before).
#define EB_MAX 4

// What becomes of a batch of a job's product elements (see EB_MAX):
// each source defines this for its argument types.
template <int EB, class A>
__device__ __forceinline__ void epilogue(const A& a, const Gemm& g,
                                         const int (&m)[EB],
                                         const int (&n)[EB],
                                         const float (&c)[EB],
                                         const bool (&ok)[EB],
                                         const AdamT& at);

// ---------------------------------------------------------------------
// cp.async: 16 bytes from L2 (.cg, past L1), or 4 bytes through L1 (.ca)
// where an operand's rows are not 16-byte aligned; src-size zero-fills the
// rest. Every line read here was written before the last grid barrier,
// whose spin ends in an L1 invalidation (see gan_chunk.cu's Design).

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The barrier of a class's depth group: a warp, or its GW warps.
template <class C>
__device__ __forceinline__ void group_sync(int grp) {
  if constexpr (C::GW == 1) {
    __syncwarp();
  } else if constexpr (C::GW == WARPS) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(C::GT));
  }
}

// Two floats as a bf16x2 word (round to nearest even): lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------
// The phase's product table, in shared memory: the jobs, each one's tile
// class and tiles across N, and where its tiles start.
struct PhaseTab {
  Gemm job[MAXJ];
  int cls[MAXJ];
  int tiles_n[MAXJ];
  int start[MAXJ + 1];
  int nj;
};

// A depth group's place in the block's walk over its tiles of one class.
struct Cur {
  int r;    // the round
  int t;    // the tile's number in the phase (-1: past the last)
  int j;    // its job
  int cnt;  // the stages this group takes of it
  int k;    // the next of them
};

template <class C, int CLS>
__device__ __forceinline__ void cur_seek(Cur& c, const PhaseTab& pt, int blk,
                                         int nb, int grp, bool skip_empty) {
  const int total = pt.start[pt.nj];
  for (;;) {
    const int t = c.r * nb + ((c.r & 1) ? nb - 1 - blk : blk);
    if (c.r * nb >= total) {
      c.t = -1;
      return;
    }
    ++c.r;
    if (t >= total) continue;
    int j = 0;
    while (t >= pt.start[j + 1]) ++j;
    if (pt.cls[j] != CLS) continue;
    const int st = (pt.job[j].K + SK - 1) / SK;
    const int cnt = st > grp ? (st - grp + C::KS - 1) / C::KS : 0;
    if (skip_empty && cnt == 0) continue;
    c.t = t;
    c.j = j;
    c.cnt = cnt;
    c.k = 0;
    return;
  }
}

// One operand's stage into shared memory: TR rows along its outer index
// (A's m, B's n: rows r0.., stride so, R of them) by SK of depth (k0..,
// stride sk, K of it), as the thread's VN 16-byte vectors along the
// contiguous index (depth-contiguous rows [TR][LDK] when dc, which needs
// sk == 1, else rows of depth [SK][TR + 4]); 4-byte copies where the rows
// are not 16-byte aligned. Zero past every edge.
template <int TR, int GT>
__device__ __forceinline__ void load_operand(const float* p, int so, int sk,
                                             int R, int K, int r0, int k0,
                                             bool dc, float* dst, int gt) {
  constexpr int VN = TR * SK / 4 / GT;
  const bool al = ((uintptr_t)p & 15) == 0;
  if (dc) {  // depth-contiguous
    const bool vec = al && so % 4 == 0;
#pragma unroll
    for (int q = 0; q < VN; ++q) {
      const int v = gt + q * GT, rr = v >> 2, kv = (v & 3) * 4;
      const int r = r0 + rr, k = k0 + kv;
      float* d = dst + rr * LDK + kv;
      if (vec) {
        const int n = r < R ? min(max(K - k, 0), 4) : 0;
        cp_async16(d, p + (n ? (size_t)r * so + k : 0), 4 * n);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = r < R && k + e < K;
          cp_async4(d + e, p + (ok ? (size_t)r * so + k + e : 0), ok);
        }
      }
    }
  } else {  // rows of depth
    constexpr int VR = TR / 4;
    const bool vec = al && so == 1 && sk % 4 == 0;
#pragma unroll
    for (int q = 0; q < VN; ++q) {
      const int v = gt + q * GT, kk = v / VR, rv = (v % VR) * 4;
      const int r = r0 + rv, k = k0 + kk;
      float* d = dst + kk * (TR + 4) + rv;
      if (vec) {
        const int n = k < K ? min(max(R - r, 0), 4) : 0;
        cp_async16(d, p + (n ? (size_t)k * sk + r : 0), 4 * n);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = k < K && r + e < R;
          cp_async4(d + e,
                    p + (ok ? (size_t)(r + e) * so + (size_t)k * sk : 0), ok);
        }
      }
    }
  }
}

// The job's layouts: A depth-contiguous when its k is contiguous, B when
// its k is and its n is not (bit 1 A, bit 0 B).
__device__ __forceinline__ int layouts(const Gemm& g) {
  return (g.a.cs == 1 ? 2 : 0) + (g.b.rs == 1 && g.b.cs != 1 ? 1 : 0);
}

// Stage s of the tile at (m0, n0) of job g into a ring slot: A (M rows of
// K) then B (N rows of K: its n index outer), in the job's layouts.
template <class C>
__device__ __forceinline__ void load_stage(const Gemm& g, int m0, int n0,
                                           int s, float* dst, int gt) {
  const int lay = layouts(g);
  load_operand<C::TM, C::GT>(g.a.p, g.a.rs, g.a.cs, g.M, g.K, m0, s * SK,
                             lay & 2, dst, gt);
  load_operand<C::TN, C::GT>(g.b.p, g.b.cs, g.b.rs, g.N, g.K, n0, s * SK,
                             lay & 1, dst + C::A_FLOATS, gt);
}

// One stage of a warp's 16x32 tile into acc, A and B in the layouts
// load_operand chose (AD, BD: depth-contiguous). float32 builds: FMAs, lane
// (rg, cg) = (lane / 8, lane % 8) keeping rows arow(i) and columns bcol(j)
// in acc[4 i + j] (each read a 16-byte shared load, the banks distinct),
// the depth summed in order; bf16 builds: four m16n8k16 tensor-core
// products, the n8 block nb in acc[4 nb ..], rows g and g + 8, columns
// 2 t, 2 t + 1 (g = lane / 4, t = lane % 4).
template <class C, bool AD, bool BD>
__device__ __forceinline__ int arow(int lane, int i) {
  return AD ? (lane >> 3) + 4 * i : 4 * (lane >> 3) + i;
}
template <class C, bool AD, bool BD>
__device__ __forceinline__ int bcol(int lane, int j) {
  return BD ? (lane & 7) + 8 * j : 4 * (lane & 7) + j;
}

template <class C, bool AD, bool BD>
__device__ __forceinline__ void mma_stage(const float* As, const float* Bs,
                                          int wm, int wn, int lane,
                                          float (&acc)[16]) {
  if constexpr (!BF16) {
#pragma unroll
    for (int k4 = 0; k4 < SK; k4 += 4) {
      float ar[4][4], br[4][4];  // [row][depth], [depth][column]
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 av =
            AD ? *reinterpret_cast<const float4*>(
                     As + (wm * 16 + arow<C, AD, BD>(lane, u)) * LDK + k4)
               : *reinterpret_cast<const float4*>(
                     As + (k4 + u) * C::LDA + wm * 16 + arow<C, AD, BD>(lane, 0));
        const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          if (AD) ar[u][w] = a4[w];
          else ar[w][u] = a4[w];
        }
        const float4 bv =
            BD ? *reinterpret_cast<const float4*>(
                     Bs + (wn * 32 + bcol<C, AD, BD>(lane, u)) * LDK + k4)
               : *reinterpret_cast<const float4*>(
                     Bs + (k4 + u) * C::LDB + wn * 32 + bcol<C, AD, BD>(lane, 0));
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          if (BD) br[w][u] = b4[w];
          else br[u][w] = b4[w];
        }
      }
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[4 * i + j] = fmaf(ar[i][kq], br[kq][j], acc[4 * i + j]);
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    // element (row, depth) of A and (depth, column) of B in shared memory
    auto a_at = [&](int r, int k) {
      return AD ? As[(wm * 16 + r) * LDK + k] : As[k * C::LDA + wm * 16 + r];
    };
    auto b_at = [&](int k, int c) {
      return BD ? Bs[(wn * 32 + c) * LDK + k] : Bs[k * C::LDB + wn * 32 + c];
    };
    const uint32_t a0 = pack_bf16(a_at(g, 2 * t), a_at(g, 2 * t + 1));
    const uint32_t a1 = pack_bf16(a_at(g + 8, 2 * t), a_at(g + 8, 2 * t + 1));
    const uint32_t a2 = pack_bf16(a_at(g, 2 * t + 8), a_at(g, 2 * t + 9));
    const uint32_t a3 =
        pack_bf16(a_at(g + 8, 2 * t + 8), a_at(g + 8, 2 * t + 9));
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const uint32_t b0 =
          pack_bf16(b_at(2 * t, nb * 8 + g), b_at(2 * t + 1, nb * 8 + g));
      const uint32_t b1 =
          pack_bf16(b_at(2 * t + 8, nb * 8 + g), b_at(2 * t + 9, nb * 8 + g));
      float* d = acc + 4 * nb;
      asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
}

// acc (see mma_stage) into the group's partial tile red [TM][TN].
template <class C, bool AD, bool BD>
__device__ __forceinline__ void store_partial(float* red, int wm, int wn,
                                              int lane, const float (&acc)[16]) {
  if constexpr (!BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        red[(wm * 16 + arow<C, AD, BD>(lane, i)) * C::TN + wn * 32 +
            bcol<C, AD, BD>(lane, j)] = acc[4 * i + j];
  } else {
    const int g = lane >> 2, t = lane & 3;
    float* p = red + (wm * 16 + g) * C::TN + wn * 32 + 2 * t;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      *reinterpret_cast<float2*>(p + nb * 8) =
          make_float2(acc[4 * nb], acc[4 * nb + 1]);
      *reinterpret_cast<float2*>(p + 8 * C::TN + nb * 8) =
          make_float2(acc[4 * nb + 2], acc[4 * nb + 3]);
    }
  }
}

template <class C>
__device__ __forceinline__ void mma_stage_any(int lay, const float* As,
                                              const float* Bs, int wm, int wn,
                                              int lane, float (&acc)[16]) {
  switch (lay) {
    case 3: mma_stage<C, true, true>(As, Bs, wm, wn, lane, acc); break;
    case 2: mma_stage<C, true, false>(As, Bs, wm, wn, lane, acc); break;
    case 1: mma_stage<C, false, true>(As, Bs, wm, wn, lane, acc); break;
    default: mma_stage<C, false, false>(As, Bs, wm, wn, lane, acc); break;
  }
}

template <class C>
__device__ __forceinline__ void store_partial_any(int lay, float* red, int wm,
                                                  int wn, int lane,
                                                  const float (&acc)[16]) {
  switch (lay) {
    case 3: store_partial<C, true, true>(red, wm, wn, lane, acc); break;
    case 2: store_partial<C, true, false>(red, wm, wn, lane, acc); break;
    case 1: store_partial<C, false, true>(red, wm, wn, lane, acc); break;
    default: store_partial<C, false, false>(red, wm, wn, lane, acc); break;
  }
}

// Every tile of class CLS that falls to this block (blk of the nb tile
// blocks), in order, through one ring a depth group that runs on from tile
// to tile; each tile's partials summed in group order, then its epilogue.
// Not inlined: one copy a class and kernel, however many phases call it
// (`a` is the kernel's copy of its arguments in shared memory: the
// epilogue reads them at every element, and through a pointer to the
// kernel's parameters each read was a slow generic load).
template <class C, int CLS, class A>
__device__ __noinline__ void walk_tiles(const A& a, const PhaseTab& pt,
                                        AdamT at, float* smem, int blk,
                                        int nb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / C::GW, gw = warp % C::GW;
  const int wm = gw / C::WN, wn = gw % C::WN;
  const int gt = threadIdx.x % C::GT;
  float* const ring = smem + grp * C::RING;
  float* const red = smem + RING_FLOATS;

  Cur pc = {0, 0, 0, 0, 0}, cc = {0, 0, 0, 0, 0};
  cur_seek<C, CLS>(pc, pt, blk, nb, grp, true);
  cur_seek<C, CLS>(cc, pt, blk, nb, grp, false);
  int issued = 0, used = 0;
  // the producer: the group's next stage into the ring (an empty group of
  // copies past the last, so that the waits count alike)
  auto issue = [&]() {
    if (pc.t >= 0) {
      const Gemm g = pt.job[pc.j];  // in registers for the copies
      const int tile = pc.t - pt.start[pc.j];
      const int tn = pt.tiles_n[pc.j];
      load_stage<C>(g, (tile / tn) * C::TM, (tile % tn) * C::TN,
                    grp + pc.k * C::KS, ring + (issued % C::NS) * C::STAGE,
                    gt);
      ++issued;
      if (++pc.k == pc.cnt) cur_seek<C, CLS>(pc, pt, blk, nb, grp, true);
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int i = 0; i < C::NS - 1; ++i) issue();

  while (cc.t >= 0) {
    const Gemm g = pt.job[cc.j];
    const int lay = layouts(g);
    const int tile = cc.t - pt.start[cc.j];
    const int tn = pt.tiles_n[cc.j];
    const int m0 = (tile / tn) * C::TM, n0 = (tile % tn) * C::TN;
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
#pragma unroll 1
    for (int k = 0; k < cc.cnt; ++k) {
      cp_async_wait<C::NS - 2>();
      group_sync<C>(grp);  // the stage is in; the slot refilled below is free
      issue();
      const float* As = ring + (used % C::NS) * C::STAGE;
      mma_stage_any<C>(lay, As, As + C::A_FLOATS, wm, wn, lane, acc);
      ++used;
    }
    __syncthreads();  // every thread is done with the previous tile's sums
    store_partial_any<C>(lay, red + grp * C::TM * C::TN, wm, wn, lane, acc);
    __syncthreads();
    constexpr int EB = C::PER < EB_MAX ? C::PER : EB_MAX;
#pragma unroll 1
    for (int e0 = 0; e0 < C::PER; e0 += EB) {
      int mb[EB], nb_[EB];
      float cb[EB];
      bool ok[EB];
#pragma unroll
      for (int k = 0; k < EB; ++k) {
        const int o = threadIdx.x + (e0 + k) * CT;
        const int mm = o / C::TN, nn = o % C::TN;
        float c = 0.0f;
#pragma unroll
        for (int v = 0; v < C::KS; ++v)
          c += red[(v * C::TM + mm) * C::TN + nn];
        mb[k] = m0 + mm;
        nb_[k] = n0 + nn;
        cb[k] = c;
        ok[k] = mb[k] < g.M && nb_[k] < g.N;
      }
      epilogue<EB>(a, g, mb, nb_, cb, ok, at);
    }
    cur_seek<C, CLS>(cc, pt, blk, nb, grp, false);
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings and the partial tiles are free again
}

// The phase's product jobs on blocks first.. of the grid (blocks before
// `first` do the phase's row or column work; all blocks take tiles when
// the grid has no blocks to spare). Each job's tile class comes from
// tile_class with the job's share of the tile blocks by its M N K.
template <class A>
__device__ __forceinline__ void run_gemms(const A& a, const Gemm* jobs,
                                          int n, const AdamT& at, float* smem,
                                          int first = 0) {
  __shared__ PhaseTab pt;
  if (first >= (int)gridDim.x) first = 0;
  if ((int)blockIdx.x < first) return;
  const int nb = gridDim.x - first, blk = blockIdx.x - first;
  __syncthreads();  // every thread is done reading the last phase's table
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
      if (j < n) pt.job[j] = jobs[j];
    pt.nj = n;
  }
  __syncthreads();
  if ((int)threadIdx.x < n) {  // a thread a job: its class by its share
    const Gemm& g = pt.job[threadIdx.x];
    int share = nb;  // one job: all of them (what the share below gives)
    if (n > 1) {
      double work = 0.0;
      for (int j = 0; j < n; ++j)
        work += (double)pt.job[j].M * pt.job[j].N * pt.job[j].K;
      share = work > 0.0
                  ? (int)((double)nb * ((double)g.M * g.N * g.K) / work)
                  : nb;
    }
    const int c = tile_class(g.M, g.N, g.K, share > 0 ? share : 1);
    const int tm = c == 0 ? T1::TM : c == 1 ? T2::TM : c == 2 ? T4::TM : T8::TM;
    const int tn = c == 0 ? T1::TN : c == 1 ? T2::TN : c == 2 ? T4::TN : T8::TN;
    pt.cls[threadIdx.x] = c;
    pt.tiles_n[threadIdx.x] = (g.N + tn - 1) / tn;
    pt.start[threadIdx.x + 1] = ((g.M + tm - 1) / tm) * pt.tiles_n[threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the counts into where each job's tiles start
    pt.start[0] = 0;
    for (int j = 0; j < n; ++j) pt.start[j + 1] += pt.start[j];
  }
  __syncthreads();
  int has = 0;  // the classes the phase's jobs took
  for (int j = 0; j < n; ++j) has |= 1 << pt.cls[j];
  if (has & 1) walk_tiles<T1, 0>(a, pt, at, smem, blk, nb);
  if (has & 2) walk_tiles<T2, 1>(a, pt, at, smem, blk, nb);
  if (has & 4) walk_tiles<T4, 2>(a, pt, at, smem, blk, nb);
  if (has & 8) walk_tiles<T8, 3>(a, pt, at, smem, blk, nb);
}

// The kernel's arguments into its shared copy, a word a thread (a copy of
// the whole struct by one thread held it all in registers at once).
template <class A>
__device__ __forceinline__ void copy_args(A& dst, const A& src) {
  static_assert(sizeof(A) % 4 == 0, "the arguments are whole words");
  const int* s = reinterpret_cast<const int*>(&src);
  int* d = reinterpret_cast<int*>(&dst);
  for (int w = threadIdx.x; w < (int)(sizeof(A) / 4); w += CT) d[w] = s[w];
  __syncthreads();
}

// The blocks a phase's rows take when each of its warps takes a row.
__device__ __forceinline__ int row_blocks(int rows) {
  return (rows + WARPS - 1) / WARPS;
}

// The blocks col_sums takes for `cols` columns.
__host__ __device__ __forceinline__ int col_blocks(int cols) {
  return (cols + 63) / 64;
}

// NS column sums of `rows` rows for each of `cols` columns, by blocks
// b0 .. b0 + col_blocks(cols) - 1 of the grid: block b0 + c takes columns
// 64 c .. 64 c + 63, a lane two columns 32 apart; term(r, v, s) adds row
// r's terms of column v to s[0..NS-1]; warp w takes rows w, w + 8, ... in
// order and the 8 warps' partials are summed in warp order; then warp 0's
// lanes run fin(v, s) for their columns.
template <int NS, class Term, class Fin>
__device__ __forceinline__ void col_sums(int cols, int rows, int b0,
                                         float* smem, Term term, Fin fin) {
  const int c = (int)blockIdx.x - b0;
  if (c < 0 || c >= col_blocks(cols)) return;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int v0 = c * 64 + lane, v1 = v0 + 32;
  float s0[NS], s1[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) s0[i] = s1[i] = 0.0f;
#pragma unroll 1
  for (int r = w; r < rows; r += WARPS) {
    if (v0 < cols) term(r, v0, s0);
    if (v1 < cols) term(r, v1, s1);
  }
  __syncthreads();  // the scratch is free
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    smem[((2 * i) * WARPS + w) * 32 + lane] = s0[i];
    smem[((2 * i + 1) * WARPS + w) * 32 + lane] = s1[i];
  }
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
      for (int u = 0; u < WARPS; ++u) {
        t0 += smem[((2 * i) * WARPS + u) * 32 + lane];
        t1 += smem[((2 * i + 1) * WARPS + u) * 32 + lane];
      }
      s0[i] = t0;
      s1[i] = t1;
    }
    if (v0 < cols) fin(v0, s0);
    if (v1 < cols) fin(v1, s1);
  }
  __syncthreads();
}

// Host side: the blocks an SM holds of a chunk kernel at SMEM_BYTES of
// dynamic shared memory a block (0 when the query fails), and one
// cooperative launch of it on `stream` (the grid no larger than what is
// co-resident, or the launch is refused): the CUDA error code.
// The kernel's shared memory attributes: SMEM_BYTES of dynamic shared
// memory, and a carveout of the SM's 228 KB no larger than the blocks an
// SM holds need (the rest stays L1, which the row phases, the column sums
// and the epilogues' loads use; left unset, the CUDA runtime took the
// most).
static cudaError_t chunk_attributes(const void* kernel) {
  const int need = MIN_BLOCKS * (SMEM_BYTES + 3072);  // + static, reserved
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (need * 100 + 233471) / 233472);
}

static int chunk_occupancy(const void* kernel) {
  int occ = 0;
  if (!kernel || chunk_attributes(kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, CT,
                                                    SMEM_BYTES) != cudaSuccess)
    return 0;
  return occ;
}

static int chunk_launch(const void* kernel, void** args, int grid,
                        void* stream) {
  cudaError_t e = chunk_attributes(kernel);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(CT), args,
                                    SMEM_BYTES,
                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
