// The row chain shared by the whole-MLP forward (mlp_fwd.cu) and the
// backward's g chain (mlp_bwd.cu, pass 1), for Hopper (sm_90a).
//
// A chain is a stack of products that one row tile carries from layer to
// layer: chain layer i takes the tile's input [TM, D_i] from shared
// memory and produces its output [TM, O_i], which is the next layer's
// input. The forward runs x -> h_1 -> ... -> out through W_l [D, O]
// (act(h W + b)); the backward runs g_{n-1} -> g_{n-2} -> ... -> dx
// through W_l^T (g W^T, times act' of the forward's hidden).
//
// Work split. A thread-block cluster of C CTAs owns one tile of TM rows.
// Every CTA holds the whole input tile in shared memory (two buffers that
// alternate between the layers) and computes one slice of each layer's
// output columns: the layer's O columns are cut into groups of 4, and
// rank c of the cluster takes groups [c*G/C, (c+1)*G/C). It stores its
// slice to device memory and into every CTA's next-layer buffer through
// distributed shared memory, and one cluster barrier a layer publishes
// it. Inside a CTA an item is TR rows (rg, rg + RG, ...) by 8 columns,
// one thread's register tile of TR x 8 float32 accumulators: forward,
// the column groups p and p + H of the slice (H = half its groups, so
// neighbouring lanes read neighbouring float4 of W); backward, the
// slice's columns p + H c, c < 8. A warp covers 4 (2, 1) row groups by 8
// (16, 32) column pairs, so each of its float4 reads of W or of the input
// tile touches at most 8 distinct addresses of one row or 4 rows.
//
// W is streamed, never held whole: its rows (forward) or columns
// (backward) for the CTA's slice arrive in chunks of KC along the
// product's depth, through a ring of CH_STAGES slots filled with
// cp.async by fixed thread-to-element maps. The ring runs across layer
// boundaries, so the next layer's first chunks are in flight while a
// layer's epilogue and the cluster barrier run. Each thread reads both
// operands from shared memory as float4, and the next 4-deep step's
// fragments load while this step's FMAs run: per step an item takes TR
// reads of the input tile and 8 of W for 32 TR FMAs.
//
// Streamed mode (large batches). Holding the whole input tile caps TM
// (G's 128 + 400 floats a row leave room for ~64 rows), and the full
// tile is what each CTA stages. With `stream`, no tile is resident: each
// ring slot carries the W chunk and the matching A chunk [TM][KC] of the
// layer's input, read back from device memory (the forward stores every
// h_l there anyway; the backward every g_l), and the cluster barrier
// between layers follows a fence instead of the remote writes. The ring
// then restarts at each layer, because the next layer's input is this
// layer's output.
//
// Layouts in shared memory:
//   input tiles  [TM][stride]  stride = round4(D) (+4 if a multiple of 16:
//                              four neighbouring rows on distinct banks)
//   forward W    [KC][4 Gc]    row k, the slice's columns (Gc groups at
//                              most, rounded up to even)
//   backward W   [4 Gc][KC+4]  W^T read as rows of W: lanes of a warp read
//                              consecutive rows, KC+4 floats apart (no bank
//                              conflicts); a layer thousands of inputs wide
//                              (the conv stacks' 6272) fits four slots only
//                              at KC 8 (ops/cuda_mlp.py WIDE_CHUNK_DEPTHS)
//   A chunk      [TM][KC+4]    streamed mode, after the W chunk in a slot
// With bf16 != 0 every operand is rounded to bfloat16 where it enters
// shared memory (the input tile when written, each ring slot in place
// once it has landed), and the sums stay float32.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define CH_MAX_LAYERS 8
#define CH_THREADS 256
#define CH_WARPS 8    // warps a CTA
#define CH_STAGES 4   // W chunks in the ring

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY_RELU = 2, ACT_SIGMOID = 3,
       ACT_TANH = 4 };

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

// Row stride (floats) of an input tile `width` wide: 16-byte rows, and
// four neighbouring rows' float4 on distinct banks (the stride is not
// 0 or 16 modulo 32).
__host__ __device__ __forceinline__ int tile_stride(int width) {
  const int s = round4(width);
  return (s % 16 == 0) ? s + 4 : s;
}

// cp.async: `bytes` of 4 or 16 from global to shared; src_size 0 (when
// !pred) fills the destination with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct ChainArgs {
  // chain layer i: forward layer i, or backward layer n-1-i
  const float* w[CH_MAX_LAYERS];     // W_l [K_l, N_l] as the caller holds it
  const float* bias[CH_MAX_LAYERS];  // forward: b_l
  const float* hact[CH_MAX_LAYERS];  // backward: the hidden whose act'
                                     // scales chain layer i's output
  float* out[CH_MAX_LAYERS];  // forward: h_{i+1} (the last: out);
                              // backward: g_{l-1} (the last: dx)
  const float* in;        // forward: x; backward: dy
  const float* in_act;    // backward: out, for act'(out) on dy
  float* in_store;        // backward: g_{n-1}
  int width[CH_MAX_LAYERS + 1];  // chain layer i: depth width[i], output
                                 // width[i + 1]
  int act[CH_MAX_LAYERS];        // forward: act_i; backward: the act whose
                                 // derivative scales chain layer i's output
  int in_act_code;               // backward: act_{n-1}
  int vec_in;                    // the input tile (x or dy), and
  int vec_in_act;                // backward: out, may be read 16 bytes
                                 // at a time
  int vec_w[CH_MAX_LAYERS];      // W rows may be read 16 bytes at a time
  int vec_out[CH_MAX_LAYERS];    // output rows may be written as float4
  const float* a_src[CH_MAX_LAYERS];  // streamed mode: chain layer i's
                                      // input in device memory
  int vec_a[CH_MAX_LAYERS];           // ... may be read 16 bytes at a time
  int chunk_start[CH_MAX_LAYERS + 1];
  int stream;    // 1: the input tile streams through the ring with W
  int slot;      // floats of one ring slot (W chunk, then the A chunk)
  int n_layers;
  int batch;
  int rg;        // row groups: TM = rg * TR
  int kc;        // depth of a W chunk (a multiple of 4)
  int gc;        // most column groups a CTA takes in any layer, even
  int stride_a;  // input tile stride of the even chain layers
  int stride_b;  // ... of the odd ones (0 with one layer)
  int stage;     // floats of one W chunk buffer
  float slope;
  int bf16;
};

// Column groups [g0, g0 + ng) of chain layer `i`'s output (i = -1: the
// chain's input) for cluster rank `rank`.
__device__ __forceinline__ void rank_groups(const ChainArgs& a, int i,
                                            int rank, int csize, int& g0,
                                            int& ng) {
  const int G = (a.width[i + 1] + 3) / 4;
  g0 = rank * G / csize;
  ng = (rank + 1) * G / csize - g0;
}

// The layer whose chunks issue_chunk is issuing and the rank's column
// groups in it, carried in registers: chunks issue in order, so the
// lookup and its divisions run once a layer, not once a chunk.
struct IssueState {
  int layer, g0, ng;
};

// Issues chunk q of the chain's W stream into ring slot q % CH_STAGES.
template <bool BWD>
__device__ __forceinline__ void issue_chunk(const ChainArgs& a, float* ring,
                                            int q, int q_end, int rank,
                                            int csize, int row0, int tm,
                                            IssueState& st) {
  if (q >= q_end) return;
  while (q >= a.chunk_start[st.layer + 1]) {
    ++st.layer;
    rank_groups(a, st.layer, rank, csize, st.g0, st.ng);
  }
  const int i = st.layer, ng = st.ng;
  const int D = a.width[i], O = a.width[i + 1];
  const int k0 = (q - a.chunk_start[i]) * a.kc;
  int kn = round4(D) - k0;  // depth rows this chunk covers
  kn = kn < a.kc ? kn : a.kc;
  const int cb = 4 * st.g0;
  float* dst = ring + (q % CH_STAGES) * a.slot;
  const float* W = a.w[i];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  if (a.stream) {  // the A chunk [tm][kc + 4]: rows row0.., columns k0..
    float* ad = dst + a.stage;
    const int row = a.kc + 4;
    const float* A = a.a_src[i];
    if (a.vec_a[i]) {
      for (int m = tid / 4; m < tm; m += CH_THREADS / 4) {
        const bool ok = row0 + m < a.batch;
        const float* src = A + (size_t)(row0 + m) * D + k0;
        for (int c4 = tid % 4; 4 * c4 < kn; c4 += 4)
          cp_async16(ad + m * row + 4 * c4, ok ? src + 4 * c4 : A, ok);
      }
    } else {
      for (int m = tid / 16; m < tm; m += CH_THREADS / 16) {
        const float* src = A + (size_t)(row0 + m) * D + k0;
        for (int c = tid % 16; c < kn; c += 16) {
          const bool ok = row0 + m < a.batch && k0 + c < D;
          cp_async4(ad + m * row + c, ok ? src + c : A, ok);
        }
      }
    }
  }
  // fixed thread-to-element maps, no division in the loops
  if (!BWD) {  // W [D, O]: rows k0.., columns cb .. cb + 4 ng; a warp a row
    const int row = 4 * a.gc;
    for (int kk = warp; kk < kn; kk += CH_WARPS) {
      const bool krow = k0 + kk < D;
      const float* src = W + (size_t)(k0 + kk) * O + cb;
      if (a.vec_w[i]) {
        for (int c4 = lane; c4 < ng; c4 += 32)
          cp_async16(dst + kk * row + 4 * c4, krow ? src + 4 * c4 : W, krow);
      } else {
        for (int c = lane; c < 4 * ng; c += 32) {
          const bool ok = krow && cb + c < O;
          cp_async4(dst + kk * row + c, ok ? src + c : W, ok);
        }
      }
    }
  } else {  // W [O, D] (the layer's K_l x N_l): rows cb.., columns k0..
    const int row = a.kc + 4;
    const int rows = 4 * ng;
    if (a.vec_w[i]) {  // 4 threads a row, 64 rows at a time
      for (int j = tid / 4; j < rows; j += CH_THREADS / 4) {
        const bool ok = cb + j < O;
        const float* src = W + (size_t)(cb + j) * D + k0;
        for (int c4 = tid % 4; 4 * c4 < kn; c4 += 4)
          cp_async16(dst + j * row + 4 * c4, ok ? src + 4 * c4 : W, ok);
      }
    } else {  // 16 threads a row
      for (int j = tid / 16; j < rows; j += CH_THREADS / 16) {
        const float* src = W + (size_t)(cb + j) * D + k0;
        for (int c = tid % 16; c < kn; c += 16) {
          const bool ok = cb + j < O && k0 + c < D;
          cp_async4(dst + j * row + c, ok ? src + c : W, ok);
        }
      }
    }
  }
}

// Stages rows row0 .. row0 + rows of src [batch, K] into dst [rows][S]
// with cp.async (16 bytes a copy where `vec`: K % 4 == 0 and src
// aligned); rows past the batch and columns past K are zero-filled.
__device__ __forceinline__ void stage_tile(float* dst, int S, const float* src,
                                           int K, int row0, int rows,
                                           int batch, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    const int v = S / 4;
    for (int e = tid; e < rows * v; e += CH_THREADS) {
      const int m = e / v, k = 4 * (e - m * v);
      const int r = row0 + m;
      const bool ok = r < batch && k < K;
      cp_async16(dst + m * S + k, ok ? src + (size_t)r * K + k : src, ok);
    }
  } else {
    for (int e = tid; e < rows * S; e += CH_THREADS) {
      const int m = e / S, k = e - m * S;
      const int r = row0 + m;
      const bool ok = r < batch && k < K;
      cp_async4(dst + e, ok ? src + (size_t)r * K + k : src, ok);
    }
  }
}

// The warp shape of a layer: lanes are lr x lc (row groups x items'
// column pairs), lr = 4, 2 or 1 as the tile has row groups; warps are
// wr x wc over the CTA's (row group, column pair) items.
struct WarpShape {
  int lr, lc, wr, wc;
};
__host__ __device__ __forceinline__ WarpShape warp_shape(int rg, int pairs) {
  WarpShape w;
  w.lr = rg >= 4 ? 4 : (rg >= 2 ? 2 : 1);
  w.lc = 32 / w.lr;
  w.wr = (rg + w.lr - 1) / w.lr;
  w.wc = (pairs + w.lc - 1) / w.lc;
  return w;
}

template <int TR, bool BWD>
__device__ __forceinline__ void chain_body(const ChainArgs& a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int TM = a.rg * TR;
  float* const buf_a = smem;
  float* const buf_b = smem + TM * a.stride_a;
  float* const ring = buf_b + TM * a.stride_b;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = (blockIdx.x / csize) * TM;
  const int n = a.n_layers;

  const int q_all = a.chunk_start[n];
  IssueState ist = {0, 0, 0};
  rank_groups(a, 0, rank, csize, ist.g0, ist.ng);
  if (a.stream) {
    if (BWD) {  // g_{n-1} = dy * act'(out) into device memory, the
                // cluster's ranks taking column groups of the row tile
      const int K0 = a.width[0];
      int g0, ng;
      rank_groups(a, -1, rank, csize, g0, ng);
      const int rows = min(TM, a.batch - row0);
      if (a.vec_in && a.vec_in_act && a.vec_a[0]) {  // float4 a thread
        for (int e = tid; e < rows * ng; e += CH_THREADS) {
          const int m = e / ng;
          const size_t o = (size_t)(row0 + m) * K0 + 4 * (g0 + e - m * ng);
          const float4 d = *reinterpret_cast<const float4*>(a.in + o);
          const float4 y = *reinterpret_cast<const float4*>(a.in_act + o);
          const int c = a.in_act_code;
          *reinterpret_cast<float4*>(a.in_store + o) = make_float4(
              d.x * act_deriv(y.x, c, a.slope), d.y * act_deriv(y.y, c, a.slope),
              d.z * act_deriv(y.z, c, a.slope), d.w * act_deriv(y.w, c, a.slope));
        }
      } else {
        const int c0 = 4 * g0, w = min(4 * ng, K0 - c0);
        for (int e = tid; e < rows * w; e += CH_THREADS) {
          const int m = e / w;
          const size_t o = (size_t)(row0 + m) * K0 + c0 + (e - m * w);
          a.in_store[o] =
              a.in[o] * act_deriv(a.in_act[o], a.in_act_code, a.slope);
        }
      }
      __threadfence();
    }
  } else {
    // the input tile through cp.async; ragged rows and the column tail
    // are zero. The forward issues W's first chunks first; the backward
    // stages out beside dy (over buffer B and the ring) and forms
    // g_{n-1} = dy * act'(out) in place before the ring starts.
    if (!BWD) {
      for (int q = 0; q < CH_STAGES - 1; ++q) {
        issue_chunk<BWD>(a, ring, q, q_all, rank, csize, row0, TM, ist);
        cp_async_commit();
      }
    }
    const int K0 = a.width[0];
    stage_tile(buf_a, a.stride_a, a.in, K0, row0, TM, a.batch, a.vec_in);
    if (BWD)
      stage_tile(buf_b, a.stride_a, a.in_act, K0, row0, TM, a.batch,
                 a.vec_in_act);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (BWD || a.bf16) {
      const int S = a.stride_a;
      for (int e = tid; e < TM * S; e += CH_THREADS) {
        float v = buf_a[e];
        if (BWD) {
          const int m = e / S, k = e - m * S;
          const int r = row0 + m;
          if (r < a.batch && k < K0) {
            v *= act_deriv(buf_b[e], a.in_act_code, a.slope);
            if (rank == 0) a.in_store[(size_t)r * K0 + k] = v;
          }
        }
        buf_a[e] = a.bf16 ? round_bf16(v) : v;
      }
    }
    if (BWD) {
      __syncthreads();  // out's tile is read; the ring may be filled
      for (int q = 0; q < CH_STAGES - 1; ++q) {
        issue_chunk<BWD>(a, ring, q, q_all, rank, csize, row0, TM, ist);
        cp_async_commit();
      }
    }
  }
  cluster.sync();  // every CTA of the cluster runs; tiles are in place

  int q = 0;
  for (int i = 0; i < n; ++i) {
    const int D = a.width[i], O = a.width[i + 1];
    const bool last = i == n - 1;
    const bool odd = i & 1;
    const float* in = odd ? buf_b : buf_a;
    const int in_stride = odd ? a.stride_b : a.stride_a;
    float* nxt = odd ? buf_a : buf_b;
    const int nxt_stride = odd ? a.stride_a : a.stride_b;
    int g0, ng;
    rank_groups(a, i, rank, csize, g0, ng);
    const int cb = 4 * g0;
    // an item: TR rows (rg, rg + RG, ...) by 8 columns: forward, the
    // groups cp and cp + H of the slice; backward, its columns
    // cp + H c (c < 8), H = ceil(ng / 2) column pairs
    const int H = (ng + 1) / 2;
    const WarpShape ws = warp_shape(a.rg, H);
    const int wr = warp / (ws.wc > 0 ? ws.wc : 1);
    const int rg = wr * ws.lr + lane / ws.lc;
    const int cp = (warp - wr * ws.wc) * ws.lc + lane % ws.lc;
    const bool on = warp < ws.wr * ws.wc && rg < a.rg && cp < H;
    float acc[TR][8];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
    const float* hrow = in + (on ? rg : 0) * in_stride;
    const int Dp = round4(D);
    // streamed: the ring stops at the layer's end (the next layer's input
    // is written by this one) and starts again here
    const int q_end = a.stream ? a.chunk_start[i + 1] : q_all;
    if (a.stream) {
      for (int s = 0; s < CH_STAGES - 1; ++s) {
        issue_chunk<BWD>(a, ring, q + s, q_end, rank, csize, row0, TM, ist);
        cp_async_commit();
      }
    }
    for (int k0 = 0; k0 < Dp; k0 += a.kc, ++q) {
      cp_async_wait<CH_STAGES - 2>();
      __syncthreads();
      issue_chunk<BWD>(a, ring, q + CH_STAGES - 1, q_end, rank, csize, row0,
                       TM, ist);
      cp_async_commit();
      float* const wt = ring + (q % CH_STAGES) * a.slot;
      const int kn = Dp - k0 < a.kc ? Dp - k0 : a.kc;
      if (a.bf16) {  // round this chunk in place, once
        for (int e = tid; e < a.slot; e += CH_THREADS)
          wt[e] = round_bf16(wt[e]);
        __syncthreads();
      }
      if (!on) continue;
      const float* hp =
          a.stream ? wt + a.stage + (on ? rg : 0) * (a.kc + 4) : hrow + k0;
      const int rstep = a.stream ? a.rg * (a.kc + 4) : a.rg * in_stride;
      if (!BWD) {
        const int wrow = 4 * a.gc;
        const float* wa = wt + 4 * cp;
        const float* wb = wa + 4 * H;
        // fragments of the next 4-deep step load while this one computes
        float4 x[4], y[4], h[TR];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[j] = *reinterpret_cast<const float4*>(wa + j * wrow);
          y[j] = *reinterpret_cast<const float4*>(wb + j * wrow);
        }
#pragma unroll
        for (int r = 0; r < TR; ++r)
          h[r] = *reinterpret_cast<const float4*>(hp + r * rstep);
        for (int kk = 0; kk < kn; kk += 4) {
          const int kq = kk + 4 < kn ? kk + 4 : kk;
          float4 xn[4], yn[4], hn[TR];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            xn[j] = *reinterpret_cast<const float4*>(wa + (kq + j) * wrow);
            yn[j] = *reinterpret_cast<const float4*>(wb + (kq + j) * wrow);
          }
#pragma unroll
          for (int r = 0; r < TR; ++r)
            hn[r] = *reinterpret_cast<const float4*>(hp + r * rstep + kq);
#pragma unroll
          for (int r = 0; r < TR; ++r) {
            const float hv[4] = {h[r].x, h[r].y, h[r].z, h[r].w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[r][0] = fmaf(hv[j], x[j].x, acc[r][0]);
              acc[r][1] = fmaf(hv[j], x[j].y, acc[r][1]);
              acc[r][2] = fmaf(hv[j], x[j].z, acc[r][2]);
              acc[r][3] = fmaf(hv[j], x[j].w, acc[r][3]);
              acc[r][4] = fmaf(hv[j], y[j].x, acc[r][4]);
              acc[r][5] = fmaf(hv[j], y[j].y, acc[r][5]);
              acc[r][6] = fmaf(hv[j], y[j].z, acc[r][6]);
              acc[r][7] = fmaf(hv[j], y[j].w, acc[r][7]);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            x[j] = xn[j];
            y[j] = yn[j];
          }
#pragma unroll
          for (int r = 0; r < TR; ++r) h[r] = hn[r];
        }
      } else {
        const int wrow = a.kc + 4;
        const float* wr0 = wt + cp * wrow;
        const int cstep = H * wrow;
        float4 w[8], h[TR];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          w[c] = *reinterpret_cast<const float4*>(wr0 + c * cstep);
#pragma unroll
        for (int r = 0; r < TR; ++r)
          h[r] = *reinterpret_cast<const float4*>(hp + r * rstep);
        for (int kk = 0; kk < kn; kk += 4) {
          const int kq = kk + 4 < kn ? kk + 4 : kk;
          float4 wn[8], hn[TR];
#pragma unroll
          for (int c = 0; c < 8; ++c)
            wn[c] = *reinterpret_cast<const float4*>(wr0 + c * cstep + kq);
#pragma unroll
          for (int r = 0; r < TR; ++r)
            hn[r] = *reinterpret_cast<const float4*>(hp + r * rstep + kq);
#pragma unroll
          for (int r = 0; r < TR; ++r) {
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              acc[r][c] = fmaf(h[r].x, w[c].x, acc[r][c]);
              acc[r][c] = fmaf(h[r].y, w[c].y, acc[r][c]);
              acc[r][c] = fmaf(h[r].z, w[c].z, acc[r][c]);
              acc[r][c] = fmaf(h[r].w, w[c].w, acc[r][c]);
            }
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) w[c] = wn[c];
#pragma unroll
          for (int r = 0; r < TR; ++r) h[r] = hn[r];
        }
      }
    }

    // epilogue: device memory, and (but for the last layer) the slice of
    // every CTA's next input tile
    float* const O_ = a.out[i];
    float bv[8];  // forward: the bias of the thread's 8 columns
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = cb + 4 * (cp + (c / 4) * H) + c % 4;
      bv[c] = (!BWD && on && col < O) ? __ldg(a.bias[i] + col) : 0.0f;
    }
    if (on) {
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const int m = rg + r * a.rg;
        const int row = row0 + m;
        const bool in_rows = row < a.batch;
        if (!BWD) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int grp = cp + half * H;
            if (grp >= ng) continue;
            const int col = cb + 4 * grp;
            float v[4];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              v[c] = col + c < O ? apply_act(acc[r][4 * half + c] +
                                                 bv[4 * half + c],
                                             a.act[i], a.slope)
                                 : 0.0f;
            if (in_rows) {
              float* dst = O_ + (size_t)row * O + col;
              if (a.vec_out[i]) {
                *reinterpret_cast<float4*>(dst) =
                    make_float4(v[0], v[1], v[2], v[3]);
              } else {
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  if (col + c < O) dst[c] = v[c];
              }
            }
            if (!last && !a.stream) {
              const float4 t =
                  a.bf16 ? make_float4(round_bf16(v[0]), round_bf16(v[1]),
                                       round_bf16(v[2]), round_bf16(v[3]))
                         : make_float4(v[0], v[1], v[2], v[3]);
              float* local = nxt + m * nxt_stride + col;
              for (int p = 0; p < csize; ++p)
                *reinterpret_cast<float4*>(cluster.map_shared_rank(local, p)) =
                    t;
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int j = cp + c * H;
            if (j >= 4 * ng) continue;
            const int col = cb + j;
            float* local = nxt + m * nxt_stride + col;
            if (col >= O) {  // the tail up to round4(O): zeros
              if (!last && !a.stream)
                for (int p = 0; p < csize; ++p)
                  *cluster.map_shared_rank(local, p) = 0.0f;
              continue;
            }
            const size_t o = (size_t)row * O + col;
            if (last) {
              if (in_rows) O_[o] = acc[r][c];
              continue;
            }
            float vv = 0.0f;
            if (in_rows) {
              vv = acc[r][c] * act_deriv(a.hact[i][o], a.act[i], a.slope);
              O_[o] = vv;
            }
            if (a.stream) continue;
            if (a.bf16) vv = round_bf16(vv);
            for (int p = 0; p < csize; ++p)
              *cluster.map_shared_rank(local, p) = vv;
          }
        }
      }
    }
    if (!last) {
      if (a.stream) __threadfence();  // the layer's output, for the ranks
      cluster.sync();
    }
  }
  cp_async_wait<0>();
}

// Launches `kern` with a cluster of `csize` CTAs along x.
template <typename K>
static cudaError_t launch_cluster(K kern, const ChainArgs& a, int grid,
                                  int csize, size_t smem,
                                  cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(CH_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Fills the plan-dependent fields of `a` from the chain widths (already
// in a.width[0..n]) and checks the plan. Returns the shared bytes a CTA
// needs, or 0 when the plan cannot run (a.rg, a.kc, tr, csize invalid,
// too many items for a CTA's threads, or too much shared memory).
static size_t chain_plan(ChainArgs& a, int tr, int csize, bool bwd,
                         int stream, size_t smem_limit) {
  const int n = a.n_layers;
  if (tr != 1 && tr != 4 && tr != 8) return 0;
  if (csize != 1 && csize != 2 && csize != 4 && csize != 8) return 0;
  if (a.rg < 1 || a.kc < 4 || a.kc > 64 || a.kc % 4) return 0;
  a.gc = 0;
  a.stride_a = a.stride_b = 0;
  a.chunk_start[0] = 0;
  for (int i = 0; i < n; ++i) {
    const int G = (a.width[i + 1] + 3) / 4;
    const int gmax = (G + csize - 1) / csize;  // the most a rank takes
    const WarpShape w = warp_shape(a.rg, (gmax + 1) / 2);
    if (w.wr * w.wc > CH_WARPS) return 0;
    if (gmax > a.gc) a.gc = gmax;
    const int s = tile_stride(a.width[i]);
    if (i & 1) a.stride_b = s > a.stride_b ? s : a.stride_b;
    else a.stride_a = s > a.stride_a ? s : a.stride_a;
    a.chunk_start[i + 1] =
        a.chunk_start[i] + (round4(a.width[i]) + a.kc - 1) / a.kc;
  }
  a.gc = (a.gc + 1) / 2 * 2;  // whole column pairs
  a.stage = bwd ? 4 * a.gc * (a.kc + 4) : a.kc * 4 * a.gc;
  const size_t tm = (size_t)a.rg * tr;
  a.stream = stream ? 1 : 0;
  size_t bytes;
  if (stream) {  // no resident tiles; a slot holds the W and A chunks
    a.stride_a = a.stride_b = 0;
    a.slot = a.stage + (int)tm * (a.kc + 4);
    bytes = sizeof(float) * (size_t)CH_STAGES * a.slot;
  } else {
    a.slot = a.stage;
    size_t rest = tm * a.stride_b + (size_t)CH_STAGES * a.stage;
    if (bwd && rest < tm * a.stride_a) rest = tm * a.stride_a;  // out's tile
    bytes = sizeof(float) * (tm * a.stride_a + rest);
  }
  return bytes <= smem_limit ? bytes : 0;
}

static inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}
