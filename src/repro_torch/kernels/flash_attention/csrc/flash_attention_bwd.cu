// Hand-written Hopper (sm_90a) kernels: GQA flash attention, backward.
//
// They replace no pallas_call: the reference's training attention,
//   src/repro/kernels/flash_attention/ops.py::chunked_attention,
// is an online softmax in XLA with a custom VJP, _chunked_core_bwd, which
// recomputes the probabilities blockwise from the saved (q, k, v, o, lse)
// and keeps O(S) residuals.  These kernels are that VJP on the card,
// behind ops.py::ChunkedAttention, whose forward is the flash_attention
// kernel with its log-sum-exp output (flash_attention.cu).
//
// What they compute (the reference's function): with s = q.k * scale
// masked (keys at or past SK; causal: k_pos > q_pos + offset, offset =
// SK - S, the reference's bottom-right alignment), p = exp(s - lse),
//   delta = rowsum(dO o)                         (flash_bwd_delta_kernel)
//   dv = p^T dO, dk = (p (dO v^T - delta))^T q * scale
//        summed over the G = HQ / HKV query heads of each KV head
//   dq = (p (dO v^T - delta)) k * scale
// each output cast to its input's type.  Every output element is summed by
// one thread in a fixed order: no atomics, so a run repeats bit for bit.
// The Python wrapper (kernel.py::route_bwd) picks one of two routes for
// dk/dv and dq, as the forward's route picks its kernel; delta comes first
// on both.
//
// What bounds them on this card: operations.  The backward does five
// products per (query, key) pair under the mask (s, dO v^T, p^T dO, dS^T q,
// dS k: 2.5 times the forward's two), 10 D operations a pair; at the
// training shape (B = 4, 16 heads, S = SK = 4096, D = 64, causal) some 344
// GFLOP, 348 us at the bf16 tensor-core peak against 28 MB of inputs and
// outputs.  Split in two kernels that own their outputs, s and dO v^T are
// computed in both (seven products a pair): dk/dv 8 D a pair (278 us at
// that shape), dq 6 D (209 us).
//
// ---------------------------------------------------------------------------
// The bf16 route: flash_bwd_dkdv_mma_kernel and flash_bwd_dq_mma_kernel
// (entry points flash_bwd_dkdv_mma_launch, flash_bwd_dq_mma_launch), for
// bf16 with D <= 128 a multiple of 8 and TMA-aligned q, k, v and dO.
//
// Numerics: bf16 operands, f32 sums, as SDPA and FlashAttention.  p and dS
// are computed in f32 (dS from the f32 p); p is rounded to bf16 only as
// dv's operand and dS only as dk's and dq's, which ref.chunked_bwd(...,
// round_bf16=True) repeats step for step.
//
// What the design does about the bound:
// - Every product on the tensor cores (wgmma, bf16 in, f32 accumulators).
// - dkdv: one block per (batch, KV head, 64-key tile), a consumer
//   warpgroup (warps 0-3) holding the block's 64 keys as the rows of every
//   product, and a producer warp (warp 4).  The producer TMA-loads K and V
//   once, then streams the Q and dO tiles (cp.async.bulk.tensor, 128-byte
//   swizzle, zero fill past S and D) with their 64 lse and delta values
//   (4-byte cp.async, zeros past S, each lane's arrival counted on the
//   stage's barrier) through a ring of stages with full and empty
//   mbarriers: the group's G query heads in order and, for each, the q
//   tiles the mask lets through (causal: from the tile of the first row
//   that sees key k0).  The consumer computes S^T = K Q^T and dP^T = V dO^T
//   (SS, both K-major); keys are the rows, so P^T and dS^T come out of the
//   accumulators in the A-operand register layout and feed dV += P^T dO and
//   dK += dS^T Q (RS, dO and Q read MN-major from the same swizzled tiles
//   that the first two products read K-major).  lse and delta are indexed
//   by column.  Rows past S meet
//   zero Q and dO rows, and dk/dv rows past SK are never written, so only
//   the causal diagonal tile is masked element by element.
// - dq: one block per (batch, q head, 64-row q tile), heaviest first.  Q,
//   dO, lse and delta load once; the ring carries the K and V tiles, cut at
//   the causal diagonal.  S = Q K^T, dP = dO V^T (SS), dS = P (dP - delta)
//   packed in place, dQ += dS K (RS, K MN-major: the forward's P V).  The
//   diagonal tile and the tile that holds SK are masked element by element.
// - dK scale, dV and dQ scale are written once, in bf16 pairs, in k's, v's
//   and q's layouts (the caller's strides).
// - Widths: built at DP = 64 and 128; a head dim below its width (Zamba2's
//   80) runs with the tensor maps' real D, TMA filling the columns past it
//   with zeros, as the forward does.
// - Registers and occupancy: 160 threads.  dkdv holds dK and dV (DP f32 a
//   thread together), S^T, dP^T (64 f32) and P^T, dS^T as bf16 pairs (32):
//   at DP = 64 __launch_bounds__(160, 2), 3 stages, 68,152 bytes of shared
//   memory, two blocks an SM; at DP = 128 (160, 1), 2 stages, 100,392
//   bytes, one block an SM.  dq holds dQ (DP / 2), S, dP (64) and dS (16):
//   (160, 2), 3 stages at DP = 64 (67,128 bytes), 2 at 128 (99,880 bytes),
//   two blocks an SM.  chip_smoke.py logs what ptxas reports for each
//   (PERF.md).  Tried in throwaway copies and left: one dkdv block an SM
//   at DP = 64 (slower), a 2-stage ring or three dq blocks an SM (no
//   faster), dq issuing tile kt + 1's products before tile kt's
//   elementwise work (two sets of S and dP spill; slower).
//
// ---------------------------------------------------------------------------
// The f32 route: flash_bwd_dkdv_kernel and flash_bwd_dq_kernel (entry
// points flash_bwd_dkdv_launch, flash_bwd_dq_launch), for float32 inputs,
// other head dims and unaligned views, in f32 from the loaded bf16 or f32
// inputs on the CUDA cores (67 TFLOP/s peak), so it sits far above the
// bound by construction, as the forward's f32 kernel does:
// - dkdv: one block per (batch, KV head, 64-key tile), 256 threads.  K and
//   V stay in shared memory as f32 while the block loops over the G query
//   heads of its group and, for each, over the 64-row q tiles the mask
//   lets through (causal: from the tile of the first row that sees the
//   block's first key); dk and dv accumulate in registers and are written
//   once.  The heaviest key tiles (the first ones, under a causal mask)
//   start first.
// - dq: one block per (batch, q head, 64-row q tile): Q, dO, lse and delta
//   staged once, a loop over the k tiles the mask lets through, dq in
//   registers, written once; the heaviest q tiles start first.
// - Register tiling as in flash_fwd_kernel: a thread holds a 4 x 4 block
//   of each 64 x 64 score tile (rows by ty, keys tx + 16 j) and a 4 x D/16
//   block of its accumulators (columns 64 g + 4 tx .. + 3), so each 16-byte
//   shared-memory load feeds 4 to 8 FMAs; rows padded by 4 floats keep the
//   16-byte loads free of bank conflicts.  p and dS go through shared
//   memory between the score products and the accumulating ones.
// - The ragged edge is masked, not padded by copies: rows past S or SK and
//   columns past D stage as zeros, their p is 0, and only real rows and
//   columns are stored.  Inputs are read through their own strides (the
//   last dimension contiguous), so the model's transposed [B, S, H, D] ->
//   [B, H, S, D] views are read in place; outputs take the caller's
//   strides.
// - D <= 128 (the 64- and 128-wide instantiations).
//
// Each entry point returns cudaGetLastError() after its launch, so a
// refused launch surfaces in the Python wrapper.

#include <cmath>

#include "hopper.cuh"

namespace {

constexpr int TQ = 64;          // query rows per tile
constexpr int TK = 64;          // keys per tile
constexpr int kThreads = 256;   // 16 x 16: ty picks 4 rows, tx the columns

struct Strides {
  long long b, h, s;            // in elements; the last dimension is dense
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Stages rows [row0, row0 + ROWS) of one head (rows past n_rows and
// columns past D as zeros) into dst [ROWS][LD] as f32.
template <typename T, int ROWS, int DP, int LD>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const T* __restrict__ head,
                                      long long row_stride, int row0,
                                      int n_rows, int D) {
  for (int e = threadIdx.x; e < ROWS * DP; e += kThreads) {
    const int r = e / DP, d = e % DP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < n_rows && d < D) x = to_f32(head[(long long)row * row_stride + d]);
    dst[r * LD + d] = x;
  }
}

// One row's f32 values of lse or delta into dst [TQ] (0 past S).
__device__ __forceinline__ void stage_row(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int row0, int S) {
  for (int i = threadIdx.x; i < TQ; i += kThreads)
    dst[i] = row0 + i < S ? src[row0 + i] : 0.f;
}

// s[i][j] = Qs[ty*4+i] . Ks[tx+16j] and dp[i][j] = dOs[ty*4+i] . Vs[tx+16j]
template <int DP, int LD>
__device__ __forceinline__ void score_tiles(const float* __restrict__ Qs,
                                            const float* __restrict__ dOs,
                                            const float* __restrict__ Ks,
                                            const float* __restrict__ Vs,
                                            float (&s)[4][4],
                                            float (&dp)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DP; d += 4) {
    float4 qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * LD + d]);
      ov[i] = *reinterpret_cast<const float4*>(&dOs[(ty * 4 + i) * LD + d]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
      vv[j] = *reinterpret_cast<const float4*>(&Vs[(tx + 16 * j) * LD + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = s[i][j], b = dp[i][j];
        a = fmaf(qv[i].x, kv[j].x, a);
        a = fmaf(qv[i].y, kv[j].y, a);
        a = fmaf(qv[i].z, kv[j].z, a);
        a = fmaf(qv[i].w, kv[j].w, a);
        b = fmaf(ov[i].x, vv[j].x, b);
        b = fmaf(ov[i].y, vv[j].y, b);
        b = fmaf(ov[i].z, vv[j].z, b);
        b = fmaf(ov[i].w, vv[j].w, b);
        s[i][j] = a;
        dp[i][j] = b;
      }
  }
}

// p and dS of the score tile in place: p = exp(s * scale - lse) under the
// mask (0 elsewhere), dS = p (dp - delta); rows are q0 + ty*4 + i, keys
// k0 + tx + 16 j.
__device__ __forceinline__ void probabilities(float (&s)[4][4],
                                              float (&dp)[4][4],
                                              const float* __restrict__ lse_s,
                                              const float* __restrict__ delta_s,
                                              int q0, int k0, int S, int SK,
                                              float scale, int causal,
                                              int offset) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int q_pos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k_pos = k0 + tx + 16 * j;
      const bool ok = q_pos < S && k_pos < SK &&
                      (!causal || k_pos <= q_pos + offset);
      const float p = ok ? expf(fmaf(s[i][j], scale, -lse_s[r])) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta_s[r]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                           float* __restrict__ delta, int HQ, int S, int D,
                           long long rows, Strides so, Strides sdo) {
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = (int)(row % S);
  const long long bh = row / S;
  const int h = (int)(bh % HQ), b = (int)(bh / HQ);
  const T* orow = o + b * so.b + h * so.h + s * so.s;
  const T* drow = dO + b * sdo.b + h * sdo.h + s * sdo.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dO,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int B,
                          int HQ, int HKV, int S, int SK, int D, Strides sq,
                          Strides sk, Strides sv, Strides sdo, Strides sdk,
                          Strides sdv, float scale, int causal, int offset) {
  constexpr int LD = DP + 4;
  constexpr int LDP = TK + 4;
  constexpr int NG = DP / 64;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [TK][LD]
  float* Vs = Ks + TK * LD;                      // [TK][LD]
  float* Qs = Vs + TK * LD;                      // [TQ][LD]
  float* dOs = Qs + TQ * LD;                     // [TQ][LD]
  float* Ps = dOs + TQ * LD;                     // [TQ][LDP]
  float* dSs = Ps + TQ * LDP;                    // [TQ][LDP]
  float* lse_s = dSs + TQ * LDP;                 // [TQ]
  float* delta_s = lse_s + TQ;                   // [TQ]

  const int BH = B * HKV;
  const int bh = blockIdx.x % BH;
  const int kt = (int)(blockIdx.x / BH);         // heaviest (first) first
  const int b = bh / HKV, hk = bh % HKV;
  const int G = HQ / HKV;
  const int k0 = kt * TK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage<T, TK, DP, LD>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, SK, D);
  stage<T, TK, DP, LD>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, SK, D);

  float dk_acc[4][NG][4], dv_acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk_acc[i][g][c] = dv_acc[i][g][c] = 0.f;

  const int n_qt = (S + TQ - 1) / TQ;
  int qt0 = 0;   // causal: the tile of the first row that sees key k0
  if (causal && k0 - offset > 0) qt0 = (k0 - offset) / TQ;
  for (int gq = 0; gq < G; ++gq) {
    const int h = hk * G + gq;
    const T* qh = q + b * sq.b + h * sq.h;
    const T* doh = dO + b * sdo.b + h * sdo.h;
    const float* lse_h = lse + ((long long)b * HQ + h) * S;
    const float* delta_h = delta + ((long long)b * HQ + h) * S;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * TQ;
      __syncthreads();   // the previous tile's reads are done
      stage<T, TQ, DP, LD>(Qs, qh, sq.s, q0, S, D);
      stage<T, TQ, DP, LD>(dOs, doh, sdo.s, q0, S, D);
      stage_row(lse_s, lse_h, q0, S);
      stage_row(delta_s, delta_h, q0, S);
      __syncthreads();

      float s[4][4], dp[4][4];
      score_tiles<DP, LD>(Qs, dOs, Ks, Vs, s, dp);
      probabilities(s, dp, lse_s, delta_s, q0, k0, S, SK, scale, causal,
                    offset);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty * 4 + i) * LDP + tx + 16 * j] = s[i][j];
          dSs[(ty * 4 + i) * LDP + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();

      // dv[key] += p[row, key] dO[row], dk[key] += dS[row, key] q[row]; this
      // thread's keys are ty*4 .. ty*4 + 3
#pragma unroll 2
      for (int r = 0; r < TQ; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(&Ps[r * LDP + ty * 4]);
        const float4 sv4 = *reinterpret_cast<const float4*>(&dSs[r * LDP + ty * 4]);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
        const float sa[4] = {sv4.x, sv4.y, sv4.z, sv4.w};
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 ov = *reinterpret_cast<const float4*>(
              &dOs[r * LD + g * 64 + tx * 4]);
          const float4 qv = *reinterpret_cast<const float4*>(
              &Qs[r * LD + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][g][0] = fmaf(pa[i], ov.x, dv_acc[i][g][0]);
            dv_acc[i][g][1] = fmaf(pa[i], ov.y, dv_acc[i][g][1]);
            dv_acc[i][g][2] = fmaf(pa[i], ov.z, dv_acc[i][g][2]);
            dv_acc[i][g][3] = fmaf(pa[i], ov.w, dv_acc[i][g][3]);
            dk_acc[i][g][0] = fmaf(sa[i], qv.x, dk_acc[i][g][0]);
            dk_acc[i][g][1] = fmaf(sa[i], qv.y, dk_acc[i][g][1]);
            dk_acc[i][g][2] = fmaf(sa[i], qv.z, dk_acc[i][g][2]);
            dk_acc[i][g][3] = fmaf(sa[i], qv.w, dk_acc[i][g][3]);
          }
        }
      }
    }
  }

  T* dkh = dk + b * sdk.b + hk * sdk.h;
  T* dvh = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= SK) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = g * 64 + tx * 4 + c;
        if (d < D) {
          dkh[(long long)key * sdk.s + d] = from_f32<T>(dk_acc[i][g][c] * scale);
          dvh[(long long)key * sdv.s + d] = from_f32<T>(dv_acc[i][g][c]);
        }
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int B, int HQ, int HKV, int S, int SK, int D,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, float scale, int causal, int offset) {
  constexpr int LD = DP + 4;
  constexpr int LDP = TK + 4;
  constexpr int NG = DP / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [TQ][LD]
  float* dOs = Qs + TQ * LD;                     // [TQ][LD]
  float* Ks = dOs + TQ * LD;                     // [TK][LD]
  float* Vs = Ks + TK * LD;                      // [TK][LD]
  float* dSs = Vs + TK * LD;                     // [TQ][LDP]
  float* lse_s = dSs + TQ * LDP;                 // [TQ]
  float* delta_s = lse_s + TQ;                   // [TQ]

  const int BH = B * HQ;
  const int n_qt = (S + TQ - 1) / TQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);   // heaviest first
  const int b = bh / HQ, h = bh % HQ;
  const int hk = h / (HQ / HKV);
  const int q0 = qt * TQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage<T, TQ, DP, LD>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, D);
  stage<T, TQ, DP, LD>(dOs, dO + b * sdo.b + h * sdo.h, sdo.s, q0, S, D);
  stage_row(lse_s, lse + (long long)bh * S, q0, S);
  stage_row(delta_s, delta + (long long)bh * S, q0, S);

  float acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;

  const T* kh = k + b * sk.b + hk * sk.h;
  const T* vh = v + b * sv.b + hk * sv.h;
  int n_kt = (SK + TK - 1) / TK;
  if (causal) {   // skip the tiles above the diagonal k_pos = q_pos + offset
    const int last = q0 + TQ - 1 + offset;
    n_kt = min(n_kt, last < 0 ? 0 : last / TK + 1);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TK;
    __syncthreads();   // Q staged; the previous tile's reads are done
    stage<T, TK, DP, LD>(Ks, kh, sk.s, k0, SK, D);
    stage<T, TK, DP, LD>(Vs, vh, sv.s, k0, SK, D);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<DP, LD>(Qs, dOs, Ks, Vs, s, dp);
    probabilities(s, dp, lse_s, delta_s, q0, k0, S, SK, scale, causal,
                  offset);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty * 4 + i) * LDP + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dq[row] += dS[row, key] k[key] over the tile's keys
#pragma unroll 2
    for (int c = 0; c < TK; c += 4) {
      float4 dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dsv[i] = *reinterpret_cast<const float4*>(&dSs[(ty * 4 + i) * LDP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 kv = *reinterpret_cast<const float4*>(
              &Ks[(c + cc) * LD + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = cc == 0 ? dsv[i].x
                            : cc == 1 ? dsv[i].y
                            : cc == 2 ? dsv[i].z
                                      : dsv[i].w;
            acc[i][g][0] = fmaf(w, kv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(w, kv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(w, kv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(w, kv.w, acc[i][g][3]);
          }
        }
      }
    }
  }

  T* dqh = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = g * 64 + tx * 4 + c;
        if (d < D) dqh[(long long)row * sdq.s + d] = from_f32<T>(acc[i][g][c] * scale);
      }
  }
}

template <int DP>
constexpr int dkdv_smem() {
  return (4 * 64 * (DP + 4) + 2 * TQ * (TK + 4) + 2 * TQ) * (int)sizeof(float);
}

template <int DP>
constexpr int dq_smem() {
  return (4 * 64 * (DP + 4) + TQ * (TK + 4) + 2 * TQ) * (int)sizeof(float);
}

struct Args {
  const void *q, *k, *v, *dO;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, HQ, HKV, S, SK, D;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  float scale;
  int causal, offset;
};

template <typename T, int DP>
int launch_dkdv(const Args& a, cudaStream_t stream) {
  constexpr int smem = dkdv_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((a.SK + TK - 1) / TK) * a.B * a.HKV;
  flash_bwd_dkdv_kernel<T, DP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dO), a.lse, a.delta,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.B, a.HQ, a.HKV, a.S,
      a.SK, a.D, a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.scale, a.causal,
      a.offset);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int smem = dq_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((a.S + TQ - 1) / TQ) * a.B * a.HQ;
  flash_bwd_dq_kernel<T, DP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dO), a.lse, a.delta,
      static_cast<T*>(a.dq), a.B, a.HQ, a.HKV, a.S, a.SK, a.D, a.sq, a.sk,
      a.sv, a.sdo, a.sdq, a.scale, a.causal, a.offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int which, cudaStream_t stream) {
  if (a.D <= 64)
    return which ? launch_dq<T, 64>(a, stream) : launch_dkdv<T, 64>(a, stream);
  return which ? launch_dq<T, 128>(a, stream) : launch_dkdv<T, 128>(a, stream);
}

int backward(const void* q, const void* k, const void* v, const void* dO,
             const void* lse, const void* delta, void* dq, void* dk, void* dv,
             int is_bf16, int B, int HQ, int HKV, int S, int SK, int D,
             const long long* st, float scale, int causal, int offset,
             int which, void* stream) {
  if (D < 1 || D > 128 || HKV < 1 || HQ % HKV != 0 || SK < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * HQ * S == 0) return (int)cudaGetLastError();
  Args a{q, k, v, dO, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, dk, dv, B, HQ, HKV, S, SK, D,
         {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
         {st[9], st[10], st[11]}, {st[12], st[13], st[14]},
         {st[15], st[16], st[17]}, {st[18], st[19], st[20]}, scale, causal,
         offset};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return dispatch<__nv_bfloat16>(a, which, s);
  return dispatch<float>(a, which, s);
}

}  // namespace

// delta [B, HQ, S] f32 (contiguous) = rowsum(dO o) in f32; o and dO [B,
// HQ, S, D] with per-tensor (batch, head, row) strides in elements.
extern "C" int flash_bwd_delta_launch(const void* o, const void* dO,
                                      void* delta, int is_bf16, int B,
                                      int HQ, int S, int D, long long o_sb,
                                      long long o_sh, long long o_ss,
                                      long long do_sb, long long do_sh,
                                      long long do_ss, void* stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * HQ * S;
  if (rows == 0) return (int)cudaGetLastError();
  const Strides so{o_sb, o_sh, o_ss}, sdo{do_sb, do_sh, do_ss};
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    flash_bwd_delta_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dO), static_cast<float*>(delta), HQ,
        S, D, rows, so, sdo);
  else
    flash_bwd_delta_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dO),
        static_cast<float*>(delta), HQ, S, D, rows, so, sdo);
  return (int)cudaGetLastError();
}

// strides: 21 in elements, (batch, head, row) of q, k, v, dO, dq, dk, dv in
// that order; lse and delta f32 [B, HQ, S] contiguous.  D <= 128, HQ a
// multiple of HKV, SK >= 1.  Causal: k_pos <= q_pos + offset.
extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dO,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int is_bf16, int B,
                                     int HQ, int HKV, int S, int SK, int D,
                                     const long long* strides, float scale,
                                     int causal, int offset, void* stream) {
  return backward(q, k, v, dO, lse, delta, nullptr, dk, dv, is_bf16, B, HQ,
                  HKV, S, SK, D, strides, scale, causal, offset, 0, stream);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const void* lse, const void* delta,
                                   void* dq, int is_bf16, int B, int HQ,
                                   int HKV, int S, int SK, int D,
                                   const long long* strides, float scale,
                                   int causal, int offset, void* stream) {
  return backward(q, k, v, dO, lse, delta, dq, nullptr, nullptr, is_bf16, B,
                  HQ, HKV, S, SK, D, strides, scale, causal, offset, 1,
                  stream);
}

// ---------------------------------------------------------------------------
// The bf16 route: the tensor-core kernels.
// ---------------------------------------------------------------------------
namespace bwd_mma {

using namespace hopper;

constexpr int kTileRows = 64;          // rows of every Q, dO, K or V tile
constexpr int kThreads = 160;          // consumer warpgroup + producer warp
constexpr int kConsumers = 128;
constexpr int kStat = kTileRows * 4;   // one tile's f32 lse or delta values
constexpr float kLog2e = 1.4426950408889634f;

struct OutStrides {
  long long b, h, s;   // in elements; the last dimension is dense
};

// 4 bytes global -> shared, asynchronous; zeros when !ok (src is then not
// read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// An arrival on bar once this thread's earlier cp.async copies have landed
// (counted among the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// One 64-row tile's lse and delta values (rows past S as zeros) by the 32
// lanes of the producer warp, then each lane's arrival on bar.
__device__ __forceinline__ void load_stats(uint32_t s_lse, uint32_t s_delta,
                                           const float* lse,
                                           const float* delta, long long row,
                                           int r0, int S, int lane,
                                           uint32_t bar) {
#pragma unroll
  for (int j = 0; j < kTileRows / 32; ++j) {
    const int i = lane + 32 * j;
    const bool ok = r0 + i < S;
    const long long at = ok ? row + r0 + i : 0;
    cp_async4(s_lse + 4 * i, lse + at, ok);
    cp_async4(s_delta + 4 * i, delta + at, ok);
  }
  cp_async_arrive(bar);
}

// Bytes of dynamic shared memory: the fixed tiles and the ring's, the
// 1 KB alignment pad, the stats (lse and delta, 512 bytes a set) and the
// barriers (one fixed, a full and an empty per stage).
template <int DP>
constexpr int smem_bytes(int tiles, int stat_sets, int stages) {
  return tiles * (DP / 64) * kBox + 1024 + stat_sets * 2 * kStat +
         8 * (1 + 2 * stages);
}

// dK, dV: one block per (batch, KV head, 64-key tile).  The consumer
// warpgroup's thread lane of warp w holds keys r0 = 16 w + lane/4 and
// r0 + 8 of the tile: the rows of every accumulator.  DP: the width, 64 or
// 128; D: the head dim, at most DP and a multiple of 8.
template <int DP, int ST, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    flash_bwd_dkdv_mma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int B, int HQ,
                              int HKV, int S, int SK, int D, OutStrides sdk,
                              OutStrides sdv, float scale, float scale_log2,
                              int causal, int offset) {
  constexpr int NB = DP / 64;
  constexpr int kTile = NB * kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + kTile;
  auto sQ = [&](int s) { return base + (2 + 2 * s) * kTile; };
  auto sdO = [&](int s) { return base + (3 + 2 * s) * kTile; };
  const uint32_t stats = base + (2 + 2 * ST) * kTile;
  auto sLse = [&](int s) { return stats + 2 * kStat * s; };
  auto sDelta = [&](int s) { return stats + 2 * kStat * s + kStat; };
  const uint32_t bars = stats + 2 * kStat * ST;
  const uint32_t kv_bar = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * ST + 8 * s; };

  const int BH = B * HKV;
  const int bh = blockIdx.x % BH;
  const int kt = (int)(blockIdx.x / BH);   // heaviest (first) first
  const int b = bh / HKV, hk = bh % HKV;
  const int G = HQ / HKV;
  const int k0 = kt * kTileRows;
  const int n_qt = (S + kTileRows - 1) / kTileRows;
  // causal: from the tile of the first row that sees key k0 (q = k0 - offset)
  const int qt0 = causal ? min(max(k0 - offset, 0) / kTileRows, n_qt) : 0;
  const int per_head = n_qt - qt0;
  const int n_it = G * per_head;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1 + 32);   // the TMA's expect_tx + 32 lanes' stats
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    // producer: K and V once, then Q, dO, lse and delta of each visible
    // q tile of each of the group's G query heads through the ring
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * kTile);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_load(sK + c * kBox, &tk, kv_bar, c * 64, k0, hk, b);
        tma_load(sV + c * kBox, &tv, kv_bar, c * 64, k0, hk, b);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % ST;
      const int h = hk * G + it / per_head;
      const int q0 = (qt0 + it % per_head) * kTileRows;
      mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full(s), 2 * kTile);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(sQ(s) + c * kBox, &tq, full(s), c * 64, q0, h, b);
          tma_load(sdO(s) + c * kBox, &tdo, full(s), c * 64, q0, h, b);
        }
      }
      load_stats(sLse(s), sDelta(s), lse, delta, ((long long)b * HQ + h) * S,
                 q0, S, lane, full(s));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g;
  const float* stat = reinterpret_cast<const float*>(smem_raw + (stats - raw));
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float st[32], dp[32];
  uint32_t pa[4][4], da[4][4];

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % ST;
    const int q0 = (qt0 + it % per_head) * kTileRows;
    mbar_wait(full(s), (it / ST) & 1);

    // S^T = K Q^T and dP^T = V dO^T: keys the rows, queries the columns
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(st, k_major(sK, kk), k_major(sQ(s), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(dp, k_major(sV, kk), k_major(sdO(s), kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(st);
    fence_regs(dp);

    // P^T = exp(S^T scale - lse), lse by column; element i sits at key row
    // r0 + 8 ((i / 2) & 1), query column 8 (i / 4) + 2 t + (i & 1).  Only
    // the diagonal tile is masked (rows past S read zero Q and dO rows,
    // and keys past SK are never written).
    const float* ls = stat + 2 * kTileRows * s;
    const float* dl = ls + kTileRows;
    const bool diag = causal && k0 + kTileRows - 1 > q0 + offset;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float x = fmaf(st[i], scale_log2, -(e & 1 ? l2.y : l2.x) * kLog2e);
        if (diag && k0 + r0 + 8 * (e >> 1) > q0 + 8 * j + 2 * t + (e & 1) +
                                                  offset)
          x = -INFINITY;
        st[i] = ex2(x);
      }
    }

    // P^T and then dS^T = P^T (dP^T - delta), in f32 from the f32 P^T,
    // packed to bf16 in place as A operands.  (Issuing dV += P^T dO before
    // forming dS^T overlaps the two but needs more live registers: at DP =
    // 64 ptxas then spilled and serialized the products.)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        dp[i] = st[i] * (dp[i] - (e & 1 ? d2.y : d2.x));
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        da[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);

    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major (queries the
    // contraction)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (DP == 64)
        wgmma_rs_n64(dv_acc, pa[kk], mn_major(sdO(s), kk));
      else
        wgmma_rs_n128(dv_acc, pa[kk], mn_major(sdO(s), kk));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (DP == 64)
        wgmma_rs_n64(dk_acc, da[kk], mn_major(sQ(s), kk));
      else
        wgmma_rs_n128(dk_acc, da[kk], mn_major(sQ(s), kk));
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_frags(pa);
    fence_frags(da);
    mbar_arrive(empty(s));
  }

  // dK scale and dV in k's and v's layouts, keys past SK not at all
  __nv_bfloat16* dkh = dk + b * sdk.b + hk * sdk.h;
  __nv_bfloat16* dvh = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + 8 * r;
    if (key >= SK) continue;
    __nv_bfloat16* krow = dkh + (long long)key * sdk.s + 2 * t;
    __nv_bfloat16* vrow = dvh + (long long)key * sdv.s + 2 * t;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j < D) {   // columns D..DP-1 are the zero fill
        *reinterpret_cast<__nv_bfloat162*>(krow + 8 * j) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2 * r] * scale,
                                  dk_acc[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * j) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * r],
                                  dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dQ: one block per (batch, q head, 64-row q tile), heaviest first.  The
// consumer's thread lane of warp w holds query rows r0 = 16 w + lane/4 and
// r0 + 8 of the tile.
template <int DP, int ST, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    flash_bwd_dq_mma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int B, int HQ,
                            int HKV, int S, int SK, int D, OutStrides sdq,
                            float scale, float scale_log2, int causal,
                            int offset) {
  constexpr int NB = DP / 64;
  constexpr int kTile = NB * kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + kTile;
  auto sK = [&](int s) { return base + (2 + 2 * s) * kTile; };
  auto sV = [&](int s) { return base + (3 + 2 * s) * kTile; };
  const uint32_t stats = base + (2 + 2 * ST) * kTile;
  const uint32_t bars = stats + 2 * kStat;
  const uint32_t q_bar = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * ST + 8 * s; };

  const int BH = B * HQ;
  const int n_qt = (S + kTileRows - 1) / kTileRows;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);   // heaviest first
  const int b = bh / HQ, h = bh % HQ;
  const int hk = h / (HQ / HKV);
  const int q0 = qt * kTileRows;
  int n_kt = (SK + kTileRows - 1) / kTileRows;
  if (causal) {   // cut at the diagonal k_pos = q_pos + offset
    const int last = q0 + kTileRows - 1 + offset;
    n_kt = min(n_kt, last < 0 ? 0 : last / kTileRows + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1 + 32);   // the TMA's expect_tx + 32 lanes' stats
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    // producer: Q, dO, lse and delta once, then the K/V ring
    if (lane == 0) {
      mbar_expect_tx(q_bar, 2 * kTile);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        tma_load(sQ + c * kBox, &tq, q_bar, c * 64, q0, h, b);
        tma_load(sdO + c * kBox, &tdo, q_bar, c * 64, q0, h, b);
      }
    }
    load_stats(stats, stats + kStat, lse, delta, (long long)bh * S, q0, S,
               lane, q_bar);
    if (lane == 0) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % ST;
        mbar_wait(empty(s), ((kt / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kTile);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(sK(s) + c * kBox, &tk, full(s), c * 64, kt * kTileRows,
                   hk, b);
          tma_load(sV(s) + c * kBox, &tv, full(s), c * 64, kt * kTileRows,
                   hk, b);
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float sc[32], dp[32];
  uint32_t da[4][4];

  mbar_wait(q_bar, 0);
  const float* stat = reinterpret_cast<const float*>(smem_raw + (stats - raw));
  const float nl[2] = {-stat[r0] * kLog2e, -stat[r0 + 8] * kLog2e};
  const float dl[2] = {stat[kTileRows + r0], stat[kTileRows + r0 + 8]};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % ST;
    mbar_wait(full(s), (kt / ST) & 1);

    // S = Q K^T and dP = dO V^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(sc, k_major(sQ, kk), k_major(sK(s), kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(dp, k_major(sdO, kk), k_major(sV(s), kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    fence_regs(dp);

    // P = exp(S scale - lse) under the mask (the diagonal tile and the tile
    // that holds SK), dS = P (dP - delta) in f32, packed to bf16 in place
    // as the A operand of dS K
    const int k0 = kt * kTileRows;
    const bool edge = k0 + kTileRows > SK ||
                      (causal && k0 + kTileRows - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) & 1;
      float x = fmaf(sc[i], scale_log2, nl[r]);
      if (edge) {
        const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        if (col >= SK || (causal && col > q0 + r0 + 8 * r + offset))
          x = -INFINITY;
      }
      dp[i] = ex2(x) * (dp[i] - dl[r]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        da[kk][e] = pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);

    // dQ += dS K, K read MN-major (keys the contraction)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (DP == 64)
        wgmma_rs_n64(acc, da[kk], mn_major(sK(s), kk));
      else
        wgmma_rs_n128(acc, da[kk], mn_major(sK(s), kk));
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_frags(da);
    mbar_arrive(empty(s));
  }

  __nv_bfloat16* dqh = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* qrow = dqh + (long long)row * sdq.s + 2 * t;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j < D)
        *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                  acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

struct Maps {
  CUtensorMap q, k, v, dO;
};

struct MmaArgs {
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, HQ, HKV, S, SK, D;
  OutStrides sdq, sdk, sdv;
  float scale, scale_log2;
  int causal, offset;
};

template <int DP, int ST, int MINB>
int launch_dkdv(const Maps& m, const MmaArgs& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>(2 + 2 * ST, ST, ST);
  auto kernel = flash_bwd_dkdv_mma_kernel<DP, ST, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)((a.SK + kTileRows - 1) / kTileRows) * a.B * a.HKV;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      m.q, m.k, m.v, m.dO, a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.B, a.HQ, a.HKV, a.S, a.SK, a.D, a.sdk, a.sdv, a.scale, a.scale_log2,
      a.causal, a.offset);
  return (int)cudaGetLastError();
}

template <int DP, int ST, int MINB>
int launch_dq(const Maps& m, const MmaArgs& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>(2 + 2 * ST, 1, ST);
  auto kernel = flash_bwd_dq_mma_kernel<DP, ST, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)((a.S + kTileRows - 1) / kTileRows) * a.B * a.HQ;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      m.q, m.k, m.v, m.dO, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq),
      a.B, a.HQ, a.HKV, a.S, a.SK, a.D, a.sdq, a.scale, a.scale_log2,
      a.causal, a.offset);
  return (int)cudaGetLastError();
}

// Error codes beside cudaError_t's, as flash_attention_mma_launch's.
constexpr int kNoEncoder = 9001;       // cuTensorMapEncodeTiled not found
constexpr int kBadTensorMap = 9002;    // a tensor map was refused

int backward(const void* q, const void* k, const void* v, const void* dO,
             const void* lse, const void* delta, void* dq, void* dk,
             void* dv, int B, int HQ, int HKV, int S, int SK, int D,
             const long long* st, float scale, int causal, int offset,
             int which, void* stream) {
  if (D < 8 || D > 128 || D % 8 != 0 || HKV < 1 || HQ % HKV != 0 || SK < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * HQ * S == 0) return (int)cudaGetLastError();
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  Maps m;
  if (tensor_map(&m.q, fn, q, B, HQ, S, D, st[0], st[1], st[2]) !=
          CUDA_SUCCESS ||
      tensor_map(&m.k, fn, k, B, HKV, SK, D, st[3], st[4], st[5]) !=
          CUDA_SUCCESS ||
      tensor_map(&m.v, fn, v, B, HKV, SK, D, st[6], st[7], st[8]) !=
          CUDA_SUCCESS ||
      tensor_map(&m.dO, fn, dO, B, HQ, S, D, st[9], st[10], st[11]) !=
          CUDA_SUCCESS)
    return kBadTensorMap;
  const MmaArgs a{static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, dk, dv, B, HQ, HKV,
                  S, SK, D, {st[12], st[13], st[14]},
                  {st[15], st[16], st[17]}, {st[18], st[19], st[20]}, scale,
                  scale * kLog2e, causal, offset};
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 0)
    return D <= 64 ? launch_dkdv<64, 3, 2>(m, a, s)
                   : launch_dkdv<128, 2, 1>(m, a, s);
  return D <= 64 ? launch_dq<64, 3, 2>(m, a, s)
                 : launch_dq<128, 2, 2>(m, a, s);
}

}  // namespace bwd_mma

// The tensor-core route: bf16 q, k, v, dO, dq, dk, dv; D <= 128, a multiple
// of 8; q, k, v and dO with 16-byte-aligned bases and (batch, head, row)
// strides that are positive multiples of 8 elements (their TMA tensor
// maps); strides and the rest as flash_bwd_dkdv_launch's.
extern "C" int flash_bwd_dkdv_mma_launch(const void* q, const void* k,
                                         const void* v, const void* dO,
                                         const void* lse, const void* delta,
                                         void* dk, void* dv, int B, int HQ,
                                         int HKV, int S, int SK, int D,
                                         const long long* strides,
                                         float scale, int causal, int offset,
                                         void* stream) {
  return bwd_mma::backward(q, k, v, dO, lse, delta, nullptr, dk, dv, B, HQ,
                           HKV, S, SK, D, strides, scale, causal, offset, 0,
                           stream);
}

extern "C" int flash_bwd_dq_mma_launch(const void* q, const void* k,
                                       const void* v, const void* dO,
                                       const void* lse, const void* delta,
                                       void* dq, int B, int HQ, int HKV,
                                       int S, int SK, int D,
                                       const long long* strides, float scale,
                                       int causal, int offset, void* stream) {
  return bwd_mma::backward(q, k, v, dO, lse, delta, dq, nullptr, nullptr, B,
                           HQ, HKV, S, SK, D, strides, scale, causal, offset,
                           1, stream);
}
