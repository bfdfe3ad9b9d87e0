// Hand-written Hopper (sm_90a) kernels: GQA flash attention, backward.
//
// They replace no pallas_call: the reference's training attention,
//   src/repro/kernels/flash_attention/ops.py::chunked_attention,
// is an online softmax in XLA with a custom VJP, _chunked_core_bwd, which
// recomputes the probabilities blockwise from the saved (q, k, v, o, lse)
// and keeps O(S) residuals.  These three kernels are that VJP on the card,
// behind ops.py::ChunkedAttention, whose forward is the flash_attention
// kernel with its log-sum-exp output (flash_attention.cu).
//
// What they compute (the reference's function, in f32 from the loaded
// bf16 or f32 inputs): with s = q.k * scale masked to the finite -1e30
// (keys at or past SK; causal: k_pos > q_pos + offset, offset = SK - S,
// the reference's bottom-right alignment), p = exp(s - lse),
//   delta = rowsum(dO o)                         (flash_bwd_delta_kernel)
//   dv = p^T dO, dk = (p (dO v^T - delta))^T q * scale
//        summed over the G = HQ / HKV query heads of each KV head
//                                                (flash_bwd_dkdv_kernel)
//   dq = (p (dO v^T - delta)) k * scale          (flash_bwd_dq_kernel)
// each output cast to its input's type.  Every output element is summed by
// one thread in a fixed order: no atomics, so a run repeats bit for bit.
//
// What bounds them on this card: operations.  The backward does five
// products per (query, key) pair under the mask (s, dO v^T, p^T dO, dS^T q,
// dS k: 2.5 times the forward's two), 10 D operations a pair; at the
// training shape (B = 4, 16 heads, S = SK = 4096, D = 64, causal) some 344
// GFLOP, 348 us at the bf16 tensor-core peak against 28 MB of inputs and
// outputs.  These kernels recompute s and dO v^T in each of the two passes
// (seven products a pair) on the CUDA cores in f32 (67 TFLOP/s peak), so
// they sit far above that bound by construction: a simple design that is
// right, the tensor cores (wgmma) and TMA staging are later work.
//
// What the design does about it:
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

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
