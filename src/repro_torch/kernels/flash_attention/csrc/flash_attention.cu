// Hand-written Hopper (sm_90a) kernel: causal GQA flash attention, forward.
//
// flash_fwd_kernel replaces the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
//   (_flash_kernel, pallas_call over the grid (B, HQ, q tiles, kv tiles)).
//
// What it computes (the Pallas kernel's function): q [B, HQ, S, D] and
// k/v [B, HKV, SK, D], bf16 or f32; query head h reads KV head
// h / (HQ / HKV); scores q.k * scale in f32 from the loaded inputs; mask
// k_pos < SK and, when causal, k_pos <= q_pos (aligned top-left), masked
// scores the finite -1e30; online softmax with an f32 running max, sum and
// accumulator; output acc / (l == 0 ? 1 : l) cast to q's type.
//
// What bounds it on this card: every (query, key) pair under the mask
// costs 4 * D floating-point operations (q.k and p.v) and the inputs are
// read once, so at the serving shape (B = 8, HQ = 16, S = SK = 2048,
// D = 128, bf16) the work is about 137 GFLOP against about 151 MB: some
// 900 operations per byte, far above the card's crossover of about 295.
// It is bound by operations.  The least time is that of the bf16 tensor
// cores (989 TFLOP/s); this first design keeps the reference's f32 math
// and runs it as f32 FMAs on the CUDA cores (67 TFLOP/s), so it sits
// more than an order of magnitude above that bound by construction.
// Tensor cores (mma/wgmma with bf16 operands) and TMA are later work.
//
// What the design does about it:
// - The TPU's sequential kv grid axis becomes a loop inside the block:
//   one block per (b, h, 64-row q tile), 256 threads, K/V tiles of 64
//   rows staged in shared memory as f32, running statistics in registers.
//   The S x SK scores never reach device memory.
// - Register tiling: each thread holds a 4 x 4 block of the 64 x 64 score
//   tile (rows by ty, columns tx + 16 j) and a 4 x D/16 block of the
//   output (columns 64 g + 4 tx .. + 3), so each 16-byte shared-memory
//   load feeds 4 to 8 FMAs.  Row statistics are reduced across the 16
//   threads of a half-warp with shuffles.  Q and K rows are padded by 4
//   floats so the 16-byte loads are free of bank conflicts.
// - Tiles wholly above the diagonal are skipped (kernel.py:61-64), and the
//   heaviest q tiles (the last ones under a causal mask) start first.
// - The ragged edge is masked here, not padded by copies: rows past S or
//   SK and columns past D stage as zeros, and only real rows and columns
//   are stored.  Inputs are read through their own strides (the last
//   dimension contiguous), so the transposed views the model hands over
//   are read in place and the output is written in q's layout.
// - GQA: the HQ / HKV query heads of one KV head read the same K/V tiles,
//   which stay in the 50 MB L2.
//
// The entry point returns cudaGetLastError() after the launch, so a
// refused launch surfaces in the Python wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;          // query rows per block
constexpr int TK = 64;          // keys per staged tile
constexpr int kThreads = 256;   // 16 x 16: ty picks 4 rows, tx the columns
constexpr float kNegInf = -1e30f;

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

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int B,
                     int HQ, int HKV, int S, int SK, int D, Strides sq,
                     Strides sk, Strides sv, Strides so, float scale,
                     int causal) {
  constexpr int LDQ = DP + 4;   // Q/K row stride: conflict-free float4 reads
  constexpr int LDP = TK + 4;
  constexpr int NG = DP / 64;   // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [TQ][LDQ]
  float* Ks = Qs + TQ * LDQ;                     // [TK][LDQ]
  float* Vs = Ks + TK * LDQ;                     // [TK][DP]
  float* Ps = Vs + TK * DP;                      // [TQ][LDP]

  const int BH = B * HQ;
  const int n_qt = (S + TQ - 1) / TQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);   // heaviest first
  const int b = bh / HQ, h = bh % HQ;
  const int hk = h / (HQ / HKV);
  const int q0 = qt * TQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + hk * sk.h;
  const T* vh = v + b * sv.b + hk * sv.h;
  stage<T, TQ, DP, LDQ>(Qs, qh, sq.s, q0, S, D);

  float m[4], l[4], acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }

  int n_kt = (SK + TK - 1) / TK;
  if (causal) n_kt = min(n_kt, (q0 + TQ - 1) / TK + 1);   // skip above diag
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TK;
    __syncthreads();   // Q staged; the previous tile's reads are done
    stage<T, TK, DP, LDQ>(Ks, kh, sk.s, k0, SK, D);
    stage<T, TK, DP, DP>(Vs, vh, sv.s, k0, SK, D);
    __syncthreads();

    // scores s[i][j] of row ty*4+i and key tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * LDQ + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LDQ + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        const bool ok = k_pos < SK && (!causal || k_pos <= q_pos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * LDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P V over the tile's keys
#pragma unroll 2
    for (int c = 0; c < TK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * LDP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(c + cc) * DP + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pv[i].x
                            : cc == 1 ? pv[i].y
                            : cc == 2 ? pv[i].z
                                      : pv[i].w;
            acc[i][g][0] = fmaf(p, vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, vv.w, acc[i][g][3]);
          }
        }
      }
    }
  }

  T* oh = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = g * 64 + tx * 4 + c;
        if (d < D) oh[(long long)row * so.s + d] = from_f32<T>(acc[i][g][c] / li);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int HQ, int HKV, int S, int SK, int D, Strides sq, Strides sk,
           Strides sv, Strides so, float scale, int causal,
           cudaStream_t stream) {
  constexpr int smem = (TQ * (DP + 4) + TK * (DP + 4) + TK * DP +
                        TQ * (TK + 4)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((S + TQ - 1) / TQ) * B * HQ;
  flash_fwd_kernel<T, DP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), B, HQ, HKV, S, SK, D, sq,
      sk, sv, so, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int HQ, int HKV, int S, int SK, int D, Strides sq, Strides sk,
             Strides sv, Strides so, float scale, int causal,
             cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, HQ, HKV, S, SK, D, sq, sk, sv, so,
                         scale, causal, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, HQ, HKV, S, SK, D, sq, sk, sv, so,
                          scale, causal, stream);
  return launch<T, 256>(q, k, v, o, B, HQ, HKV, S, SK, D, sq, sk, sv, so,
                        scale, causal, stream);
}

}  // namespace

// is_bf16: 1 for bf16 tensors, 0 for f32.  Strides are in elements, per
// tensor (batch, head, row); the last dimension is contiguous.  D <= 256,
// HQ a multiple of HKV, SK >= 1.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int HQ, int HKV, int S, int SK, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, void* stream) {
  if (D < 1 || D > 256 || HKV < 1 || HQ % HKV != 0 || SK < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * HQ * S == 0) return (int)cudaGetLastError();
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss},
      sv{v_sb, v_sh, v_ss}, so{o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, HQ, HKV, S, SK, D, sq, sk,
                                   sv, so, scale, causal, s);
  return dispatch<float>(q, k, v, o, B, HQ, HKV, S, SK, D, sq, sk, sv, so,
                         scale, causal, s);
}
