// Hand-written Hopper (sm_90a) kernels: causal GQA flash attention, forward.
//
// Both replace the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
//   (_flash_kernel, pallas_call over the grid (B, HQ, q tiles, kv tiles)).
// The Python wrapper (kernel.py::route) sends bf16 inputs with D <= 128, a
// multiple of 8, and 16-byte-aligned bases and row strides to the
// tensor-core kernel below and everything else to the f32 kernel after it.
//
// Both also serve training (kernel.py::flash_attention_lse, the forward of
// ops.py::ChunkedAttention, whose backward is flash_attention_bwd.cu): an
// optional f32 lse [B, HQ, S] output, each row's log-sum-exp of its scaled
// scores (a null pointer writes nothing, as serving passes), and a causal
// diagonal offset, k_pos <= q_pos + offset, with the causal k-tile count
// bounded to match (serving passes 0: the top-left mask below; training
// SK - S, the reference's chunked_attention aligning it bottom-right).
//
// ---------------------------------------------------------------------------
// The bf16 route: flash_mma_kernel (entry point flash_attention_mma_launch).
//
// What it computes: the Pallas kernel's function (q [B, HQ, S, D], k/v
// [B, HKV, SK, D]; query head h reads KV head h / (HQ / HKV); scores q.k *
// scale in f32; mask k_pos < SK and, when causal, k_pos <= q_pos, aligned
// top-left; masked scores the finite -1e30; online softmax with f32 running
// max and sum; output acc / (l == 0 ? 1 : l) in bf16), except that the
// probabilities p are rounded to bf16 for the p.v product, as SDPA and
// FlashAttention do.  q.k is exact: a product of two bf16 values is exact
// in f32, so only the summation order differs from the reference.
//
// What bounds it on this card: operations.  At the serving shape (B = 8,
// HQ = 16, HKV = 2, S = SK = 2048, D = 128, causal) the pairs under the
// mask need 4 * D operations each, about 137 GFLOP against about 151 MB of
// inputs and output: 139 us at the bf16 tensor-core peak (989 TFLOP/s),
// 45 us at 3.35 TB/s.  The f32 kernel runs the same work on the CUDA cores
// (67 TFLOP/s peak), so it cannot come within 15x of that bound.
//
// What the design does about it:
// - Both products on the tensor cores with bf16 operands and f32
//   accumulation (wgmma).  One block per (b, h, 64-row q tile): a consumer
//   warpgroup (warps 0-3) owns the 64 query rows; S = Q K^T is
//   wgmma.m64n64k16 with Q and K from shared memory, both K-major (D is the
//   contraction axis); O += P V is wgmma.m64n{D}k16 with P from registers
//   and V from shared memory read transposed (MN-major) through its
//   descriptor.
// - P never leaves the registers: the S accumulator's layout (thread lane
//   holds rows lane/4 and lane/4 + 8 of its warp's 16, columns 2 (lane % 4)
//   + 8 j and the next) is the A-operand layout of the second product, so
//   after the online-softmax update each pair of probabilities is packed to
//   bf16x2 in place.  Row max and sum are reduced across the four threads
//   of a row with quad shuffles (the sum once, at the end); exp2 with
//   scale * log2(e) folded into one FMA.
// - Asynchronous staging: a producer warp (warp 4) issues TMA loads
//   (cp.async.bulk.tensor.4d over [B, H, S, D] with the caller's strides,
//   128-byte swizzle, zero fill past S and SK) of Q once and of each
//   64-key K/V tile into a ring of stages in shared memory, with a full and
//   an empty mbarrier per stage, so tile j + 1 loads while tile j computes.
//   The tensor maps are encoded on the host per launch, with
//   cuTensorMapEncodeTiled taken from the driver through
//   cudaGetDriverEntryPointByVersion (cudaGetDriverEntryPoint before CUDA
//   12.5), so the build needs no -lcuda.
// - Causal work: tiles wholly above the diagonal are never loaded; only
//   the diagonal tile and the tile that holds SK are masked element by
//   element (zero-filled keys past SK score 0, not -1e30, so they are
//   masked too); the heaviest q tiles start first.
// - Occupancy: 160 threads; shared memory (1 + 2 ST) * D * 128 bytes for
//   the tiles, a 1 KB alignment pad and 8 bytes for each of the 1 + 2 ST
//   barriers: D = 128 with ST = 2 stages 81,920 + 1,064 bytes, two blocks
//   (10 warps) per SM; D = 64 with ST = 3 57,344 + 1,080 bytes, three
//   blocks (15 warps) per SM.  Registers:
//   __launch_bounds__(160, 2 or 3) caps them at 204 (D = 128) or 136 (D =
//   64) per thread; the consumer holds the S tile (32 f32), the O tile
//   (D / 2 f32) and P (16 bf16x2).
// - The output is written from registers in q's layout (bf16 pairs), rows
//   past S not at all.
// - Head dims other than 64 and 128 (D <= 128, a multiple of 8; Zamba2's
//   80) run the instantiation of width DP = 64 (D <= 64) or 128 with no
//   copy: the tensor maps keep the real D as their inner extent, so TMA
//   fills columns D..DP-1 of every Q, K and V box with zeros (the box still
//   moves its full bytes, so the expect_tx counts do not change).  The zero
//   columns add exactly 0 to q.k and give zero accumulator columns in P V;
//   the epilogue writes only the 8-column groups below D.  The loops run
//   over all of DP: at D = 80, 48 of 128 columns are zeros.
//
// ---------------------------------------------------------------------------
// The f32 route: flash_fwd_kernel (entry point flash_attention_launch).
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
// cores (989 TFLOP/s); this kernel keeps the reference's f32 math and
// runs it as f32 FMAs on the CUDA cores (67 TFLOP/s), so it sits more
// than an order of magnitude above that bound by construction.  It is
// the route of f32 inputs (held to 2e-5, which bf16 products cannot
// meet), of bf16 with other head dims and of unaligned views; bf16 at
// D = 64 and 128 takes the tensor-core kernel above.
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

#include <cmath>

#include "hopper.cuh"

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
                     int causal, int offset, float* __restrict__ lse) {
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
  if (causal) {   // skip the tiles above the diagonal k_pos = q_pos + offset
    const int last = q0 + TQ - 1 + offset;
    n_kt = min(n_kt, last < 0 ? 0 : last / TK + 1);
  }
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
        const bool ok = k_pos < SK && (!causal || k_pos <= q_pos + offset);
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
    if (lse != nullptr && tx == 0)   // the reference's m + log(max(l, 1e-37))
      lse[(long long)bh * S + row] = m[i] + logf(fmaxf(l[i], 1e-37f));
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
           Strides sv, Strides so, float scale, int causal, int offset,
           float* lse, cudaStream_t stream) {
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
      sk, sv, so, scale, causal, offset, lse);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int HQ, int HKV, int S, int SK, int D, Strides sq, Strides sk,
             Strides sv, Strides so, float scale, int causal, int offset,
             float* lse, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, HQ, HKV, S, SK, D, sq, sk, sv, so,
                         scale, causal, offset, lse, stream);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, HQ, HKV, S, SK, D, sq, sk, sv, so,
                          scale, causal, offset, lse, stream);
  return launch<T, 256>(q, k, v, o, B, HQ, HKV, S, SK, D, sq, sk, sv, so,
                        scale, causal, offset, lse, stream);
}

}  // namespace

// is_bf16: 1 for bf16 tensors, 0 for f32.  Strides are in elements, per
// tensor (batch, head, row); the last dimension is contiguous.  D <= 256,
// HQ a multiple of HKV, SK >= 1.  Causal: k_pos <= q_pos + offset.  lse:
// null, or f32 [B, HQ, S] for each row's log-sum-exp of its scaled scores.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int HQ, int HKV, int S, int SK, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int offset,
    void* lse, void* stream) {
  if (D < 1 || D > 256 || HKV < 1 || HQ % HKV != 0 || SK < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * HQ * S == 0) return (int)cudaGetLastError();
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss},
      sv{v_sb, v_sh, v_ss}, so{o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, HQ, HKV, S, SK, D, sq, sk,
                                   sv, so, scale, causal, offset,
                                   static_cast<float*>(lse), s);
  return dispatch<float>(q, k, v, o, B, HQ, HKV, S, SK, D, sq, sk, sv, so,
                         scale, causal, offset, static_cast<float*>(lse), s);
}

// ---------------------------------------------------------------------------
// The bf16 route: the tensor-core kernel.
// ---------------------------------------------------------------------------
namespace mma {

using namespace hopper;

constexpr int kRows = 64;             // query rows per block (one warpgroup)
constexpr int kKeys = 64;             // keys per K/V tile
constexpr int kThreads = 160;         // consumer warpgroup + producer warp
constexpr int kConsumers = 128;
constexpr float kNegInf = -1e30f;

struct OutStrides {
  long long b, h, s;   // in elements; the last dimension is dense
};

template <int DP, int ST>
constexpr int smem_bytes() {
  return (1 + 2 * ST) * (DP / 64) * kBox + 1024 + 8 * (1 + 2 * ST);
}

// DP: the instantiation's width, 64 or 128; D: the head dim, at most DP and
// a multiple of 8 (columns D..DP-1 arrive as TMA's zero fill).
template <int DP, int ST, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    flash_mma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ o, int B, int HQ, int HKV,
                     int S, int SK, int D, OutStrides so, float scale_log2,
                     int causal, int offset, float* __restrict__ lse) {
  constexpr int NB = DP / 64;           // 64-column boxes per row
  constexpr int kTile = NB * kBox;      // one Q, K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t bars = base + (1 + 2 * ST) * kTile;
  const uint32_t q_bar = bars;
  auto sK = [&](int s) { return base + (1 + 2 * s) * kTile; };
  auto sV = [&](int s) { return base + (2 + 2 * s) * kTile; };
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * ST + 8 * s; };

  const int BH = B * HQ;
  const int n_qt = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);   // heaviest first
  const int b = bh / HQ, h = bh % HQ;
  const int hk = h / (HQ / HKV);
  const int q0 = qt * kRows;
  int n_kt = (SK + kKeys - 1) / kKeys;
  if (causal) {   // offset 0: qt + 1 tiles, as q0 + 63 < (qt + 1) * 64
    const int last = q0 + kRows - 1 + offset;
    n_kt = min(n_kt, last < 0 ? 0 : last / kKeys + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    // producer: Q once, then the K/V ring
    if (lane == 0) {
      mbar_expect_tx(q_bar, kTile);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load(sQ + c * kBox, &tq, q_bar, c * 64, q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % ST;
        mbar_wait(empty(s), ((kt / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kTile);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          tma_load(sK(s) + c * kBox, &tk, full(s), c * 64, kt * kKeys, hk, b);
          tma_load(sV(s) + c * kBox, &tv, full(s), c * 64, kt * kKeys, hk, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: thread lane of warp w holds rows r0 = 16 w + lane/4
  // and r0 + 8 of the tile, columns 8 j + 2 (lane % 4) and the next
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float sc[32];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(q_bar, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % ST;
    mbar_wait(full(s), (kt / ST) & 1);

    // S = Q K^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(sc, k_major(sQ, kk), k_major(sK(s), kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    // mask the diagonal tile and the tile that holds SK
    const int k0 = kt * kKeys;
    if (k0 + kKeys > SK || (causal && k0 + kKeys - 1 > q0 + offset)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        const int row = q0 + r0 + 8 * ((i / 2) & 1);
        if (col >= SK || (causal && col > row + offset)) sc[i] = kNegInf;
      }
    }

    // online softmax on the scores in registers (log2 domain)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) & 1;
      mx[r] = fmaxf(mx[r], sc[i] * scale_log2);
    }
    float alpha[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      mc[r] = -mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) & 1;
      sc[i] = ex2(fmaf(sc[i], scale_log2, mc[r]));
      l[r] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i / 2) & 1];

    // O += P V, P packed to bf16 in place as the A operand
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (DP == 64)
        wgmma_rs_n64(acc, pa[kk], mn_major(sV(s), kk));
      else
        wgmma_rs_n128(acc, pa[kk], mn_major(sV(s), kk));
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    mbar_arrive(empty(s));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // the row's natural log-sum-exp: m is the log2-domain running max
    if (lse != nullptr && t == 0 && q0 + r0 + 8 * r < S)
      lse[(long long)bh * S + q0 + r0 + 8 * r] =
          m[r] * 0.6931471805599453f + logf(fmaxf(l[r], 1e-37f));
    l[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
  __nv_bfloat16* oh = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = oh + (long long)row * so.s + 2 * t;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      // a predicate, not a break: the loop stays unrolled, acc in registers
      if (8 * j < D)   // columns D..DP-1 are the zero fill
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * l[r],
                                  acc[4 * j + 2 * r + 1] * l[r]);
    }
  }
}

template <int DP, int ST, int MINB>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           void* o, int B, int HQ, int HKV, int S, int SK, int D,
           OutStrides so, float scale_log2, int causal, int offset,
           float* lse, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP, ST>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<DP, ST, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((S + kRows - 1) / kRows) * B * HQ;
  flash_mma_kernel<DP, ST, MINB><<<(unsigned)blocks, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, HQ, HKV, S, SK, D, so,
      scale_log2, causal, offset, lse);
  return (int)cudaGetLastError();
}

}  // namespace mma

// Error codes of flash_attention_mma_launch beside cudaError_t's.
#define FA_MMA_NO_ENCODER 9001       // cuTensorMapEncodeTiled not found
#define FA_MMA_BAD_TENSOR_MAP 9002   // a tensor map was refused

// bf16 q/k/v/o; D <= 128, a multiple of 8; bases 16-byte aligned; strides
// in elements (batch, head, row), multiples of 8, the last dimension
// contiguous; HQ a multiple of HKV, SK >= 1.  Causal, offset and lse as
// flash_attention_launch's.
extern "C" int flash_attention_mma_launch(
    const void* q, const void* k, const void* v, void* o, int B, int HQ,
    int HKV, int S, int SK, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int offset,
    void* lse, void* stream) {
  if (D < 8 || D > 128 || D % 8 != 0 || HKV < 1 || HQ % HKV != 0 || SK < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * HQ * S == 0) return (int)cudaGetLastError();
  hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return FA_MMA_NO_ENCODER;
  CUtensorMap tq, tk, tv;
  if (hopper::tensor_map(&tq, fn, q, B, HQ, S, D, q_sb, q_sh, q_ss) !=
          CUDA_SUCCESS ||
      hopper::tensor_map(&tk, fn, k, B, HKV, SK, D, k_sb, k_sh, k_ss) !=
          CUDA_SUCCESS ||
      hopper::tensor_map(&tv, fn, v, B, HKV, SK, D, v_sb, v_sh, v_ss) !=
          CUDA_SUCCESS)
    return FA_MMA_BAD_TENSOR_MAP;
  const mma::OutStrides so{o_sb, o_sh, o_ss};
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = (cudaStream_t)stream;
  if (D <= 64)
    return mma::launch<64, 3, 3>(tq, tk, tv, o, B, HQ, HKV, S, SK, D, so,
                                 scale_log2, causal, offset,
                                 static_cast<float*>(lse), s);
  return mma::launch<128, 2, 2>(tq, tk, tv, o, B, HQ, HKV, S, SK, D, so,
                                scale_log2, causal, offset,
                                static_cast<float*>(lse), s);
}
