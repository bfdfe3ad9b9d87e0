// Hand-written Hopper (sm_90a) kernels: causal GQA flash attention, forward.
//
// Both replace the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
//   (_flash_kernel, pallas_call over the grid (B, HQ, q tiles, kv tiles)).
// The Python wrapper (kernel.py::route) sends bf16 inputs with D <= 128, a
// multiple of 8, and 16-byte-aligned bases and row strides to the
// tensor-core kernel below and everything else to the f32-route kernel
// after it (split TF32 on mma.sync).
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
// 45 us at 3.35 TB/s.  The f32 route runs the same work as three split
// TF32 products (495 TFLOP/s peak), so it cannot come within 6x of it.
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
//   (_flash_kernel, pallas_call over the grid (B, HQ, q tiles, kv tiles))
// for every input the tensor-core kernel above does not take: float32
// (held to 2e-5, which bf16 products cannot meet), and bf16 with a head
// dim that is not a multiple of 8 or above 128, or a base or stride TMA
// refuses.
//
// What it computes (the Pallas kernel's function): q [B, HQ, S, D] and
// k/v [B, HKV, SK, D], bf16 or f32, D <= 256, any strides with the last
// dimension contiguous; query head h reads KV head h / (HQ / HKV); scores
// q.k * scale in f32; mask k_pos < SK and, when causal, k_pos <= q_pos +
// offset; masked scores the finite -1e30; online softmax with an f32
// running max, sum and accumulator; output acc / (l == 0 ? 1 : l) in q's
// type and layout, and the optional lse.
//
// Numerics: f32 sums of products formed on the tensor cores in split TF32
// (tf32.cuh): each float32 operand v split into hi = tf32(v) and lo = v -
// hi, a product a_lo b_hi + a_hi b_lo + a_hi b_hi, about float32's
// accuracy (ref.flash_attention_ref(..., split_tf32=True) and
// ref.chunked_fwd(..., split_tf32=True) emulate it on the CPU; one TF32
// product alone reads some 1e-4 off).  A bf16 operand is exact in TF32 and
// drops its lo term: on bf16, S = Q K^T is one product and P V two (p is
// always float32).  The tensor cores add with truncation, so no sum runs
// long on them: S's small terms have their own accumulators (its hi chain
// is D / 8 long), each K/V tile's P V starts from zero, its small terms
// again apart, and joins the running O by the CUDA cores' rounded f32
// adds (o = o alpha + tile), in a fixed order.  No atomics: a run repeats
// bit for bit.
//
// What bounds it on this card: operations.  Every (query, key) pair under
// the mask costs 4 D operations (q.k and p.v); at float32 q [2, 16, 2048,
// 128], k/v [2, 2, 2048, 128], causal, 34.38 GFLOP against some 75 MB:
// 513 us at the f32 CUDA-core peak (67 TFLOP/s: the bound of the design
// this one replaced, scalar FMAs on the CUDA cores), 208 us for the three
// split products at the TF32 tensor-core peak (495 TFLOP/s).
//
// What the design does about it:
// - Both products on mma.sync.m16n8k8 TF32 (wgmma's TF32 kind reads its
//   B operand K-major only: V would need a transposed split copy).  One
//   block per (b, h, 64-row q tile), heaviest first, 4 warps, each owning
//   16 query rows across every key of a tile: the row statistics stay in
//   one warp (quad shuffles), no partial sums between warps.
// - The contraction index is permuted (k = t <-> column 2t, k = t + 4 <->
//   2t + 1) in both operands of both products.  So an A or B fragment of
//   S = Q K^T is one 8-byte (f32) or 4-byte (bf16) load a row, and the S
//   accumulator's fragment (rows g, g + 8; columns 2t, 2t + 1) is P's A
//   fragment as it stands: P never leaves the registers and needs no
//   shuffle; V's B fragment is two column loads.
// - Asynchronous staging: Q once a block, then the K/V tiles through a
//   two-stage cp.async ring (16-byte copies where a tensor's base and
//   strides allow, else 4-byte, else plain loads: a bf16 view offset by
//   one element), raw in the input's type, rows past S or SK and columns
//   past D zero-filled in place: no padding copies.  Tile kt + 1's copies
//   are in flight while tile kt is multiplied; one barrier a tile.
// - Each operand is split in registers as its fragment is loaded (Q's
//   once a k step, reused across the tile's key columns).  A split copy of
//   Q, K and V in shared memory would double the tiles and leave one block
//   an SM; raw tiles keep two: 90,112 bytes at D <= 64 (64-key tiles),
//   103,424 at D <= 128 (32-key tiles), float32; __launch_bounds__(128,
//   2).  D <= 256 runs with 16-key tiles and one block an SM (134,656).
//   Row strides of the width + 8 (Q, K) and + 4 (float32 V) elements
//   keep the fragment loads free of bank conflicts.  chip_smoke.py logs ptxas's
//   registers and spills for each instantiation.
// - Tiles wholly above the causal diagonal are skipped; only the diagonal
//   tile and the tile that holds SK are masked element by element.
// - GQA: the HQ / HKV query heads of one KV head read the same K/V tiles,
//   which stay in the 50 MB L2.
//
// The entry point returns cudaGetLastError() after the launch, so a
// refused launch surfaces in the Python wrapper.

#include <cmath>

#include "hopper.cuh"
#include "tf32.cuh"

namespace f32route {

using namespace tf32;

constexpr int TQ = 64;               // query rows per block, 16 a warp
constexpr int kThreads = 2 * TQ;     // 4 warps
constexpr float kNegInf = -1e30f;

// The cp.async width (16 or 4 bytes; 0: plain loads) of each input's rows.
struct Vec {
  int q, k, v;
};

// The kernel's tiles, by input type and width DP (64, 128 or 256).
template <typename T, int DP>
struct Tiles {
  static constexpr bool kExact = sizeof(T) == 2;   // bf16: lo = 0
  static constexpr int TK = DP == 64 ? 64 : DP == 128 ? 32 : 16;   // keys
  static constexpr int NT = TK / 8;        // a warp's key column tiles
  // P V column tiles a batch (at width 128 one: two spill 12 bytes)
  static constexpr int NC = DP == 64 ? 4 : DP == 128 ? 1 : 2;
  static constexpr int MINB = DP == 256 ? 1 : 2;  // blocks an SM
  static constexpr int LDQ = DP + 8;       // Q and K rows, in elements
  static constexpr int LDV = kExact ? DP + 8 : DP + 4;   // V rows
  static constexpr int kStage = TK * (LDQ + LDV);        // K and V tiles
  static constexpr int kSmem = (TQ * LDQ + 2 * kStage) * (int)sizeof(T);
  static_assert(kSmem <= 232448, "one block's shared memory");
  static_assert((DP / 8) % NC == 0, "P V batches cover the width");
};

// Columns c and c + 1 of a row in shared memory, as f32.
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// v as a TF32 operand: hi (and lo, unless v is exact in TF32).
template <bool kExact>
__device__ __forceinline__ void operand(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (kExact)
    hi = __float_as_uint(v);
  else
    split(v, hi, lo);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, Tiles<T, DP>::MINB)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int B,
                     int HQ, int HKV, int S, int SK, int D, Strides sq,
                     Strides sk, Strides sv, Strides so, float scale,
                     int causal, int offset, float* __restrict__ lse,
                     Vec vec) {
  using C = Tiles<T, DP>;
  constexpr bool kExact = C::kExact;
  constexpr int TK = C::TK, NT = C::NT, NC = C::NC;
  constexpr int LDQ = C::LDQ, LDV = C::LDV;
  extern __shared__ float4 smem4[];
  T* const Qs = reinterpret_cast<T*>(smem4);   // [TQ][LDQ]
  // stage st: K [TK][LDQ], then V [TK][LDV]
  auto Ks = [&](int st) { return Qs + TQ * LDQ + st * C::kStage; };
  auto Vs = [&](int st) { return Ks(st) + TK * LDQ; };

  const int BH = B * HQ;
  const int n_qt = (S + TQ - 1) / TQ;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);   // heaviest first
  const int b = bh / HQ, h = bh % HQ;
  const int hk = h / (HQ / HKV);
  const int q0 = qt * TQ;
  int n_kt = (SK + TK - 1) / TK;
  if (causal) {   // skip the tiles above the diagonal k_pos = q_pos + offset
    const int last = q0 + TQ - 1 + offset;
    n_kt = min(n_kt, last < 0 ? 0 : last / TK + 1);
  }

  const T* kh = k + b * sk.b + hk * sk.h;
  const T* vh = v + b * sv.b + hk * sv.h;
  auto issue = [&](int kt) {   // tile kt into stage kt % 2
    load_rows<T, TK, DP, LDQ, kThreads>(Ks(kt & 1), kh, sk.s, kt * TK, SK,
                                        D, vec.k);
    load_rows<T, TK, DP, LDV, kThreads>(Vs(kt & 1), vh, sv.s, kt * TK, SK,
                                        D, vec.v);
  };
  // Q and the first tile in one group
  load_rows<T, TQ, DP, LDQ, kThreads>(Qs, q + b * sq.b + h * sq.h, sq.s, q0,
                                      S, D, vec.q);
  if (n_kt > 0) issue(0);
  cp_async_commit();

  // thread lane of warp w: rows r0 + g and r0 + g + 8 of the tile, columns
  // 8 j + 2t and the next of each 8-wide tile of S and O
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp;
  const T* const qa = Qs + (r0 + g) * LDQ + 2 * t;
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();   // tile kt has landed; tile kt - 1's reads are done
    if (kt + 1 < n_kt) issue(kt + 1);
    cp_async_commit();
    const T* const Kt = Ks(kt & 1);
    const T* const Vt = Vs(kt & 1);

    // S = Q K^T over the width, the small terms apart (float32)
    float s[NT][4], sl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < DP / 8; ++kb) {
      uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
      const float2 x0 = pair(qa + 8 * kb), x1 = pair(qa + 8 * LDQ + 8 * kb);
      operand<kExact>(x0.x, ah[0], al[0]);
      operand<kExact>(x1.x, ah[1], al[1]);
      operand<kExact>(x0.y, ah[2], al[2]);
      operand<kExact>(x1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 y = pair(Kt + (8 * j + g) * LDQ + 8 * kb + 2 * t);
        operand<kExact>(y.x, bh[j][0], bl[j][0]);
        operand<kExact>(y.y, bh[j][1], bl[j][1]);
      }
      mma3<kExact, kExact, NT>(s, sl, ah, al, bh, bl);
    }

    // scale, mask (the diagonal tile and the tile that holds SK), and the
    // online-softmax update of the thread's two rows
    const int k0 = kt * TK;
    const bool edge = k0 + TK > SK || (causal && k0 + TK - 1 > q0 + offset);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (kExact ? s[j][e] : s[j][e] + sl[j][e]) * scale;
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = q0 + r0 + g + 8 * (e >> 1);
          if (key >= SK || (causal && key > row + offset)) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
    // P = exp(S - m), split as the A operand of P V (k permuted: the
    // accumulator's fragment in place)
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[j][e] - m[e >> 1]);
        ls[e >> 1] += p[e];
      }
      split(p[0], ph[j][0], pl[j][0]);
      split(p[2], ph[j][1], pl[j][1]);
      split(p[1], ph[j][2], pl[j][2]);
      split(p[3], ph[j][3], pl[j][3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];

    // O = O alpha + P V: the tile's sum from zero (its small terms apart),
    // NC column tiles at a time, then one rounded fold into O
#pragma unroll
    for (int n0 = 0; n0 < DP / 8; n0 += NC) {
      float tv[NC][4], te[NC][4];
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) tv[i][e] = te[i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t vh_[NC][2], vl_[NC][2];
        const T* const vb = Vt + (8 * j + 2 * t) * LDV + 8 * n0 + g;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          operand<kExact>(to_f32(vb[8 * i]), vh_[i][0], vl_[i][0]);
          operand<kExact>(to_f32(vb[LDV + 8 * i]), vh_[i][1], vl_[i][1]);
        }
        mma3<false, kExact, NC>(tv, te, ph[j], pl[j], vh_, vl_);
      }
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n0 + i][e] =
              fmaf(acc[n0 + i][e], alpha[e >> 1], tv[i][e] + te[i][e]);
    }
  }

  // the row sums over the quad, the lse, and O / l in q's layout
  T* const oh = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + r0 + g + 8 * r;
    if (row >= S) continue;
    if (lse != nullptr && t == 0)   // the reference's m + log(max(l, 1e-37))
      lse[(long long)bh * S + row] = m[r] + logf(fmaxf(l[r], 1e-37f));
    const float li = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < D)
          oh[(long long)row * so.s + d] = from_f32<T>(acc[n][2 * r + e] / li);
      }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int HQ, int HKV, int S, int SK, int D, Strides sq, Strides sk,
           Strides sv, Strides so, float scale, int causal, int offset,
           float* lse, cudaStream_t stream) {
  using C = Tiles<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int elem = (int)sizeof(T);
  const Vec vec{vec_bytes(q, sq, elem), vec_bytes(k, sk, elem),
                vec_bytes(v, sv, elem)};
  const long long blocks = (long long)((S + TQ - 1) / TQ) * B * HQ;
  flash_fwd_kernel<T, DP><<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), B, HQ, HKV, S, SK, D, sq,
      sk, sv, so, scale, causal, offset, lse, vec);
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

}  // namespace f32route

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
  const tf32::Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss},
      sv{v_sb, v_sh, v_ss}, so{o_sb, o_sh, o_ss};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return f32route::dispatch<__nv_bfloat16>(
        q, k, v, o, B, HQ, HKV, S, SK, D, sq, sk, sv, so, scale, causal,
        offset, static_cast<float*>(lse), s);
  return f32route::dispatch<float>(q, k, v, o, B, HQ, HKV, S, SK, D, sq, sk,
                                   sv, so, scale, causal, offset,
                                   static_cast<float*>(lse), s);
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
