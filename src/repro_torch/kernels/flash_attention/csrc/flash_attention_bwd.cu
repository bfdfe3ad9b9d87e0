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
// points flash_bwd_dkdv_launch, flash_bwd_dq_launch), for float32 inputs
// and every bf16 view the tensor-core route does not take (a head dim
// that is not a multiple of 8, a base or stride TMA refuses): any D <=
// 128, any strides with the last dimension contiguous, any base.
//
// Numerics: f32 sums of products formed on the tensor cores in split TF32
// (tf32.cuh): each float32 operand split once into hi = tf32(v) and lo =
// v - hi, a product a_lo b_hi + a_hi b_lo + a_hi b_hi (tf32.cuh's mma3),
// which is about as accurate as float32 (ref.chunked_bwd(...,
// split_tf32=True) emulates it on the CPU; one TF32 product alone reads
// some 5e-4 off).  p = expf(s scale - lse) and dS = p (dP - delta) are
// formed in f32 and split in registers, each value once.  On a bf16 view
// q, k, v and dO are exact in TF32 (lo = 0): s and dO v^T take one
// product, dV, dK and dQ two.  The tensor cores add into an accumulator
// with truncation (each mma loses up to an ulp of it, toward zero), so
// no sum runs long on them: each tile's dK, dV and dQ terms start from
// zero (3 NT chained mma) and join the running sums by rounded f32 adds,
// and in float32 the score products' small terms (a_lo b_hi, a_hi b_lo)
// have their own accumulators, so the hi chain is D / 8 long.  With one
// accumulator for everything (3 S / 8 chained mma for dK at S queries)
// dk read 1.09e-5 of its largest value off the split emulation at
// float32 [2, 16, 2048, 64] on the card (chip_smoke.py phase 22); with
// short chains it reads 2.07e-6 there (PERF.md).
//
// What the design does about the bound (split TF32 runs at a third of the
// 495 TFLOP/s TF32 peak, 2.5 times the f32 CUDA-core peak of 67):
// - Instruction: mma.sync.m16n8k8 TF32, as ssd_scan.cu.  wgmma's TF32
//   kind reads shared-memory operands K-major only, with no transpose,
//   and the backward reads each streamed tile both ways (Q is K-major in
//   S^T = K Q^T and MN-major in dK += dS^T Q; K likewise in dq), so wgmma
//   would need a transposed split copy of Q and dO (or K and V) beside
//   the plain one: eight float32 tiles a stage, 128 KB at D = 64, which
//   with K and V does not fit.  mma.sync takes its fragments from
//   registers, loaded from one row-major split tile either way: K-major
//   with ldmatrix (x4: an A fragment, or the B fragments of two 8-wide
//   column tiles, a load), MN-major with scalar loads; the row stride D +
//   4 floats keeps both free of bank conflicts.  The contraction index of
//   dV += P^T dO, dK += dS^T Q and dQ += dS K is permuted (k = t <-> column
//   2t, k = t + 4 <-> 2t + 1) in both operands, so P^T, dS^T and dS feed
//   those products straight from the accumulators.
// - Each staged tile is split once: it arrives raw (the input's type) in
//   a two-stage cp.async ring (16-byte copies where the base and strides
//   allow, else 4-byte, else plain loads: a bf16 view offset by one
//   element; zero fill past S, SK and D), then one pass writes its f32 hi
//   and lo tiles (hi alone on a bf16 view), which every warp's products
//   read.  Tile i + 1's copies are in flight while tile i is split and
//   multiplied.
// - dkdv: one block per (batch, KV head, key tile), heaviest (first)
//   first.  K and V are staged and split once; then the Q, dO, lse and
//   delta tiles of the group's G query heads stream through the ring, for
//   each head the q tiles the mask lets through (causal: from the tile of
//   the first row that sees the block's first key).  Warp w holds keys
//   16 (w % (TR / 16)) .. + 15 and a share (NSPLIT) of each q tile's
//   queries:
//   S^T = K Q^T and dP^T = V dO^T (K, V the A operands, both products in
//   one k loop), P^T and dS^T in registers, then dV += P^T dO and dK +=
//   dS^T Q over its queries, all D columns.  The warps of a key group add
//   their partial dK and dV through shared memory at the end, in a fixed
//   order: no atomics.
// - dq: one block per (batch, q head, q tile), heaviest first.  Q and dO
//   are staged and split once, each row's lse and delta held in
//   registers; the K and V tiles stream through the ring, cut at the
//   causal diagonal; S = Q K^T, dP = dO V^T, dS = P (dP - delta), dQ +=
//   dS K, with warps and partial sums as dkdv's.
// - Only the causal diagonal tile and the ragged edges (rows past S, keys
//   past SK) are masked element by element.  dK scale, dV and dQ scale
//   are written once, in the caller's strides.
// - Tiles (Tiles<T, DP>): float32 at width 64 has 64-row tiles and 8
//   warps, 206,336 bytes of shared memory (the K, V, Q and dO hi and lo
//   tiles 139,264, the ring 66,560): one block an SM.  At width 128 a
//   64-row tile pair does not fit beside its ring, so the block holds 32
//   keys (dkdv) or 32 rows (dq) and streams 32-row tiles (201,472
//   bytes); four warps share a row group, 8 query or key columns each
//   (ldmatrix.x2 for their B fragments), so the block still has 8 warps
//   (with 2 a row group and 4 warps it was 11% slower at float32 [2,
//   16/2, 2048, 128]).  A bf16 view has no lo tiles: 64-row tiles and 8
//   warps at both widths (103,936 and 202,240 bytes).  chip_smoke.py logs
//   what ptxas reports for each (236-255 registers, no spills).
// - What still bounds it: one block of 8 warps an SM (the shared memory
//   and the registers allow no more) is too few to hide the latency of
//   the mma chains, the fragment loads and the two barriers a tile; at
//   float32 [2, 16, 2048, 64] the pair reaches about 28% of the TF32
//   peak in split-TF32 products.  Tried on the card and not kept: four D
//   tiles a B-load batch (NC 4; within 1%), exp by ex2.approx (about
//   2.5% faster; expf kept, the accurate exp the emulation uses).  Next:
//   wgmma, whose transposed split copies fit beside K and V only at D =
//   64 with one raw stage.
//
// Each entry point returns cudaGetLastError() after its launch, so a
// refused launch surfaces in the Python wrapper.

#include <cmath>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace tf32;

// The cp.async width (16 or 4 bytes; 0: plain loads) of each input's rows.
struct Vec {
  int q, k, v, dO;
};

// delta: 256 threads a block; each thread keeps kDeltaRows rows in flight
constexpr int kDeltaThreads = 256;
constexpr int kDeltaRows = 4;

// VEC elements of a row, read by one load of VEC * sizeof(T) bytes (16, 8,
// 4 or, a lone bf16, 2), as 32-bit words.
template <typename T, int VEC>
struct Chunk {
  static constexpr int kBytes = VEC * (int)sizeof(T);
  static_assert(kBytes == 16 || kBytes == 4 || kBytes == (int)sizeof(T),
                "a chunk is one 16-byte, 4-byte or single-element load");
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x;
      w[1] = u.y;
      w[2] = u.z;
      w[3] = u.w;
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  // element i as f32 (a bf16 is the high half of its f32)
  __device__ __forceinline__ float at(int i) const {
    if constexpr (sizeof(T) == 4)
      return __uint_as_float(w[i]);
    else
      return __uint_as_float(i & 1 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
  }
};

// delta[row] = sum_d o dO in f32 over rows = B * HQ * S.  A row is read by
// 2^lpr_log2 neighbouring lanes (its D / VEC chunks, chunk c by lane c mod
// lanes, each lane's in order), its lanes' sums added by a fixed shuffle
// tree; a warp holds 32 >> lpr_log2 rows, and a thread kDeltaRows rows at
// once, whose loads are issued before any is summed.  The grid strides
// over the rows.
template <typename T, int VEC>
__global__ void __launch_bounds__(kDeltaThreads, 2)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                           float* __restrict__ delta, int HQ, int S, int D,
                           int rows, int lpr_log2, Strides so, Strides sdo) {
  const int lanes = 1 << lpr_log2;
  const int lane = threadIdx.x % 32;
  const int sub = lane & (lanes - 1);
  const int per_warp = 32 >> lpr_log2;
  const int chunks = D / VEC;
  const long long warp =
      (long long)blockIdx.x * (kDeltaThreads / 32) + threadIdx.x / 32;
  const long long step =
      (long long)gridDim.x * (kDeltaThreads / 32) * per_warp;
  // w0 is the same on every lane of the warp: the shuffles see all 32
  for (long long w0 = warp * per_warp; w0 < rows; w0 += kDeltaRows * step) {
    const T* orow[kDeltaRows];
    const T* drow[kDeltaRows];
    bool ok[kDeltaRows];
    float acc[kDeltaRows];
#pragma unroll
    for (int r = 0; r < kDeltaRows; ++r) {
      const long long row = w0 + r * step + (lane >> lpr_log2);
      ok[r] = row < rows;
      const unsigned u = ok[r] ? (unsigned)row : 0u;
      const unsigned s = u % (unsigned)S, bh = u / (unsigned)S;
      const unsigned h = bh % (unsigned)HQ, b = bh / (unsigned)HQ;
      orow[r] = o + b * so.b + h * so.h + s * so.s;
      drow[r] = dO + b * sdo.b + h * sdo.h + s * sdo.s;
      acc[r] = 0.f;
    }
    for (int c0 = 0; c0 < chunks; c0 += lanes) {
      const int c = c0 + sub;
      Chunk<T, VEC> x[kDeltaRows], y[kDeltaRows];
#pragma unroll
      for (int r = 0; r < kDeltaRows; ++r) {
        if (ok[r] && c < chunks) {
          x[r].load(orow[r] + c * VEC);
          y[r].load(drow[r] + c * VEC);
        } else {
          x[r].zero();
          y[r].zero();
        }
      }
#pragma unroll
      for (int r = 0; r < kDeltaRows; ++r)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[r] = fmaf(x[r].at(i), y[r].at(i), acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kDeltaRows; ++r) {
      for (int off = lanes / 2; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      if (ok[r] && sub == 0)
        delta[w0 + r * step + (lane >> lpr_log2)] = acc[r];
    }
  }
}

template <typename T, int VEC>
int launch_delta(const void* o, const void* dO, float* delta, int HQ, int S,
                 int D, int rows, const Strides& so, const Strides& sdo,
                 cudaStream_t stream) {
  int chunks = D / VEC, lpr_log2 = 0;
  while ((1 << lpr_log2) < chunks && lpr_log2 < 5) ++lpr_log2;
  // the grid: as many blocks as fit on the card at once, or fewer if the
  // rows are fewer
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flash_bwd_delta_kernel<T, VEC>, kDeltaThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long per_block =
      (long long)(kDeltaThreads / 32) * (32 >> lpr_log2) * kDeltaRows;
  const long long need = (rows + per_block - 1) / per_block;
  const int blocks = (int)(need < resident ? need : resident);
  flash_bwd_delta_kernel<T, VEC><<<blocks, kDeltaThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dO), delta, HQ, S, D,
      rows, lpr_log2, so, sdo);
  return (int)cudaGetLastError();
}

// The f32 pair's tiles, by input type and width DP (64 or 128).
template <typename T, int DP>
struct Tiles {
  static constexpr bool kExact = sizeof(T) == 2;   // bf16: lo = 0
  static constexpr int kParts = kExact ? 1 : 2;    // hi (and lo) a tile
  static constexpr int TR = (!kExact && DP == 128) ? 32 : 64;   // own rows
  static constexpr int TS = TR;                    // rows of a streamed tile
  // warps sharing a row group: 2, or 4 where the rows are 32 (8 warps)
  static constexpr int NSPLIT = (!kExact && DP == 128) ? 4 : 2;
  static constexpr int kWarps = TR / 16 * NSPLIT;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int NT = TS / NSPLIT / 8;       // a warp's column tiles
  static constexpr int NC = 2;                     // D tiles a B-load batch
  static constexpr int LD = DP + 4;                // split rows, in floats
  static constexpr int LR = DP + 8;                // partial-sum rows
  static constexpr int kFixed = 2 * kParts * TR * LD;    // floats
  static constexpr int kStream = 2 * kParts * TS * LD;   // floats
  static constexpr int kRaw = TS * DP;             // elements of a raw tile
  // bytes of a ring stage: two raw tiles and a tile's lse and delta
  static constexpr int kStage = 2 * kRaw * (int)sizeof(T) + 2 * TS * 4;
  static constexpr int kSmem = (kFixed + kStream + 2 * TS) * 4 + 2 * kStage;
  static_assert(NT == 1 || NT % 2 == 0, "B fragments load in pairs");
  static_assert(TR == TS, "the fixed tiles stage through a ring stage");
  static_assert((NSPLIT - 1) * 2 * TR * LR <= kFixed + kStream,
                "the partial sums fit where the tiles were");
  static_assert(kSmem <= 232448, "one block's shared memory");
};

// One tile's ROWS f32 values of lse or delta (0 past S), by cp.async.
template <int ROWS>
__device__ __forceinline__ void load_stats(float* dst, const float* src,
                                           int row0, int S) {
  const int i = threadIdx.x;
  if (i < ROWS) {
    const bool ok = row0 + i < S;
    cp_async4(dst + i, ok ? src + row0 + i : src, ok ? 4 : 0);
  }
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

// The split pass: a raw tile [ROWS][DP] into its f32 hi and lo tiles
// [ROWS][LD] (hi alone when kExact: the value is its own hi).
template <bool kExact, typename T, int ROWS, int DP, int LD, int NTH>
__device__ __forceinline__ void split_rows(float* hi, float* lo,
                                           const T* raw) {
  constexpr int kPer = DP / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * kPer; e += NTH) {
    const int r = e / kPer, c = (e % kPer) * 4;
    float x[4];
    load4(raw + r * DP + c, x);
    if constexpr (kExact) {
      *reinterpret_cast<float4*>(hi + r * LD + c) =
          make_float4(x[0], x[1], x[2], x[3]);
    } else {
      float h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = to_tf32(x[i]);
      *reinterpret_cast<float4*>(hi + r * LD + c) =
          make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<float4*>(lo + r * LD + c) = make_float4(
          x[0] - h[0], x[1] - h[1], x[2] - h[2], x[3] - h[3]);
    }
  }
}

// A lane's ldmatrix offsets (floats) into a split tile of row stride LD:
// an A fragment of rows 0..15, columns 0..7; the B fragments of two
// column tiles, rows 0..7 and 8..15, columns (k) 0..7.
template <int LD>
__device__ __forceinline__ int a_offset(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 4;
}
template <int LD>
__device__ __forceinline__ int b_offset(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 4;
}

// B fragments of column tiles 2 jp and 2 jp + 1 from one ldmatrix.
template <int NT>
__device__ __forceinline__ void b_pair(uint32_t (&b)[NT][2], int jp,
                                       uint32_t addr) {
  uint32_t r[4];
  ldsm_x4(r, addr);
  b[2 * jp][0] = r[0];
  b[2 * jp][1] = r[1];
  b[2 * jp + 1][0] = r[2];
  b[2 * jp + 1][1] = r[3];
}

// The score products of a tile, both in one k loop over the width: s =
// X1 Y1^T and dp = X2 Y2^T, X the A operands (a warp's 16 rows), Y the B
// operands (its NT 8-row column tiles); each argument holds the shared
// addresses of the hi tile and the lo tile (not read when kExact) with the
// lane's offsets folded in.  In float32 the small terms go to their own
// accumulators, added at the end (tf32.cuh's mma3): the hi products' chain
// on the tensor cores is DP / 8 additions long, not 3 DP / 8.
template <bool kExact, int DP, int LD, int NT>
__device__ __forceinline__ void score_products(float (&s)[NT][4],
                                               float (&dp)[NT][4],
                                               const uint32_t (&x1)[2],
                                               const uint32_t (&y1)[2],
                                               const uint32_t (&x2)[2],
                                               const uint32_t (&y2)[2]) {
  constexpr int kParts = kExact ? 1 : 2;
  float sl[NT][4], dpl[NT][4];   // the small terms (float32 only)
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = sl[j][e] = dpl[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t a1[2][4], a2[2][4], b1[2][NT][2], b2[2][NT][2];
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      ldsm_x4(a1[part], x1[part] + 32 * kk);
      ldsm_x4(a2[part], x2[part] + 32 * kk);
      if constexpr (NT == 1) {
        ldsm_x2(b1[part][0], y1[part] + 32 * kk);
        ldsm_x2(b2[part][0], y2[part] + 32 * kk);
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        b_pair<NT>(b1[part], jp, y1[part] + jp * 64 * LD + 32 * kk);
        b_pair<NT>(b2[part], jp, y2[part] + jp * 64 * LD + 32 * kk);
      }
    }
    mma3<kExact, kExact, NT>(s, sl, a1[0], a1[1], b1[0], b1[1]);
    mma3<kExact, kExact, NT>(dp, dpl, a2[0], a2[1], b2[0], b2[1]);
  }
  if constexpr (!kExact) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += sl[j][e];
        dp[j][e] += dpl[j][e];
      }
  }
}

// The A fragment of an accumulator's 8-wide column tile c, k permuted
// (k = t <-> column 2t, k = t + 4 <-> 2t + 1), split into hi and lo.
__device__ __forceinline__ void a_from_acc(const float (&c)[4],
                                           uint32_t (&h)[4],
                                           uint32_t (&l)[4]) {
  split(c[0], h[0], l[0]);
  split(c[2], h[1], l[1]);
  split(c[1], h[2], l[2]);
  split(c[3], h[3], l[3]);
}

// B fragments of column tiles n0 .. n0 + NC - 1 (head-dim columns 8 n +
// g) for a product contracted over rows row, row + 1 of a split tile (the
// permuted k = t, t + 4): MN-major scalar loads.
template <int LD, int NC>
__device__ __forceinline__ void mn_frags(uint32_t (&b)[NC][2],
                                         const float* tile, int row, int n0,
                                         int g) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    b[i][0] = __float_as_uint(tile[row * LD + 8 * (n0 + i) + g]);
    b[i][1] = __float_as_uint(tile[(row + 1) * LD + 8 * (n0 + i) + g]);
  }
}

// A warp's partial sums (rows r0 + g and + 8, columns 8 n + 2t, + 1) into
// part [TR][LR], or added from it.
template <int LR, int NN>
__device__ __forceinline__ void put_partial(const float (&acc)[NN][4],
                                            float* part, int r0, int g,
                                            int t) {
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(part + (r0 + g + 8 * h) * LR + 8 * n +
                                 2 * t) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
}
template <int LR, int NN>
__device__ __forceinline__ void add_partial(float (&acc)[NN][4],
                                            const float* part, int r0, int g,
                                            int t) {
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 x = *reinterpret_cast<const float2*>(
          part + (r0 + g + 8 * h) * LR + 8 * n + 2 * t);
      acc[n][2 * h] += x.x;
      acc[n][2 * h + 1] += x.y;
    }
}

// acc (times mul) into rows r0 + g and + 8 of a head's output (row stride
// ld), rows at or past n_rows and columns at or past D not at all.
template <typename T, int NN>
__device__ __forceinline__ void store_rows(const float (&acc)[NN][4], T* out,
                                           long long ld, int row0,
                                           int n_rows, int D, float mul,
                                           int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < D) out[(long long)row * ld + d] = from_f32<T>(acc[n][2 * h + e] * mul);
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(Tiles<T, DP>::kThreads, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dO,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int B,
                          int HQ, int HKV, int S, int SK, int D, Strides sq,
                          Strides sk, Strides sv, Strides sdo, Strides sdk,
                          Strides sdv, float scale, int causal, int offset,
                          Vec vec) {
  using C = Tiles<T, DP>;
  constexpr bool kExact = C::kExact;
  constexpr int TR = C::TR, TS = C::TS, NT = C::NT, NC = C::NC, LD = C::LD;
  constexpr int NTH = C::kThreads;
  extern __shared__ float4 smem4[];
  float* const fixed = reinterpret_cast<float*>(smem4);   // K, V split
  float* const strm = fixed + C::kFixed;                   // Q, dO split
  float* const stats = strm + C::kStream;                  // lse, delta [TS]
  uint8_t* const ring = reinterpret_cast<uint8_t*>(stats + 2 * TS);
  // split tiles: x 0 (K; Q), 1 (V; dO); part 0 hi, 1 lo
  auto fix = [&](int x, int part) {
    return fixed + (x * C::kParts + part) * TR * LD;
  };
  auto str = [&](int x, int part) {
    return strm + (x * C::kParts + part) * TS * LD;
  };
  auto raw = [&](int st, int x) {
    return reinterpret_cast<T*>(ring + st * C::kStage) + x * C::kRaw;
  };
  auto raw_stats = [&](int st) {
    return reinterpret_cast<float*>(ring + st * C::kStage +
                                    2 * C::kRaw * sizeof(T));
  };

  const int BH = B * HKV;
  const int bh = blockIdx.x % BH;
  const int kt = (int)(blockIdx.x / BH);   // heaviest (first) first
  const int b = bh / HKV, hk = bh % HKV;
  const int G = HQ / HKV;
  const int k0 = kt * TR;
  const int n_qt = (S + TS - 1) / TS;
  // causal: from the tile of the first row that sees key k0 (q = k0 - offset)
  const int qt0 = causal ? min(max(k0 - offset, 0) / TS, n_qt) : 0;
  const int per_head = n_qt - qt0;
  const int n_it = G * per_head;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * (warp % (TR / 16));   // the warp's keys in the tile
  const int sp = warp / (TR / 16);
  const int c0 = sp * (TS / C::NSPLIT);     // its queries in a q tile

  // q tile it (head it / per_head) into ring stage st
  auto issue = [&](int it, int st) {
    const int h = hk * G + it / per_head;
    const int q0 = (qt0 + it % per_head) * TS;
    load_rows<T, TS, DP, DP, NTH>(raw(st, 0), q + b * sq.b + h * sq.h, sq.s, q0,
                              S, D, vec.q);
    load_rows<T, TS, DP, DP, NTH>(raw(st, 1), dO + b * sdo.b + h * sdo.h, sdo.s,
                              q0, S, D, vec.dO);
    const long long row = ((long long)b * HQ + h) * S;
    load_stats<TS>(raw_stats(st), lse + row, q0, S);
    load_stats<TS>(raw_stats(st) + TS, delta + row, q0, S);
  };

  // K and V through stage 0 while the first q tile goes to stage 1
  load_rows<T, TR, DP, DP, NTH>(raw(0, 0), k + b * sk.b + hk * sk.h, sk.s, k0,
                            SK, D, vec.k);
  load_rows<T, TR, DP, DP, NTH>(raw(0, 1), v + b * sv.b + hk * sv.h, sv.s, k0,
                            SK, D, vec.v);
  cp_async_commit();
  if (n_it > 0) issue(0, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  split_rows<kExact, T, TR, DP, LD, NTH>(fix(0, 0), fix(0, 1), raw(0, 0));
  split_rows<kExact, T, TR, DP, LD, NTH>(fix(1, 0), fix(1, 1), raw(0, 1));
  __syncthreads();   // stage 0 is free again

  const uint32_t a_off = 4 * (r0 * LD + a_offset<LD>(lane));
  const uint32_t b_off = 4 * (c0 * LD + b_offset<LD>(lane));
  const uint32_t xk[2] = {smem_addr(fix(0, 0)) + a_off,
                          smem_addr(fix(0, kExact ? 0 : 1)) + a_off};
  const uint32_t xv[2] = {smem_addr(fix(1, 0)) + a_off,
                          smem_addr(fix(1, kExact ? 0 : 1)) + a_off};
  const uint32_t yq[2] = {smem_addr(str(0, 0)) + b_off,
                          smem_addr(str(0, kExact ? 0 : 1)) + b_off};
  const uint32_t yo[2] = {smem_addr(str(1, 0)) + b_off,
                          smem_addr(str(1, kExact ? 0 : 1)) + b_off};

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1, it & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile it has landed; tile it - 1's products are done
    const int st = (it + 1) & 1;
    split_rows<kExact, T, TS, DP, LD, NTH>(str(0, 0), str(0, 1), raw(st, 0));
    split_rows<kExact, T, TS, DP, LD, NTH>(str(1, 0), str(1, 1), raw(st, 1));
    for (int i = threadIdx.x; i < 2 * TS; i += NTH) stats[i] = raw_stats(st)[i];
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: keys the rows, queries the columns
    float s[NT][4], dp[NT][4];
    score_products<kExact, DP, LD, NT>(s, dp, xk, yq, xv, yo);

    // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta), lse and
    // delta by column; masked only on the causal diagonal and past S
    const int q0 = (qt0 + it % per_head) * TS;
    const bool edge = q0 + TS > S || (causal && k0 + TR - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 8 * j + 2 * t + (e & 1);
        float p = expf(fmaf(s[j][e], scale, -stats[col]));
        if (edge) {
          const int qp = q0 + col, key = k0 + r0 + g + 8 * (e >> 1);
          if (qp >= S || (causal && key > qp + offset)) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - stats[TS + col]);
      }

    // dV += P^T dO and dK += dS^T Q over the warp's queries, dO and Q read
    // MN-major (queries the contraction); each tile's sums start from zero
    // (a chain of 3 NT tensor-core additions) and join the running sums by
    // the CUDA cores' rounded adds
    uint32_t ph[NT][4], pl[NT][4], dh[NT][4], dl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      a_from_acc(s[j], ph[j], pl[j]);
      a_from_acc(dp[j], dh[j], dl[j]);
    }
#pragma unroll
    for (int n0 = 0; n0 < DP / 8; n0 += NC) {
      float tv[NC][4] = {}, tk[NC][4] = {};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int row = c0 + 8 * j + 2 * t;
        uint32_t oh[NC][2], ol[NC][2], qh[NC][2], ql[NC][2];
        mn_frags<LD, NC>(oh, str(1, 0), row, n0, g);
        mn_frags<LD, NC>(qh, str(0, 0), row, n0, g);
        if constexpr (!kExact) {
          mn_frags<LD, NC>(ol, str(1, 1), row, n0, g);
          mn_frags<LD, NC>(ql, str(0, 1), row, n0, g);
        }
        mma3<false, kExact, NC>(tv, tv, ph[j], pl[j], oh, ol);
        mma3<false, kExact, NC>(tk, tk, dh[j], dl[j], qh, ql);
      }
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv_acc[n0 + i][e] += tv[i][e];
          dk_acc[n0 + i][e] += tk[i][e];
        }
    }
  }

  // the key group's two warps add their sums in a fixed order (shared
  // memory now holds the partial sums: dK [TR][LR], then dV)
  constexpr int LR = C::LR;
  __syncthreads();
  if (sp > 0) {
    put_partial<LR>(dk_acc, fixed + (sp - 1) * 2 * TR * LR, r0, g, t);
    put_partial<LR>(dv_acc, fixed + ((sp - 1) * 2 + 1) * TR * LR, r0, g, t);
  }
  __syncthreads();
  if (sp > 0) return;
#pragma unroll
  for (int o = 0; o < C::NSPLIT - 1; ++o) {
    add_partial<LR>(dk_acc, fixed + o * 2 * TR * LR, r0, g, t);
    add_partial<LR>(dv_acc, fixed + (o * 2 + 1) * TR * LR, r0, g, t);
  }
  store_rows<T>(dk_acc, dk + b * sdk.b + hk * sdk.h, sdk.s, k0 + r0, SK, D,
                scale, g, t);
  store_rows<T>(dv_acc, dv + b * sdv.b + hk * sdv.h, sdv.s, k0 + r0, SK, D,
                1.f, g, t);
}

template <typename T, int DP>
__global__ void __launch_bounds__(Tiles<T, DP>::kThreads, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dO,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int B, int HQ, int HKV, int S, int SK, int D,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, float scale, int causal, int offset,
                        Vec vec) {
  using C = Tiles<T, DP>;
  constexpr bool kExact = C::kExact;
  constexpr int TR = C::TR, TS = C::TS, NT = C::NT, NC = C::NC, LD = C::LD;
  constexpr int NTH = C::kThreads;
  extern __shared__ float4 smem4[];
  float* const fixed = reinterpret_cast<float*>(smem4);   // Q, dO split
  float* const strm = fixed + C::kFixed;                   // K, V split
  uint8_t* const ring = reinterpret_cast<uint8_t*>(strm + C::kStream + 2 * TS);
  auto fix = [&](int x, int part) {
    return fixed + (x * C::kParts + part) * TR * LD;
  };
  auto str = [&](int x, int part) {
    return strm + (x * C::kParts + part) * TS * LD;
  };
  auto raw = [&](int st, int x) {
    return reinterpret_cast<T*>(ring + st * C::kStage) + x * C::kRaw;
  };

  const int BH = B * HQ;
  const int n_qt = (S + TR - 1) / TR;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);   // heaviest first
  const int b = bh / HQ, h = bh % HQ;
  const int hk = h / (HQ / HKV);
  const int q0 = qt * TR;
  int n_kt = (SK + TS - 1) / TS;
  if (causal) {   // cut at the diagonal k_pos = q_pos + offset
    const int last = q0 + TR - 1 + offset;
    n_kt = min(n_kt, last < 0 ? 0 : last / TS + 1);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * (warp % (TR / 16));   // the warp's rows in the tile
  const int sp = warp / (TR / 16);
  const int c0 = sp * (TS / C::NSPLIT);     // its keys in a k tile

  const T* kh = k + b * sk.b + hk * sk.h;
  const T* vh = v + b * sv.b + hk * sv.h;
  auto issue = [&](int kt, int st) {
    load_rows<T, TS, DP, DP, NTH>(raw(st, 0), kh, sk.s, kt * TS, SK, D, vec.k);
    load_rows<T, TS, DP, DP, NTH>(raw(st, 1), vh, sv.s, kt * TS, SK, D, vec.v);
  };

  // Q and dO through stage 0 while the first k tile goes to stage 1
  load_rows<T, TR, DP, DP, NTH>(raw(0, 0), q + b * sq.b + h * sq.h, sq.s, q0, S,
                            D, vec.q);
  load_rows<T, TR, DP, DP, NTH>(raw(0, 1), dO + b * sdo.b + h * sdo.h, sdo.s, q0,
                            S, D, vec.dO);
  cp_async_commit();
  if (n_kt > 0) issue(0, 1);
  cp_async_commit();
  // this thread's two rows' lse (negated) and delta, 0 past S
  float nl[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + g + 8 * hh;
    const bool ok = row < S;
    nl[hh] = ok ? -lse[(long long)bh * S + row] : 0.f;
    dl[hh] = ok ? delta[(long long)bh * S + row] : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();
  split_rows<kExact, T, TR, DP, LD, NTH>(fix(0, 0), fix(0, 1), raw(0, 0));
  split_rows<kExact, T, TR, DP, LD, NTH>(fix(1, 0), fix(1, 1), raw(0, 1));
  __syncthreads();   // stage 0 is free again

  const uint32_t a_off = 4 * (r0 * LD + a_offset<LD>(lane));
  const uint32_t b_off = 4 * (c0 * LD + b_offset<LD>(lane));
  const uint32_t xq[2] = {smem_addr(fix(0, 0)) + a_off,
                          smem_addr(fix(0, kExact ? 0 : 1)) + a_off};
  const uint32_t xo[2] = {smem_addr(fix(1, 0)) + a_off,
                          smem_addr(fix(1, kExact ? 0 : 1)) + a_off};
  const uint32_t yk[2] = {smem_addr(str(0, 0)) + b_off,
                          smem_addr(str(0, kExact ? 0 : 1)) + b_off};
  const uint32_t yv[2] = {smem_addr(str(1, 0)) + b_off,
                          smem_addr(str(1, kExact ? 0 : 1)) + b_off};

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) issue(kt + 1, kt & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile kt has landed; tile kt - 1's products are done
    const int st = (kt + 1) & 1;
    split_rows<kExact, T, TS, DP, LD, NTH>(str(0, 0), str(0, 1), raw(st, 0));
    split_rows<kExact, T, TS, DP, LD, NTH>(str(1, 0), str(1, 1), raw(st, 1));
    __syncthreads();

    // S = Q K^T and dP = dO V^T
    float s[NT][4], dp[NT][4];
    score_products<kExact, DP, LD, NT>(s, dp, xq, yk, xo, yv);

    // dS = P (dP - delta), P = exp(S scale - lse) under the mask (the
    // diagonal tile and the tile that holds SK)
    const int k0 = kt * TS;
    const bool edge =
        k0 + TS > SK || (causal && k0 + TS - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        float p = expf(fmaf(s[j][e], scale, nl[hh]));
        if (edge) {
          const int key = k0 + c0 + 8 * j + 2 * t + (e & 1);
          if (key >= SK ||
              (causal && key > q0 + r0 + g + 8 * hh + offset))
            p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - dl[hh]);
      }

    // dQ += dS K over the warp's keys, K read MN-major (keys the
    // contraction); each tile's sum from zero, as dkdv's
    uint32_t dh[NT][4], dlo[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) a_from_acc(dp[j], dh[j], dlo[j]);
#pragma unroll
    for (int n0 = 0; n0 < DP / 8; n0 += NC) {
      float tq[NC][4] = {};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int row = c0 + 8 * j + 2 * t;
        uint32_t bh_[NC][2], bl_[NC][2];
        mn_frags<LD, NC>(bh_, str(0, 0), row, n0, g);
        if constexpr (!kExact) mn_frags<LD, NC>(bl_, str(0, 1), row, n0, g);
        mma3<false, kExact, NC>(tq, tq, dh[j], dlo[j], bh_, bl_);
      }
#pragma unroll
      for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + i][e] += tq[i][e];
    }
  }

  constexpr int LR = C::LR;
  __syncthreads();
  if (sp > 0) put_partial<LR>(acc, fixed + (sp - 1) * TR * LR, r0, g, t);
  __syncthreads();
  if (sp > 0) return;
#pragma unroll
  for (int o = 0; o < C::NSPLIT - 1; ++o)
    add_partial<LR>(acc, fixed + o * TR * LR, r0, g, t);
  store_rows<T>(acc, dq + b * sdq.b + h * sdq.h, sdq.s, q0 + r0, S, D, scale,
                g, t);
}

struct Args {
  const void *q, *k, *v, *dO;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, HQ, HKV, S, SK, D;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  float scale;
  int causal, offset;
  Vec vec;
};

template <typename T, int DP>
int launch_dkdv(const Args& a, cudaStream_t stream) {
  using C = Tiles<T, DP>;
  auto kernel = flash_bwd_dkdv_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((a.SK + C::TR - 1) / C::TR) * a.B * a.HKV;
  kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dO), a.lse, a.delta,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.B, a.HQ, a.HKV, a.S,
      a.SK, a.D, a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.scale, a.causal,
      a.offset, a.vec);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dq(const Args& a, cudaStream_t stream) {
  using C = Tiles<T, DP>;
  auto kernel = flash_bwd_dq_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((a.S + C::TR - 1) / C::TR) * a.B * a.HQ;
  kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dO), a.lse, a.delta,
      static_cast<T*>(a.dq), a.B, a.HQ, a.HKV, a.S, a.SK, a.D, a.sq, a.sk,
      a.sv, a.sdo, a.sdq, a.scale, a.causal, a.offset, a.vec);
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
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, sdo{st[9], st[10], st[11]};
  const int elem = is_bf16 ? 2 : 4;
  const Vec vec{vec_bytes(q, sq, elem), vec_bytes(k, sk, elem),
                vec_bytes(v, sv, elem), vec_bytes(dO, sdo, elem)};
  Args a{q, k, v, dO, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, dk, dv, B, HQ, HKV, S, SK, D,
         sq, sk, sv, sdo, {st[12], st[13], st[14]},
         {st[15], st[16], st[17]}, {st[18], st[19], st[20]}, scale, causal,
         offset, vec};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return dispatch<__nv_bfloat16>(a, which, s);
  return dispatch<float>(a, which, s);
}

}  // namespace

// delta [B, HQ, S] f32 (contiguous) = rowsum(dO o) in f32; o and dO [B,
// HQ, S, D] with per-tensor (batch, head, row) strides in elements; vec:
// the elements a load reads (kernel.py::delta_width: f32 4 or 1, bf16 8, 2
// or 1), which must divide D and be no wider than tf32::vec_bytes allows
// for either tensor (its base and its batch, head and row strides).
extern "C" int flash_bwd_delta_launch(const void* o, const void* dO,
                                      void* delta, int is_bf16, int B,
                                      int HQ, int S, int D, long long o_sb,
                                      long long o_sh, long long o_ss,
                                      long long do_sb, long long do_sh,
                                      long long do_ss, int vec, void* stream) {
  const long long rows = (long long)B * HQ * S;
  const tf32::Strides so{o_sb, o_sh, o_ss}, sdo{do_sb, do_sh, do_ss};
  const int elem = is_bf16 ? 2 : 4, bytes = vec * elem;
  if (D < 1 || vec < 1 || D % vec != 0 || rows > 0x7fffffffLL ||
      (vec > 1 && (bytes > tf32::vec_bytes(o, so, elem) ||
                   bytes > tf32::vec_bytes(dO, sdo, elem))))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  float* out = static_cast<float*>(delta);
  cudaStream_t s = (cudaStream_t)stream;
  const int n = (int)rows;
  if (is_bf16) {
    if (vec == 8)
      return launch_delta<__nv_bfloat16, 8>(o, dO, out, HQ, S, D, n, so, sdo, s);
    if (vec == 2)
      return launch_delta<__nv_bfloat16, 2>(o, dO, out, HQ, S, D, n, so, sdo, s);
    if (vec == 1)
      return launch_delta<__nv_bfloat16, 1>(o, dO, out, HQ, S, D, n, so, sdo, s);
  } else {
    if (vec == 4)
      return launch_delta<float, 4>(o, dO, out, HQ, S, D, n, so, sdo, s);
    if (vec == 1)
      return launch_delta<float, 1>(o, dO, out, HQ, S, D, n, so, sdo, s);
  }
  return (int)cudaErrorInvalidValue;
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
