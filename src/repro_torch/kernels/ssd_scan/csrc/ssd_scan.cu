// Hand-written Hopper (sm_90a) kernels: the Mamba-2 SSD chunked scan.
//
// ssd_cb_kernel + ssd_scan_kernel replace the TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py::ssd_scan
//   (_ssd_kernel, pallas_call over the grid (batch * head, chunks)).
//
// What they compute (the Pallas kernel's function, ref.py::ssd_chunked):
// per (batch, head), with an [N, P] f32 state h carried across chunks of
// Q steps, in order:
//   cum_t  = sum_{s <= t} dt_s * A                    (within the chunk)
//   y_t    = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//          + exp(cum_t) C_t^T h + D x_t
//   h     <- exp(cum_Q) h + sum_t dt_t exp(cum_Q - cum_t) B_t (x) x_t
// x and y in bf16 or f32, dt, A, B, C, D in f32, all math in f32 or in
// split TF32 products of about f32 accuracy (below); h_final optionally
// written out.  The sequence may be ragged: rows past L act as dt = 0, x = 0 (the
// reference's padding), which leaves h unchanged, and no y row past L is
// written.
//
// What bounds it on this card: at one Mamba2-1.3B layer's prefill (8 x
// 2000 tokens, 64 heads of P = 64, N = 128, chunk 64) the scan reads x
// (bf16, 131 MB), dt, B and C (f32, 21 MB; B and C are shared by the heads
// and read once per batch) and writes y (131 MB) and h_final (17 MB):
// about 300 MB, 89 us at 3.35 TB/s.  Its products are 46.3 GFLOP under
// the causal mask, 37.8 once C B^T is computed once per batch and chunk
// instead of once per head.  The h_final check (1e-5 of its magnitude)
// rules out plain TF32 or bf16 products: rounding each operand to TF32's
// 10-bit mantissa leaves h_final about 3e-4 off.  So every product is
// 3xTF32: a = a_hi + a_lo with a_hi = tf32(a), a_lo = a - a_hi, and a b ~
// a_hi b_hi + a_hi b_lo + a_lo b_hi, which is about as accurate as f32
// (tests/test_torch_ssd_scan.py emulates both on the CPU).  A bf16 x is
// exact in TF32 (x_lo = 0), so products with x take two mma instead of
// three.  At a third of the 495 TFLOP/s TF32 peak the 37.8 GFLOP take
// 229 us, so the operations bound it, not the bytes.
//
// The design:
// - ssd_cb_kernel writes G = C B^T for each (batch, chunk) into an f32
//   workspace of 64 x 64 tiles, in exact f32 FMAs on the CUDA cores (0.26
//   GFLOP at the prefill shape).  The scan reads G from L2 instead of
//   recomputing it for each of the 64 heads that share B and C (the
//   model's B and C are one group; the flat signature has one head).
// - ssd_scan_kernel: one block of 4 warps per (batch, head); the chunk
//   axis (the TPU's sequential grid axis) is a loop inside the block.
//   Warp w owns rows p in [16w, 16w + 16) of everything it computes, in
//   transposed form, so that the state never leaves the registers:
//     y^T[p, t]  = sum_n h^T[p, n] C[t, n] exp(cum_t)
//                + sum_s x^T[p, s] M[t, s]
//     h^T[p, n] <- exp(cum_Q) h^T[p, n] + sum_s x^T[p, s] B[s, n] w_s
//   with mma.sync.m16n8k8 TF32.  h^T is the accumulator of the state
//   update (16 tiles of 16 x 8, 64 registers a thread) and, for the next
//   chunk's C h product, the A operand: a thread's accumulator holds
//   columns 2q and 2q + 1 of each 8-wide tile where the A fragment wants
//   columns q and q + 4, so the contraction index is permuted (k = q <->
//   column 2q, k = q + 4 <-> column 2q + 1) in both operands, which the
//   sum does not see.  The same permutation of s makes each B fragment of
//   M and C one 8-byte shared load.
// - The split rounds hi in two integer operations (cvt.rna.tf32.f32,
//   which rounds the same way, compiles to several and was measurably
//   slower) and hands lo over unrounded: the tensor cores read the TF32
//   part of an operand.
// - Per chunk, x (in its own type), B, C and G are copied into shared
//   memory with cp.async, all in flight at once (16-byte vectors where
//   the strides allow, else 4; zero-filled past the chunk's rows, P and
//   N), while warp 0 forms cum with a warp scan, with exp(cum_t), w_s =
//   dt_s exp(cum_Q - cum_s) and exp(cum_Q) beside it; then M = G
//   exp(cum_t - cum_s) dt_s is built in place of G, selected to 0 above
//   the diagonal BEFORE the exponential (there cum_t - cum_s > 0 and exp
//   may overflow; 0 * inf would be NaN).  The M x product visits only the
//   36 of 64 tile pairs on or below the diagonal.  Every other tile is
//   visited whatever the chunk's rows or N (zeros past them), so the mma
//   loops unroll into straight code: with runtime bounds in them they did
//   not (the SASS held a fifth of the mma), and a call took twice as
//   long.
// - Row strides of the staged tiles (72 bf16 or 68 f32 for x, 72, 132,
//   136 floats) make every fragment load free of bank conflicts.
// - Shared memory: 97,296 bytes a block with bf16 x (x 9,216, M 18,432,
//   B 33,792, C 34,816, cum and friends 1,040; 105,488 with f32 x), so 2
//   blocks (8 warps) fit on an SM, one staging while the other computes;
//   247-249 registers a thread, no spills.  512 blocks at the prefill
//   shape fill 132 SMs x 2 in 1.9 waves; 128 at the scoring shape (2 x
//   2000 tokens) leave 4 SMs idle and one block on each of the others.
// - What still bounds it: a call issues 46.7 M mma.sync at the prefill
//   shape (712 a warp and chunk, 2,048 operations each), which at the
//   time chip_smoke.py phase 12 measures (about 0.88 ms on an H100) is
//   about a fifth of the TF32 peak.  Each mma comes with about four other
//   instructions (the operand splits, shared loads), and an SM holds 8
//   warps, 2 a scheduler, too few to hide the latency of the shared loads
//   and the mma chains.  Variants tried on the card and not kept:
//   double-buffered staging with two heads a block sharing B, C and G (M
//   formed in registers, 218 KB of shared memory, one block of 8 warps an
//   SM) gained little at the prefill shape, lost at the scoring shape and
//   spilled; interleaving the three products of two accumulators, or
//   skipping C h on the first chunk, changed nothing.  Next: operands
//   split once per chunk instead of once per warp and use, and wgmma,
//   which reads its B operand from shared memory.
// - Inputs are read through their strides (the last dimension of x, B, C
//   and y contiguous): the model's x is a strided view of its conv
//   output, B and C are [batch, L, N] with a head stride of 0, and y is
//   written in the model's [batch, L, head, P] layout, so no copy is
//   made on either side.
// - Tiles are sized for Q <= 64, P <= 64, N <= 128 (Mamba2-1.3B's shape);
//   a smaller chunk, P or N runs in the same tiles, zero-padded.
//
// Each entry point returns cudaGetLastError() after its launch, so a
// refused launch surfaces in the Python wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;          // rows of a staged chunk
constexpr int TP = 64;          // largest head dim P
constexpr int TN = 128;         // largest state size N

// ssd_cb_kernel: 16 x 16 threads, a 4 x 4 register tile of G each
constexpr int kCbThreads = 256;
constexpr int LDN = TN + 4;     // Bs/Cs row stride: conflict-free float4
constexpr int kCbSmemFloats = 2 * TQ * LDN;

// ssd_scan_kernel: 4 warps, warp w owns p rows [16w, 16w + 16)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int LDM = TQ + 8;     // Ms [t][s]: float2 B loads, stride = 8 mod 32
constexpr int LDB = TN + 4;     // Bs [s][n]: scalar B loads
constexpr int LDC = TN + 8;     // Cs [t][n]: float2 B loads

// Xs [s][p] holds x in its own type: scalar A loads, conflict-free with a
// row stride of 8 mod 32 words (bf16) or 4 mod 32 (f32)
template <typename T>
__host__ __device__ constexpr int ldx() {
  return sizeof(T) == 2 ? TP + 8 : TP + 4;
}
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return TQ * ldx<T>() * (int)sizeof(T) +
         (TQ * LDM + TQ * LDB + TQ * LDC + 4 * TQ + 4) * (int)sizeof(float);
}

struct Str3 {
  long long b, h, l;            // in elements
};
struct Str2 {
  long long b, h;
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

// ---- 3xTF32 on mma.sync --------------------------------------------------

// v ~ hi + lo: hi is v rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna.tf32.f32, in two integer operations where cvt.rna takes
// several), lo = v - hi exactly, of which the tensor cores read the TF32
// part (they ignore the low 13 bits of an operand)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in split TF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, the small
// terms first; a_lo b_hi is left out when a is exact in TF32 (bf16 x).
// b = (b0, b1) is split here.
template <bool kExactA>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  if (!kExactA) mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// ---- asynchronous staging -------------------------------------------------

// copies src_bytes (<= the vector's size) and zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Rows [0, rows) x columns [0, cols) of a row-major global tile (row
// stride ld elements) into a shared TQ x W tile (row stride lds), zeros
// elsewhere, in cp.async vectors of kBytes (16 or 4; the caller has
// checked the alignment); the copies are in flight on return.
template <int kBytes, int W, int kNThreads, typename E>
__device__ __forceinline__ void stage_async(E* sm, int lds, const E* g,
                                            long long ld, int rows, int cols,
                                            int tid) {
  constexpr int kVec = kBytes / (int)sizeof(E);
  constexpr int kPerRow = W / kVec;
#pragma unroll 4
  for (int e = tid; e < TQ * kPerRow; e += kNThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * kVec;
    const int n = r < rows ? max(0, min(kVec, cols - c)) : 0;
    const E* src = n > 0 ? g + r * ld + c : g;
    if (kBytes == 16)
      cp_async16(sm + r * lds + c, src, n * (int)sizeof(E));
    else
      cp_async4(sm + r * lds + c, src, n * (int)sizeof(E));
  }
}

// the widest cp.async vector (16 or 4 bytes; 0: none) that every row of a
// tensor with these strides (in elements of elem bytes) starts aligned to
int vec_bytes(const void* p, long long sb, long long sh, long long sl,
              int elem) {
  const int widths[2] = {16, 4};
  for (int bytes : widths) {
    const long long v = bytes / elem;
    if (reinterpret_cast<uintptr_t>(p) % bytes == 0 && sb % v == 0 &&
        sh % v == 0 && sl % v == 0)
      return bytes;
  }
  return 0;
}

// ---- G = C B^T per (batch, chunk) ------------------------------------------

__global__ void __launch_bounds__(kCbThreads)
    ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                  float* __restrict__ G, int L, int N, int chunk, Str3 sb,
                  Str3 sc, int vbc) {
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);   // [TQ][LDN]
  float* Cs = Bs + TQ * LDN;                     // [TQ][LDN]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ci = blockIdx.x, b = blockIdx.y;
  const int n_chunks = gridDim.x;
  const int l0 = ci * chunk;
  const int rows = min(chunk, L - l0);
  const float* Bh = Bm + b * sb.b;
  const float* Ch = Cm + b * sc.b;
  const float* Bc = Bh + (long long)l0 * sb.l;
  const float* Cc = Ch + (long long)l0 * sc.l;
  if (vbc == 16) {
    stage_async<16, TN, kCbThreads>(Bs, LDN, Bc, sb.l, rows, N, tid);
    stage_async<16, TN, kCbThreads>(Cs, LDN, Cc, sc.l, rows, N, tid);
  } else {
    stage_async<4, TN, kCbThreads>(Bs, LDN, Bc, sb.l, rows, N, tid);
    stage_async<4, TN, kCbThreads>(Cs, LDN, Cc, sc.l, rows, N, tid);
  }
  cp_async_wait_all();
  __syncthreads();
  const int n4 = (N + 3) & ~3;
  float g[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
#pragma unroll 4
  for (int n = 0; n < n4; n += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cv[i] = *reinterpret_cast<const float4*>(&Cs[(ty * 4 + i) * LDN + n]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * j) * LDN + n]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = g[i][j];
        a = fmaf(cv[i].x, bv[j].x, a);
        a = fmaf(cv[i].y, bv[j].y, a);
        a = fmaf(cv[i].z, bv[j].z, a);
        a = fmaf(cv[i].w, bv[j].w, a);
        g[i][j] = a;
      }
  }
  float* Gc = G + ((long long)b * n_chunks + ci) * TQ * TQ;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Gc[(ty * 4 + i) * TQ + tx + 16 * j] = g[i][j];
}

// ---- the scan ----------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ D,
                    const float* __restrict__ G, T* __restrict__ y,
                    float* __restrict__ h_out, int H, int L, int P,
                    int N, int chunk, Str3 sx, Str3 sdt, Str2 sa, Str3 sb,
                    Str3 sc, Str2 sd, Str3 sy, int vx, int vbc) {
  constexpr bool kExactX = sizeof(T) == 2;   // bf16 fits TF32's mantissa
  constexpr int LDX = ldx<T>();
  extern __shared__ float4 smem4[];
  T* Xs = reinterpret_cast<T*>(smem4);           // [TQ][LDX]  x[s][p]
  float* Ms = reinterpret_cast<float*>(Xs + TQ * LDX);  // [TQ][LDM]  M[t][s]
  float* Bs = Ms + TQ * LDM;                     // [TQ][LDB]  B[s][n]
  float* Cs = Bs + TQ * LDB;                     // [TQ][LDC]  C[t][n]
  float* cum = Cs + TQ * LDC;                    // [TQ]
  float* ecum = cum + TQ;                        // [TQ] exp(cum_t)
  float* wv = ecum + TQ;                         // [TQ] dt_s exp(cum_Q - cum_s)
  float* dts = wv + TQ;                          // [TQ]
  float* elast = dts + TQ;                       // [1] exp(cum_Q)

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;      // mma fragment coordinates
  const int b = blockIdx.x / H, hd = blockIdx.x % H;
  const T* xh = x + b * sx.b + hd * sx.h;
  const float* dth = dt + b * sdt.b + hd * sdt.h;
  const float* Bh = Bm + b * sb.b + hd * sb.h;
  const float* Ch = Cm + b * sc.b + hd * sc.h;
  T* yh = y + b * sy.b + hd * sy.h;
  const float Ah = A[b * sa.b + hd * sa.h];
  const float Dh = D[b * sd.b + hd * sd.h];
  const int n_chunks = (L + chunk - 1) / chunk;
  const float* Gb = G + (long long)b * n_chunks * TQ * TQ;
  const int p0 = warp * 16;
  const int pa = p0 + gid, pb = p0 + gid + 8;    // this thread's two rows

  // h^T[p][n], tile nt: [0] (pa, 8nt+2tig), [1] (pa, +1), [2] (pb, 8nt+2tig),
  // [3] (pb, +1)
  float hacc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) hacc[i][c] = 0.f;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int l0 = ci * chunk;
    const int rows = min(chunk, L - l0);

    // ---- stage the chunk: x, B, C and G in flight at once ---------------
    {
      const T* xc = xh + (long long)l0 * sx.l;
      if (vx == 16) {
        stage_async<16, TP, kThreads>(Xs, LDX, xc, sx.l, rows, P, tid);
      } else if (vx == 4) {
        stage_async<4, TP, kThreads>(Xs, LDX, xc, sx.l, rows, P, tid);
      } else {
        for (int e = tid; e < TQ * TP; e += kThreads) {
          const int r = e / TP, p = e % TP;
          Xs[r * LDX + p] = r < rows && p < P ? xc[r * sx.l + p]
                                              : from_f32<T>(0.f);
        }
      }
      const float* Bc = Bh + (long long)l0 * sb.l;
      const float* Cc = Ch + (long long)l0 * sc.l;
      if (vbc == 16) {
        stage_async<16, TN, kThreads>(Bs, LDB, Bc, sb.l, rows, N, tid);
        stage_async<16, TN, kThreads>(Cs, LDC, Cc, sc.l, rows, N, tid);
      } else {
        stage_async<4, TN, kThreads>(Bs, LDB, Bc, sb.l, rows, N, tid);
        stage_async<4, TN, kThreads>(Cs, LDC, Cc, sc.l, rows, N, tid);
      }
      stage_async<16, TQ, kThreads>(Ms, LDM, Gb + (long long)ci * TQ * TQ,
                                    TQ, TQ, TQ, tid);
    }
    if (warp == 0) {
      // cum: an inclusive warp scan over two halves of 32 rows
      const int r0 = lane, r1 = lane + 32;
      const float d0 = r0 < rows ? dth[(long long)(l0 + r0) * sdt.l] : 0.f;
      const float d1 = r1 < rows ? dth[(long long)(l0 + r1) * sdt.l] : 0.f;
      float a0 = d0 * Ah, a1 = d1 * Ah;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, a0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, a1, off);
        if (lane >= off) {
          a0 += u0;
          a1 += u1;
        }
      }
      a1 += __shfl_sync(0xffffffffu, a0, 31);
      const float last = __shfl_sync(0xffffffffu, a1, 31);
      cum[r0] = a0;
      cum[r1] = a1;
      ecum[r0] = expf(a0);
      ecum[r1] = expf(a1);
      wv[r0] = d0 * expf(last - a0);
      wv[r1] = d1 * expf(last - a1);
      dts[r0] = d0;
      dts[r1] = d1;
      if (lane == 0) elast[0] = expf(last);
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- M = G exp(cum_t - cum_s) dt_s in place, masked before the
    // exponential ----
    {
      for (int e = tid; e < TQ * TQ / 4; e += kThreads) {
        const int t = e / (TQ / 4), s0 = (e % (TQ / 4)) * 4;
        const float4 g = *reinterpret_cast<const float4*>(&Ms[t * LDM + s0]);
        const float gv[4] = {g.x, g.y, g.z, g.w};
        float m[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = s0 + i;
          m[i] = (t >= s && t < rows)
                     ? gv[i] * expf(cum[t] - cum[s]) * dts[s]
                     : 0.f;
        }
        *reinterpret_cast<float4*>(&Ms[t * LDM + s0]) =
            make_float4(m[0], m[1], m[2], m[3]);
      }
    }
    __syncthreads();

    // Every tile is visited (columns past N and rows past the chunk are
    // zeros): loops without runtime bounds unroll into straight mma code.
    if (p0 < P) {
      float yacc[8][4];                          // y^T, same layout as hacc
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) yacc[j][c] = 0.f;

      // ---- y^T = h^T C^T (the state before this chunk) ----
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        // A fragment of h^T straight from the accumulator, k permuted
        uint32_t ah[4], al[4];
        split(hacc[nt][0], ah[0], al[0]);
        split(hacc[nt][2], ah[1], al[1]);
        split(hacc[nt][1], ah[2], al[2]);
        split(hacc[nt][3], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 c = *reinterpret_cast<const float2*>(
              &Cs[(8 * j + gid) * LDC + 8 * nt + 2 * tig]);
          mma3<false>(yacc[j], ah, al, c.x, c.y);
        }
      }
      // times exp(cum_t), column by column; the state decays by exp(cum_Q)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e0 = ecum[8 * j + 2 * tig], e1 = ecum[8 * j + 2 * tig + 1];
        yacc[j][0] *= e0;
        yacc[j][1] *= e1;
        yacc[j][2] *= e0;
        yacc[j][3] *= e1;
      }
      const float el = elast[0];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) hacc[nt][c] *= el;

      // ---- y^T += x^T M^T and h^T += x^T (B w), one k step of s at a time
#pragma unroll
      for (int s8 = 0; s8 < 8; ++s8) {
        const int s = 8 * s8 + 2 * tig;          // k = tig <-> s, tig+4 <-> s+1
        const float xa[4] = {
            to_f32(Xs[s * LDX + pa]), to_f32(Xs[s * LDX + pb]),
            to_f32(Xs[(s + 1) * LDX + pa]), to_f32(Xs[(s + 1) * LDX + pb])};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (kExactX) {
            ah[i] = __float_as_uint(xa[i]);
            al[i] = 0u;
          } else {
            split(xa[i], ah[i], al[i]);
          }
        }
#pragma unroll
        for (int j = s8; j < 8; ++j) {           // M is 0 above the diagonal
          const float2 m = *reinterpret_cast<const float2*>(
              &Ms[(8 * j + gid) * LDM + s]);
          mma3<kExactX>(yacc[j], ah, al, m.x, m.y);
        }
        const float w0 = wv[s], w1 = wv[s + 1];
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          const int n = 8 * nt + gid;
          mma3<kExactX>(hacc[nt], ah, al, Bs[s * LDB + n] * w0,
                        Bs[(s + 1) * LDB + n] * w1);
        }
      }

      // ---- y = y^T + D x --------------------------------------------------
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int t = 8 * j + 2 * tig + (c & 1);
          const int p = c < 2 ? pa : pb;
          if (t < rows && p < P)
            yh[(long long)(l0 + t) * sy.l + p] =
                from_f32<T>(yacc[j][c] + Dh * to_f32(Xs[t * LDX + p]));
        }
      }
    }
    __syncthreads();   // every read of this chunk's tiles is done
  }

  if (h_out != nullptr && p0 < P) {
    float* ho = h_out + (long long)blockIdx.x * N * P;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = 8 * nt + 2 * tig + (c & 1);
        const int p = c < 2 ? pa : pb;
        if (n < N && p < P) ho[(long long)n * P + p] = hacc[nt][c];
      }
  }
}

template <typename T>
int launch_scan(const void* x, const float* dt, const float* A,
                const float* Bm, const float* Cm, const float* D,
                const float* G, void* y, float* h_out, int Bz, int H, int L,
                int P, int N, int chunk, Str3 sx, Str3 sdt, Str2 sa,
                Str3 sb, Str3 sc, Str2 sd, Str3 sy, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int vx = vec_bytes(x, sx.b, sx.h, sx.l, (int)sizeof(T));
  const int vbc = vec_bytes(Bm, sb.b, sb.h, sb.l, 4) == 16 &&
                          vec_bytes(Cm, sc.b, sc.h, sc.l, 4) == 16
                      ? 16
                      : 4;
  const long long blocks = (long long)Bz * H;
  ssd_scan_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, Bm, Cm, D, G, static_cast<T*>(y),
      h_out, H, L, P, N, chunk, sx, sdt, sa, sb, sc, sd, sy, vx, vbc);
  return (int)cudaGetLastError();
}

bool sizes_ok(int L, int N, int chunk) {
  return chunk >= 1 && chunk <= TQ && N >= 1 && N <= TN && L >= 1;
}

}  // namespace

// G = C B^T per chunk: B and C f32, indexed [Bz, L, N] with strides in
// elements (the last dimension contiguous); G a contiguous f32 [Bz,
// n_chunks, 64, 64], rows and columns past the chunk's live rows zero.
// 1 <= chunk <= 64, 1 <= N <= 128.
extern "C" int ssd_cb_launch(const void* Bm, const void* Cm, void* G,
                             int Bz, int L, int N, int chunk, long long b_sb,
                             long long b_sl, long long c_sb, long long c_sl,
                             void* stream) {
  if (!sizes_ok(L, N, chunk)) return (int)cudaErrorInvalidValue;
  if (Bz == 0) return (int)cudaGetLastError();
  constexpr int smem = kCbSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (L + chunk - 1) / chunk;
  if (Bz > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_chunks, (unsigned)Bz);
  const int vbc = vec_bytes(Bm, b_sb, 0, b_sl, 4) == 16 &&
                          vec_bytes(Cm, c_sb, 0, c_sl, 4) == 16
                      ? 16
                      : 4;
  ssd_cb_kernel<<<grid, kCbThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(G), L, N, chunk, Str3{b_sb, 0, b_sl},
      Str3{c_sb, 0, c_sl}, vbc);
  return (int)cudaGetLastError();
}

// x and y: bf16 (is_bf16 = 1) or f32, indexed [Bz, H, L, P]; dt [Bz, H, L],
// A and D [Bz, H], B and C [Bz, H, L, N], all f32.  Strides are in
// elements per tensor (batch, head, row); the last dimension of x, B, C
// and y is contiguous.  B and C must be the same for every head (a head
// stride of 0, or H = 1): G is ssd_cb_launch's output for them and the
// same chunk, one per batch.  h_out: null, or a contiguous f32 [Bz, H, N,
// P].
// 1 <= chunk <= 64, 1 <= P <= 64, 1 <= N <= 128.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* G, void* y, void* h_out,
    int is_bf16, int Bz, int H, int L, int P, int N, int chunk,
    long long x_sb, long long x_sh, long long x_sl, long long dt_sb,
    long long dt_sh, long long dt_sl, long long a_sb, long long a_sh,
    long long b_sb, long long b_sh, long long b_sl, long long c_sb,
    long long c_sh, long long c_sl, long long d_sb, long long d_sh,
    long long y_sb, long long y_sh, long long y_sl, void* stream) {
  if (!sizes_ok(L, N, chunk) || H < 1 || P < 1 || P > TP)
    return (int)cudaErrorInvalidValue;
  if (Bz == 0) return (int)cudaGetLastError();
  const Str3 sx{x_sb, x_sh, x_sl}, sdt{dt_sb, dt_sh, dt_sl},
      sb{b_sb, b_sh, b_sl}, sc{c_sb, c_sh, c_sl}, sy{y_sb, y_sh, y_sl};
  const Str2 sa{a_sb, a_sh}, sd{d_sb, d_sh};
  cudaStream_t s = (cudaStream_t)stream;
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_a = static_cast<const float*>(A);
  const float* f_b = static_cast<const float*>(Bm);
  const float* f_c = static_cast<const float*>(Cm);
  const float* f_d = static_cast<const float*>(D);
  const float* f_g = static_cast<const float*>(G);
  float* f_h = static_cast<float*>(h_out);
  if (is_bf16)
    return launch_scan<__nv_bfloat16>(x, f_dt, f_a, f_b, f_c, f_d, f_g, y,
                                      f_h, Bz, H, L, P, N, chunk, sx,
                                      sdt, sa, sb, sc, sd, sy, s);
  return launch_scan<float>(x, f_dt, f_a, f_b, f_c, f_d, f_g, y, f_h, Bz, H,
                            L, P, N, chunk, sx, sdt, sa, sb, sc, sd, sy, s);
}
