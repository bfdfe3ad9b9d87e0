// Hand-written Hopper (sm_90a) kernel: the Mamba-2 SSD chunked scan.
//
// ssd_scan_kernel replaces the TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py::ssd_scan
//   (_ssd_kernel, pallas_call over the grid (batch * head, chunks)).
//
// What it computes (the Pallas kernel's function, ref.py::ssd_chunked):
// per (batch, head), with an [N, P] f32 state h carried across chunks of
// Q steps, in order:
//   cum_t  = sum_{s <= t} dt_s * A                    (within the chunk)
//   y_t    = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//          + exp(cum_t) C_t^T h + D x_t
//   h     <- exp(cum_Q) h + sum_t dt_t exp(cum_Q - cum_t) B_t (x) x_t
// x and y in bf16 or f32, dt, A, B, C, D in f32, all math in f32; h_final
// optionally written out.  The sequence may be ragged: rows past L act as
// dt = 0, x = 0 (the reference's padding), which leaves h unchanged, and
// no y row past L is written.
//
// What bounds it on this card: at one Mamba2-1.3B layer's prefill (8 x
// 2000 tokens, 64 heads of P = 64, N = 128, chunk 64) the scan reads x
// (bf16, 131 MB), dt, B and C (f32, 21 MB; B and C are shared by the heads
// and read once per batch) and writes y (131 MB) and h_final (17 MB):
// about 300 MB, 89 us at 3.35 TB/s.  Its products are about 47 GFLOP
// under the causal mask, 47 us at the bf16 tensor-core peak of 989
// TFLOP/s.  So the bound is bytes.  This first design keeps the
// reference's f32 products and runs them as f32 FMAs on the CUDA cores
// (67 TFLOP/s), which puts it well above that bound by construction.
// Tensor cores (a numerics decision against the f32 reference) and TMA
// are later work.
//
// What the design does about it:
// - The TPU's sequential chunk grid axis becomes a loop inside the block:
//   one block per (batch, head), 256 threads.  The state lives in
//   registers (each thread owns an 8 x 4 block of h) and in shared memory
//   for the C h product; it never leaves the chip until h_final.
// - Per chunk, x, B and C are staged in shared memory as f32 (rows past
//   the chunk's end or L, and columns past P or N, as zeros), and warp 0
//   forms cum with a warp scan, with exp(cum_t) and dt_s exp(cum_Q -
//   cum_s) beside it.
// - The four products are register-tiled on the CUDA cores: G = C B^T
//   (4 x 4 per thread), then M = G exp(cum_t - cum_s) dt_s, selected to 0
//   above the diagonal BEFORE the exponential (there cum_t - cum_s > 0
//   and exp may overflow; 0 * inf would be NaN); y = M x + exp(cum) C h
//   + D x (4 x 4 per thread, the M x sum stopping at the warp's diagonal);
//   h' = exp(cum_Q) h + (B w)^T x (8 x 4 per thread).  Rows of B and C are
//   padded by 4 floats so the 16-byte loads of the C B^T tile are free of
//   bank conflicts.
// - Inputs are read through their strides (the last dimension of x, B, C
//   and y contiguous): the model's x is a strided view of its conv
//   output, B and C are [batch, L, N] with a head stride of 0, and y is
//   written in the model's [batch, L, head, P] layout, so no copy is
//   made on either side.
// - Tiles are sized for Q <= 64, P <= 64, N <= 128 (Mamba2-1.3B's shape);
//   a smaller chunk, P or N runs in the same tiles, zero-padded.
//
// The entry point returns cudaGetLastError() after the launch, so a
// refused launch surfaces in the Python wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;          // rows of a staged chunk
constexpr int TP = 64;          // largest head dim P
constexpr int TN = 128;         // largest state size N
constexpr int kThreads = 256;   // 16 x 16: tx picks columns, ty rows
constexpr int LDX = TP + 4;     // Xs row stride (floats)
constexpr int LDN = TN + 4;     // Bs/Cs row stride: conflict-free float4
constexpr int LDM = TQ + 4;     // Ms row stride
constexpr int LDH = TP;         // Hs row stride
constexpr int kSmemFloats =
    TQ * LDX + 2 * TQ * LDN + TN * LDH + TQ * LDM + 4 * TQ + 4;

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

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ D, T* __restrict__ y,
                    float* __restrict__ h_out, int H, int L, int P, int N,
                    int chunk, Str3 sx, Str3 sdt, Str2 sa, Str3 sb, Str3 sc,
                    Str2 sd, Str3 sy) {
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);   // [TQ][LDX]
  float* Bs = Xs + TQ * LDX;                     // [TQ][LDN]
  float* Cs = Bs + TQ * LDN;                     // [TQ][LDN]
  float* Hs = Cs + TQ * LDN;                     // [TN][LDH]
  float* Ms = Hs + TN * LDH;                     // [TQ][LDM]
  float* cum = Ms + TQ * LDM;                    // [TQ]
  float* ecum = cum + TQ;                        // [TQ] exp(cum_t)
  float* wv = ecum + TQ;                         // [TQ] dt_s exp(cum_Q - cum_s)
  float* dts = wv + TQ;                          // [TQ]
  float* elast = dts + TQ;                       // [1] exp(cum_Q)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / H, hd = blockIdx.x % H;
  const T* xh = x + b * sx.b + hd * sx.h;
  const float* dth = dt + b * sdt.b + hd * sdt.h;
  const float* Bh = Bm + b * sb.b + hd * sb.h;
  const float* Ch = Cm + b * sc.b + hd * sc.h;
  T* yh = y + b * sy.b + hd * sy.h;
  const float Ah = A[b * sa.b + hd * sa.h];
  const float Dh = D[b * sd.b + hd * sd.h];
  const int n4 = (N + 3) & ~3;   // columns of B/C the products read

  for (int e = tid; e < TN * LDH; e += kThreads) Hs[e] = 0.f;
  float hreg[8][4];              // h[ty*8 + i][tx*4 + c]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) hreg[i][c] = 0.f;

  const int n_chunks = (L + chunk - 1) / chunk;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int l0 = ci * chunk;
    const int rows = min(chunk, L - l0);

    // ---- stage the chunk ------------------------------------------------
    for (int e = tid; e < TQ * TP; e += kThreads) {
      const int r = e / TP, p = e % TP;
      float v = 0.f;
      if (r < rows && p < P) v = to_f32(xh[(long long)(l0 + r) * sx.l + p]);
      Xs[r * LDX + p] = v;
    }
    for (int e = tid; e < TQ * TN; e += kThreads) {
      const int r = e / TN, n = e % TN;
      float bv = 0.f, cv = 0.f;
      if (r < rows && n < N) {
        bv = Bh[(long long)(l0 + r) * sb.l + n];
        cv = Ch[(long long)(l0 + r) * sc.l + n];
      }
      Bs[r * LDN + n] = bv;
      Cs[r * LDN + n] = cv;
    }
    if (tid < 32) {
      // cum: an inclusive warp scan over two halves of 32 rows
      const int r0 = tid, r1 = tid + 32;
      const float d0 = r0 < rows ? dth[(long long)(l0 + r0) * sdt.l] : 0.f;
      const float d1 = r1 < rows ? dth[(long long)(l0 + r1) * sdt.l] : 0.f;
      float a0 = d0 * Ah, a1 = d1 * Ah;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, a0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, a1, off);
        if (tid >= off) {
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
      if (tid == 0) elast[0] = expf(last);
    }
    __syncthreads();

    // ---- G = C B^T, then M (masked before the exponential) --------------
    {
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
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          Ms[t * LDM + s] =
              t >= s ? g[i][j] * expf(cum[t] - cum[s]) * dts[s] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = M x + exp(cum) C h + D x ---------------------------------------
    {
      float acc[4][4], ch[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = ch[i][c] = 0.f;
      // M is 0 above the diagonal and past the chunk: stop at the warp's
      // last row (ty pairs share a warp) and at the chunk's end
      const int s_end = min((ty | 1) * 4 + 4, (rows + 3) & ~3);
      for (int s = 0; s < s_end; s += 4) {
        float4 mv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mv[i] = *reinterpret_cast<const float4*>(&Ms[(ty * 4 + i) * LDM + s]);
#pragma unroll
        for (int ss = 0; ss < 4; ++ss) {
          const float4 xv =
              *reinterpret_cast<const float4*>(&Xs[(s + ss) * LDX + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float m = comp(mv[i], ss);
            acc[i][0] = fmaf(m, xv.x, acc[i][0]);
            acc[i][1] = fmaf(m, xv.y, acc[i][1]);
            acc[i][2] = fmaf(m, xv.z, acc[i][2]);
            acc[i][3] = fmaf(m, xv.w, acc[i][3]);
          }
        }
      }
#pragma unroll 2
      for (int n = 0; n < n4; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(&Cs[(ty * 4 + i) * LDN + n]);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const float4 hv =
              *reinterpret_cast<const float4*>(&Hs[(n + nn) * LDH + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float c = comp(cv[i], nn);
            ch[i][0] = fmaf(c, hv.x, ch[i][0]);
            ch[i][1] = fmaf(c, hv.y, ch[i][1]);
            ch[i][2] = fmaf(c, hv.z, ch[i][2]);
            ch[i][3] = fmaf(c, hv.w, ch[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty * 4 + i;
        if (t >= rows) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx * 4 + c;
          if (p < P) {
            const float v = acc[i][c] + ecum[t] * ch[i][c];
            yh[(long long)(l0 + t) * sy.l + p] =
                from_f32<T>(v + Dh * Xs[t * LDX + p]);
          }
        }
      }
    }

    // ---- h' = exp(cum_Q) h + sum_s (B_s w_s) (x) x_s ------------------------
    {
      float inj[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) inj[i][c] = 0.f;
      for (int s = 0; s < rows; ++s) {
        const float w = wv[s];
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s * LDN + ty * 8]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[s * LDN + ty * 8 + 4]);
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[s * LDX + tx * 4]);
        const float bw[8] = {b0.x * w, b0.y * w, b0.z * w, b0.w * w,
                             b1.x * w, b1.y * w, b1.z * w, b1.w * w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          inj[i][0] = fmaf(bw[i], xv.x, inj[i][0]);
          inj[i][1] = fmaf(bw[i], xv.y, inj[i][1]);
          inj[i][2] = fmaf(bw[i], xv.z, inj[i][2]);
          inj[i][3] = fmaf(bw[i], xv.w, inj[i][3]);
        }
      }
      const float el = elast[0];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) hreg[i][c] = el * hreg[i][c] + inj[i][c];
    }
    __syncthreads();   // every read of Hs, Xs, Bs, Cs of this chunk is done
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(&Hs[(ty * 8 + i) * LDH + tx * 4]) =
          make_float4(hreg[i][0], hreg[i][1], hreg[i][2], hreg[i][3]);
  }

  if (h_out != nullptr) {
    float* ho = h_out + (long long)blockIdx.x * N * P;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = ty * 8 + i;
      if (n >= N) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx * 4 + c;
        if (p < P) ho[(long long)n * P + p] = hreg[i][c];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* D, void* y, float* h_out, int Bz,
           int H, int L, int P, int N, int chunk, Str3 sx, Str3 sdt, Str2 sa,
           Str3 sb, Str3 sc, Str2 sd, Str3 sy, cudaStream_t stream) {
  constexpr int smem = kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)Bz * H;
  ssd_scan_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, Bm, Cm, D, static_cast<T*>(y), h_out,
      H, L, P, N, chunk, sx, sdt, sa, sb, sc, sd, sy);
  return (int)cudaGetLastError();
}

}  // namespace

// x and y: bf16 (is_bf16 = 1) or f32, indexed [Bz, H, L, P]; dt [Bz, H, L],
// A and D [Bz, H], B and C [Bz, H, L, N], all f32.  Strides are in
// elements per tensor (batch, head, row); the last dimension of x, B, C
// and y is contiguous.  h_out: null, or a contiguous f32 [Bz, H, N, P].
// 1 <= chunk <= 64, 1 <= P <= 64, 1 <= N <= 128.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, void* y, void* h_out, int is_bf16, int Bz,
    int H, int L, int P, int N, int chunk, long long x_sb, long long x_sh,
    long long x_sl, long long dt_sb, long long dt_sh, long long dt_sl,
    long long a_sb, long long a_sh, long long b_sb, long long b_sh,
    long long b_sl, long long c_sb, long long c_sh, long long c_sl,
    long long d_sb, long long d_sh, long long y_sb, long long y_sh,
    long long y_sl, void* stream) {
  if (chunk < 1 || chunk > TQ || P < 1 || P > TP || N < 1 || N > TN ||
      H < 1 || L < 1)
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
  float* f_h = static_cast<float*>(h_out);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, f_dt, f_a, f_b, f_c, f_d, y, f_h, Bz, H,
                                 L, P, N, chunk, sx, sdt, sa, sb, sc, sd, sy,
                                 s);
  return launch<float>(x, f_dt, f_a, f_b, f_c, f_d, y, f_h, Bz, H, L, P, N,
                       chunk, sx, sdt, sa, sb, sc, sd, sy, s);
}
