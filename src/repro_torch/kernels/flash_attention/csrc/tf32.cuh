// Split TF32 ("3xTF32") on mma.sync for the attention kernels' f32 routes
// (flash_attention.cu: flash_fwd_kernel; flash_attention_bwd.cu:
// flash_bwd_dkdv_kernel, flash_bwd_dq_kernel), with the asynchronous row
// copies (16-byte, 4-byte or plain loads, chosen on the host by
// vec_bytes) and shared-memory fragment loads they use.  kernels/build.py
// hashes this file with each source that includes it.
//
// A float32 operand v is split once, when its tile is staged, into hi =
// tf32(v) and lo = v - hi; a product is then a_lo b_hi + a_hi b_lo + a_hi
// b_hi, in f32 accumulators (a_lo b_lo, some 2^-22 of a b, is left out).  An operand that is exact in TF32 (a bf16 value)
// has lo = 0, and its term is left out: two products, or one where both
// are exact.  ref.chunked_bwd(..., split_tf32=True) emulates the
// arithmetic on the CPU.  The same split is ssd_scan.cu's (its own copy).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// A [B, H, rows, D] tensor's batch, head and row strides in elements (the
// last dimension is dense).
struct Strides {
  long long b, h, s;
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

// v rounded to TF32 (10-bit mantissa), to nearest with ties away from zero
// as cvt.rna.tf32.f32 rounds, in two integer operations.
__device__ __forceinline__ float to_tf32(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

// v ~ hi + lo: lo = v - hi exactly, of which the tensor cores read the
// TF32 part (they ignore the low 13 bits of an operand).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const float h = to_tf32(v);
  hi = __float_as_uint(h);
  lo = __float_as_uint(v - h);
}

// d += a b, one m16n8k8 TF32 product with f32 accumulators.  Fragments
// (g = lane / 4, t = lane % 4): a = (row g, k t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b = (k t, column g), (t + 4, g); d = (g, 2t), (g, 2t +
// 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i] += a b[i] for N column tiles sharing one A fragment, in split TF32:
// the small terms a_lo b_hi and a_hi b_lo into e[i], a_hi b_hi into d[i]
// (e may be d), each term over all N accumulators before the next (N
// independent chains).  kExactA / kExactB leave out the term of an
// operand whose lo is 0 (al or bl is then not read).  The tensor cores add
// with truncation, each addition losing up to an ulp of its accumulator
// (toward zero), so a caller keeps its chains short: a separate e sums
// terms some 2^-11 of d's and loses next to nothing, and the caller adds
// e into d, and d into a longer sum, with the CUDA cores' rounded adds.
template <bool kExactA, bool kExactB, int N>
__device__ __forceinline__ void mma3(float (*d)[4], float (*e)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[N][2],
                                     const uint32_t (&bl)[N][2]) {
  if constexpr (!kExactA) {
#pragma unroll
    for (int i = 0; i < N; ++i) mma(e[i], al, bh[i]);
  }
  if constexpr (!kExactB) {
#pragma unroll
    for (int i = 0; i < N; ++i) mma(e[i], ah, bl[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) mma(d[i], ah, bh[i]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 4 tiles of 32-bit values (8 rows of 16 bytes each) from shared
// memory: lane L gives the address of row L % 8 of tile L / 8, and
// register j of lane (g, t) receives row g, column t of tile j.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Two 8 x 4 tiles (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// Asynchronous global -> shared copies of 16 or 4 bytes: src_bytes (at
// most the copy's size) are read, the rest of the copy zero-filled (src is
// not read when src_bytes is 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Returns once at most N of this thread's most recent groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of one head (row stride ld elements) into dst
// [ROWS][LD] in the input's type, rows past n_rows and columns past D (up
// to DP) as zeros, by cp.async copies of kBytes (the host checked the
// alignment); in flight on return.
template <int kBytes, typename T, int ROWS, int DP, int LD, int NTH>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long ld,
                                          int row0, int n_rows, int D) {
  constexpr int kV = kBytes / (int)sizeof(T);
  constexpr int kPer = DP / kV;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * kPer; e += NTH) {
    const int r = e / kPer, c = (e % kPer) * kV;
    const int n = row0 + r < n_rows ? max(0, min(kV, D - c)) : 0;
    const T* p = n > 0 ? src + (long long)(row0 + r) * ld + c : src;
    if constexpr (kBytes == 16)
      cp_async16(dst + r * LD + c, p, n * (int)sizeof(T));
    else
      cp_async4(dst + r * LD + c, p, n * (int)sizeof(T));
  }
}

// copy_rows by the widest copy the rows allow (vec: 16, 4, or 0 for plain
// loads, which have landed on return).
template <typename T, int ROWS, int DP, int LD, int NTH>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long ld,
                                          int row0, int n_rows, int D,
                                          int vec) {
  if (vec == 16) {
    copy_rows<16, T, ROWS, DP, LD, NTH>(dst, src, ld, row0, n_rows, D);
  } else if (vec == 4) {
    copy_rows<4, T, ROWS, DP, LD, NTH>(dst, src, ld, row0, n_rows, D);
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += NTH) {
      const int r = e / DP, c = e % DP;
      dst[r * LD + c] = row0 + r < n_rows && c < D
                            ? src[(long long)(row0 + r) * ld + c]
                            : from_f32<T>(0.f);
    }
  }
}

// The widest cp.async copy (16 or 4 bytes; 0: none) that every row of a
// tensor with this base and these strides (in elements of elem bytes)
// starts aligned to.
inline int vec_bytes(const void* p, const Strides& s, int elem) {
  const int widths[2] = {16, 4};
  for (int bytes : widths) {
    const long long n = bytes / elem;
    if (reinterpret_cast<uintptr_t>(p) % bytes == 0 && s.b % n == 0 &&
        s.h % n == 0 && s.s % n == 0)
      return bytes;
  }
  return 0;
}

}  // namespace tf32
