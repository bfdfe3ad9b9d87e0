// Hand-written Hopper (sm_90a) kernels for the NetCRAQ register store.
//
// kv_read_kernel replaces the TPU kernel
//   src/repro/kernels/kv_engine/kernel.py::cluster_read_engine
//   (_read_kernel_cluster / _read_tile),
// kv_snapshot_kernel + kv_write_kernel replace
//   src/repro/kernels/kv_engine/kernel.py::cluster_write_engine
//   (_write_kernel_cluster / _write_tile),
// kv_bucketed_read_kernel replaces
//   src/repro/kernels/kv_engine/kernel.py::bucketed_read_engine
//   (_read_kernel_bucketed / _read_tile),
// kv_bucketed_snapshot_kernel + kv_bucketed_write_kernel replace
//   src/repro/kernels/kv_engine/kernel.py::bucketed_write_engine
//   (_write_kernel_bucketed / _write_tile).
//
// The TPU kernels resolve a key with a one-hot masked reduction over key
// tiles held in VMEM: O(B * K) work per batch, which is what a TPU's vector
// unit does well.  Here each query is one thread that computes its row
// address and loads exactly the cells it needs, O(B) work, with the W = 4
// value words of a cell moved as one 16-byte int4 load or store.
//
// What bounds them on this card: at the engine's shapes (a [32, 65536, 4, 4]
// store, a [32, 320] batch) a launch touches well under 1 MB of the 170 MiB
// store, scattered one 16-byte cell at a time, so the 3.35 TB/s of HBM is
// never the limit: a launch costs its launch latency (a few microseconds)
// plus one dependent round trip to memory per thread.  The design keeps it
// at one launch per tick for all C * n nodes (the "chain" axis of the
// reference kernels is the flattened node axis here) and one load chain of
// depth two per thread (pending, then the latest cell).
//
// Layout (all int32, contiguous, value cells 16-byte aligned):
//   values [N, K, V, 4], seqs [N, K, V], pending [N, K], a batch [N, B].
//
// The bucketed kernels serve a flat batch of global keys the caller has
// resolved through the partition map into (chains[i], slots[i]).  The
// TPU kernels walk a (chain, key tile) grid and let each grid row add the
// queries the map routes to it; here each query is again one thread that
// addresses its chain directly.  Their store leaves are [C, K, V, 4],
// [C, K, V] and [C, K] with contiguous inner dimensions and a free chain
// stride per leaf (sv, ss, sp, in int32 words), so one replica of a
// running [C, n, K, ...] cluster store (its tail, say) is read and
// written in place, without a copy.  At the main path's read-back
// (458,752 keys over a 170 MiB store) a launch moves about 35 MB and is
// bound by memory; the thread-per-query design issues every query's
// loads at once and keeps the dependent chain at depth two.
//
// Both entry points return cudaGetLastError() after the launch, so a
// refused launch surfaces in the Python wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Words per value cell: the paper's 128-bit VALUE field.
constexpr int W = 4;

// Copies one cell as a single 16-byte int4 move; a null source writes
// zeros.
__device__ __forceinline__ void copy_cell(int* __restrict__ dst,
                                          const int* __restrict__ src) {
  *reinterpret_cast<int4*>(dst) =
      src ? __ldg(reinterpret_cast<const int4*>(src)) : make_int4(0, 0, 0, 0);
}

// One thread per (node, query).  A key outside [0, K) matches no register
// and answers all-zero, as the TPU kernel's one-hot (it matches no tile
// row); it is never used as an address.  A pending count outside [0, V)
// likewise yields a zero latest cell.
__global__ void kv_read_kernel(const int* __restrict__ values,
                               const int* __restrict__ seqs,
                               const int* __restrict__ pending,
                               const int* __restrict__ keys, int N, int K,
                               int V, int B, int* __restrict__ clean_val,
                               int* __restrict__ clean_seq,
                               int* __restrict__ latest_val,
                               int* __restrict__ latest_seq,
                               int* __restrict__ pend_out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)N * B) return;
  const int64_t n = t / B;
  const int key = __ldg(keys + t);
  const int* cell0 = nullptr;
  const int* latest = nullptr;
  int cs = 0, ls = 0, p = 0;
  if (key >= 0 && key < K) {
    const int64_t row = n * K + key;
    p = __ldg(pending + row);
    cs = __ldg(seqs + row * V);
    cell0 = values + row * V * W;
    if (p >= 0 && p < V) {
      ls = __ldg(seqs + row * V + p);
      latest = values + (row * V + p) * W;
    }
  }
  copy_cell(clean_val + t * W, cell0);
  copy_cell(latest_val + t * W, latest);
  clean_seq[t] = cs;
  latest_seq[t] = ls;
  pend_out[t] = p;
}

// Pass 1 of an append, one thread per (node, write): the pending count of
// the write's register as it stands before any write lands (0 for a key
// outside [0, K)).  Only the batch's words are copied, not the table.
__global__ void kv_snapshot_kernel(const int* __restrict__ pending,
                                   const int* __restrict__ keys, int N, int K,
                                   int B, int* __restrict__ snap) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)N * B) return;
  const int key = __ldg(keys + t);
  snap[t] = (key >= 0 && key < K) ? __ldg(pending + (t / B) * K + key) : 0;
}

// Pass 2, one thread per (node, write).  The append slot is
// snap + 1 + rank: reading the live counter instead would race with the
// atomicAdd of an earlier same-key write and give a later write the wrong
// slot.  Accepted (key, slot) pairs are unique (rank is the within-batch
// same-key rank), so the value and seq stores need no atomics; only the
// counter does.
__global__ void kv_write_kernel(int* __restrict__ values,
                                int* __restrict__ seqs,
                                int* __restrict__ pending,
                                const int* __restrict__ keys,
                                const int* __restrict__ wvals,
                                const int* __restrict__ wseqs,
                                const int* __restrict__ active,
                                const int* __restrict__ rank,
                                const int* __restrict__ snap, int N, int K,
                                int V, int B, int* __restrict__ accepted) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)N * B) return;
  const int64_t n = t / B;
  const int key = __ldg(keys + t);
  int ok = 0;
  if (__ldg(active + t) > 0 && key >= 0 && key < K) {
    const int64_t row = n * K + key;
    const int slot = __ldg(snap + t) + 1 + __ldg(rank + t);
    if (slot <= V - 1) {
      ok = 1;
      if (slot >= 0) {
        copy_cell(values + (row * V + slot) * W, wvals + t * W);
        seqs[row * V + slot] = __ldg(wseqs + t);
      }
      atomicAdd(pending + row, 1);
    }
  }
  accepted[t] = ok;
}

// One thread per flat query.  chains[i] and slots[i] are bounds-checked
// against [0, C) and [0, K) before any address is formed: a parked query
// (chain -1) or a slot outside the store answers zeros, as the TPU
// kernel's chain mask and one-hot do.
__global__ void kv_bucketed_read_kernel(
    const int* __restrict__ values, const int* __restrict__ seqs,
    const int* __restrict__ pending, const int* __restrict__ slots,
    const int* __restrict__ chains, int C, int K, int V, int B, int64_t sv,
    int64_t ss, int64_t sp, int* __restrict__ clean_val,
    int* __restrict__ clean_seq, int* __restrict__ latest_val,
    int* __restrict__ latest_seq, int* __restrict__ pend_out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B) return;
  const int c = __ldg(chains + t);
  const int s = __ldg(slots + t);
  const int* cell0 = nullptr;
  const int* latest = nullptr;
  int cs = 0, ls = 0, p = 0;
  if (c >= 0 && c < C && s >= 0 && s < K) {
    const int* seq_row = seqs + c * ss + (int64_t)s * V;
    p = __ldg(pending + c * sp + s);
    cs = __ldg(seq_row);
    cell0 = values + c * sv + (int64_t)s * V * W;
    if (p >= 0 && p < V) {
      ls = __ldg(seq_row + p);
      latest = cell0 + (int64_t)p * W;
    }
  }
  copy_cell(clean_val + t * W, cell0);
  copy_cell(latest_val + t * W, latest);
  clean_seq[t] = cs;
  latest_seq[t] = ls;
  pend_out[t] = p;
}

// Pass 1 of a bucketed append: each write's pending count as it stands
// before any write lands (0 outside the store).
__global__ void kv_bucketed_snapshot_kernel(const int* __restrict__ pending,
                                            const int* __restrict__ slots,
                                            const int* __restrict__ chains,
                                            int C, int K, int B, int64_t sp,
                                            int* __restrict__ snap) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B) return;
  const int c = __ldg(chains + t);
  const int s = __ldg(slots + t);
  snap[t] = (c >= 0 && c < C && s >= 0 && s < K)
                ? __ldg(pending + c * sp + s)
                : 0;
}

// Pass 2, one thread per write: slot = snap + 1 + rank, where rank is the
// write's place among the batch's earlier active writes to the same
// (chain, slot).  As in kv_write_kernel, reading the live counter would
// race with a same-register write's atomicAdd; accepted (register, cell)
// pairs are unique, so only the counter needs an atomic.
__global__ void kv_bucketed_write_kernel(
    int* __restrict__ values, int* __restrict__ seqs,
    int* __restrict__ pending, const int* __restrict__ slots,
    const int* __restrict__ chains, const int* __restrict__ wvals,
    const int* __restrict__ wseqs, const int* __restrict__ active,
    const int* __restrict__ rank, const int* __restrict__ snap, int C, int K,
    int V, int B, int64_t sv, int64_t ss, int64_t sp,
    int* __restrict__ accepted) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B) return;
  const int c = __ldg(chains + t);
  const int s = __ldg(slots + t);
  int ok = 0;
  if (__ldg(active + t) > 0 && c >= 0 && c < C && s >= 0 && s < K) {
    const int cell = __ldg(snap + t) + 1 + __ldg(rank + t);
    if (cell <= V - 1) {
      ok = 1;
      if (cell >= 0) {
        copy_cell(values + c * sv + ((int64_t)s * V + cell) * W,
                  wvals + t * W);
        seqs[c * ss + (int64_t)s * V + cell] = __ldg(wseqs + t);
      }
      atomicAdd(pending + c * sp + s, 1);
    }
  }
  accepted[t] = ok;
}

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int kv_read_launch(const int* values, const int* seqs,
                              const int* pending, const int* keys, int N,
                              int K, int V, int B, int* clean_val,
                              int* clean_seq, int* latest_val, int* latest_seq,
                              int* pend_out, void* stream) {
  const int64_t total = (int64_t)N * B;
  if (total > 0) {
    kv_read_kernel<<<blocks_for(total), kThreads, 0,
                     (cudaStream_t)stream>>>(values, seqs, pending, keys, N,
                                             K, V, B, clean_val, clean_seq,
                                             latest_val, latest_seq, pend_out);
  }
  return (int)cudaGetLastError();
}

// `snap` is [N, B] scratch; both passes run in order on `stream`.
extern "C" int kv_write_launch(int* values, int* seqs, int* pending,
                               const int* keys, const int* wvals,
                               const int* wseqs, const int* active,
                               const int* rank, int N, int K, int V, int B,
                               int* snap, int* accepted, void* stream) {
  const int64_t total = (int64_t)N * B;
  if (total > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    kv_snapshot_kernel<<<blocks_for(total), kThreads, 0, s>>>(pending, keys,
                                                              N, K, B, snap);
    kv_write_kernel<<<blocks_for(total), kThreads, 0, s>>>(
        values, seqs, pending, keys, wvals, wseqs, active, rank, snap, N, K,
        V, B, accepted);
  }
  return (int)cudaGetLastError();
}

// Strides sv, ss, sp: the chain strides of values, seqs and pending, in
// int32 words.
extern "C" int kv_bucketed_read_launch(
    const int* values, const int* seqs, const int* pending, const int* slots,
    const int* chains, int C, int K, int V, int B, long long sv, long long ss,
    long long sp, int* clean_val, int* clean_seq, int* latest_val,
    int* latest_seq, int* pend_out, void* stream) {
  if (B > 0) {
    kv_bucketed_read_kernel<<<blocks_for(B), kThreads, 0,
                              (cudaStream_t)stream>>>(
        values, seqs, pending, slots, chains, C, K, V, B, sv, ss, sp,
        clean_val, clean_seq, latest_val, latest_seq, pend_out);
  }
  return (int)cudaGetLastError();
}

// `snap` is [B] scratch; both passes run in order on `stream`.
extern "C" int kv_bucketed_write_launch(
    int* values, int* seqs, int* pending, const int* slots,
    const int* chains, const int* wvals, const int* wseqs, const int* active,
    const int* rank, int C, int K, int V, int B, long long sv, long long ss,
    long long sp, int* snap, int* accepted, void* stream) {
  if (B > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    kv_bucketed_snapshot_kernel<<<blocks_for(B), kThreads, 0, st>>>(
        pending, slots, chains, C, K, B, sp, snap);
    kv_bucketed_write_kernel<<<blocks_for(B), kThreads, 0, st>>>(
        values, seqs, pending, slots, chains, wvals, wseqs, active, rank,
        snap, C, K, V, B, sv, ss, sp, accepted);
  }
  return (int)cudaGetLastError();
}
