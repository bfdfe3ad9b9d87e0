// Hand-written Hopper (sm_90a) kernels for the NetCRAQ register store.
//
// kv_read_kernel replaces the TPU kernel
//   src/repro/kernels/kv_engine/kernel.py::cluster_read_engine
//   (_read_kernel_cluster / _read_tile),
// kv_write_kernel replaces
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
// plus one dependent round trip to memory per thread.  At that size what a
// node step costs is the number of launches around the kernels, each a few
// microseconds of host dispatch, so the per-node kernels take the whole of
// a node step's read, or of its dirty appends, into one launch for all
// C * n nodes (the "chain" axis of the reference kernels is the flattened
// node axis here), in one of two modes fixed at compile time:
//
//   engine mode (OPS = false): the Pallas kernels' contract.  A key
//     outside [0, K) answers zeros and is never accepted; the read writes
//     the five lookups; the append takes the caller's rank.
//   ops mode (OPS = true): the node step's own read and append, as the
//     reference's jnp store does them.  The raw keys resolve inside the
//     kernel (a gather wraps a negative key once, then clamps into
//     [0, K); a scatter wraps once, then drops), the read writes the reply
//     and the NetCRAQ decision, and the append ranks its batch itself and
//     takes the bool active mask and writes bool accept flags, so nothing
//     else is dispatched between the store and the outputs.
//
// Layout (all int32 unless stated, contiguous, value cells 16-byte aligned):
//   values [N, K, V, 4], seqs [N, K, V], pending [N, K], a batch [N, B];
//   in the ops mode active, is_tail and accepted are bytes (torch.bool).
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
// Every entry point returns cudaGetLastError() after the launch, so a
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

// A negative key wraps once, as a JAX gather or scatter index does.
__device__ __forceinline__ int wrap_once(int key, int K) {
  return key < 0 ? key + K : key;
}

// Cell c of register `row` and its seq, or null and 0 for a c outside
// [0, V).
__device__ __forceinline__ const int* cell_at(const int* __restrict__ values,
                                              const int* __restrict__ seqs,
                                              int64_t row, int c, int V,
                                              int& seq) {
  if (c < 0 || c >= V) {
    seq = 0;
    return nullptr;
  }
  seq = __ldg(seqs + row * V + c);
  return values + (row * V + c) * W;
}

// One thread per (node, query).  Engine mode: a key outside [0, K) matches
// no register and answers all-zero, as the TPU kernel's one-hot (it matches
// no tile row), and is never used as an address; a pending count outside
// [0, V) likewise yields a zero latest cell.  Outputs: out_val/out_seq the
// clean cell, latest_val/latest_seq the latest, out_code the pending count.
// Ops mode: the key reads the register the store's gather clamps it to, and
// the thread loads only the cell it answers with: the latest when the
// register is dirty at a tail node (is_tail[n], or tail_all when is_tail is
// null), else the clean cell.  out_code is the decision: 0 clean, 1 dirty
// at the tail, 2 dirty elsewhere (forward to the tail).
template <bool OPS>
__global__ void kv_read_kernel(const int* __restrict__ values,
                               const int* __restrict__ seqs,
                               const int* __restrict__ pending,
                               const int* __restrict__ keys,
                               const unsigned char* __restrict__ is_tail,
                               int tail_all, int N, int K, int V, int B,
                               int* __restrict__ out_val,
                               int* __restrict__ out_seq,
                               int* __restrict__ latest_val,
                               int* __restrict__ latest_seq,
                               int* __restrict__ out_code) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)N * B) return;
  const int64_t n = t / B;
  int key = __ldg(keys + t);
  if constexpr (OPS) {
    key = min(max(wrap_once(key, K), 0), K - 1);
    const int64_t row = n * K + key;
    const int p = __ldg(pending + row);
    const bool tail = is_tail ? is_tail[n] != 0 : tail_all != 0;
    const bool from_latest = p != 0 && tail;
    int s;
    copy_cell(out_val + t * W,
              cell_at(values, seqs, row, from_latest ? p : 0, V, s));
    out_seq[t] = s;
    out_code[t] = p == 0 ? 0 : (tail ? 1 : 2);
  } else {
    const int* cell0 = nullptr;
    const int* latest = nullptr;
    int cs = 0, ls = 0, p = 0;
    if (key >= 0 && key < K) {
      const int64_t row = n * K + key;
      p = __ldg(pending + row);
      cell0 = cell_at(values, seqs, row, 0, V, cs);
      latest = cell_at(values, seqs, row, p, V, ls);
    }
    copy_cell(out_val + t * W, cell0);
    copy_cell(latest_val + t * W, latest);
    out_seq[t] = cs;
    latest_seq[t] = ls;
    out_code[t] = p;
  }
}

// Shared memory of an append block per lane of its batch: a staged write's
// raw key, lane, base and rank and, in the ops mode, whether a later write
// takes its cell.
constexpr int kWriteSmemPerLane = (int)(4 * sizeof(int) + sizeof(bool));

template <bool OPS>
__device__ __forceinline__ void store_flag(void* out, int64_t i, bool v) {
  if constexpr (OPS) {
    static_cast<unsigned char*>(out)[i] = v;
  } else {
    static_cast<int*>(out)[i] = v;
  }
}

__device__ __forceinline__ int count_eq(int4 k, int v) {
  return (k.x == v) + (k.y == v) + (k.z == v) + (k.w == v);
}

// Where a write of raw key `raw` lands (`dst`, K for nowhere) and where its
// base is read (`reg`).  Engine mode: the key itself (a live write's key is
// in [0, K)).  Ops mode: the reference store's scatter (wrap once, else
// drop) and gather (wrap once, then clamp).
template <bool OPS>
__device__ __forceinline__ void resolve(int raw, int K, int& dst, int& reg) {
  if constexpr (OPS) {
    const int w = wrap_once(raw, K);
    dst = (w >= 0 && w < K) ? w : K;
    reg = min(max(w, 0), K - 1);
  } else {
    dst = reg = raw;
  }
}

// One block per node row n, its threads looping over the row's B lanes.
// A row is one node's store and no other block touches it, so a barrier
// after every write has read its base (the pending count of its register)
// stands in for a snapshot of pending: the slot of a write is
// base + 1 + rank, and reading the live counter instead would race with an
// earlier same-key write's atomicAdd.
//
// 1. Stage the live lanes (engine: active and its key in [0, K); ops:
//    active) in lane order: staged write c holds its raw key and lane.
// 2. One thread per staged write loads its base and, in the ops mode, takes
//    its rank while the load is in flight: the count of earlier staged
//    writes with the same raw key (store.batch_rank on the raw keys), read
//    four keys a shared load, O(live) per write.  A node step's batch holds
//    a few live writes per node, so the pass is short where it matters.
//    Where a row stages a negative key that wraps onto a register, the
//    same pass says whether a later write takes the write's cell.  Only
//    the register's other raw name can (-1 and K - 1 rank apart, so their
//    r-th writes share a slot): its write of rank r exists when it has
//    more than r writes, and comes later when at most r of them come
//    before.  The plain version's scatter keeps the later write, so the
//    earlier one stores nothing.  The engine mode takes the caller's rank,
//    the within-batch same-key rank of the Pallas contract, under which
//    accepted (key, slot) pairs are unique.
// 3. Append: accepted iff the slot fits (slot <= V - 1), so a write the
//    ops mode drops is accepted when its clamped register's slot fits, as
//    store.append_dirty has it; an accepted write to a register in [0, K)
//    stores its cell and counts into pending with an atomicAdd, exact for
//    two raw keys of one register.
template <bool OPS>
__global__ void kv_write_kernel(int* __restrict__ values,
                                int* __restrict__ seqs, int* pending,
                                const int* __restrict__ keys,
                                const int* __restrict__ wvals,
                                const int* __restrict__ wseqs,
                                const void* __restrict__ active,
                                const int* __restrict__ rank, int K, int V,
                                int B, void* __restrict__ accepted) {
  extern __shared__ int s_key[];
  int* s_lane = s_key + B;
  int* s_base = s_lane + B;
  int* s_rank = s_base + B;
  bool* s_shadowed = reinterpret_cast<bool*>(s_rank + B);
  __shared__ int s_warp_live[32];
  const int64_t lane0 = (int64_t)blockIdx.x * B;
  int* row_pending = pending + (int64_t)blockIdx.x * K;
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  int live = 0;  // writes staged by the earlier passes, in every thread
  bool others = false;  // a staged key names its register by wrapping
  for (int i0 = 0; i0 < B; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    bool is_live = false;
    int raw = 0;
    if (i < B) {
      raw = __ldg(keys + lane0 + i);
      if constexpr (OPS) {
        is_live = static_cast<const unsigned char*>(active)[lane0 + i] != 0;
      } else {
        is_live = __ldg(static_cast<const int*>(active) + lane0 + i) > 0 &&
                  raw >= 0 && raw < K;
      }
      if (!is_live) store_flag<OPS>(accepted, lane0 + i, false);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, is_live);
    if ((threadIdx.x & 31) == 0) s_warp_live[warp] = __popc(ballot);
    __syncthreads();
    int c = live + __popc(ballot & ((1u << (threadIdx.x & 31)) - 1));
    for (int w = 0; w < n_warps; ++w) {
      const int n_w = s_warp_live[w];
      c += w < warp ? n_w : 0;
      live += n_w;
    }
    if (is_live) {
      s_key[c] = raw;
      s_lane[c] = i;
    }
    others |= __syncthreads_or(OPS && is_live && raw < 0 && raw >= -K) != 0;
  }
  if constexpr (OPS) {
    const int4* key4 = reinterpret_cast<const int4*>(s_key);
    for (int c = threadIdx.x; c < live; c += blockDim.x) {
      const int key = s_key[c];
      int dst, reg;
      resolve<OPS>(key, K, dst, reg);
      const int base = row_pending[reg];  // stored last: the pass hides it
      const int other = key < 0 ? dst : dst - K;  // the register's other name
      const int head = c & ~3;
      int same = 0, other_before = 0, other_after = 0;
      if (!others) {  // the rank alone: the keys before c
#pragma unroll 4
        for (int d = 0; d < head; d += 4) same += count_eq(key4[d >> 2], key);
        for (int d = head; d < c; ++d) same += s_key[d] == key;
      } else {  // and the other name's writes before and after c
#pragma unroll 4
        for (int d = 0; d < head; d += 4) {
          const int4 k = key4[d >> 2];
          same += count_eq(k, key);
          other_before += count_eq(k, other);
        }
        for (int d = head; d < c; ++d) {
          same += s_key[d] == key;
          other_before += s_key[d] == other;
        }
        for (int d = c; d < live; ++d) other_after += s_key[d] == other;
      }
      s_rank[c] = same;
      s_shadowed[c] = other_before + other_after > same &&
                      other_before <= same;
      s_base[c] = base;
    }
  } else {
    for (int c = threadIdx.x; c < live; c += blockDim.x) {
      s_base[c] = row_pending[s_key[c]];
      s_rank[c] = __ldg(rank + lane0 + s_lane[c]);
    }
  }
  __syncthreads();  // every base read before any write of this row lands
  for (int c = threadIdx.x; c < live; c += blockDim.x) {
    int dst, reg;
    resolve<OPS>(s_key[c], K, dst, reg);
    const int i = s_lane[c];
    const int slot = s_base[c] + 1 + s_rank[c];
    const bool ok = slot <= V - 1;
    store_flag<OPS>(accepted, lane0 + i, ok);
    if (!ok || dst >= K) continue;
    bool store = slot >= 0;
    if constexpr (OPS) store = store && !s_shadowed[c];
    if (store) {
      const int64_t row = (int64_t)blockIdx.x * K + dst;
      copy_cell(values + (row * V + slot) * W, wvals + (lane0 + i) * W);
      seqs[row * V + slot] = __ldg(wseqs + lane0 + i);
    }
    atomicAdd(row_pending + dst, 1);
  }
}

// An empty kernel: the device time of a launch that does nothing, the
// floor the per-node kernels sit on (timed beside them, counted nowhere).
__global__ void kv_empty_kernel() {}

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

// One block of up to kWriteThreads threads per node row; the staged batch
// in dynamic shared memory, above 48 KB in all once the kernel is allowed
// it.
constexpr int kWriteThreads = 512;
constexpr int kSharedPerBlock = 232448;  // sm_90's opt-in limit

template <bool OPS>
int write_launch(int* values, int* seqs, int* pending, const int* keys,
                 const int* wvals, const int* wseqs, const void* active,
                 const int* rank, int N, int K, int V, int B, void* accepted,
                 void* stream) {
  if (N <= 0 || B <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)B * kWriteSmemPerLane;
  const size_t fixed = 32 * sizeof(int);
  if (smem + fixed > (size_t)kSharedPerBlock) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem + fixed > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kv_write_kernel<OPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = B >= kWriteThreads ? kWriteThreads : (B + 31) / 32 * 32;
  kv_write_kernel<OPS><<<N, threads, smem, (cudaStream_t)stream>>>(
      values, seqs, pending, keys, wvals, wseqs, active, rank, K, V, B,
      accepted);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kv_read_launch(const int* values, const int* seqs,
                              const int* pending, const int* keys, int N,
                              int K, int V, int B, int* clean_val,
                              int* clean_seq, int* latest_val, int* latest_seq,
                              int* pend_out, void* stream) {
  const int64_t total = (int64_t)N * B;
  if (total > 0) {
    kv_read_kernel<false><<<blocks_for(total), kThreads, 0,
                            (cudaStream_t)stream>>>(
        values, seqs, pending, keys, nullptr, 0, N, K, V, B, clean_val,
        clean_seq, latest_val, latest_seq, pend_out);
  }
  return (int)cudaGetLastError();
}

// The ops mode of the read: raw keys, is_tail [N] bytes (or null, with
// tail_all for every node), the reply and the decision.
extern "C" int kv_read_decide_launch(const int* values, const int* seqs,
                                     const int* pending, const int* keys,
                                     const unsigned char* is_tail,
                                     int tail_all, int N, int K, int V, int B,
                                     int* reply_val, int* reply_seq,
                                     int* decision, void* stream) {
  const int64_t total = (int64_t)N * B;
  if (total > 0) {
    kv_read_kernel<true><<<blocks_for(total), kThreads, 0,
                           (cudaStream_t)stream>>>(
        values, seqs, pending, keys, is_tail, tail_all, N, K, V, B,
        reply_val, reply_seq, nullptr, nullptr, decision);
  }
  return (int)cudaGetLastError();
}

// The engine mode of the append: int32 active, the caller's rank, int32
// accept flags.
extern "C" int kv_write_launch(int* values, int* seqs, int* pending,
                               const int* keys, const int* wvals,
                               const int* wseqs, const int* active,
                               const int* rank, int N, int K, int V, int B,
                               int* accepted, void* stream) {
  return write_launch<false>(values, seqs, pending, keys, wvals, wseqs,
                             active, rank, N, K, V, B, accepted, stream);
}

// The ops mode of the append: raw keys, bool active, the rank taken in the
// block, bool accept flags.
extern "C" int kv_append_launch(int* values, int* seqs, int* pending,
                                const int* keys, const int* wvals,
                                const int* wseqs, const unsigned char* active,
                                int N, int K, int V, int B,
                                unsigned char* accepted, void* stream) {
  return write_launch<true>(values, seqs, pending, keys, wvals, wseqs,
                            active, nullptr, N, K, V, B, accepted, stream);
}

extern "C" int kv_empty_launch(int blocks, int threads, void* stream) {
  kv_empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
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
