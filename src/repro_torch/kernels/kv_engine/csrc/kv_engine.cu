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
// kv_bucketed_write_kernel replaces
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
// The bucketed kernels serve a flat batch of global keys through the
// partition map, in the same two modes: the engine mode takes the
// (chains[i], slots[i]) the caller resolved, as the Pallas kernels do;
// the ops mode is the whole of partitioned_read_batch or
// partitioned_write_batch in one launch: the raw global keys are placed
// through the map's owner/base columns inside the kernel, the read writes
// the reply and the decision, and the append ranks its writes itself.
// The TPU kernels walk a (chain, key tile) grid and let each grid row add
// the queries the map routes to it; here each query is one thread that
// addresses its chain directly.  Their store leaves are [C, K, V, 4],
// [C, K, V] and [C, K] with contiguous inner dimensions and a free chain
// stride per leaf (sv, ss, sp, in int32 words), so one replica of a
// running [C, n, K, ...] cluster store (its tail, say) is read and
// written in place, without a copy.
//
// What bounds them: a query needs 4 to 20 bytes of a register, but the
// card moves whole 32-byte sectors, one for the pending word, one for the
// seq and one for the cell of every register a batch touches (a sector
// holds 8 pending words, 2 seq rows or 2 cells).  For phase 2's read of
// 458,752 random global keys (about half the tail's registers)
// chip_smoke.py counts 23.4 MB of useful bytes but 33.8 MB of sectors,
// 7.0 and 10.1 us at 3.35 TB/s, so the sector count, not the byte count,
// is the floor a launch can approach.  The read issues every load of a
// query in one round trip where it can (see kv_bucketed_read_kernel);
// the append needs grid-wide barriers, as its note says.
//
// Every entry point returns cudaGetLastError() after the launch, so a
// refused launch surfaces in the Python wrapper.  The bucketed append
// returns kBatchTooLarge or kStoreTooLarge (negative, no cudaError) for a
// batch or a store that one launch cannot hold, before it launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// The bucketed pair: a flat batch of global keys through the partition map
// ---------------------------------------------------------------------------

// One replica per chain: values [C, K, V, W], seqs [C, K, V], pending
// [C, K], contiguous past a free chain stride (sv, ss, sp, in int32 words).
struct BucketedStore {
  int* values;
  int* seqs;
  int* pending;
  int C, K, V;
  int64_t sv, ss, sp;
};

// What the ops modes read to place a global key: the map's bucket columns
// (owner chain, base register) and the cluster's key hash.
struct KeyMap {
  const int* owner;  // [n_buckets]
  const int* base;   // [n_buckets]
  int n_buckets, n_chains, buckets_per_chain, bucket_slots;
  int num_global_keys;
};

// Map columns up to this many buckets are staged in a block's shared
// memory (phase 7's map has 112); longer ones are read where they lie.
constexpr int kMapStage = 2048;

// Stages the map's columns in dynamic shared memory where they fit and
// points owner/base at the copy; every thread of the block must call it.
__device__ __forceinline__ void stage_map(const KeyMap& m, const int*& owner,
                                          const int*& base) {
  extern __shared__ int s_map[];
  owner = m.owner;
  base = m.base;
  if (m.n_buckets > kMapStage) return;
  for (int b = threadIdx.x; b < m.n_buckets; b += blockDim.x) {
    s_map[b] = __ldg(m.owner + b);
    s_map[m.n_buckets + b] = __ldg(m.base + b);
  }
  __syncthreads();
  owner = s_map;
  base = s_map + m.n_buckets;
}

// (chain, slot) of global key g under the map, as the reference resolves
// it (ClusterConfig.key_to_chain/key_to_slot on a key made safe): a key
// outside [0, num_global_keys) is parked on chain -1 with key 0's slot;
// the bucket index wraps once if negative, then clamps (a JAX gather),
// which no key in range needs.  Returns whether g lies in the key space.
__device__ __forceinline__ bool place_key(int g, const KeyMap& m,
                                          const int* owner, const int* base,
                                          int& chain, int& slot) {
  const bool in_range = g >= 0 && g < m.num_global_keys;
  const int safe = in_range ? g : 0;
  const int q = safe / m.n_chains;
  int b = (safe % m.n_chains) * m.buckets_per_chain + q / m.bucket_slots;
  if (b < 0) b += m.n_buckets;
  b = min(max(b, 0), m.n_buckets - 1);
  chain = in_range ? owner[b] : -1;
  slot = base[b] + q % m.bucket_slots;
  return in_range;
}

__device__ __forceinline__ bool in_store(const BucketedStore& st, int c,
                                         int s) {
  return c >= 0 && c < st.C && s >= 0 && s < st.K;
}

__device__ __forceinline__ int4 load_cell(const int* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// One thread per flat query.  The query's first loads go out together: its
// pending count, cells 0 and 1 (one 32-byte sector of a 16-byte aligned
// register row) and their seqs; only a latest cell past 1 costs a second
// round trip.  A chain outside [0, C) (a parked query, chain -1) or a
// slot outside [0, K) forms no address and answers zeros, as the TPU
// kernel's chain mask and one-hot do.
//
// Engine mode (OPS = false): slots and chains in (keys = slots); writes the
// five lookups (clean cell, latest cell, pending).  Ops mode: global keys
// in, placed through the map inside; writes the reply, the NetCRAQ
// decision (0 clean, 1 dirty at a tail, 2 dirty elsewhere, -1 with a zero
// reply for a key outside the key space) and the chains and slots.
template <bool OPS>
__global__ void kv_bucketed_read_kernel(
    const BucketedStore st, const int* __restrict__ keys,
    const int* __restrict__ chains_in, const KeyMap map, int tail, int B,
    int* __restrict__ out_val, int* __restrict__ out_seq,
    int* __restrict__ latest_val, int* __restrict__ latest_seq,
    int* __restrict__ out_code, int* __restrict__ chains_out,
    int* __restrict__ slots_out) {
  const int* owner = nullptr;
  const int* base = nullptr;
  if constexpr (OPS) stage_map(map, owner, base);
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B) return;
  int c, s;
  bool in_range = true;
  if constexpr (OPS) {
    in_range = place_key(__ldg(keys + t), map, owner, base, c, s);
    chains_out[t] = c;
    slots_out[t] = s;
  } else {
    c = __ldg(chains_in + t);
    s = __ldg(keys + t);
  }
  const int V = st.V;
  const bool ok = in_store(st, c, s);
  const int* row = nullptr;
  const int* srow = nullptr;
  int p = 0, seq0 = 0, seq1 = 0;
  int4 cell0 = make_int4(0, 0, 0, 0), cell1 = cell0;
  if (ok) {
    row = st.values + c * st.sv + (int64_t)s * V * W;
    srow = st.seqs + c * st.ss + (int64_t)s * V;
    p = __ldg(st.pending + c * st.sp + s);
    cell0 = load_cell(row);
    seq0 = __ldg(srow);
    if (V > 1 && (!OPS || tail)) {
      cell1 = load_cell(row + W);
      seq1 = __ldg(srow + 1);
    }
  }
  // cell q of the register (zeros outside [0, V) or the store)
  auto cell = [&](int q, int& sq) {
    if (!ok || q < 0 || q >= V) {
      sq = 0;
      return make_int4(0, 0, 0, 0);
    }
    if (q <= 1) {
      sq = q == 0 ? seq0 : seq1;
      return q == 0 ? cell0 : cell1;
    }
    sq = __ldg(srow + q);
    return load_cell(row + q * W);
  };
  int sq;
  if constexpr (OPS) {
    int4 reply = make_int4(0, 0, 0, 0);
    sq = 0;
    if (in_range) reply = cell(p != 0 && tail ? p : 0, sq);
    *reinterpret_cast<int4*>(out_val + t * W) = reply;
    out_seq[t] = sq;
    out_code[t] = !in_range ? -1 : p == 0 ? 0 : tail ? 1 : 2;
  } else {
    *reinterpret_cast<int4*>(out_val + t * W) = cell0;
    out_seq[t] = seq0;
    *reinterpret_cast<int4*>(latest_val + t * W) = cell(p, sq);
    latest_seq[t] = sq;
    out_code[t] = p;
  }
}

// The append, one cooperative launch of at most as many blocks as are
// resident at once, with two grid barriers.  A flat batch has no row a
// block owns: any lane may write any register, and a write's base (its
// register's pending count) must be read before any count lands on it.
// So the launch first sorts the batch by target, t = chain * K + slot (the
// reference's int32 batch_rank key), into buckets of kBucketTargets
// consecutive registers; then each block owns whole buckets: it reads
// their bases, ranks their writes and lands them, and no other block
// touches those registers.
//
//   phase 0: block b takes lanes [b * chunk, (b + 1) * chunk): places each
//     one, writes its accept flag false, and counts each live lane into
//     its bucket in shared memory (the count returned is the lane's place
//     among the block's lanes of that bucket); then adds its counts to
//     the global ones, getting its offset within each bucket;
//   grid barrier;
//   phase 1: every block scans the bucket counts and scatters each of its
//     live lanes, as (lane, target), to its bucket's segment of the
//     entries;
//   grid barrier;
//   phase 2: block b takes buckets b, b + grid, ...: loads each entry's
//     base and the entries (into shared memory where they fit), then
//     ranks in rounds: round r's winner of a target is its least lane
//     above round r - 1's winner (a 64-bit shared-memory atomicMin of
//     lane and entry), so it is the target's r-th write in lane order; a
//     thread per target then lands it at base + 1 + r, in register order.
//     Rounds go on while base + 1 + r <= V - 1 for some target with writes
//     left: with every base >= 0 at most V - 1 rounds (three at V = 4),
//     however many writes a target has.  The pending words that moved
//     are stored once, and the bucket's count is reset for the next call.
//
// Engine mode (the Pallas contract) runs the same phases and lands each
// live write (active > 0, chain in [0, C), slot in [0, K)) at cell base +
// 1 + the caller's rank, accepted iff that is at most V - 1, with no
// rounds.  Ops mode is partitioned_write_batch: a global key is placed as
// in the read, a key outside the key space is never live (dropped, not
// clamped onto a victim), bool accept flags.  A target that is not the
// lane's own register (a map that points outside [0, K) but whose int32
// target names another register) ranks among that register's writes, as
// in the reference, and lands nowhere.
//
// What bounds it: latency more than bytes.  Each phase is a short chain
// of dependent memory round trips, the landings are scattered 16- and
// 4-byte writes of a cell and its seq, and the bytes it must move take a
// tenth of its time (chip_smoke.py prints both).  Slower in trials at
// phase 2's batch and not kept: a grid-wide atomicMin per round over
// [C * K] scratch, with the lanes in registers or in shared memory (a
// grid barrier per rank, and every round's posts, checks and resets
// scattered over the whole store); entries that carry the write's
// payload (their scatter costs more than gathering the payload of the
// writes that land).
// Scratch: the bucket counts ([kMaxBuckets] int32, zero between calls:
// phase 2 resets them) and the entries ([B] int2), the wrapper's,
// allocated once per device and grown for a larger batch; nothing is
// cleared per call.
constexpr int kCoopThreads = 512;
constexpr int kBucketTargets = 1024;  // targets a bucket spans
constexpr int kEntryCache = 2048;     // entries of a bucket ranked in smem
constexpr int kMaxBuckets = 8192;     // so C * K <= 8,388,608
constexpr int kBatchTooLarge = -1;    // no cooperative grid holds the lanes
constexpr int kStoreTooLarge = -2;    // more than kMaxBuckets buckets
constexpr int kNotOwn = 1 << 30;      // entry target flag: lands nowhere

struct BucketedWrite {
  BucketedStore st;
  const int* keys;     // engine: slots; ops: global keys
  const int* chains;   // engine only
  const int* wvals;    // [B, W]
  const int* wseqs;    // [B]
  const void* active;  // engine: int32; ops: bool bytes or int32 (words)
  int active_words;    // ops: active is int32 (else bytes)
  const int* rank;     // engine only
  KeyMap map;          // ops only
  int B, chunk;        // the batch; lanes per block in phase 0
  int n_buckets;       // ceil(C * K / kBucketTargets)
  int* counts;         // [n_buckets] scratch, zero between calls
  int2* entries;       // [B] scratch: (lane, target | kNotOwn)
  void* accepted;      // engine: int32; ops: bool bytes
};

// In-place exclusive prefix sum of n ints in shared memory by the block.
__device__ void block_exclusive_scan(int* data, int n) {
  __shared__ int s_warp[32];
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int sum = 0;
  for (int k = lo; k < hi; ++k) sum += data[k];
  int incl = sum;  // inclusive scan of the threads' sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? s_warp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += v;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int k = lo; k < hi; ++k) {
    const int v = data[k];
    data[k] = run;
    run += v;
  }
  __syncthreads();
}

template <bool OPS>
__global__ void __launch_bounds__(kCoopThreads)
    kv_bucketed_write_kernel(const BucketedWrite a) {
  extern __shared__ int smem[];
  cg::grid_group grid = cg::this_grid();
  const BucketedStore& st = a.st;
  const int* owner = nullptr;
  const int* base_of = nullptr;
  int map_ints = 0;
  if constexpr (OPS) {
    stage_map(a.map, owner, base_of);
    map_ints = a.map.n_buckets <= kMapStage ? 2 * a.map.n_buckets : 0;
  }
  const int nb = a.n_buckets;
  int* s_scan = smem + map_ints;  // [nb] counts, then bucket offsets
  int* s_off = s_scan + nb;       // [nb] the block's offset in a bucket
  int* s_work = s_off + nb;       // phases 0-1 and phase 2 in turn
  int* s_tgt = s_work;            // [chunk] a lane's target, -1 if not live
  int* s_pos = s_tgt + a.chunk;   // [chunk] its place in the block's bucket
  const int K = st.K, V = st.V, n_targets = st.C * st.K;
  const int64_t first = (int64_t)blockIdx.x * a.chunk;
  const int64_t left = a.B - first;  // the block's lanes: n
  const int n = left <= 0 ? 0 : left < a.chunk ? (int)left : a.chunk;

  // -- phase 0: place, count per bucket ------------------------------------
  for (int k = threadIdx.x; k < nb; k += blockDim.x) s_scan[k] = 0;
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int64_t i = first + c;
    int ch, sl, tgt = -1;
    if constexpr (OPS) {
      const bool in_range = place_key(__ldg(a.keys + i), a.map, owner,
                                      base_of, ch, sl);
      const bool act =
          a.active_words
              ? __ldg(static_cast<const int*>(a.active) + i) != 0
              : static_cast<const unsigned char*>(a.active)[i] != 0;
      const int t = (int)((unsigned)ch * (unsigned)K + (unsigned)sl);
      if (act && in_range && t >= 0 && t < n_targets) tgt = t;
    } else {
      ch = __ldg(a.chains + i);
      sl = __ldg(a.keys + i);
      if (__ldg(static_cast<const int*>(a.active) + i) > 0 &&
          in_store(st, ch, sl)) {
        tgt = ch * K + sl;
      }
    }
    store_flag<OPS>(a.accepted, i, false);
    if (tgt >= 0) {
      s_pos[c] = atomicAdd(s_scan + tgt / kBucketTargets, 1);
      if (!in_store(st, ch, sl)) tgt |= kNotOwn;
    }
    s_tgt[c] = tgt;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    if (s_scan[k] > 0) s_off[k] = atomicAdd(a.counts + k, s_scan[k]);
  }
  grid.sync();

  // -- phase 1: scatter the live lanes to their buckets ---------------------
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    s_scan[k] = __ldcg(a.counts + k);
  }
  __syncthreads();
  block_exclusive_scan(s_scan, nb);
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int tgt = s_tgt[c];
    if (tgt < 0) continue;
    const int64_t i = first + c;
    const int k = (tgt & ~kNotOwn) / kBucketTargets;
    a.entries[(int64_t)s_scan[k] + s_off[k] + s_pos[c]] =
        make_int2((int)(first + c), tgt);
  }
  grid.sync();

  // -- phase 2: each block its buckets: bases, rank, land --------------------
  int* s_base = s_work;                     // [kBucketTargets] pending before
  int* s_last = s_base + kBucketTargets;    // the last round's winner, lane
  int* s_acc = s_last + kBucketTargets;     // writes accepted
  unsigned long long* s_sel =               // the round's least (lane, entry)
      reinterpret_cast<unsigned long long*>(s_acc + kBucketTargets);
  int2* s_ent = reinterpret_cast<int2*>(s_sel + kBucketTargets);
  constexpr unsigned long long kNone = ~0ull;
  for (int k = blockIdx.x; k < nb; k += gridDim.x) {
    const int t0 = k * kBucketTargets;
    const int m = min(kBucketTargets, n_targets - t0);
    const int64_t e0 = s_scan[k];
    const int n_e = __ldcg(a.counts + k);
    const bool cached = n_e <= kEntryCache;
    for (int tl = threadIdx.x; tl < m; tl += blockDim.x) {
      s_last[tl] = -1;
      s_acc[tl] = 0;
      s_sel[tl] = kNone;
    }
    __syncthreads();
    // each entry's base (its register's pending word: duplicates store the
    // same value), and the entries in shared memory where they fit
    for (int e = threadIdx.x; e < n_e; e += blockDim.x) {
      const int2 key = __ldcg(a.entries + e0 + e);
      const int t = key.y & ~kNotOwn;
      s_base[t - t0] = st.pending[(t / K) * st.sp + t % K];
      if (cached) s_ent[e] = key;
    }
    __syncthreads();
    auto entry = [&](int e) {
      return cached ? s_ent[e] : __ldcg(a.entries + e0 + e);
    };
    // lands lane key.x's write on its own register at cell `slot`
    auto put = [&](int2 key, int slot) {
      const int c = key.y / K, s = key.y % K;
      if (slot >= 0) {
        *reinterpret_cast<int4*>(st.values + c * st.sv +
                                 ((int64_t)s * V + slot) * W) =
            __ldg(reinterpret_cast<const int4*>(a.wvals) + key.x);
        st.seqs[c * st.ss + (int64_t)s * V + slot] = __ldg(a.wseqs + key.x);
      }
      store_flag<OPS>(a.accepted, key.x, true);
    };
    if constexpr (!OPS) {
      for (int e = threadIdx.x; e < n_e; e += blockDim.x) {
        const int2 key = entry(e);
        const int tl = key.y - t0;
        const int64_t slot = (int64_t)s_base[tl] + 1 + __ldg(a.rank + key.x);
        if (slot <= V - 1) {
          put(key, (int)slot);
          atomicAdd(s_acc + tl, 1);
        }
      }
    } else {
      // round r: each target's least lane above round r - 1's winner,
      // packed with its entry; a thread per target then lands the winner
      // (in register order) and keeps its lane
      for (int r = 0;; ++r) {
        bool any = false;
        for (int e = threadIdx.x; e < n_e; e += blockDim.x) {
          const int2 key = entry(e);
          const int tl = (key.y & ~kNotOwn) - t0;
          if (key.x > s_last[tl] && s_base[tl] <= V - 2 - r) {
            atomicMin(s_sel + tl, (unsigned long long)key.x << 32 | e);
            any = true;
          }
        }
        if (!__syncthreads_or(any)) break;
        for (int tl = threadIdx.x; tl < m; tl += blockDim.x) {
          const unsigned long long w = s_sel[tl];
          if (w == kNone) continue;
          s_sel[tl] = kNone;
          const int e = (int)(w & 0xffffffffu);
          const int2 key = entry(e);
          s_last[tl] = key.x;
          if (!(key.y & kNotOwn)) {  // rank r, on its own register
            put(key, s_base[tl] + 1 + r);
            ++s_acc[tl];
          }
        }
        __syncthreads();
      }
    }
    __syncthreads();
    for (int tl = threadIdx.x; tl < m; tl += blockDim.x) {
      if (s_acc[tl] > 0) {
        const int t = t0 + tl;
        st.pending[(t / K) * st.sp + t % K] = s_base[tl] + s_acc[tl];
      }
    }
    if (threadIdx.x == 0) a.counts[k] = 0;  // no block reads it again
    __syncthreads();
  }
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


// The map's staging bytes, on the host.
inline size_t map_smem_host(const KeyMap& m) {
  return m.n_buckets <= kMapStage ? 2 * sizeof(int) * m.n_buckets : 0;
}

template <bool OPS>
int read_bucketed(const BucketedStore& st, const int* keys,
                  const int* chains, const KeyMap& map, int tail, int B,
                  int* out_val, int* out_seq, int* latest_val,
                  int* latest_seq, int* out_code, int* chains_out,
                  int* slots_out, void* stream) {
  if (B > 0) {
    kv_bucketed_read_kernel<OPS><<<blocks_for(B), kThreads,
                                   OPS ? map_smem_host(map) : 0,
                                   (cudaStream_t)stream>>>(
        st, keys, chains, map, tail, B, out_val, out_seq, latest_val,
        latest_seq, out_code, chains_out, slots_out);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory of an append block holding `chunk` lanes in phase
// 0 (its phase 2 needs the four target arrays and the entry cache).
inline size_t write_smem(size_t map_bytes, int n_buckets, int64_t chunk) {
  const size_t rank_bytes = (3 * sizeof(int) + sizeof(long long)) *
                               kBucketTargets + sizeof(int2) * kEntryCache;
  return map_bytes + 2 * sizeof(int) * n_buckets +
         std::max<size_t>(2 * sizeof(int) * chunk, rank_bytes);
}

// Sets the append's grid for a.B lanes: as many blocks per SM as are
// resident at once with their shared memory (a cooperative launch may
// have no more), but no more than a block per bucket or per kCoopThreads
// lanes, whichever is more.
// The one place that decides what an append holds: returns 0,
// kBatchTooLarge where no grid holds a.B, or a CUDA error.
template <bool OPS>
int write_grid(BucketedWrite& a, size_t map_bytes, int& blocks,
               size_t& smem) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kv_bucketed_write_kernel<OPS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSharedPerBlock - 1024);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t min_blocks = std::max<int64_t>(
      a.n_buckets, (a.B + kCoopThreads - 1) / kCoopThreads);
  for (int per_sm = 2048 / kCoopThreads; per_sm >= 1; --per_sm) {
    const int64_t b = std::min<int64_t>((int64_t)sms * per_sm, min_blocks);
    const int64_t chunk = (a.B + b - 1) / b;
    const size_t bytes = write_smem(map_bytes, a.n_buckets, chunk);
    int resident = 0;
    if (bytes > (size_t)kSharedPerBlock - 1024 ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &resident, kv_bucketed_write_kernel<OPS>, kCoopThreads,
            bytes) != cudaSuccess ||
        b > (int64_t)sms * resident) {
      continue;
    }
    a.chunk = (int)chunk;
    blocks = (int)b;
    smem = bytes;
    return 0;
  }
  return kBatchTooLarge;
}

template <bool OPS>
int write_bucketed(BucketedWrite a, void* stream) {
  if (a.B <= 0) return (int)cudaGetLastError();
  a.n_buckets =
      (int)(((int64_t)a.st.C * a.st.K + kBucketTargets - 1) / kBucketTargets);
  if (a.n_buckets > kMaxBuckets) return kStoreTooLarge;
  int blocks = 0;
  size_t smem = 0;
  const int rc = write_grid<OPS>(a, OPS ? map_smem_host(a.map) : 0, blocks,
                                 smem);
  if (rc != 0) return rc;
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)kv_bucketed_write_kernel<OPS>, dim3((unsigned)blocks),
      dim3(kCoopThreads), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
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
// Strides sv, ss, sp: the chain strides of values, seqs and pending, in
// int32 words.
extern "C" int kv_bucketed_read_launch(
    const int* values, const int* seqs, const int* pending, const int* slots,
    const int* chains, int C, int K, int V, int B, long long sv, long long ss,
    long long sp, int* clean_val, int* clean_seq, int* latest_val,
    int* latest_seq, int* pend_out, void* stream) {
  const BucketedStore st{const_cast<int*>(values), const_cast<int*>(seqs),
                         const_cast<int*>(pending), C, K, V, sv, ss, sp};
  return read_bucketed<false>(st, slots, chains, KeyMap{}, 0, B, clean_val,
                              clean_seq, latest_val, latest_seq, pend_out,
                              nullptr, nullptr, stream);
}

// The ops mode of the read: global keys and the map in; the reply, the
// decision and each key's chain and slot out.
extern "C" int kv_bucketed_resolve_launch(
    const int* values, const int* seqs, const int* pending, const int* gkeys,
    const int* owner, const int* base, int n_buckets, int n_chains,
    int buckets_per_chain, int bucket_slots, int num_global_keys, int tail,
    int C, int K, int V, int B, long long sv, long long ss, long long sp,
    int* reply_val, int* reply_seq, int* decision, int* chains_out,
    int* slots_out, void* stream) {
  const BucketedStore st{const_cast<int*>(values), const_cast<int*>(seqs),
                         const_cast<int*>(pending), C, K, V, sv, ss, sp};
  const KeyMap map{owner, base, n_buckets, n_chains, buckets_per_chain,
                   bucket_slots, num_global_keys};
  return read_bucketed<true>(st, gkeys, nullptr, map, tail, B, reply_val,
                             reply_seq, nullptr, nullptr, decision,
                             chains_out, slots_out, stream);
}

// The engine mode of the append: int32 active, the caller's rank, int32
// accept flags; one cooperative launch.  counts [kMaxBuckets] int32 (zero
// between calls) and entries ([B, 2] int32) are the wrapper's scratch.
extern "C" int kv_bucketed_write_launch(
    int* values, int* seqs, int* pending, const int* slots,
    const int* chains, const int* wvals, const int* wseqs, const int* active,
    const int* rank, int C, int K, int V, int B, long long sv, long long ss,
    long long sp, int* counts, int* entries, int* accepted, void* stream) {
  BucketedWrite a{};
  a.st = BucketedStore{values, seqs, pending, C, K, V, sv, ss, sp};
  a.keys = slots;
  a.chains = chains;
  a.wvals = wvals;
  a.wseqs = wseqs;
  a.active = active;
  a.rank = rank;
  a.B = B;
  a.counts = counts;
  a.entries = reinterpret_cast<int2*>(entries);
  a.accepted = accepted;
  return write_bucketed<false>(a, stream);
}

// The ops mode of the append: global keys and the map in, active as bytes
// (active_words = 0) or int32, the rank taken inside, bool accept flags;
// scratch as for the engine mode.
extern "C" int kv_bucketed_append_launch(
    int* values, int* seqs, int* pending, const int* gkeys, const int* owner,
    const int* base, int n_buckets, int n_chains, int buckets_per_chain,
    int bucket_slots, int num_global_keys, const int* wvals, const int* wseqs,
    const void* active, int active_words, int C, int K, int V, int B,
    long long sv, long long ss, long long sp, int* counts, int* entries,
    unsigned char* accepted, void* stream) {
  BucketedWrite a{};
  a.st = BucketedStore{values, seqs, pending, C, K, V, sv, ss, sp};
  a.keys = gkeys;
  a.wvals = wvals;
  a.wseqs = wseqs;
  a.active = active;
  a.active_words = active_words;
  a.map = KeyMap{owner, base, n_buckets, n_chains, buckets_per_chain,
                 bucket_slots, num_global_keys};
  a.B = B;
  a.counts = counts;
  a.entries = reinterpret_cast<int2*>(entries);
  a.accepted = accepted;
  return write_bucketed<true>(a, stream);
}

// The bucket counts the append's scratch holds (its wrapper sizes them).
extern "C" int kv_bucketed_max_buckets() { return kMaxBuckets; }
