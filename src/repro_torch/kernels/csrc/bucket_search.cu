// Bucket-constrained top-K neighbour scans of the distributed LSH index,
// hand-written for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of the reference package:
//   probe_table_kernel + bucket_scan_kernel + bucket_search_merge_kernel
//       <- src/repro/kernels/bucket_search.py bucket_search_pallas
//          (_bucket_search_kernel, _merge_topk_tile): the full scan over
//          every stored row;
//   bucket_gather_kernel
//       <- bucket_search.py bucket_gather_pallas (_bucket_gather_kernel):
//          the CSR gather over a bucket-sorted region.
//
// What bounds them on an H100.  A (row, point) pair can be a hit only if
// the point's (table, bucket) is one the row probes, and at the index's
// shapes a few ten thousand of the 10^9 (row, slot) pairs are such
// matched pairs.  The TPU kernel computes every pair's distance on the
// MXU and masks after; in IEEE float32 outside the tensor cores that
// is ~10^11 FMAs for nothing.  Here the work is what the data needs: read
// each stored slot's liveness (4 bytes), each live slot's table and
// bucket (12 bytes), and only for matched pairs the point row and a
// d-long dot.  The full scan is then a memory stream over the per-slot
// columns; the gather reads only its spans' rows.
//
// Design:
//  * match first: per (shard, tile of TILE_R compacted live rows) a
//    probe table -- an open-addressing hash of the rows' active probes,
//    key (table, hi, lo) -> a 64-bit mask of the tile's rows that probe
//    it -- is built by probe_table_kernel in global memory.  Inactive
//    probes are left out, and a row probing one bucket twice sets one bit
//    once, so a point counts once per row, as the reference's OR over
//    probes has it.  Keys are compared for equality only (no order), so
//    the uint32/int32 reading of bucket words cannot matter.  Each scan
//    block copies its table into shared memory when it fits (the wrapper's
//    plan decides) and otherwise probes it in global memory;
//  * filter: a scan block walks a split of one shard's slots, CH a
//    step, thread t taking slots t + k BLOCK, so each load of a warp --
//    liveness, then table and bucket words of the live slots only -- is
//    one coalesced run at any alignment (a tail slice starts at any row);
//    the next step's liveness is loaded before this step's is used.
//    (Four consecutive slots a thread, liveness as one 16-byte vector,
//    ran slower on the H100: each column load of a warp then spans 16 to
//    32 sectors.)  A matched slot goes to a shared queue as (slot, mask);
//  * pairs: when the queue may fill (and at the end) a block-wide prefix
//    sum of the masks' popcounts numbers the matched pairs, and every
//    thread takes one pair a round, so a hot bucket spreads over the block
//    instead of one thread looping over its rows;
//  * d^2 of a pair is pair_d2(qsq, psq, pair_dot(q, p)) in both kernels:
//    one ascending __fmaf_rn chain over d (16-byte loads where d % 4 == 0
//    and the rows are aligned, the same arithmetic either way), then
//    __fadd_rn/__fmul_rn/__fsub_rn and the clamp.  The CSR gather is
//    bitwise equal to the full scan by construction;
//  * top-K: hits below their row's current K-th key go to a shared hit
//    queue; after each round a barrier, then each row's owner thread
//    inserts its hits into the row's ascending list of exact 64-bit
//    (bits(d^2), gid) keys.  Keys of a row form a multiset and counts are
//    sums, so the order atomics give does not change the output;
//  * the point axis is split over blocks (the wrapper's plan sizes the
//    splits from N, so a handful of live row tiles still fill the 132
//    SMs); bucket_search_merge_kernel merges each row's per-split lists
//    with a block over the splits and scatters the rows back to their
//    places;
//  * gather: a block takes TILE_R expanded (row, probe) rows, numbers the
//    points of their spans [start, end) by a prefix sum, and runs the same
//    pair rounds: lanes over points, long spans over the whole block.
//    Dead probes (start == end, sorted last) cost one write of the empty
//    answer;
//  * one launch covers all S shards, each shard's store reached through a
//    shard stride, so a slice of the store needs no copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int BLOCK = 512;           // threads of a scan or gather block
constexpr int NW = BLOCK / 32;
constexpr int TILE_R = 64;           // rows of a tile: one bit of a mask
constexpr int SLOTS = 4;             // slots a thread filters a step
constexpr int CH = SLOTS * BLOCK;    // slots a filter step covers
constexpr int MQ = CH + BLOCK;       // matched-slot queue entries
constexpr int HQ = BLOCK;            // hit-queue entries: one a thread
constexpr int NMISC = 8;             // shared counters
constexpr int MERGE_T = 128;         // threads of a merge block
constexpr int MAX_SPLITS = 4 * MERGE_T;  // splits a merge thread offers 4
// (F32_MAX, IMAX): the empty top-K slot, larger than every real key
constexpr u64 SENTINEL = (static_cast<u64>(0x7f7fffffu) << 32) | 0x7fffffffu;

__device__ __forceinline__ u64 lex_key(float d2, int gid) {
  return (static_cast<u64>(__float_as_uint(d2)) << 32) |
         static_cast<unsigned int>(gid);
}

// |q|^2 + |p|^2 - 2 q.p, clamped at +0 (the shared rounding path).
__device__ __forceinline__ float pair_d2(float qsq, float psq, float dot) {
  const float d2 = __fsub_rn(__fadd_rn(qsq, psq), __fmul_rn(2.0f, dot));
  return d2 > 0.0f ? d2 : 0.0f;
}

// q . p for one query row and one point row (global memory, d floats):
// one ascending chain acc = fma(q[k], p[k], acc), k = 0 .. d-1.  With vec
// (d % 4 == 0, both rows 16-byte aligned) it loads 16 bytes at a time;
// the arithmetic is the same either way.  Both kernels call it, which is
// what keeps the gather bitwise equal to the full scan.
__device__ __forceinline__ float pair_dot(const float* __restrict__ q,
                                          const float* __restrict__ p, int d,
                                          bool vec) {
  float acc = 0.0f;
  if (vec) {
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll 4
    for (int k = 0; k < d / 4; ++k) {
      const float4 a = __ldg(q4 + k);
      const float4 b = __ldg(p4 + k);
      acc = __fmaf_rn(a.x, b.x, acc);
      acc = __fmaf_rn(a.y, b.y, acc);
      acc = __fmaf_rn(a.z, b.z, acc);
      acc = __fmaf_rn(a.w, b.w, acc);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < d; ++k)
      acc = __fmaf_rn(__ldg(q + k), __ldg(p + k), acc);
  }
  return acc;
}

// Hash of a probe key (table, hi, lo); the table's slot is its low bits.
__device__ __forceinline__ unsigned int key_hash(int tab, unsigned int hi,
                                                 unsigned int lo) {
  unsigned int h = hi * 0x9E3779B1u;
  h ^= (lo + 0x7F4A7C15u) * 0x85EBCA77u;
  h ^= static_cast<unsigned int>(tab) * 0xC2B2AE3Du;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return h;
}

// One (shard, row tile) probe table, H slots (a power of two, at most half
// full); a slot is empty while its mask is 0.  The pointers may address
// shared or global memory.
struct ProbeTable {
  u64* mask;
  int* tab;
  unsigned int* hi;
  unsigned int* lo;
  int H;

  __device__ __forceinline__ u64 find(int t, unsigned int h,
                                      unsigned int l) const {
    unsigned int i = key_hash(t, h, l) & (H - 1);
    for (;;) {
      const u64 m = mask[i];
      if (m == 0 || (hi[i] == h && lo[i] == l && tab[i] == t)) return m;
      i = (i + 1) & (H - 1);
    }
  }
};

// The probe tables of all (shard, tile) pairs, carved from one workspace
// of table_ws_bytes(n_tables, H): masks, claims, tables, hi, lo words.
__device__ __host__ __forceinline__ size_t table_ws_bytes(long long n,
                                                          int H) {
  return static_cast<size_t>(n) * H * (8 + 4 * 4);
}

struct TableWs {
  u64* mask;
  int* own;
  int* tab;
  unsigned int* hi;
  unsigned int* lo;

  __device__ __host__ TableWs(void* ws, long long n, int H) {
    const long long slots = n * H;
    mask = static_cast<u64*>(ws);
    own = reinterpret_cast<int*>(mask + slots);
    tab = own + slots;
    hi = reinterpret_cast<unsigned int*>(tab + slots);
    lo = hi + slots;
  }
};

// Exclusive prefix sums of a[0, n) in place (shared memory, every thread
// of the block calls it); returns the total.  wsum holds NW partials.
template <typename T>
__device__ T block_exclusive_scan(T* a, int n, T* wsum) {
  const int per = (n + BLOCK - 1) / BLOCK;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n, lo + per);
  T s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  T x = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  if (w == 0) {
    T v = lane < NW ? wsum[lane] : T(0);
#pragma unroll
    for (int o = 1; o < NW; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < NW) wsum[lane] = v;
  }
  __syncthreads();
  T run = x - s + (w > 0 ? wsum[w - 1] : T(0));
  for (int i = lo; i < hi; ++i) {
    const T v = a[i];
    a[i] = run;
    run += v;
  }
  const T total = wsum[NW - 1];
  __syncthreads();
  return total;
}

// The entry i of an exclusive prefix array pref[0, n) whose segment holds
// p (the largest i with pref[i] <= p; pref[0] == 0 <= p).
template <typename T>
__device__ __forceinline__ int find_segment(const T* pref, int n, T p) {
  int a = 0, b = n;
  while (b - a > 1) {
    const int m = (a + b) >> 1;
    if (pref[m] <= p) a = m; else b = m;
  }
  return a;
}

// Position of the j-th (from 0) set bit of m.
__device__ __forceinline__ int nth_bit(u64 m, int j) {
  int r = 0;
  int c = __popc(static_cast<unsigned int>(m));
  unsigned int x = static_cast<unsigned int>(m);
  if (j >= c) { j -= c; x = static_cast<unsigned int>(m >> 32); r = 32; }
  c = __popc(x & 0xffffu);
  if (j >= c) { j -= c; x >>= 16; r += 16; }
  c = __popc(x & 0xffu);
  if (j >= c) { j -= c; x >>= 8; r += 8; }
  c = __popc(x & 0xfu);
  if (j >= c) { j -= c; x >>= 4; r += 4; }
  c = __popc(x & 0x3u);
  if (j >= c) { j -= c; x >>= 2; r += 2; }
  if (j >= static_cast<int>(x & 1u)) r += 1;
  return r;
}

// Insert key into one row's ascending list (K entries at stride STRIDE)
// if it is below the K-th.
template <int STRIDE>
__device__ __forceinline__ void topk_insert(u64* list, int K, u64 key) {
  if (key >= list[(K - 1) * STRIDE]) return;
  int pos = K - 1;
  while (pos > 0) {
    const u64 prev = list[(pos - 1) * STRIDE];
    if (prev <= key) break;
    list[pos * STRIDE] = prev;
    --pos;
  }
  list[pos * STRIDE] = key;
}

// What the pair rounds read: the tile's rows (their query offsets, norms,
// hit counts and top-K lists in shared memory), one shard's store columns
// and the shared hit queue.
struct PairCtx {
  const float* q;
  const int* row_off;
  const float* row_qsq;
  int* row_cnt;
  u64* list;
  const float* p;
  const float* psq;
  const int* gid;
  const int* ok;
  u64* hq_key;
  int* hq_row;
  int* hq_n;
  int d;
  int K;
  bool vec;
  float cr2;
};

// Every thread takes pair base + tid of the P pairs, locate(pi, r, c) names
// its tile row r and store slot c.  A live pair within cr2 counts for its
// row and, below the row's K-th key, goes to the hit queue; after each
// round the rows' owners insert the queued hits.
template <typename T, typename Locate>
__device__ void pair_rounds(const PairCtx& x, T P, Locate locate) {
  const int tid = threadIdx.x;
  for (T base = 0; base < P; base += BLOCK) {
    bool pushed = false;
    if (base + tid < P) {
      int r;
      long long c;
      locate(base + tid, r, c);
      if (x.ok[c] > 0) {
        const float dot = pair_dot(
            x.q + static_cast<long long>(x.row_off[r]) * x.d,
            x.p + c * x.d, x.d, x.vec);
        const float d2 = pair_d2(x.row_qsq[r], x.psq[c], dot);
        if (d2 <= x.cr2) {
          atomicAdd(&x.row_cnt[r], 1);
          const u64 key = lex_key(d2, x.gid[c]);
          if (key < x.list[(x.K - 1) * TILE_R + r]) {
            const int i = atomicAdd(x.hq_n, 1);
            x.hq_key[i] = key;
            x.hq_row[i] = r;
            pushed = true;
          }
        }
      }
    }
    const int nh = __syncthreads_count(pushed);
    if (nh > 0) {
      if (tid < TILE_R)
        for (int i = 0; i < nh; ++i)
          if (x.hq_row[i] == tid)
            topk_insert<TILE_R>(x.list + tid, x.K, x.hq_key[i]);
      __syncthreads();
      if (tid == 0) *x.hq_n = 0;
      __syncthreads();
    }
  }
}

// Shared memory of a scan block (bucket_search_smem_bytes mirrors it).
__host__ __device__ __forceinline__ size_t scan_smem(int K, int H,
                                                     bool table_in_smem) {
  return 8 * (static_cast<size_t>(K) * TILE_R + MQ + HQ) +
         (table_in_smem ? static_cast<size_t>(20) * H : 0) +
         4 * static_cast<size_t>(2 * MQ + HQ + 3 * TILE_R + NW + NMISC);
}

__host__ __device__ __forceinline__ size_t gather_smem(int K) {
  return 8 * (static_cast<size_t>(K) * TILE_R + HQ + TILE_R + NW) +
         4 * static_cast<size_t>(4 * TILE_R + HQ + NMISC);
}

// Full scan, pass 0: per shard (grid S), list the rows that probe at
// least one bucket first, ascending, into row_idx, the others after
// them, and count them in nlive (a row that probes nothing has no hit).
__global__ void __launch_bounds__(BLOCK) live_rows_kernel(
    const int* __restrict__ probe, int R, int L, int* __restrict__ row_idx,
    int* __restrict__ nlive) {
  __shared__ int before[BLOCK];
  __shared__ int wsum[NW];
  const int s = blockIdx.x, tid = threadIdx.x;
  int* idx = row_idx + static_cast<long long>(s) * R;
  int n_live = 0, n_dead = 0;
  for (int r0 = 0; r0 < R; r0 += BLOCK) {
    const int r = r0 + tid;
    int on = 0;
    if (r < R) {
      const int* pr = probe + (static_cast<long long>(s) * R + r) * L;
      for (int l = 0; l < L && !on; ++l) on = pr[l] > 0;
    }
    before[tid] = on;
    __syncthreads();
    const int live = block_exclusive_scan(before, BLOCK, wsum);
    if (r < R) {
      if (on) idx[n_live + before[tid]] = r;
      else idx[R - 1 - (n_dead + tid - before[tid])] = r;
    }
    n_live += live;
    n_dead += min(BLOCK, R - r0) - live;
    __syncthreads();
  }
  if (tid == 0) nlive[s] = n_live;
}

// Full scan, pass 1: the probe table of (row tile, shard) -- grid (tiles,
// S) -- from the tile's compacted live rows and their active probes.
__global__ void __launch_bounds__(BLOCK) probe_table_kernel(
    const int* __restrict__ qb, const int* __restrict__ probe,
    const int* __restrict__ qtab, const int* __restrict__ row_idx,
    const int* __restrict__ nlive, int R, int L, int H, void* ws) {
  const int t = blockIdx.x, s = blockIdx.y, tiles = gridDim.x;
  const int r0 = t * TILE_R;
  const int live = nlive[s];
  if (r0 >= live) return;  // uniform over the block
  const int rows = min(TILE_R, live - r0);
  const TableWs w(ws, static_cast<long long>(tiles) * gridDim.y, H);
  const long long base = (static_cast<long long>(s) * tiles + t) * H;
  for (int h = threadIdx.x; h < H; h += BLOCK) {
    w.own[base + h] = -1;
    w.mask[base + h] = 0;
  }
  __syncthreads();
  const int* ridx = row_idx + static_cast<long long>(s) * R + r0;
  auto key_of = [&](int e, int& kt, unsigned int& kh, unsigned int& kl) {
    const long long qoff = static_cast<long long>(s) * R + ridx[e / L];
    const int l = e % L;
    kt = qtab[qoff];
    kh = static_cast<unsigned int>(qb[qoff * 2 * L + 2 * l]);
    kl = static_cast<unsigned int>(qb[qoff * 2 * L + 2 * l + 1]);
    return probe[qoff * L + l] > 0;
  };
  for (int e = threadIdx.x; e < rows * L; e += BLOCK) {
    int kt;
    unsigned int kh, kl;
    if (!key_of(e, kt, kh, kl)) continue;
    const u64 bit = 1ull << (e / L);
    unsigned int h = key_hash(kt, kh, kl) & (H - 1);
    for (;;) {
      const long long i = base + h;
      const int old = atomicCAS(&w.own[i], -1, e);
      bool same = old == -1;
      if (same) {
        w.tab[i] = kt;
        w.hi[i] = kh;
        w.lo[i] = kl;
      } else {  // compare with the claimer's key, read from the inputs
        int ot;
        unsigned int oh, ol;
        key_of(old, ot, oh, ol);
        same = ot == kt && oh == kh && ol == kl;
      }
      if (same) {
        atomicOr(&w.mask[i], bit);
        break;
      }
      h = (h + 1) & (H - 1);
    }
  }
}

// Full scan, pass 2: block (split, row tile, shard) filters its split of
// the shard's slots through the tile's probe table, computes the matched
// pairs and writes each row's partial top-K list and count.
__global__ void __launch_bounds__(BLOCK) bucket_scan_kernel(
    const float* __restrict__ q, const float* __restrict__ qsq,
    const int* __restrict__ row_idx, const int* __restrict__ nlive, int R,
    int d, int K, void* ws, int H, int table_in_smem,
    const float* __restrict__ p, const float* __restrict__ psq,
    const int* __restrict__ pb, const int* __restrict__ gid,
    const int* __restrict__ pvalid, const int* __restrict__ ptab,
    long long sp, long long sn, long long sb, int N, int split_len,
    int vec, float cr2, u64* __restrict__ part_keys,
    int* __restrict__ part_cnt) {
  const int split = blockIdx.x, t = blockIdx.y, s = blockIdx.z;
  const int n_splits = gridDim.x, tiles = gridDim.y;
  const int r0 = t * TILE_R;
  const int live = nlive[s];
  if (r0 >= live) return;  // uniform over the block
  const int rows = min(TILE_R, live - r0);
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  u64* list = reinterpret_cast<u64*>(smem);
  u64* mq_mask = list + K * TILE_R;
  u64* hq_key = mq_mask + MQ;
  u64* t_mask = hq_key + HQ;
  int* ibase = reinterpret_cast<int*>(t_mask + (table_in_smem ? H : 0));
  int* t_tab = ibase;
  int* mq_slot = t_tab + (table_in_smem ? 3 * H : 0);
  int* mq_pref = mq_slot + MQ;
  int* hq_row = mq_pref + MQ;
  int* row_off = hq_row + HQ;
  float* row_qsq = reinterpret_cast<float*>(row_off + TILE_R);
  int* row_cnt = reinterpret_cast<int*>(row_qsq + TILE_R);
  int* wsum = row_cnt + TILE_R;
  int* misc = wsum + NW;  // [0] matched slots queued, [1] hits queued

  const TableWs w(ws, static_cast<long long>(tiles) * gridDim.z, H);
  const long long tb = (static_cast<long long>(s) * tiles + t) * H;
  ProbeTable table{w.mask + tb, w.tab + tb, w.hi + tb, w.lo + tb, H};
  if (table_in_smem) {
    ProbeTable sh{t_mask, t_tab, reinterpret_cast<unsigned int*>(t_tab + H),
                  reinterpret_cast<unsigned int*>(t_tab + 2 * H), H};
    for (int h = tid; h < H; h += BLOCK) {
      sh.mask[h] = table.mask[h];
      sh.tab[h] = table.tab[h];
      sh.hi[h] = table.hi[h];
      sh.lo[h] = table.lo[h];
    }
    table = sh;
  }
  for (int i = tid; i < K * TILE_R; i += BLOCK) list[i] = SENTINEL;
  if (tid < TILE_R) {
    const long long at = static_cast<long long>(s) * R + r0 + tid;
    const int r = tid < rows ? row_idx[at] : 0;
    row_off[tid] = s * R + r;
    row_qsq[tid] = tid < rows ? qsq[static_cast<long long>(s) * R + r] : 0.0f;
    row_cnt[tid] = 0;
  }
  if (tid < NMISC) misc[tid] = 0;
  __syncthreads();

  const float* p_s = p + s * sp;
  const int* ok_s = pvalid + s * sn;
  const int* tab_s = ptab + s * sn;
  const int* pb_s = pb + s * sb;
  const PairCtx ctx{q, row_off, row_qsq, row_cnt, list, p_s, psq + s * sn,
                    gid + s * sn, ok_s, hq_key, hq_row, misc + 1, d, K,
                    vec != 0, cr2};

  // pair phase over the queued matched slots; leaves the queue empty
  auto flush = [&]() {
    const int n = misc[0];
    for (int i = tid; i < n; i += BLOCK) mq_pref[i] = __popcll(mq_mask[i]);
    __syncthreads();
    const int P = block_exclusive_scan(mq_pref, n, wsum);
    pair_rounds(ctx, P, [&](int pi, int& r, long long& c) {
      const int i = find_segment(mq_pref, n, pi);
      r = nth_bit(mq_mask[i], pi - mq_pref[i]);
      c = mq_slot[i];
    });
    __syncthreads();
    if (tid == 0) misc[0] = 0;
    __syncthreads();
  };

  // this split's slots [b0, b1), CH a step: thread tid takes slots
  // base + tid + k BLOCK, so every load of a warp is one coalesced run
  const int b0 = min(N, split * split_len);
  const int b1 = min(N, b0 + split_len);
  auto load_ok = [&](int base, int (&ok)[SLOTS]) {
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int c = base + tid + k * BLOCK;
      ok[k] = c < b1 ? __ldg(ok_s + c) : 0;
    }
  };
  int queued_bound = 0;  // >= the matched slots queued; uniform
  int next[SLOTS];
  load_ok(b0, next);
  for (int base = b0; base < b1; base += CH) {
    int ok[SLOTS], tb[SLOTS];
    unsigned int hi[SLOTS], lo[SLOTS];
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) ok[k] = next[k];
    load_ok(base + CH, next);
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      if (ok[k] > 0) {
        const long long c = base + tid + k * BLOCK;
        const int2 b = __ldg(reinterpret_cast<const int2*>(pb_s + 2 * c));
        tb[k] = __ldg(tab_s + c);
        hi[k] = static_cast<unsigned int>(b.x);
        lo[k] = static_cast<unsigned int>(b.y);
      }
    }
    int pushed = 0;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      if (ok[k] > 0) {
        const u64 m = table.find(tb[k], hi[k], lo[k]);
        if (m != 0) {
          const int i = atomicAdd(&misc[0], 1);
          mq_slot[i] = base + tid + k * BLOCK;
          mq_mask[i] = m;
          ++pushed;
        }
      }
    }
    queued_bound += SLOTS * __syncthreads_count(pushed > 0);
    if (queued_bound > MQ - CH) {
      flush();
      queued_bound = 0;
    }
  }
  if (queued_bound > 0) flush();

  __syncthreads();
  if (tid < rows) {
    const long long slot =
        (static_cast<long long>(s) * R + r0 + tid) * n_splits + split;
    part_cnt[slot] = row_cnt[tid];
    for (int k = 0; k < K; ++k)
      part_keys[slot * K + k] = list[k * TILE_R + tid];
  }
}

// Full scan, pass 3: block (row position, shard) merges a compacted live
// row's per-split lists and counts and writes them to the row's place in
// the outputs; the other rows get the empty answer (F32_MAX, IMAX; 0).
// Round i offers the i-th key of every split whose keys so far all went
// below the row's K-th (each list is ascending, so the rest cannot), and
// thread 0 inserts the offered keys; almost every split's list is empty,
// so a row takes one round.
__global__ void __launch_bounds__(MERGE_T) bucket_search_merge_kernel(
    const int* __restrict__ row_idx, const int* __restrict__ nlive, int R,
    int K, int n_splits, const u64* __restrict__ part_keys,
    const int* __restrict__ part_cnt, float* __restrict__ topd,
    int* __restrict__ topg, int* __restrict__ cnt) {
  const int pos = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* list = reinterpret_cast<u64*>(smem);
  u64* offered = list + K;
  // misc[0]: keys offered this round, misc[1]: the row's hit count
  int* misc = reinterpret_cast<int*>(offered + MAX_SPLITS);
  for (int k = tid; k < K; k += MERGE_T) list[k] = SENTINEL;
  if (tid < 2) misc[tid] = 0;
  __syncthreads();
  if (pos < nlive[s]) {  // uniform over the block
    const long long slot0 = (static_cast<long long>(s) * R + pos) * n_splits;
    int c = 0;
    unsigned int alive = 0;  // bit m: split tid + m * MERGE_T still offers
    for (int m = 0; tid + m * MERGE_T < n_splits; ++m) {
      c += part_cnt[slot0 + tid + m * MERGE_T];
      alive |= 1u << m;
    }
    atomicAdd(&misc[1], c);
    for (int i = 0; i < K; ++i) {
      for (int m = 0; alive >> m; ++m) {
        if (!(alive >> m & 1u)) continue;
        const u64 key = part_keys[(slot0 + tid + m * MERGE_T) * K + i];
        if (key < list[K - 1]) {
          offered[atomicAdd(&misc[0], 1)] = key;
        } else {
          alive &= ~(1u << m);
        }
      }
      __syncthreads();
      const int n = misc[0];
      if (n == 0) break;  // uniform: read between two barriers
      __syncthreads();
      if (tid == 0) {
        for (int e = 0; e < n; ++e) topk_insert<1>(list, K, offered[e]);
        misc[0] = 0;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  const long long shard_row0 = static_cast<long long>(s) * R;
  const long long out = shard_row0 + row_idx[shard_row0 + pos];
  if (tid == 0) cnt[out] = misc[1];
  for (int k = tid; k < K; k += MERGE_T) {
    const u64 key = list[k];
    topd[out * K + k] = __uint_as_float(static_cast<unsigned int>(key >> 32));
    topg[out * K + k] = static_cast<int>(key & 0xffffffffu);
  }
}

// CSR gather: block (row tile, shard) numbers the points of its TILE_R
// expanded rows' spans [start, end) and runs the pair rounds over them.
__global__ void __launch_bounds__(BLOCK) bucket_gather_kernel(
    const float* __restrict__ q, const float* __restrict__ qsq,
    const int* __restrict__ start, const int* __restrict__ end, int E, int d,
    int K, const float* __restrict__ p, const float* __restrict__ psq,
    const int* __restrict__ gid, const int* __restrict__ pvalid,
    long long sp, long long sn, int vec, float cr2,
    float* __restrict__ topd, int* __restrict__ topg,
    int* __restrict__ cnt) {
  const int s = blockIdx.y;
  const int e0 = blockIdx.x * TILE_R;
  const int rows = min(TILE_R, E - e0);
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  u64* list = reinterpret_cast<u64*>(smem);
  u64* hq_key = list + K * TILE_R;
  long long* pref = reinterpret_cast<long long*>(hq_key + HQ);
  long long* wsum = pref + TILE_R;
  int* row_off = reinterpret_cast<int*>(wsum + NW);
  int* row_start = row_off + TILE_R;
  float* row_qsq = reinterpret_cast<float*>(row_start + TILE_R);
  int* row_cnt = reinterpret_cast<int*>(row_qsq + TILE_R);
  int* hq_row = row_cnt + TILE_R;
  int* misc = hq_row + HQ;

  for (int i = tid; i < K * TILE_R; i += BLOCK) list[i] = SENTINEL;
  if (tid < TILE_R) {
    const long long row = static_cast<long long>(s) * E + e0 + tid;
    const bool in = tid < rows;
    const int st = in ? start[row] : 0;
    row_start[tid] = st;
    pref[tid] = in ? max(end[row] - st, 0) : 0;
    row_off[tid] = in ? static_cast<int>(row) : 0;
    row_qsq[tid] = in ? qsq[row] : 0.0f;
    row_cnt[tid] = 0;
  }
  if (tid < NMISC) misc[tid] = 0;
  __syncthreads();
  const long long P = block_exclusive_scan(pref, TILE_R, wsum);
  const PairCtx ctx{q, row_off, row_qsq, row_cnt, list, p + s * sp,
                    psq + s * sn, gid + s * sn, pvalid + s * sn, hq_key,
                    hq_row, misc, d, K, vec != 0, cr2};
  pair_rounds(ctx, P, [&](long long pi, int& r, long long& c) {
    r = find_segment(pref, TILE_R, pi);
    c = row_start[r] + (pi - pref[r]);
  });
  __syncthreads();
  if (tid < rows) {
    const long long row = static_cast<long long>(s) * E + e0 + tid;
    cnt[row] = row_cnt[tid];
    for (int k = 0; k < K; ++k) {
      const u64 key = list[k * TILE_R + tid];
      topd[row * K + k] = __uint_as_float(static_cast<unsigned int>(key >> 32));
      topg[row * K + k] = static_cast<int>(key & 0xffffffffu);
    }
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

// Shared bytes of a scan block with K-lists and an H-slot probe table
// (copied in when table_in_smem), and of a gather block; the wrapper's
// plan mirrors both.
long long bucket_search_smem_bytes(int K, int H, int table_in_smem) {
  return static_cast<long long>(scan_smem(K, H, table_in_smem != 0));
}

long long bucket_gather_smem_bytes(int K) {
  return static_cast<long long>(gather_smem(K));
}

// Bytes of a full scan's device workspace: the splits' partial lists and
// counts, the probe tables of the S * ceil(R / TILE_R) row tiles and the
// live-row lists and counts.
long long bucket_search_workspace_bytes(int S, int R, int K, int n_splits,
                                        int H) {
  const long long rows = static_cast<long long>(S) * R;
  return 8 * rows * n_splits * K +
         static_cast<long long>(table_ws_bytes(
             static_cast<long long>(S) * ((R + TILE_R - 1) / TILE_R), H)) +
         4 * (rows * n_splits + rows + S);
}

// Full scan over S shards: rows (S, R), points (S, N) through shard
// strides sp (points), sn (per-point columns), sb (bucket pairs).  H (a
// power of two >= 2 * TILE_R * L), table_in_smem, n_splits and smem come
// from the wrapper's plan and are checked here; ws holds ws_bytes ==
// bucket_search_workspace_bytes(...).  Writes every row of topd/topg
// (S, R, K) and cnt (S, R).  Returns the CUDA error code (0 on success).
int bucket_search_launch(const float* q, const float* qsq, const int* qb,
                         const int* probe, const int* qtab, int S, int R,
                         int d, int L, int K, const float* p,
                         const float* psq, const int* pb, const int* gid,
                         const int* pvalid, const int* ptab, long long sp,
                         long long sn, long long sb, int N, int n_splits,
                         int H, int table_in_smem, long long smem, float cr2,
                         void* ws, long long ws_bytes, float* topd,
                         int* topg, int* cnt, void* stream) {
  if (K < 1 || K > 128 || L < 1 || d < 1 || n_splits < 1 ||
      n_splits > MAX_SPLITS || N < 0 || N > 0x7fffffff - 2 * CH ||
      H < 2 * TILE_R * L || (H & (H - 1)) != 0 ||
      smem != static_cast<long long>(scan_smem(K, H, table_in_smem != 0)) ||
      ws_bytes != bucket_search_workspace_bytes(S, R, K, n_splits, H))
    return static_cast<int>(cudaErrorInvalidValue);
  const int split_len = (N + n_splits - 1) / n_splits;
  const int tiles = (R + TILE_R - 1) / TILE_R;
  const int vec = d % 4 == 0 && sp % 4 == 0 && aligned16(q) && aligned16(p);
  const long long rows = static_cast<long long>(S) * R;
  u64* part_keys = static_cast<u64*>(ws);
  void* table_ws = part_keys + rows * n_splits * K;
  int* part_cnt = reinterpret_cast<int*>(
      static_cast<unsigned char*>(table_ws) +
      table_ws_bytes(static_cast<long long>(S) * tiles, H));
  int* row_idx = part_cnt + rows * n_splits;
  int* nlive = row_idx + rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  live_rows_kernel<<<S, BLOCK, 0, st>>>(probe, R, L, row_idx, nlive);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  probe_table_kernel<<<dim3(tiles, S), BLOCK, 0, st>>>(
      qb, probe, qtab, row_idx, nlive, R, L, H, table_ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = set_smem(reinterpret_cast<const void*>(bucket_scan_kernel), smem);
  if (err != cudaSuccess) return err;
  bucket_scan_kernel<<<dim3(n_splits, tiles, S), BLOCK, smem, st>>>(
      q, qsq, row_idx, nlive, R, d, K, table_ws, H, table_in_smem, p, psq,
      pb, gid, pvalid, ptab, sp, sn, sb, N, split_len, vec, cr2, part_keys,
      part_cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem2 = 8 * static_cast<size_t>(K + MAX_SPLITS) + 8;
  bucket_search_merge_kernel<<<dim3(R, S), MERGE_T, smem2, st>>>(
      row_idx, nlive, R, K, n_splits, part_keys, part_cnt, topd, topg, cnt);
  return cudaGetLastError();
}

// CSR gather over S shards: expanded rows (S, E) with spans [start, end)
// into the sorted points (S, N), reached through shard strides sp, sn;
// smem is bucket_gather_smem_bytes(K).  Writes every row of topd/topg
// (S, E, K) and cnt (S, E).
int bucket_gather_launch(const float* q, const float* qsq, const int* start,
                         const int* end, int S, int E, int d, int K,
                         const float* p, const float* psq, const int* gid,
                         const int* pvalid, long long sp, long long sn,
                         float cr2, long long smem, float* topd, int* topg,
                         int* cnt, void* stream) {
  if (K < 1 || K > 128 || d < 1 ||
      smem != static_cast<long long>(gather_smem(K)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = d % 4 == 0 && sp % 4 == 0 && aligned16(q) && aligned16(p);
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(bucket_gather_kernel), smem);
  if (err != cudaSuccess) return err;
  bucket_gather_kernel<<<dim3((E + TILE_R - 1) / TILE_R, S), BLOCK, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      q, qsq, start, end, E, d, K, p, psq, gid, pvalid, sp, sn, vec, cr2,
      topd, topg, cnt);
  return cudaGetLastError();
}

}  // extern "C"
