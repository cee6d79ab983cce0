// Bucket-constrained top-K neighbour scans of the distributed LSH index,
// hand-written for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of the reference package:
//   bucket_search_kernel (+ bucket_search_merge_kernel)
//       <- src/repro/kernels/bucket_search.py bucket_search_pallas
//          (_bucket_search_kernel, _merge_topk_tile): the full scan over
//          every stored row;
//   bucket_gather_kernel
//       <- bucket_search.py bucket_gather_pallas (_bucket_gather_kernel):
//          the CSR gather over a bucket-sorted region.
//
// What bounds them on an H100.  Full scan: float32 FMAs outside the tensor
// cores.  A row/point pair costs d FMAs for its dot and a compare; once a
// point tile sits in shared memory the bytes per pair are tiny, so the
// bound is 2*rows*points*d / 67 TFLOP/s.  The hit test (same bucket, same
// table, valid, d^2 <= (cr)^2) almost never passes at a real radius, so the
// top-K insertion is off the hot path.  Gather: the rows of each probe's
// own bucket, a few hundred bytes per probe: bound by memory latency and
// bytes, far below the full scan.
//
// Design:
//  * one thread owns one query row: its dot products, its hit count and
//    its sorted top-K list (in shared memory, K <= 128, so up to 128 KB
//    of dynamic shared memory) need no synchronisation between threads;
//  * full scan: a block stages STAGE_N points in shared memory per pair
//    of barriers; every thread reads the same point at the same time (a
//    broadcast, no bank conflicts) and keeps a chunk of its query row and
//    SUB_N dot accumulators in registers, four FMAs per 16-byte shared
//    load;
//  * the TPU's sequential point-tile grid axis becomes a loop inside the
//    block; the full scan also splits the point axis over blocks (a second
//    kernel merges their partial top-K lists), so a handful of live row
//    tiles still fill the 132 SMs;
//  * the full scan reads its rows through a list of the rows that probe at
//    least one bucket: routed buffers are mostly padding, and a row that
//    probes nothing has no hit;
//  * gather: the TPU kernel streams a window of aligned store tiles per
//    row tile, because a BlockSpec can only fetch whole tiles; here each
//    thread walks its own span [start, end) in global memory, so there is
//    no window to size and no overflow to fall back from;
//  * one launch covers all S shards (grid y), each shard's store reached
//    through a shard stride, so a slice of the store needs no copy;
//  * d^2 is the same arithmetic in both kernels: an ascending FMA chain
//    over d with __fmaf_rn (zeros past d), then __fadd_rn/__fmul_rn/
//    __fsub_rn and the clamp, so nvcc has no contraction or reordering
//    choice that could make the gather round differently from the full
//    scan.  Top-K order is exact lex (d^2, gid) on one 64-bit key, so the
//    CSR path stays bitwise equal to the full scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_R = 128;     // query rows per block, one thread each
constexpr int SUB_N = 32;       // points per register-accumulated sub-tile
constexpr int STAGE_N = 128;    // points staged in shared memory per barrier
constexpr int DCH = 16;         // query-row depth chunk held in registers
constexpr int IMAX = 0x7fffffff;
// (F32_MAX, IMAX): the empty top-K slot, larger than every real key
constexpr unsigned long long SENTINEL =
    (static_cast<unsigned long long>(0x7f7fffffu) << 32) | 0x7fffffffu;

__device__ __forceinline__ unsigned long long lex_key(float d2, int gid) {
  return (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) |
         static_cast<unsigned int>(gid);
}

// |q|^2 + |p|^2 - 2 q.p, clamped at +0 (the shared rounding path).
__device__ __forceinline__ float pair_d2(float qsq, float psq, float dot) {
  const float d2 = __fsub_rn(__fadd_rn(qsq, psq), __fmul_rn(2.0f, dot));
  return d2 > 0.0f ? d2 : 0.0f;
}

// Dots of one query row (global memory, d floats) with SUB_N points staged
// in shared memory at row stride dp (d rounded up to DCH, zero padded).
// Each dot is the ascending chain acc = fma(q[k], p[k], acc), k < dp.
__device__ __forceinline__ void sub_tile_dots(float (&acc)[SUB_N],
                                              const float* __restrict__ qrow,
                                              const float* ps, int d, int dp) {
#pragma unroll
  for (int j = 0; j < SUB_N; ++j) acc[j] = 0.0f;
  for (int k0 = 0; k0 < dp; k0 += DCH) {
    float qc[DCH];
#pragma unroll
    for (int kk = 0; kk < DCH; ++kk)
      qc[kk] = (k0 + kk < d) ? __ldg(qrow + k0 + kk) : 0.0f;
#pragma unroll
    for (int j = 0; j < SUB_N; ++j) {
      const float4* pr = reinterpret_cast<const float4*>(ps + j * dp + k0);
#pragma unroll
      for (int v = 0; v < DCH / 4; ++v) {
        const float4 p4 = pr[v];
        acc[j] = __fmaf_rn(qc[4 * v + 0], p4.x, acc[j]);
        acc[j] = __fmaf_rn(qc[4 * v + 1], p4.y, acc[j]);
        acc[j] = __fmaf_rn(qc[4 * v + 2], p4.z, acc[j]);
        acc[j] = __fmaf_rn(qc[4 * v + 3], p4.w, acc[j]);
      }
    }
  }
}

// Insert key (< the current K-th key) into this thread's ascending list
// (K entries at stride TILE_R); returns the new K-th key.
__device__ __forceinline__ unsigned long long topk_insert(
    unsigned long long* list, int K, unsigned long long key) {
  int pos = K - 1;
  while (pos > 0) {
    const unsigned long long prev = list[(pos - 1) * TILE_R];
    if (prev <= key) break;
    list[pos * TILE_R] = prev;
    --pos;
  }
  list[pos * TILE_R] = key;
  return list[(K - 1) * TILE_R];
}

// Stage points [c0, c0 + n) of one shard (rows of d floats) into shared
// memory at row stride dp; columns past `limit` and depth past d are 0.
__device__ __forceinline__ void stage_points(float* ps, const float* p,
                                             long long c0, int n, int d,
                                             int dp, long long limit) {
  for (int idx = threadIdx.x; idx < n * dp; idx += blockDim.x) {
    const int j = idx / dp;
    const int k = idx - j * dp;
    const long long c = c0 + j;
    ps[idx] = (k < d && c < limit) ? p[c * d + k] : 0.0f;
  }
}

// Full scan, pass 1: block (row tile, shard, point split) scans its split
// for TILE_R compacted rows and writes each row's partial top-K and count.
__global__ void __launch_bounds__(TILE_R) bucket_search_kernel(
    const float* __restrict__ q, const float* __restrict__ qsq,
    const int* __restrict__ qb, const int* __restrict__ probe,
    const int* __restrict__ qtab, const int* __restrict__ row_idx,
    const int* __restrict__ nlive, int R, int d, int dp, int L, int K,
    const float* __restrict__ p, const float* __restrict__ psq,
    const int* __restrict__ pb, const int* __restrict__ gid,
    const int* __restrict__ pvalid, const int* __restrict__ ptab,
    long long sp, long long sn, long long sb, int N, int split_len,
    float cr2, unsigned long long* __restrict__ part_keys,
    int* __restrict__ part_cnt) {
  const int s = blockIdx.y;
  const int r0 = blockIdx.x * TILE_R;
  const int live = nlive[s];
  if (r0 >= live) return;  // uniform over the block
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* ps = reinterpret_cast<float*>(smem);
  float* psq_s = ps + STAGE_N * dp;
  int* gid_s = reinterpret_cast<int*>(psq_s + STAGE_N);
  int* ok_s = gid_s + STAGE_N;
  int* tab_s = ok_s + STAGE_N;
  int* hi_s = tab_s + STAGE_N;
  int* lo_s = hi_s + STAGE_N;
  unsigned long long* list =
      reinterpret_cast<unsigned long long*>(lo_s + STAGE_N) + tid;

  const bool has_row = r0 + tid < live;
  const long long qoff =
      static_cast<long long>(s) * R +
      (has_row ? row_idx[static_cast<long long>(s) * R + r0 + tid] : 0);
  const float* qrow = q + qoff * d;
  const float my_qsq = has_row ? qsq[qoff] : 0.0f;
  const int my_tab = has_row ? qtab[qoff] : 0;
  const int* my_qb = qb + qoff * 2 * L;
  const int* my_probe = probe + qoff * L;

  for (int k = 0; k < K; ++k) list[k * TILE_R] = SENTINEL;
  unsigned long long kth = SENTINEL;
  int count = 0;

  const float* p_s = p + s * sp;
  const float* psq_sh = psq + s * sn;
  const int* gid_sh = gid + s * sn;
  const int* ok_sh = pvalid + s * sn;
  const int* tab_sh = ptab + s * sn;
  const int* pb_sh = pb + s * sb;
  const long long n_begin = static_cast<long long>(blockIdx.z) * split_len;
  const long long n_end = min(static_cast<long long>(N), n_begin + split_len);

  for (long long c0 = n_begin; c0 < n_end; c0 += STAGE_N) {
    __syncthreads();  // the previous tile is consumed
    stage_points(ps, p_s, c0, STAGE_N, d, dp, n_end);
    for (int j = tid; j < STAGE_N; j += TILE_R) {
      const long long c = c0 + j;
      const bool in = c < n_end;
      psq_s[j] = in ? psq_sh[c] : 0.0f;
      gid_s[j] = in ? gid_sh[c] : IMAX;
      ok_s[j] = in ? ok_sh[c] : 0;
      tab_s[j] = in ? tab_sh[c] : 0;
      hi_s[j] = in ? pb_sh[2 * c] : 0;
      lo_s[j] = in ? pb_sh[2 * c + 1] : 0;
    }
    __syncthreads();
    if (!has_row) continue;
    const int n_sub = static_cast<int>(
        min(static_cast<long long>(STAGE_N), n_end - c0) + SUB_N - 1) /
        SUB_N;
    for (int sub = 0; sub < n_sub; ++sub) {
      float acc[SUB_N];
      sub_tile_dots(acc, qrow, ps + sub * SUB_N * dp, d, dp);
#pragma unroll
      for (int j = 0; j < SUB_N; ++j) {
        const int jj = sub * SUB_N + j;
        const float d2 = pair_d2(my_qsq, psq_s[jj], acc[j]);
        if (d2 <= cr2 && ok_s[jj] > 0 && tab_s[jj] == my_tab) {
          bool match = false;
          for (int l = 0; l < L && !match; ++l)
            match = my_probe[l] > 0 && my_qb[2 * l] == hi_s[jj] &&
                    my_qb[2 * l + 1] == lo_s[jj];
          if (match) {
            ++count;
            const unsigned long long key = lex_key(d2, gid_s[jj]);
            if (key < kth) kth = topk_insert(list, K, key);
          }
        }
      }
    }
  }
  if (!has_row) return;
  const long long slot =
      (static_cast<long long>(s) * R + r0 + tid) * gridDim.z + blockIdx.z;
  part_cnt[slot] = count;
  for (int k = 0; k < K; ++k) part_keys[slot * K + k] = list[k * TILE_R];
}

// Full scan, pass 2: merge each compacted row's per-split lists and counts
// and write them to the row's place in the outputs.
__global__ void __launch_bounds__(TILE_R) bucket_search_merge_kernel(
    const int* __restrict__ row_idx, const int* __restrict__ nlive, int R,
    int K, int n_splits, const unsigned long long* __restrict__ part_keys,
    const int* __restrict__ part_cnt, float* __restrict__ topd,
    int* __restrict__ topg, int* __restrict__ cnt) {
  const int s = blockIdx.y;
  const int pos = blockIdx.x * TILE_R + threadIdx.x;
  if (pos >= nlive[s]) return;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* list =
      reinterpret_cast<unsigned long long*>(smem) + threadIdx.x;
  for (int k = 0; k < K; ++k) list[k * TILE_R] = SENTINEL;
  unsigned long long kth = SENTINEL;
  int total = 0;
  const long long slot0 = (static_cast<long long>(s) * R + pos) * n_splits;
  for (int sp = 0; sp < n_splits; ++sp) {
    total += part_cnt[slot0 + sp];
    const unsigned long long* part = part_keys + (slot0 + sp) * K;
    for (int k = 0; k < K; ++k) {
      const unsigned long long key = part[k];
      if (key >= kth) break;  // each partial list is ascending
      kth = topk_insert(list, K, key);
    }
  }
  const long long out =
      static_cast<long long>(s) * R + row_idx[static_cast<long long>(s) * R + pos];
  cnt[out] = total;
  for (int k = 0; k < K; ++k) {
    const unsigned long long key = list[k * TILE_R];
    topd[out * K + k] = __uint_as_float(static_cast<unsigned int>(key >> 32));
    topg[out * K + k] = static_cast<int>(key & 0xffffffffu);
  }
}

// Dot of one query row with one point, both read from global memory: the
// same ascending FMA chain as sub_tile_dots (zeros past d up to dp), so a
// pair's d^2 is bitwise the full scan's.
__device__ __forceinline__ float row_dot(const float* __restrict__ qrow,
                                         const float* __restrict__ prow,
                                         int d, int dp) {
  float acc = 0.0f;
  for (int k = 0; k < dp; ++k) {
    const float qk = k < d ? __ldg(qrow + k) : 0.0f;
    const float pk = k < d ? __ldg(prow + k) : 0.0f;
    acc = __fmaf_rn(qk, pk, acc);
  }
  return acc;
}

// CSR gather: one thread per expanded (query row, probe) row walks the
// rows [start, end) of its own bucket in the sorted region.  Rows are
// sorted by span start, so a warp's spans lie close together; dead probes
// (start == end) sort last and cost one write of the empty answer.
__global__ void __launch_bounds__(TILE_R) bucket_gather_kernel(
    const float* __restrict__ q, const float* __restrict__ qsq,
    const int* __restrict__ start, const int* __restrict__ end, int E, int d,
    int dp, int K, const float* __restrict__ p, const float* __restrict__ psq,
    const int* __restrict__ gid, const int* __restrict__ pvalid,
    long long sp, long long sn, float cr2, float* __restrict__ topd,
    int* __restrict__ topg, int* __restrict__ cnt) {
  const int s = blockIdx.y;
  const int e = blockIdx.x * TILE_R + threadIdx.x;
  if (e >= E) return;
  const long long row = static_cast<long long>(s) * E + e;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* list =
      reinterpret_cast<unsigned long long*>(smem) + threadIdx.x;
  for (int k = 0; k < K; ++k) list[k * TILE_R] = SENTINEL;
  unsigned long long kth = SENTINEL;
  int count = 0;

  const float* qrow = q + row * d;
  const float my_qsq = qsq[row];
  const float* p_s = p + s * sp;
  const float* psq_sh = psq + s * sn;
  const int* gid_sh = gid + s * sn;
  const int* ok_sh = pvalid + s * sn;
  const int c_end = end[row];
  for (int c = start[row]; c < c_end; ++c) {
    if (ok_sh[c] <= 0) continue;
    const float d2 = pair_d2(my_qsq, psq_sh[c],
                             row_dot(qrow, p_s + static_cast<long long>(c) * d,
                                     d, dp));
    if (d2 <= cr2) {
      ++count;
      const unsigned long long key = lex_key(d2, gid_sh[c]);
      if (key < kth) kth = topk_insert(list, K, key);
    }
  }
  cnt[row] = count;
  for (int k = 0; k < K; ++k) {
    const unsigned long long key = list[k * TILE_R];
    topd[row * K + k] = __uint_as_float(static_cast<unsigned int>(key >> 32));
    topg[row * K + k] = static_cast<int>(key & 0xffffffffu);
  }
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// Full scan over S shards: rows (S, R), points (S, N) through shard
// strides sp (points), sn (per-point columns), sb (bucket pairs).
// part_keys (S, R, n_splits, K) and part_cnt (S, R, n_splits) are
// scratch; topd/topg (S, R, K) and cnt (S, R) must hold the empty-row
// values (F32_MAX, IMAX, 0) on entry: only rows listed in row_idx are
// written.  Returns the CUDA error code (0 on success).
int bucket_search_launch(const float* q, const float* qsq, const int* qb,
                         const int* probe, const int* qtab,
                         const int* row_idx, const int* nlive, int S, int R,
                         int d, int L, int K, const float* p,
                         const float* psq, const int* pb, const int* gid,
                         const int* pvalid, const int* ptab, long long sp,
                         long long sn, long long sb, int N, int n_splits,
                         float cr2, unsigned long long* part_keys,
                         int* part_cnt, float* topd, int* topg, int* cnt,
                         void* stream) {
  const int dp = round_up(d, DCH);
  const int split_len = round_up((N + n_splits - 1) / n_splits, SUB_N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(STAGE_N) * dp * 4 +
                      6 * STAGE_N * 4 + static_cast<size_t>(K) * TILE_R * 8;
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(bucket_search_kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + TILE_R - 1) / TILE_R, S, n_splits);
  bucket_search_kernel<<<grid, TILE_R, smem, st>>>(
      q, qsq, qb, probe, qtab, row_idx, nlive, R, d, dp, L, K, p, psq, pb,
      gid, pvalid, ptab, sp, sn, sb, N, split_len, cr2, part_keys, part_cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem2 = static_cast<size_t>(K) * TILE_R * 8;
  err = set_smem(reinterpret_cast<const void*>(bucket_search_merge_kernel),
                 smem2);
  if (err != cudaSuccess) return err;
  bucket_search_merge_kernel<<<dim3(grid.x, S), TILE_R, smem2, st>>>(
      row_idx, nlive, R, K, n_splits, part_keys, part_cnt, topd, topg, cnt);
  return cudaGetLastError();
}

// CSR gather over S shards: expanded rows (S, E) with spans [start, end)
// into the sorted points (S, N), reached through shard strides sp, sn.
// Writes every row of topd/topg (S, E, K) and cnt (S, E).
int bucket_gather_launch(const float* q, const float* qsq, const int* start,
                         const int* end, int S, int E, int d, int K,
                         const float* p, const float* psq, const int* gid,
                         const int* pvalid, long long sp, long long sn,
                         float cr2, float* topd, int* topg, int* cnt,
                         void* stream) {
  const int dp = round_up(d, DCH);
  const size_t smem = static_cast<size_t>(K) * TILE_R * 8;
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(bucket_gather_kernel), smem);
  if (err != cudaSuccess) return err;
  bucket_gather_kernel<<<dim3((E + TILE_R - 1) / TILE_R, S), TILE_R, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      q, qsq, start, end, E, d, dp, K, p, psq, gid, pvalid, sp, sn, cr2, topd,
      topg, cnt);
  return cudaGetLastError();
}

}  // extern "C"
