// The p-stable LSH hash floor((x a + b) / w) -> int32, hand-written for
// Hopper (sm_90a), with a plain C interface for ctypes.  It is bitwise the
// index's hash_h (src/repro_torch/core/hashing.py), and the index hashes
// through it on the card: the insert, the query dispatch, the receive
// side and the second layer G (K = 1).
//
// Replaces the Pallas TPU kernel of the reference package:
//   lsh_hash_kernel <- src/repro/kernels/lsh_hash.py lsh_hash_pallas
//                      (_lsh_hash_kernel).
//
// Arithmetic.  out[i][k] = floor(fdiv_rn(fadd_rn(tree(x[i][:] * a[:, k]),
// b[k]), w)), where every product is rounded once (__fmul_rn) and tree is
// tree_sum's fixed pairwise order (src/repro_torch/kernels/types.py): the
// products in pairs, level by level, an odd level padded with +0.0, each
// add one __fadd_rn.  Only the intrinsics are used: nvcc's default
// --fmad=true would contract a plain x * a + s into an FFMA and move bits,
// and this file must never be built with --use_fast_math or -ftz=true
// (torch on the CPU keeps subnormals).  The TPU kernel multiplies by 1/w;
// this one divides, as hash_h does.  With floor_out = 0 the float32
// quotient is written instead (hash_h's Gamma).
//
// The order, kept without holding a row whole.  Let d = m 2^j with m odd
// and C = 2^min(j, 6) (or less, where shared memory asks for it).  The
// first log2(C) levels of tree_sum see even lengths, so they are sums of
// C consecutive products: each thread forms those chunk sums in registers
// by a compile-time-unrolled tree.  tree_sum of the d / C chunk sums
// equals tree_sum padded to a power of two, so the chunk sums are merged
// as they arrive (a binary counter: neighbours of equal level) and folded
// from the right at the end, the right part padded with one + 0.0 per
// missing level.  tests/test_torch_hash_order.py emulates this order and
// holds it bitwise against tree_sum.
//
// Inputs: x (n, d) float32, bf16 or int32 (converted exactly), read
// through its element strides; a (T, d, K) and b (T, K) float32
// contiguous; T tables, row i under table t(i) = table[i / div] (or i /
// div without a table pointer, the leading axis of a (T, N, d) x).  Out
// (n, K) row-major.
//
// What bounds it on an H100.  At the index's Map-phase shape (2**22
// points, d = 64, K = 20) the bytes: x read once and the ints written
// once, 1.41 GB, 0.42 ms at 3.35 TB/s.  No fused multiply-add is allowed,
// so each output costs d products, d - 1 adds, the b add and a division;
// about 1.1e10 float32 instructions there, 0.32 ms at the card's rate of
// non-fused instructions, near the bytes' time.  So the loads must
// overlap the arithmetic, and the other instructions (shared loads,
// addressing, the epilogue) must stay few beside it.
//
// Design:
//  * one thread per row of a 32-row warp tile (two rows, lane and lane +
//    32, where one chunk is the whole dot), summing it against a group of
//    at most 8 output columns, the same columns across the warp: a block
//    of 8 warps covers 32 R (8 / NG) rows by NG groups (KB <= 64
//    columns).  For four products a thread reads a row's x with one
//    16-byte shared load, which serves its columns, and a column's a with
//    one 16-byte load of one address across the warp, which serves its
//    rows, at offsets known at compile time;
//  * a tile's outputs go to shared memory and leave row-major, whole rows
//    at a time, so the warps' stores are coalesced;
//  * a persistent grid (blocks per SM from the occupancy calculator)
//    walks the (row tile, column block) units, each in stages of up to 64
//    columns of d (whole chunks), stepping a cursor (no division in the
//    loop).  A ring of 2-3 stages in shared memory keeps the next stages'
//    loads in flight while one is summed: cp.async 16-byte copies where x
//    is float32 with 16-byte-aligned contiguous rows (the index's points
//    and offsets), 4-byte copies for any other float32 or int32 x (int32
//    converted in place once it lands), plain loads for bf16.  Row and
//    column pitches are 4 (mod 8) words, so the 16-byte loads of a
//    quarter warp fall on distinct banks;
//  * a and b stay in shared memory: b whole, a whole where one stage
//    covers d and K (the index shape), else a's stage of every table
//    rides in the ring beside x;
//  * any n, d (d / C < 2**16) and K; plan() in kernels/lsh_hash.py sizes
//    the chunk, the stages, the column groups, the ring and the tiles,
//    and raises on what this file refuses.  A row whose table id lies
//    outside [0, T) gets INT_MIN (or NaN).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // 8 warps: RW row warps x NG column groups
// rows a thread sums: two where one chunk is the whole dot (the a loads
// shared by two rows); one where chunk sums are carried across stages,
// whose counters would double and, compiled for two rows, take ptxas
// minutes
template <int LV>
__host__ __device__ constexpr int rows_of() { return LV == 1 ? 2 : 1; }
constexpr int MAX_COLS = 8;       // output columns a thread sums
constexpr int LEVELS = 16;        // d / C < 2**LEVELS chunk sums a dot
constexpr int MAX_STAGE = 64;     // columns of d a stage holds (or one chunk)

struct Args {
  const void* x;
  const float* a;
  const float* b;
  const int* table;
  void* out;
  long long n, xs0, xs1, div;
  int units, d, K, T, KB, NG, kc, TR, nkb, nchunks, sc, ds, steps, stages,
      pitch, apitch, opitch, a_resident, vec, dtype, floor_out, ids;
  float w;
};

__host__ __device__ __forceinline__ int round4(int v) {
  return (v + 3) & ~3;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This block's stage: unit blockIdx.x + i gridDim.x, step `step` of it.
struct Cursor {
  int unit, step;
};

__device__ __forceinline__ void advance(const Args& p, Cursor& c) {
  if (++c.step == p.steps) {
    c.step = 0;
    c.unit += gridDim.x;
  }
}

struct Stage {
  long long row0;
  int step, kb0, kw;
};

__device__ __forceinline__ Stage stage_at(const Args& p, const Cursor& c) {
  int tile = c.unit, kb = 0;
  if (p.nkb > 1) {
    tile = c.unit / p.nkb;
    kb = c.unit - tile * p.nkb;
  }
  Stage st;
  st.step = c.step;
  st.kb0 = kb * p.KB;
  st.kw = min(p.KB, p.K - st.kb0);
  st.row0 = static_cast<long long>(tile) * p.TR;
  return st;
}

// a's rows [step ds, step ds + ds) and columns [kb0, kb0 + KB) of every
// table, each column along d: as[(t KB + kk) apitch + c], zero past K.
__device__ void load_a(const Args& p, const Stage& st, float* as) {
  const int per = p.ds * p.KB;
  const int dd0 = st.step * p.ds;
  for (int i = threadIdx.x; i < p.T * per; i += blockDim.x) {
    const int t = i / per;
    const int rem = i - t * per;
    const int c = rem / p.KB;
    const int kk = rem - c * p.KB;
    float* dst = as + (t * p.KB + kk) * p.apitch + c;
    if (kk < st.kw)
      cp_async4(dst, p.a + (static_cast<long long>(t) * p.d + dd0 + c) *
                               p.K + st.kb0 + kk);
    else
      *dst = 0.0f;
  }
}

__device__ void load_stage(const Args& p, const Cursor& cur, int slot,
                           float* a_s, float* x_s, int* t_s) {
  const Stage st = stage_at(p, cur);
  float* xs = x_s + slot * round4(p.TR * p.pitch);
  const int dd0 = st.step * p.ds;
  if (p.vec) {
    // pieces i = r Q + q of the tile, walked without a division a piece
    const int Q = p.ds / 4;
    const int dr = THREADS / Q, dq = THREADS - dr * Q;
    const float* xf = static_cast<const float*>(p.x);
    for (int r = threadIdx.x / Q, q = threadIdx.x - r * Q; r < p.TR;
         r += dr, q += dq) {
      if (q >= Q) {
        q -= Q;
        if (++r >= p.TR) break;
      }
      const long long row = st.row0 + r;
      float* dst = xs + r * p.pitch + 4 * q;
      if (row < p.n)
        cp_async16(dst, xf + row * p.xs0 + dd0 + 4 * q);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    const int dr = THREADS / p.ds, dc = THREADS - dr * p.ds;
    for (int r = threadIdx.x / p.ds, c = threadIdx.x - r * p.ds; r < p.TR;
         r += dr, c += dc) {
      if (c >= p.ds) {
        c -= p.ds;
        if (++r >= p.TR) break;
      }
      const long long row = st.row0 + r;
      float* dst = xs + r * p.pitch + c;
      const long long off =
          row * p.xs0 + static_cast<long long>(dd0 + c) * p.xs1;
      if (row >= p.n)
        *dst = 0.0f;
      else if (p.dtype == 1)
        *dst = __bfloat162float(
            static_cast<const __nv_bfloat16*>(p.x)[off]);
      else  // float32, or int32 bits converted once the stage lands
        cp_async4(dst, static_cast<const float*>(p.x) + off);
    }
  }
  if (!p.a_resident) load_a(p, st, a_s + slot * round4(p.T * p.KB * p.apitch));
  if (p.ids) {
    int* ts = t_s + slot * p.TR;
    for (int r = threadIdx.x; r < p.TR; r += blockDim.x) {
      const long long row = st.row0 + r;
      int t = 0;
      if (row < p.n) {
        const long long e = row / p.div;
        t = p.table ? p.table[e] : static_cast<int>(e);
        if (t < 0 || t >= p.T) t = -1;
      }
      ts[r] = t;
    }
  }
}

// Chunk sums of this thread's R rows against its columns [col0, col0 +
// KC) over the stage's columns [c0, c0 + C): the C products of each,
// summed by tree_sum's pairs (the counter's positions are compile-time
// constants, so lvl stays in registers), then merged into the output's
// running counter stk at position `chunk`.  For four products a row's x
// comes as one 16-byte load and serves its KC columns; a column's a comes
// as one 16-byte load of one address across the warp and serves the R
// rows (SAME: every row under one table; else one load a row).
template <int C, int KC, int LV, int R, bool SAME>
__device__ __forceinline__ void sum_chunk(const float* const (&xr)[R],
                                          const float* const (&ar)[R],
                                          int apitch, int chunk,
                                          float (&stk)[R][KC][LV]) {
  constexpr int L2C = C >= 64 ? 6 : C >= 32 ? 5 : C >= 16 ? 4 : C >= 8 ? 3
                      : C >= 4 ? 2 : C >= 2 ? 1 : 0;
  constexpr int V = C >= 4 ? 4 : 1;
  constexpr int RA = SAME ? 1 : R;      // rows with their own a loads
  float lvl[R][KC][L2C + 1];
#pragma unroll
  for (int i = 0; i < C; i += V) {
    float xv[R][V], av[RA][KC][V];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (V == 4) {
        const float4 q = *reinterpret_cast<const float4*>(xr[r] + i);
        xv[r][0] = q.x;
        xv[r][1] = q.y;
        xv[r][2] = q.z;
        xv[r][3] = q.w;
      } else {
        xv[r][0] = xr[r][i];
      }
    }
#pragma unroll
    for (int r = 0; r < RA; ++r) {
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if constexpr (V == 4) {
          const float4 u =
              *reinterpret_cast<const float4*>(ar[r] + j * apitch + i);
          av[r][j][0] = u.x;
          av[r][j][1] = u.y;
          av[r][j][2] = u.z;
          av[r][j][3] = u.w;
        } else {
          av[r][j][0] = ar[r][j * apitch + i];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < KC; ++j) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int ii = i + e;
          float v = __fmul_rn(xv[r][e], av[SAME ? 0 : r][j][e]);
          bool carry = true;
#pragma unroll
          for (int l = 0; l <= L2C; ++l) {
            if (carry) {
              if ((ii >> l) & 1) {
                v = __fadd_rn(lvl[r][j][l], v);
              } else {
                lvl[r][j][l] = v;
                carry = false;
              }
            }
          }
        }
      }
    }
  }
  // merge into the counters of chunk sums: position `chunk` (uniform)
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      float v = lvl[r][j][L2C];
#pragma unroll
      for (int l = 0; l < LV; ++l) {
        if ((chunk >> l) & 1) {
          v = __fadd_rn(stk[r][j][l], v);
        } else {
          stk[r][j][l] = v;
          break;
        }
      }
    }
  }
}

// tree_sum of P chunk sums held by the counter: the set bits from the
// lowest (rightmost subtree) up, the right part padded with + 0.0 for each
// level it lacks.
template <int LV>
__device__ __forceinline__ float fold(const float (&stk)[LV], int P) {
  float v = 0.0f;
  bool have = false;
#pragma unroll
  for (int l = 0; l < LV; ++l) {
    const bool bit = (P >> l) & 1;
    if (!have) {
      if (bit) {
        v = stk[l];
        have = true;
        if (P >> (l + 1)) v = __fadd_rn(v, 0.0f);
      }
    } else if (P >> l) {
      v = bit ? __fadd_rn(stk[l], v) : __fadd_rn(v, 0.0f);
    }
  }
  return v;
}

// Each thread sums R rows of its warp's 32 R (lane, lane + 32, ...)
// against its column group; the results go to o_s (the tile's outputs,
// row-major), and the block writes them out whole rows at a time.
template <int C, int KC, int LV>
__global__ void __launch_bounds__(THREADS, LV == 1 ? 2 : 1)
    lsh_hash_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  const int aslot = round4(p.T * p.KB * p.apitch);
  const int xslot = round4(p.TR * p.pitch);
  float* b_s = smem;
  float* a_s = b_s + round4(p.T * p.K);
  float* x_s = a_s + aslot * (p.a_resident ? 1 : p.stages);
  int* o_s = reinterpret_cast<int*>(x_s + xslot * p.stages);
  int* t_s = o_s + p.TR * p.opitch;

  constexpr int R = rows_of<LV>();
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row0 = (warp / p.NG) * 32 * R + tid % 32;   // in the tile
  const int col0 = (warp % p.NG) * p.kc;           // in the column block
  const int mine = (p.units - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int total = mine * p.steps;
  for (int i = tid; i < p.T * p.K; i += blockDim.x) b_s[i] = p.b[i];
  Cursor load = {static_cast<int>(blockIdx.x), 0};
  if (p.a_resident) load_a(p, stage_at(p, load), a_s);
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < total) {
      load_stage(p, load, s, a_s, x_s, t_s);
      advance(p, load);
    }
    cp_commit();
  }
  float stk[R][KC][LV];
  Cursor cur = {static_cast<int>(blockIdx.x), 0};
  int slot = 0, load_slot = p.stages - 1;
  for (int s = 0; s < total; ++s) {
    // one barrier a stage: stage s has landed for every thread, and every
    // thread is done with stage s - 1, whose slot the next load refills
    if (p.stages == 3)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();
    if (s + p.stages - 1 < total) {
      load_stage(p, load, load_slot, a_s, x_s, t_s);
      advance(p, load);
    }
    cp_commit();
    float* xs = x_s + slot * xslot;
    if (p.dtype == 2) {  // int32 bits -> float, as hk.to(float32)
      for (int i = tid; i < p.TR * p.pitch; i += blockDim.x)
        xs[i] = __int2float_rn(__float_as_int(xs[i]));
      __syncthreads();
    }
    const Stage st = stage_at(p, cur);
    const int nc = min(p.kc, st.kw - col0);       // warp-uniform
    int t[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      t[r] = p.ids ? t_s[slot * p.TR + row0 + 32 * r] : 0;
    if (nc > 0) {
      const float* as = a_s + (p.a_resident ? 0 : slot * aslot);
      for (int sc = 0; sc < p.sc; ++sc) {
        const float* xr[R];
        const float* ar[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          xr[r] = xs + (row0 + 32 * r) * p.pitch + sc * C;
          ar[r] = as + (max(t[r], 0) * p.KB + col0) * p.apitch + sc * C;
        }
        const int chunk = st.step * p.sc + sc;
        if (p.T == 1)
          sum_chunk<C, KC, LV, R, true>(xr, ar, p.apitch, chunk, stk);
        else
          sum_chunk<C, KC, LV, R, false>(xr, ar, p.apitch, chunk, stk);
      }
    }
    if (st.step == p.steps - 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          if (j >= nc) break;
          const float q = __fdiv_rn(
              __fadd_rn(fold<LV>(stk[r][j], p.nchunks),
                        b_s[max(t[r], 0) * p.K + st.kb0 + col0 + j]),
              p.w);
          o_s[(row0 + 32 * r) * p.opitch + col0 + j] =
              p.floor_out
                  ? (t[r] < 0 ? INT_MIN : static_cast<int>(floorf(q)))
                  : (t[r] < 0 ? 0x7fc00000 : __float_as_int(q));
        }
      }
      __syncthreads();
      // the tile's rows [row0, row0 + TR) x columns [kb0, kb0 + kw)
      const int kw = st.kw;
      int r = tid / kw, c = tid - (tid / kw) * kw;
      const int dr = THREADS / kw, dc = THREADS - dr * kw;
      int* out = static_cast<int*>(p.out);
      for (; r < p.TR; r += dr, c += dc) {
        if (c >= kw) {
          c -= kw;
          ++r;
          if (r >= p.TR) break;
        }
        const long long grow = st.row0 + r;
        if (grow >= p.n) break;
        out[grow * p.K + st.kb0 + c] = o_s[r * p.opitch + c];
      }
    }
    advance(p, cur);
    slot = slot + 1 == p.stages ? 0 : slot + 1;
    load_slot = load_slot + 1 == p.stages ? 0 : load_slot + 1;
  }
  cp_wait<0>();
}

// The launch: blocks per SM from the occupancy calculator, remembered
// per device for the last shared-memory size (the serving path launches
// the same few shapes again and again from the host).
template <int C, int KC, int LV>
int launch(const Args& p, int smem, cudaStream_t stream) {
  constexpr int MAX_DEVICES = 64;
  static int last_smem[MAX_DEVICES] = {}, blocks[MAX_DEVICES] = {};
  auto fn = lsh_hash_kernel<C, KC, LV>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (last_smem[dev] != smem) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                          THREADS, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    blocks[dev] = per_sm * sms;
    last_smem[dev] = smem;
  }
  fn<<<min(p.units, blocks[dev]), THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int KC, int LV>
int launch_chunk(const Args& p, int chunk, int smem, cudaStream_t st) {
  switch (chunk) {
    case 1: return launch<1, KC, LV>(p, smem, st);
    case 2: return launch<2, KC, LV>(p, smem, st);
    case 4: return launch<4, KC, LV>(p, smem, st);
    case 8: return launch<8, KC, LV>(p, smem, st);
    case 16: return launch<16, KC, LV>(p, smem, st);
    case 32: return launch<32, KC, LV>(p, smem, st);
    case 64: return launch<64, KC, LV>(p, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// every column group sums KC columns (a group past K sums a's zero
// padding, whose outputs are not written)
template <int LV>
int launch_cols(const Args& p, int chunk, int smem, cudaStream_t st) {
  switch (p.kc) {
    case 1: return launch_chunk<1, LV>(p, chunk, smem, st);
    case 2: return launch_chunk<2, LV>(p, chunk, smem, st);
    case 4: return launch_chunk<4, LV>(p, chunk, smem, st);
    case 5: return launch_chunk<5, LV>(p, chunk, smem, st);
    case 8: return launch_chunk<8, LV>(p, chunk, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared memory of a launch, as the kernel lays it out (plan() in
// kernels/lsh_hash.py computes the same); ids: rows carry table ids.
long long smem_bytes(int T, int K, int KB, int rows, int pitch,
                              int apitch, int opitch, int stages,
                              int a_resident, int ids) {
  return 4LL * (round4(T * K) +
                round4(T * KB * apitch) * (a_resident ? 1 : stages) +
                round4(rows * pitch) * stages + rows * opitch +
                (ids ? rows * stages : 0));
}

}  // namespace

extern "C" {

// out (n, K) int32 (floor_out = 1) or float32, row-major, from x (n, d)
// reached through its element strides (xs0, xs1), dtype 0 float32, 1
// bf16, 2 int32; a (T, d, K) and b (T, K) float32 contiguous; row i under
// table table[i / div] (table may be NULL: i / div).  chunk, sc (chunks
// a stage), KB (columns a block), NG (column groups), rows, stages,
// kc (columns a group: 1, 2, 4, 5 or 8), pitch, apitch, opitch,
// a_resident and vec are plan()'s; smem its bytes.  Returns the CUDA error
// code (0 on success).
int lsh_hash_launch(const void* x, const void* a, const void* b,
                    const void* table, void* out, int dtype, int floor_out,
                    long long n, int d, int K, int T, long long div, float w,
                    long long xs0, long long xs1, int chunk, int sc, int KB,
                    int NG, int kc, int rows, int stages, int pitch,
                    int apitch, int opitch, int a_resident, int vec,
                    long long smem, void* stream) {
  const int ds = chunk * sc;
  const long long nchunks = chunk > 0 ? d / chunk : 0;
  const int nkb = KB > 0 ? (K + KB - 1) / KB : 0;
  const long long steps = sc > 0 ? nchunks / sc : 0;
  const long long units = KB > 0 && rows > 0
                              ? ((n + rows - 1) / rows) * nkb : 0;
  const bool ids = T > 1 || table != nullptr;
  if (n < 0 || d <= 0 || K <= 0 || T <= 0 || div <= 0 || !(w > 0.0f) ||
      dtype < 0 || dtype > 2 || chunk <= 0 || (chunk & (chunk - 1)) ||
      chunk > 64 || d % chunk != 0 || nchunks >= (1LL << LEVELS) ||
      sc <= 0 || nchunks % sc != 0 || (sc > 1 && ds > MAX_STAGE) ||
      KB <= 0 || KB > K || KB > MAX_COLS * 8 ||
      (NG != 1 && NG != 2 && NG != 4 && NG != 8) || kc <= 0 ||
      kc > MAX_COLS || kc * NG < KB ||
      rows != 32 * (nchunks == 1 ? rows_of<1>() : rows_of<LEVELS>()) *
                  (8 / NG) ||
      (stages != 2 && stages != 3) ||
      units >= (1LL << 31) || pitch < ds || apitch < ds || opitch < KB ||
      opitch % 2 != 1 ||
      (chunk >= 4 && (pitch % 8 != 4 || apitch % 8 != 4)) ||
      (chunk < 4 && (pitch % 2 != 1 || apitch % 2 != 1)) ||
      (a_resident && (steps != 1 || nkb != 1)) ||
      (vec && (dtype != 0 || chunk % 4 != 0 || xs1 != 1 || xs0 % 4 != 0 ||
               reinterpret_cast<uintptr_t>(x) % 16 != 0)) ||
      smem != smem_bytes(T, K, KB, rows, pitch, apitch, opitch, stages,
                         a_resident, ids))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args p;
  p.x = x;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.table = static_cast<const int*>(table);
  p.out = out;
  p.n = n;
  p.xs0 = xs0;
  p.xs1 = xs1;
  p.div = div;
  p.units = static_cast<int>(units);
  p.d = d;
  p.K = K;
  p.T = T;
  p.KB = KB;
  p.NG = NG;
  p.kc = kc;
  p.TR = rows;
  p.nkb = nkb;
  p.nchunks = static_cast<int>(nchunks);
  p.sc = sc;
  p.ds = ds;
  p.steps = static_cast<int>(steps);
  p.stages = stages;
  p.pitch = pitch;
  p.apitch = apitch;
  p.opitch = opitch;
  p.a_resident = a_resident;
  p.vec = vec;
  p.dtype = dtype;
  p.floor_out = floor_out;
  p.ids = ids;
  p.w = w;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nchunks == 1)
    return launch_cols<1>(p, chunk, static_cast<int>(smem), st);
  return launch_cols<LEVELS>(p, chunk, static_cast<int>(smem), st);
}

}  // extern "C"
