// Mamba-2 SSD chunked scan, hand-written for Hopper (sm_90a), with a plain
// C interface for ctypes.
//
// Replaces the Pallas TPU kernel of the reference package:
//   ssd_scan_kernel, ssd_scan_tc_kernel
//     <- src/repro/kernels/ssd_scan.py ssd_scan_pallas (_ssd_kernel).
// Both compute what _ssd_kernel computes, for one (batch, head) and one
// chunk of Q steps at a time, with lam_t = a dt_t, a = -exp(a_log[h]) and
// cum_t the running sum of lam inside the chunk:
//   y_t    = exp(cum_t) C_t . state
//          + sum_{j <= t} (C_t . B_j) exp(cum_t - cum_j) dt_j x_j
//   state' = exp(cum_Q) state + sum_t exp(cum_Q - cum_t) dt_t x_t B_t^T
// with x (B, S, H, P), B and C (B, S, G, N) read at group h / (H / G)
// through their strides (nothing is repeated to the heads), dt (B, S, H)
// and a_log (H,) in float32, the (P, N) state carried in float32 across
// chunks, and y (B, S, H, P) in x's dtype.  Common to both designs:
//  * one block per (batch, head); the TPU kernel's sequential chunk grid
//    axis is the loop over chunks inside the block, the state carried
//    across it as in VMEM scratch: 1,536 blocks at mamba2-130m's shape;
//  * chunk Q = 64, not the TPU kernel's 128 (the wrapper's CHUNK): the
//    float32 design's tiles would pass a block's 227 KB at 128, and the
//    tensor-core design keeps two blocks an SM at 64.  The chunk length
//    changes only the rounding, not the function;
//  * the decay is selected before the exponential: only i >= j takes
//    exp(min(cum_i - cum_j, 0)); the TPU kernel's exp-then-mask would
//    give inf * 0 = NaN for i < j at mamba2's decay rates (a down to -16);
//  * any S: the last chunk is masked (dt = 0 and zero x, B, C past S,
//    identity steps), nothing is padded by the caller;
//  * the cumulative sums, exponentials and masks are float32.
//
// What bounds it on an H100.  At the embedder's shapes (64 x 1,024 tokens,
// H = 24, P = 64, N = 128, bf16) the chunked algorithm does about 70 GFLOP
// of products a launch at Q = 64 (the causal half of the chunk-square
// ones) against some 440 MB of traffic: about 160 FLOP a byte, below the
// 295 at which bf16 tensor cores would be the limit, so the bytes, once
// the products run on tensor cores; at the float32 CUDA-core rate they
// are the operations.  In practice the tensor-core design is bound by
// each block's own chain: it walks its 16 chunks in order (the state is
// a chain), one warp a scheduler issuing each chunk's long run of
// dependent instructions, and one block alone on an SM takes about as
// long per chunk as two sharing it (PERF.md).  Fewer instructions a
// chunk is what moved it; more warps a block (8, scores duplicated, 128
// registers) was slower.
//
// Two designs; the wrapper's plan (kernels/ssd_scan.py, `plan`) picks one
// by dtype, shape and alignment, never after a failure:
//
// "tensor_core" (ssd_scan_tc_kernel): bf16, P and N multiples of 16 with
// P <= 64 and N <= 128 (the state lives in registers), every pointer and
// stride of x, B, C and y 16-byte aligned -- mamba2-130m (P = 64,
// N = 128, strided views of its conv output) and every bf16 card test.
//  * 4 warps (128 threads); each chunk's x (Q x P), B and C (Q x N) are
//    staged as bf16 by 16-byte cp.async, dt (Q, f32) by 4-byte ones,
//    through a two-stage ring: chunk c + 1 loads while chunk c computes
//    (at mamba2's exact widths each thread's pieces are a constant count,
//    unrolled).  Rows are padded by 16 bytes (conflict-free ldmatrix).
//    105.5 KB at mamba2's shape: two blocks an SM; two barriers a chunk;
//  * the four products run on mma.sync m16n8k16 bf16 -> f32, fragments
//    from ldmatrix (.trans where the operand is k-major in shared
//    memory).  Warp w owns chunk rows 16 w .. 16 w + 15:
//      - scores C B^T over N, both operands the bf16 the model wrote,
//        for all Q columns (those past the warp's diagonal are masked in
//        M): the loops stay branch-free so the fragment loads are
//        scheduled ahead of the products, and warp 3, which needs every
//        column, sets the chunk's pace at the barrier either way;
//      - y = diag(exp cum) C state^T, with B = a bf16 copy of the state
//        that each chunk writes to shared memory;
//      - y += M x, M = scores * exp(cum_i - cum_j) * dt_j (j <= i) built
//        in f32 on the score fragments and rounded to bf16 in registers,
//        as FA2 rounds P; the decay is the SFU's 2^x of the gap in log2
//        units (cum is kept times log2 e), an f32 rounding away from
//        expf and far below M's bf16 step;
//      - state = exp(total) state + (w x)^T B, w_t = exp(total - cum_t)
//        dt_t, with x^T from ldmatrix.trans scaled by w in f32 and
//        rounded to bf16 in registers; the f32 state itself lives in the
//        warps' accumulator fragments (warp w owns state rows 16 w ..,
//        64 registers a thread at N = 128) and is never rounded;
//  * the cumulative sum runs in every warp on its own copy (no barrier);
//    y leaves through the warp's own (spent) C rows as 16-byte stores
//    where a y row fits a C row (P <= N + 8), else from the fragments.
// Operands rounded to bf16, once each, with no hi/lo split: M, the state
// copy that C . state^T reads, and w x (x, B, C are bf16 already).  The
// card tests hold the result to the plain version at 0.05 as before.
//
// "cuda_core" (ssd_scan_kernel): float32 (the card tests hold it to the
// sequential reference at 2e-4, which bf16 products could not meet) and
// any bf16 shape the tensor-core design does not take.  The first,
// simple design, unchanged: one block of 256 threads, the state and
// float32 tiles of B, C, x and C B^T in shared memory (133 KB at
// mamba2's shape, one block an SM), each small product from shared
// memory with a 16 x 16 thread grid, a thread owning rows ty + 16 i and
// columns tx + 16 j, so rows are read as broadcasts and columns from
// consecutive banks.  All float32 FMAs on CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int Q = 64;            // internal chunk
constexpr int THREADS = 256;     // a 16 x 16 grid
constexpr int RM = Q / 16;       // rows a thread owns in a Q-row product
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct S4 {  // element strides of a 4-d tensor
  long long s0, s1, s2, s3;
};

// Shared-memory layout in floats, for P rounded up to PP = 16 TP and N.
struct Layout {
  int ldc, ldbt, ldm, nrows;
  int c, bt, x, m, st, cum, w, ecum, dt, total;
  __host__ __device__ Layout(int N, int PP) {
    ldc = N + 1;                    // C  [Q][N + 1]
    ldbt = Q + 1;                   // B^T[nrows][Q + 1]
    ldm = Q + 1;                    // M  [Q][Q + 1]
    nrows = (N + Q - 1) / Q * Q;    // B^T rows, whole row blocks of Q
    c = 0;
    bt = c + Q * ldc;
    x = bt + nrows * ldbt;          // x  [Q][PP]
    m = x + Q * PP;
    st = m + Q * ldm;               // state^T [N][PP]
    cum = st + N * PP;
    w = cum + Q;
    ecum = w + Q;
    dt = ecum + Q;
    total = dt + Q;
  }
};

template <typename T, int TP>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ dt,
    const float* __restrict__ a_log, T* __restrict__ y, int S, int H,
    int G, int P, int N, S4 xs, S4 bs, S4 cs, S4 ds, S4 ys) {
  constexpr int PP = 16 * TP;
  const Layout lay(N, PP);
  extern __shared__ __align__(16) float smem[];
  float* c_s = smem + lay.c;
  float* bt_s = smem + lay.bt;
  float* x_s = smem + lay.x;
  float* m_s = smem + lay.m;
  float* st_s = smem + lay.st;
  float* cum_s = smem + lay.cum;
  float* w_s = smem + lay.w;
  float* ecum_s = smem + lay.ecum;
  float* dt_s = smem + lay.dt;
  float* total_s = smem + lay.total;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = h / (H / G);
  const float a = -expf(a_log[h]);

  const T* xb = x + b * xs.s0 + h * xs.s2;
  const T* bb = bm + b * bs.s0 + g * bs.s2;
  const T* cb = cm + b * cs.s0 + g * cs.s2;
  const float* db = dt + b * ds.s0 + h * ds.s2;
  T* yb = y + b * ys.s0 + h * ys.s2;

  // the state starts at 0; B^T rows past N stay 0
  for (int i = tid; i < N * PP; i += THREADS) st_s[i] = 0.0f;
  for (int i = tid; i < lay.nrows * lay.ldbt; i += THREADS) bt_s[i] = 0.0f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int len = min(Q, S - t0);
    __syncthreads();  // the previous chunk is consumed
    // ---- stage the chunk (zeros past S: identity steps) ------------------
    for (int i = tid; i < Q * PP; i += THREADS) {
      const int t = i / PP;
      const int p = i - t * PP;
      x_s[i] = (t < len && p < P)
                   ? to_f32(xb[(t0 + t) * xs.s1 + p * xs.s3]) : 0.0f;
    }
    for (int i = tid; i < Q * N; i += THREADS) {
      const int t = i / N;
      const int n = i - t * N;
      const bool in = t < len;
      c_s[t * lay.ldc + n] = in ? to_f32(cb[(t0 + t) * cs.s1 + n * cs.s3])
                                : 0.0f;
      bt_s[n * lay.ldbt + t] = in ? to_f32(bb[(t0 + t) * bs.s1 + n * bs.s3])
                                  : 0.0f;
    }
    if (tid < Q) dt_s[tid] = tid < len ? db[(t0 + tid) * ds.s1] : 0.0f;
    __syncthreads();
    // ---- cum_t: inclusive running sum of a dt_t (warp 0, 2 rows a lane) --
    if (tid < 32) {
      const float l0 = a * dt_s[2 * tid];
      const float l1 = a * dt_s[2 * tid + 1];
      float run = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL, run, off);
        if (tid >= off) run += o;
      }
      const float before = run - (l0 + l1);
      cum_s[2 * tid] = before + l0;
      cum_s[2 * tid + 1] = run;
      const float tot = __shfl_sync(FULL, run, 31);
      if (tid == 0) total_s[0] = tot;
    }
    __syncthreads();
    const float total = total_s[0];
    if (tid < Q) {
      const float ct = cum_s[tid];
      ecum_s[tid] = expf(ct);
      w_s[tid] = expf(fminf(total - ct, 0.0f)) * dt_s[tid];
    }
    // ---- M[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i --------
    {
      float acc[RM][RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RM; ++j) acc[i][j] = 0.0f;
      for (int k = 0; k < N; ++k) {
        float av[RM], bv[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = c_s[(ty + 16 * i) * lay.ldc + k];
#pragma unroll
        for (int j = 0; j < RM; ++j) bv[j] = bt_s[k * lay.ldbt + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RM; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty + 16 * i;
        const float cr = cum_s[r];
#pragma unroll
        for (int j = 0; j < RM; ++j) {
          const int col = tx + 16 * j;
          // select before the exponential: never exp of a positive gap
          m_s[r * lay.ldm + col] =
              col <= r ? acc[i][j] * expf(fminf(cr - cum_s[col], 0.0f)) *
                             dt_s[col]
                       : 0.0f;
        }
      }
    }
    __syncthreads();
    // ---- y = exp(cum) C . state + M x ------------------------------------
    {
      float inter[RM][TP], intra[RM][TP];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < TP; ++j) inter[i][j] = intra[i][j] = 0.0f;
      for (int k = 0; k < N; ++k) {
        float av[RM], bv[TP];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = c_s[(ty + 16 * i) * lay.ldc + k];
#pragma unroll
        for (int j = 0; j < TP; ++j) bv[j] = st_s[k * PP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < TP; ++j)
            inter[i][j] = fmaf(av[i], bv[j], inter[i][j]);
      }
      for (int k = 0; k < Q; ++k) {
        float av[RM], bv[TP];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = m_s[(ty + 16 * i) * lay.ldm + k];
#pragma unroll
        for (int j = 0; j < TP; ++j) bv[j] = x_s[k * PP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < TP; ++j)
            intra[i][j] = fmaf(av[i], bv[j], intra[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty + 16 * i;
        if (r >= len) continue;
        const float e = ecum_s[r];
#pragma unroll
        for (int j = 0; j < TP; ++j) {
          const int p = tx + 16 * j;
          if (p < P)
            store(yb + (t0 + r) * ys.s1 + p * ys.s3,
                  fmaf(e, inter[i][j], intra[i][j]));
        }
      }
    }
    __syncthreads();  // every read of the old state is done
    // ---- state^T[n][p] = exp(total) state^T + sum_t B_t[n] w_t x_t[p] ----
    const float etot = expf(total);
    for (int r0 = 0; r0 < N; r0 += Q) {
      float acc[RM][TP];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < TP; ++j) acc[i][j] = 0.0f;
      for (int k = 0; k < Q; ++k) {
        const float wk = w_s[k];
        float av[RM], bv[TP];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          av[i] = bt_s[(r0 + ty + 16 * i) * lay.ldbt + k];
#pragma unroll
        for (int j = 0; j < TP; ++j) bv[j] = x_s[k * PP + tx + 16 * j] * wk;
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < TP; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int n = r0 + ty + 16 * i;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < TP; ++j) {
          float* s = st_s + n * PP + tx + 16 * j;
          *s = fmaf(etot, *s, acc[i][j]);
        }
      }
    }
  }
}

template <int TP>
size_t smem_bytes(int N) {
  const Layout lay(N, 16 * TP);
  return static_cast<size_t>(lay.total + 1) * sizeof(float);
}

template <typename T, int TP>
cudaError_t launch(const void* x, const void* b, const void* c,
                   const float* dt, const float* a_log, void* y, int B,
                   int S, int H, int G, int P, int N, S4 xs, S4 bs, S4 cs,
                   S4 ds, S4 ys, cudaStream_t st) {
  const size_t smem = smem_bytes<TP>(N);
  auto fn = ssd_scan_kernel<T, TP>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fn<<<B * H, THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(c), dt, a_log, static_cast<T*>(y), S, H, G, P,
      N, xs, bs, cs, ds, ys);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* b, const void* c,
                     const float* dt, const float* a_log, void* y, int B,
                     int S, int H, int G, int P, int N, S4 xs, S4 bs, S4 cs,
                     S4 ds, S4 ys, cudaStream_t st) {
  if (P <= 16)
    return launch<T, 1>(x, b, c, dt, a_log, y, B, S, H, G, P, N, xs, bs, cs,
                        ds, ys, st);
  if (P <= 32)
    return launch<T, 2>(x, b, c, dt, a_log, y, B, S, H, G, P, N, xs, bs, cs,
                        ds, ys, st);
  if (P <= 64)
    return launch<T, 4>(x, b, c, dt, a_log, y, B, S, H, G, P, N, xs, bs, cs,
                        ds, ys, st);
  return launch<T, 8>(x, b, c, dt, a_log, y, B, S, H, G, P, N, xs, bs, cs,
                      ds, ys, st);
}


// ---------------------------------------------------------------------------
// "tensor_core": bf16 on mma.sync, cp.async staging (see the header note)
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps, 16 chunk rows each
constexpr int TC_PM = 64;        // widest head: 16 state rows a warp
constexpr int TC_NM = 128;       // widest state: 64 f32 registers a thread
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout in bytes: two stages of (x [Q][P + 8], B and C
// [Q][N + 8] bf16, dt [Q] f32), the bf16 copy of the state [P][N + 8],
// and each warp's own cum and w [2][Q] f32.  Rows are padded by 16 bytes,
// which makes every ldmatrix conflict-free.
struct TcLayout {
  int ldx, ldn;
  int x, b, c, dt, stage, st, warp, total;
  __host__ __device__ TcLayout(int P, int N) {
    ldx = P + 8;
    ldn = N + 8;
    x = 0;
    b = x + Q * ldx * 2;
    c = b + Q * ldn * 2;
    dt = c + Q * ldn * 2;
    stage = dt + Q * 4;
    st = 2 * stage;
    warp = st + P * ldn * 2;
    total = warp + (TC_THREADS / 32) * 2 * Q * 4;
  }
};

// The pair of bf16 values in u, times (s0, s1), rounded to bf16 again.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t u, float s0,
                                                 float s1) {
  const float2 f = tc::unpack_bf16(u);
  return tc::pack_bf16(f.x * s0, f.y * s1);
}

// PM, NM: the widest head and state of this instantiation; EXACT: P == PM
// and N == NM, so every loop bound is a constant.
template <int PM, int NM, bool EXACT>
__global__ void __launch_bounds__(TC_THREADS, 2) ssd_scan_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ bm,
    const __nv_bfloat16* __restrict__ cm, const float* __restrict__ dt,
    const float* __restrict__ a_log, __nv_bfloat16* __restrict__ y, int S,
    int H, int G, int P_rt, int N_rt, S4 xs, S4 bs, S4 cs, S4 ds, S4 ys) {
  const int P = EXACT ? PM : P_rt;
  const int N = EXACT ? NM : N_rt;
  const TcLayout lay(P, N);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* st_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.st);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;
  float* cum_w = reinterpret_cast<float*>(smem_raw + lay.warp) + warp * 2 * Q;
  float* w_w = cum_w + Q;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int grp = h / (H / G);
  const float a = -expf(a_log[h]);
  const __nv_bfloat16* xb = x + b * xs.s0 + h * xs.s2;
  const __nv_bfloat16* bb = bm + b * bs.s0 + grp * bs.s2;
  const __nv_bfloat16* cb = cm + b * cs.s0 + grp * cs.s2;
  const float* db = dt + b * ds.s0 + h * ds.s2;
  __nv_bfloat16* yb = y + b * ys.s0 + h * ys.s2;
  const int n_chunks = (S + Q - 1) / Q;
  const int cpx = P / 8;          // 16-byte chunks of an x row
  const int cpn = N / 8;          // of a B or C row

  // stage chunk ci by 16-byte cp.async (4 bytes for dt); zeros past S.
  // At the exact widths each thread copies a constant number of pieces,
  // so the loops unroll with no remainder handling.
  auto load = [&](int ci) {
    unsigned char* base = smem_raw + (ci & 1) * lay.stage;
    __nv_bfloat16* xd = reinterpret_cast<__nv_bfloat16*>(base + lay.x);
    __nv_bfloat16* bd = reinterpret_cast<__nv_bfloat16*>(base + lay.b);
    __nv_bfloat16* cd = reinterpret_cast<__nv_bfloat16*>(base + lay.c);
    float* dd = reinterpret_cast<float*>(base + lay.dt);
    const int t0 = ci * Q;
    const int len = min(Q, S - t0);
    const __nv_bfloat16* xc = xb + t0 * xs.s1;
    const __nv_bfloat16* bc = bb + t0 * bs.s1;
    const __nv_bfloat16* cc = cb + t0 * cs.s1;
    auto piece_x = [&](int i) {
      const int t = i / cpx;
      const int ch = i - t * cpx;
      const bool in = t < len;
      tc::cp_async16(xd + t * lay.ldx + ch * 8,
                     (in ? xc + t * xs.s1 : xb) + ch * 8, in ? 16 : 0);
    };
    auto piece_bc = [&](int i) {
      const int t = i / cpn;
      const int ch = i - t * cpn;
      const bool in = t < len;
      tc::cp_async16(bd + t * lay.ldn + ch * 8,
                     (in ? bc + t * bs.s1 : bb) + ch * 8, in ? 16 : 0);
      tc::cp_async16(cd + t * lay.ldn + ch * 8,
                     (in ? cc + t * cs.s1 : cb) + ch * 8, in ? 16 : 0);
    };
    if constexpr (EXACT && Q * (PM / 8) % TC_THREADS == 0 &&
                  Q * (NM / 8) % TC_THREADS == 0) {
#pragma unroll
      for (int k = 0; k < Q * (PM / 8) / TC_THREADS; ++k)
        piece_x(tid + k * TC_THREADS);
#pragma unroll
      for (int k = 0; k < Q * (NM / 8) / TC_THREADS; ++k)
        piece_bc(tid + k * TC_THREADS);
    } else {
      for (int i = tid; i < Q * cpx; i += TC_THREADS) piece_x(i);
      for (int i = tid; i < Q * cpn; i += TC_THREADS) piece_bc(i);
    }
    if (tid < Q) {
      const bool in = tid < len;
      const long long row = in ? t0 + tid : 0;
      tc::cp_async4(dd + tid, db + row * ds.s1, in ? 4 : 0);
    }
  };

  for (int i = tid; i < P * lay.ldn / 2; i += TC_THREADS)
    reinterpret_cast<uint32_t*>(st_s)[i] = 0u;    // the state starts at 0
  load(0);
  tc::cp_async_commit();

  // this warp's state rows p = 16 warp + g (+ 8), all N columns, in f32
  float st_acc[NM / 8][4];
#pragma unroll
  for (int i = 0; i < NM / 8; ++i)
    st_acc[i][0] = st_acc[i][1] = st_acc[i][2] = st_acc[i][3] = 0.0f;
  const bool owns = warp * 16 < P;
  const int ra = warp * 16 + g;   // chunk rows of this thread's y and M
  const int rb = ra + 8;
  // ldmatrix offsets: C rows as A; B rows and state rows as B (n-major);
  // x and B as B (k-major, transposed); x^T as A (transposed)
  const int c_off = (warp * 16 + (lane & 15)) * lay.ldn + (lane >> 4) * 8;
  const int n_off = ((lane & 7) + ((lane >> 4) << 3)) * lay.ldn +
                    ((lane >> 3) & 1) * 8;
  const int xt_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * lay.ldx +
                     (lane >> 4) * 8;
  const int bt_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * lay.ldn +
                     (lane >> 4) * 8;
  const int xa_off = ((lane & 7) + ((lane >> 4) << 3)) * lay.ldx +
                     warp * 16 + ((lane >> 3) & 1) * 8;

  for (int ci = 0; ci < n_chunks; ++ci) {
    if (ci + 1 < n_chunks) {
      load(ci + 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();     // chunk ci has landed
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();              // ... for every thread; and the state copy
    unsigned char* base = smem_raw + (ci & 1) * lay.stage;
    const __nv_bfloat16* x_s =
        reinterpret_cast<const __nv_bfloat16*>(base + lay.x);
    const __nv_bfloat16* b_s =
        reinterpret_cast<const __nv_bfloat16*>(base + lay.b);
    __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(base + lay.c);
    const float* dt_s = reinterpret_cast<const float*>(base + lay.dt);

    // ---- cum_t: inclusive running sum of a dt_t (each warp its own copy,
    //      2 rows a lane), and w_t = exp(total - cum_t) dt_t ---------------
    float total;
    {
      const float d0 = dt_s[2 * lane];
      const float d1 = dt_s[2 * lane + 1];
      const float l0 = a * d0;
      const float l1 = a * d1;
      float run = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL, run, off);
        if (lane >= off) run += o;
      }
      const float c0 = run - (l0 + l1) + l0;
      total = __shfl_sync(FULL, run, 31);
      cum_w[2 * lane] = c0 * kLog2e;
      cum_w[2 * lane + 1] = run * kLog2e;
      w_w[2 * lane] = expf(fminf(total - c0, 0.0f)) * d0;
      w_w[2 * lane + 1] = expf(fminf(total - run, 0.0f)) * d1;
      __syncwarp();
    }
    const float cum_a = cum_w[ra];    // in log2 units
    const float cum_b = cum_w[rb];

    // ---- one pass over N: y = C . state^T (the bf16 copy) and the scores
    //      C B^T.  Every warp computes all Q columns j (those past its
    //      diagonal block are masked below): branch-free, so the fragment
    //      loads can be scheduled ahead of the products, and warp 3, which
    //      needs them all, sets the chunk's pace either way ------------
    float yacc[PM / 8][4];
    float sc[Q / 8][4];
#pragma unroll
    for (int i = 0; i < PM / 8; ++i)
      yacc[i][0] = yacc[i][1] = yacc[i][2] = yacc[i][3] = 0.0f;
#pragma unroll
    for (int i = 0; i < Q / 8; ++i)
      sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NM / 16; ++kk) {
      if (!EXACT && kk * 16 >= N) break;
      uint32_t af[4];
      tc::ldsm_x4(af, c_s + c_off + kk * 16);
#pragma unroll
      for (int np = 0; np < PM / 16; ++np) {
        if (!EXACT && np * 16 >= P) break;
        uint32_t bf[4];
        tc::ldsm_x4(bf, st_s + np * 16 * lay.ldn + kk * 16 + n_off);
        tc::mma_bf16(yacc[2 * np], af, bf[0], bf[1]);
        tc::mma_bf16(yacc[2 * np + 1], af, bf[2], bf[3]);
      }
#pragma unroll
      for (int jp = 0; jp < Q / 16; ++jp) {
        uint32_t bf[4];
        tc::ldsm_x4(bf, b_s + jp * 16 * lay.ldn + kk * 16 + n_off);
        tc::mma_bf16(sc[2 * jp], af, bf[0], bf[1]);
        tc::mma_bf16(sc[2 * jp + 1], af, bf[2], bf[3]);
      }
    }
    const float ea = exp2f(cum_a);
    const float eb = exp2f(cum_b);
#pragma unroll
    for (int i = 0; i < PM / 8; ++i) {
      yacc[i][0] *= ea;
      yacc[i][1] *= ea;
      yacc[i][2] *= eb;
      yacc[i][3] *= eb;
    }

    // ---- M[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, in f32,
    //      rounded to bf16 in registers as the A operand of y += M x ------
#pragma unroll
    for (int jp = 0; jp < Q / 16; ++jp) {
      float mv[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = (2 * jp + half) * 8 + 2 * qd + (e & 1);
          const int i = e < 2 ? ra : rb;
          const float ci_ = e < 2 ? cum_a : cum_b;
          // select before the exponential: never exp of a positive gap;
          // the SFU's 2^x (relative error ~2^-22), as M is rounded to
          // bf16 right after
          mv[half][e] =
              j <= i ? sc[2 * jp + half][e] *
                           tc::exp2_approx(fminf(ci_ - cum_w[j], 0.0f)) *
                           dt_s[j]
                     : 0.0f;
        }
      uint32_t ma[4];
      ma[0] = tc::pack_bf16(mv[0][0], mv[0][1]);
      ma[1] = tc::pack_bf16(mv[0][2], mv[0][3]);
      ma[2] = tc::pack_bf16(mv[1][0], mv[1][1]);
      ma[3] = tc::pack_bf16(mv[1][2], mv[1][3]);
#pragma unroll
      for (int np = 0; np < PM / 16; ++np) {
        if (!EXACT && np * 16 >= P) break;
        uint32_t bf[4];
        tc::ldsm_x4_t(bf, x_s + jp * 16 * lay.ldx + np * 16 + xt_off);
        tc::mma_bf16(yacc[2 * np], ma, bf[0], bf[1]);
        tc::mma_bf16(yacc[2 * np + 1], ma, bf[2], bf[3]);
      }
    }

    // ---- y, through this warp's own C rows (read by no other warp, and
    //      done with) as 16-byte stores where a y row fits a C row (P <=
    //      N + 8, as at mamba2's widths), else straight from the fragments
    const int t0 = ci * Q;
    const int len = min(Q, S - t0);
    if (P <= lay.ldn) {
      __syncwarp();
      __nv_bfloat16* y_s = c_s + warp * 16 * lay.ldn;
#pragma unroll
      for (int nt = 0; nt < PM / 8; ++nt) {
        if (!EXACT && nt * 8 >= P) break;
        const int c = nt * 8 + 2 * qd;
        *reinterpret_cast<uint32_t*>(y_s + g * lay.ldn + c) =
            tc::pack_bf16(yacc[nt][0], yacc[nt][1]);
        *reinterpret_cast<uint32_t*>(y_s + (g + 8) * lay.ldn + c) =
            tc::pack_bf16(yacc[nt][2], yacc[nt][3]);
      }
      __syncwarp();
      for (int i = lane; i < 16 * cpx; i += 32) {
        const int r = i / cpx;
        const int ch = i - r * cpx;
        const int t = warp * 16 + r;
        if (t < len)
          *reinterpret_cast<int4*>(yb + (t0 + t) * ys.s1 + ch * 8) =
              *reinterpret_cast<const int4*>(y_s + r * lay.ldn + ch * 8);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < PM / 8; ++nt) {
        if (!EXACT && nt * 8 >= P) break;
        const int c = nt * 8 + 2 * qd;
        if (ra < len)
          *reinterpret_cast<uint32_t*>(yb + (t0 + ra) * ys.s1 + c) =
              tc::pack_bf16(yacc[nt][0], yacc[nt][1]);
        if (rb < len)
          *reinterpret_cast<uint32_t*>(yb + (t0 + rb) * ys.s1 + c) =
              tc::pack_bf16(yacc[nt][2], yacc[nt][3]);
      }
    }

    // ---- state = exp(total) state + (w x)^T B, into the f32 fragments;
    //      w x is rounded to bf16 in registers as the A operand ----------
    if (owns) {
      const float et = expf(total);
#pragma unroll
      for (int i = 0; i < NM / 8; ++i) {
        st_acc[i][0] *= et;
        st_acc[i][1] *= et;
        st_acc[i][2] *= et;
        st_acc[i][3] *= et;
      }
#pragma unroll
      for (int kt = 0; kt < Q / 16; ++kt) {
        uint32_t af[4];
        tc::ldsm_x4_t(af, x_s + kt * 16 * lay.ldx + xa_off);
        const float w0 = w_w[kt * 16 + 2 * qd];
        const float w1 = w_w[kt * 16 + 2 * qd + 1];
        const float w2 = w_w[kt * 16 + 8 + 2 * qd];
        const float w3 = w_w[kt * 16 + 9 + 2 * qd];
        af[0] = scale_bf16x2(af[0], w0, w1);
        af[1] = scale_bf16x2(af[1], w0, w1);
        af[2] = scale_bf16x2(af[2], w2, w3);
        af[3] = scale_bf16x2(af[3], w2, w3);
#pragma unroll
        for (int np = 0; np < NM / 16; ++np) {
          if (!EXACT && np * 16 >= N) break;
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, b_s + kt * 16 * lay.ldn + np * 16 + bt_off);
          tc::mma_bf16(st_acc[2 * np], af, bf[0], bf[1]);
          tc::mma_bf16(st_acc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with the state copy and the stage
    if (owns) {
#pragma unroll
      for (int nt = 0; nt < NM / 8; ++nt) {
        if (!EXACT && nt * 8 >= N) break;
        const int c = nt * 8 + 2 * qd;
        *reinterpret_cast<uint32_t*>(st_s + ra * lay.ldn + c) =
            tc::pack_bf16(st_acc[nt][0], st_acc[nt][1]);
        *reinterpret_cast<uint32_t*>(st_s + rb * lay.ldn + c) =
            tc::pack_bf16(st_acc[nt][2], st_acc[nt][3]);
      }
    }
  }
}

template <bool EXACT>
cudaError_t launch_tc(const void* x, const void* b, const void* c,
                      const float* dt, const float* a_log, void* y, int B,
                      int S, int H, int G, int P, int N, S4 xs, S4 bs, S4 cs,
                      S4 ds, S4 ys, cudaStream_t st) {
  const size_t smem = TcLayout(P, N).total;
  auto fn = ssd_scan_tc_kernel<TC_PM, TC_NM, EXACT>;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fn<<<B * H, TC_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), dt, a_log,
      static_cast<__nv_bfloat16*>(y), S, H, G, P, N, xs, bs, cs, ds, ys);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Shared memory one block of the "cuda_core" design needs at head width P
// and state width N (the wrapper's plan mirrors it, and refuses shapes
// past the 232,448 bytes a block may have).
long long ssd_scan_smem_bytes(int P, int N) {
  if (P <= 16) return smem_bytes<1>(N);
  if (P <= 32) return smem_bytes<2>(N);
  if (P <= 64) return smem_bytes<4>(N);
  return smem_bytes<8>(N);
}

// The "cuda_core" design.  y (B, S, H, P) from x (B, S, H, P), b and c
// (B, S, G, N), dt (B, S, H) float32 and a_log (H,) float32, every tensor
// but a_log reached through its element strides.  dtype 0 is float32, 1
// bfloat16 (x, b, c and y alike).  Needs H % G == 0 and P <= 128.
// Returns the CUDA error code (0 on success).
int ssd_scan_launch(const void* x, const void* b, const void* c,
                    const void* dt, const void* a_log, void* y, int dtype,
                    int B, int S, int H, int G, int P, int N,
                    long long xs0, long long xs1, long long xs2,
                    long long xs3, long long bs0, long long bs1,
                    long long bs2, long long bs3, long long cs0,
                    long long cs1, long long cs2, long long cs3,
                    long long ds0, long long ds1, long long ds2,
                    long long ys0, long long ys1, long long ys2,
                    long long ys3, void* stream) {
  if (G <= 0 || H % G != 0 || P <= 0 || P > 128 || N <= 0 || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  const S4 xs{xs0, xs1, xs2, xs3}, bs{bs0, bs1, bs2, bs3},
      cs{cs0, cs1, cs2, cs3}, ds{ds0, ds1, ds2, 0}, ys{ys0, ys1, ys2, ys3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(a_log);
  if (dtype == 0)
    return dispatch<float>(x, b, c, dtp, al, y, B, S, H, G, P, N, xs, bs, cs,
                           ds, ys, st);
  return dispatch<__nv_bfloat16>(x, b, c, dtp, al, y, B, S, H, G, P, N, xs,
                                 bs, cs, ds, ys, st);
}

// Shared memory of one block of the "tensor_core" design (the wrapper's
// plan mirrors it).
long long ssd_scan_tc_smem_bytes(int P, int N) {
  return TcLayout(P, N).total;
}

// The "tensor_core" design: as ssd_scan_launch, bf16 only (x, b, c, y),
// and needs P, N multiples of 16 with P <= 64, N <= 128, x, b, c and y
// unit-stride in their last dim, and every pointer and other stride of
// theirs 16-byte aligned.  Returns the CUDA error code (0 on success).
int ssd_scan_tc_launch(const void* x, const void* b, const void* c,
                       const void* dt, const void* a_log, void* y, int B,
                       int S, int H, int G, int P, int N, long long xs0,
                       long long xs1, long long xs2, long long xs3,
                       long long bs0, long long bs1, long long bs2,
                       long long bs3, long long cs0, long long cs1,
                       long long cs2, long long cs3, long long ds0,
                       long long ds1, long long ds2, long long ys0,
                       long long ys1, long long ys2, long long ys3,
                       void* stream) {
  const long long strides[12] = {xs0, xs1, xs2, bs0, bs1, bs2,
                                 cs0, cs1, cs2, ys0, ys1, ys2};
  bool ok = G > 0 && H % G == 0 && P >= 16 && P <= TC_PM && P % 16 == 0 &&
            N >= 16 && N <= TC_NM && N % 16 == 0 && xs3 == 1 && bs3 == 1 &&
            cs3 == 1 && ys3 == 1 && aligned16(x) && aligned16(b) &&
            aligned16(c) && aligned16(y);
  for (long long s : strides) ok = ok && s % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || H == 0) return 0;
  const S4 xs{xs0, xs1, xs2, xs3}, bs{bs0, bs1, bs2, bs3},
      cs{cs0, cs1, cs2, cs3}, ds{ds0, ds1, ds2, 0}, ys{ys0, ys1, ys2, ys3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(a_log);
  if (P == TC_PM && N == TC_NM)
    return launch_tc<true>(x, b, c, dtp, al, y, B, S, H, G, P, N, xs, bs, cs,
                           ds, ys, st);
  return launch_tc<false>(x, b, c, dtp, al, y, B, S, H, G, P, N, xs, bs, cs,
                          ds, ys, st);
}

}  // extern "C"
