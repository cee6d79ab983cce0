// Mamba-2 SSD chunked scan, hand-written for Hopper (sm_90a), with a plain
// C interface for ctypes.
//
// Replaces the Pallas TPU kernel of the reference package:
//   ssd_scan_kernel <- src/repro/kernels/ssd_scan.py ssd_scan_pallas
//                      (_ssd_kernel).
// It computes what _ssd_kernel computes, for one (batch, head) and one
// chunk of Q steps at a time, with lam_t = a dt_t, a = -exp(a_log[h]) and
// cum_t the running sum of lam inside the chunk:
//   y_t    = exp(cum_t) C_t . state
//          + sum_{j <= t} (C_t . B_j) exp(cum_t - cum_j) dt_j x_j
//   state' = exp(cum_Q) state + sum_t exp(cum_Q - cum_t) dt_t x_t B_t^T
// with x (B, S, H, P), B and C (B, S, G, N) read at group h / (H / G),
// dt (B, S, H) and a_log (H,) in float32, the (P, N) state and every
// product in float32, and y (B, S, H, P) in x's dtype.
//
// What bounds it on an H100.  At the embedder's shapes (64 x 1,024 tokens,
// H = 24, P = 64, N = 128, bf16) the chunked algorithm does about 90 GFLOP
// a launch at Q = 64 against some 440 MB of traffic: about 200 FLOP a
// byte, so operations, at the float32 CUDA-core rate this kernel uses.
//
// Design (simple and right first; not tuned):
//  * one block of 256 threads per (batch, head); the TPU kernel's
//    sequential chunk grid axis is the loop over chunks inside the block,
//    and the state stays in shared memory across it, as in VMEM scratch;
//  * internal chunk Q = 64, not the TPU kernel's 128: at Q = 128 the
//    float32 tiles of B, C, x, the state and C B^T would need about
//    230 KB, past the 227 KB a block may have; at Q = 64 they need
//    133 KB and the quadratic (C B^T) work halves.  The chunk length
//    changes only the rounding, not the function;
//  * groups: B and C are read at group h / (H / G) through their strides;
//    nothing is repeated to the heads;
//  * the decay is selected before the exponential: only i >= j takes
//    exp(min(cum_i - cum_j, 0)); the TPU kernel's exp-then-mask would
//    give inf * 0 = NaN for i < j at mamba2's decay rates (a down to -16);
//  * any S: the last chunk is masked (dt = 0 and zero x, B, C past S,
//    identity steps), nothing is padded by the caller;
//  * each small product runs from shared memory with a 16 x 16 thread
//    grid, a thread owning rows ty + 16 i and columns tx + 16 j, so rows
//    are read as broadcasts and columns from consecutive banks.  All
//    float32 FMAs on CUDA cores; no tensor cores, no cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

extern "C" {

// Shared memory one block needs at head width P and state width N (the
// wrapper refuses shapes past the 232,448 bytes a block may have).
long long ssd_scan_smem_bytes(int P, int N) {
  if (P <= 16) return smem_bytes<1>(N);
  if (P <= 32) return smem_bytes<2>(N);
  if (P <= 64) return smem_bytes<4>(N);
  return smem_bytes<8>(N);
}

// y (B, S, H, P) from x (B, S, H, P), b and c (B, S, G, N), dt (B, S, H)
// float32 and a_log (H,) float32, every tensor but a_log reached through
// its element strides.  dtype 0 is float32, 1 bfloat16 (x, b, c and y
// alike).  Needs H % G == 0 and P <= 128.  Returns the CUDA error code
// (0 on success).
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

}  // extern "C"
