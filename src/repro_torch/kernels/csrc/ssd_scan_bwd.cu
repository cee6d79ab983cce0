// Gradient of the Mamba-2 SSD scan, hand-written for Hopper (sm_90a), with
// a plain C interface for ctypes.
//
// The reference package has no Pallas kernel for it: the reference trains
// through its plain scan (src/repro/kernels/ref.py ssd_scan_ref) and JAX
// autodiff.  The port's training forward runs the SSD kernel
// (csrc/ssd_scan.cu), so its gradient is this kernel, the port's own,
// behind the torch.autograd.Function of kernels/ops.py ssd_scan.
//
// Per (batch, head), with a = -exp(a_log[h]), the forward is
//   h_t = e^{a dt_t} h_{t-1} + dt_t x_t b_t^T,   y_t = h_t c_t
// with h_t (P, N) and head h reading group g = h / (H / G) of b and c.
// Given dy, the reverse recurrence
//   dh_t = dy_t c_t^T + e^{a dt_{t+1}} dh_{t+1}
// gives
//   dx_t  = dt_t dh_t b_t
//   db_t  = dt_t dh_t^T x_t,  dc_t = h_t^T dy_t   (each summed over the
//                                                 heads of its group)
//   ddt_t = x_t . (dh_t b_t) + a e^{a dt_t} <dh_t, h_{t-1}>
//   da_log = a sum_t dt_t e^{a dt_t} <dh_t, h_{t-1}>  (over batch too).
//
// Design (simple first; every sum in a fixed order, no atomics, so two
// launches are bitwise equal):
//  * ssd_bwd_state_kernel: one block of 8 warps per (batch, head, slice of
//    32 state columns).  Lane l owns column 32 s + l; warp w owns the R
//    rows w R .. w R + R - 1 of the head (P padded to PP = 8 R), so a
//    thread holds R state entries in registers.  The block first runs the
//    forward recurrence over all S steps and writes the state before every
//    chunk of QC steps to a workspace (its own region; the same thread
//    reads back what it wrote).  It then walks the chunks in reverse:
//    the chunk's inputs are staged in shared memory as float32 (x dt, dy,
//    b, c, the decays), and the chunk is cut into sub-chunks of SUB steps
//    whose states are recomputed from the chunk's boundary state and held
//    in registers (SUB R = 64 floats), walking the sub-chunks in reverse,
//    so no state is ever recovered by dividing by a decay (unstable at
//    mamba2's rates, a down to -16).  Each step updates dh in registers
//    and forms per-thread partials: dh b summed over the thread's column
//    (reduced over the warp's 32 lanes by a reduce-scatter butterfly, one
//    row a lane pair), dh x dt and h dy summed over the thread's rows
//    (then over the 8 warps in order), and <dh, h_{t-1}> (warp, then
//    warps).  Each sub-chunk's partials go to the workspace: dh b per
//    (slice, row), <dh, h_{t-1}> per slice, db and dc per head.
//  * ssd_bwd_finish_x (a warp per (batch, step, head)): sums the slices in
//    order into u = dh b, writes dx = dt u in x's dtype, and ddt =
//    x . u + a e^{a dt} <dh, h_{t-1}>; keeps dt e^{a dt} <dh, h_{t-1}>.
//  * ssd_bwd_finish_bc (a thread per (batch, step, group, column)): db and
//    dc summed over the group's heads in head order, in b's dtype.
//  * ssd_bwd_finish_alog (a block per head): da_log = a times the sum of
//    the kept terms over batch and steps, in a fixed tree.
// Any S: steps past S are identity steps (dt = 0, zero x, dy, b, c); rows
// past P and columns past N hold zeros.  Inputs are read through their
// strides (x, b, c as views of the conv output); every product and sum is
// float32.
//
// What bounds it on an H100.  At mamba2-130m's training shape (8 x 1,024
// tokens, H = 24, P = 64, N = 128, bf16) the least work is some 85 MB of
// inputs and outputs (0.025 ms at 3.35 TB/s) and the chunked algorithm's
// products (about 18 GFLOP, 0.018 ms on bf16 tensor cores): the bytes.
// This design is far from either: it walks the 1,024 steps one at a time
// on CUDA cores (about 12 P N FLOPs a step and head, plus the recomputed
// states and the butterflies), 768 blocks of 256 threads, and moves about
// 0.6 GB of workspace (boundary states and per-slice partials).  Each
// warp's step is a chain of dependent FMAs and shuffles, so the kernel is
// bound by latency; the state kernel is held to 128 registers (two
// blocks, 16 warps an SM: 2.84 ms a launch at the training shape against
// 4.43 ms at 199 registers and one block; PERF.md).  It is the simple,
// exact design; a chunked design on tensor cores is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QC = 32;          // steps a staged chunk
constexpr int COLS = 32;        // state columns a block, one a lane
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
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
struct S3 {
  long long s0, s1, s2;
};

// rows a warp (R), padded head width (PP) and steps held in registers
// (SUB) of the state kernel, for R in {2, 4, 8, 16}
template <int R>
struct Rows {
  static constexpr int PP = 8 * R;
  static constexpr int SUB = R <= 8 ? 8 : 4;
  static constexpr int LOG = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
};

// Shared floats of a state block: x dt and dy (QC, PP), b and c (QC,
// COLS), the decays (QC), the per-warp db and dc partials (SUB, WARPS,
// COLS), the row sums of dh b (SUB, PP) and the per-warp <dh, h_{t-1}>
// (SUB, WARPS).
__host__ __device__ constexpr long long state_smem_floats(int PP, int SUB) {
  return 2LL * QC * PP + 2LL * QC * COLS + QC + 2LL * SUB * WARPS * COLS +
         (long long)SUB * PP + (long long)SUB * WARPS;
}

// The workspace, in floats: boundary states (B, H, NS, nck, PP, COLS), dh b
// per slice (B, S, H, NS, P), <dh, h_{t-1}> per slice (B, S, H, NS), db and
// dc per head (B, S, H, N) each, and dt e^{a dt} <dh, h_{t-1}> (B, S, H).
struct Work {
  long long ck, up, gp, bp, cp, dl, total;
};
__host__ __device__ inline Work work_layout(int B, int S, int H, int P,
                                            int N, int PP) {
  const long long NS = (N + COLS - 1) / COLS, nck = (S + QC - 1) / QC;
  const long long BSH = (long long)B * S * H;
  Work w;
  w.ck = 0;
  w.up = w.ck + (long long)B * H * NS * nck * PP * COLS;
  w.gp = w.up + BSH * NS * P;
  w.bp = w.gp + BSH * NS;
  w.cp = w.bp + BSH * N;
  w.dl = w.cp + BSH * N;
  w.total = w.dl + BSH;
  return w;
}

// Sum v[0..R) over the warp's 32 lanes, one row a lane: a reduce-scatter
// butterfly (each stage sends half of the remaining rows to the partner
// lane and keeps the other half), then plain xor stages.  Returns the
// sum of row `row` (the same on every lane of a group of 32 / R).
template <int R>
__device__ __forceinline__ float row_sums(float (&v)[R], int lane,
                                          int& row) {
  row = 0;
#pragma unroll
  for (int s = 0; s < Rows<R>::LOG; ++s) {
    const int half = (R >> s) >> 1;
    const int m = 16 >> s;
    const bool up = lane & m;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = up ? v[j] : v[j + half];
      const float keep = up ? v[j + half] : v[j];
      v[j] = keep + __shfl_xor_sync(FULL, send, m);
    }
    if (up) row += half;
  }
#pragma unroll
  for (int m = 16 >> Rows<R>::LOG; m >= 1; m >>= 1)
    v[0] += __shfl_xor_sync(FULL, v[0], m);
  return v[0];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// Stage chunk k's inputs: x dt and (with_dy) dy, b and (with_dy) c, the
// decays; zeros and identity steps past S, P and N.
template <typename T, int PP>
__device__ void stage(float* sm, int k, bool with_dy, const T* x, const T* b,
                      const T* c, const float* dt, const T* dy, float a,
                      int bb, int h, int g, int ns, int S, int P, int N,
                      S4 xs, S4 bs, S4 cs, S3 ds, S4 ys) {
  float* sxdt = sm;
  float* sdy = sxdt + QC * PP;
  float* sb = sdy + QC * PP;
  float* sc = sb + QC * COLS;
  float* sdec = sc + QC * COLS;
  const int t0 = k * QC;
  for (int i = threadIdx.x; i < QC * PP; i += THREADS) {
    const int q = i / PP, p = i % PP, t = t0 + q;
    float xv = 0.f, dyv = 0.f;
    if (t < S && p < P) {
      const float d = dt[bb * ds.s0 + t * ds.s1 + h * ds.s2];
      xv = to_f32(x[bb * xs.s0 + t * xs.s1 + h * xs.s2 + p * xs.s3]) * d;
      if (with_dy)
        dyv = to_f32(dy[bb * ys.s0 + t * ys.s1 + h * ys.s2 + p * ys.s3]);
    }
    sxdt[i] = xv;
    sdy[i] = dyv;
  }
  for (int i = threadIdx.x; i < QC * COLS; i += THREADS) {
    const int q = i / COLS, n = ns * COLS + i % COLS, t = t0 + q;
    float bv = 0.f, cv = 0.f;
    if (t < S && n < N) {
      bv = to_f32(b[bb * bs.s0 + t * bs.s1 + g * bs.s2 + n * bs.s3]);
      if (with_dy)
        cv = to_f32(c[bb * cs.s0 + t * cs.s1 + g * cs.s2 + n * cs.s3]);
    }
    sb[i] = bv;
    sc[i] = cv;
  }
  for (int q = threadIdx.x; q < QC; q += THREADS) {
    const int t = t0 + q;
    sdec[q] = t < S ? expf(a * dt[bb * ds.s0 + t * ds.s1 + h * ds.s2]) : 1.f;
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(THREADS, 2) ssd_bwd_state_kernel(
    const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ c,
    const float* __restrict__ dt, const float* __restrict__ a_log,
    const T* __restrict__ dy, float* __restrict__ work, int B, int S, int H,
    int G, int P, int N, S4 xs, S4 bs, S4 cs, S3 ds, S4 ys) {
  constexpr int PP = Rows<R>::PP;
  constexpr int SUB = Rows<R>::SUB;
  extern __shared__ float sm[];
  float* sxdt = sm;
  float* sdy = sxdt + QC * PP;
  float* sb = sdy + QC * PP;
  float* sc = sb + QC * COLS;
  float* sdec = sc + QC * COLS;
  float* redb = sdec + QC;
  float* redc = redb + SUB * WARPS * COLS;
  float* su = redc + SUB * WARPS * COLS;
  float* sg = su + SUB * PP;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int NS = (N + COLS - 1) / COLS;
  int blk = blockIdx.x;
  const int ns = blk % NS;
  blk /= NS;
  const int h = blk % H, bb = blk / H;
  const int g = h / (H / G);
  const int p0 = w * R;
  const float a = -expf(a_log[h]);
  const int nck = (S + QC - 1) / QC;
  const Work wl = work_layout(B, S, H, P, N, PP);
  float* ck = work + wl.ck +
              (((long long)bb * H + h) * NS + ns) * nck * (PP * COLS);
  float* up = work + wl.up;
  float* gp = work + wl.gp;
  float* bp = work + wl.bp;
  float* cp = work + wl.cp;

  // forward: the state before every chunk
  float hr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) hr[r] = 0.f;
  for (int k = 0; k < nck; ++k) {
    float* dst = ck + (long long)k * PP * COLS + p0 * COLS + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[r * COLS] = hr[r];
    __syncthreads();
    stage<T, PP>(sm, k, false, x, b, c, dt, dy, a, bb, h, g, ns, S, P, N, xs,
                 bs, cs, ds, ys);
    __syncthreads();
    for (int q = 0; q < QC; ++q) {
      const float d = sdec[q], bq = sb[q * COLS + lane];
#pragma unroll
      for (int r = 0; r < R; ++r)
        hr[r] = fmaf(d, hr[r], sxdt[q * PP + p0 + r] * bq);
    }
  }

  // reverse
  float dh[R];
#pragma unroll
  for (int r = 0; r < R; ++r) dh[r] = 0.f;
  float dnext = 1.f;  // the decay of the step after the current one
  const int wmask = 32 / R - 1;
  for (int k = nck - 1; k >= 0; --k) {
    __syncthreads();
    stage<T, PP>(sm, k, true, x, b, c, dt, dy, a, bb, h, g, ns, S, P, N, xs,
                 bs, cs, ds, ys);
    __syncthreads();
    // the chunk's boundary state, as this thread wrote it
    const float* src = ck + (long long)k * PP * COLS + p0 * COLS + lane;
    for (int j = QC / SUB - 1; j >= 0; --j) {
      // the state before sub-chunk j, then its SUB states
      float hp[R];
#pragma unroll
      for (int r = 0; r < R; ++r) hp[r] = src[r * COLS];
      for (int q = 0; q < j * SUB; ++q) {
        const float d = sdec[q], bq = sb[q * COLS + lane];
#pragma unroll
        for (int r = 0; r < R; ++r)
          hp[r] = fmaf(d, hp[r], sxdt[q * PP + p0 + r] * bq);
      }
      float hs[SUB][R];
#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        const int q = j * SUB + i;
        const float d = sdec[q], bq = sb[q * COLS + lane];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float prev = i == 0 ? hp[r] : hs[i == 0 ? 0 : i - 1][r];
          hs[i][r] = fmaf(d, prev, sxdt[q * PP + p0 + r] * bq);
        }
      }
#pragma unroll
      for (int i = SUB - 1; i >= 0; --i) {
        const int q = j * SUB + i;
        const float bq = sb[q * COLS + lane], cq = sc[q * COLS + lane];
        float u[R];
        float dbp = 0.f, dcp = 0.f, gpp = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float dyr = sdy[q * PP + p0 + r];
          dh[r] = fmaf(dnext, dh[r], dyr * cq);
          const float prev = i == 0 ? hp[r] : hs[i == 0 ? 0 : i - 1][r];
          u[r] = dh[r] * bq;
          dbp = fmaf(dh[r], sxdt[q * PP + p0 + r], dbp);
          dcp = fmaf(hs[i][r], dyr, dcp);
          gpp = fmaf(dh[r], prev, gpp);
        }
        int row;
        const float us = row_sums<R>(u, lane, row);
        if ((lane & wmask) == 0) su[i * PP + p0 + row] = us;
        gpp = warp_sum(gpp);
        if (lane == 0) sg[i * WARPS + w] = gpp;
        redb[(i * WARPS + w) * COLS + lane] = dbp;
        redc[(i * WARPS + w) * COLS + lane] = dcp;
        dnext = sdec[q];
      }
      __syncthreads();
      // the sub-chunk's partials, warps summed in order
      const int ts = k * QC + j * SUB;
      for (int i2 = threadIdx.x; i2 < SUB * COLS; i2 += THREADS) {
        const int i = i2 / COLS, l = i2 % COLS, t = ts + i;
        const int n = ns * COLS + l;
        if (t < S && n < N) {
          float sbv = 0.f, scv = 0.f;
#pragma unroll
          for (int ww = 0; ww < WARPS; ++ww) {
            sbv += redb[(i * WARPS + ww) * COLS + l];
            scv += redc[(i * WARPS + ww) * COLS + l];
          }
          const long long o = (((long long)bb * S + t) * H + h) * N + n;
          bp[o] = sbv;
          cp[o] = scv;
        }
      }
      for (int i2 = threadIdx.x; i2 < SUB * PP; i2 += THREADS) {
        const int i = i2 / PP, p = i2 % PP, t = ts + i;
        if (t < S && p < P)
          up[((((long long)bb * S + t) * H + h) * NS + ns) * P + p] = su[i2];
      }
      for (int i = threadIdx.x; i < SUB; i += THREADS) {
        const int t = ts + i;
        if (t < S) {
          float s = 0.f;
#pragma unroll
          for (int ww = 0; ww < WARPS; ++ww) s += sg[i * WARPS + ww];
          gp[(((long long)bb * S + t) * H + h) * NS + ns] = s;
        }
      }
      __syncthreads();
    }
  }
}

// A warp per (batch, step, head): dx, ddt and the kept decay term.
template <typename T>
__global__ void __launch_bounds__(256) ssd_bwd_finish_x(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a_log, float* __restrict__ work,
    T* __restrict__ dx, float* __restrict__ ddt, int B, int S, int H, int P,
    int N, int PP, S4 xs, S3 ds) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= (long long)B * S * H) return;
  const int h = row % H;
  const long long bt = row / H;
  const int t = bt % S, bb = bt / S;
  const int NS = (N + COLS - 1) / COLS;
  const Work wl = work_layout(B, S, H, P, N, PP);
  const float* up = work + wl.up + row * NS * P;
  const float dtv = dt[bb * ds.s0 + t * ds.s1 + h * ds.s2];
  float xu = 0.f;
  for (int p = lane; p < P; p += 32) {
    float u = 0.f;
    for (int s = 0; s < NS; ++s) u += up[s * P + p];
    store(dx + row * P + p, dtv * u);
    xu = fmaf(to_f32(x[bb * xs.s0 + t * xs.s1 + h * xs.s2 + p * xs.s3]), u,
              xu);
  }
  xu = warp_sum(xu);
  if (lane == 0) {
    const float* gp = work + wl.gp + row * NS;
    float gs = 0.f;
    for (int s = 0; s < NS; ++s) gs += gp[s];
    const float a = -expf(a_log[h]);
    const float e = expf(a * dtv);
    ddt[row] = xu + a * e * gs;
    (work + wl.dl)[row] = dtv * e * gs;
  }
}

// A thread per (batch, step, group, column): db and dc over the group's
// heads in head order.
template <typename T>
__global__ void __launch_bounds__(256) ssd_bwd_finish_bc(
    const float* __restrict__ work, T* __restrict__ db, T* __restrict__ dc,
    int B, int S, int H, int G, int P, int N, int PP) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * S * G * N) return;
  const int n = i % N;
  const int g = (i / N) % G;
  const long long bt = i / ((long long)N * G);
  const int rep = H / G;
  const Work wl = work_layout(B, S, H, P, N, PP);
  float sb = 0.f, sc = 0.f;
  for (int j = 0; j < rep; ++j) {
    const long long o = (bt * H + g * rep + j) * N + n;
    sb += work[wl.bp + o];
    sc += work[wl.cp + o];
  }
  store(db + i, sb);
  store(dc + i, sc);
}

// A block per head: da_log = a times the kept terms summed over batch and
// steps (each thread a strided run in order, then a shared-memory tree).
__global__ void __launch_bounds__(256) ssd_bwd_finish_alog(
    const float* __restrict__ work, const float* __restrict__ a_log,
    float* __restrict__ da_log, int B, int S, int H, int P, int N, int PP) {
  __shared__ float red[256];
  const int h = blockIdx.x;
  const Work wl = work_layout(B, S, H, P, N, PP);
  const float* dl = work + wl.dl;
  const long long rows = (long long)B * S;
  float s = 0.f;
  for (long long r = threadIdx.x; r < rows; r += 256) s += dl[r * H + h];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int m = 128; m >= 1; m >>= 1) {
    if (threadIdx.x < m) red[threadIdx.x] += red[threadIdx.x + m];
    __syncthreads();
  }
  if (threadIdx.x == 0) da_log[h] = -expf(a_log[h]) * red[0];
}

template <typename T, int R>
cudaError_t launch_rows(const void* x, const void* b, const void* c,
                        const void* dt, const void* a_log, const void* dy,
                        void* dx, void* db, void* dc, void* ddt,
                        void* da_log, void* work, int B, int S, int H, int G,
                        int P, int N, S4 xs, S4 bs, S4 cs, S3 ds, S4 ys,
                        cudaStream_t st) {
  constexpr int PP = Rows<R>::PP;
  const long long smem = state_smem_floats(PP, Rows<R>::SUB) * 4;
  auto kern = ssd_bwd_state_kernel<T, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int NS = (N + COLS - 1) / COLS;
  kern<<<B * H * NS, THREADS, smem, st>>>(
      (const T*)x, (const T*)b, (const T*)c, (const float*)dt,
      (const float*)a_log, (const T*)dy, (float*)work, B, S, H, G, P, N, xs,
      bs, cs, ds, ys);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long rows = (long long)B * S * H;
  ssd_bwd_finish_x<T><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const T*)x, (const float*)dt, (const float*)a_log, (float*)work,
      (T*)dx, (float*)ddt, B, S, H, P, N, PP, xs, ds);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long cols = (long long)B * S * G * N;
  ssd_bwd_finish_bc<T><<<(unsigned)((cols + 255) / 256), 256, 0, st>>>(
      (const float*)work, (T*)db, (T*)dc, B, S, H, G, P, N, PP);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_finish_alog<<<H, 256, 0, st>>>((const float*)work,
                                         (const float*)a_log,
                                         (float*)da_log, B, S, H, P, N, PP);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int PP, const void* x, const void* b, const void* c,
                     const void* dt, const void* a_log, const void* dy,
                     void* dx, void* db, void* dc, void* ddt, void* da_log,
                     void* work, int B, int S, int H, int G, int P, int N,
                     S4 xs, S4 bs, S4 cs, S3 ds, S4 ys, cudaStream_t st) {
  switch (PP) {
    case 16:
      return launch_rows<T, 2>(x, b, c, dt, a_log, dy, dx, db, dc, ddt,
                               da_log, work, B, S, H, G, P, N, xs, bs, cs, ds,
                               ys, st);
    case 32:
      return launch_rows<T, 4>(x, b, c, dt, a_log, dy, dx, db, dc, ddt,
                               da_log, work, B, S, H, G, P, N, xs, bs, cs, ds,
                               ys, st);
    case 64:
      return launch_rows<T, 8>(x, b, c, dt, a_log, dy, dx, db, dc, ddt,
                               da_log, work, B, S, H, G, P, N, xs, bs, cs, ds,
                               ys, st);
    case 128:
      return launch_rows<T, 16>(x, b, c, dt, a_log, dy, dx, db, dc, ddt,
                                da_log, work, B, S, H, G, P, N, xs, bs, cs,
                                ds, ys, st);
    default:
      return cudaErrorInvalidValue;
  }
}

int padded_rows(int P) {
  for (int pp = 16; pp <= 128; pp *= 2)
    if (P <= pp) return pp;
  return 0;
}

}  // namespace

extern "C" {

// Shared bytes of a state block at head width P (0 past 128).
long long ssd_scan_bwd_smem_bytes(int P) {
  const int PP = padded_rows(P);
  if (PP == 0) return 0;
  return state_smem_floats(PP, PP <= 64 ? 8 : 4) * 4;
}

// Floats of the workspace the wrapper allocates (0 past P = 128).
long long ssd_scan_bwd_work_floats(int B, int S, int H, int P, int N) {
  const int PP = padded_rows(P);
  if (PP == 0) return 0;
  return work_layout(B, S, H, P, N, PP).total;
}

// x, b, c, dy in float32 (dtype 0) or bf16 (1) through their strides; dt
// (B, S, H) and a_log (H,) float32; dx (B, S, H, P) and db, dc (B, S, G, N)
// contiguous in x's dtype, ddt (B, S, H) and da_log (H,) float32; work of
// ssd_scan_bwd_work_floats floats.  Returns a cudaError_t.
int ssd_scan_bwd_launch(const void* x, const void* b, const void* c,
                        const void* dt, const void* a_log, const void* dy,
                        void* dx, void* db, void* dc, void* ddt,
                        void* da_log, void* work, int dtype, int B, int S,
                        int H, int G, int P, int N, long long xs0,
                        long long xs1, long long xs2, long long xs3,
                        long long bs0, long long bs1, long long bs2,
                        long long bs3, long long cs0, long long cs1,
                        long long cs2, long long cs3, long long ds0,
                        long long ds1, long long ds2, long long ys0,
                        long long ys1, long long ys2, long long ys3,
                        void* stream) {
  const int PP = padded_rows(P);
  if (PP == 0 || G <= 0 || H % G != 0 || B <= 0 || S <= 0 || N <= 0)
    return (int)cudaErrorInvalidValue;
  const S4 xs{xs0, xs1, xs2, xs3}, bs{bs0, bs1, bs2, bs3},
      cs{cs0, cs1, cs2, cs3}, ys{ys0, ys1, ys2, ys3};
  const S3 ds{ds0, ds1, ds2};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      dtype == 0
          ? launch_t<float>(PP, x, b, c, dt, a_log, dy, dx, db, dc, ddt,
                            da_log, work, B, S, H, G, P, N, xs, bs, cs, ds,
                            ys, st)
          : launch_t<__nv_bfloat16>(PP, x, b, c, dt, a_log, dy, dx, db, dc,
                                    ddt, da_log, work, B, S, H, G, P, N, xs,
                                    bs, cs, ds, ys, st);
  return (int)err;
}

}  // extern "C"
