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
// Two designs; the wrapper's bwd_plan (kernels/ssd_scan.py) picks one by
// dtype, widths and alignment, never after a failure.  Both are
// deterministic: no atomics, every output element has one owner and every
// sum runs in a fixed order, so two launches are bitwise equal.  Any S:
// steps past S are identity steps (dt = 0, zero x, dy, b, c).  Inputs are
// read through their strides (x, b, c as views of the conv output).
//
// What bounds it on an H100.  At mamba2-130m's training shape (8 x 1,024
// tokens, H = 24, P = 64, N = 128, bf16) the least work is some 85 MB of
// inputs and outputs (0.025 ms at 3.35 TB/s) and the chunked algorithm's
// products on bf16 tensor cores: the two terms are close (chip_smoke.py
// prints both).
//
// "tensor_core" (bf16, P and N multiples of 16 with P <= 64 and N <= 128,
// every pointer and stride of x, b, c, dy 16-byte aligned: mamba2-130m's
// training step).  The chunked decomposition of the Mamba-2 authors' SSD
// backward (arXiv:2405.21060, section 6), at the forward's chunk Q = 64,
// with lam_t = a dt_t, cum_t its running sum inside the chunk, total =
// cum_{Q-1}, L_tj = exp(cum_t - cum_j) for j <= t, h0 the state entering
// the chunk and G the gradient into the state leaving it.  Four kernels,
// one launch of the wrapper:
//  1. ssd_bwd_tc_states, a block per (batch, head, direction), walks the
//     chunks in order as the forward kernel does, the (P, N) f32 state in
//     the warps' accumulator fragments: forward, it writes h0 at each
//     chunk and adds the chunk's end state, h0' = exp(total) h0 + s, s =
//     sum_t exp(total - cum_t) dt_t x_t b_t^T; backward, it writes G and
//     adds the chunk's start gradient, G' = exp(total) G + r, r = sum_t
//     exp(cum_t) dy_t c_t^T.  Each is a (P, Q) x (Q, N) product on
//     mma.sync m16n8k16 (bf16 -> f32), the scaled rows split into a bf16
//     hi + lo pair (two products).  Walking the chunks in order writes
//     each boundary state once: s and r per chunk in parallel and an
//     elementwise pass over the states moved 600 MB more and took 0.35 ms
//     at the training shape (PERF.md);
//  2. ssd_bwd_tc_chunk, a block per (batch, head, chunk), 4 warps each
//     owning 16 chunk rows: the scores C B^T and dY X^T (the model's bf16
//     tensors, exact operands, f32 sums), then on their fragments M1 = CB L
//     and M2 = DX L dt_j and T / dt_j = CB L DX in f32 (its row and column
//     sums);
//       dc = exp(cum) dY h0 + M2 B           (rows t: M2 from registers)
//       u  = exp(total - cum) B G^T + M1^T dY, dx = dt u   (rows j)
//       db = exp(total - cum) dt X G + M2^T C               (rows j)
//     (M1, then M2, through shared memory for the transposes).  Every f32
//     operand -- h0, G, M1, M2 -- enters as a bf16 hi + lo pair (two
//     products): one bf16 rounding of a state would cost ddt its 1e-3,
//     and one of M2 costs db and dc, summed over 24 heads, more than the
//     card tests' 0.05 on small values; then dcum_t = rowsum(T)
//     - colsum(T) + exp(cum_t) dy_t^T h0 c_t - v_t, v_t = exp(total -
//     cum_t) dt_t x_t^T G b_t, plus exp(total) <G, h0> + sum_t v_t at t =
//     Q - 1; dlam is its reverse running sum in the chunk, ddt = x . u +
//     a dlam, where x . u = colsum(T / dt) + exp(total - cum) x^T G b comes
//     from f32 terms only (not from M1's products), and the chunk's sum of
//     dt dlam is kept for da_log.  The decay is selected before the
//     exponential (only j <= t takes exp(min(cum_t - cum_j, 0))), and no
//     state is ever recovered by dividing by a decay;
//  3. ssd_bwd_finish_bc and ssd_bwd_finish_alog: db and dc over a group's
//     heads in head order, da_log over batch and chunks in a fixed tree.
// The workspace holds h0 and G in f32 (B, H, nc, P, N) each and the
// per-head db and dc (B, S, H, N) each: 403 MB at the training shape.
// ref.ssd_scan_bwd_chunked_ref is this decomposition in plain PyTorch,
// with the same rounding points.
//
// "cuda_core" (float32, whose 1e-4 tolerances need f32 products, and any
// bf16 input the tensor-core design does not take): the first, simple
// design.  It walks the steps one at a time:
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
//  * ssd_bwd_finish_bc and ssd_bwd_finish_alog as above.
// Every product and sum is float32.  Rows past P and columns past N hold
// zeros.  It is bound by latency: each warp's step is a chain of dependent
// FMAs and shuffles (12 P N FLOPs a step and head, plus the recomputed
// states and the butterflies), 768 blocks of 256 threads at the training
// shape, about 0.6 GB of workspace; the state kernel is held to 128
// registers (two blocks, 16 warps an SM: 2.84 ms a launch at the training
// shape in bf16 against 4.43 ms at 199 registers; PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

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
// heads in head order, from the per-head partials bp and cp (B, S, H, N).
template <typename T>
__global__ void __launch_bounds__(256) ssd_bwd_finish_bc(
    const float* __restrict__ bp, const float* __restrict__ cp,
    T* __restrict__ db, T* __restrict__ dc, int B, int S, int H, int G,
    int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * S * G * N) return;
  const int n = i % N;
  const int g = (i / N) % G;
  const long long bt = i / ((long long)N * G);
  const int rep = H / G;
  float sb = 0.f, sc = 0.f;
  for (int j = 0; j < rep; ++j) {
    const long long o = (bt * H + g * rep + j) * N + n;
    sb += bp[o];
    sc += cp[o];
  }
  store(db + i, sb);
  store(dc + i, sc);
}

// A block per head: da_log = a times the kept terms dl (rows, H) summed
// over the rows (batch and steps, or batch and chunks): each thread a
// strided run in order, then a shared-memory tree.
__global__ void __launch_bounds__(256) ssd_bwd_finish_alog(
    const float* __restrict__ dl, const float* __restrict__ a_log,
    float* __restrict__ da_log, long long rows, int H) {
  __shared__ float red[256];
  const int h = blockIdx.x;
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
  const Work wl = work_layout(B, S, H, P, N, PP);
  const float* wf = (const float*)work;
  const long long cols = (long long)B * S * G * N;
  ssd_bwd_finish_bc<T><<<(unsigned)((cols + 255) / 256), 256, 0, st>>>(
      wf + wl.bp, wf + wl.cp, (T*)db, (T*)dc, B, S, H, G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_finish_alog<<<H, 256, 0, st>>>(wf + wl.dl, (const float*)a_log,
                                         (float*)da_log, (long long)B * S,
                                         H);
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

// ---------------------------------------------------------------------------
// "tensor_core": the chunked backward on mma.sync (see the header note)
// ---------------------------------------------------------------------------

constexpr int TQ = 64;           // steps a chunk (the forward's CHUNK)
constexpr int TC_THREADS = 128;  // 4 warps, 16 chunk (or state) rows each
constexpr int TC_PM = 64;        // widest head
constexpr int TC_NM = 128;       // widest state
constexpr float kLog2e = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

// The workspace of the tensor-core design, in floats: the states h0 and G
// at every chunk boundary (B, H, nc, P, N) each, db and dc per head
// (B, S, H, N) each, and each chunk's sum of dt dlam (B, nc, H).
struct TcWork {
  long long st, gr, bp, cp, dl, total;
};
__host__ __device__ inline TcWork tc_work_layout(int B, int S, int H, int P,
                                                 int N) {
  const long long nc = (S + TQ - 1) / TQ;
  const long long states = (long long)B * H * nc * P * N;
  const long long bshn = (long long)B * S * H * N;
  TcWork w;
  w.st = 0;
  w.gr = w.st + states;
  w.bp = w.gr + states;
  w.cp = w.bp + bshn;
  w.dl = w.cp + bshn;
  w.total = w.dl + (long long)B * H * nc;
  return w;
}

// Shared bytes of a stage of the states kernel's ring: bf16 x or dy
// [Q][P + 8], b or c [Q][N + 8], f32 dt [Q]; the block has two, then
// each warp's row weights [Q].
__host__ __device__ inline int tc_states_stage(int P, int N) {
  return TQ * (P + 8) * 2 + TQ * (N + 8) * 2 + TQ * 4;
}
__host__ __device__ inline int tc_states_smem(int P, int N) {
  return 2 * tc_states_stage(P, N) + (TC_THREADS / 32) * TQ * 4;
}

// Shared layout of a chunk block, in bytes: bf16 x and dy [Q][P + 8], b
// and c [Q][N + 8], the hi and lo halves of h0 (then G) [P][N + 8] and of
// M1 (then M2) [Q][Q + 8]; f32 dt, cum (log2 units), the row sums of T,
// each warp's column sums of T / dt [4][Q], exp(cum) dy^T h0 c and
// exp(total - cum) x^T G b [Q] each, and 8 floats for reductions.  Rows
// are padded by 16 bytes: every ldmatrix is conflict-free.
struct TcLayout {
  int ldx, ldn, ldq;
  int x, dy, b, c, hh, hl, mh, ml, dt, cum, rowt, colp, dc1, xbg, red, total;
  __host__ __device__ TcLayout(int P, int N) {
    ldx = P + 8;
    ldn = N + 8;
    ldq = TQ + 8;
    x = 0;
    dy = x + TQ * ldx * 2;
    b = dy + TQ * ldx * 2;
    c = b + TQ * ldn * 2;
    hh = c + TQ * ldn * 2;
    hl = hh + P * ldn * 2;
    mh = hl + P * ldn * 2;
    ml = mh + TQ * ldq * 2;
    dt = ml + TQ * ldq * 2;
    cum = dt + TQ * 4;
    rowt = cum + TQ * 4;
    colp = rowt + TQ * 4;
    dc1 = colp + 4 * TQ * 4;
    xbg = dc1 + TQ * 4;
    red = xbg + TQ * 4;
    total = red + 8 * 4;
  }
};

// ldmatrix row offsets, for lane l of a .x4 load of a 16 x 16 tile at a
// row pitch of ld elements: A from row-major storage (off_a); B from
// n-major storage, or A transposed from k-major storage (off_n: the two
// use the same addresses, .trans for the latter); B from k-major storage
// with .trans (off_k).
__device__ __forceinline__ int off_a(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int off_n(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int off_k(int lane, int ld) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + (lane >> 4) * 8;
}

// Two f32 values as a bf16 hi + lo pair of packed registers.
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tc::pack_bf16(v0, v1);
  const float2 r = tc::unpack_bf16(hi);
  lo = tc::pack_bf16(v0 - r.x, v1 - r.y);
}

// The pair of bf16 values in u times (s0, s1) in f32, as a bf16 hi + lo
// pair (two operands whose sum is the f32 product to about 2^-17).
__device__ __forceinline__ void split_scale(uint32_t u, float s0, float s1,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f = tc::unpack_bf16(u);
  split_pair(f.x * s0, f.y * s1, hi, lo);
}

// Stage a chunk's Q rows of `width` bf16 values (a multiple of 8; WM the
// widest) from src (row stride s1, unit-stride rows) into dst [Q][width +
// 8] by 16-byte cp.async, zeros past len (identity steps).  At the exact
// widths each thread copies a constant number of pieces, unrolled.
template <int WM, bool EXACT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long s1, int width, int t0,
                                           int len) {
  const int cp = width / 8, ld = width + 8;
  auto piece = [&](int i) {
    const int t = i / cp, ch = i - t * cp;
    const bool in = t < len;
    const long long r = in ? t0 + t : 0;
    tc::cp_async16(dst + t * ld + ch * 8, src + r * s1 + ch * 8,
                   in ? 16 : 0);
  };
  if constexpr (EXACT && TQ * (WM / 8) % TC_THREADS == 0) {
#pragma unroll
    for (int k = 0; k < TQ * (WM / 8) / TC_THREADS; ++k)
      piece(threadIdx.x + k * TC_THREADS);
  } else {
    for (int i = threadIdx.x; i < TQ * cp; i += TC_THREADS) piece(i);
  }
}

// ... and the chunk's dt [Q] by 4-byte cp.async, zeros past len.
__device__ __forceinline__ void stage_dt(float* dst, const float* src,
                                         long long s1, int t0, int len) {
  if (threadIdx.x < TQ) {
    const bool in = threadIdx.x < len;
    const long long r = in ? t0 + threadIdx.x : 0;
    tc::cp_async4(dst + threadIdx.x, src + r * s1, in ? 4 : 0);
  }
}

// cum_t, the running sum of a dt_t over the chunk, for t = 2 lane and
// 2 lane + 1 (one warp); returns the total.
__device__ __forceinline__ float chunk_cum(const float* dt_s, float a,
                                           int lane, float& c0, float& c1) {
  const float l0 = a * dt_s[2 * lane];
  const float l1 = a * dt_s[2 * lane + 1];
  float run = l0 + l1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, run, off);
    if (lane >= off) run += o;
  }
  c0 = run - (l0 + l1) + l0;
  c1 = run;
  return __shfl_sync(FULL, run, 31);
}

// Kernel 1, a block per (batch, head, direction): the state passing.
// Direction 0 walks the chunks forward and writes h0, the state entering
// each chunk, then adds the chunk's end state: h0' = exp(total) h0 + s,
// s = sum_t exp(total - cum_t) dt_t x_t b_t^T.  Direction 1 walks them
// backward and writes G, the gradient into the state leaving each chunk,
// then adds the chunk's start gradient: G' = exp(total) G + r, r = sum_t
// exp(cum_t) dy_t c_t^T.  As in the forward kernel, the (P, N) f32 state
// lives in the warps' accumulator fragments (warp w owns rows 16 w ..,
// all N columns) and the chunks arrive through a two-stage cp.async ring;
// each step's row of the A operand (x or dy, transposed by ldmatrix) is
// scaled in f32 and split into a bf16 hi + lo pair (two products each).
template <int PM, int NM, bool EXACT>
__global__ void __launch_bounds__(TC_THREADS) ssd_bwd_tc_states(
    const bf16* __restrict__ x, const bf16* __restrict__ b,
    const bf16* __restrict__ c, const float* __restrict__ dt,
    const float* __restrict__ a_log, const bf16* __restrict__ dy,
    float* __restrict__ work, int B, int S, int H, int G, int P_rt,
    int N_rt, S4 xs, S4 bs, S4 cs, S3 ds, S4 ys) {
  const int P = EXACT ? PM : P_rt;
  const int N = EXACT ? NM : N_rt;
  const int ldx = P + 8, ldn = N + 8;
  const int stage = tc_states_stage(P, N);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  float* w_w = reinterpret_cast<float*>(smem_raw + 2 * stage) + warp * TQ;
  const int dir = blockIdx.x & 1;
  const int bh = blockIdx.x >> 1;
  const int h = bh % H, bb = bh / H;
  const int grp = h / (H / G);
  const float a = -expf(a_log[h]);
  const int nc = (S + TQ - 1) / TQ;
  const TcWork wl = tc_work_layout(B, S, H, P, N);
  float* out = work + (dir == 0 ? wl.st : wl.gr) + (long long)bh * nc * P * N;
  // direction 0 reads x and b, direction 1 dy and c
  const bf16* ab = dir == 0 ? x + bb * xs.s0 + h * xs.s2
                            : dy + bb * ys.s0 + h * ys.s2;
  const long long as1 = dir == 0 ? xs.s1 : ys.s1;
  const bf16* bbase = dir == 0 ? b + bb * bs.s0 + grp * bs.s2
                               : c + bb * cs.s0 + grp * cs.s2;
  const long long bs1 = dir == 0 ? bs.s1 : cs.s1;
  const float* dtb = dt + bb * ds.s0 + h * ds.s2;

  // stage chunk ci into ring slot k: A [Q][P + 8], B [Q][N + 8], dt [Q]
  auto load = [&](int ci, int k) {
    bf16* ad = reinterpret_cast<bf16*>(smem_raw + k * stage);
    bf16* bd = ad + TQ * ldx;
    const int t0 = ci * TQ, len = min(TQ, S - t0);
    stage_rows<PM, EXACT>(ad, ab, as1, P, t0, len);
    stage_rows<NM, EXACT>(bd, bbase, bs1, N, t0, len);
    stage_dt(reinterpret_cast<float*>(bd + TQ * ldn), dtb, ds.s1, t0, len);
  };

  float acc[NM / 8][4];
#pragma unroll
  for (int i = 0; i < NM / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  const bool owns = warp * 16 < P;
  const int ra = warp * 16 + g;
  const int at = off_n(lane, ldx) + warp * 16;
  const int bt = off_k(lane, ldn);
  load(dir == 0 ? 0 : nc - 1, 0);
  tc::cp_async_commit();
  for (int k = 0; k < nc; ++k) {
    const int ci = dir == 0 ? k : nc - 1 - k;
    if (k + 1 < nc) {
      load(dir == 0 ? ci + 1 : ci - 1, (k + 1) & 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();     // chunk ci has landed
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a_s =
        reinterpret_cast<const bf16*>(smem_raw + (k & 1) * stage);
    const bf16* b_s = a_s + TQ * ldx;
    const float* dt_s = reinterpret_cast<const float*>(b_s + TQ * ldn);
    // this warp's own copy of the row weights (no barrier)
    float c0, c1;
    const float total = chunk_cum(dt_s, a, lane, c0, c1);
    w_w[2 * lane] =
        dir == 0 ? expf(fminf(total - c0, 0.0f)) * dt_s[2 * lane] : expf(c0);
    w_w[2 * lane + 1] = dir == 0 ? expf(fminf(total - c1, 0.0f)) *
                                       dt_s[2 * lane + 1]
                                 : expf(c1);
    __syncwarp();
    if (owns) {
      // the state at the chunk's boundary (before it, forward; after it,
      // backward), then the update
      float* dst = out + (long long)ci * P * N;
      const float et = expf(total);
#pragma unroll
      for (int nt = 0; nt < NM / 8; ++nt) {
        if (!EXACT && nt * 8 >= N) break;
        const int col = nt * 8 + 2 * qd;
        *reinterpret_cast<float2*>(dst + (long long)ra * N + col) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(dst + (long long)(ra + 8) * N + col) =
            make_float2(acc[nt][2], acc[nt][3]);
        acc[nt][0] *= et;
        acc[nt][1] *= et;
        acc[nt][2] *= et;
        acc[nt][3] *= et;
      }
#pragma unroll
      for (int kt = 0; kt < TQ / 16; ++kt) {
        uint32_t af[4], hi[4], lo[4];
        tc::ldsm_x4_t(af, a_s + kt * 16 * ldx + at);
        const float w0 = w_w[kt * 16 + 2 * qd];
        const float w1 = w_w[kt * 16 + 2 * qd + 1];
        const float w2 = w_w[kt * 16 + 8 + 2 * qd];
        const float w3 = w_w[kt * 16 + 9 + 2 * qd];
        split_scale(af[0], w0, w1, hi[0], lo[0]);
        split_scale(af[1], w0, w1, hi[1], lo[1]);
        split_scale(af[2], w2, w3, hi[2], lo[2]);
        split_scale(af[3], w2, w3, hi[3], lo[3]);
#pragma unroll
        for (int np = 0; np < NM / 16; ++np) {
          if (!EXACT && np * 16 >= N) break;
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, b_s + kt * 16 * ldn + np * 16 + bt);
          tc::mma_bf16(acc[2 * np], hi, bf[0], bf[1]);
          tc::mma_bf16(acc[2 * np + 1], hi, bf[2], bf[3]);
          tc::mma_bf16(acc[2 * np], lo, bf[0], bf[1]);
          tc::mma_bf16(acc[2 * np + 1], lo, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();   // the slot is free for chunk k + 2
  }
}

// A (P, N) f32 state as bf16 hi and lo halves [P][N + 8]; with `other`,
// returns this thread's part of <state, other> (each thread its float4s in
// order).
__device__ __forceinline__ float split_state(const float* src,
                                             const float* other, bf16* hi,
                                             bf16* lo, int P, int N) {
  const int ldn = N + 8;
  float dot = 0.f;
  for (int i = threadIdx.x; i < P * N / 4; i += TC_THREADS) {
    const float4 v = reinterpret_cast<const float4*>(src)[i];
    const int p = (i * 4) / N, n = i * 4 - p * N;
    const uint32_t h01 = tc::pack_bf16(v.x, v.y);
    const uint32_t h23 = tc::pack_bf16(v.z, v.w);
    const float2 f01 = tc::unpack_bf16(h01), f23 = tc::unpack_bf16(h23);
    *reinterpret_cast<uint2*>(hi + p * ldn + n) = make_uint2(h01, h23);
    *reinterpret_cast<uint2*>(lo + p * ldn + n) =
        make_uint2(tc::pack_bf16(v.x - f01.x, v.y - f01.y),
                   tc::pack_bf16(v.z - f23.x, v.w - f23.y));
    if (other != nullptr) {
      const float4 o = reinterpret_cast<const float4*>(other)[i];
      dot = fmaf(v.x, o.x, dot);
      dot = fmaf(v.y, o.y, dot);
      dot = fmaf(v.z, o.z, dot);
      dot = fmaf(v.w, o.w, dot);
    }
  }
  return dot;
}

// Kernel 2, a block per (batch, head, chunk), with h0 and G known: the
// scores, M1, M2 and T; dc (rows t), then u -> dx and db (rows j) as
// intra-chunk plus inter-chunk products; then dcum, its reverse running
// sum, ddt and the chunk's sum of dt dlam.  Warp w owns chunk rows
// 16 w .. 16 w + 15 of every product.
template <int PM, int NM, bool EXACT>
__global__ void __launch_bounds__(TC_THREADS, 2) ssd_bwd_tc_chunk(
    const bf16* __restrict__ x, const bf16* __restrict__ b,
    const bf16* __restrict__ c, const float* __restrict__ dt,
    const float* __restrict__ a_log, const bf16* __restrict__ dy,
    bf16* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ work,
    int B, int S, int H, int G, int P_rt, int N_rt, S4 xs, S4 bs, S4 cs,
    S3 ds, S4 ys) {
  const int P = EXACT ? PM : P_rt;
  const int N = EXACT ? NM : N_rt;
  const TcLayout lay(P, N);
  const int ldx = lay.ldx, ldn = lay.ldn, ldq = lay.ldq;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw + lay.x);
  bf16* dy_s = reinterpret_cast<bf16*>(smem_raw + lay.dy);
  bf16* b_s = reinterpret_cast<bf16*>(smem_raw + lay.b);
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw + lay.c);
  bf16* hh_s = reinterpret_cast<bf16*>(smem_raw + lay.hh);
  bf16* hl_s = reinterpret_cast<bf16*>(smem_raw + lay.hl);
  bf16* mh_s = reinterpret_cast<bf16*>(smem_raw + lay.mh);
  bf16* ml_s = reinterpret_cast<bf16*>(smem_raw + lay.ml);
  float* dt_s = reinterpret_cast<float*>(smem_raw + lay.dt);
  float* cum_s = reinterpret_cast<float*>(smem_raw + lay.cum);
  float* rowt_s = reinterpret_cast<float*>(smem_raw + lay.rowt);
  float* colp_s = reinterpret_cast<float*>(smem_raw + lay.colp);
  float* dc1_s = reinterpret_cast<float*>(smem_raw + lay.dc1);
  float* xbg_s = reinterpret_cast<float*>(smem_raw + lay.xbg);
  float* red_s = reinterpret_cast<float*>(smem_raw + lay.red);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int nc = (S + TQ - 1) / TQ;
  int blk = blockIdx.x;
  const int ci = blk % nc;
  blk /= nc;
  const int h = blk % H, bb = blk / H;
  const int grp = h / (H / G);
  const float a = -expf(a_log[h]);
  const int t0 = ci * TQ, len = min(TQ, S - t0);
  const TcWork wl = tc_work_layout(B, S, H, P, N);
  const long long cix = ((long long)bb * H + h) * nc + ci;
  const float* h0g = work + wl.st + cix * P * N;
  const float* gg = work + wl.gr + cix * P * N;

  stage_rows<PM, EXACT>(x_s, x + bb * xs.s0 + h * xs.s2, xs.s1, P, t0, len);
  stage_rows<PM, EXACT>(dy_s, dy + bb * ys.s0 + h * ys.s2, ys.s1, P, t0,
                        len);
  stage_rows<NM, EXACT>(b_s, b + bb * bs.s0 + grp * bs.s2, bs.s1, N, t0,
                        len);
  stage_rows<NM, EXACT>(c_s, c + bb * cs.s0 + grp * cs.s2, cs.s1, N, t0,
                        len);
  stage_dt(dt_s, dt + bb * ds.s0 + h * ds.s2, ds.s1, t0, len);
  tc::cp_async_commit();
  split_state(h0g, nullptr, hh_s, hl_s, P, N);   // while the chunk lands
  tc::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) {
    float c0, c1;
    const float total = chunk_cum(dt_s, a, lane, c0, c1);
    cum_s[2 * lane] = c0 * kLog2e;
    cum_s[2 * lane + 1] = c1 * kLog2e;
    if (lane == 0) red_s[4] = total;
  }
  __syncthreads();
  const float total = red_s[4];
  const float total2 = total * kLog2e;
  const int r0 = warp * 16, ra = r0 + g, rb = ra + 8;
  const float cum_a = cum_s[ra], cum_b = cum_s[rb];
  const float dt_a = dt_s[ra], dt_b = dt_s[rb];
  const int oa_x = off_a(lane, ldx) + r0 * ldx;
  const int oa_n = off_a(lane, ldn) + r0 * ldn;
  const int on_x = off_n(lane, ldx), on_n = off_n(lane, ldn);
  const int ok_x = off_k(lane, ldx), ok_n = off_k(lane, ldn);
  const int ot_q = off_n(lane, ldq) + r0;   // M^T rows j = r0 .. (trans)

  // ---- scores CB = C B^T and DX = dY X^T for this warp's rows t and the
  //      columns j of the blocks at or below the diagonal; then per element
  //      L = exp(cum_t - cum_j) (j <= t), M1 = CB L and M2 = DX L dt_j as
  //      bf16 hi + lo pairs (M1 to shared memory, M2 kept in registers as
  //      the A fragments of dc's product) and T / dt_j = CB L DX (f32: its
  //      row sums times dt_j, its column sums) ---------------------------
  uint32_t m2h[TQ / 16][4], m2l[TQ / 16][4];
  {
    float cb[TQ / 8][4], dxs[TQ / 8][4];
#pragma unroll
    for (int i = 0; i < TQ / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[i][e] = dxs[i][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NM / 16; ++kk) {
      if (!EXACT && kk * 16 >= N) break;
      uint32_t af[4];
      tc::ldsm_x4(af, c_s + oa_n + kk * 16);
#pragma unroll
      for (int jp = 0; jp < TQ / 16; ++jp) {
        if (jp > warp) break;
        uint32_t bf[4];
        tc::ldsm_x4(bf, b_s + jp * 16 * ldn + kk * 16 + on_n);
        tc::mma_bf16(cb[2 * jp], af, bf[0], bf[1]);
        tc::mma_bf16(cb[2 * jp + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < PM / 16; ++kk) {
      if (!EXACT && kk * 16 >= P) break;
      uint32_t af[4];
      tc::ldsm_x4(af, dy_s + oa_x + kk * 16);
#pragma unroll
      for (int jp = 0; jp < TQ / 16; ++jp) {
        if (jp > warp) break;
        uint32_t bf[4];
        tc::ldsm_x4(bf, x_s + jp * 16 * ldx + kk * 16 + on_x);
        tc::mma_bf16(dxs[2 * jp], af, bf[0], bf[1]);
        tc::mma_bf16(dxs[2 * jp + 1], af, bf[2], bf[3]);
      }
    }
    float rt_a = 0.0f, rt_b = 0.0f;
#pragma unroll
    for (int nt = 0; nt < TQ / 8; ++nt) {
      const int j0 = nt * 8 + 2 * qd;
      float col[2] = {0.0f, 0.0f};
      if (nt / 2 <= warp) {
        float m1v[4], m2v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + (e & 1);
          const int i = e < 2 ? ra : rb;
          const float ci_ = e < 2 ? cum_a : cum_b;
          // select before the exponential: never exp of a positive gap
          const float L =
              j <= i ? tc::exp2_approx(fminf(ci_ - cum_s[j], 0.0f)) : 0.0f;
          const float d = dt_s[j];
          const float m1 = cb[nt][e] * L;
          const float pe = m1 * dxs[nt][e];
          m1v[e] = m1;
          m2v[e] = dxs[nt][e] * L * d;
          if (e < 2) rt_a = fmaf(pe, d, rt_a);
          else rt_b = fmaf(pe, d, rt_b);
          col[e & 1] += pe;
        }
        uint32_t h0, h1, l0, l1;
        split_pair(m1v[0], m1v[1], h0, l0);
        split_pair(m1v[2], m1v[3], h1, l1);
        *reinterpret_cast<uint32_t*>(mh_s + ra * ldq + j0) = h0;
        *reinterpret_cast<uint32_t*>(mh_s + rb * ldq + j0) = h1;
        *reinterpret_cast<uint32_t*>(ml_s + ra * ldq + j0) = l0;
        *reinterpret_cast<uint32_t*>(ml_s + rb * ldq + j0) = l1;
        // the A fragment of k block nt / 2: rows g and g + 8 of its half
        split_pair(m2v[0], m2v[1], m2h[nt / 2][2 * (nt % 2)],
                   m2l[nt / 2][2 * (nt % 2)]);
        split_pair(m2v[2], m2v[3], m2h[nt / 2][2 * (nt % 2) + 1],
                   m2l[nt / 2][2 * (nt % 2) + 1]);
#pragma unroll
        for (int m = 4; m <= 16; m <<= 1) {
          col[0] += __shfl_xor_sync(FULL, col[0], m);
          col[1] += __shfl_xor_sync(FULL, col[1], m);
        }
      }
      if (lane < 4) {
        colp_s[warp * TQ + j0] = col[0];
        colp_s[warp * TQ + j0 + 1] = col[1];
      }
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      rt_a += __shfl_xor_sync(FULL, rt_a, m);
      rt_b += __shfl_xor_sync(FULL, rt_b, m);
    }
    if (qd == 0) {
      rowt_s[ra] = rt_a;
      rowt_s[rb] = rt_b;
    }
  }
  __syncthreads();   // M1 in shared memory

  const float ea = exp2f(cum_a), eb = exp2f(cum_b);
  const float eta = exp2f(fminf(total2 - cum_a, 0.0f));
  const float etb = exp2f(fminf(total2 - cum_b, 0.0f));
  const long long row_s = (long long)H;           // steps apart, in rows
  const long long base = ((long long)bb * S + t0) * H + h;

  // ---- dc (rows t) = exp(cum_t) dY h0 + M2 B; on the way, exp(cum_t)
  //      dy_t^T h0 c_t for dcum --------------------------------------
  {
    float acc[NM / 8][4];
#pragma unroll
    for (int i = 0; i < NM / 8; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < PM / 16; ++kk) {
      if (!EXACT && kk * 16 >= P) break;
      uint32_t af[4];
      tc::ldsm_x4(af, dy_s + oa_x + kk * 16);
#pragma unroll
      for (int np = 0; np < NM / 16; ++np) {
        if (!EXACT && np * 16 >= N) break;
        uint32_t bh[4], bl[4];
        tc::ldsm_x4_t(bh, hh_s + kk * 16 * ldn + np * 16 + ok_n);
        tc::ldsm_x4_t(bl, hl_s + kk * 16 * ldn + np * 16 + ok_n);
        tc::mma_bf16(acc[2 * np], af, bh[0], bh[1]);
        tc::mma_bf16(acc[2 * np + 1], af, bh[2], bh[3]);
        tc::mma_bf16(acc[2 * np], af, bl[0], bl[1]);
        tc::mma_bf16(acc[2 * np + 1], af, bl[2], bl[3]);
      }
    }
    float wa = 0.0f, wb = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NM / 8; ++nt) {
      if (!EXACT && nt * 8 >= N) break;
      const int n = nt * 8 + 2 * qd;
      const float2 ca = tc::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(c_s + ra * ldn + n));
      const float2 cb2 = tc::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(c_s + rb * ldn + n));
      wa = fmaf(acc[nt][0], ca.x, fmaf(acc[nt][1], ca.y, wa));
      wb = fmaf(acc[nt][2], cb2.x, fmaf(acc[nt][3], cb2.y, wb));
      acc[nt][0] *= ea;
      acc[nt][1] *= ea;
      acc[nt][2] *= eb;
      acc[nt][3] *= eb;
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      wa += __shfl_xor_sync(FULL, wa, m);
      wb += __shfl_xor_sync(FULL, wb, m);
    }
    if (qd == 0) {
      dc1_s[ra] = ea * wa;
      dc1_s[rb] = eb * wb;
    }
#pragma unroll
    for (int jp = 0; jp < TQ / 16; ++jp) {
      if (jp > warp) break;
#pragma unroll
      for (int np = 0; np < NM / 16; ++np) {
        if (!EXACT && np * 16 >= N) break;
        uint32_t bf[4];
        tc::ldsm_x4_t(bf, b_s + jp * 16 * ldn + np * 16 + ok_n);
        tc::mma_bf16(acc[2 * np], m2h[jp], bf[0], bf[1]);
        tc::mma_bf16(acc[2 * np + 1], m2h[jp], bf[2], bf[3]);
        tc::mma_bf16(acc[2 * np], m2l[jp], bf[0], bf[1]);
        tc::mma_bf16(acc[2 * np + 1], m2l[jp], bf[2], bf[3]);
      }
    }
    float* cp = work + wl.cp + base * N;
#pragma unroll
    for (int nt = 0; nt < NM / 8; ++nt) {
      if (!EXACT && nt * 8 >= N) break;
      const int n = nt * 8 + 2 * qd;
      if (ra < len)
        *reinterpret_cast<float2*>(cp + ra * row_s * N + n) =
            make_float2(acc[nt][0], acc[nt][1]);
      if (rb < len)
        *reinterpret_cast<float2*>(cp + rb * row_s * N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();   // every warp is done with h0
  {
    const float part = split_state(gg, h0g, hh_s, hl_s, P, N);
    const float ws = warp_sum(part);
    if (lane == 0) red_s[warp] = ws;
  }
  __syncthreads();   // G in shared memory, <G, h0> by warp

  // ---- u (rows j) = exp(total - cum_j) B G^T + M1^T dY; dx = dt u; on the
  //      way, exp(total - cum_j) x_j^T G b_j for ddt and dcum ----------
  {
    float acc[PM / 8][4];
#pragma unroll
    for (int i = 0; i < PM / 8; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NM / 16; ++kk) {
      if (!EXACT && kk * 16 >= N) break;
      uint32_t af[4];
      tc::ldsm_x4(af, b_s + oa_n + kk * 16);
#pragma unroll
      for (int np = 0; np < PM / 16; ++np) {
        if (!EXACT && np * 16 >= P) break;
        uint32_t bh[4], bl[4];
        tc::ldsm_x4(bh, hh_s + np * 16 * ldn + kk * 16 + on_n);
        tc::ldsm_x4(bl, hl_s + np * 16 * ldn + kk * 16 + on_n);
        tc::mma_bf16(acc[2 * np], af, bh[0], bh[1]);
        tc::mma_bf16(acc[2 * np + 1], af, bh[2], bh[3]);
        tc::mma_bf16(acc[2 * np], af, bl[0], bl[1]);
        tc::mma_bf16(acc[2 * np + 1], af, bl[2], bl[3]);
      }
    }
    float sa = 0.0f, sb = 0.0f;
#pragma unroll
    for (int nt = 0; nt < PM / 8; ++nt) {
      if (!EXACT && nt * 8 >= P) break;
      const int p = nt * 8 + 2 * qd;
      const float2 xa = tc::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(x_s + ra * ldx + p));
      const float2 xb = tc::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(x_s + rb * ldx + p));
      sa = fmaf(acc[nt][0], xa.x, fmaf(acc[nt][1], xa.y, sa));
      sb = fmaf(acc[nt][2], xb.x, fmaf(acc[nt][3], xb.y, sb));
      acc[nt][0] *= eta;
      acc[nt][1] *= eta;
      acc[nt][2] *= etb;
      acc[nt][3] *= etb;
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      sa += __shfl_xor_sync(FULL, sa, m);
      sb += __shfl_xor_sync(FULL, sb, m);
    }
    if (qd == 0) {
      xbg_s[ra] = eta * sa;
      xbg_s[rb] = etb * sb;
    }
#pragma unroll
    for (int tb = 0; tb < TQ / 16; ++tb) {
      if (tb < warp) continue;
      uint32_t ah[4], al[4];
      tc::ldsm_x4_t(ah, mh_s + tb * 16 * ldq + ot_q);
      tc::ldsm_x4_t(al, ml_s + tb * 16 * ldq + ot_q);
#pragma unroll
      for (int np = 0; np < PM / 16; ++np) {
        if (!EXACT && np * 16 >= P) break;
        uint32_t bf[4];
        tc::ldsm_x4_t(bf, dy_s + tb * 16 * ldx + np * 16 + ok_x);
        tc::mma_bf16(acc[2 * np], ah, bf[0], bf[1]);
        tc::mma_bf16(acc[2 * np + 1], ah, bf[2], bf[3]);
        tc::mma_bf16(acc[2 * np], al, bf[0], bf[1]);
        tc::mma_bf16(acc[2 * np + 1], al, bf[2], bf[3]);
      }
    }
    bf16* dxb = dx + base * P;
#pragma unroll
    for (int nt = 0; nt < PM / 8; ++nt) {
      if (!EXACT && nt * 8 >= P) break;
      const int p = nt * 8 + 2 * qd;
      if (ra < len)
        *reinterpret_cast<uint32_t*>(dxb + ra * row_s * P + p) =
            tc::pack_bf16(dt_a * acc[nt][0], dt_a * acc[nt][1]);
      if (rb < len)
        *reinterpret_cast<uint32_t*>(dxb + rb * row_s * P + p) =
            tc::pack_bf16(dt_b * acc[nt][2], dt_b * acc[nt][3]);
    }
  }

  // ---- M2 (hi, lo) to shared memory in place of M1, for its transpose ----
  __syncthreads();   // every warp is done with M1
#pragma unroll
  for (int jp = 0; jp < TQ / 16; ++jp) {
    if (jp > warp) break;
    const int c0 = jp * 16 + 2 * qd;
    *reinterpret_cast<uint32_t*>(mh_s + ra * ldq + c0) = m2h[jp][0];
    *reinterpret_cast<uint32_t*>(mh_s + rb * ldq + c0) = m2h[jp][1];
    *reinterpret_cast<uint32_t*>(mh_s + ra * ldq + c0 + 8) = m2h[jp][2];
    *reinterpret_cast<uint32_t*>(mh_s + rb * ldq + c0 + 8) = m2h[jp][3];
    *reinterpret_cast<uint32_t*>(ml_s + ra * ldq + c0) = m2l[jp][0];
    *reinterpret_cast<uint32_t*>(ml_s + rb * ldq + c0) = m2l[jp][1];
    *reinterpret_cast<uint32_t*>(ml_s + ra * ldq + c0 + 8) = m2l[jp][2];
    *reinterpret_cast<uint32_t*>(ml_s + rb * ldq + c0 + 8) = m2l[jp][3];
  }
  __syncthreads();

  // ---- db (rows j) = exp(total - cum_j) dt_j X G + M2^T C ----------------
  {
    float acc[NM / 8][4];
#pragma unroll
    for (int i = 0; i < NM / 8; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < PM / 16; ++kk) {
      if (!EXACT && kk * 16 >= P) break;
      uint32_t af[4];
      tc::ldsm_x4(af, x_s + oa_x + kk * 16);
#pragma unroll
      for (int np = 0; np < NM / 16; ++np) {
        if (!EXACT && np * 16 >= N) break;
        uint32_t bh[4], bl[4];
        tc::ldsm_x4_t(bh, hh_s + kk * 16 * ldn + np * 16 + ok_n);
        tc::ldsm_x4_t(bl, hl_s + kk * 16 * ldn + np * 16 + ok_n);
        tc::mma_bf16(acc[2 * np], af, bh[0], bh[1]);
        tc::mma_bf16(acc[2 * np + 1], af, bh[2], bh[3]);
        tc::mma_bf16(acc[2 * np], af, bl[0], bl[1]);
        tc::mma_bf16(acc[2 * np + 1], af, bl[2], bl[3]);
      }
    }
    const float sa = eta * dt_a, sb = etb * dt_b;
#pragma unroll
    for (int nt = 0; nt < NM / 8; ++nt) {
      acc[nt][0] *= sa;
      acc[nt][1] *= sa;
      acc[nt][2] *= sb;
      acc[nt][3] *= sb;
    }
#pragma unroll
    for (int tb = 0; tb < TQ / 16; ++tb) {
      if (tb < warp) continue;
      uint32_t ah[4], al[4];
      tc::ldsm_x4_t(ah, mh_s + tb * 16 * ldq + ot_q);
      tc::ldsm_x4_t(al, ml_s + tb * 16 * ldq + ot_q);
#pragma unroll
      for (int np = 0; np < NM / 16; ++np) {
        if (!EXACT && np * 16 >= N) break;
        uint32_t bf[4];
        tc::ldsm_x4_t(bf, c_s + tb * 16 * ldn + np * 16 + ok_n);
        tc::mma_bf16(acc[2 * np], ah, bf[0], bf[1]);
        tc::mma_bf16(acc[2 * np + 1], ah, bf[2], bf[3]);
        tc::mma_bf16(acc[2 * np], al, bf[0], bf[1]);
        tc::mma_bf16(acc[2 * np + 1], al, bf[2], bf[3]);
      }
    }
    float* bp = work + wl.bp + base * N;
#pragma unroll
    for (int nt = 0; nt < NM / 8; ++nt) {
      if (!EXACT && nt * 8 >= N) break;
      const int n = nt * 8 + 2 * qd;
      if (ra < len)
        *reinterpret_cast<float2*>(bp + ra * row_s * N + n) =
            make_float2(acc[nt][0], acc[nt][1]);
      if (rb < len)
        *reinterpret_cast<float2*>(bp + rb * row_s * N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();   // the row terms of dcum, from every warp

  // ---- dcum_t = rowsum(T) - colsum(T) + exp(cum) dy^T h0 c - v_t, v_t =
  //      dt_t exp(total - cum_t) x_t^T G b_t, and at t = Q - 1 exp(total)
  //      <G, h0> + sum_t v_t; dlam its reverse running sum; ddt = x . u +
  //      a dlam, x . u = colsum(T / dt) + exp(total - cum) x^T G b ------
  if (warp == 0) {
    float d[2], xu[2], dtv[2], v = 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = 2 * lane + k;
      const float colp = ((colp_s[t] + colp_s[TQ + t]) + colp_s[2 * TQ + t]) +
                         colp_s[3 * TQ + t];
      dtv[k] = dt_s[t];
      xu[k] = colp + xbg_s[t];
      const float vt = dtv[k] * xbg_s[t];
      d[k] = rowt_s[t] - dtv[k] * colp + dc1_s[t] - vt;
      v += vt;
    }
    v = warp_sum(v);
    if (lane == 31) {
      const float hg = ((red_s[0] + red_s[1]) + red_s[2]) + red_s[3];
      d[1] += expf(total) * hg + v;
    }
    float run = d[0] + d[1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_down_sync(FULL, run, off);
      if (lane + off < 32) run += o;
    }
    float later = __shfl_down_sync(FULL, run, 1);
    if (lane == 31) later = 0.0f;
    float dl[2];
    dl[1] = later + d[1];
    dl[0] = dl[1] + d[0];
    float sdl = 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = 2 * lane + k;
      if (t < len) ddt[base + t * row_s] = xu[k] + a * dl[k];
      sdl = fmaf(dtv[k], dl[k], sdl);
    }
    sdl = warp_sum(sdl);
    if (lane == 0) work[wl.dl + ((long long)bb * nc + ci) * H + h] = sdl;
  }
}

template <bool EXACT>
cudaError_t launch_tc(const void* x, const void* b, const void* c,
                      const void* dt, const void* a_log, const void* dy,
                      void* dx, void* db, void* dc, void* ddt, void* da_log,
                      void* work, int B, int S, int H, int G, int P, int N,
                      S4 xs, S4 bs, S4 cs, S3 ds, S4 ys, cudaStream_t st) {
  const int nc = (S + TQ - 1) / TQ;
  const long long blocks = (long long)B * H * nc;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bf16 *xp = (const bf16*)x, *bp = (const bf16*)b,
             *cp = (const bf16*)c, *yp = (const bf16*)dy;
  const float *dtp = (const float*)dt, *al = (const float*)a_log;
  float* wf = (float*)work;
  auto k1 = ssd_bwd_tc_states<TC_PM, TC_NM, EXACT>;
  const int sm1 = tc_states_smem(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, sm1);
  if (err != cudaSuccess) return err;
  k1<<<(unsigned)(2 * B * H), TC_THREADS, sm1, st>>>(
      xp, bp, cp, dtp, al, yp, wf, B, S, H, G, P, N, xs, bs, cs, ds, ys);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto k3 = ssd_bwd_tc_chunk<TC_PM, TC_NM, EXACT>;
  const int sm3 = TcLayout(P, N).total;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sm3);
  if (err != cudaSuccess) return err;
  k3<<<(unsigned)blocks, TC_THREADS, sm3, st>>>(xp, bp, cp, dtp, al, yp,
                                                (bf16*)dx, (float*)ddt, wf,
                                                B, S, H, G, P, N, xs, bs, cs,
                                                ds, ys);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const TcWork wl = tc_work_layout(B, S, H, P, N);
  const long long cols = (long long)B * S * G * N;
  ssd_bwd_finish_bc<bf16><<<(unsigned)((cols + 255) / 256), 256, 0, st>>>(
      wf + wl.bp, wf + wl.cp, (bf16*)db, (bf16*)dc, B, S, H, G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_finish_alog<<<H, 256, 0, st>>>(wf + wl.dl, al, (float*)da_log,
                                         (long long)B * nc, H);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

// Shared bytes of a chunk block of the "tensor_core" design (the largest
// of its kernels; the wrapper's bwd_plan mirrors it).
long long ssd_scan_bwd_tc_smem_bytes(int P, int N) {
  return TcLayout(P, N).total;
}

// Floats of the "tensor_core" design's workspace.
long long ssd_scan_bwd_tc_work_floats(int B, int S, int H, int P, int N) {
  return tc_work_layout(B, S, H, P, N).total;
}

// The "tensor_core" design: as ssd_scan_bwd_launch, bf16 only, and needs
// P, N multiples of 16 with P <= 64, N <= 128, x, b, c and dy unit-stride
// in their last dim and every pointer and other stride of theirs 16-byte
// aligned; work of ssd_scan_bwd_tc_work_floats floats.  Returns a
// cudaError_t.
int ssd_scan_bwd_tc_launch(const void* x, const void* b, const void* c,
                           const void* dt, const void* a_log, const void* dy,
                           void* dx, void* db, void* dc, void* ddt,
                           void* da_log, void* work, int B, int S, int H,
                           int G, int P, int N, long long xs0, long long xs1,
                           long long xs2, long long xs3, long long bs0,
                           long long bs1, long long bs2, long long bs3,
                           long long cs0, long long cs1, long long cs2,
                           long long cs3, long long ds0, long long ds1,
                           long long ds2, long long ys0, long long ys1,
                           long long ys2, long long ys3, void* stream) {
  const long long strides[12] = {xs0, xs1, xs2, bs0, bs1, bs2,
                                 cs0, cs1, cs2, ys0, ys1, ys2};
  bool ok = G > 0 && H % G == 0 && B > 0 && S > 0 && P >= 16 &&
            P <= TC_PM && P % 16 == 0 && N >= 16 && N <= TC_NM &&
            N % 16 == 0 && xs3 == 1 && bs3 == 1 && cs3 == 1 && ys3 == 1 &&
            aligned16(x) && aligned16(b) && aligned16(c) && aligned16(dy) &&
            aligned16(work);
  for (long long s : strides) ok = ok && s % 8 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const S4 xs{xs0, xs1, xs2, xs3}, bs{bs0, bs1, bs2, bs3},
      cs{cs0, cs1, cs2, cs3}, ys{ys0, ys1, ys2, ys3};
  const S3 ds{ds0, ds1, ds2};
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      P == TC_PM && N == TC_NM
          ? launch_tc<true>(x, b, c, dt, a_log, dy, dx, db, dc, ddt, da_log,
                            work, B, S, H, G, P, N, xs, bs, cs, ds, ys, st)
          : launch_tc<false>(x, b, c, dt, a_log, dy, dx, db, dc, ddt,
                             da_log, work, B, S, H, G, P, N, xs, bs, cs, ds,
                             ys, st);
  return (int)err;
}

}  // extern "C"
