// Gradient of flash attention, hand-written for Hopper (sm_90a), with a
// plain C interface for ctypes.
//
// Replaces the backward of the reference's custom VJP around its
// attention (src/repro/models/flash_xla.py _bwd_vjp, an XLA lax.scan over
// 1,024-key chunks: the TPU had no Pallas kernel for it).  It computes
// what _bwd_vjp computes, per (batch, head h) with kv head h / group:
//   delta_i = sum_d dO_id O_id                         (f32)
//   s_ij    = scale q_i . k_j, masked where j >= Sk or (causal) j > i
//   P_ij    = exp(s_ij - lse_i), rounded to v's dtype
//   dP_ij   = dO_i . v_j                               (f32)
//   dS_ij   = P_ij (dP_ij - delta_i), rounded to k's dtype
//   dV_j    = sum_{h, i} P_ij dO_i
//   dK_j    = sum_{h, i} dS_ij (scale q_i)    (both over the kv head's
//                                              group of query heads)
//   dQ_i    = scale sum_j dS_ij k_j
// with every sum in float32 and the outputs in the inputs' dtype.  lse is
// the forward's (csrc/flash_attention.cu), in natural units of the
// scaled scores.  The causal mask is top-left (rows >= cols), as the
// forward has it; the wrapper takes causal only with Sq == Sk.  Inputs
// are read through their (batch, head, row) strides (q, k, v are views of
// the projections); dq, dk, dv, lse and the delta workspace are
// contiguous.
//
// No atomics, and every sum in a fixed order: each output element is
// owned by one thread of one block, which adds its terms in the same
// order on every launch, so two launches are bitwise alike and a replay
// after a failure repeats a training run's losses bit for bit.
//
// Three kernels, one after the other on the stream:
//  * fa_bwd_delta_kernel: one warp a row, delta_i into a workspace;
//  * dK/dV: one block per (batch, kv head, tile of key rows).  It walks
//    every query head of its group and every query tile that can see its
//    keys (causal: from the tile holding its first key on), recomputes
//    S and dP for the pair of tiles, and keeps its dK and dV rows in
//    float32 registers across the walk;
//  * dQ: one block per (batch, head, tile of query rows), walking the key
//    tiles its rows can see, recomputing S and dP, dQ in registers.
// S and dP are computed twice (once for dK/dV, once for dQ): seven
// products where a one-pass design with atomics has five.
//
// Two designs; the wrapper's bwd_plan (kernels/flash_attention.py) picks
// one before the launch, never after a failure:
//
// "tensor_core" (bf16, dh % 16 == 0, every pointer and stride 16-byte
// aligned: the training path's every launch).  mma.sync m16n8k16 bf16 ->
// f32 with ldmatrix fragments (csrc/hopper_mma.cuh), as the forward:
//  * dK/dV (fa_bwd_dkdv_tc_kernel): 8 warps own TC_BK = 32 keys; K and V
//    tiles stay in shared memory, Q and dO tiles of TC_BQ = 64 queries
//    (and their lse, delta) are staged by cp.async.  Phase 1: warp
//    (r, c) computes S^T and dP^T for keys 16 r .. 16 r + 15 against
//    queries 16 c .. 16 c + 15 (A = K or V rows, B = Q or dO rows, over
//    the full dh), P^T = 2^(s c2 - lse2) (c2 the scale, lse2 the lse, in
//    log2 units: lse is converted once, as it is staged) and dS^T, both
//    rounded to bf16 -- the reference's rounding points -- and written
//    to shared memory.  Phase 2: warp (r, c) owns the dh columns of
//    16-column blocks c, c + 4, ... of keys 16 r ..: dV += P^T dO and
//    dK += dS^T Q (A = P^T or dS^T from shared memory, B = dO or Q by
//    ldmatrix.trans), so a thread holds at most 2 x 32 accumulators at
//    dh = 256 (four blocks of 16 columns, two n-tiles each, twice);
//  * dQ (fa_bwd_dq_tc_kernel): 4 warps own 64 query rows, 16 a warp,
//    as the forward's blocks; Q and dO rows stay in shared memory, K and
//    V tiles of key_tile(dh) keys are staged; S and dP per warp on
//    mma.sync, P and dS in registers, dS rounded to bf16 as the A operand
//    of dQ += dS K (K by ldmatrix.trans); dQ in registers (dh / 2 floats a
//    thread).
//  Shared memory at dh = 256: dK/dV 32 + 64 rows of two tensors each
//  (101 KB) plus P^T, dS^T (9 KB) and lse, delta; dQ 2 x 64 + 2 x 32
//  rows (101 KB): two blocks an SM each.
//
// "cuda_core" (float32, whose card tolerance bf16 products could not
// meet, and any bf16 input the tensor-core design does not take): the
// forward's CUDA-core shape.  dK/dV: one warp a key row, 8 keys a block,
// query tiles of 32 (one a lane) staged as float32, each lane computing
// its query's score and dP, the warp's dK, dV row held as float4s of
// columns 128 g + 4 lane and updated from the lanes' P and dS by
// shuffles.  dQ: one warp a query row, 16 rows a block, key tiles of 32
// (one a lane), dQ as float4s the same way.
//
// What bounds it on an H100.  At the training shape (gemma-7b: B = 2,
// H = Hkv = 16, S = 1,024, dh = 256, bf16, causal) the least work is five
// causal products of B H S^2 dh / 2 multiply-adds (43 GFLOP, 0.044 ms on
// bf16 tensor cores) and some 135 MB of inputs and outputs (0.040 ms): the
// operations, barely.  This design spends seven products on mma.sync
// (not wgmma), single-buffers its tiles (no copy overlaps a product) and
// exchanges P^T and dS^T through shared memory, so it sits well above
// that bound; wgmma, TMA and a one-pass schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper_mma.cuh"

namespace {

constexpr int MAX_DH = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {  // element strides of (batch, head, row)
  long long b, h, s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// x rounded to T's precision and back (the reference's .astype points)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// delta_i = sum_d dO_id O_id, one warp a row
// ---------------------------------------------------------------------------

constexpr int DELTA_WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(DELTA_WARPS * 32) fa_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, int H, int Sq, int dh, long long rows,
    Strides os, Strides dos) {
  const long long r =
      static_cast<long long>(blockIdx.x) * DELTA_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const long long bh = r / Sq;
  const int i = static_cast<int>(r - bh * Sq);
  const int b = static_cast<int>(bh / H);
  const int h = static_cast<int>(bh - static_cast<long long>(b) * H);
  const T* orow = o + b * os.b + h * os.h + i * os.s;
  const T* drow = dout + b * dos.b + h * dos.h + i * dos.s;
  float acc = 0.0f;
  for (int c = lane; c < dh; c += 32)
    acc = fmaf(to_f32(drow[c]), to_f32(orow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) delta[r] = acc;
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int B, int H, int Sq, int dh, Strides os,
                         Strides dos, cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * H * Sq;
  const long long blocks = (rows + DELTA_WARPS - 1) / DELTA_WARPS;
  fa_bwd_delta_kernel<T><<<static_cast<unsigned>(blocks), DELTA_WARPS * 32,
                           0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, H, Sq, dh,
      rows, os, dos);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "cuda_core"
// ---------------------------------------------------------------------------

constexpr int CC_KV_WARPS = 8;   // keys a dK/dV block, one a warp
constexpr int CC_QT = 32;        // queries a staged tile, one a lane
constexpr int CC_Q_WARPS = 16;   // query rows a dQ block, one a warp
constexpr int CC_KT = 32;        // keys a staged tile, one a lane

size_t cc_dkdv_smem_bytes(int dh) {
  return static_cast<size_t>(2 * CC_KV_WARPS * dh + 2 * CC_QT * (dh + 4) +
                             2 * CC_QT) * 4;
}

size_t cc_dq_smem_bytes(int dh) {
  return static_cast<size_t>(2 * CC_Q_WARPS * dh + 2 * CC_KT * (dh + 4)) * 4;
}

template <typename T, int G>
__global__ void __launch_bounds__(CC_KV_WARPS * 32) fa_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int group,
    int Sq, int Sk, int dh, float scale, int causal, Strides qs, Strides ks,
    Strides vs, Strides dos) {
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv;
  const int hk = bhk - b * Hkv;
  const int kt0 = blockIdx.y * CC_KV_WARPS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int key = kt0 + warp;             // this warp's key row
  const int dhp = dh + 4;

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                      // CC_KV_WARPS x dh
  float* v_s = k_s + CC_KV_WARPS * dh;    // CC_KV_WARPS x dh
  float* q_s = v_s + CC_KV_WARPS * dh;    // CC_QT x dhp, pre-scaled
  float* do_s = q_s + CC_QT * dhp;        // CC_QT x dhp
  float* lse_s = do_s + CC_QT * dhp;      // CC_QT
  float* dl_s = lse_s + CC_QT;            // CC_QT

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int idx = threadIdx.x; idx < CC_KV_WARPS * dh; idx += blockDim.x) {
    const int w = idx / dh;
    const int c = idx - w * dh;
    const bool in = kt0 + w < Sk;
    k_s[idx] = in ? to_f32(kb[(kt0 + w) * ks.s + c]) : 0.0f;
    v_s[idx] = in ? to_f32(vb[(kt0 + w) * vs.s + c]) : 0.0f;
  }
  float4 dk_acc[G], dv_acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    dk_acc[g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dv_acc[g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float4* my_k = reinterpret_cast<const float4*>(k_s + warp * dh);
  const float4* my_v = reinterpret_cast<const float4*>(v_s + warp * dh);
  const float4* lane_q = reinterpret_cast<const float4*>(q_s + lane * dhp);
  const float4* lane_do = reinterpret_cast<const float4*>(do_s + lane * dhp);
  // causal: queries before the block's first key see none of its keys
  const int q_first = causal ? kt0 / CC_QT * CC_QT : 0;

  for (int hi = 0; hi < group; ++hi) {
    const int h = hk * group + hi;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * dos.b + h * dos.h;
    const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
    for (int qt0 = q_first; qt0 < Sq; qt0 += CC_QT) {
      __syncthreads();  // the previous tile consumed
      for (int idx = threadIdx.x; idx < CC_QT * dh; idx += blockDim.x) {
        const int r = idx / dh;
        const int c = idx - r * dh;
        const bool in = qt0 + r < Sq;
        q_s[r * dhp + c] =
            in ? __fmul_rn(to_f32(qb[(qt0 + r) * qs.s + c]), scale) : 0.0f;
        do_s[r * dhp + c] = in ? to_f32(db[(qt0 + r) * dos.s + c]) : 0.0f;
      }
      if (threadIdx.x < CC_QT) {
        const int r = qt0 + threadIdx.x;
        lse_s[threadIdx.x] = r < Sq ? lse[row0 + r] : 0.0f;
        dl_s[threadIdx.x] = r < Sq ? delta[row0 + r] : 0.0f;
      }
      __syncthreads();
      const int qi = qt0 + lane;           // this lane's query
      const bool live = key < Sk && qi < Sq && !(causal && key > qi);
      if (!__any_sync(FULL, live)) continue;   // uniform in the warp
      float p = 0.0f, ds = 0.0f;
      if (live) {
        float s = 0.0f, dp = 0.0f;
        for (int c = 0; c < dh / 4; ++c) {
          const float4 a = lane_q[c];
          const float4 kk = my_k[c];
          s = fmaf(a.x, kk.x, s);
          s = fmaf(a.y, kk.y, s);
          s = fmaf(a.z, kk.z, s);
          s = fmaf(a.w, kk.w, s);
          const float4 d = lane_do[c];
          const float4 vv = my_v[c];
          dp = fmaf(d.x, vv.x, dp);
          dp = fmaf(d.y, vv.y, dp);
          dp = fmaf(d.z, vv.z, dp);
          dp = fmaf(d.w, vv.w, dp);
        }
        p = round_to(expf(s - lse_s[lane]), k);
        ds = round_to(p * (dp - dl_s[lane]), k);
      }
      for (int t = 0; t < CC_QT; ++t) {
        const float pt = __shfl_sync(FULL, p, t);
        const float dst = __shfl_sync(FULL, ds, t);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int col = 128 * g + 4 * lane;
          if (col < dh) {
            const float4 dd =
                *reinterpret_cast<const float4*>(do_s + t * dhp + col);
            const float4 qq =
                *reinterpret_cast<const float4*>(q_s + t * dhp + col);
            dv_acc[g].x = fmaf(pt, dd.x, dv_acc[g].x);
            dv_acc[g].y = fmaf(pt, dd.y, dv_acc[g].y);
            dv_acc[g].z = fmaf(pt, dd.z, dv_acc[g].z);
            dv_acc[g].w = fmaf(pt, dd.w, dv_acc[g].w);
            dk_acc[g].x = fmaf(dst, qq.x, dk_acc[g].x);
            dk_acc[g].y = fmaf(dst, qq.y, dk_acc[g].y);
            dk_acc[g].z = fmaf(dst, qq.z, dk_acc[g].z);
            dk_acc[g].w = fmaf(dst, qq.w, dk_acc[g].w);
          }
        }
      }
    }
  }
  if (key >= Sk) return;
  const long long out = ((static_cast<long long>(b) * Hkv + hk) * Sk + key) *
                        dh;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int col = 128 * g + 4 * lane;
    if (col < dh) {
      store(dk + out + col + 0, dk_acc[g].x);
      store(dk + out + col + 1, dk_acc[g].y);
      store(dk + out + col + 2, dk_acc[g].z);
      store(dk + out + col + 3, dk_acc[g].w);
      store(dv + out + col + 0, dv_acc[g].x);
      store(dv + out + col + 1, dv_acc[g].y);
      store(dv + out + col + 2, dv_acc[g].z);
      store(dv + out + col + 3, dv_acc[g].w);
    }
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(CC_Q_WARPS * 32) fa_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int group, int Sq, int Sk, int dh,
    float scale, int causal, Strides qs, Strides ks, Strides vs,
    Strides dos) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const int r0 = blockIdx.y * CC_Q_WARPS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = r0 + warp;
  const int dhp = dh + 4;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // CC_Q_WARPS x dh, pre-scaled
  float* do_s = q_s + CC_Q_WARPS * dh;    // CC_Q_WARPS x dh
  float* k_s = do_s + CC_Q_WARPS * dh;    // CC_KT x dhp
  float* v_s = k_s + CC_KT * dhp;         // CC_KT x dhp

  const T* qb = q + b * qs.b + h * qs.h;
  const T* db = dout + b * dos.b + h * dos.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int idx = threadIdx.x; idx < CC_Q_WARPS * dh; idx += blockDim.x) {
    const int w = idx / dh;
    const int c = idx - w * dh;
    const bool in = r0 + w < Sq;
    q_s[idx] =
        in ? __fmul_rn(to_f32(qb[(r0 + w) * qs.s + c]), scale) : 0.0f;
    do_s[idx] = in ? to_f32(db[(r0 + w) * dos.s + c]) : 0.0f;
  }
  const long long my_row = static_cast<long long>(bh) * Sq + row;
  const float my_lse = row < Sq ? lse[my_row] : 0.0f;
  const float my_dl = row < Sq ? delta[my_row] : 0.0f;
  const int last = min(Sq, r0 + CC_Q_WARPS);
  const int n_keys = causal ? min(Sk, last) : Sk;
  const int my_keys = row < Sq ? (causal ? min(Sk, row + 1) : Sk) : 0;

  float4 acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* my_q = reinterpret_cast<const float4*>(q_s + warp * dh);
  const float4* my_do = reinterpret_cast<const float4*>(do_s + warp * dh);
  const float4* lane_k = reinterpret_cast<const float4*>(k_s + lane * dhp);
  const float4* lane_v = reinterpret_cast<const float4*>(v_s + lane * dhp);

  for (int t0 = 0; t0 < n_keys; t0 += CC_KT) {
    __syncthreads();  // q, dO staged / the previous tile consumed
    for (int idx = threadIdx.x; idx < CC_KT * dh; idx += blockDim.x) {
      const int j = idx / dh;
      const int c = idx - j * dh;
      const bool in = t0 + j < Sk;
      k_s[j * dhp + c] = in ? to_f32(kb[(t0 + j) * ks.s + c]) : 0.0f;
      v_s[j * dhp + c] = in ? to_f32(vb[(t0 + j) * vs.s + c]) : 0.0f;
    }
    __syncthreads();
    const int n_here = min(CC_KT, my_keys - t0);  // uniform in the warp
    if (n_here <= 0) continue;
    float ds = 0.0f;
    if (lane < n_here) {
      float s = 0.0f, dp = 0.0f;
      for (int c = 0; c < dh / 4; ++c) {
        const float4 a = my_q[c];
        const float4 kk = lane_k[c];
        s = fmaf(a.x, kk.x, s);
        s = fmaf(a.y, kk.y, s);
        s = fmaf(a.z, kk.z, s);
        s = fmaf(a.w, kk.w, s);
        const float4 d = my_do[c];
        const float4 vv = lane_v[c];
        dp = fmaf(d.x, vv.x, dp);
        dp = fmaf(d.y, vv.y, dp);
        dp = fmaf(d.z, vv.z, dp);
        dp = fmaf(d.w, vv.w, dp);
      }
      const float p = round_to(expf(s - my_lse), k);
      ds = round_to(p * (dp - my_dl), k);
    }
    for (int j = 0; j < n_here; ++j) {
      const float dsj = __shfl_sync(FULL, ds, j);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int col = 128 * g + 4 * lane;
        if (col < dh) {
          const float4 kk =
              *reinterpret_cast<const float4*>(k_s + j * dhp + col);
          acc[g].x = fmaf(dsj, kk.x, acc[g].x);
          acc[g].y = fmaf(dsj, kk.y, acc[g].y);
          acc[g].z = fmaf(dsj, kk.z, acc[g].z);
          acc[g].w = fmaf(dsj, kk.w, acc[g].w);
        }
      }
    }
  }
  if (row >= Sq) return;
  T* out = dq + my_row * dh;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int col = 128 * g + 4 * lane;
    if (col < dh) {
      store(out + col + 0, acc[g].x * scale);
      store(out + col + 1, acc[g].y * scale);
      store(out + col + 2, acc[g].z * scale);
      store(out + col + 3, acc[g].w * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, H, Hkv, Sq, Sk, dh;
  float scale;
  int causal;
  Strides qs, ks, vs, os, dos;
};

template <typename F>
cudaError_t set_smem(F* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int G>
cudaError_t launch_cc(const Args& a, cudaStream_t st) {
  cudaError_t err = launch_delta<T>(a.o, a.dout, a.delta, a.B, a.H, a.Sq,
                                    a.dh, a.os, a.dos, st);
  if (err != cudaSuccess) return err;
  const int group = a.H / a.Hkv;
  if (a.Sk > 0) {
    const size_t smem = cc_dkdv_smem_bytes(a.dh);
    auto fn = fa_bwd_dkdv_kernel<T, G>;
    err = set_smem(fn, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.Hkv, (a.Sk + CC_KV_WARPS - 1) / CC_KV_WARPS);
    fn<<<grid, CC_KV_WARPS * 32, smem, st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Hkv,
        group, a.Sq, a.Sk, a.dh, a.scale, a.causal, a.qs, a.ks, a.vs, a.dos);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t smem = cc_dq_smem_bytes(a.dh);
  auto fn = fa_bwd_dq_kernel<T, G>;
  err = set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sq + CC_Q_WARPS - 1) / CC_Q_WARPS);
  fn<<<grid, CC_Q_WARPS * 32, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.H, group, a.Sq, a.Sk, a.dh, a.scale,
      a.causal, a.qs, a.ks, a.vs, a.dos);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "tensor_core": bf16 on mma.sync (see the header note)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_BK = 32;        // keys a dK/dV block owns
constexpr int TC_BQ = 64;        // queries a dK/dV block stages at a time
constexpr int TC_KV_WARPS = 8;   // 2 row groups x 4 column groups
constexpr int TC_Q_WARPS = 4;    // a dQ block: 4 warps of 16 query rows
constexpr int TC_BM = 16 * TC_Q_WARPS;
constexpr int PAD = 8;           // bf16 a shared row is padded by

__host__ __device__ constexpr int key_tile(int dh) {
  return dh <= 128 ? 64 : 32;
}

size_t tc_dkdv_smem_bytes(int dh) {
  return static_cast<size_t>(2 * (TC_BK + TC_BQ) * (dh + PAD)) * 2 +
         static_cast<size_t>(2 * TC_BK * (TC_BQ + PAD)) * 2 +
         static_cast<size_t>(2 * TC_BQ) * 4;
}

size_t tc_dq_smem_bytes(int dh) {
  return static_cast<size_t>(2 * TC_BM + 2 * key_tile(dh)) * (dh + PAD) * 2;
}

// ldmatrix lane offsets (row stride ld) for: an A operand, 16 rows x 16
// columns of a row-major tile; a B operand whose tile is stored (n, k)
// row-major (non-transposed load); a B operand stored (k, n) row-major
// (transposed load).  Each x4 load of the B kinds gives two n-tiles of 8.
__device__ __forceinline__ int a_off(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int bn_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bk_off(int lane, int ld) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + (lane >> 4) * 8;
}

// rows [r0, r0 + n) of a (row-strided) bf16 tensor into a shared tile of
// row stride ld, by 16-byte cp.async; rows past `limit` are zero-filled.
template <int THREADS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long stride, int r0, int n,
                                           int limit, int dh, int ld) {
  const int cpr = dh / 8;
  for (int i = threadIdx.x; i < n * cpr; i += THREADS) {
    const int r = i / cpr;
    const int ch = i - r * cpr;
    const bool in = r0 + r < limit;
    tc::cp_async16(dst + r * ld + ch * 8,
                   (in ? src + (r0 + r) * stride : src) + ch * 8,
                   in ? 16 : 0);
  }
}

// DM: the widest head of this instantiation; EXACT: dh == DM.
template <int DM, bool EXACT>
__global__ void __launch_bounds__(TC_KV_WARPS * 32) fa_bwd_dkdv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int group,
    int Sq, int Sk, int dh_rt, float scale, float scale_log2, int causal,
    Strides qs, Strides ks, Strides vs, Strides dos) {
  constexpr int THREADS = TC_KV_WARPS * 32;
  constexpr int NB = (DM / 16 + 3) / 4;   // 16-column blocks a warp owns
  constexpr int ldp = TC_BQ + PAD;
  const int dh = EXACT ? DM : dh_rt;
  const int ld = dh + PAD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv;
  const int hk = bhk - b * Hkv;
  const int kt0 = blockIdx.y * TC_BK;
  const int rg = warp & 1;     // key rows 16 rg .. 16 rg + 15 of the block
  const int cg = warp >> 1;    // phase 1: queries 16 cg ..; phase 2:
                               // 16-column blocks cg, cg + 4, ...
  const int key_a = kt0 + 16 * rg + g;
  const int key_b = key_a + 8;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);   // TC_BK x ld
  bf16* v_s = k_s + TC_BK * ld;                     // TC_BK x ld
  bf16* q_s = v_s + TC_BK * ld;                     // TC_BQ x ld
  bf16* do_s = q_s + TC_BQ * ld;                    // TC_BQ x ld
  bf16* pt_s = do_s + TC_BQ * ld;                   // TC_BK x ldp: P^T
  bf16* dst_s = pt_s + TC_BK * ldp;                 // TC_BK x ldp: dS^T
  float* lse_s = reinterpret_cast<float*>(dst_s + TC_BK * ldp);  // log2
  float* dl_s = lse_s + TC_BQ;

  stage_rows<THREADS>(k_s, k + b * ks.b + hk * ks.h, ks.s, kt0, TC_BK, Sk,
                      dh, ld);
  stage_rows<THREADS>(v_s, v + b * vs.b + hk * vs.h, vs.s, kt0, TC_BK, Sk,
                      dh, ld);
  tc::cp_async_commit();

  float dk_acc[2 * NB][4], dv_acc[2 * NB][4];
#pragma unroll
  for (int i = 0; i < 2 * NB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.0f;
  const int ao = a_off(lane, ld);
  const int bno = bn_off(lane, ld);
  const int bko = bk_off(lane, ld);
  const int aop = a_off(lane, ldp);
  // causal: queries before the block's first key see none of its keys
  const int q_first = causal ? kt0 / TC_BQ * TC_BQ : 0;

  for (int hi = 0; hi < group; ++hi) {
    const int h = hk * group + hi;
    const long long row0 = (static_cast<long long>(b) * H + h) * Sq;
    for (int qt0 = q_first; qt0 < Sq; qt0 += TC_BQ) {
      __syncthreads();  // the previous tile's phase 2 is done
      stage_rows<THREADS>(q_s, q + b * qs.b + h * qs.h, qs.s, qt0, TC_BQ, Sq,
                          dh, ld);
      stage_rows<THREADS>(do_s, dout + b * dos.b + h * dos.h, dos.s, qt0,
                          TC_BQ, Sq, dh, ld);
      tc::cp_async_commit();
      for (int i = threadIdx.x; i < TC_BQ; i += THREADS) {
        const int r = qt0 + i;
        lse_s[i] = r < Sq ? lse[row0 + r] * LOG2E : 0.0f;
        dl_s[i] = r < Sq ? delta[row0 + r] : 0.0f;
      }
      tc::cp_async_wait<0>();   // K, V (first time) and this tile's Q, dO
      __syncthreads();

      // ---- phase 1: S^T, dP^T of keys 16 rg .. x queries 16 cg .. -------
      float s[2][4], dp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk) {
        if (!EXACT && kk * 16 >= dh) break;
        uint32_t a[4], bq[4];
        tc::ldsm_x4(a, k_s + 16 * rg * ld + kk * 16 + ao);
        tc::ldsm_x4(bq, q_s + 16 * cg * ld + kk * 16 + bno);
        tc::mma_bf16(s[0], a, bq[0], bq[1]);
        tc::mma_bf16(s[1], a, bq[2], bq[3]);
        tc::ldsm_x4(a, v_s + 16 * rg * ld + kk * 16 + ao);
        tc::ldsm_x4(bq, do_s + 16 * cg * ld + kk * 16 + bno);
        tc::mma_bf16(dp[0], a, bq[0], bq[1]);
        tc::mma_bf16(dp[1], a, bq[2], bq[3]);
      }
      // P^T = 2^(s c2 - lse2) and dS^T, each rounded to bf16 (a masked
      // pair is an explicit 0), into shared memory
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int key = half ? key_b : key_a;
          const int col = 16 * cg + 8 * nt + 2 * qd;   // query in the tile
          float pv[2], dsv[2];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int qc = col + e2;
            const int qi = qt0 + qc;
            const bool live = qi < Sq && key < Sk && !(causal && key > qi);
            const float x = s[nt][2 * half + e2];
            const float p = live ? __bfloat162float(__float2bfloat16_rn(
                                       tc::exp2_approx(fmaf(
                                           x, scale_log2, -lse_s[qc]))))
                                 : 0.0f;
            pv[e2] = p;
            dsv[e2] = p * (dp[nt][2 * half + e2] - dl_s[qc]);
          }
          const int row = 16 * rg + g + 8 * half;
          *reinterpret_cast<uint32_t*>(pt_s + row * ldp + col) =
              tc::pack_bf16(pv[0], pv[1]);
          *reinterpret_cast<uint32_t*>(dst_s + row * ldp + col) =
              tc::pack_bf16(dsv[0], dsv[1]);
        }
      __syncthreads();

      // ---- phase 2: dV += P^T dO, dK += dS^T Q on this warp's columns ---
#pragma unroll
      for (int kq = 0; kq < TC_BQ / 16; ++kq) {
        uint32_t ap[4], ad[4];
        tc::ldsm_x4(ap, pt_s + 16 * rg * ldp + kq * 16 + aop);
        tc::ldsm_x4(ad, dst_s + 16 * rg * ldp + kq * 16 + aop);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int cb = cg + 4 * j;
          if (cb * 16 >= dh) break;            // uniform in the warp
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, do_s + kq * 16 * ld + cb * 16 + bko);
          tc::mma_bf16(dv_acc[2 * j], ap, bf[0], bf[1]);
          tc::mma_bf16(dv_acc[2 * j + 1], ap, bf[2], bf[3]);
          tc::ldsm_x4_t(bf, q_s + kq * 16 * ld + cb * 16 + bko);
          tc::mma_bf16(dk_acc[2 * j], ad, bf[0], bf[1]);
          tc::mma_bf16(dk_acc[2 * j + 1], ad, bf[2], bf[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();   // the K/V copy, when no query tile ran

  // ---- dK (times the scale, which Q did not carry) and dV, as bf16 ------
  const long long base = (static_cast<long long>(b) * Hkv + hk) * Sk;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int cb = cg + 4 * j;
    if (cb * 16 >= dh) break;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int col = cb * 16 + 8 * t + 2 * qd;
      const int i = 2 * j + t;
      if (key_a < Sk) {
        *reinterpret_cast<uint32_t*>(dk + (base + key_a) * dh + col) =
            tc::pack_bf16(dk_acc[i][0] * scale, dk_acc[i][1] * scale);
        *reinterpret_cast<uint32_t*>(dv + (base + key_a) * dh + col) =
            tc::pack_bf16(dv_acc[i][0], dv_acc[i][1]);
      }
      if (key_b < Sk) {
        *reinterpret_cast<uint32_t*>(dk + (base + key_b) * dh + col) =
            tc::pack_bf16(dk_acc[i][2] * scale, dk_acc[i][3] * scale);
        *reinterpret_cast<uint32_t*>(dv + (base + key_b) * dh + col) =
            tc::pack_bf16(dv_acc[i][2], dv_acc[i][3]);
      }
    }
  }
}

template <int DM, int BN, bool EXACT>
__global__ void __launch_bounds__(TC_Q_WARPS * 32) fa_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int group, int Sq, int Sk, int dh_rt,
    float scale, float scale_log2, int causal, Strides qs, Strides ks,
    Strides vs, Strides dos) {
  constexpr int THREADS = TC_Q_WARPS * 32;
  const int dh = EXACT ? DM : dh_rt;
  const int ld = dh + PAD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const int r0 = blockIdx.y * TC_BM;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // TC_BM x ld
  bf16* do_s = q_s + TC_BM * ld;                    // TC_BM x ld
  bf16* k_s = do_s + TC_BM * ld;                    // BN x ld
  bf16* v_s = k_s + BN * ld;                        // BN x ld

  stage_rows<THREADS>(q_s, q + b * qs.b + h * qs.h, qs.s, r0, TC_BM, Sq, dh,
                      ld);
  stage_rows<THREADS>(do_s, dout + b * dos.b + h * dos.h, dos.s, r0, TC_BM,
                      Sq, dh, ld);
  tc::cp_async_commit();

  const int wr0 = r0 + 16 * warp;
  const int row_a = wr0 + g;
  const int row_b = row_a + 8;
  const long long row0 = static_cast<long long>(bh) * Sq;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    lse2[r] = row < Sq ? lse[row0 + row] * LOG2E : 0.0f;
    dl[r] = row < Sq ? delta[row0 + row] : 0.0f;
  }
  const int n_keys = causal ? min(Sk, r0 + TC_BM) : Sk;
  const int warp_keys = wr0 >= Sq ? 0 : (causal ? min(Sk, wr0 + 16) : Sk);
  const int ao = a_off(lane, ld);
  const int bno = bn_off(lane, ld);
  const int bko = bk_off(lane, ld);
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  float acc[DM / 8][4];
#pragma unroll
  for (int i = 0; i < DM / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int kt0 = 0; kt0 < n_keys; kt0 += BN) {
    __syncthreads();  // the previous tile consumed
    stage_rows<THREADS>(k_s, kb, ks.s, kt0, BN, Sk, dh, ld);
    stage_rows<THREADS>(v_s, vb, vs.s, kt0, BN, Sk, dh, ld);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();   // Q, dO (first time) and this tile
    __syncthreads();
    if (kt0 >= warp_keys) continue;   // uniform in the warp
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.0f;
    // ---- S = Q K^T, dP = dO V^T (f32) --------------------------------------
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk) {
      if (!EXACT && kk * 16 >= dh) break;
      uint32_t a[4];
      tc::ldsm_x4(a, q_s + 16 * warp * ld + kk * 16 + ao);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t bf[4];
        tc::ldsm_x4(bf, k_s + np * 16 * ld + kk * 16 + bno);
        tc::mma_bf16(s[2 * np], a, bf[0], bf[1]);
        tc::mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
      }
      tc::ldsm_x4(a, do_s + 16 * warp * ld + kk * 16 + ao);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t bf[4];
        tc::ldsm_x4(bf, v_s + np * 16 * ld + kk * 16 + bno);
        tc::mma_bf16(dp[2 * np], a, bf[0], bf[1]);
        tc::mma_bf16(dp[2 * np + 1], a, bf[2], bf[3]);
      }
    }
    // ---- P rounded to bf16, then dS (into s); a masked pair is 0 ---------
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt0 + nt * 8 + 2 * qd + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        const bool live = row < Sq && col < Sk && !(causal && col > row);
        const float p = live ? __bfloat162float(__float2bfloat16_rn(
                                   tc::exp2_approx(fmaf(
                                       s[nt][e], scale_log2, -lse2[e >> 1]))))
                             : 0.0f;
        s[nt][e] = p * (dp[nt][e] - dl[e >> 1]);
      }
    // ---- dQ += dS K, dS rounded to bf16 in registers ----------------------
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      uint32_t pa[4];
      pa[0] = tc::pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = tc::pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = tc::pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = tc::pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dp2 = 0; dp2 < DM / 16; ++dp2) {
        if (!EXACT && dp2 * 16 >= dh) break;
        uint32_t bf[4];
        tc::ldsm_x4_t(bf, k_s + j * 16 * ld + dp2 * 16 + bko);
        tc::mma_bf16(acc[2 * dp2], pa, bf[0], bf[1]);
        tc::mma_bf16(acc[2 * dp2 + 1], pa, bf[2], bf[3]);
      }
    }
  }
  tc::cp_async_wait<0>();   // the Q, dO copy, when no key tile ran

  // ---- dQ = scale acc, as bf16 --------------------------------------------
#pragma unroll
  for (int nt = 0; nt < DM / 8; ++nt) {
    if (!EXACT && nt * 8 >= dh) break;
    const int c = nt * 8 + 2 * qd;
    if (row_a < Sq)
      *reinterpret_cast<uint32_t*>(dq + (row0 + row_a) * dh + c) =
          tc::pack_bf16(acc[nt][0] * scale, acc[nt][1] * scale);
    if (row_b < Sq)
      *reinterpret_cast<uint32_t*>(dq + (row0 + row_b) * dh + c) =
          tc::pack_bf16(acc[nt][2] * scale, acc[nt][3] * scale);
  }
}

template <int DM, bool EXACT>
cudaError_t launch_tc(const Args& a, cudaStream_t st) {
  cudaError_t err = launch_delta<bf16>(a.o, a.dout, a.delta, a.B, a.H, a.Sq,
                                       a.dh, a.os, a.dos, st);
  if (err != cudaSuccess) return err;
  const int group = a.H / a.Hkv;
  const float scale_log2 = a.scale * LOG2E;
  if (a.Sk > 0) {
    const size_t smem = tc_dkdv_smem_bytes(a.dh);
    auto fn = fa_bwd_dkdv_tc_kernel<DM, EXACT>;
    err = set_smem(fn, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.B * a.Hkv, (a.Sk + TC_BK - 1) / TC_BK);
    fn<<<grid, TC_KV_WARPS * 32, smem, st>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
        a.H, a.Hkv, group, a.Sq, a.Sk, a.dh, a.scale, scale_log2, a.causal,
        a.qs, a.ks, a.vs, a.dos);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t smem = tc_dq_smem_bytes(a.dh);
  auto fn = fa_bwd_dq_tc_kernel<DM, key_tile(DM), EXACT>;
  err = set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sq + TC_BM - 1) / TC_BM);
  fn<<<grid, TC_Q_WARPS * 32, smem, st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.dq), a.H, group, a.Sq, a.Sk, a.dh,
      a.scale, scale_log2, a.causal, a.qs, a.ks, a.vs, a.dos);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

Args make_args(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk,
               int dh, float scale, int causal, const long long* st) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.o = o, a.dout = dout;
  a.lse = lse, a.delta = delta, a.dq = dq, a.dk = dk, a.dv = dv;
  a.B = B, a.H = H, a.Hkv = Hkv, a.Sq = Sq, a.Sk = Sk, a.dh = dh;
  a.scale = scale, a.causal = causal;
  Strides* s[5] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos};
  for (int i = 0; i < 5; ++i) *s[i] = Strides{st[3 * i], st[3 * i + 1],
                                              st[3 * i + 2]};
  return a;
}

}  // namespace

extern "C" {

// The "cuda_core" design.  Given q (B, H, Sq, dh), k, v (B, Hkv, Sk, dh),
// the forward's output o and lse (B, H, Sq) float32, and dout like o,
// writes dq (B, H, Sq, dh) and dk, dv (B, Hkv, Sk, dh), contiguous, in
// the inputs' dtype; delta (B, H, Sq) float32 is the caller's workspace.
// q, k, v, o and dout are reached through their (batch, head, row)
// element strides, given in that order, with a unit-stride last dim.
// dtype 0 is float32, 1 bfloat16.  Needs dh % 4 == 0, dh <= 256,
// H % Hkv == 0, and Sq == Sk when causal.  Returns the CUDA error code
// (0 on success).
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int H, int Hkv, int Sq, int Sk, int dh,
    float scale, int causal, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh,
    long long oss, long long dsb, long long dsh, long long dss,
    void* stream) {
  if (dh <= 0 || dh % 4 != 0 || dh > MAX_DH || Hkv <= 0 || H % Hkv != 0 ||
      (causal && Sq != Sk) || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const long long st[15] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh,
                            vss, osb, osh, oss, dsb, dsh, dss};
  const Args a = make_args(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                           Hkv, Sq, Sk, dh, scale, causal, st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = dh > 128;
  if (dtype == 0)
    return wide ? launch_cc<float, 2>(a, s) : launch_cc<float, 1>(a, s);
  return wide ? launch_cc<bf16, 2>(a, s) : launch_cc<bf16, 1>(a, s);
}

// The "tensor_core" design: as flash_attention_bwd_launch, bf16 only, and
// needs dh % 16 == 0, dh <= 256, and every pointer and (batch, head, row)
// stride 16-byte aligned.  Returns the CUDA error code (0 on success).
int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int H, int Hkv, int Sq, int Sk, int dh, float scale,
    int causal, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss,
    long long dsb, long long dsh, long long dss, void* stream) {
  const long long st[15] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh,
                            vss, osb, osh, oss, dsb, dsh, dss};
  bool ok = dh > 0 && dh % 16 == 0 && dh <= MAX_DH && Hkv > 0 &&
            H % Hkv == 0 && !(causal && Sq != Sk);
  for (const void* p : {q, k, v, o, dout, static_cast<const void*>(dq),
                        static_cast<const void*>(dk),
                        static_cast<const void*>(dv)})
    ok = ok && aligned16(p);
  for (long long s : st) ok = ok && s % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Args a = make_args(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                           Hkv, Sq, Sk, dh, scale, causal, st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) return launch_tc<64, true>(a, s);
  if (dh < 64) return launch_tc<64, false>(a, s);
  if (dh == 128) return launch_tc<128, true>(a, s);
  if (dh < 128) return launch_tc<128, false>(a, s);
  if (dh == 256) return launch_tc<256, true>(a, s);
  return launch_tc<256, false>(a, s);
}

// Dynamic shared bytes of one block: design 0 "cuda_core", 1
// "tensor_core"; kernel 0 dK/dV, 1 dQ (the wrapper's bwd_plan mirrors
// them).
long long flash_attention_bwd_smem_bytes(int design, int kernel, int dh) {
  if (design == 1)
    return static_cast<long long>(kernel == 0 ? tc_dkdv_smem_bytes(dh)
                                              : tc_dq_smem_bytes(dh));
  return static_cast<long long>(kernel == 0 ? cc_dkdv_smem_bytes(dh)
                                            : cc_dq_smem_bytes(dh));
}

}  // extern "C"
