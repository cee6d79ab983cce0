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
// products where a one-pass design has five, and must add dQ's partial
// sums across key tiles with atomics (not bitwise) or through memory (at
// the training shape ~0.56 GB more traffic, four times the bound).
//
// Two designs; the wrapper's bwd_plan (kernels/flash_attention.py) picks
// one before the launch, never after a failure:
//
// "tensor_core" (bf16, dh % 16 == 0, every pointer and stride 16-byte
// aligned and every stride positive: the training path's every launch).
// Every product on wgmma (csrc/hopper_wgmma.cuh), bf16 -> f32, its
// shared-memory operands written by TMA (128-byte swizzle, zeros past each
// extent, so ragged tiles need no special load) through a ring of stages.
// A block is two consumer warpgroups and a producer warpgroup, one thread
// of which issues every copy and waits on "empty" mbarriers while the
// consumers wait on "full" ones, so the next tiles' copies run under this
// tile's products; the producer gives all but 40 of its registers to the
// consumers (setmaxnreg: 232 each).  The head width is padded to 64, 128 or
// 256 (columns past dh are zeros).  A delta pass writes the workspace: lse
// in log2 units and delta, each padded with zeros to whole 64-row tiles,
// so that a tile's 64 values are one aligned 256-byte bulk copy.
//  * dK/dV (fa_bwd_dkdv_tc_kernel): TC_BK = 64 keys, their K and V tiles
//    resident; a ring of KV_STAGES = 2 stages of Q and dO tiles of 64
//    queries with their lse2 and delta.  dK and dV of 64 keys in float32
//    (2 x 64 x 256 / 128 = 256 registers a thread at dh = 256) do not fit
//    one warpgroup, so warpgroup 0 owns dV and warpgroup 1 dK.  Warpgroup
//    0: S^T = K Q^T (m64n64, both K-major from shared memory), P^T =
//    2^(s c2 - lse2) (c2 the scale) rounded to bf16 in registers, then dV
//    += P^T dO with P^T as the A operand in registers (its accumulator
//    layout is the A layout) and dO MN-major (the transpose bit).
//    Warpgroup 1 meanwhile: dP^T = V dO^T; it takes P^T (8 KB, bf16,
//    thread for thread in the accumulator layout) through shared memory
//    behind a named barrier, forms dS^T = P^T (dP^T - delta) rounded to
//    bf16, and adds dK += dS^T Q.  202 KB of shared memory at dh = 256:
//    one block an SM.
//  * dQ (fa_bwd_dq_tc_kernel): TC_QROWS = 128 query rows, 64 a warpgroup,
//    Q and dO resident; a ring of DQ_STAGES = 3 stages of K and V tiles of
//    dq_key_tile keys (64 up to dh = 128, 32 above).  S = Q K^T and dP =
//    dO V^T (K-major) as two groups of products, P's exponentials while dP
//    runs, dS = P (dP - delta) rounded to bf16 in registers as the A
//    operand of dQ += dS K (K MN-major), left running into the next
//    tile's products.  225 KB at dh = 256.
// Only a tile on the causal diagonal or a ragged edge tests each element's
// mask.  Blocks go heaviest first (the first key tiles, the last query
// tiles of a causal mask) within groups of heads whose streamed tiles fit
// L2 together; a tile's descriptors are built once and stepped by adding
// offsets.
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
// operations, barely.  This design spends seven products (60 GFLOP,
// 0.061 ms at the peak rate).  What holds it above that, measured by
// taking parts out (PERF.md, PR 22): the consumers' instruction issue
// (each tile's exponentials, masks and product issue share a scheduler
// with the other warpgroup's), the dQ kernel's S and dP products, m64n32
// at dh = 256 and so bound by reading their operands from shared memory,
// and the dK/dV block's two warpgroups, coupled through P^T.  Loads are
// not: taking the streamed copies out moves neither kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <initializer_list>

#include "hopper_mma.cuh"
#include "hopper_wgmma.cuh"

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
// "tensor_core": bf16 on wgmma, fed by TMA through a ring of stages (see the
// header note)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_BK = 64;       // keys a dK/dV block owns
constexpr int TC_BQ = 64;       // queries of a dK/dV stage
constexpr int TC_QROWS = 128;   // query rows a dQ block owns, 64 a warpgroup
constexpr int KV_STAGES = 2;    // staged Q, dO tile pairs of a dK/dV block
constexpr int DQ_STAGES = 3;    // staged K, V tile pairs of a dQ block
constexpr long long L2_SHARE = 16 << 20;   // bytes a group of heads keeps
                                           // in L2 (of its 50 MB)
constexpr int CONSUMERS = 2 * 128;   // threads of the two consumer warpgroups
constexpr int TC_THREADS = CONSUMERS + 128;   // and the producer's
// registers a thread: 384 threads start at 168 (65,536 / 384, rounded
// down to 8); the producer gives back all but PRODUCER_REGS, and each
// consumer takes CONSUMER_REGS (2 x 128 x 232 + 128 x 40 <= 65,536)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int BAR_BYTES = 64;   // the mbarriers, after the tiles
constexpr int SWZ = 1024;       // alignment of a swizzled tile

// The head width rounded up to whole 64-column panels (columns past dh
// read as zeros), and the keys of a dQ block's stage at that width.
__host__ __device__ constexpr int padded(int dh) {
  return dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
}
__host__ __device__ constexpr int dq_key_tile(int dmp) {
  return dmp <= 128 ? 64 : 32;
}

// the dK/dV block's shared memory: K, V, the ring of Q, dO tiles, P^T and
// each stage's 64 lse2 and delta values
size_t tc_dkdv_smem_bytes(int dh) {
  const size_t tile = static_cast<size_t>(TC_BK) * padded(dh) * 2;
  return SWZ + (2 + 2 * KV_STAGES) * tile + TC_BK * TC_BQ * 2 +
         KV_STAGES * 2 * TC_BQ * 4 + BAR_BYTES;
}

size_t tc_dq_smem_bytes(int dh) {
  const int dmp = padded(dh);
  return SWZ + static_cast<size_t>(2 * TC_QROWS +
                                   2 * DQ_STAGES * dq_key_tile(dmp)) * dmp * 2 +
         BAR_BYTES;
}

__device__ __forceinline__ uint8_t* align_swz(uint8_t* p) {
  return p + ((SWZ - (wg::smem_u32(p) & (SWZ - 1))) & (SWZ - 1));
}

struct TcShape {
  int n_bh, head_group, H, Hkv, group, Sq, Sk, dh;
  int Sq_pad;   // rows of each (batch, head) in the lse2 and delta workspace
  float scale, scale_log2;
  int causal;
};

// This block's (batch, head) pair of n_bh and tile of n_tiles.  Heads go in
// groups of head_group, whose tiles of the other operand fit L2 together;
// a group runs tile 0 of each of its heads, then tile 1, ...
__device__ __forceinline__ void block_tile(int n_bh, int head_group,
                                           int n_tiles, int& bh, int& t) {
  const int per_group = head_group * n_tiles;
  const int grp = blockIdx.x / per_group;
  const int rem = blockIdx.x - grp * per_group;
  const int heads = min(head_group, n_bh - grp * head_group);
  t = rem / heads;
  bh = grp * head_group + rem - t * heads;
}

// The tensor-core design's workspace: lse2 = lse log2(e) (the lse in log2
// units) and delta_i = sum_d dO_id O_id, each (B, H, Sq_pad), zero past Sq,
// so that a tile of 64 rows is one aligned 256-byte copy.  One warp a row,
// 8 columns a lane by 16-byte loads (dh % 16 == 0, 16-byte-aligned rows).
__global__ void __launch_bounds__(DELTA_WARPS * 32) fa_bwd_delta_tc_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ lse2,
    float* __restrict__ delta, int H, int Sq, int Sq_pad, int dh,
    long long rows, Strides os, Strides dos) {
  const long long r =
      static_cast<long long>(blockIdx.x) * DELTA_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const long long bh = r / Sq_pad;
  const int i = static_cast<int>(r - bh * Sq_pad);
  if (i >= Sq) {
    if (lane == 0) lse2[r] = delta[r] = 0.0f;
    return;
  }
  const int b = static_cast<int>(bh / H);
  const int h = static_cast<int>(bh - static_cast<long long>(b) * H);
  const bf16* orow = o + b * os.b + h * os.h + i * os.s;
  const bf16* drow = dout + b * dos.b + h * dos.h + i * dos.s;
  float acc = 0.0f;
  for (int c = 8 * lane; c < dh; c += 256) {
    const uint4 x = *reinterpret_cast<const uint4*>(orow + c);
    const uint4 y = *reinterpret_cast<const uint4*>(drow + c);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
    const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = tc::unpack_bf16(xs[j]);
      const float2 d = tc::unpack_bf16(ys[j]);
      acc = fmaf(d.x, a.x, acc);
      acc = fmaf(d.y, a.y, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) {
    delta[r] = acc;
    lse2[r] = lse[bh * Sq + i] * LOG2E;
  }
}

// One consumer warpgroup of a dK/dV block.  DK = false owns dV: it computes
// S^T = K Q^T, P^T, hands P^T to the other through shared memory and adds
// P^T dO.  DK = true owns dK: it computes dP^T = V dO^T, takes P^T, forms
// dS^T and adds dS^T Q.
template <int DMP, bool DK>
__device__ __forceinline__ void dkdv_consumer(
    const uint8_t* k_s, const uint8_t* v_s, const uint8_t* st_s,
    uint32_t* pt_s, const float* ld_s, uint64_t* kv_full, uint64_t* full,
    uint64_t* empty, bf16* __restrict__ out, TcShape sh, int b, int hk,
    int kt0, int q_first, int n_qt) {
  constexpr int TILE = TC_BK * DMP * 2;
  constexpr int PANEL = TC_BK * 128;
  const int t = threadIdx.x & 127;
  const int w = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int total = sh.group * n_qt;
  // descriptors: the left operand K or V, K-major; each stage's tiles are
  // described per iteration.  A step inside a view adds its byte offset / 16
  // (shared addresses stay below 2^18: no carry out of the address field).
  const uint64_t d_left = wg::desc(wg::smem_u32(DK ? v_s : k_s), 16, 1024);
  const uint32_t st0 = wg::smem_u32(st_s);

  float acc[DMP / 2];
#pragma unroll
  for (int i = 0; i < DMP / 2; ++i) acc[i] = 0.0f;
  wg::bar_wait(kv_full, 0);

  for (int it = 0; it < total; ++it) {
    const int s = it % KV_STAGES;
    const int hi = it / n_qt;
    const int qt0 = q_first + (it - hi * n_qt) * TC_BQ;
    const uint32_t q_t = st0 + 2 * s * TILE;
    const uint32_t do_t = q_t + TILE;
    // the first product's right operand (Q or dO, K-major) and the second's
    // (dO or Q, MN-major)
    const uint64_t d_r1 = wg::desc(DK ? do_t : q_t, 16, 1024);
    const uint64_t d_r2 = wg::desc(DK ? q_t : do_t, PANEL, 1024);
    wg::bar_wait(full + s, (it / KV_STAGES) & 1);
    // each thread's 16 query columns: lse2 (for P) or delta, staged
    float cv[16];
    const float* lv = ld_s + s * 2 * TC_BQ + (DK ? TC_BQ : 0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(lv + 8 * j + 2 * qd);
      cv[2 * j] = x.x;
      cv[2 * j + 1] = x.y;
    }

    // ---- S^T = K Q^T or dP^T = V dO^T, over the head width ----------------
    float sa[32];
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DMP / 16; ++kk) {
      const uint32_t off = ((kk >> 2) * PANEL + (kk & 3) * 32) >> 4;
      wg::mma_ss(sa, d_left + off, d_r1 + off, kk > 0);
    }
    wg::commit();
    wg::wait<0>();
    wg::hold(sa);

    // ---- P^T or dS^T, rounded to bf16, as A operands ----------------------
    // element n of sa: key row kt0 + 16 w + g + 8 ((n >> 1) & 1), query
    // column qt0 + 8 (n >> 2) + 2 qd + (n & 1)
    uint32_t a[16];
    if (!DK) {
      // P^T rounded to bf16; only a tile on the diagonal or a ragged edge
      // tests each element's mask
      float p[32];
#pragma unroll
      for (int n = 0; n < 32; ++n)
        p[n] = tc::exp2_approx(
            fmaf(sa[n], sh.scale_log2, -cv[2 * (n >> 2) + (n & 1)]));
      if ((sh.causal && qt0 < kt0 + TC_BK) || qt0 + TC_BQ > sh.Sq ||
          kt0 + TC_BK > sh.Sk) {
        const int key0 = kt0 + 16 * w + g;
        const int q0 = qt0 + 2 * qd;
#pragma unroll
        for (int n = 0; n < 32; ++n) {
          const int key = key0 + 8 * ((n >> 1) & 1);
          const int qi = q0 + 8 * (n >> 2) + (n & 1);
          const bool live = qi < sh.Sq && key < sh.Sk &&
                            !(sh.causal && key > qi);
          p[n] = live ? p[n] : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] = tc::pack_bf16(p[2 * i], p[2 * i + 1]);
      if (it > 0) wg::named_sync(2, CONSUMERS);   // the last P^T was read
#pragma unroll
      for (int i = 0; i < 16; ++i) pt_s[i * 128 + t] = a[i];
      wg::named_arrive(1, CONSUMERS);
    } else {
      wg::named_sync(1, CONSUMERS);
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] = pt_s[i * 128 + t];
      if (it + 1 < total) wg::named_arrive(2, CONSUMERS);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 p = tc::unpack_bf16(a[i]);
        const int c = 2 * (i >> 1);
        a[i] = tc::pack_bf16(p.x * (sa[2 * i] - cv[c]),
                             p.y * (sa[2 * i + 1] - cv[c + 1]));
      }
    }

    // ---- dV += P^T dO or dK += dS^T Q, four steps of 16 queries -----------
    wg::fence();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const uint32_t ak[4] = {a[4 * kb], a[4 * kb + 1], a[4 * kb + 2],
                              a[4 * kb + 3]};
      wg::mma_rs_t(acc, ak, d_r2 + kb * (2048 >> 4), 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::hold(acc);
    wg::hold(a);
    __syncwarp();
    if (lane == 0) wg::bar_arrive(empty + s);
  }

  // ---- dK (times the scale, which Q did not carry) or dV, as bf16 ---------
  const long long base = (static_cast<long long>(b) * sh.Hkv + hk) * sh.Sk;
  const float f = DK ? sh.scale : 1.0f;
#pragma unroll
  for (int j = 0; j < DMP / 8; ++j) {
    const int col = 8 * j + 2 * qd;
    if (col >= sh.dh) break;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int key = kt0 + 16 * w + g + 8 * h2;
      if (key < sh.Sk)
        *reinterpret_cast<uint32_t*>(out + (base + key) * sh.dh + col) =
            tc::pack_bf16(acc[4 * j + 2 * h2] * f,
                          acc[4 * j + 2 * h2 + 1] * f);
    }
  }
}

// dK and dV of TC_BK keys of one kv head: K, V resident, the group's query
// heads' Q and dO tiles through the ring (DMP: the padded head width).
template <int DMP>
__global__ void __launch_bounds__(TC_THREADS, 1) fa_bwd_dkdv_tc_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse2,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, TcShape sh) {
  constexpr int TILE = TC_BK * DMP * 2;
  constexpr int PANEL = TC_BK * 128;
  extern __shared__ uint8_t tc_smem[];
  uint8_t* k_s = align_swz(tc_smem);
  uint8_t* v_s = k_s + TILE;
  uint8_t* st_s = v_s + TILE;   // stage s: Q at 2 s TILE, dO after it
  uint32_t* pt_s = reinterpret_cast<uint32_t*>(st_s + 2 * KV_STAGES * TILE);
  float* ld_s = reinterpret_cast<float*>(pt_s + 16 * 128);   // lse2, delta
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(ld_s + KV_STAGES * 2 * TC_BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + KV_STAGES;

  // heaviest first within a group of heads: under the causal mask the
  // first key tiles see the most queries
  int bhk, kt;
  block_tile(sh.n_bh, sh.head_group, (sh.Sk + TC_BK - 1) / TC_BK, bhk, kt);
  const int b = bhk / sh.Hkv;
  const int hk = bhk - b * sh.Hkv;
  const int kt0 = kt * TC_BK;
  const int q_first = sh.causal ? kt0 : 0;   // causal: Sq == Sk
  const int n_qt = (sh.Sq - q_first + TC_BQ - 1) / TC_BQ;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    wg::bar_init(kv_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      wg::bar_init(full + s, 1);
      wg::bar_init(empty + s, CONSUMERS / 32);   // one arrival a warp
    }
    wg::bar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {   // the producer: one thread's copies
    wg::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS) return;
    // K and V in boxes of the dQ block's key tile (the maps are shared)
    constexpr int KB = dq_key_tile(DMP);
    wg::bar_expect(kv_full, 2 * TILE);
    for (int p = 0; p < DMP / 64; ++p)
      for (int r = 0; r < TC_BK; r += KB) {
        const int off = p * PANEL + r * 128;
        wg::tma_load(k_s + off, &tk, kv_full, 64 * p, kt0 + r, hk, b);
        wg::tma_load(v_s + off, &tv, kv_full, 64 * p, kt0 + r, hk, b);
      }
    const int total = sh.group * n_qt;
    for (int it = 0; it < total; ++it) {
      const int s = it % KV_STAGES;
      if (it >= KV_STAGES) wg::bar_wait(empty + s, (it / KV_STAGES - 1) & 1);
      const int hi = it / n_qt;
      const int qt0 = q_first + (it - hi * n_qt) * TC_BQ;
      const int h = hk * sh.group + hi;
      uint8_t* dst = st_s + 2 * s * TILE;
      float* ld = ld_s + s * 2 * TC_BQ;
      const long long row =
          (static_cast<long long>(b) * sh.H + h) * sh.Sq_pad + qt0;
      wg::bar_expect(full + s, 2 * TILE + 2 * TC_BQ * 4);
      for (int p = 0; p < DMP / 64; ++p) {
        wg::tma_load(dst + p * PANEL, &tq, full + s, 64 * p, qt0, h, b);
        wg::tma_load(dst + TILE + p * PANEL, &tdo, full + s, 64 * p, qt0, h,
                     b);
      }
      wg::bulk_load(ld, lse2 + row, TC_BQ * 4, full + s);
      wg::bulk_load(ld + TC_BQ, delta + row, TC_BQ * 4, full + s);
    }
    return;
  }
  wg::regs_inc<CONSUMER_REGS>();
  if (warp < 4)
    dkdv_consumer<DMP, false>(k_s, v_s, st_s, pt_s, ld_s, kv_full, full,
                              empty, dv, sh, b, hk, kt0, q_first, n_qt);
  else
    dkdv_consumer<DMP, true>(k_s, v_s, st_s, pt_s, ld_s, kv_full, full,
                             empty, dk, sh, b, hk, kt0, q_first, n_qt);
}

// dQ of TC_QROWS query rows of one head, 64 a warpgroup: Q, dO resident,
// the kv head's K and V tiles through the ring.
template <int DMP>
__global__ void __launch_bounds__(TC_THREADS, 1) fa_bwd_dq_tc_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse2,
    const float* __restrict__ delta, bf16* __restrict__ dq, TcShape sh) {
  constexpr int BN = dq_key_tile(DMP);
  constexpr int QPANEL = TC_QROWS * 128;
  constexpr int QTILE = DMP / 64 * QPANEL;
  constexpr int KPANEL = BN * 128;
  constexpr int KTILE = DMP / 64 * KPANEL;
  extern __shared__ uint8_t tc_smem[];
  uint8_t* q_s = align_swz(tc_smem);
  uint8_t* do_s = q_s + QTILE;
  uint8_t* st_s = do_s + QTILE;   // stage s: K at 2 s KTILE, V after it
  uint64_t* qd_full =
      reinterpret_cast<uint64_t*>(st_s + 2 * DQ_STAGES * KTILE);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + DQ_STAGES;

  // heaviest first within a group of heads: under the causal mask the last
  // query tiles see the most keys
  const int n_rt = (sh.Sq + TC_QROWS - 1) / TC_QROWS;
  int bh, i;
  block_tile(sh.n_bh, sh.head_group, n_rt, bh, i);
  const int r0 = (sh.causal ? n_rt - 1 - i : i) * TC_QROWS;
  const int b = bh / sh.H;
  const int h = bh - b * sh.H;
  const int hk = h / sh.group;
  const int n_keys = sh.causal ? min(sh.Sk, r0 + TC_QROWS) : sh.Sk;
  const int n_kt = (n_keys + BN - 1) / BN;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    wg::bar_init(qd_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      wg::bar_init(full + s, 1);
      wg::bar_init(empty + s, CONSUMERS / 32);
    }
    wg::bar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {   // the producer: one thread's copies
    wg::regs_dec<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS) return;
    wg::bar_expect(qd_full, 2 * QTILE);
    for (int p = 0; p < DMP / 64; ++p)
      for (int half = 0; half < 2; ++half) {
        const int off = p * QPANEL + half * (QPANEL / 2);
        wg::tma_load(q_s + off, &tq, qd_full, 64 * p, r0 + 64 * half, h, b);
        wg::tma_load(do_s + off, &tdo, qd_full, 64 * p, r0 + 64 * half, h,
                     b);
      }
    for (int it = 0; it < n_kt; ++it) {
      const int s = it % DQ_STAGES;
      if (it >= DQ_STAGES) wg::bar_wait(empty + s, (it / DQ_STAGES - 1) & 1);
      uint8_t* dst = st_s + 2 * s * KTILE;
      wg::bar_expect(full + s, 2 * KTILE);
      for (int p = 0; p < DMP / 64; ++p) {
        wg::tma_load(dst + p * KPANEL, &tk, full + s, 64 * p, it * BN, hk, b);
        wg::tma_load(dst + KTILE + p * KPANEL, &tv, full + s, 64 * p,
                     it * BN, hk, b);
      }
    }
    return;
  }

  // ---- a consumer warpgroup: query rows r0 + 64 wq .. r0 + 64 wq + 63 ------
  wg::regs_inc<CONSUMER_REGS>();
  // broadcast from lane 0, so that the compiler knows it uniform in the
  // warp and keeps the descriptors built from it in uniform registers
  const int wq = __shfl_sync(FULL, warp >> 2, 0);
  const int t = threadIdx.x & 127;
  const int w = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int wr0 = r0 + 64 * wq;
  const int row_a = wr0 + 16 * w + g;
  const int row_b = row_a + 8;
  const long long row0 = static_cast<long long>(bh) * sh.Sq;
  float lr[2], dl[2];   // lse2 and delta of the two rows (0 past Sq)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = static_cast<long long>(bh) * sh.Sq_pad +
                          min(r ? row_b : row_a, sh.Sq_pad - 1);
    lr[r] = lse2[row];
    dl[r] = delta[row];
  }
  // keys any row of this warpgroup sees, and the key tiles holding them (a
  // prefix of the block's)
  const int wg_keys = sh.causal ? min(sh.Sk, wr0 + 64) : sh.Sk;
  const int n_mine = min(n_kt, (wg_keys + BN - 1) / BN);
  // descriptors (see the dK/dV block's): this warpgroup's rows of Q and dO,
  // and each stage's K and V
  const uint64_t d_q = wg::desc(wg::smem_u32(q_s) + wq * (QPANEL / 2), 16,
                                1024);
  const uint64_t d_do = wg::desc(wg::smem_u32(do_s) + wq * (QPANEL / 2), 16,
                                 1024);
  const uint32_t st0 = wg::smem_u32(st_s);
  const auto k_tile = [&](int t) {
    return st0 + 2 * (t % DQ_STAGES) * KTILE;
  };
  const auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) wg::bar_arrive(empty + t % DQ_STAGES);
  };

  float acc[DMP / 2];
#pragma unroll
  for (int j = 0; j < DMP / 2; ++j) acc[j] = 0.0f;
  wg::bar_wait(qd_full, 0);

  // Key tile t: S = Q K^T and dP = dO V^T over the head width, issued as
  // two groups behind tile t - 1's dQ product; P (the exponentials) while
  // dP runs; then dS = P (dP - delta), rounded to bf16 as A operands, and
  // dQ += dS K, left running into the next tile's products.
  float sa[BN / 2], pa[BN / 2];
  for (int t = 0; t < n_mine; ++t) {
    wg::bar_wait(full + t % DQ_STAGES, (t / DQ_STAGES) & 1);
    const uint32_t k_t = k_tile(t);
    const uint64_t d_k = wg::desc(k_t, 16, 1024);
    const uint64_t d_v = wg::desc(k_t + KTILE, 16, 1024);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DMP / 16; ++kk) {
      const uint32_t qo = ((kk >> 2) * QPANEL + (kk & 3) * 32) >> 4;
      const uint32_t ko = ((kk >> 2) * KPANEL + (kk & 3) * 32) >> 4;
      wg::mma_ss(sa, d_q + qo, d_k + ko, kk > 0);
    }
    wg::commit();
#pragma unroll
    for (int kk = 0; kk < DMP / 16; ++kk) {
      const uint32_t qo = ((kk >> 2) * QPANEL + (kk & 3) * 32) >> 4;
      const uint32_t ko = ((kk >> 2) * KPANEL + (kk & 3) * 32) >> 4;
      wg::mma_ss(pa, d_do + qo, d_v + ko, kk > 0);
    }
    wg::commit();
    wg::wait<1>();   // tile t - 1's dQ product and tile t's S
    wg::hold(sa);
    wg::hold(acc);
    if (t > 0) release(t - 1);
    // P rounded to bf16 into sa; only a tile on the diagonal or a ragged
    // edge tests each element's mask (element n: row row_a + 8 ((n >> 1) &
    // 1), key kt0 + 8 (n >> 2) + 2 qd + (n & 1))
#pragma unroll
    for (int n = 0; n < BN / 2; ++n)
      sa[n] = __bfloat162float(__float2bfloat16_rn(tc::exp2_approx(
          fmaf(sa[n], sh.scale_log2, -lr[(n >> 1) & 1]))));
    const int kt0 = t * BN;
    if ((sh.causal && kt0 + BN > wr0) || kt0 + BN > sh.Sk ||
        wr0 + 64 > sh.Sq) {
#pragma unroll
      for (int n = 0; n < BN / 2; ++n) {
        const int row = (n >> 1) & 1 ? row_b : row_a;
        const int col = kt0 + 8 * (n >> 2) + 2 * qd + (n & 1);
        const bool live = row < sh.Sq && col < sh.Sk &&
                          !(sh.causal && col > row);
        sa[n] = live ? sa[n] : 0.0f;
      }
    }
    wg::wait<0>();   // dP
    wg::hold(pa);
    // dS = P (dP - delta), rounded to bf16 as A operands; dQ += dS K
    uint32_t a[BN / 4];
#pragma unroll
    for (int i2 = 0; i2 < BN / 4; ++i2) {
      const int n = 2 * i2;
      const int r = (n >> 1) & 1;
      a[i2] = tc::pack_bf16(sa[n] * (pa[n] - dl[r]),
                            sa[n + 1] * (pa[n + 1] - dl[r]));
    }
    const uint64_t d_kmn = wg::desc(k_t, KPANEL, 1024);
    wg::fence();
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb) {
      const uint32_t ak[4] = {a[4 * kb], a[4 * kb + 1], a[4 * kb + 2],
                              a[4 * kb + 3]};
      wg::mma_rs_t(acc, ak, d_kmn + kb * (2048 >> 4), 1);
    }
    wg::commit();
  }
  wg::wait<0>();
  wg::hold(acc);
  if (n_mine > 0) release(n_mine - 1);
  for (int t = n_mine; t < n_kt; ++t) {   // tiles past this warpgroup's
    wg::bar_wait(full + t % DQ_STAGES, (t / DQ_STAGES) & 1);   // keys
    release(t);
  }

  // ---- dQ = scale acc, as bf16 ----------------------------------------------
#pragma unroll
  for (int j = 0; j < DMP / 8; ++j) {
    const int col = 8 * j + 2 * qd;
    if (col >= sh.dh) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row_b : row_a;
      if (row < sh.Sq)
        *reinterpret_cast<uint32_t*>(dq + (row0 + row) * sh.dh + col) =
            tc::pack_bf16(acc[4 * j + 2 * r] * sh.scale,
                          acc[4 * j + 2 * r + 1] * sh.scale);
    }
  }
}

// set_smem once a device for each kernel (whose shared memory its template
// arguments fix; `done` is that kernel's own): the call costs host time.
template <typename F>
cudaError_t set_smem_once(F* fn, size_t smem, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = set_smem(fn, smem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// cuTensorMapEncodeTiled, reached through the runtime (no libcuda link).
using EncodeFn = decltype(&cuTensorMapEncodeTiled);

EncodeFn encode_fn() {
  static const EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeFn>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a (B, heads, S, dh) bf16 view with element strides st:
// boxes of 64 columns x `rows` rows of one (batch, head), 128-byte swizzle,
// zeros past each extent.
bool tensor_map(CUtensorMap* map, const void* p, int B, int heads, int S,
                int dh, Strides st, int rows) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  // an extent of 1 is never stepped over: any legal stride does
  const cuuint64_t strides[3] = {
      S > 1 ? static_cast<cuuint64_t>(st.s) * 2 : 16,
      heads > 1 ? static_cast<cuuint64_t>(st.h) * 2 : 16,
      B > 1 ? static_cast<cuuint64_t>(st.b) * 2 : 16};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DMP>
cudaError_t launch_tc(const Args& a, cudaStream_t st) {
  const int Sq_pad = (a.Sq + TC_BQ - 1) / TC_BQ * TC_BQ;
  const long long rows = static_cast<long long>(a.B) * a.H * Sq_pad;
  float* lse2 = a.delta;   // the workspace: lse2, then delta
  float* delta = a.delta + rows;
  fa_bwd_delta_tc_kernel<<<static_cast<unsigned>(
                               (rows + DELTA_WARPS - 1) / DELTA_WARPS),
                           DELTA_WARPS * 32, 0, st>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout), a.lse,
      lse2, delta, a.H, a.Sq, Sq_pad, a.dh, rows, a.os, a.dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.Sk == 0)   // no key: dq is 0, dk and dv are empty
    return cudaMemsetAsync(a.dq, 0,
                           sizeof(bf16) * a.B * a.H * a.Sq * a.dh, st);
  constexpr int BN = dq_key_tile(DMP);
  CUtensorMap tq, tdo, tk, tv;   // boxes of 64 query rows, of BN keys
  if (!tensor_map(&tq, a.q, a.B, a.H, a.Sq, a.dh, a.qs, TC_BQ) ||
      !tensor_map(&tdo, a.dout, a.B, a.H, a.Sq, a.dh, a.dos, TC_BQ) ||
      !tensor_map(&tk, a.k, a.B, a.Hkv, a.Sk, a.dh, a.ks, BN) ||
      !tensor_map(&tv, a.v, a.B, a.Hkv, a.Sk, a.dh, a.vs, BN))
    return cudaErrorInvalidValue;
  const int group = a.H / a.Hkv;
  TcShape sh{a.B * a.Hkv, 1,       a.H,             a.Hkv,   group,
             a.Sq,        a.Sk,    a.dh,            Sq_pad,  a.scale,
             a.scale * LOG2E,      a.causal};
  // heads a group: the query heads' Q and dO of a dK/dV block's kv head,
  // the kv head's K and V of a dQ block, within L2_SHARE
  const auto head_group = [&](long long bytes, int n_bh) {
    return static_cast<int>(
        std::max(1LL, std::min<long long>(n_bh, L2_SHARE / bytes)));
  };
  sh.head_group = head_group(4LL * group * a.Sq * DMP, sh.n_bh);
  const long long kv_blocks =
      static_cast<long long>(sh.n_bh) * ((a.Sk + TC_BK - 1) / TC_BK);
  const long long q_blocks = static_cast<long long>(a.B) * a.H *
                             ((a.Sq + TC_QROWS - 1) / TC_QROWS);
  if (kv_blocks > INT_MAX || q_blocks > INT_MAX)
    return cudaErrorInvalidConfiguration;
  {
    const size_t smem = tc_dkdv_smem_bytes(a.dh);
    auto fn = fa_bwd_dkdv_tc_kernel<DMP>;
    static bool done[64] = {};
    err = set_smem_once(fn, smem, done);
    if (err != cudaSuccess) return err;
    fn<<<static_cast<unsigned>(kv_blocks), TC_THREADS, smem, st>>>(
        tq, tdo, tk, tv, lse2, delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), sh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  sh.n_bh = a.B * a.H;
  sh.head_group = head_group(4LL * a.Sk * DMP, sh.n_bh);
  const size_t smem = tc_dq_smem_bytes(a.dh);
  auto fn = fa_bwd_dq_tc_kernel<DMP>;
  static bool done[64] = {};
  err = set_smem_once(fn, smem, done);
  if (err != cudaSuccess) return err;
  fn<<<static_cast<unsigned>(q_blocks), TC_THREADS, smem, st>>>(
      tq, tdo, tk, tv, lse2, delta, static_cast<bf16*>(a.dq), sh);
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
// stride 16-byte aligned and every stride positive (TMA's tensor maps).
// Its workspace `delta` holds 2 B H Sq_pad floats, Sq_pad = Sq rounded up
// to a multiple of 64 (lse in log2 units, then delta).  Returns the CUDA
// error code (0 on success).
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
  for (long long s : st) ok = ok && s % 8 == 0 && s > 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Args a = make_args(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H,
                           Hkv, Sq, Sk, dh, scale, causal, st);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 64) return launch_tc<64>(a, s);
  if (dh <= 128) return launch_tc<128>(a, s);
  return launch_tc<256>(a, s);
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
