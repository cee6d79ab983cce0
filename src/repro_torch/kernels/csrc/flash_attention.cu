// Online-softmax (flash) attention, hand-written for Hopper (sm_90a), with
// a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel of the reference package:
//   flash_attention_kernel <- src/repro/kernels/flash_attention.py
//                             flash_attention_pallas (_flash_kernel).
// It computes what _flash_kernel computes: f32 scores of (q * scale) . k
// read in f32 from f32 or bf16 inputs, GQA through kv head = h / group,
// the causal mask rows >= cols (top-left; the wrapper takes causal only
// with Sq == Sk), keys past Sk left out, a running max and sum and an f32
// accumulator, and the output acc / max(l, 1e-30) in the inputs' dtype.
//
// What bounds it on an H100.  At the embedder's shapes (Sq = Sk = 128,
// dh = 256, bf16) the bytes: q, k, v and o are each read or written once
// (2 B a value) against 4 * Sq * Sk / 2 * dh FLOPs per head of causal
// work, about 32 FLOP a byte, well below the 295 at which bf16 tensor
// cores would be the limit.
//
// Design (simple and right first; not tuned):
//  * one warp owns one query row; a block holds WARPS consecutive rows of
//    one (batch, head), so the K/V tiles it stages in shared memory serve
//    WARPS rows.  The TPU kernel's sequential kv grid axis becomes the
//    loop over key tiles inside the block; nothing carries between blocks;
//  * a key tile is TILE_K = 32 keys, one per lane: lane j computes the
//    whole score of key t0 + j against the row's scaled q (staged once in
//    shared memory, read as a broadcast), so the tile's max and sum take
//    one warp reduction each, not one per key;
//  * the K tile is staged at row stride dh + 4 floats, so the lanes' float4
//    reads of their own keys fall on distinct banks; V rows are read by
//    all lanes along dh, each lane owning the float4 columns
//    128 g + 4 lane (g < G = ceil(dh / 128)) of the accumulator;
//  * causal: a block stages keys up to its last row only, and each warp
//    stops at its own row, so no masked tile is visited and no score is
//    ever -inf inside the sums (a masked key contributes exactly 0, as
//    exp(-1e30 - m) does in the TPU kernel);
//  * strides are arguments (the last dim must be unit-stride), so q, k, v
//    and o can be views of the (B, S, H, dh) projections: no copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 16;       // query rows per block, one warp each
constexpr int TILE_K = 32;      // keys per staged tile, one per lane
constexpr int MAX_DH = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {  // element strides of (batch, head, row)
  long long b, h, s;
};

template <typename T, int G>
__global__ void __launch_bounds__(WARPS * 32) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int H, int group, int Sq,
    int Sk, int dh, float scale, int causal, Strides qs, Strides ks,
    Strides vs, Strides os) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const int r0 = blockIdx.y * WARPS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = r0 + warp;
  const int dhp = dh + 4;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // WARPS x dh, pre-scaled
  float* k_s = q_s + WARPS * dh;       // TILE_K x dhp
  float* v_s = k_s + TILE_K * dhp;     // TILE_K x dh

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int idx = threadIdx.x; idx < WARPS * dh; idx += blockDim.x) {
    const int w = idx / dh;
    const int c = idx - w * dh;
    const int r = r0 + w;
    q_s[idx] = r < Sq ? __fmul_rn(to_f32(qb[r * qs.s + c]), scale) : 0.0f;
  }
  // keys this block needs, and this warp's row
  const int last = min(Sq, r0 + WARPS);
  const int n_keys = causal ? min(Sk, last) : Sk;
  const int my_keys = row < Sq ? (causal ? min(Sk, row + 1) : Sk) : 0;

  float m = -INFINITY;
  float l = 0.0f;
  float4 acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* my_q = reinterpret_cast<const float4*>(q_s + warp * dh);
  const float4* my_k = reinterpret_cast<const float4*>(k_s + lane * dhp);

  for (int t0 = 0; t0 < n_keys; t0 += TILE_K) {
    __syncthreads();  // q staged / the previous tile consumed
    for (int idx = threadIdx.x; idx < TILE_K * dh; idx += blockDim.x) {
      const int j = idx / dh;
      const int c = idx - j * dh;
      const int key = t0 + j;
      const bool in = key < Sk;
      k_s[j * dhp + c] = in ? to_f32(kb[key * ks.s + c]) : 0.0f;
      v_s[idx] = in ? to_f32(vb[key * vs.s + c]) : 0.0f;
    }
    __syncthreads();
    const int n_here = min(TILE_K, my_keys - t0);  // uniform in the warp
    if (n_here <= 0) continue;

    float s = -INFINITY;
    if (lane < n_here) {
      float dot = 0.0f;
      for (int c = 0; c < dh / 4; ++c) {
        const float4 a = my_q[c];
        const float4 kk = my_k[c];
        dot = fmaf(a.x, kk.x, dot);
        dot = fmaf(a.y, kk.y, dot);
        dot = fmaf(a.z, kk.z, dot);
        dot = fmaf(a.w, kk.w, dot);
      }
      s = dot;
    }
    float tmax = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, off));
    const float m_new = fmaxf(m, tmax);       // finite: lane 0 holds a key
    const float p = lane < n_here ? expf(s - m_new) : 0.0f;
    const float corr = expf(m - m_new);       // 0 on the first tile
    float psum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      psum += __shfl_xor_sync(FULL, psum, off);
    l = l * corr + psum;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g].x *= corr;
      acc[g].y *= corr;
      acc[g].z *= corr;
      acc[g].w *= corr;
    }
    for (int j = 0; j < n_here; ++j) {
      const float pj = __shfl_sync(FULL, p, j);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int col = 128 * g + 4 * lane;
        if (col < dh) {
          const float4 vv = *reinterpret_cast<const float4*>(v_s + j * dh + col);
          acc[g].x = fmaf(pj, vv.x, acc[g].x);
          acc[g].y = fmaf(pj, vv.y, acc[g].y);
          acc[g].z = fmaf(pj, vv.z, acc[g].z);
          acc[g].w = fmaf(pj, vv.w, acc[g].w);
        }
      }
    }
    m = m_new;
  }
  if (row >= Sq) return;
  const float den = fmaxf(l, 1e-30f);
  T* orow = o + b * os.b + h * os.h + row * os.s;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int col = 128 * g + 4 * lane;
    if (col < dh) {
      store(orow + col + 0, acc[g].x / den);
      store(orow + col + 1, acc[g].y / den);
      store(orow + col + 2, acc[g].z / den);
      store(orow + col + 3, acc[g].w / den);
    }
  }
}

template <typename T, int G>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int Sq, int Sk, int dh, float scale,
                   int causal, Strides qs, Strides ks, Strides vs, Strides os,
                   cudaStream_t st) {
  const size_t smem =
      static_cast<size_t>(WARPS * dh + TILE_K * (dh + 4) + TILE_K * dh) * 4;
  auto fn = flash_attention_kernel<T, G>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B * H, (Sq + WARPS - 1) / WARPS);
  fn<<<grid, WARPS * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / Hkv, Sq, Sk, dh,
      scale, causal, qs, ks, vs, os);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Attention of q (B, H, Sq, dh) against k, v (B, Hkv, Sk, dh), written to
// o (B, H, Sq, dh); every tensor is reached through its (batch, head,
// row) element strides with a unit-stride last dim.  dtype 0 is float32,
// 1 bfloat16 (all four tensors alike).  Needs dh % 4 == 0, dh <= 256,
// H % Hkv == 0, and Sq == Sk when causal.  Returns the CUDA error code
// (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int Hkv, int Sq,
                           int Sk, int dh, float scale, int causal,
                           long long qsb, long long qsh, long long qss,
                           long long ksb, long long ksh, long long kss,
                           long long vsb, long long vsh, long long vss,
                           long long osb, long long osh, long long oss,
                           void* stream) {
  if (dh <= 0 || dh % 4 != 0 || dh > MAX_DH || Hkv <= 0 || H % Hkv != 0 ||
      (causal && Sq != Sk) || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = dh > 128;
  if (dtype == 0)
    return wide ? launch<float, 2>(q, k, v, o, B, H, Hkv, Sq, Sk, dh, scale,
                                   causal, qs, ks, vs, os, st)
                : launch<float, 1>(q, k, v, o, B, H, Hkv, Sq, Sk, dh, scale,
                                   causal, qs, ks, vs, os, st);
  return wide ? launch<__nv_bfloat16, 2>(q, k, v, o, B, H, Hkv, Sq, Sk, dh,
                                         scale, causal, qs, ks, vs, os, st)
              : launch<__nv_bfloat16, 1>(q, k, v, o, B, H, Hkv, Sq, Sk, dh,
                                         scale, causal, qs, ks, vs, os, st);
}

}  // extern "C"
