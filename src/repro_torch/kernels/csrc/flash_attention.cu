// Online-softmax (flash) attention, hand-written for Hopper (sm_90a), with
// a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel of the reference package:
//   flash_attention_kernel, flash_attention_tc_kernel
//     <- src/repro/kernels/flash_attention.py flash_attention_pallas
//        (_flash_kernel).
// Both compute what _flash_kernel computes: f32 scores scale * (q . k)
// from f32 or bf16 inputs, GQA through kv head = h / group, the causal
// mask rows >= cols (top-left; the wrapper takes causal only with
// Sq == Sk), keys past Sk left out, a running max and sum and an f32
// accumulator, and the output acc / max(l, 1e-30) in the inputs' dtype.
// Strides are arguments (the last dim must be unit-stride), so q, k, v
// and o can be views of the (B, S, H, dh) projections: no copies.
// On request (a non-null lse) both designs also write each row's
// log-sum-exp, lse = m + log(max(l, 1e-30)) in natural units of the
// scaled scores, as the reference's custom VJP keeps it
// (src/repro/models/flash_xla.py _fwd): the training backward
// (csrc/flash_attention_bwd.cu) recomputes P = exp(s - lse) from it.  The
// tensor-core design holds m and l in log2 units of the raw dots and
// converts once, at the row's end; the output's bits do not depend on
// whether lse is written.
//
// What bounds it on an H100.  At the embedder's shapes (Sq = Sk = 128,
// dh = 256, bf16) the bytes: q, k, v and o are each read or written once
// (2 B a value) against 4 * Sq * Sk / 2 * dh FLOPs per head of causal
// work, about 32 FLOP a byte, well below the 295 at which bf16 tensor
// cores would be the limit.  So a kernel near its bound streams K and V
// while the products run, keeps enough blocks in flight to cover the
// memory latency, and does not spend CUDA-core cycles on the products.
//
// Two designs; the wrapper's plan (kernels/flash_attention.py, `plan`)
// picks one by dtype, shape and alignment, never after a failure:
//
// "tensor_core" (flash_attention_tc_kernel): bf16, dh % 16 == 0,
// dh <= 256, every pointer and (batch, head, row) stride 16-byte aligned
// -- every bf16 input of the embedders and the card tests.  FA2-shaped:
//  * a block of 4 warps owns TC_BM = 64 query rows of one (batch, head),
//    16 rows a warp; the grid is (B * H, ceil(Sq / 64)), walked so that
//    the row blocks of one head run side by side (K and V come from L2
//    the second time) and the longest causal blocks start first;
//  * Q goes to shared memory by 16-byte cp.async; K and V tiles of
//    key_tile(dh) keys (64 up to dh = 128, 32 above) go through a
//    two-stage cp.async ring, so the next tile loads while this one is
//    computed.  Rows are padded by 16 bytes, which makes every ldmatrix
//    conflict-free.  At dh = 256: 33 KB of Q plus 2 x 2 x 16.5 KB of K
//    and V, 99 KB, two blocks an SM;
//  * S = Q K^T runs on mma.sync m16n8k16 bf16 -> f32 with fragments from
//    ldmatrix; the scale is applied to the f32 scores (in log2 units, for
//    exp2), never to a bf16 q, which would add a rounding the reference
//    does not have;
//  * the online softmax runs on the accumulator fragments, quad shuffles
//    for each row's max (of the raw dots: the scale is positive), and
//    p = 2^(s c - m c) as one FMA and the SFU's ex2.approx (c the scale
//    in log2 units; relative error ~2^-22, below P's bf16 step); each
//    thread keeps partial row sums, reduced once at the end, and a warp
//    vote skips the accumulator's rescale when no row max moved;
//  * P is rounded to bf16 in registers as the A operand of P V (as FA2
//    does; the TPU kernel's MXU takes bf16 passes of it too), and V's
//    fragments come from ldmatrix.trans.  The f32 O accumulator lives in
//    registers: dh / 2 floats a thread, 128 at dh = 256;
//  * causal: a block loads keys up to its last row, each warp skips the
//    tiles above its own rows, and only a tile that crosses the diagonal
//    (or Sk) is masked.  Every visited tile holds, for every row, at least
//    the key at the tile's start, so the row max is finite and a masked
//    score contributes an explicit 0: no -inf ever enters a sum;
//  * the output, acc times one reciprocal a row, goes back through the
//    warp's own Q rows in shared memory and leaves as 16-byte stores;
//  * at dh == 64, 128, 256 every loop bound is a constant, and each
//    thread's staging pieces a constant count, unrolled.
// At gemma-7b's layer it runs within a few percent of PyTorch's fused
// attention (PERF.md).  Of what was tried on the card, a deeper ring,
// 64-key tiles, 128-row blocks and FA2's split K/V buffers did no better
// or worse: what moved it were fewer instructions (the epilogue's
// divisions, the exponentials), not the pipeline's shape.
// Operands rounded to bf16: only P (q, k and v are bf16 already).
//
// "cuda_core" (flash_attention_kernel): float32 (the card tests hold it
// to the reference at 2e-5, which bf16 products could not meet) and any
// bf16 input the tensor-core design does not take (dh % 16 != 0,
// unaligned views).  The first, simple design, unchanged:
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
//    exp(-1e30 - m) does in the TPU kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

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
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int H, int group, int Sq, int Sk, int dh, float scale, int causal,
    Strides qs, Strides ks, Strides vs, Strides os) {
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
  if (lse != nullptr && lane == 0)   // m is in units of the scaled scores
    lse[static_cast<long long>(bh) * Sq + row] = m + logf(den);
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

size_t cuda_core_smem_bytes(int dh) {
  return static_cast<size_t>(WARPS * dh + TILE_K * (dh + 4) + TILE_K * dh) *
         4;
}

template <typename T, int G>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int Sq, int Sk, int dh,
                   float scale, int causal, Strides qs, Strides ks,
                   Strides vs, Strides os, cudaStream_t st) {
  const size_t smem = cuda_core_smem_bytes(dh);
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, H / Hkv, Sq, Sk,
      dh, scale, causal, qs, ks, vs, os);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "tensor_core": bf16 on mma.sync, cp.async staging (see the header note)
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;     // a block: 4 warps of 16 query rows
constexpr int TC_STAGES = 2;    // K/V tiles in the cp.async ring

__host__ __device__ constexpr int key_tile(int dh) {
  return dh <= 128 ? 64 : 32;
}

// Q, then the ring's stages of K and of V, each row dh + 8 bf16.
size_t tc_smem_bytes(int dh) {
  return static_cast<size_t>(16 * TC_WARPS + 2 * TC_STAGES * key_tile(dh)) *
         (dh + 8) * 2;
}

// DM: the widest head of this instantiation; EXACT: dh == DM, so every
// loop bound is a constant.  BN keys a tile.
template <int DM, int BN, bool EXACT>
__global__ void __launch_bounds__(TC_WARPS * 32, 2)
    flash_attention_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int H, int group, int Sq, int Sk, int dh_rt,
    float scale_log2, int causal, Strides qs, Strides ks, Strides vs,
    Strides os) {
  constexpr int BM = 16 * TC_WARPS;
  constexpr int THREADS = 32 * TC_WARPS;
  constexpr int STAGES = TC_STAGES;
  const int dh = EXACT ? DM : dh_rt;
  const int ld = dh + 8;          // shared row stride in elements
  const int cpr = dh / 8;         // 16-byte chunks a row
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;
  // the row blocks of one head are neighbours in launch order, longest
  // (last rows: most causal keys) first
  const int n_rb = gridDim.y;
  const int lin = blockIdx.y * gridDim.x + blockIdx.x;
  const int rb = n_rb - 1 - lin % n_rb;
  const int bh = lin / n_rb;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const int r0 = rb * BM;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + BM * ld;              // [STAGES][BN][ld]
  __nv_bfloat16* v_s = k_s + STAGES * BN * ld;     // [STAGES][BN][ld]

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

  // At dh == DM each thread copies a constant number of 16-byte pieces,
  // so the staging loops unroll with no remainder handling.
  auto q_piece = [&](int i) {
    const int r = i / cpr;
    const int ch = i - r * cpr;
    const bool in = r0 + r < Sq;
    tc::cp_async16(q_s + r * ld + ch * 8,
                   qb + (in ? (r0 + r) * qs.s : 0) + ch * 8, in ? 16 : 0);
  };
  if constexpr (EXACT) {
#pragma unroll
    for (int k = 0; k < BM * (DM / 8) / THREADS; ++k)
      q_piece(tid + k * THREADS);
  } else {
    for (int i = tid; i < BM * cpr; i += THREADS) q_piece(i);
  }
  tc::cp_async_commit();

  const int n_keys = causal ? min(Sk, r0 + BM) : Sk;
  const int n_tiles = (n_keys + BN - 1) / BN;
  // key tile t of K and V into stage t % STAGES
  auto load_kv = [&](int t) {
    const int kt0 = t * BN;
    __nv_bfloat16* kd = k_s + (t % STAGES) * BN * ld;
    __nv_bfloat16* vd = v_s + (t % STAGES) * BN * ld;
    const __nv_bfloat16* kt = kb + kt0 * ks.s;
    const __nv_bfloat16* vt = vb + kt0 * vs.s;
    auto piece = [&](int i) {
      const int r = i / cpr;
      const int ch = i - r * cpr;
      const bool in = kt0 + r < Sk;
      tc::cp_async16(kd + r * ld + ch * 8, (in ? kt + r * ks.s : kb) + ch * 8,
                     in ? 16 : 0);
      tc::cp_async16(vd + r * ld + ch * 8, (in ? vt + r * vs.s : vb) + ch * 8,
                     in ? 16 : 0);
    };
    if constexpr (EXACT) {
#pragma unroll
      for (int k = 0; k < BN * (DM / 8) / THREADS; ++k)
        piece(tid + k * THREADS);
    } else {
      for (int i = tid; i < BN * cpr; i += THREADS) piece(i);
    }
  };
  // the ring: tiles 0 .. STAGES - 2 ahead, one commit group each (empty
  // past the last tile, so the wait count below stays the same)
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    tc::cp_async_commit();
  }

  // this warp's 16 rows, and the keys they see
  const int wr0 = r0 + warp * 16;
  const int warp_keys = wr0 >= Sq ? 0 : (causal ? min(Sk, wr0 + 16) : Sk);
  const int row_a = wr0 + g;      // accumulator rows of this thread
  const int row_b = row_a + 8;
  const __nv_bfloat16* q_frag =
      q_s + (warp * 16 + (lane & 15)) * ld + (lane >> 4) * 8;
  // ldmatrix offsets: K blocks (keys, dims) non-transposed, V transposed
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * ld +
                    ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld +
                    (lane >> 4) * 8;

  float acc[DM / 8][4];
#pragma unroll
  for (int i = 0; i < DM / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.0f, 0.0f};        // this thread's columns only

  for (int t = 0; t < n_tiles; ++t) {
    if (t + STAGES - 1 < n_tiles) load_kv(t + STAGES - 1);
    tc::cp_async_commit();
    tc::cp_async_wait<STAGES - 1>();  // Q and tile t have landed
    __syncthreads();
    const int kt0 = t * BN;
    if (kt0 < warp_keys) {            // uniform in the warp
      const __nv_bfloat16* kst = k_s + (t % STAGES) * BN * ld;
      const __nv_bfloat16* vst = v_s + (t % STAGES) * BN * ld;
      float s[BN / 8][4];             // scores, then P
      // ---- S = Q K^T (raw dot products, f32) ------------------------------
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk) {
        if (!EXACT && kk * 16 >= dh) break;
        uint32_t a[4];
        tc::ldsm_x4(a, q_frag + kk * 16);
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t bf[4];
          tc::ldsm_x4(bf, kst + np * 16 * ld + kk * 16 + k_off);
          tc::mma_bf16(s[2 * np], a, bf[0], bf[1]);
          tc::mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
        }
      }
      // ---- mask the diagonal / ragged tile --------------------------------
      const bool edge = kt0 + BN > Sk || (causal && kt0 + BN - 1 > wr0);
      if (edge) {
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kt0 + nt * 8 + 2 * qd + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            if (col >= Sk || (causal && col > row)) s[nt][e] = -INFINITY;
          }
      }
      // ---- online softmax on the fragments: the max of the raw dots (the
      //      scale is positive), p = exp2(s c - m c) in one FMA, c the
      //      scale in log2 units ---------------------------------------------
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
      float corr[2], msc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // finite mx; 0 on the first tile (m_r = -inf)
        corr[r] = tc::exp2_approx((m_r[r] - mx[r]) * scale_log2);
        m_r[r] = mx[r];
        msc[r] = mx[r] * scale_log2;
      }
      float psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[nt][e];
          const float p =
              (edge && x == -INFINITY)
                  ? 0.0f
                  : tc::exp2_approx(fmaf(x, scale_log2, -msc[e >> 1]));
          s[nt][e] = p;
          psum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + psum[r];
      // no row max of the warp moved: corr is exactly 1, skip the rescale
      if (!__all_sync(0xffffffffu, corr[0] == 1.0f && corr[1] == 1.0f)) {
#pragma unroll
        for (int i = 0; i < DM / 8; ++i) {
          acc[i][0] *= corr[0];
          acc[i][1] *= corr[0];
          acc[i][2] *= corr[1];
          acc[i][3] *= corr[1];
        }
      }
      // ---- O += P V, P rounded to bf16 in registers -----------------------
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        uint32_t pa[4];
        pa[0] = tc::pack_bf16(s[2 * j][0], s[2 * j][1]);
        pa[1] = tc::pack_bf16(s[2 * j][2], s[2 * j][3]);
        pa[2] = tc::pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[3] = tc::pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
        for (int dp = 0; dp < DM / 16; ++dp) {
          if (!EXACT && dp * 16 >= dh) break;
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, vst + j * 16 * ld + dp * 16 + v_off);
          tc::mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
          tc::mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();                  // stage t % STAGES is free again
  }
  tc::cp_async_wait<0>();             // the Q copy, when no tile ran
  __syncthreads();

  // ---- o = acc / max(l, 1e-30), through this warp's Q rows: one division
  //      a row, then multiplies (an f32 ulp apart, far below bf16's) ----
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.0f / fmaxf(l, 1e-30f);
    // the log-sum-exp of the row's scaled scores, in natural units (the
    // reference's): m and the sum are in log2 units of the raw dots here
    const int row = r == 0 ? row_a : row_b;
    if (lse != nullptr && qd == 0 && row < Sq)
      lse[static_cast<long long>(bh) * Sq + row] =
          fmaf(m_r[r], scale_log2, log2f(fmaxf(l, 1e-30f))) *
          0.6931471805599453f;
  }
  __nv_bfloat16* o_s = q_s + warp * 16 * ld;
#pragma unroll
  for (int nt = 0; nt < DM / 8; ++nt) {
    if (!EXACT && nt * 8 >= dh) break;
    const int c = nt * 8 + 2 * qd;
    *reinterpret_cast<uint32_t*>(o_s + g * ld + c) =
        tc::pack_bf16(acc[nt][0] * inv[0], acc[nt][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(o_s + (g + 8) * ld + c) =
        tc::pack_bf16(acc[nt][2] * inv[1], acc[nt][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
  for (int i = lane; i < 16 * cpr; i += 32) {
    const int r = i / cpr;
    const int ch = i - r * cpr;
    if (wr0 + r < Sq)
      *reinterpret_cast<int4*>(ob + (wr0 + r) * os.s + ch * 8) =
          *reinterpret_cast<const int4*>(o_s + r * ld + ch * 8);
  }
}

template <int DM, bool EXACT>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int H, int Hkv, int Sq, int Sk,
                      int dh, float scale, int causal, Strides qs,
                      Strides ks, Strides vs, Strides os, cudaStream_t st) {
  const size_t smem = tc_smem_bytes(dh);
  auto fn = flash_attention_tc_kernel<DM, key_tile(DM), EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + 16 * TC_WARPS - 1) / (16 * TC_WARPS));
  fn<<<grid, 32 * TC_WARPS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, H, H / Hkv, Sq, Sk, dh, scale * 1.4426950408889634f, causal, qs,
      ks, vs, os);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// The "cuda_core" design.  Attention of q (B, H, Sq, dh) against k, v
// (B, Hkv, Sk, dh), written to o (B, H, Sq, dh); every tensor is reached
// through its (batch, head, row) element strides with a unit-stride last
// dim.  Unless lse is null, each row's log-sum-exp of its scaled scores,
// m + log(max(l, 1e-30)) in natural units, goes to lse (B, H, Sq) float32
// (contiguous); the output's bits do not depend on it.  dtype 0 is float32,
// 1 bfloat16 (all four tensors alike).  Needs dh % 4 == 0, dh <= 256,
// H % Hkv == 0, and Sq == Sk when causal.  Returns the CUDA error code
// (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int dtype, int B, int H,
                           int Hkv, int Sq, int Sk, int dh, float scale,
                           int causal,
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
    return wide ? launch<float, 2>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, dh,
                                   scale, causal, qs, ks, vs, os, st)
                : launch<float, 1>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, dh,
                                   scale, causal, qs, ks, vs, os, st);
  return wide ? launch<__nv_bfloat16, 2>(q, k, v, o, lse, B, H, Hkv, Sq, Sk,
                                         dh, scale, causal, qs, ks, vs, os,
                                         st)
              : launch<__nv_bfloat16, 1>(q, k, v, o, lse, B, H, Hkv, Sq, Sk,
                                         dh, scale, causal, qs, ks, vs, os,
                                         st);
}

// Dynamic shared bytes of one block: design 0 "cuda_core", 1
// "tensor_core" (the wrapper's plan mirrors both).
long long flash_attention_smem_bytes(int design, int dh) {
  return static_cast<long long>(design == 1 ? tc_smem_bytes(dh)
                                            : cuda_core_smem_bytes(dh));
}

// The "tensor_core" design: as flash_attention_launch, bf16 only, and
// needs dh % 16 == 0, dh <= 256, and every pointer and (batch, head, row)
// stride 16-byte aligned.  Returns the CUDA error code (0 on success).
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int H, int Hkv,
                              int Sq, int Sk, int dh, float scale,
                              int causal,
                              long long qsb, long long qsh, long long qss,
                              long long ksb, long long ksh, long long kss,
                              long long vsb, long long vsh, long long vss,
                              long long osb, long long osh, long long oss,
                              void* stream) {
  const long long strides[12] = {qsb, qsh, qss, ksb, ksh, kss,
                                 vsb, vsh, vss, osb, osh, oss};
  bool ok = dh > 0 && dh % 16 == 0 && dh <= MAX_DH && Hkv > 0 &&
            H % Hkv == 0 && !(causal && Sq != Sk) && aligned16(q) &&
            aligned16(k) && aligned16(v) && aligned16(o);
  for (long long s : strides) ok = ok && s % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch_tc<64, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk,
                               dh, scale, causal, qs, ks, vs, os, st);
  if (dh < 64)
    return launch_tc<64, false>(q, k, v, o, lse, B, H, Hkv, Sq, Sk,
                                dh, scale, causal, qs, ks, vs, os, st);
  if (dh == 128)
    return launch_tc<128, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk,
                                dh, scale, causal, qs, ks, vs, os, st);
  if (dh < 128)
    return launch_tc<128, false>(q, k, v, o, lse, B, H, Hkv, Sq, Sk,
                                 dh, scale, causal, qs, ks, vs, os, st);
  if (dh == 256)
    return launch_tc<256, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk,
                                dh, scale, causal, qs, ks, vs, os, st);
  return launch_tc<256, false>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, dh,
                               scale, causal, qs, ks, vs, os, st);
}

}  // extern "C"
