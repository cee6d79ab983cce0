// Fused p-stable LSH hash floor((x a + b) / w) -> int32, hand-written for
// Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel of the reference package:
//   lsh_hash_kernel <- src/repro/kernels/lsh_hash.py lsh_hash_pallas
//                      (_lsh_hash_kernel).
// It computes out[i][k] = floor((sum_d x[i][d] a[d][k] + b[k]) / w) for x
// (n, d) float32 or bf16 read through its strides, a (d, K) and b (K,)
// float32, as int32 (n, K).  Each dot is one ascending chain of IEEE
// float32 fused multiply-adds (never TF32); the sum plus b is divided by
// w, as the plain version and the port's hash_h do (the TPU kernel
// multiplies by 1/w, which moves a few floors).
//
// What bounds it on an H100.  At the index's Map-phase shape (2**22 points,
// d = 64, K = 20) the bytes: x is read once (4 B a value) and the ints
// written once, 1.41 GB, against 2 d K = 2,560 FLOPs a row, about 7.6
// FLOP a byte, well below the float32 CUDA-core balance of about 20.
//
// Design (simple and right first; not tuned):
//  * a block takes ROWS = 256 rows, one per thread.  The TPU kernel pads n
//    to 128 rows and K to 128 lanes; here the last row tile is masked and
//    K is walked in column chunks of KC = 32 held in registers, so any n
//    and K are taken without padding;
//  * x is staged in depth slabs of DS = 64 values per row, coalesced along
//    d, at a row stride of DS + 1 floats, so the threads' reads of their
//    own rows fall on distinct banks; the slab of a (DS x KC) is read as
//    a broadcast;
//  * the int32 results of a chunk are staged and written back along the
//    row-major output, so a warp's stores are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 256;   // rows per block, one per thread
constexpr int DS = 64;      // depth of a staged x slab
constexpr int KC = 32;      // columns per register chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr size_t SMEM_BYTES =
    (ROWS * (DS + 1) + DS * KC + KC) * sizeof(float) + ROWS * KC * sizeof(int);

template <typename T>
__global__ void __launch_bounds__(ROWS) lsh_hash_kernel(
    const T* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ b, int* __restrict__ out, long long n, int d,
    int K, float w, long long xs0, long long xs1) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                      // ROWS x (DS + 1)
  float* a_s = x_s + ROWS * (DS + 1);     // DS x KC
  float* b_s = a_s + DS * KC;             // KC
  int* o_s = reinterpret_cast<int*>(b_s + KC);  // ROWS x KC

  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(min(static_cast<long long>(ROWS), n - r0));
  const T* xb = x + r0 * xs0;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kw = min(KC, K - k0);
    float acc[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) acc[j] = 0.0f;
    for (int d0 = 0; d0 < d; d0 += DS) {
      const int dw = min(DS, d - d0);
      __syncthreads();  // the previous slab is consumed
      for (int i = tid; i < ROWS * DS; i += ROWS) {
        const int r = i / DS;
        const int c = i - r * DS;
        x_s[r * (DS + 1) + c] =
            (r < rows && c < dw) ? to_f32(xb[r * xs0 + (d0 + c) * xs1]) : 0.0f;
      }
      for (int i = tid; i < DS * KC; i += ROWS) {
        const int r = i / KC;
        const int c = i - r * KC;
        a_s[i] = (r < dw && c < kw)
                     ? a[static_cast<long long>(d0 + r) * K + k0 + c] : 0.0f;
      }
      __syncthreads();
      const float* xr = x_s + tid * (DS + 1);
      for (int c = 0; c < dw; ++c) {
        const float xv = xr[c];
        const float4* ar = reinterpret_cast<const float4*>(a_s + c * KC);
#pragma unroll
        for (int j = 0; j < KC / 4; ++j) {
          const float4 av = ar[j];
          acc[4 * j + 0] = __fmaf_rn(xv, av.x, acc[4 * j + 0]);
          acc[4 * j + 1] = __fmaf_rn(xv, av.y, acc[4 * j + 1]);
          acc[4 * j + 2] = __fmaf_rn(xv, av.z, acc[4 * j + 2]);
          acc[4 * j + 3] = __fmaf_rn(xv, av.w, acc[4 * j + 3]);
        }
      }
    }
    if (tid < KC) b_s[tid] = tid < kw ? b[k0 + tid] : 0.0f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KC; ++j)
      o_s[tid * KC + j] =
          static_cast<int>(floorf(__fdiv_rn(__fadd_rn(acc[j], b_s[j]), w)));
    __syncthreads();
    // write the chunk back row-major: out[r0 + r][k0 + c]
    for (int i = tid; i < rows * kw; i += ROWS) {
      const int r = i / kw;
      const int c = i - r * kw;
      out[(r0 + r) * K + k0 + c] = o_s[r * KC + c];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* a, const float* b, int* out,
                   long long n, int d, int K, float w, long long xs0,
                   long long xs1, cudaStream_t st) {
  auto fn = lsh_hash_kernel<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const long long blocks = (n + ROWS - 1) / ROWS;
  fn<<<static_cast<unsigned>(blocks), ROWS, SMEM_BYTES, st>>>(
      static_cast<const T*>(x), a, b, out, n, d, K, w, xs0, xs1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (n, K) int32, row-major, from x (n, d) reached through its element
// strides (xs0, xs1), a (d, K) and b (K,) float32 contiguous, and w > 0.
// dtype 0 is float32, 1 bfloat16 (x only).  Returns the CUDA error code
// (0 on success).
int lsh_hash_launch(const void* x, const void* a, const void* b, void* out,
                    int dtype, long long n, int d, int K, float w,
                    long long xs0, long long xs1, void* stream) {
  if (d <= 0 || K <= 0 || n < 0 || !(w > 0.0f) || dtype < 0 || dtype > 1 ||
      (n + ROWS - 1) / ROWS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  int* op = static_cast<int*>(out);
  if (dtype == 0)
    return launch<float>(x, ap, bp, op, n, d, K, w, xs0, xs1, st);
  return launch<__nv_bfloat16>(x, ap, bp, op, n, d, K, w, xs0, xs1, st);
}

}  // extern "C"
