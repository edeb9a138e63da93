// RMSNorm and fused residual-add + RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels rmsnorm_tpu and rmsnorm_residual_tpu
// (src/repro/kernels/rmsnorm.py). Both are bound by device-memory bytes:
// about one floating-point operation per byte moved. So the design reads
// each input element once and writes each output element once: one block
// per row, the row held in registers across the block's threads, the sum of
// squares reduced in f32 through warp shuffles and one shared-memory step.
//
// rmsnorm_residual rounds the sum x + r to the input type BEFORE it norms
// it, as the unfused model does (x = x + y; apply_norm(x)). The Pallas body
// norms the f32 sum; in bf16 that differs.
//
// Plain C interface, loaded with ctypes. Each entry returns the value of
// cudaGetLastError() after its launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // 4 warps per row
constexpr int kMaxPerThread = 16;       // rows up to 128 * 16 = 2048 wide

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum of v over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += partial[w];
  return total;
}

// RESIDUAL = false: y = rmsnorm(x) * w.
// RESIDUAL = true:  s = T(x + r); y = rmsnorm(s) * w; writes y and s.
template <typename T, bool RESIDUAL>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const float* __restrict__ w, T* __restrict__ y,
               T* __restrict__ s_out, int D, float eps) {
  const int64_t base = (int64_t)blockIdx.x * D;
  float v[kMaxPerThread];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    v[i] = 0.f;
    if (c < D) {
      float xv = to_f32(x[base + c]);
      if (RESIDUAL) {
        const T s = from_f32<T>(xv + to_f32(r[base + c]));
        s_out[base + c] = s;
        xv = to_f32(s);
      }
      v[i] = xv;
      ss += xv * xv;
    }
  }
  const float inv = rsqrtf(block_sum(ss) / (float)D + eps);
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < D) y[base + c] = from_f32<T>(v[i] * inv * w[c]);
  }
}

template <bool RESIDUAL>
int launch(const void* x, const void* r, const void* w, void* y, void* s,
           int N, int D, float eps, int dtype, void* stream) {
  if (N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    rmsnorm_kernel<float, RESIDUAL><<<N, kThreads, 0, st>>>(
        (const float*)x, (const float*)r, (const float*)w, (float*)y,
        (float*)s, D, eps);
  } else {
    rmsnorm_kernel<__nv_bfloat16, RESIDUAL><<<N, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)r, (const float*)w,
        (__nv_bfloat16*)y, (__nv_bfloat16*)s, D, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rmsnorm_max_width() { return kThreads * kMaxPerThread; }

// x, y: (N, D) of dtype (0 = float32, 1 = bfloat16); w: (D,) float32.
int rmsnorm_fwd(const void* x, const void* w, void* y, int N, int D,
                float eps, int dtype, void* stream) {
  return launch<false>(x, nullptr, w, y, nullptr, N, D, eps, dtype, stream);
}

// x, r, y, s: (N, D) of dtype; w: (D,) float32.
int rmsnorm_residual_fwd(const void* x, const void* r, const void* w,
                         void* y, void* s, int N, int D, float eps, int dtype,
                         void* stream) {
  return launch<true>(x, r, w, y, s, N, D, eps, dtype, stream);
}

}  // extern "C"
