// The three-term bf16 split of an f32 matrix, for the unembedding's
// backward on tensor cores (models/layers.py UnembedProduct): the f32
// cotangent enters bf16 GEMMs with f32 accumulation as three exact terms.
//
// g (rows, cols) f32, rows ld elements apart -> parts (rows, 3, cols) bf16,
// the terms in ascending order lo, mid, hi: hi = bf16(g), mid = bf16(g -
// hi), lo = bf16(g - hi - mid), each rounded to nearest even. (hi + mid) +
// lo is g wherever |g| is 0 or at least 2^-110. Ascending, so that a GEMM
// contracting over [lo | mid | hi] adds the small terms while its
// accumulator is still small: the tensor cores' accumulator truncates.
// Both subtractions are exact in f32 and no product is near them, so no
// contraction into an FMA can move them; subnormals are kept (the build
// has no -ftz), as PyTorch's plain split keeps them.
//
// One pass: each element read once (4 bytes) and three bf16 written (6
// bytes), against 38 bytes an element for the same split in five PyTorch
// ops. A block of internlm2-1.8b's train microbatch, 16,384 x 2,048, is
// 336 MB: 0.10 ms at 3.35 TB/s, so the bound is bytes. A thread takes 4
// floats of a row (one 16-byte load, streaming past the caches, and one
// 8-byte store per part) where the row stride, the width and the base
// allow, neighbouring threads on neighbouring bytes; else one element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // H100 SMs x resident blocks of 256

__device__ __forceinline__ void split_one(float x, __nv_bfloat16& hi,
                                          __nv_bfloat16& mid,
                                          __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  r = r - __bfloat162float(mid);
  lo = __float2bfloat16_rn(r);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    split_bf16x3_kernel(const float* __restrict__ g, int64_t ld,
                        __nv_bfloat16* __restrict__ parts, int64_t rows,
                        int64_t cols) {
  const int64_t per_row = cols / V;
  const int64_t items = rows * per_row;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < items; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t row = i / per_row;
    const int64_t col = (i - row * per_row) * V;
    const float* src = g + row * ld + col;
    __nv_bfloat16* dst = parts + row * 3 * cols + col;
    float x[V];
    if constexpr (V == 4) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(src));
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
      x[0] = __ldcs(src);
    }
    alignas(8) __nv_bfloat16 t[3][V];
#pragma unroll
    for (int k = 0; k < V; ++k) split_one(x[k], t[2][k], t[1][k], t[0][k]);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if constexpr (V == 4) {
        *reinterpret_cast<uint2*>(dst + p * cols) =
            *reinterpret_cast<const uint2*>(t[p]);
      } else {
        dst[p * cols] = t[p][0];
      }
    }
  }
}

template <int V>
int launch(const float* g, int64_t ld, __nv_bfloat16* parts, int64_t rows,
           int64_t cols, cudaStream_t stream) {
  const int64_t items = rows * (cols / V);
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  split_bf16x3_kernel<V><<<blocks, kThreads, 0, stream>>>(g, ld, parts, rows,
                                                          cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// g: (rows, cols) float32 with row stride ld (elements), unit column
// stride; parts: (rows, 3, cols) bfloat16, contiguous, lo, mid, hi. vec 4
// needs cols and ld multiples of 4 and g 16-byte aligned (kernels/bf16x3.py
// checks); vec 1 takes any. rows * cols > 0.
int split_bf16x3(const void* g, long long ld, void* parts, long long rows,
                 long long cols, int vec, void* stream) {
  if (vec != 1 && vec != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4 && (cols % 4 || ld % 4 ||
                   reinterpret_cast<uintptr_t>(g) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* out = static_cast<__nv_bfloat16*>(parts);
  auto* in = static_cast<const float*>(g);
  auto s = static_cast<cudaStream_t>(stream);
  return vec == 4 ? launch<4>(in, ld, out, rows, cols, s)
                  : launch<1>(in, ld, out, rows, cols, s);
}

}  // extern "C"
