// RMSNorm and fused residual-add + RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels rmsnorm_tpu and rmsnorm_residual_tpu
// (src/repro/kernels/rmsnorm.py). Both do about one floating-point operation
// per byte moved, so their bound on the H100 is device-memory bytes: each
// input read once, each output written once. But at the serving shapes (8
// or 512 rows of 768) they move 27 KB to 2.4 MB, a fraction of a
// microsecond at 3.35 TB/s: what sets their time is the launch and the chain
// of dependent steps on a row's critical path. The design shortens that
// chain:
//
// - One warp per row, kRowsPerBlock rows per block, for rows up to
//   kWarpMaxWidth. The sum of squares is reduced by warp shuffles alone: no
//   shared memory and no barrier. 4 warps per block puts (512, 768) on 128
//   blocks, one wave on the 132 SMs, and (8, 768) on 2 blocks; a block of
//   128 threads also stays well inside an SM's limits for any N. The last
//   block's spare warps exit.
// - 16-byte accesses: 8 bf16 or 4 f32 per load and store of x, r, y and s,
//   and 4 f32 per load of w, neighbouring lanes on neighbouring 16 bytes,
//   x, r and w by the read-only path. A bf16 row of 768 is 3 accesses a
//   lane, an f32 row 6.
// - One memory round trip: every load of the row (x, r and w) is issued
//   before any of them is used, so the chain is load -> reduce -> rsqrt ->
//   scale -> store.
// - Registers sized to the row: the warp layout is instantiated for the
//   row widths of the repo's configs up to kWarpMaxWidth (768, 1536 and
//   2048), and a row takes the narrowest of these that covers it. One
//   instantiation for the widest row (8 accesses a lane in bf16) held 145
//   registers and ran a row of 768 no faster than the kernel it replaced.
//
// Rows wider than kWarpMaxWidth, up to kMaxWidth (llama3-405b's d_model),
// take one block per row: 16-byte accesses, the row in registers across up
// to kWideThreads threads, shuffles and then one shared-memory step.
//
// A row whose bytes are not a multiple of 16, or a tensor whose base is not
// 16-byte aligned, takes the scalar instantiation of the same template (one
// element per access) in the block-per-row layout, at any width. No serving
// path gives it such a row. The variants, by the code the C entries take
// (kernels/rmsnorm.py pick_variant chooses; the entries check):
//
//   0 warp     D <= 2048     one warp per row, 16-byte accesses
//   1 wide     D <= 16384    one block per row, 16-byte accesses
//   2 scalar   D <= 16384    one block per row, element accesses
//
// rmsnorm_residual rounds the sum x + r to the input type BEFORE it norms
// it, as the unfused model does (x = x + y; apply_norm(x)). The Pallas body
// norms the f32 sum; in bf16 that differs.
//
// Plain C interface, loaded with ctypes. Each entry returns the value of
// cudaGetLastError() after its launch (0 = success), or
// cudaErrorInvalidValue for a variant that cannot take its arguments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRowsPerBlock = 4;     // warp layout: 4 warps, one row each
constexpr int kWarpMaxWidth = 2048;  // widest row of the warp layout
constexpr int kWideThreads = 1024;   // most threads on one row (wide layout)
constexpr int kMaxWidth = 16384;     // widest row of any variant

// The raw bits of one access: V elements of T, 16 bytes or one element.
template <typename T, int V>
using Raw = std::conditional_t<
    V == 1, std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>, uint4>;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load(const T* p) {
  static_assert(V == 1 || V * sizeof(T) == 16, "one element or 16 bytes");
  return __ldg(reinterpret_cast<const Raw<T, V>*>(p));
}

// A bf16 is the top half of an f32: the low half of a word holds the first.
template <typename T>
__device__ __forceinline__ void unpack_word(uint32_t u, float* out) {
  if constexpr (sizeof(T) == 4) {
    out[0] = __uint_as_float(u);
  } else {
    out[0] = __uint_as_float(u << 16);
    out[1] = __uint_as_float(u & 0xffff0000u);
  }
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& u, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = __uint_as_float(sizeof(T) == 4 ? (uint32_t)u : (uint32_t)u << 16);
  } else {
    constexpr int kPer = 4 / sizeof(T);  // elements in a 32-bit word
    unpack_word<T>(u.x, out);
    unpack_word<T>(u.y, out + kPer);
    unpack_word<T>(u.z, out + 2 * kPer);
    unpack_word<T>(u.w, out + 3 * kPer);
  }
}

// The bits of v in T, rounded to nearest even.
template <typename T>
__device__ __forceinline__ uint32_t bits(float v) {
  if constexpr (sizeof(T) == 4) return __float_as_uint(v);
  else return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 4) return v;
  else return __uint_as_float(bits<T>(v) << 16);
}

template <typename T>
__device__ __forceinline__ uint32_t pack_word(const float* v) {
  if constexpr (sizeof(T) == 4) return bits<T>(v[0]);
  else return bits<T>(v[0]) | (bits<T>(v[1]) << 16);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *reinterpret_cast<Raw<T, 1>*>(p) = (Raw<T, 1>)bits<T>(v[0]);
  } else {
    constexpr int kPer = 4 / sizeof(T);
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_word<T>(v), pack_word<T>(v + kPer),
                   pack_word<T>(v + 2 * kPer), pack_word<T>(v + 3 * kPer));
  }
}

// V floats of the scale: one element, or V / 4 loads of 16 bytes.
template <int V>
__device__ __forceinline__ void load_scale(const float* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = __ldg(p);
  } else {
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + j);
      out[4 * j] = q.x;
      out[4 * j + 1] = q.y;
      out[4 * j + 2] = q.z;
      out[4 * j + 3] = q.w;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block's total of each warp's sum (v in every lane of every warp).
// Every warp adds the partials in the same order, so all get one value.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kWideThreads / 32];
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = v;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  return warp_sum(lane < (int)blockDim.x / 32 ? partial[lane] : 0.f);
}

// RESIDUAL = false: y = rmsnorm(x) * w.
// RESIDUAL = true:  s = T(x + r); y = rmsnorm(s) * w; writes y and s.
// V elements per access (16 bytes, or 1), at most NV accesses per thread.
// WIDE = false: one warp per row, kRowsPerBlock rows per block.
// WIDE = true:  one block per row, blockDim.x a multiple of 32.
template <typename T, bool RESIDUAL, int V, int NV, bool WIDE>
__global__ void __launch_bounds__(WIDE ? kWideThreads : 32 * kRowsPerBlock)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const float* __restrict__ w, T* __restrict__ y,
               T* __restrict__ s_out, int N, int D, float eps) {
  const int row = WIDE ? (int)blockIdx.x
                       : (int)(blockIdx.x * kRowsPerBlock + threadIdx.x / 32);
  const int t = WIDE ? (int)threadIdx.x : (int)(threadIdx.x % 32);
  const int nt = WIDE ? (int)blockDim.x : 32;     // threads on the row
  if (row >= N) return;                           // a whole warp exits
  const int64_t base = (int64_t)row * D;

  // every load of the row is in flight before any of them is used
  Raw<T, V> xs[NV], rs[NV];
  float ws[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (t + i * nt) * V;               // first column of access i
    if (c < D) {
      xs[i] = load<T, V>(x + base + c);
      if constexpr (RESIDUAL) rs[i] = load<T, V>(r + base + c);
      load_scale<V>(w + c, ws[i]);
    }
  }

  float v[NV][V];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (t + i * nt) * V;
    if (c < D) {
      unpack<T, V>(xs[i], v[i]);
      if constexpr (RESIDUAL) {
        float rv[V];
        unpack<T, V>(rs[i], rv);
#pragma unroll
        for (int k = 0; k < V; ++k) v[i][k] = round_to<T>(v[i][k] + rv[k]);
        store<T, V>(s_out + base + c, v[i]);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) ss += v[i][k] * v[i][k];
    }
  }
  ss = warp_sum(ss);
  if constexpr (WIDE) ss = block_sum(ss);
  const float inv = rsqrtf(ss / (float)D + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (t + i * nt) * V;
    if (c < D) {
      float o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = v[i][k] * inv * ws[i][k];
      store<T, V>(y + base + c, o);
    }
  }
}

__global__ void empty_kernel() {}

template <typename T, bool RESIDUAL, int V, int NV, bool WIDE>
void launch_kernel(int grid, int threads, const void* x, const void* r,
                   const void* w, void* y, void* s, int N, int D, float eps,
                   cudaStream_t st) {
  rmsnorm_kernel<T, RESIDUAL, V, NV, WIDE><<<grid, threads, 0, st>>>(
      (const T*)x, (const T*)r, (const float*)w, (T*)y, (T*)s, N, D, eps);
}

// The warp layout with the fewest accesses per lane, from the list NV,
// MORE..., that cover the row: registers sized to the row, and no guarded
// access that is never taken (a bf16 row of 768 runs NV = 3, not 8).
template <typename T, bool RESIDUAL, int V, int NV, int... MORE>
void launch_warp(const void* x, const void* r, const void* w, void* y,
                 void* s, int N, int D, float eps, cudaStream_t st) {
  if constexpr (sizeof...(MORE) > 0) {
    if (D > 32 * V * NV)
      return launch_warp<T, RESIDUAL, V, MORE...>(x, r, w, y, s, N, D, eps, st);
  }
  static_assert(32 * V * NV == kWarpMaxWidth || sizeof...(MORE) > 0,
                "the last entry covers the widest row");
  launch_kernel<T, RESIDUAL, V, NV, false>(
      (N + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, x, r, w,
      y, s, N, D, eps, st);
}

// The wide layout: NV accesses per thread cover kMaxWidth on kWideThreads;
// a narrower row gets the multiple of 32 threads it needs.
template <typename T, bool RESIDUAL, int V>
void launch_wide(const void* x, const void* r, const void* w, void* y,
                 void* s, int N, int D, float eps, cudaStream_t st) {
  constexpr int NV = kMaxWidth / kWideThreads / V;
  const int threads = ((D / V + NV - 1) / NV + 31) / 32 * 32;
  launch_kernel<T, RESIDUAL, V, NV, true>(N, threads, x, r, w, y, s, N, D,
                                          eps, st);
}

template <typename T, bool RESIDUAL>
void launch_dtype(int variant, const void* x, const void* r, const void* w,
                  void* y, void* s, int N, int D, float eps, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  switch (variant) {
    case 0:                      // rows up to 768, 1536, 2048
      launch_warp<T, RESIDUAL, kVec, 768 / 32 / kVec, 1536 / 32 / kVec,
                  2048 / 32 / kVec>(x, r, w, y, s, N, D, eps, st);
      break;
    case 1: launch_wide<T, RESIDUAL, kVec>(x, r, w, y, s, N, D, eps, st); break;
    default: launch_wide<T, RESIDUAL, 1>(x, r, w, y, s, N, D, eps, st); break;
  }
}

bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

template <bool RESIDUAL>
int launch(const void* x, const void* r, const void* w, void* y, void* s,
           int N, int D, float eps, int dtype, int variant, void* stream) {
  const bool vector = variant < 2;
  const int elem = dtype == 0 ? 4 : 2;
  if (variant < 0 || variant > 2 || (dtype != 0 && dtype != 1) || D < 1 ||
      D > (variant == 0 ? kWarpMaxWidth : kMaxWidth) ||
      (vector && ((D * elem) % 16 != 0 || !aligned16(x) || !aligned16(r) ||
                  !aligned16(w) || !aligned16(y) || !aligned16(s))))
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) launch_dtype<float, RESIDUAL>(variant, x, r, w, y, s, N, D, eps, st);
  else launch_dtype<__nv_bfloat16, RESIDUAL>(variant, x, r, w, y, s, N, D, eps, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (N, D) of dtype (0 = float32, 1 = bfloat16); w: (D,) float32.
int rmsnorm_fwd(const void* x, const void* w, void* y, int N, int D,
                float eps, int dtype, int variant, void* stream) {
  return launch<false>(x, nullptr, w, y, nullptr, N, D, eps, dtype, variant,
                       stream);
}

// x, r, y, s: (N, D) of dtype; w: (D,) float32.
int rmsnorm_residual_fwd(const void* x, const void* r, const void* w,
                         void* y, void* s, int N, int D, float eps, int dtype,
                         int variant, void* stream) {
  return launch<true>(x, r, w, y, s, N, D, eps, dtype, variant, stream);
}

// One block of kRowsPerBlock warps that does nothing: the floor under the
// time of any launch.
int rmsnorm_empty(void* stream) {
  empty_kernel<<<1, 32 * kRowsPerBlock, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
