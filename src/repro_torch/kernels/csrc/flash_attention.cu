// Causal / full flash attention forward for Hopper (sm_90a), with GQA and a
// per-row key-length mask.
//
// Replaces the Pallas TPU kernel flash_attention_tpu
// (src/repro/kernels/flash_attention.py). At the serving shapes
// (S = 512, D = 64) it does about 190 operations per byte it must move, so
// on this card it sits below the bf16 ridge (~295 operations per byte) and
// is bound by bytes in principle. This first version is bound by neither:
// it runs its products on the f32 FMA units out of shared memory, not on
// the tensor cores (no wgmma or TMA yet).
//
// What the design does about the TPU's layout:
// - The TPU walks the k blocks as a sequential grid axis with the running
//   max / denominator / accumulator in VMEM scratch. Here one block owns one
//   (batch, head, 64-row q tile) and loops over the k tiles itself, keeping
//   the running max and denominator and its share of the accumulator in
//   registers.
// - K/V stay at KV heads: head h reads KV head h / (H / KV), so the
//   repeated K/V are never materialised.
// - Keys are masked by causality and by kpos < lengths[b] with -1e30 (not
//   -inf), so a row without a valid key averages V as the full softmax
//   does. k tiles past the diagonal or past lengths[b] are skipped. The
//   ragged edge (S not a multiple of 64) is masked in the kernel.
// - p is rounded to the input type before the PV product, as the model's
//   XLA path does; the denominator sums the unrounded p and is floored at
//   1e-30.
//
// Plain C interface, loaded with ctypes. The entry returns the value of
// cudaGetLastError() after its launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kTX = 16;                 // threads along keys / head dim
constexpr int kTY = kThreads / kTX;     // threads along query rows
constexpr float kNegInf = -1e30f;       // the reference's mask value
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int D>
constexpr int smem_floats() {
  // Q and K tiles padded to D + 1 columns and P to kBlockK + 1 so the
  // column-wise reads of 16 threads hit 16 different banks.
  return kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D +
         kBlockQ * (kBlockK + 1);
}

// q, o: (B, S, H, D); k, v: (B, S, KV, D); lengths: (B,) or null.
// grid = (ceil(S / 64), H, B), block = 128 threads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int* __restrict__ lengths, int S, int H, int KV,
                 int causal, float scale) {
  constexpr int RQ = kBlockQ / kTY;     // query rows per thread
  constexpr int CK = kBlockK / kTX;     // key columns per thread
  constexpr int CD = D / kTX;           // output columns per thread
  constexpr int DP = D + 1;
  constexpr int KP = kBlockK + 1;

  extern __shared__ float smem[];
  float* Qs = smem;                     // kBlockQ x DP
  float* Ks = Qs + kBlockQ * DP;        // kBlockK x DP
  float* Vs = Ks + kBlockK * DP;        // kBlockK x D
  float* Ps = Vs + kBlockK * D;         // kBlockQ x KP

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int len = lengths ? lengths[b] : S;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D, s = q0 + r;
    Qs[r * DP + c] = s < S ? to_f32(q[(((int64_t)b * S + s) * H + h) * D + c]) : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[a][c] = 0.f;
  }

  // Keys at or past kend are masked for every row of this tile, except when
  // lengths[b] == 0: then no key is valid and every row averages all S.
  int kend = causal ? min(S, q0 + kBlockQ) : S;
  if (len > 0) kend = min(kend, len);
  else kend = S;

  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();                    // the last tile's readers are done
    for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D, s = k0 + r;
      const int64_t g = (((int64_t)b * S + s) * KV + kvh) * D + c;
      Ks[r * DP + c] = s < S ? to_f32(k[g]) : 0.f;
      Vs[r * D + c] = s < S ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float sc[RQ][CK];
#pragma unroll
    for (int a = 0; a < RQ; ++a)
#pragma unroll
      for (int j = 0; j < CK; ++j) sc[a][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int a = 0; a < RQ; ++a) qv[a] = Qs[(ty + a * kTY) * DP + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Ks[(tx + j * kTX) * DP + d];
#pragma unroll
      for (int a = 0; a < RQ; ++a)
#pragma unroll
        for (int j = 0; j < CK; ++j) sc[a][j] = fmaf(qv[a], kv[j], sc[a][j]);
    }

#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      const int qpos = q0 + ty + a * kTY;
      float mx = m[a];
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kpos = k0 + tx + j * kTX;
        const bool ok = kpos < len && (!causal || kpos <= qpos);
        // keys past S do not exist: they take no share of the softmax
        const float s = kpos >= S ? -INFINITY : (ok ? sc[a][j] * scale : kNegInf);
        sc[a][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = expf(m[a] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(sc[a][j] - mx);
        sum += p;
        Ps[(ty + a * kTY) * KP + tx + j * kTX] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[a] = l[a] * corr + sum;
      m[a] = mx;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[a][c] *= corr;
    }
    __syncthreads();                    // P is written

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[j * D + tx + c * kTX];
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
        const float p = Ps[(ty + a * kTY) * KP + j];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[a][c] = fmaf(p, vv[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int row = q0 + ty + a * kTY;
    if (row >= S) continue;
    const float den = fmaxf(l[a], 1e-30f);
    T* out = o + (((int64_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) out[tx + c * kTX] = from_f32<T>(acc[a][c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* lengths, int B, int S, int H, int KV, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  // once per instantiation and device, so that launches inside a CUDA graph
  // capture make no attribute call
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lengths, S, H, KV, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. D must be 64 or 128 (the wrapper checks).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        const void* lengths, int B, int S, int H, int KV,
                        int D, int causal, float scale, int dtype,
                        void* stream) {
  if (B == 0 || S == 0) return 0;
  const int* len = (const int*)lengths;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, len, B, S, H, KV, causal, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, len, B, S, H, KV, causal, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, len, B, S, H, KV, causal, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, len, B, S, H, KV, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
