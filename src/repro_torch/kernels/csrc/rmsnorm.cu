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
// Backward (K2b, K3b): rmsnorm_bwd_kernel, the same template's layouts and
// variants, replaces XLA's gradient of rmsnorm_ref (src/repro/kernels/ref.py)
// and of the model's unfused x + y; norm. Per row, in f32: r = rsqrt(mean(x^2)
// + eps), g = dy w, dx = r (g - x r^2 mean(g x)); K3b reads the saved sum s,
// the cotangents dh (of the normed output) and ds (of the sum), and writes
// dt = ds + dx rounded once to the input type, the gradient of both x and r.
// The two row sums (x^2 and g x) are independent, so they share one
// reduction. It reads two or three rows and writes one: at (2048, 768) bf16,
// 9.4 MB for K2b (2.8 us at 3.35 TB/s) and 12.6 MB for K3b (3.8 us), bound
// by bytes, like the forward.
//
// dw = sum over rows of dy x r needs a sum across rows, which blocks cannot
// share. Each block walks its rows with a grid stride (at most kBwdBlocks
// blocks), keeps its columns' partial sums in registers, combines its
// warps' partials in shared memory in a fixed order, and writes one row of
// an f32 scratch (blocks, D). The same launch then sums those rows
// (dw_tail): every block releases its arrival on a device-wide counter and
// is done, without waiting for the atomic's result; the last few blocks
// (at most kReducers) wait for all arrivals and each sums a slice of dw's
// columns over all partial rows, every column in an order fixed by the
// code, so dw does not depend on scheduling. The only atomics are on the
// counter, never on data. No separate reduction kernel, and no round trip
// of the partials through a second launch.
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
constexpr int kBwdBlocks = 264;      // most blocks of a backward launch (2 per SM)
constexpr int kReducers = 48;        // most blocks that sum dw's columns
constexpr int kReduceLanes = 16;     // dw: threads on one column, adding every 16th row

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

// block_sum for two values at once. Ends with a barrier, so a loop may
// call it again.
__device__ __forceinline__ float2 block_sum2(float2 v) {
  __shared__ float2 partial2[kWideThreads / 32];
  if (threadIdx.x % 32 == 0) partial2[threadIdx.x / 32] = v;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const bool in = lane < (int)blockDim.x / 32;
  float2 out = make_float2(warp_sum(in ? partial2[lane].x : 0.f),
                           warp_sum(in ? partial2[lane].y : 0.f));
  __syncthreads();
  return out;
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

// Adds v to a device-wide counter, releasing: every global write ordered
// before it (by this thread, or by the block's threads through a barrier)
// is visible to whoever acquires the sum.
__device__ __forceinline__ void add_release(unsigned long long* p,
                                            unsigned long long v) {
  asm volatile("red.release.gpu.global.add.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long add_acq_rel(
    unsigned long long* p, unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;"
               : "=l"(old) : "l"(p), "l"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// dst[c] for c in [c0, c1) = the sum over the nb rows b of src[b * cols +
// c], by one block, in an order fixed by the code: lane j of a column
// (kReduceLanes of them) adds rows j, j + kReduceLanes, ... in order, with
// CHUNK loads in flight before it adds them, and lane 0 then adds the
// lanes' sums in order j = 0, 1, ... Columns are the fastest thread index,
// so a warp reads whole 128-byte runs of a few rows. Other blocks wrote
// src: it is read through L2 (__ldcg). buf: kReduceLanes x (blockDim.x /
// kReduceLanes) F of shared memory.
template <int CHUNK, typename F>
__device__ __forceinline__ void sum_slice(const F* src, int nb, int cols,
                                          int c0, int c1, F* dst, F* buf) {
  const int per = blockDim.x / kReduceLanes;        // columns a pass
  const int co = threadIdx.x % per, j = threadIdx.x / per;
  for (int p0 = c0; p0 < c1; p0 += per) {
    const int c = p0 + co;
    F acc;
    bool first = true;
    if (c < c1) {
      for (int b0 = j; b0 < nb; b0 += CHUNK * kReduceLanes) {
        F v[CHUNK];
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) {
          const int b = b0 + i * kReduceLanes;
          if (b < nb) v[i] = __ldcg(src + (int64_t)b * cols + c);
        }
#pragma unroll
        for (int i = 0; i < CHUNK; ++i)
          if (b0 + i * kReduceLanes < nb) {
            acc = first ? v[i] : add(acc, v[i]);
            first = false;
          }
      }
    }
    if (first) acc = F{};                           // a lane with no row
    buf[j * per + co] = acc;
    __syncthreads();
    if (j == 0 && c < c1) {
      F sum = buf[co];
      for (int l = 1; l < kReduceLanes; ++l) sum = add(sum, buf[l * per + co]);
      dst[c] = sum;
    }
    __syncthreads();
  }
}

// The backward's last step, in every block after it wrote its partial row
// (blocks nb of them, rows of D in `partial`). Each block releases its
// arrival on *arrivals and, unless it is one of the last `reducers` blocks,
// is done: it waits for nothing. Reducer r acquires until all nb blocks of
// this launch have arrived, then sums its slice of dw's columns over every
// partial row (sum_slice's fixed order, whichever blocks reduce).
//
// Only the reducers wait, and only on blocks that never wait: a block they
// wait for runs to its end once it is resident, and it becomes resident as
// soon as any non-reducer finishes, since the reducers alone can never fill
// the card (the launcher keeps them below half the SM count). So no
// schedule deadlocks. A wait longer than 10 s (a broken launch) traps
// rather than hanging the card.
//
// *arrivals only grows: a launch adds nb, so every launch on one counter
// with one nb starts at a multiple of nb (the wrapper keeps a counter per
// block count), and a reducer's own arrival tells it which multiple ends
// this launch. No reset and no memset; a CUDA graph's replays count on.
// buf: 16 KB of shared memory.
template <bool WIDE>
__device__ __forceinline__ void dw_tail(const float* partial,
                                        unsigned long long* arrivals,
                                        float* dw, int D, int reducers,
                                        void* buf) {
  const unsigned long long nb = gridDim.x;
  const int r = (int)blockIdx.x - ((int)nb - reducers);
  __syncthreads();                                  // the partial row is out
  if (threadIdx.x == 0) {
    if (r < 0) {
      add_release(arrivals, 1ull);
    } else {
      const unsigned long long old = add_acq_rel(arrivals, 1ull);
      const unsigned long long end = old - old % nb + nb;
      const unsigned long long t0 = now_ns();
      while (load_acquire(arrivals) < end) {
        __nanosleep(64);
        if (now_ns() - t0 > 10000000000ull) __trap();
      }
    }
  }
  if (r < 0) return;
  __syncthreads();
  // the slice of columns (16-byte columns where D allows) this reducer sums
  constexpr int CHUNK = WIDE ? 4 : (kBwdBlocks + kReduceLanes - 1) / kReduceLanes;
  if (D % 4 == 0) {
    const int cols = D / 4, per = (cols + reducers - 1) / reducers;
    sum_slice<CHUNK>(reinterpret_cast<const float4*>(partial), (int)nb, cols,
                     r * per, min(cols, (r + 1) * per),
                     reinterpret_cast<float4*>(dw),
                     reinterpret_cast<float4*>(buf));
  } else {
    const int per = (D + reducers - 1) / reducers;
    sum_slice<CHUNK>(partial, (int)nb, D, r * per, min(D, (r + 1) * per), dw,
                     reinterpret_cast<float*>(buf));
  }
}

// The backward of rmsnorm_kernel, in the same layouts (WIDE, V, NV).
// RESIDUAL = false (K2b): dx = d/dx of rmsnorm(x) * w at cotangent dy.
// RESIDUAL = true (K3b): x holds the saved sum s, dy the cotangent of the
// normed output and ds that of s; writes dx = T(ds + d/ds rmsnorm(s) * w).
// Either way, writes row blockIdx.x of partial (this block's sum over its
// rows of dy x r, per column), then takes its part in summing those rows
// into dw (dw_tail). Rows are walked with a grid stride.
template <typename T, bool RESIDUAL, int V, int NV, bool WIDE>
__global__ void __launch_bounds__(WIDE ? kWideThreads : 32 * kRowsPerBlock)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const T* __restrict__ ds, const float* __restrict__ w,
                   T* __restrict__ dx, float* __restrict__ dw_out,
                   float* __restrict__ partial,
                   unsigned long long* __restrict__ arrivals, int reducers,
                   int N, int D, float eps) {
  const int t = WIDE ? (int)threadIdx.x : (int)(threadIdx.x % 32);
  const int nt = WIDE ? (int)blockDim.x : 32;     // threads on the row
  const int first = WIDE ? (int)blockIdx.x
                         : (int)(blockIdx.x * kRowsPerBlock + threadIdx.x / 32);
  const int stride = WIDE ? (int)gridDim.x : (int)gridDim.x * kRowsPerBlock;

  float dw[NV][V];                                // this thread's columns
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < V; ++k) dw[i][k] = 0.f;

  // WIDE: every thread of the block walks the same rows (block_sum2 needs
  // them all); warp layout: each warp its own rows, no barrier inside
  for (int row = first; row < N; row += stride) {
    const int64_t base = (int64_t)row * D;
    // w is read again for each row (from L1 or L2), not held across rows:
    // the registers go to the row and the dw sums
    Raw<T, V> xs[NV], gs[NV], ss[NV];
    float ws[NV][V];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (t + i * nt) * V;
      if (c < D) {
        xs[i] = load<T, V>(x + base + c);
        gs[i] = load<T, V>(dy + base + c);
        if constexpr (RESIDUAL) ss[i] = load<T, V>(ds + base + c);
        load_scale<V>(w + c, ws[i]);
      }
    }
    float xv[NV][V], gv[NV][V];
    float2 sums = make_float2(0.f, 0.f);          // sum x^2, sum g x
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (t + i * nt) * V;
      if (c < D) {
        unpack<T, V>(xs[i], xv[i]);
        unpack<T, V>(gs[i], gv[i]);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          sums.x += xv[i][k] * xv[i][k];
          sums.y += gv[i][k] * ws[i][k] * xv[i][k];
        }
      }
    }
    sums.x = warp_sum(sums.x);
    sums.y = warp_sum(sums.y);
    if constexpr (WIDE) sums = block_sum2(sums);
    const float r = rsqrtf(sums.x / (float)D + eps);
    const float c3 = r * r * r * sums.y / (float)D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (t + i * nt) * V;
      if (c < D) {
        float o[V];
        float sv[V];
        if constexpr (RESIDUAL) unpack<T, V>(ss[i], sv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          o[k] = r * gv[i][k] * ws[i][k] - xv[i][k] * c3;
          if constexpr (RESIDUAL) o[k] += sv[k];
          dw[i][k] += gv[i][k] * xv[i][k] * r;
        }
        store<T, V>(dx + base + c, o);
      }
    }
  }

  // the warps' partials, then dw_tail's lanes
  __shared__ __align__(16) float red[kRowsPerBlock][kWarpMaxWidth];
  float* out = partial + (int64_t)blockIdx.x * D;
  if constexpr (WIDE) {                           // each thread owns its columns
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (t + i * nt) * V;
      if (c < D) {
#pragma unroll
        for (int k = 0; k < V; ++k) out[c + k] = dw[i][k];
      }
    }
  } else {                                        // add the block's warps in order
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (t + i * nt) * V;
      if (c < D) {
#pragma unroll
        for (int k = 0; k < V; ++k) red[warp][c + k] = dw[i][k];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kRowsPerBlock; ++j) acc += red[j][c];
      out[c] = acc;
    }
  }
  dw_tail<WIDE>(partial, arrivals, dw_out, D, reducers, &red[0][0]);
}

__global__ void empty_kernel() {}

// The arguments of one launch, forward or backward. Forward: x, r (K3), w
// in; y, s (K3) out. Backward: x (or s), dy, ds (K3b), w in; dx, dw out,
// on `blocks` blocks, with the f32 scratch (one partial row of D per
// block) and the arrival counter.
struct Args {
  const void* x;
  const void* r;      // forward: the residual; backward: dy
  const void* ds;     // backward, K3b only
  const void* w;
  void* y;            // forward: y; backward: dx
  void* s;            // forward: the sum; backward: dw
  int N, D;
  float eps;
  int blocks;         // backward only
  float* scratch;               // backward only
  unsigned long long* arrivals; // backward only
  cudaStream_t st;
};

// Blocks of a backward launch that sum dw: at most kReducers, and fewer
// than half the SMs, so that the blocks they wait for always find an SM.
int reducers(int blocks) {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return max(1, min(min(kReducers, blocks), sms[dev] / 2));
}

template <bool BWD, typename T, bool RESIDUAL, int V, int NV, bool WIDE>
void launch_kernel(int grid, int threads, const Args& a) {
  if constexpr (BWD)
    rmsnorm_bwd_kernel<T, RESIDUAL, V, NV, WIDE><<<a.blocks, threads, 0, a.st>>>(
        (const T*)a.x, (const T*)a.r, (const T*)a.ds, (const float*)a.w,
        (T*)a.y, (float*)a.s, a.scratch, a.arrivals, reducers(a.blocks), a.N,
        a.D, a.eps);
  else
    rmsnorm_kernel<T, RESIDUAL, V, NV, WIDE><<<grid, threads, 0, a.st>>>(
        (const T*)a.x, (const T*)a.r, (const float*)a.w, (T*)a.y, (T*)a.s,
        a.N, a.D, a.eps);
}

// The warp layout with the fewest accesses per lane, from the list NV,
// MORE..., that cover the row: registers sized to the row, and no guarded
// access that is never taken (a bf16 row of 768 runs NV = 3, not 8).
template <bool BWD, typename T, bool RESIDUAL, int V, int NV, int... MORE>
void launch_warp(const Args& a) {
  if constexpr (sizeof...(MORE) > 0) {
    if (a.D > 32 * V * NV)
      return launch_warp<BWD, T, RESIDUAL, V, MORE...>(a);
  }
  static_assert(32 * V * NV == kWarpMaxWidth || sizeof...(MORE) > 0,
                "the last entry covers the widest row");
  launch_kernel<BWD, T, RESIDUAL, V, NV, false>(
      (a.N + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, a);
}

// The wide layout: NV accesses per thread cover kMaxWidth on kWideThreads;
// a narrower row gets the multiple of 32 threads it needs.
template <bool BWD, typename T, bool RESIDUAL, int V>
void launch_wide(const Args& a) {
  constexpr int NV = kMaxWidth / kWideThreads / V;
  const int threads = ((a.D / V + NV - 1) / NV + 31) / 32 * 32;
  launch_kernel<BWD, T, RESIDUAL, V, NV, true>(a.N, threads, a);
}

template <bool BWD, typename T, bool RESIDUAL>
void launch_dtype(int variant, const Args& a) {
  constexpr int kVec = 16 / sizeof(T);
  switch (variant) {
    case 0:                      // rows up to 768, 1536, 2048
      launch_warp<BWD, T, RESIDUAL, kVec, 768 / 32 / kVec, 1536 / 32 / kVec,
                  2048 / 32 / kVec>(a);
      break;
    case 1: launch_wide<BWD, T, RESIDUAL, kVec>(a); break;
    default: launch_wide<BWD, T, RESIDUAL, 1>(a); break;
  }
}

bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

template <bool BWD, bool RESIDUAL>
int launch(const Args& a, int dtype, int variant) {
  const bool vector = variant < 2;
  const int elem = dtype == 0 ? 4 : 2;
  const int D = a.D;
  if (variant < 0 || variant > 2 || (dtype != 0 && dtype != 1) || D < 1 ||
      D > (variant == 0 ? kWarpMaxWidth : kMaxWidth) ||
      (BWD && (a.blocks < 1 || a.blocks > kBwdBlocks || !a.s || !a.scratch ||
               !a.arrivals || !aligned16(a.scratch))) ||
      (vector && ((D * elem) % 16 != 0 || !aligned16(a.x) ||
                  !aligned16(a.r) || !aligned16(a.ds) || !aligned16(a.w) ||
                  !aligned16(a.y) || !aligned16(a.s))))
    return (int)cudaErrorInvalidValue;
  if (a.N <= 0) return 0;
  if (dtype == 0) launch_dtype<BWD, float, RESIDUAL>(variant, a);
  else launch_dtype<BWD, __nv_bfloat16, RESIDUAL>(variant, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: (N, D) of dtype (0 = float32, 1 = bfloat16); w: (D,) float32.
int rmsnorm_fwd(const void* x, const void* w, void* y, int N, int D,
                float eps, int dtype, int variant, void* stream) {
  return launch<false, false>({x, nullptr, nullptr, w, y, nullptr, N, D, eps,
                               0, nullptr, nullptr, (cudaStream_t)stream},
                              dtype, variant);
}

// x, r, y, s: (N, D) of dtype; w: (D,) float32.
int rmsnorm_residual_fwd(const void* x, const void* r, const void* w,
                         void* y, void* s, int N, int D, float eps, int dtype,
                         int variant, void* stream) {
  return launch<false, true>({x, r, nullptr, w, y, s, N, D, eps, 0, nullptr,
                              nullptr, (cudaStream_t)stream}, dtype, variant);
}

// K2b. x, dy, dx: (N, D) of dtype; w, dw: (D,) float32; scratch: float32
// of kBwdBlocks * D, 16-byte aligned; arrivals: one u64 counter, 0 when
// first used, which every launch on it advances by `blocks`: launches on
// one counter must all take the same `blocks`, and must be ordered (one
// stream), since two at once would count each other's blocks. ds is not
// read.
int rmsnorm_bwd(const void* x, const void* dy, const void* ds, const void* w,
                void* dx, void* dw, void* scratch, void* arrivals, int N,
                int D, float eps, int dtype, int variant, int blocks,
                void* stream) {
  (void)ds;
  return launch<true, false>({x, dy, nullptr, w, dx, dw, N, D, eps, blocks,
                              (float*)scratch, (unsigned long long*)arrivals,
                              (cudaStream_t)stream}, dtype, variant);
}

// K3b. s (the forward's sum), dy, ds, dt: (N, D) of dtype; the rest as for
// rmsnorm_bwd.
int rmsnorm_residual_bwd(const void* s, const void* dy, const void* ds,
                         const void* w, void* dt, void* dw, void* scratch,
                         void* arrivals, int N, int D, float eps, int dtype,
                         int variant, int blocks, void* stream) {
  return launch<true, true>({s, dy, ds, w, dt, dw, N, D, eps, blocks,
                             (float*)scratch, (unsigned long long*)arrivals,
                             (cudaStream_t)stream}, dtype, variant);
}

// The id of the CUDA graph capture under way on the stream, or 0 when none
// is: scratch and a counter made during a capture belong to that capture.
int rmsnorm_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  *id = 0;
  const cudaError_t err =
      cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, id);
  if (status != cudaStreamCaptureStatusActive) *id = 0;
  return (int)err;
}

// One block of kRowsPerBlock warps that does nothing: the floor under the
// time of any launch.
int rmsnorm_empty(void* stream) {
  empty_kernel<<<1, 32 * kRowsPerBlock, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
