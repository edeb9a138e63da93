// GQA decode attention over the KV cache, read where it lies and only up to
// each row's length: the single-device decode of models/attention.py
// decode_self_attention.
//
// Replaces no Pallas kernel: it stands in for XLA's einsums in
// src/repro/models/attention.py:213 decode_attention_ref, whose plain port
// upcast the whole (B, S, KV, HD) cache to f32 (and copied it once more,
// permuted) before two f32 products over all S positions, masking by length
// after both.
//
// Bound: the bytes of the live K/V. A step reads each row's K and V at its
// live positions once, 2 * KV * HD * 2 bytes a position (bf16), for
// 4 * G * HD FLOPs over G = H / KV query heads: 2 FLOPs a byte at G = 2 in
// bf16, far below the f32 ridge (20). internlm2-1.8b's chat cell (64 rows of
// about 1,000 live positions, 8 KV heads of 128, bf16) reads 262 MB a
// layer: 78 us at 3.35 TB/s.
//
// Design. The cache is bf16, as the model's caches are (the plain version
// serves any other dtype on the CPU). The keys split into chunks of
// `chunk` positions, and an item is one (row, KV head, chunk) whose chunk
// starts before the row's length.
// Every block stages the rows' lengths and lists the live items alike
// (`stage_items`), then the grid walks the list, block i taking items i,
// i + gridDim.x, ...: dead positions cost neither bytes nor blocks, and
// the live ones spread evenly whatever the lengths. Within an item, a
// group of LANES threads covers one cache row of HD (16 bytes a thread,
// neighbouring threads on neighbouring bytes) and takes one (position,
// query head) pair at a time; the G heads of a KV head take the same
// positions in the same pass, so device memory serves each row once. Two
// launches:
//  1. gqa_decode_scores: each thread multiplies its 16 bytes of K (8 bf16),
//     converted to f32 in registers (exact), by its slice of q in f32 with
//     fused multiply-adds; the group sums by a butterfly of shuffles;
//     s = sum / sqrt(HD). Scores go to f32 scratch, and each head's chunk
//     max and sum of exp(s - max) to `stats`.
//  2. gqa_decode_pv: each item folds its row's chunk stats, in chunk order,
//     into the softmax's max M and denominator L, forms its chunk's weights
//     exp(s - M) / L rounded to bf16 (the reference rounds the normalised
//     weights to the cache's dtype before PV), and accumulates weight * V
//     in f32 per group; the groups' sums are added in a fixed order into
//     one f32 partial (G, HD) per chunk. The last of a row's chunks to
//     finish (a ticket) adds the partials in chunk order and rounds to q's
//     dtype.
// The sums' order is fixed: the result is the same bits at every call. A
// row of length 0 (or below) attends to every position with equal scores,
// as the reference's all-masked softmax does; a length past S counts S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // rows a thread loads at once: of 1, 2, 4 and 8
                            // the fastest on the H100 at the serving cells'
                            // shapes
constexpr int kMaxScores = 8192;        // chunk * G floats of shared memory
constexpr int kMaxRows = 512;           // rows a block stages (B at most)
constexpr float kNegInf = -1e30f;       // the reference's NEG_INF

struct Args {
  const void* q;        // (B, H, HD), unit stride along HD
  const void* k;        // (B, S, KV, HD) bf16, unit stride along HD
  const void* v;
  const void* lengths;  // (B,) int32 or int64
  void* out;            // (B, H, HD) contiguous, q's dtype
  float2* stats;        // (B, KV, splits, G): chunk max, sum of exp
  float* scores;        // (B, KV, G, S)
  float* partial;       // (B, KV, splits, G, HD)
  int* tickets;         // (B, KV): chunks of the row done with PV
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int B, S, KV, G, chunk, splits, items, len64;
  float sqrt_hd;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of the cache as 8 floats
__device__ __forceinline__ void load16(const bf16* p, float* x) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// The row's live positions, clamped to S; 0 (or below) attends to all S
// with equal scores (`uniform`). Lengths are read where they lie, int32 or
// int64, so a caller's int64 lengths cost no cast; a build that read int32
// alone ran 26% slower at the chat shape on the H100 (nvcc scheduled both
// passes differently), so the branch stays.
__device__ __forceinline__ int live(const Args& a, int b, bool& uniform) {
  const long long n = a.len64
      ? static_cast<const long long*>(a.lengths)[b]
      : static_cast<long long>(static_cast<const int*>(a.lengths)[b]);
  uniform = n <= 0;
  return uniform || n > a.S ? a.S : static_cast<int>(n);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Thread layout shared by the two passes over the cache: LANES threads a
// cache row, GROUPS groups a block, `per` positions a pass (GROUPS / G),
// group grp on head g = grp % G of the pass's position r = grp / G.
template <int HD>
struct Layout {
  static constexpr int VEC = 16 / sizeof(bf16);
  static constexpr int LANES = HD / VEC;
  static constexpr int GROUPS = kThreads / LANES;
  int grp, lane, g, r, per;
  bool active;
  __device__ Layout(int G)
      : grp(threadIdx.x / LANES), lane(threadIdx.x % LANES), g(grp % G),
        r(grp / G), per(GROUPS / G), active(grp / G < GROUPS / G) {}
};

// The work of a pass, staged by every block alike: each row's live
// positions, signed (negative where the row attends to all S with equal
// scores, `live`), and `first`, the number of live items (a KV head's
// chunk of keys that starts before the row's length) of the rows before
// it. Items are listed row by row, KV head by KV head, chunk by chunk, live
// ones only; returns their number.
__device__ __forceinline__ int stage_items(const Args& a, int* rows,
                                           int* first) {
  for (int b = threadIdx.x; b < a.B; b += kThreads) {
    bool uniform;
    const int n = live(a, b, uniform);
    rows[b] = uniform ? -n : n;
  }
  __syncthreads();
  if (threadIdx.x < 32) {               // a warp's running sum
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < a.B; base += 32) {
      const int b = base + lane;
      int x = b < a.B ? (abs(rows[b]) + a.chunk - 1) / a.chunk * a.KV : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      if (b < a.B) first[b + 1] = carry + x;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) first[0] = 0;
  }
  __syncthreads();
  return first[a.B];
}

// Item k of the list: its row b (the last whose first item is at most k),
// KV head, chunk c and the row's live positions.
__device__ __forceinline__ int item_of(const Args& a, const int* rows,
                                       const int* first, int k, int& c,
                                       int& b, int& kvh, bool& uniform) {
  int lo = 0, hi = a.B - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (first[mid] <= k) lo = mid; else hi = mid - 1;
  }
  b = lo;
  const int n = abs(rows[b]), nc = (n + a.chunk - 1) / a.chunk;
  const int r = k - first[b];
  kvh = r / nc;
  c = r - kvh * nc;
  uniform = rows[b] < 0;
  return n;
}

template <int HD, typename TQ>
__global__ void __launch_bounds__(kThreads) gqa_decode_scores(Args a) {
  using L = Layout<HD>;
  extern __shared__ float sc[];         // (G, chunk)
  __shared__ int rows[kMaxRows], first[kMaxRows + 1];
  const int items = stage_items(a, rows, first);
  const int G = a.G;
  const L t(G);
  const int warp = threadIdx.x / 32, l32 = threadIdx.x % 32;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int c, b, kvh;
    bool uniform;
    const int n = item_of(a, rows, first, item, c, b, kvh, uniform);
    const int c0 = c * a.chunk, len = min(a.chunk, n - c0);
    float qf[L::VEC];
    const TQ* qp = static_cast<const TQ*>(a.q) + b * a.q_sb
        + (kvh * G + t.g) * a.q_sh + t.lane * L::VEC;
#pragma unroll
    for (int i = 0; i < L::VEC; ++i) qf[i] = to_f32(qp[i]);
    const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb
        + kvh * a.k_sh + (c0 * a.k_ss + t.lane * L::VEC);
    float* out = a.scores
        + (static_cast<long long>(b * a.KV + kvh) * G + t.g) * a.S + c0;
    // every thread runs every pass, so the shuffles see the whole warp
    for (int base = 0; base < len; base += t.per * kUnroll) {
      float x[kUnroll][L::VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * t.per + t.r;
        if (t.active && i < len) load16(kp + i * a.k_ss, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * t.per + t.r;
        const bool valid = t.active && i < len;
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < L::VEC; ++j)
          dot = fmaf(qf[j], valid ? x[u][j] : 0.f, dot);
#pragma unroll
        for (int off = L::LANES / 2; off; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (valid && t.lane == 0) {
          const float s = uniform ? kNegInf : dot / a.sqrt_hd;
          sc[t.g * a.chunk + i] = s;
          out[i] = s;
        }
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += kThreads / 32) {
      const float* s = sc + g * a.chunk;
      float m = -INFINITY;
      for (int i = l32; i < len; i += 32) m = fmaxf(m, s[i]);
      m = warp_max(m);
      float l = 0.f;
      for (int i = l32; i < len; i += 32) l += expf(s[i] - m);
      l = warp_sum(l);
      if (l32 == 0)
        a.stats[(static_cast<long long>(b * a.KV + kvh) * a.splits + c) * G
                + g] = make_float2(m, l);
    }
    if (c == 0 && threadIdx.x == 0) a.tickets[b * a.KV + kvh] = 0;
    __syncthreads();                    // sc is the next item's
  }
}

template <int HD, typename TQ>
__global__ void __launch_bounds__(kThreads) gqa_decode_pv(Args a) {
  using L = Layout<HD>;
  extern __shared__ float smem[];
  __shared__ int rows[kMaxRows], first[kMaxRows + 1];
  const int items = stage_items(a, rows, first);
  const int G = a.G;
  const L t(G);
  float* norm = smem;                   // (G, 2): M, L
  float* w = smem + 2 * G;              // (G, chunk)
  float* red = w + G * a.chunk;         // (GROUPS, HD)
  __shared__ bool last;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int c, b, kvh;
    bool uniform;
    const int n = item_of(a, rows, first, item, c, b, kvh, uniform);
    const int c0 = c * a.chunk, len = min(a.chunk, n - c0);
    const int nc = (n + a.chunk - 1) / a.chunk;
    const long long row = static_cast<long long>(b * a.KV + kvh);
    if (threadIdx.x < G) {
      const float2* st = a.stats + row * a.splits * G + threadIdx.x;
      float M = -INFINITY;
      for (int j = 0; j < nc; ++j) M = fmaxf(M, st[j * G].x);
      float den = 0.f;
      for (int j = 0; j < nc; ++j) {
        const float2 mj = st[j * G];
        den = fmaf(mj.y, expf(mj.x - M), den);
      }
      norm[2 * threadIdx.x] = M;
      norm[2 * threadIdx.x + 1] = den;
    }
    __syncthreads();
    const float* scores = a.scores + row * G * a.S + c0;
    for (int e = threadIdx.x; e < G * len; e += kThreads) {
      const int g = e / len, i = e - g * len;
      const float p = expf(scores[g * a.S + i] - norm[2 * g])
          / norm[2 * g + 1];
      w[g * a.chunk + i] = to_f32(from_f32<bf16>(p));
    }
    __syncthreads();
    float acc[L::VEC];
#pragma unroll
    for (int j = 0; j < L::VEC; ++j) acc[j] = 0.f;
    const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb
        + kvh * a.v_sh + (c0 * a.v_ss + t.lane * L::VEC);
    const float* wg = w + t.g * a.chunk;
    if (t.active) {
      for (int base = 0; base < len; base += t.per * kUnroll) {
        float x[kUnroll][L::VEC];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = base + u * t.per + t.r;
          if (i < len) load16(vp + i * a.v_ss, x[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = base + u * t.per + t.r;
          if (i < len) {
            const float p = wg[i];
#pragma unroll
            for (int j = 0; j < L::VEC; ++j)
              acc[j] = fmaf(p, x[u][j], acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < L::VEC; ++j)
        red[t.grp * HD + t.lane * L::VEC + j] = acc[j];
    }
    __syncthreads();
    float* part = a.partial + row * a.splits * G * HD;
    for (int e = threadIdx.x; e < G * HD; e += kThreads) {
      const int g = e / HD, d = e - g * HD;
      float o = 0.f;
      for (int r = 0; r < t.per; ++r) o += red[(r * G + g) * HD + d];
      part[c * G * HD + e] = o;
    }
    // the row's last chunk to finish adds the chunks' partials in chunk
    // order: each block makes its partial visible before it takes a ticket
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(a.tickets + row, 1) == nc - 1;
    __syncthreads();
    if (last) {
      TQ* out = static_cast<TQ*>(a.out) + row * G * HD;
      for (int e = threadIdx.x; e < G * HD; e += kThreads) {
        float o = 0.f;
        for (int j = 0; j < nc; ++j) o += __ldcg(part + j * G * HD + e);
        out[e] = from_f32<TQ>(o);
      }
    }
    __syncthreads();                    // norm, w and red are the next item's
  }
}

template <int HD, typename TQ>
int launch(const Args& a, int blocks, cudaStream_t stream) {
  constexpr int groups = Layout<HD>::GROUPS;
  if (a.G > groups) return -1;
  const int grid = min(blocks, a.items);  // at most one block an item
  // shared memory: the chunk's scores; M and L, the weights and the
  // groups' sums of weight x V
  const size_t scores_smem = sizeof(float) * a.G * a.chunk;
  const size_t pv_smem = sizeof(float) * (2 * a.G + a.G * a.chunk
                                          + groups * HD);
  gqa_decode_scores<HD, TQ><<<grid, kThreads, scores_smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gqa_decode_pv<HD, TQ><<<grid, kThreads, pv_smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int by_q(const Args& a, int blocks, int q_dtype, cudaStream_t s) {
  return q_dtype ? launch<HD, bf16>(a, blocks, s)
                 : launch<HD, float>(a, blocks, s);
}

bool aligned16(const void* p, long long sb, long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0
      && ss % 8 == 0 && sh % 8 == 0;
}

}  // namespace

extern "C" {

// q (B, H, HD), k and v (B, S, KV, HD) bf16, each with a unit stride along
// HD; strides: q's (batch, head), k's (batch, seq, head), v's (batch, seq,
// head), in elements; lengths (B,) int32 (len64 0) or int64 (1), read where
// they lie; out (B, H, HD) contiguous in q's dtype (0 float32, 1 bfloat16);
// scratch f32 of gqa_decode_scratch floats.
// HD 16, 64 or 128; G = H / KV at most 256 / (HD / 8); chunk * G at most
// 8192; the caches' bases and strides 16-byte aligned
// (kernels/gqa_decode.py checks all).
// Returns a CUDA error code, or -1 for arguments the kernels do not take.
int gqa_decode(const void* q, const void* k, const void* v,
               const void* lengths, void* out, void* scratch,
               const long long* strides, int B, int S, int H, int KV, int HD,
               int chunk, int blocks, int len64, int q_dtype, void* stream) {
  if (B <= 0 || B > kMaxRows || S <= 0 || KV <= 0 || H % KV || chunk <= 0
      || blocks <= 0
      || (H / KV) * chunk > kMaxScores)
    return -1;
  if (!aligned16(k, strides[2], strides[3], strides[4])
      || !aligned16(v, strides[5], strides[6], strides[7]))
    return -1;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = lengths;
  a.out = out;
  a.q_sb = strides[0];
  a.q_sh = strides[1];
  a.k_sb = strides[2];
  a.k_ss = strides[3];
  a.k_sh = strides[4];
  a.v_sb = strides[5];
  a.v_ss = strides[6];
  a.v_sh = strides[7];
  a.B = B;
  a.S = S;
  a.KV = KV;
  a.G = H / KV;
  a.chunk = chunk;
  a.splits = (S + chunk - 1) / chunk;
  a.items = a.splits * B * KV;
  a.len64 = len64;
  a.sqrt_hd = sqrtf(static_cast<float>(HD));
  const long long stats = 2LL * B * H * a.splits;
  a.stats = reinterpret_cast<float2*>(scratch);
  a.scores = static_cast<float*>(scratch) + stats;
  a.partial = a.scores + static_cast<long long>(B) * H * S;
  a.tickets = reinterpret_cast<int*>(
      a.partial + static_cast<long long>(B) * H * a.splits * HD);
  auto s = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 16: return by_q<16>(a, blocks, q_dtype, s);
    case 64: return by_q<64>(a, blocks, q_dtype, s);
    case 128: return by_q<128>(a, blocks, q_dtype, s);
    default: return -1;
  }
}

}  // extern "C"
