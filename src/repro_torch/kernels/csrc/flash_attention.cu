// Causal / full flash attention forward for Hopper (sm_90a), with GQA and a
// per-row key-length mask (its backward, K1b, is further down). Two
// kernels, picked by dtype alone:
//
// - bfloat16: flash_fwd_wgmma, on the tensor cores (wgmma) with its K/V
//   tiles brought in by TMA;
// - float32: flash_fwd_f32, on the f32 FMA units (its design is with its
//   code, after the f32 backward). TF32 tensor cores keep about three
//   decimal digits and cannot meet the f32 bar (3e-5).
//
// Replaces the Pallas TPU kernel flash_attention_tpu
// (src/repro/kernels/flash_attention.py). At the serving shapes
// (q (1, 512, 12, 64), k/v (1, 512, 4, 64), causal) it does about 190
// operations per byte it must move, below the card's bf16 ridge (~295
// operations per byte), so it is bound by device-memory bytes: 0.63 us for
// 2.1 MB at 3.35 TB/s. At one 64-row q tile per block the serving shape
// gives 96 blocks for 132 SMs, so in practice the latency of the longest
// block, the last q tile with 8 k tiles, sets the time.
//
// What the bf16 kernel does about what held the first, FMA version back:
// - Products on the FMA pipe: S = Q K^T and O += P V are wgmma m64nNk16
//   products, bf16 in, f32 accumulators in registers.
// - f32 tiles in shared memory, loaded element by element: tiles stay bf16
//   (8 KB per 64 x 64 tile) and TMA copies each with one instruction, in
//   the 128-byte swizzle that the wgmma descriptors read.
// - Loads that never overlap compute: K/V tiles go through a two-stage ring
//   with one mbarrier per tile, so tile k+1 arrives while tile k is
//   multiplied.
// - P through shared memory: the S accumulator fragment is the layout of
//   wgmma's register A operand, so p is packed to bf16 pairs in registers
//   and never stored. One __syncthreads per k tile is left, to free a ring
//   stage for its next load.
//
// Head dims 64, 128 and 192; 192 is MLA's q/k width (dn + dr), the caller
// pads V to it. At D = 192 a bf16 tile row is three 64-column swizzle atoms
// (one TMA box each), O is 96 f32 registers a thread and P V one
// wgmma m64n192k16 per 16 keys; Q and the two K and V stages take 121 KB
// of shared memory. The f32 kernel takes 165 KB there. The backward
// kernels stay at 64 and 128.
//
// The tensor maps carry the real strides of q, k and v (innermost stride
// 1), so the strided k/v views of the fused kv projection are read in
// place. They keep a separate S dimension: rows past S read as zeros and
// never alias the next batch's rows. O is stored per thread, masked by
// row < S.
//
// Semantics shared by both kernels:
// - The TPU walks the k blocks as a sequential grid axis with the running
//   max / denominator / accumulator in VMEM scratch. Here one block owns one
//   (batch, head, 64-row q tile), or in f32, where that would leave SMs
//   idle, a run of its k tiles, and loops over the 64-key tiles itself,
//   keeping the running max and denominator and its share of the
//   accumulator in registers.
// - K/V stay at KV heads: head h reads KV head h / (H / KV), so the
//   repeated K/V are never materialised.
// - Keys are masked by causality and by kpos < lengths[b] with -1e30 (not
//   -inf), so a row without a valid key averages V as the full softmax
//   does. k tiles past the diagonal or past lengths[b] are skipped. The
//   ragged edge (S not a multiple of the tile) is masked in the kernel, and
//   keys past S take no share of the softmax.
// - p is rounded to the input type before the PV product, as the model's
//   XLA path does (in f32 a no-op); the denominator sums the unrounded p
//   and is floored at 1e-30.
// - Both read q, k and v by their strides and write o contiguous, masked by
//   row < S; the row log-sum-exp (row_lse) only when asked for.
//
// Plain C interface, loaded with ctypes. The entry returns the value of
// cudaGetLastError() after its launch (0 = success). cuTensorMapEncodeTiled
// comes through cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;       // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

// The row log-sum-exp the backward recomputes P from: m + log(l). A row
// with no valid key has every score at -1e30 (m = -1e30, l = S), and
// -1e30 + log(S) rounds to -1e30; it stores log(l) alone, and the backward
// takes that row's masked scores as 0, so P = 1/S as in the forward.
__device__ __forceinline__ float row_lse(float m, float l) {
  return (m <= kNegInf ? 0.f : m) + logf(l);
}

// ---------------------------------------------------------------------------
// Backward (K1b): the FlashAttention-2 form; float32 on the f32 FMA units
// ---------------------------------------------------------------------------
//
// Replaces XLA's gradient of the JAX reference's flash_attention_xla
// (src/repro/models/attention.py:91); the Pallas kernel has no backward.
// Two kernels per dtype, launched in this order, with no atomics, so the
// result does not depend on scheduling:
//
// - dq: one block per (64-row q tile, head, batch). It forms Delta =
//   rowsum(dO o) for its rows and writes it, then walks the k tiles the
//   forward walked, recomputing P = exp(score - lse) from the forward's row
//   log-sum-exp: dP = dO V^T, dS = P (dP - Delta), dQ += dS K scale.
// - dkdv: one block per (k tile, KV head, batch), 64 keys in bf16 and 32
//   in f32. It walks the H / KV query heads of its KV head and the q tiles
//   at or below the diagonal, reading Delta: dV += P~^T dO, dK += dS^T Q
//   scale. The GQA sum over query heads stays in the block's registers.
//
// P~ is P rounded to the input type: the forward rounds p before the PV
// product and that cast passes the cotangent through, so dV takes P~ and
// the softmax gradient P in f32. A masked score takes no gradient; a row
// with no valid key (lengths[b] <= 0) has P = 1/S on every key (its lse is
// log S, see row_lse), which only dV sees.
//
// Bound, at the training shape q (16, 128, 12, 64), k/v (16, 128, 4, 64)
// bf16, causal: q, o, dO and dq are 3.15 MB each, k, v, dk and dv 1.05 MB,
// lse and Delta 0.1 MB: 17 MB, 5.1 us at 3.35 TB/s; five products of
// 2 S^2 D per (b, h), halved by the mask, 1.0 GFLOP, 1.0 us at the bf16
// tensor-core peak. So by bytes.
//
// float32 (flash_bwd_dq_f32, flash_bwd_dkdv_f32) keeps every product in
// true f32 on the FMA units: TF32 keeps about three decimal digits and
// cannot meet the f32 bar (2e-5). bfloat16 runs on the tensor cores
// (flash_bwd_*_wgmma, below). In f32 the same training shape moves 34 MB
// (10 us at 3.35 TB/s) and its five products, 1.0 GFLOP, take 15 us at the
// 67 TFLOP/s f32 peak: bound by operations, so the design is about keeping
// the FMA units fed.
//
// - 16-byte shared loads along the reduction: every tile stays row-major
//   as it lies in memory, rows padded by kPad floats, and a thread reads
//   four consecutive values of each of its rows at once. With the thread
//   layout of f32_lane a warp's 16-byte load touches at most 128 distinct
//   bytes on distinct banks: 8 or 10.7 FMAs per shared-memory wavefront,
//   above the 4 the SM needs to keep its FMA units busy.
// - Loads in flight while the products run: tiles arrive by 16-byte
//   cp.async, zero-filled past S. K1b-dkdv streams the Q, dO, lse and
//   Delta of its (head, q tile) pairs through two stages; K1b-dq loads K
//   and V once per k tile and writes dS over V once dP is formed, so at
//   D = 64 it fits three blocks to an SM, whose loads overlap each
//   other's products.
// - More, smaller blocks for K1b-dkdv: a block owns 32 keys
//   (kDkdvRows), so the training shape's 128 blocks of 64 keys become 256,
//   two to an SM; the heavy ones (k tiles under the most q tiles) are
//   dispatched first, so an SM tends to pair a heavy with a light one.
//   K1b-dq runs its longest q tiles first. Both take 128 threads.
// - P = exp2(score scale log2(e) - lse log2(e)).
//
// The GQA sum over query heads, and every other sum, runs inside one
// block in an order fixed by the code: K1b-dkdv adds its (head, q tile)
// pairs in order head by head, q tile by q tile.

constexpr int kF32Threads = 128;
constexpr int kDkdvRows = 32;           // keys of a K1b-dkdv f32 block
constexpr int kPad = 4;                 // floats after each row of a D-wide tile
constexpr int kSP = kBlockK + 8;        // row of a 64-wide P or dS tile

// Thread t's place in the f32 backward's tiles: rows ty + 8 i; in a product
// over the head dim (abt_f32) columns tx + 16 j, in a product into a D-wide
// tile (pm_f32) columns 4 tx + 64 j .. + 3. A warp holds 4 consecutive ty
// and 8 consecutive tx.
__device__ __forceinline__ void f32_lane(int& tx, int& ty) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  ty = l / 8 + 4 * (w % 2);
  tx = l % 8 + 8 * (w / 2);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct RowStrides { long long b, s, h; };   // element strides; head dim 1

// Rows row0 .. row0 + R - 1 of head h of a (B, S, heads, D) f32 tensor with
// the given strides (16-byte aligned base, strides multiples of 4) into dst
// (rows of D + kPad floats) by 16-byte cp.async; rows past S are
// zero-filled.
template <int R, int D>
__device__ __forceinline__ void load_rows_f32(float* dst,
                                              const float* __restrict__ src,
                                              int b, int row0, int h, int S,
                                              RowStrides st) {
  constexpr int kChunks = D / 4;
  const float* head = src + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < R * kChunks; i += kF32Threads) {
    const int r = i / kChunks, c = 4 * (i % kChunks), s = row0 + r;
    const bool ok = s < S;
    cp_async16(dst + r * (D + kPad) + c, ok ? head + s * st.s + c : src, ok);
  }
}

// The same from a contiguous tensor with `heads` heads.
template <int R, int D>
__device__ __forceinline__ void load_rows_f32(float* dst,
                                              const float* __restrict__ src,
                                              int b, int row0, int h, int S,
                                              int heads) {
  load_rows_f32<R, D>(dst, src, b, row0, h, S,
                      RowStrides{(long long)S * heads * D,
                                 (long long)heads * D, D});
}

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// out[i][j] = sum over d < DIN, in order, of A[(ty + RS i) lda + d]
// B[(tx + CS j) ldb + d]: A and B row-major in shared memory, read four
// values of d at a time. The defaults are f32_lane's layout.
template <int NR, int DIN, int NC = 4, int RS = 8, int CS = 16>
__device__ __forceinline__ void abt_f32(float (&out)[NR][NC], const float* A,
                                        int lda, const float* B, int ldb,
                                        int tx, int ty) {
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) out[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DIN; d += 4) {
    float4 a[NR], bv[NC];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + RS * i) * lda + d);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (tx + CS * j) * ldb + d);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j)
          out[i][j] = fmaf(lane4(a[i], e), lane4(bv[j], e), out[i][j]);
  }
}

// acc[i][4 j + e] += sum over k < 64, in order, of P[(ty + RS i) ldp + k]
// M[k ldm + 4 tx + 4 CL j + e]: P (rows of 64) and M (64 rows of DOUT)
// row-major in shared memory, P read four values of k at a time, M four
// columns at a time; CL threads along the columns. The defaults are
// f32_lane's layout.
template <int NR, int DOUT, int RS = 8, int CL = 16>
__device__ __forceinline__ void pm_f32(float (&acc)[NR][DOUT / CL],
                                       const float* P, int ldp,
                                       const float* M, int ldm, int tx,
                                       int ty) {
  constexpr int NJ = DOUT / (4 * CL);
#pragma unroll 2
  for (int k = 0; k < 64; k += 4) {
    float4 p[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + RS * i) * ldp + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 m[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        m[j] = *reinterpret_cast<const float4*>(M + (k + e) * ldm + 4 * tx +
                                                4 * CL * j);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float pv = lane4(p[i], e);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[i][4 * j] = fmaf(pv, m[j].x, acc[i][4 * j]);
          acc[i][4 * j + 1] = fmaf(pv, m[j].y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(pv, m[j].z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(pv, m[j].w, acc[i][4 * j + 3]);
        }
      }
    }
  }
}

// Rows ty + 8 i (i < NR) of a D-wide tile held as pm_f32 holds it, times
// mul, to out (rows of `stride` elements from row `row0`); rows at or past
// S are skipped.
template <int NR, int D>
__device__ __forceinline__ void store_rows_f32(float* __restrict__ out,
                                               int64_t stride, int row0,
                                               int S,
                                               const float (&acc)[NR][D / 16],
                                               float mul, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = row0 + ty + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 64; ++j)
      *reinterpret_cast<float4*>(out + row * stride + 4 * tx + 64 * j) =
          make_float4(acc[i][4 * j] * mul, acc[i][4 * j + 1] * mul,
                      acc[i][4 * j + 2] * mul, acc[i][4 * j + 3] * mul);
  }
}

template <int D>
constexpr int dq_f32_smem_floats() {
  return 4 * kBlockQ * (D + kPad) + kBlockQ;
}

template <int D>
constexpr int dkdv_f32_smem_floats() {
  return (2 * kDkdvRows + 4 * kBlockQ) * (D + kPad) + 2 * kDkdvRows * kSP +
         4 * kBlockQ;
}

// q, o, dO, dq: (B, S, H, D); k, v: (B, S, KV, D); lse, delta: (B, H, S),
// all f32 and contiguous. grid = (H, B, ceil(S / 64)), the last q tile
// first under the causal mask (it walks the most k tiles); block = 128.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dO, const float* __restrict__ lse,
                 float* __restrict__ delta, float* __restrict__ dq,
                 const int* __restrict__ lengths, int S, int H, int KV,
                 int causal, float scale) {
  constexpr int DP = D + kPad;
  extern __shared__ float smem[];
  float* Qs = smem;                     // 64 x DP
  float* dOs = Qs + kBlockQ * DP;       // 64 x DP
  float* Ks = dOs + kBlockQ * DP;       // 64 x DP
  float* Vs = Ks + kBlockK * DP;        // 64 x DP; dS once dP is formed
  float* dSs = Vs;
  float* Ls = Vs + kBlockK * DP;        // 64: lse

  const int qt = causal ? (int)(gridDim.z - 1 - blockIdx.z) : (int)blockIdx.z;
  const int q0 = qt * kBlockQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  int tx, ty;
  f32_lane(tx, ty);
  const int len = lengths ? lengths[b] : S;
  const int64_t row_base = ((int64_t)b * H + h) * S;
  // the k tiles the forward walked; with no valid key (len <= 0) every
  // score is masked and dq is 0
  int kend = causal ? min(S, q0 + kBlockQ) : S;
  kend = len > 0 ? min(kend, len) : 0;
  const int nk = (kend + kBlockK - 1) / kBlockK;

  load_rows_f32<kBlockQ, D>(Qs, q, b, q0, h, S, H);
  load_rows_f32<kBlockQ, D>(dOs, dO, b, q0, h, S, H);
  if (nk > 0) {
    load_rows_f32<kBlockK, D>(Ks, k, b, 0, kvh, S, KV);
    load_rows_f32<kBlockK, D>(Vs, v, b, 0, kvh, S, KV);
  }
  if (threadIdx.x < kBlockQ) {
    const int row = q0 + threadIdx.x;
    cp_async4(Ls + threadIdx.x, row < S ? lse + row_base + row : lse, row < S);
  }
  cp_async_commit();

  // Delta = rowsum(dO o), two threads a row, each half the row: o straight
  // from device memory while the tiles arrive, dO from its tile
  const int dr = threadIdx.x / 2, dh = threadIdx.x % 2;
  float4 ov[D / 8];
  {
    const bool in = q0 + dr < S;
    const float4* po = reinterpret_cast<const float4*>(
        o + (((int64_t)b * S + (in ? q0 + dr : 0)) * H + h) * D + dh * (D / 2));
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      ov[c] = in ? __ldg(po + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_wait<0>();
  __syncthreads();
  float dsum = 0.f;
  {
    const float* pd = dOs + dr * DP + dh * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const float4 g = *reinterpret_cast<const float4*>(pd + 4 * c);
      dsum = fmaf(g.x, ov[c].x, dsum);
      dsum = fmaf(g.y, ov[c].y, dsum);
      dsum = fmaf(g.z, ov[c].z, dsum);
      dsum = fmaf(g.w, ov[c].w, dsum);
    }
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  __shared__ float Dl[kBlockQ];
  if (dh == 0) {
    Dl[dr] = dsum;
    if (q0 + dr < S) delta[row_base + q0 + dr] = dsum;
  }
  __syncthreads();
  // Delta and lse log2(e) of this thread's rows
  float dl[8], l2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    dl[i] = Dl[ty + 8 * i];
    l2[i] = Ls[ty + 8 * i] * kLog2e;
  }

  float acc[8][D / 16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBlockK;
    if (j > 0) {
      cp_async_wait<0>();
      __syncthreads();                  // K and V of this tile are in
    }
    float sc[8][4], dp[8][4];
    abt_f32<8, D>(sc, Qs, DP, Ks, DP, tx, ty);
    abt_f32<8, D>(dp, dOs, DP, Vs, DP, tx, ty);
    __syncthreads();                    // every warp is done with V
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i, qpos = q0 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = tx + 16 * c, kpos = k0 + kc;
        // a masked score, or a key past S, takes no gradient
        const bool ok = kpos < len && kpos < S && (!causal || kpos <= qpos);
        dSs[r * DP + kc] =
            ok ? exp2f(fmaf(sc[i][c], scale2, -l2[i])) * (dp[i][c] - dl[i])
               : 0.f;
      }
    }
    __syncthreads();                    // dS is written over V
    pm_f32<8, D>(acc, dSs, DP, Ks, DP, tx, ty);    // dQ += dS K
    __syncthreads();                    // K and dS are free
    if (j + 1 < nk) {
      load_rows_f32<kBlockK, D>(Ks, k, b, k0 + kBlockK, kvh, S, KV);
      load_rows_f32<kBlockK, D>(Vs, v, b, k0 + kBlockK, kvh, S, KV);
      cp_async_commit();
    }
  }
  store_rows_f32<8, D>(dq + (int64_t)b * S * H * D + (int64_t)h * D,
                       (int64_t)H * D, q0, S, acc, scale, tx, ty);
}

// dk, dv: (B, S, KV, D); the rest as flash_bwd_dq_f32, which wrote delta.
// grid = (KV, B, ceil(S / 32)): blockIdx.z is the 32-key tile, slowest, so
// the tiles with the most q tiles below them start first; block = 128.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dO,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, const int* __restrict__ lengths,
                   int S, int H, int KV, int causal, float scale) {
  constexpr int DP = D + kPad, R = kDkdvRows;
  extern __shared__ float smem[];
  float* Ks = smem;                     // R x DP
  float* Vs = Ks + R * DP;              // R x DP
  float* Qs = Vs + R * DP;              // 2 stages of 64 x DP
  float* dOs = Qs + 2 * kBlockQ * DP;   // 2 stages of 64 x DP
  float* Pt = dOs + 2 * kBlockQ * DP;   // R x kSP: P~^T
  float* dSt = Pt + R * kSP;            // R x kSP: dS^T
  float* Rows = dSt + R * kSP;          // 2 stages of 64 lse, 64 Delta

  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * R;
  const int G = H / KV;
  int tx, ty;
  f32_lane(tx, ty);
  const int len = lengths ? lengths[b] : S;
  const bool empty = len <= 0;          // no valid key: P = 1/S everywhere

  // keys at or past lengths[b] take no gradient; under the causal mask
  // only q tiles at or below this k tile's diagonal see it
  const bool none = !empty && k0 >= len;
  const int qt0 = causal && !empty ? k0 / kBlockQ : 0;
  const int per = none ? 0 : (S + kBlockQ - 1) / kBlockQ - qt0;
  const int n = G * per;                // (head, q tile) pairs, head-major

  // pair i into stage st: Q and dO tiles, lse and Delta of its rows
  auto load_pair = [&](int i, int st) {
    const int h = kvh * G + i / per, q0 = (qt0 + i % per) * kBlockQ;
    load_rows_f32<kBlockQ, D>(Qs + st * kBlockQ * DP, q, b, q0, h, S, H);
    load_rows_f32<kBlockQ, D>(dOs + st * kBlockQ * DP, dO, b, q0, h, S, H);
    const int t = threadIdx.x, row = q0 + t % kBlockQ;
    const float* src = t < kBlockQ ? lse : delta;
    cp_async4(Rows + st * 2 * kBlockQ + t,
              row < S ? src + ((int64_t)b * H + h) * S + row : src, row < S);
    cp_async_commit();
  };
  if (n > 0) {
    load_rows_f32<R, D>(Ks, k, b, k0, kvh, S, KV);
    load_rows_f32<R, D>(Vs, v, b, k0, kvh, S, KV);
    load_pair(0, 0);
    if (n > 1) load_pair(1, 1);
  }

  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[i][c] = dva[i][c] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int i = 0; i < n; ++i) {
    const int st = i & 1, q0 = (qt0 + i % per) * kBlockQ;
    if (i + 1 < n) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();                    // pair i is in
    const float* Q = Qs + st * kBlockQ * DP;
    const float* dOt = dOs + st * kBlockQ * DP;
    const float* L = Rows + st * 2 * kBlockQ;
    float sc[4][4], dpt[4][4];
    abt_f32<4, D>(sc, Ks, DP, Q, DP, tx, ty);      // scores, transposed
    abt_f32<4, D>(dpt, Vs, DP, dOt, DP, tx, ty);   // dP^T
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int kr = ty + 8 * a, kpos = k0 + kr;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = tx + 16 * c, qpos = q0 + qc;
        const bool ok = kpos < len && (!causal || kpos <= qpos);
        float p = 0.f, ds = 0.f;
        if (kpos < S && qpos < S) {
          if (ok) {
            p = exp2f(fmaf(sc[a][c], scale2, -L[qc] * kLog2e));
            ds = p * (dpt[a][c] - L[kBlockQ + qc]);
          } else if (empty) {
            p = exp2f(-L[qc] * kLog2e);  // the masked score, taken as 0
          }
        }
        Pt[kr * kSP + qc] = p;
        dSt[kr * kSP + qc] = ds;
      }
    }
    __syncthreads();                    // P~^T and dS^T are written
    pm_f32<4, D>(dva, Pt, kSP, dOt, DP, tx, ty);   // dV += P~^T dO
    pm_f32<4, D>(dka, dSt, kSP, Q, DP, tx, ty);    // dK += dS^T Q
    __syncthreads();                    // stage st, P~^T and dS^T are free
    if (i + 2 < n) load_pair(i + 2, st);
  }

  const int64_t off = (int64_t)b * S * KV * D + (int64_t)kvh * D;
  store_rows_f32<4, D>(dk + off, (int64_t)KV * D, k0, S, dka, scale, tx, ty);
  store_rows_f32<4, D>(dv + off, (int64_t)KV * D, k0, S, dva, 1.f, tx, ty);
}

// Sets a kernel's dynamic shared memory limit once per device, so that
// launches inside a CUDA graph capture make no attribute call.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool (&configured)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  return 0;
}

template <int D>
int launch_bwd_dq_f32(const void* q, const void* k, const void* v,
                      const void* o, const void* dO, const float* lse,
                      float* delta, void* dq, const int* lengths, int B,
                      int S, int H, int KV, int causal, float scale,
                      cudaStream_t stream) {
  const int smem = (int)sizeof(float) * dq_f32_smem_floats<D>();
  static bool configured[kMaxDevices] = {};
  const int err = allow_smem(flash_bwd_dq_f32<D>, smem, configured);
  if (err) return err;
  const dim3 grid(H, B, (S + kBlockQ - 1) / kBlockQ);
  flash_bwd_dq_f32<D><<<grid, kF32Threads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dO, lse, delta, (float*)dq, lengths, S, H, KV, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_dkdv_f32(const void* q, const void* k, const void* v,
                        const void* dO, const float* lse, const float* delta,
                        void* dk, void* dv, const int* lengths, int B, int S,
                        int H, int KV, int causal, float scale,
                        cudaStream_t stream) {
  const int smem = (int)sizeof(float) * dkdv_f32_smem_floats<D>();
  static bool configured[kMaxDevices] = {};
  const int err = allow_smem(flash_bwd_dkdv_f32<D>, smem, configured);
  if (err) return err;
  const dim3 grid(KV, B, (S + kDkdvRows - 1) / kDkdvRows);
  flash_bwd_dkdv_f32<D><<<grid, kF32Threads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dO,
      lse, delta, (float*)dk, (float*)dv, lengths, S, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Forward, float32 (K1 f32): f32 FMA from shared memory
// ---------------------------------------------------------------------------
//
// Bound, at the training shape q (16, 128, 12, 64), k/v (16, 128, 4, 64)
// f32, causal: 16.8 MB (5.0 us at 3.35 TB/s) against 0.41 GFLOP of QK^T and
// PV over the pairs the mask keeps (6.1 us at the 67 TFLOP/s f32 peak), so
// by operations; at the serving shape (1, 512, 12, 64) by operations too.
// The design keeps the FMA units fed with the backward's tools:
//
// - Thread layout: thread t holds rows ty + 16 i of a 64-row q tile (ty =
//   t / 8), keys tx + 8 j of a 64-key tile (tx = t % 8) and output columns
//   4 tx + 32 j .. + 3. A row's keys lie in one warp, so its running max
//   takes three shuffles and no shared memory. Both products read 16 bytes
//   at a time along their reduction, 12 loads per 128 FMAs, with no bank
//   conflict.
// - Loads in flight during the products: Q, K and V arrive by 16-byte
//   cp.async into row-major tiles padded by kPad, zero-filled past S, read
//   by their strides, so the strided k/v views of the fused kv projection
//   need no copy. One K and one V buffer, loaded in turns: K of tile j + 1
//   arrives while P V of tile j runs, V of tile j + 1 while Q K^T of tile
//   j + 1 runs. Half the shared memory of a two-stage ring: at D = 64 three
//   blocks fit an SM.
// - The softmax in base 2: scores times scale log2(e) in one multiply,
//   p = exp2(s - m). Each thread keeps its own share of the denominator
//   (its 8 keys of each tile, rescaled as the max moves); the 8 shares of a
//   row are summed once, at the end, by a fixed butterfly. P stays f32 (in
//   f32, rounding p to the input type changes nothing).
// - Heavy blocks first: grid (H, B, q tiles) with the q tile slowest and,
//   under the causal mask, the longest tiles dispatched first.
// - Enough blocks: where one block per q tile would leave SMs idle (the
//   serving shape: 96 blocks for 132 SMs), each q tile's k tiles are split
//   over `splits` blocks (SPLIT; the wrapper asks for 4), in runs of
//   consecutive tiles. Each writes its rows' unnormalised o, max and
//   denominator to a scratch buffer, and flash_fwd_f32_merge combines them
//   in a fixed order. The last q tile's walk, which sets the time there,
//   is that many times shorter.
//
// Every sum runs in an order fixed by the code: o is the same bit for bit
// from call to call.

constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr int fwd_f32_smem_floats() {
  return (kBlockQ + 2 * kBlockK) * (D + kPad) + kBlockQ * kSP;
}

// q: (B, S, H, D), k, v: (B, S, KV, D) f32 with the given strides (16-byte
// aligned base, strides multiples of 4); o: (B, S, H, D) contiguous; lse:
// (B, H, S) or null; lengths: (B,) or null. grid = (H, B, ceil(S / 64)),
// block = 128 threads. SPLIT: grid (H, B, splits ceil(S / 64)); run p of a
// q tile's k tiles writes its rows to part: unnormalised o at
// part[(p R + row) D ..], the row max (base 2) at part[n R D + p R + row],
// the denominator at part[n R D + (n + p) R + row], n = splits, R = B H S
// rows by (b, head, s); o and lse are left to flash_fwd_f32_merge.
template <int D, bool SPLIT>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32(const float* __restrict__ q, RowStrides qs,
              const float* __restrict__ k, RowStrides ks,
              const float* __restrict__ v, RowStrides vs,
              float* __restrict__ o, float* __restrict__ lse,
              float* __restrict__ part, int splits,
              const int* __restrict__ lengths, int S, int H, int KV,
              int causal, float scale) {
  constexpr int NR = kBlockQ / 16, DP = D + kPad;
  extern __shared__ float smem[];
  float* Qs = smem;                     // 64 x DP
  float* Ks = Qs + kBlockQ * DP;        // 64 x DP
  float* Vs = Ks + kBlockK * DP;        // 64 x DP
  float* Ps = Vs + kBlockK * DP;        // 64 x kSP

  const int z = causal ? (int)(gridDim.z - 1 - blockIdx.z) : (int)blockIdx.z;
  const int qt = SPLIT ? z / splits : z, run = SPLIT ? z % splits : 0;
  const int q0 = qt * kBlockQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int len = lengths ? lengths[b] : S;
  // Keys at or past kend are masked for every row of this tile, except when
  // lengths[b] == 0: then no key is valid and every row averages all S.
  int kend = causal ? min(S, q0 + kBlockQ) : S;
  kend = len > 0 ? min(kend, len) : S;
  const int nk = (kend + kBlockK - 1) / kBlockK;
  // this block's k tiles: all, or under SPLIT its run of them
  const int j0 = SPLIT ? run * nk / splits : 0;
  const int j1 = SPLIT ? (run + 1) * nk / splits : nk;

  if (j0 < j1) {                        // an empty run loads nothing
    load_rows_f32<kBlockQ, D>(Qs, q, b, q0, h, S, qs);
    load_rows_f32<kBlockK, D>(Ks, k, b, j0 * kBlockK, kvh, S, ks);
  }
  cp_async_commit();
  if (j0 < j1) load_rows_f32<kBlockK, D>(Vs, v, b, j0 * kBlockK, kvh, S, vs);
  cp_async_commit();

  float m[NR], l[NR], acc[NR][D / 8];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }
  const float scale2 = scale * kLog2e;

  for (int j = j0; j < j1; ++j) {
    const int k0 = j * kBlockK;
    const bool more = j + 1 < j1;
    if (j == j0) cp_async_wait<1>();    // Q and K; V may still be on its way
    else cp_async_wait<0>();
    __syncthreads();                    // K is in; every warp is done with V and P
    if (j > j0) {
      load_rows_f32<kBlockK, D>(Vs, v, b, k0, kvh, S, vs);
      cp_async_commit();
    }
    float sc[NR][8];
    abt_f32<NR, D, 8, 16, 8>(sc, Qs, DP, Ks, DP, tx, ty);     // S = Q K^T
    __syncthreads();                    // every warp is done with K
    if (more) {
      load_rows_f32<kBlockK, D>(Ks, k, b, k0 + kBlockK, kvh, S, ks);
      cp_async_commit();
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
      float mx = m[i];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kpos = k0 + tx + 8 * c;
        const bool ok = kpos < len && (!causal || kpos <= qpos);
        // keys past S do not exist: they take no share of the softmax
        sc[i][c] = kpos >= S ? -INFINITY : ok ? sc[i][c] * scale2 : kNegInf;
        mx = fmaxf(mx, sc[i][c]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = exp2f(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = exp2f(sc[i][c] - mx);
        sum += p;
        Ps[r * kSP + tx + 8 * c] = p;
      }
      l[i] = fmaf(l[i], corr, sum);
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[i][c] *= corr;
    }
    if (more) cp_async_wait<1>();       // V; the next K may still be on its way
    else cp_async_wait<0>();
    __syncthreads();                    // V and P are in
    pm_f32<NR, D, 16, 8>(acc, Ps, kSP, Vs, DP, tx, ty);       // O += P V
  }

  const int64_t R = (int64_t)gridDim.y * H * S;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const int64_t rid = ((int64_t)b * H + h) * S + row;
    if (SPLIT) {
      float* out = part + (run * R + rid) * D + 4 * tx;
#pragma unroll
      for (int c = 0; c < D / 32; ++c)
        *reinterpret_cast<float4*>(out + 32 * c) =
            make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
                        acc[i][4 * c + 3]);
      if (tx == 0) {
        part[splits * R * D + run * R + rid] = m[i];
        part[splits * R * D + (splits + run) * R + rid] = lt;
      }
      continue;
    }
    const float den = fmaxf(lt, 1e-30f);
    float* out = o + (((int64_t)b * S + row) * H + h) * D + 4 * tx;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
      *reinterpret_cast<float4*>(out + 32 * c) =
          make_float4(acc[i][4 * c] / den, acc[i][4 * c + 1] / den,
                      acc[i][4 * c + 2] / den, acc[i][4 * c + 3] / den);
    if (lse && tx == 0)
      lse[rid] = row_lse(m[i] <= kNegInf ? kNegInf : m[i] * kLn2, lt);
  }
}

// o and lse from the runs flash_fwd_f32<D, true> wrote to part: with M the
// largest max and c_p = exp2(m_p - M) for run p, o = sum of o_p c_p over
// max(sum of l_p c_p, 1e-30), the sums in run order. One thread per 4
// columns of a row; rows by (b, head, s).
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_merge(const float* __restrict__ part, int splits,
                    float* __restrict__ o, float* __restrict__ lse, int B,
                    int S, int H) {
  const int64_t R = (int64_t)B * H * S;
  const int64_t t = (int64_t)blockIdx.x * kF32Threads + threadIdx.x;
  if (t >= R * (D / 4)) return;
  const int64_t rid = t / (D / 4);
  const int c = 4 * (int)(t % (D / 4));
  const float* ml = part + splits * R * D;
  float mx = kNegInf;
  for (int p = 0; p < splits; ++p) mx = fmaxf(mx, ml[p * R + rid]);
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < splits; ++p) {
    const float cp = exp2f(ml[p * R + rid] - mx);
    const float4 ap = *reinterpret_cast<const float4*>(part + (p * R + rid) * D + c);
    l = fmaf(ml[(splits + p) * R + rid], cp, l);
    a = make_float4(fmaf(ap.x, cp, a.x), fmaf(ap.y, cp, a.y),
                    fmaf(ap.z, cp, a.z), fmaf(ap.w, cp, a.w));
  }
  const float den = fmaxf(l, 1e-30f);
  const int s = (int)(rid % S), bh = (int)(rid / S);
  *reinterpret_cast<float4*>(o + (((int64_t)(bh / H) * S + s) * H + bh % H) * D +
                             c) =
      make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
  if (lse && c == 0) lse[rid] = row_lse(mx <= kNegInf ? kNegInf : mx * kLn2, l);
}

template <int D, bool SPLIT>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   float* lse, float* part, int splits, const int* lengths,
                   int B, int S, int H, int KV, const long long* st,
                   int causal, float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * fwd_f32_smem_floats<D>();
  static bool configured[kMaxDevices] = {};
  const int err = allow_smem(flash_fwd_f32<D, SPLIT>, smem, configured);
  if (err) return err;
  const int tiles = (S + kBlockQ - 1) / kBlockQ;
  const dim3 grid(H, B, SPLIT ? splits * tiles : tiles);
  flash_fwd_f32<D, SPLIT><<<grid, kF32Threads, smem, stream>>>(
      (const float*)q, RowStrides{st[0], st[1], st[2]}, (const float*)k,
      RowStrides{st[3], st[4], st[5]}, (const float*)v,
      RowStrides{st[6], st[7], st[8]}, (float*)o, lse, part, splits, lengths,
      S, H, KV, causal, scale);
  const int launched = (int)cudaGetLastError();
  if (launched || !SPLIT) return launched;
  const long long threads = (long long)B * H * S * (D / 4);
  flash_fwd_f32_merge<D><<<(unsigned)((threads + kF32Threads - 1) /
                                      kF32Threads),
                           kF32Threads, 0, stream>>>(part, splits, (float*)o,
                                                     lse, B, S, H);
  return (int)cudaGetLastError();
}

// The backward entries' shape checks: what the wrapper checks, again.
bool bwd_ok(int B, int S, int H, int KV, int D, int dtype) {
  return B > 0 && S > 0 && KV > 0 && H % KV == 0 && (D == 64 || D == 128) &&
         (dtype == 0 || dtype == 1) && B <= 65535 && H <= 65535;
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma tensor-core products fed by TMA
// ---------------------------------------------------------------------------

constexpr int kTile = 64;               // q rows, keys per k tile, columns per swizzle atom
constexpr int kAtomBytes = kTile * 128; // 64 rows of one 128-byte swizzled row each

// Shared memory, in bytes from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 1024 bytes): Q, two K stages, two V stages, then
// the mbarriers (Q, K[2], V[2]).
template <int D>
struct WgLayout {
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;
  static constexpr int kV = 3 * kTileBytes;
  static constexpr int kBar = 5 * kTileBytes;
  static constexpr int kBytes = kBar + 5 * 8 + 1024;   // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the phase of the given parity to complete. A load that never
// arrives (a bad tensor map) traps after 10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 10000000000ull) asm volatile("trap;");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box of the 4-d map (D, heads, S, B) into shared memory at dst;
// completion is counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
         "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma descriptor of a tile that TMA wrote with the 128-byte swizzle.
// lbo: bytes between 64-column atoms (read for an MN-major operand only);
// sbo: bytes between groups of 8 rows (1024).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define WG_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, f32) (+)= A (64 x 16) B^T, both bf16 and K-major in shared
// memory; accumulate when acc != 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x N, f32) += A (64 x 16, bf16 pairs in registers) B, with B (16 x N)
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56), WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_D8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64-row bf16 tile of a 4-d map (rows row.., head, batch) into shared
// memory at dst, one 64-column swizzle atom per TMA box.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head, int row,
                                         int batch) {
#pragma unroll
  for (int a = 0; a < D / 64; ++a)
    tma_load(dst + a * kAtomBytes, map, bar, a * 64, head, row, batch);
}

// d (64 x 64, f32) = A B^T over D, A and B 64 x D bf16 tiles that TMA wrote
// (K-major, 128-byte swizzle): 16 columns a step, the next atom after four.
template <int D>
__device__ __forceinline__ void wg_abt(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kAtomBytes + (kk % 4) * 32;
    wgmma_ss_n64(d, sw128_desc(a + off, 16), sw128_desc(b + off, 16), kk > 0);
  }
}

// d (64 x D, f32) += A M: A (64 x 64) as bf16 pairs in registers, four
// 16-column fragments; M a 64 x D tile that TMA wrote, read MN-major, 16
// rows (2048 bytes) a step.
template <int N>
__device__ __forceinline__ void wg_am(float (&d)[N], const uint32_t (&a)[4][4],
                                      uint32_t m) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_rs(d, a[j], sw128_desc(m + j * 2048, kAtomBytes));
}

// x0, x1 as two bf16 terms each: hi = bf16(x), lo = bf16(x - hi), packed in
// pairs. hi + lo keeps 16 significant bits, so dS K (and dS^T Q) on the
// tensor cores meets the f32 softmax gradient's bar where one bf16 dS
// would not.
__device__ __forceinline__ void pack_split(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// One warpgroup per (64-row q tile, head, batch); grid = (ceil(S / 64), H,
// B). Maps: q (D, H, S, B), k/v (D, KV, S, B), box (64, 1, 64, 1).
//
// Accumulator fragments (wgmma's layout): thread t of warp w = t / 32 holds
// rows r0 = 16 w + (t % 32) / 4 and r0 + 8, and in each 8-column block the
// columns 2 (t % 4) and 2 (t % 4) + 1; register i is row r0 + 8 ((i / 2) %
// 2), column 8 (i / 4) + 2 (t % 4) + i % 2.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                const int* __restrict__ lengths, int S, int H, int KV,
                int causal, float scale) {
  using L = WgLayout<D>;
  constexpr int kNO = D / 2;            // O accumulator floats a thread holds
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t barQ = base + L::kBar, barK = barQ + 8, barV = barQ + 24;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int len = lengths ? lengths[b] : S;
  // keys at or past kend are masked for every row of this tile, except when
  // lengths[b] <= 0: then no key is valid and every row averages all S
  int kend = causal ? min(S, q0 + kTile) : S;
  if (len > 0) kend = min(kend, len);
  else kend = S;
  const int ntiles = (kend + kTile - 1) / kTile;

  auto load_kv = [&](int t) {           // thread 0 only
    const int s = t & 1;
    mbar_expect_tx(barK + 8 * s, L::kTileBytes);
    tma_tile<D>(sK + s * L::kTileBytes, &k_map, barK + 8 * s, kvh, t * kTile, b);
    mbar_expect_tx(barV + 8 * s, L::kTileBytes);
    tma_tile<D>(sV + s * L::kTileBytes, &v_map, barV + 8 * s, kvh, t * kTile, b);
  };

  if (tid == 0) {
    prefetch_map(&q_map);
    prefetch_map(&k_map);
    prefetch_map(&v_map);
    for (int i = 0; i < 5; ++i) mbar_init(barQ + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(barQ, L::kTileBytes);
    tma_tile<D>(sQ, &q_map, barQ, h, q0, b);
    load_kv(0);
    if (ntiles > 1) load_kv(1);
  }

  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) acc[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t & 1;
    const uint32_t parity = (t >> 1) & 1;
    const int k0 = t * kTile;
    if (t == 0) mbar_wait(barQ, 0);
    mbar_wait(barK + 8 * s, parity);

    float sc[32];                       // S = Q K^T
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wg_fence();
    fence_regs(sc);
    wg_abt<D>(sc, sQ, sK + s * L::kTileBytes);
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // scale and mask; tiles wholly inside the valid keys skip the mask
    const bool whole = k0 + kTile <= min(len, S) &&
                       (!causal || k0 + kTile - 1 <= q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float x = sc[i] * scale;
      if (!whole) {
        const int kpos = k0 + (i >> 2) * 8 + cq + (i & 1);
        const int qpos = q0 + r0 + 8 * r;
        const bool ok = kpos < len && (!causal || kpos <= qpos);
        // keys past S do not exist: they take no share of the softmax
        x = kpos >= S ? -INFINITY : (ok ? x : kNegInf);
      }
      sc[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {       // the 4 threads of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
    // p in bf16 pairs: registers 8j..8j+7 of S are wgmma's A fragment
    // (a0..a3) for keys 16j..16j+15
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = exp2f((sc[i] - mx[r]) * kLog2e);
      const float p1 = exp2f((sc[i + 1] - mx[r]) * kLog2e);
      l[r] += p0 + p1;
      pa[i / 8][(i / 2) % 4] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < kNO; ++i) acc[i] *= corr[(i >> 1) & 1];

    mbar_wait(barV + 8 * s, parity);    // O += P V
    wg_fence();
    fence_regs(acc);
    wg_am(acc, pa, sV + s * L::kTileBytes);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);

    __syncthreads();                    // every warp is done with stage s
    if (tid == 0 && t + 2 < ntiles) load_kv(t + 2);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + r0 + 8 * r;
    if (row >= S) continue;             // never the next batch's rows
    const float den = fmaxf(l[r], 1e-30f);
    if (lse && lane % 4 == 0) lse[((int64_t)b * H + h) * S + row] = row_lse(m[r], l[r]);
    __nv_bfloat16* out = o + (((int64_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(out + c * 8 + cq) =
          pack_bf16(acc[4 * c + 2 * r] / den, acc[4 * c + 2 * r + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// Backward (K1b), bfloat16: wgmma tensor-core products fed by TMA
// ---------------------------------------------------------------------------
//
// flash_bwd_dq_wgmma and flash_bwd_dkdv_wgmma compute what the f32 kernels
// above compute, in the same order (K1b-dkdv on 64-key tiles), at the bound
// stated there (17 MB, 5.1 us; 1.0 GFLOP, 1.0 us: by bytes). What the
// design does:
//
// - Products: each is a wgmma with f32 accumulators in a form the forward
//   already uses. S = Q K^T and dP = dO V^T (in K1b-dkdv their transposes
//   K Q^T and V dO^T) read two K-major tiles (SS); dQ += dS K, dK += dS^T Q
//   and dV += P~^T dO take their left operand as bf16 pairs in registers,
//   packed from an accumulator as the forward packs p, and read the right
//   one MN-major from the same swizzled tile (RS). So one tile in shared
//   memory serves two products, as the forward's V tile does.
// - dS as two bf16 terms. A tensor-core product takes dS in bf16; rounded
//   once, dQ and dK miss the softmax gradient's bar (1 bf16 ulp + 2e-5 of
//   max |ref| against the f32 plain backward) 30-80 times over (emulated
//   in f32 on small shapes, tests/test_torch_kernels.py). hi = bf16(dS)
//   and lo = bf16(dS - hi) keep 16 significant bits, and hi K + lo K
//   (summed in f32) passes with room, for two more wgmma chains a tile.
//   dV takes P~ in bf16, as the forward rounds it.
// - Loads: every tile comes by TMA through a 4-d map with the real
//   strides, so the strided k/v views of the fused kv projection, and any
//   view with a contiguous head dim and 16-byte aligned base and strides,
//   are read in place; rows past S read as zeros. K1b-dq streams K/V
//   through a two-stage mbarrier ring; K1b-dkdv loads K/V once and streams
//   Q and dO of its (head, q tile) pairs through six stages (four at
//   D = 128), with lse and Delta staged beside them, so at the training
//   shape every load is in flight before the first product.
// - Registers: K1b-dkdv gives dV to warpgroup 0 and dK to warpgroup 1
//   (both form S^T), so no thread holds two D-wide accumulators, and
//   neither kernel spills at D = 64 or 128.
// - Masks by select, and P as exp2 of scores prescaled by log2(e).
//
// What is still serial (H100 SXM, training shape): K1b-dq spends most of
// its time before its loop's first product, on loads, Delta and launch;
// K1b-dkdv's 128 blocks fill one wave, and the longest (k tile 0) walk
// six (head, q tile) pairs one after another, each a chain of wgmma waits
// and exp/split work with one warp of each warpgroup per scheduler. The
// numbers are in PERF.md (tools/k1b_breakdown.py times the parts).

// Shared memory of K1b-dq, in bytes from a 1024-byte aligned base: Q, dO,
// two K stages, two V stages, Delta (64 f32), then the mbarriers (Q + dO,
// K[2], V[2]).
template <int D>
struct DqLayout {
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kTileBytes;
  static constexpr int kK = 2 * kTileBytes;
  static constexpr int kV = 4 * kTileBytes;
  static constexpr int kDelta = 6 * kTileBytes;
  static constexpr int kBar = kDelta + kTile * 4;
  static constexpr int kBytes = kBar + 5 * 8 + 1024;
};

// K1b-dq: one warpgroup per (64-row q tile, head, batch); grid = (ceil(S /
// 64), H, B), longest rows first. Maps: q, dO (D, H, S, B), k, v (D, KV, S,
// B). o and dO are also read in place for Delta. Fragments as in
// flash_fwd_wgmma.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const __nv_bfloat16* __restrict__ o, RowStrides os,
                   const __nv_bfloat16* __restrict__ dO, RowStrides dos,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq,
                   const int* __restrict__ lengths, int S, int H, int KV,
                   int causal, float scale) {
  using L = DqLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* Dl = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                       L::kDelta);
  const uint32_t sQ = base + L::kQ, sdO = base + L::kDO;
  const uint32_t sK = base + L::kK, sV = base + L::kV;
  const uint32_t barQ = base + L::kBar, barK = barQ + 8, barV = barQ + 24;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int len = lengths ? lengths[b] : S;
  const int64_t row_base = ((int64_t)b * H + h) * S;
  // the k tiles the forward walked; with no valid key (len <= 0) every
  // score is masked and dq is 0
  int kend = causal ? min(S, q0 + kTile) : S;
  kend = len > 0 ? min(kend, len) : 0;
  const int ntiles = (kend + kTile - 1) / kTile;

  auto load_kv = [&](int t) {           // thread 0 only
    const int s = t & 1;
    mbar_expect_tx(barK + 8 * s, L::kTileBytes);
    tma_tile<D>(sK + s * L::kTileBytes, &k_map, barK + 8 * s, kvh, t * kTile, b);
    mbar_expect_tx(barV + 8 * s, L::kTileBytes);
    tma_tile<D>(sV + s * L::kTileBytes, &v_map, barV + 8 * s, kvh, t * kTile, b);
  };

  if (tid == 0) {
    prefetch_map(&q_map);
    prefetch_map(&k_map);
    prefetch_map(&v_map);
    prefetch_map(&do_map);
    for (int i = 0; i < 5; ++i) mbar_init(barQ + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (ntiles > 0) {                   // the loads start before Delta's
      mbar_expect_tx(barQ, 2 * L::kTileBytes);
      tma_tile<D>(sQ, &q_map, barQ, h, q0, b);
      tma_tile<D>(sdO, &do_map, barQ, h, q0, b);
      load_kv(0);
      if (ntiles > 1) load_kv(1);
    }
  }

  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  const float scale2 = scale * kLog2e;
  float lr[2], dr[2];                   // lse log2(e) and Delta of this thread's rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    lr[r] = row < S ? lse[row_base + row] * kLog2e : 0.f;
  }

  {                                     // Delta = rowsum(dO o): two threads a row
    const int r = tid / 2, half = tid % 2, row = q0 + r;
    float acc = 0.f;
    if (row < S) {
      const uint4* po = reinterpret_cast<const uint4*>(
          o + b * os.b + row * os.s + h * os.h + half * (D / 2));
      const uint4* pd = reinterpret_cast<const uint4*>(
          dO + b * dos.b + row * dos.s + h * dos.h + half * (D / 2));
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 ov = po[c], dv = pd[c];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 of = __bfloat1622float2(o2[i]), df = __bfloat1622float2(d2[i]);
          acc = fmaf(df.x, of.x, acc);
          acc = fmaf(df.y, of.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      Dl[r] = acc;
      if (row < S) delta[row_base + row] = acc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) dr[r] = Dl[r0 + 8 * r];
  constexpr int kN = D / 2;             // dQ accumulator floats a thread holds
  float acc[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t & 1;
    const uint32_t parity = (t >> 1) & 1;
    const int k0 = t * kTile;
    const uint32_t tK = sK + s * L::kTileBytes, tV = sV + s * L::kTileBytes;
    if (t == 0) mbar_wait(barQ, 0);

    // S = Q K^T, then dP = dO V^T in a second group, so the exponentials
    // of P overlap the dP product
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    mbar_wait(barK + 8 * s, parity);
    wg_fence();
    fence_regs(sc);
    fence_regs(dp);
    wg_abt<D>(sc, sQ, tK);
    wg_commit();
    mbar_wait(barV + 8 * s, parity);
    wg_abt<D>(dp, sdO, tV);
    wg_commit();
    wg_wait_1();
    fence_regs(sc);

    // P = exp(S scale - lse) = exp2(S scale log2(e) - lse log2(e)); a
    // masked score, or a key past S, takes no gradient (exp2(-inf) = 0).
    // Tiles wholly inside the valid keys skip the mask.
    const bool whole = k0 + kTile <= min(len, S) &&
                       (!causal || k0 + kTile - 1 <= q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float x = fmaf(sc[i], scale2, -lr[r]);
      if (!whole) {
        const int kpos = k0 + (i >> 2) * 8 + cq + (i & 1);
        const int qpos = q0 + r0 + 8 * r;
        const bool ok = kpos < len && kpos < S && (!causal || kpos <= qpos);
        x = ok ? x : -INFINITY;
      }
      sc[i] = exp2f(x);
    }
    wg_wait_all();
    fence_regs(dp);

    // dS = P (dP - Delta) as hi + lo bf16 pairs: registers 8j..8j+7 are
    // wgmma's A fragment for keys 16j..16j+15
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      pack_split(sc[i] * (dp[i] - dr[r]), sc[i + 1] * (dp[i + 1] - dr[r]),
                 hi[i / 8][(i / 2) % 4], lo[i / 8][(i / 2) % 4]);
    }
    // dQ += dS_hi K + dS_lo K, K read MN-major from the same tile
    wg_fence();
    fence_regs(acc);
    wg_am(acc, hi, tK);
    wg_am(acc, lo, tK);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);

    if (t + 2 < ntiles) {
      __syncthreads();                  // every warp is done with stage s
      if (tid == 0) load_kv(t + 2);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= S) continue;             // never the next batch's rows
    __nv_bfloat16* out = dq + (((int64_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(out + c * 8 + cq) =
          pack_bf16(acc[4 * c + 2 * r] * scale, acc[4 * c + 2 * r + 1] * scale);
  }
}

// Shared memory of K1b-dkdv, in bytes from a 1024-byte aligned base: K, V,
// kStages stages of Q and of dO, kStages stages of (64 lse, 64 Delta) f32,
// then the mbarriers (K + V, stage[kStages]). Six stages at D = 64 hold
// every (head, q tile) pair of the training shape's longest block, so its
// loads are all issued before the first product.
template <int D>
struct DkdvLayout {
  static constexpr int kStages = D == 64 ? 6 : 4;
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kTileBytes;
  static constexpr int kQ = 2 * kTileBytes;
  static constexpr int kDO = kQ + kStages * kTileBytes;
  static constexpr int kRows = kDO + kStages * kTileBytes;
  static constexpr int kBar = kRows + kStages * 2 * kTile * 4;
  static constexpr int kBytes = kBar + (1 + kStages) * 8 + 1024;
};

constexpr int kDkdvThreads = 2 * kThreads;  // warpgroup 0: dV; 1: dK

// K1b-dkdv: one block per (64-key tile, KV head, batch); grid = (ceil(S /
// 64), KV, B). It walks the (query head, q tile) pairs of its KV head, the
// q tiles at or below the diagonal, through a ring of kStages. Both
// warpgroups form S^T = K Q^T; warpgroup 0 then dV += P~^T dO, warpgroup 1
// dP^T = V dO^T and dK += dS^T Q. Rows of a fragment are keys, columns
// queries, so lse and Delta are read by column.
template <int D>
__global__ void __launch_bounds__(kDkdvThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     const int* __restrict__ lengths, int S, int H, int KV,
                     int causal, float scale) {
  using L = DkdvLayout<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* rows = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                         L::kRows);
  const uint32_t sK = base + L::kK, sV = base + L::kV;
  const uint32_t sQ = base + L::kQ, sdO = base + L::kDO;
  const uint32_t barKV = base + L::kBar, barS = barKV + 8;

  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, wg = tid / kThreads, lt = tid % kThreads;
  const int len = lengths ? lengths[b] : S;
  const bool empty = len <= 0;          // no valid key: P = 1/S everywhere
  // keys at or past lengths[b] take no gradient; under the causal mask
  // only q tiles at or below this k tile's diagonal see it
  const bool none = !empty && k0 >= len;
  const int qt0 = causal && !empty ? k0 / kTile : 0;
  const int nq = none ? 0 : (S + kTile - 1) / kTile - qt0;
  const int n = G * nq;                 // (head, q tile) pairs, head-major

  // Thread lt of warpgroup 0 stages one value of pair i: lse log2(e)
  // (lt < 64) or Delta (lt >= 64) of row lt % 64 of its q tile.
  auto row_value = [&](int i) -> float {
    const int h = kvh * G + i / nq, row = (qt0 + i % nq) * kTile + lt % 64;
    if (row >= S) return 0.f;
    const int64_t at = ((int64_t)b * H + h) * S + row;
    return lt < 64 ? lse[at] * kLog2e : delta[at];
  };
  auto load_qdo = [&](int i) {          // thread 0 only
    const int s = i % kStages, h = kvh * G + i / nq, q0 = (qt0 + i % nq) * kTile;
    mbar_expect_tx(barS + 8 * s, 2 * L::kTileBytes);
    tma_tile<D>(sQ + s * L::kTileBytes, &q_map, barS + 8 * s, h, q0, b);
    tma_tile<D>(sdO + s * L::kTileBytes, &do_map, barS + 8 * s, h, q0, b);
  };

  if (tid == 0) {
    prefetch_map(&q_map);
    prefetch_map(&k_map);
    prefetch_map(&v_map);
    prefetch_map(&do_map);
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(barKV + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (n > 0) {                        // the loads start before lse's
      mbar_expect_tx(barKV, 2 * L::kTileBytes);
      tma_tile<D>(sK, &k_map, barKV, kvh, k0, b);
      tma_tile<D>(sV, &v_map, barKV, kvh, k0, b);
      for (int i = 0; i < kStages && i < n; ++i) load_qdo(i);
    }
  }
  if (wg == 0)
    for (int i = 0; i < kStages && i < n; ++i)
      rows[i * 2 * kTile + lt] = row_value(i);
  __syncthreads();
  // pair i + kStages's values, loaded an iteration before they are staged
  float next = wg == 0 && n > kStages ? row_value(kStages) : 0.f;

  const int lane = lt % 32;
  const int r0 = (lt / 32) * 16 + lane / 4;   // key row within the tile
  const int cq = (lane % 4) * 2;
  constexpr int kN = D / 2;             // dV (warpgroup 0) or dK floats a thread holds
  const float scale2 = scale * kLog2e;
  float acc[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int q0 = (qt0 + i % nq) * kTile;
    const float* Ls = rows + s * 2 * kTile;
    const float* Dls = Ls + kTile;
    const uint32_t tQ = sQ + s * L::kTileBytes, tdO = sdO + s * L::kTileBytes;
    if (i == 0) mbar_wait(barKV, 0);
    mbar_wait(barS + 8 * s, parity);
    const bool whole = k0 + kTile <= min(len, S) && q0 + kTile <= S &&
                       (!causal || k0 + kTile - 1 <= q0);
    // P^T at fragment register j from its score sv, exp2(sv scale log2(e)
    // - lse log2(e)), masked by select: a masked score takes no gradient
    // (exp2(-inf) = 0), but with no valid key (lengths[b] <= 0) P = exp(0 -
    // lse) = 1/S, which only dV sees
    auto p_at = [&](float sv, int j, bool for_dv) -> float {
      const int c = (j >> 2) * 8 + cq + (j & 1);
      float x = fmaf(sv, scale2, -Ls[c]);
      if (!whole) {
        const int kpos = k0 + r0 + 8 * ((j >> 1) & 1), qpos = q0 + c;
        const bool in = kpos < S && qpos < S;
        const bool ok = in && kpos < len && (!causal || kpos <= qpos);
        x = ok ? x : (for_dv && empty && in ? -Ls[c] : -INFINITY);
      }
      return exp2f(x);
    };
    float st[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = 0.f;
    if (wg == 0) {
      wg_fence();
      fence_regs(st);
      wg_abt<D>(st, sK, tQ);            // S^T = K Q^T
      wg_commit();
      wg_wait_all();
      fence_regs(st);
      uint32_t pa[4][4];                // P~^T in bf16 pairs
#pragma unroll
      for (int j = 0; j < 32; j += 2)
        pa[j / 8][(j / 2) % 4] = pack_bf16(p_at(st[j], j, true),
                                         p_at(st[j + 1], j + 1, true));
      wg_fence();
      fence_regs(acc);
      wg_am(acc, pa, tdO);              // dV += P~^T dO
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
    } else {
      float dpt[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) dpt[j] = 0.f;
      wg_fence();
      fence_regs(st);
      fence_regs(dpt);
      wg_abt<D>(st, sK, tQ);            // S^T = K Q^T
      wg_commit();
      wg_abt<D>(dpt, sV, tdO);          // dP^T = V dO^T
      wg_commit();
      wg_wait_1();
      fence_regs(st);
#pragma unroll
      for (int j = 0; j < 32; ++j) st[j] = p_at(st[j], j, false);
      wg_wait_all();
      fence_regs(dpt);
      uint32_t hi[4][4], lo[4][4];      // dS^T = P^T (dP^T - Delta), split
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int c = (j >> 2) * 8 + cq;
        pack_split(st[j] * (dpt[j] - Dls[c]), st[j + 1] * (dpt[j + 1] - Dls[c + 1]),
                   hi[j / 8][(j / 2) % 4], lo[j / 8][(j / 2) % 4]);
      }
      wg_fence();
      fence_regs(acc);
      wg_am(acc, hi, tQ);               // dK += dS^T_hi Q + dS^T_lo Q
      wg_am(acc, lo, tQ);
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
    }

    if (i + kStages < n) {
      __syncthreads();                  // both warpgroups are done with stage s
      if (wg == 0) rows[s * 2 * kTile + lt] = next;
      if (tid == 0) load_qdo(i + kStages);
      if (wg == 0 && i + kStages + 1 < n) next = row_value(i + kStages + 1);
    }
  }

  __nv_bfloat16* out = wg == 0 ? dv : dk;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + r0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* dst = out + (((int64_t)b * S + row) * KV + kvh) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(dst + c * 8 + cq) =
          pack_bf16(acc[4 * c + 2 * r] * mul, acc[4 * c + 2 * r + 1] * mul);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A 4-d map over a bf16 (B, S, heads, D) tensor with the given element
// strides, boxes of (64 columns, 1 head, 64 rows, 1 batch).
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D,
             const long long* strides /* batch, seq, head */) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[2] * 2,
                               (cuuint64_t)strides[1] * 2,
                               (cuuint64_t)strides[0] * 2};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, const int* lengths, int B, int S, int H, int KV,
                 const long long* strides, int causal, float scale,
                 cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, B, S, H, D, strides);
  if (!err) err = make_map(&km, k, B, S, KV, D, strides + 3);
  if (!err) err = make_map(&vm, v, B, S, KV, D, strides + 6);
  if (err) return err;
  const int smem = WgLayout<D>::kBytes;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr != cudaSuccess) return (int)cerr;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cerr = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
    if (cerr != cudaSuccess) return (int)cerr;
    configured[dev] = true;
  }
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_fwd_wgmma<D><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, (__nv_bfloat16*)o, lse, lengths, S, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                        const void* o, const void* dO, const float* lse,
                        float* delta, void* dq, const int* lengths, int B,
                        int S, int H, int KV, const long long* strides,
                        int causal, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom;
  int err = make_map(&qm, q, B, S, H, D, strides);
  if (!err) err = make_map(&km, k, B, S, KV, D, strides + 3);
  if (!err) err = make_map(&vm, v, B, S, KV, D, strides + 6);
  if (!err) err = make_map(&dom, dO, B, S, H, D, strides + 12);
  if (err) return err;
  const int smem = DqLayout<D>::kBytes;
  static bool configured[kMaxDevices] = {};
  err = allow_smem(flash_bwd_dq_wgmma<D>, smem, configured);
  if (err) return err;
  const RowStrides os{strides[9], strides[10], strides[11]};
  const RowStrides dos{strides[12], strides[13], strides[14]};
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_bwd_dq_wgmma<D><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, dom, (const __nv_bfloat16*)o, os,
      (const __nv_bfloat16*)dO, dos, lse, delta, (__nv_bfloat16*)dq, lengths,
      S, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_dkdv_wgmma(const void* q, const void* k, const void* v,
                          const void* dO, const float* lse,
                          const float* delta, void* dk, void* dv,
                          const int* lengths, int B, int S, int H, int KV,
                          const long long* strides, int causal, float scale,
                          cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom;
  int err = make_map(&qm, q, B, S, H, D, strides);
  if (!err) err = make_map(&km, k, B, S, KV, D, strides + 3);
  if (!err) err = make_map(&vm, v, B, S, KV, D, strides + 6);
  if (!err) err = make_map(&dom, dO, B, S, H, D, strides + 9);
  if (err) return err;
  const int smem = DkdvLayout<D>::kBytes;
  static bool configured[kMaxDevices] = {};
  err = allow_smem(flash_bwd_dkdv_wgmma<D>, smem, configured);
  if (err) return err;
  const dim3 grid((S + kTile - 1) / kTile, KV, B);
  flash_bwd_dkdv_wgmma<D><<<grid, kDkdvThreads, smem, stream>>>(
      qm, km, vm, dom, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
      lengths, S, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

// Strides fit 16-byte accesses (TMA for bf16, cp.async for f32): a 16-byte
// aligned base and strides that are positive multiples of 16 bytes; dtype
// as the entries take it (0 = float32, 1 = bfloat16).
bool aligned16(const void* p, const long long* strides, int dtype) {
  const int elem = dtype == 0 ? 4 : 2;
  if ((uintptr_t)p % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] <= 0 || (strides[i] * elem) % 16) return false;
  return true;
}

// The strides of n (B, S, heads, D) tensors are those of contiguous ones;
// heads[i] is tensor i's head count.
bool dense(const long long* strides, const int* heads, int n, int S, int D) {
  for (int i = 0; i < n; ++i) {
    const long long want[3] = {(long long)S * heads[i] * D,
                               (long long)heads[i] * D, D};
    for (int j = 0; j < 3; ++j)
      if (strides[3 * i + j] != want[j]) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. D must be 64, 128 or 192 (the wrapper
// checks); 192 is MLA's q/k width, with V zero-padded to it.
// strides: element strides (batch, seq, head) of q, then k, then v; the
// head dim has stride 1; the bases and strides must be 16-byte aligned
// (TMA reads bf16, cp.async f32). lse_out: (B, H, S) float32 for the row
// log-sum-exp, or null. float32 only: with splits > 1, each q tile's keys
// are split over that many blocks (flash_fwd_f32's SPLIT) and scratch holds
// splits B H S (D + 2) floats; else scratch is null.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse_out, void* scratch, int splits,
                        const void* lengths, int B, int S, int H, int KV,
                        int D, const long long* strides, int causal,
                        float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  const int* len = (const int*)lengths;
  float* lse = (float*)lse_out;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!aligned16(q, strides, dtype) || !aligned16(k, strides + 3, dtype) ||
      !aligned16(v, strides + 6, dtype))
    return (int)cudaErrorInvalidValue;
  float* part = (float*)scratch;
  const bool split = splits > 1;
  if (split && (part == nullptr || splits > 64))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return split ? launch_fwd_f32<64, true>(q, k, v, o, lse, part, splits,
                                            len, B, S, H, KV, strides, causal,
                                            scale, st)
                 : launch_fwd_f32<64, false>(q, k, v, o, lse, part, 1, len, B,
                                             S, H, KV, strides, causal, scale,
                                             st);
  if (dtype == 0 && D == 128)
    return split ? launch_fwd_f32<128, true>(q, k, v, o, lse, part, splits,
                                             len, B, S, H, KV, strides,
                                             causal, scale, st)
                 : launch_fwd_f32<128, false>(q, k, v, o, lse, part, 1, len,
                                              B, S, H, KV, strides, causal,
                                              scale, st);
  if (dtype == 0 && D == 192)
    return split ? launch_fwd_f32<192, true>(q, k, v, o, lse, part, splits,
                                             len, B, S, H, KV, strides,
                                             causal, scale, st)
                 : launch_fwd_f32<192, false>(q, k, v, o, lse, part, 1, len,
                                              B, S, H, KV, strides, causal,
                                              scale, st);
  if (dtype == 1) {
    if (D == 64)
      return launch_wgmma<64>(q, k, v, o, lse, len, B, S, H, KV, strides,
                              causal, scale, st);
    if (D == 128)
      return launch_wgmma<128>(q, k, v, o, lse, len, B, S, H, KV, strides,
                               causal, scale, st);
    if (D == 192)
      return launch_wgmma<192>(q, k, v, o, lse, len, B, S, H, KV, strides,
                               causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K1b-dq. q, o, dO (B, S, H, D) and k, v (B, S, KV, D) of dtype; lse (from
// the forward) and delta (written here) (B, H, S) f32; dq (B, S, H, D)
// contiguous. strides: element strides (batch, seq, head) of q, k, v, o,
// then dO; the head dim has stride 1. bfloat16 reads them as they are
// (16-byte aligned base and strides); float32 takes contiguous tensors only.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* o, const void* dO, const void* lse,
                           void* delta, void* dq, const void* lengths, int B,
                           int S, int H, int KV, int D,
                           const long long* strides, int causal, float scale,
                           int dtype, void* stream) {
  if (!bwd_ok(B, S, H, KV, D, dtype)) return (int)cudaErrorInvalidValue;
  const int* len = (const int*)lengths;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const int heads[5] = {H, KV, KV, H, H};
    if (!dense(strides, heads, 5, S, D)) return (int)cudaErrorInvalidValue;
    if (D == 64)
      return launch_bwd_dq_f32<64>(q, k, v, o, dO, l, dl, dq, len, B, S, H,
                                     KV, causal, scale, st);
    return launch_bwd_dq_f32<128>(q, k, v, o, dO, l, dl, dq, len, B, S, H,
                                    KV, causal, scale, st);
  }
  const void* ptrs[5] = {q, k, v, o, dO};
  for (int i = 0; i < 5; ++i)
    if (!aligned16(ptrs[i], strides + 3 * i, 1))
      return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_bwd_dq_wgmma<64>(q, k, v, o, dO, l, dl, dq, len, B, S, H,
                                   KV, strides, causal, scale, st);
  return launch_bwd_dq_wgmma<128>(q, k, v, o, dO, l, dl, dq, len, B, S, H, KV,
                                  strides, causal, scale, st);
}

// K1b-dkdv, after K1b-dq on the same stream (it reads delta). dk, dv
// (B, S, KV, D) contiguous; strides of q, k, v, then dO; the rest as
// flash_attention_bwd_dq.
int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                             void* dk, const void* dO, const void* lse,
                             const void* delta, void* dv,
                             const void* lengths, int B, int S, int H, int KV,
                             int D, const long long* strides, int causal,
                             float scale, int dtype, void* stream) {
  if (!bwd_ok(B, S, H, KV, D, dtype)) return (int)cudaErrorInvalidValue;
  const int* len = (const int*)lengths;
  const float* l = (const float*)lse;
  const float* dl = (const float*)delta;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const int heads[4] = {H, KV, KV, H};
    if (!dense(strides, heads, 4, S, D)) return (int)cudaErrorInvalidValue;
    if (D == 64)
      return launch_bwd_dkdv_f32<64>(q, k, v, dO, l, dl, dk, dv, len, B, S,
                                       H, KV, causal, scale, st);
    return launch_bwd_dkdv_f32<128>(q, k, v, dO, l, dl, dk, dv, len, B, S,
                                        H, KV, causal, scale, st);
  }
  const void* ptrs[4] = {q, k, v, dO};
  for (int i = 0; i < 4; ++i)
    if (!aligned16(ptrs[i], strides + 3 * i, 1))
      return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_bwd_dkdv_wgmma<64>(q, k, v, dO, l, dl, dk, dv, len, B, S, H,
                                     KV, strides, causal, scale, st);
  return launch_bwd_dkdv_wgmma<128>(q, k, v, dO, l, dl, dk, dv, len, B, S, H,
                                    KV, strides, causal, scale, st);
}

}  // extern "C"
