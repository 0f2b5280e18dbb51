// Paged attention over a block-pool KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel analytics_zoo_tpu/ops/flash_attention.py:
// _paged_fused_kernel (launched by _paged_attention_fused).  It computes
// the same function as the plain PyTorch version, paged_attention_ref in
// analytics_zoo_tpu_torch/ops/flash_attention.py:
//
//   query s of row b, head h*G + g, attends logical cache positions
//   p <= pos[b] + s (and p < M * bs, the table's width); position p of
//   row b lives in physical block tables[b, p / bs] at offset p % bs of a
//   head-major [N, KH, bs, D] pool.  Online softmax in f32 with
//   NEG_INF = -1e30, a row with nothing live yet subtracting 0 instead of
//   its max (m_sub), and scale 1/sqrt(D); output f32 [B, S, H, D].  int8
//   pools carry bf16 scales [N, KH, bs]: k-scales multiply the logit
//   columns, v-scales fold into p before p.V.  f32/bf16 pools round p to
//   the pool dtype before p.V, as the TPU kernel and the gather path do.
//
// What bounds it on this card: memory bytes.  Each (row, kv head) must
// read its live K/V rows once, and per byte read the work is a few
// multiply-adds per query row, far below the ~295 operations per byte at
// which an H100 stops waiting on memory, for decode (one query row per
// kv head) and for prefill alike.  So the design keeps loads in flight
// and spreads the bytes over every SM:
//
//   - Gather.  K/V tiles of 64 logical positions (32 for the bf16 kernel
//     at D > 64) are copied by 16-byte cp.async into shared memory, two
//     stages: tile j + 1 is in flight while tile j is used.  Each thread
//     owns one position of a tile and reads its table entry one tile
//     ahead of the copy (the TPU's scalar prefetch), so the copy never
//     waits on the table; positions past the block's causal frontier are
//     zero-filled, never read.  int8 scales ride a register loaded at
//     the copy and stored to shared memory one tile later.
//   - Split-K.  When the few-row kernel's B * KH * (query-row tiles)
//     blocks would not fill two waves of the card's SMs (decode and
//     narrow verify), the logical positions are split into ranges of
//     whole tiles over several CUDA blocks (paged_attention_splits picks
//     the count; the tensor-core kernel takes one split).  Each
//     split writes f32 partials (m in base-2 units, l, unnormalised acc)
//     to a workspace the wrapper allocates; paged_combine_kernel merges
//     them.  A split whose first position lies past a row's frontier is
//     neither read for that row by the combine nor, when no row of its
//     block reaches it, run at all: it would carry m = -1e30, l = 0 and
//     weigh 0.  A split's p is rounded to bf16 relative to that split's
//     running max, not the row's: the same one-ulp effect the bf16
//     tolerance already covers for the plain version's normalised
//     weights.
//   - Few rows (paged_attention_kernel: every pool type, S*G < 16 rows
//     for bf16, any rows for f32 and int8).  CUDA cores, f32 math.  All
//     four warps work even for one query row: warp w takes positions
//     w*16 .. w*16+15 of every tile, lane (key = lane % 16, half = lane
//     / 16) dots its key's half of D with the block's query rows, a
//     shuffle adds the halves, and each warp keeps its own online-softmax
//     state; the four are merged in shared memory at the end (each
//     warp's p is rounded relative to the warp's max, as for a split).
//     f32 pools stay exact f32 products (the f32 engine-token parity
//     needs them; TF32 would not give it), int8 pools f32 on the
//     dequantising scales.
//   - Many rows, bf16 (paged_attention_bf16_kernel: S*G >= 16, prefill
//     chunks and wide verify).  Tensor cores: 64-row query tiles (row
//     r = s*G + g of kv head h, gathered by cp.async), 4 warps of 16
//     rows, q.k^T by mma_abt with the Q fragments resident and p.V by
//     mma_xb (tensor_core.cuh), whose bf16 A operand is the TPU's
//     p.astype(v.dtype).  The causal mask runs only on tiles that cross
//     a warp's frontier; a warp whose rows all end before a tile skips
//     it.
//
// Left for later work: wgmma and TMA for the bf16 kernel, and CUDA graphs
// against the launch overhead of the eager decode step.
//
// Plain C interface (loaded with ctypes): paged_attention_splits returns
// the split count for a shape (0 for a shape the kernels do not take);
// paged_attention_fwd returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for a shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 64;      // logical positions per CUDA-core K/V tile
constexpr int kMaxBs = 64;
constexpr int kTcRows = 64;      // query rows per tensor-core block
constexpr int kMmaMinRows = 16;  // S*G from which bf16 takes tensor cores
// split-K policy (paged_attention_splits; the kernels take any count):
// at most 16 splits
constexpr int kMaxSplits = 16;
constexpr int kSplitsLimit = 1024;

// query rows of a CUDA-core block (a lane keeps m, l, a score, p and
// D / 32 accumulators a row): decode and narrow verify have 1-8
constexpr int kCcRows = 8;

// logical positions per K/V tile of the tensor-core kernel (registers: a
// lane holds D/4 Q fragment registers, D/2 accumulators and keys/2
// scores, so D > 64 takes half the keys)
__host__ __device__ constexpr int tc_keys(int D) { return D <= 64 ? 64 : 32; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// p as the p.V product sees it: rounded to the pool's storage type for
// bf16 pools; f32 pools keep f32 (int8 folds the v-scale instead)
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

// acc / l, or 0 for a row with nothing live (l = 0, acc = 0).
// __fdividef (within 2 ulp): the IEEE division's slow path is a
// subroutine call, and the registers saved around it are spills
__device__ __forceinline__ float safe_div(float a, float l) {
  return l > 0.f ? __fdividef(a, l) : 0.f;
}

// kN consecutive elements of a shared-memory row as f32, read as the
// widest aligned words the width allows (the row offset is a multiple
// of kN elements); a width that is no such word (1, 3, 6 or 12 bytes: a
// lane's D / 32 values at D = 96, or at D = 32 in int8) element by
// element
template <typename T, int kN>
__device__ __forceinline__ void load_f32(float (&dst)[kN], const T* src) {
  constexpr int kBytes = kN * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 != 0 && kBytes != 8 && kBytes != 4 &&
                kBytes != 2) {
#pragma unroll
    for (int i = 0; i < kN; ++i) dst[i] = to_f32(src[i]);
  } else {
    uint32_t w[(kBytes + 3) / 4];
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const uint4 x = reinterpret_cast<const uint4*>(src)[i];
        w[4 * i] = x.x;
        w[4 * i + 1] = x.y;
        w[4 * i + 2] = x.z;
        w[4 * i + 3] = x.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 x = *reinterpret_cast<const uint2*>(src);
      w[0] = x.x;
      w[1] = x.y;
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(src);
    } else {
      w[0] = *reinterpret_cast<const uint16_t*>(src);
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if constexpr (std::is_same_v<T, float>) {
        dst[i] = __uint_as_float(w[i]);
      } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        dst[i] = __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u
                                       : w[i / 2] << 16);
      } else {
        dst[i] = static_cast<float>(
            static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
      }
    }
  }
}

// This thread's share of the K/V gather of one tile of kN logical
// positions t0 .. t0 + kN - 1 of kv head h into [kN][kLd] shared tiles:
// kThreads / kN threads per position, each copying every
// (kThreads / kN)-th 16-byte chunk of the position's K and V rows.  blk
// is the position's physical block (read a tile ahead by the caller); a
// position past `last` is zero-filled and its block never read.
template <typename TKV, int D, int kN, int kLd>
__device__ __forceinline__ void gather_kv(TKV* ks, TKV* vs,
                                          const TKV* __restrict__ kpool,
                                          const TKV* __restrict__ vpool,
                                          int blk, int t0, int last, int h,
                                          int KH, int bs) {
  constexpr int kTpr = kThreads / kN;  // threads per position
  constexpr int kChunks = D * static_cast<int>(sizeof(TKV)) / 16;
  constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));
  static_assert(kChunks % kTpr == 0, "whole chunks per thread");
  const int r = threadIdx.x / kTpr, part = threadIdx.x % kTpr;
  const int t = t0 + r;
  const bool in = t <= last;
  const size_t off =
      in ? ((static_cast<size_t>(blk) * KH + h) * bs + t % bs) * D : 0;
#pragma unroll
  for (int i = 0; i < kChunks / kTpr; ++i) {
    const int c = part + i * kTpr;
    tc::cp_async16(ks + r * kLd + c * kVec, kpool + off + c * kVec,
                   in ? 16 : 0);
    tc::cp_async16(vs + r * kLd + c * kVec, vpool + off + c * kVec,
                   in ? 16 : 0);
  }
}

// The physical block of this thread's position in the tile at t0 (0 for
// a position past `last`, which is zero-filled)
template <int kN>
__device__ __forceinline__ int table_entry(const int* __restrict__ row,
                                           int t0, int last, int bs) {
  const int t = t0 + threadIdx.x / (kThreads / kN);
  return t <= last ? row[t / bs] : 0;
}

// Where a split writes its partials for output row o of rows = B*S*H:
// acc [D] (unnormalised), m (base-2 units) and l, each split's after the
// one before
struct Partials {
  float* ws;
  int rows, splits, D;
  __device__ float* acc(int split, size_t o) const {
    return ws + (static_cast<size_t>(split) * rows + o) * D;
  }
  __device__ float* m(int split, size_t o) const {
    return ws + static_cast<size_t>(splits) * rows * D +
           static_cast<size_t>(split) * rows + o;
  }
  __device__ float* l(int split, size_t o) const {
    return m(split, o) + static_cast<size_t>(splits) * rows;
  }
};

// Few query rows, any pool type: CUDA cores, f32 math (see the header).
// Launch bounds of one block an SM: with none given, ptxas held some
// instantiations to the register count of the next occupancy step (96,
// 128 or 168) and spilled a few registers to get there
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads, 1)
    paged_attention_kernel(const TQ* __restrict__ q,
                           const TKV* __restrict__ kpool,
                           const TKV* __restrict__ vpool,
                           const __nv_bfloat16* __restrict__ kscale,
                           const __nv_bfloat16* __restrict__ vscale,
                           const int* __restrict__ tables,
                           const int* __restrict__ pos,
                           float* __restrict__ out, Partials part, int S,
                           int H, int KH, int bs, int M, int chunk,
                           float scale2) {
  constexpr bool kQuant = std::is_same_v<TKV, int8_t>;
  constexpr int kR = kCcRows;
  constexpr int kLd = D + 16 / static_cast<int>(sizeof(TKV));  // padded
  constexpr int kHalf = D / 2;  // a lane's half of a key's dot
  constexpr int kVec = 16 / static_cast<int>(sizeof(TKV));
  constexpr int kDl = D / 32;   // output dims per lane
  constexpr int kStage = kKeys * kLd;
  static_assert(kWarps * kR * (D + 2) * sizeof(float) <=
                    4 * kStage * sizeof(TKV),
                "the merge scratch fits in the K/V stages");
  const int h = blockIdx.y, b = blockIdx.z;
  // the last row tiles attend the most positions: start them first
  const int split = blockIdx.x % part.splits;
  const int row0 =
      (gridDim.x / part.splits - 1 - blockIdx.x / part.splits) * kR;
  const int G = H / KH;
  const int nr = min(kR, S * G - row0);  // live rows of this block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key = lane % 16, half = lane / 16;

  const int pos_b = pos[b];
  const int lim = M * bs - 1;  // the table's last position
  // the block's frontier: its last row attends the furthest
  const int last = min(pos_b + (row0 + nr - 1) / G, lim);
  const int t_begin = split * chunk;
  if (t_begin > last) return;  // no row of this block reads the split
  const int nt = (min(t_begin + chunk, last + 1) - t_begin + kKeys - 1) /
                 kKeys;

  extern __shared__ __align__(16) unsigned char smem[];
  TKV* k_s = reinterpret_cast<TKV*>(smem);  // [2][kKeys][kLd]
  TKV* v_s = k_s + 2 * kStage;              // [2][kKeys][kLd]
  float* q_s = reinterpret_cast<float*>(v_s + 2 * kStage);  // [kR][D]
  float* sc_s = q_s + kR * D;  // [2 stages][k, v][kKeys] int8 scales
  int* fr_s = reinterpret_cast<int*>(sc_s + 4 * kKeys);  // [kR]

  for (int idx = threadIdx.x; idx < kR * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, rr = row0 + r;
    q_s[idx] = r < nr ? to_f32(q[((static_cast<size_t>(b) * S + rr / G) * H +
                                  h * G + rr % G) *
                                     D +
                                 d])
                      : 0.f;
  }
  // each row's last live position
  if (threadIdx.x < kR)
    fr_s[threadIdx.x] = min(pos_b + (row0 + threadIdx.x) / G, lim);

  const int* trow = tables + static_cast<size_t>(b) * M;
  int ent = table_entry<kKeys>(trow, t_begin, last, bs);
  float sc = 0.f;  // int8: this thread's scale of the tile last issued
  auto issue = [&](int j) {  // tile j into stage j & 1, through ent
    const int t0 = t_begin + j * kKeys, st = j & 1;
    gather_kv<TKV, D, kKeys, kLd>(k_s + st * kStage, v_s + st * kStage,
                                  kpool, vpool, ent, t0, last, h, KH, bs);
    if constexpr (kQuant) {  // two threads a position: k-, then v-scale
      const int t = t0 + threadIdx.x / 2;
      const __nv_bfloat16* src = threadIdx.x % 2 ? vscale : kscale;
      sc = t <= last ? __bfloat162float(
                           src[(static_cast<size_t>(ent) * KH + h) * bs +
                               t % bs])
                     : 0.f;
    }
  };
  issue(0);
  if (nt > 1) ent = table_entry<kKeys>(trow, t_begin + kKeys, last, bs);
  tc::cp_async_commit();

  float m[kR], l[kR], acc[kR][kDl];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDl; ++c) acc[r][c] = 0.f;
  }

  for (int j = 0; j < nt; ++j) {
    const int st = j & 1;
    const int t0 = t_begin + j * kKeys;
    if constexpr (kQuant)  // tile j's scales, loaded when it was issued
      sc_s[(st * 2 + threadIdx.x % 2) * kKeys + threadIdx.x / 2] = sc;
    if (j + 1 < nt) {  // tile j + 1 in flight, the entries of j + 2 read
      issue(j + 1);
      if (j + 2 < nt)
        ent = table_entry<kKeys>(trow, t0 + 2 * kKeys, last, bs);
    }
    tc::cp_async_commit();   // (empty on the last tile)
    tc::cp_async_wait<1>();  // tile j landed
    __syncthreads();

    const int w0 = warp * 16;  // the warp's positions t0 + w0 ..
    if (t0 + w0 <= last) {     // warp-uniform: else all of them are dead
      const int t = t0 + w0 + key;  // the lane's position
      const TKV* kr = k_s + st * kStage + (w0 + key) * kLd + half * kHalf;
      float s[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) s[r] = 0.f;
#pragma unroll
      for (int c = 0; c < kHalf; c += kVec) {
        float kv[kVec];
        load_f32<TKV, kVec>(kv, kr + c);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (r >= nr) continue;
          float qv[kVec];
          load_f32<float, kVec>(qv, q_s + r * D + half * kHalf + c);
#pragma unroll
          for (int e = 0; e < kVec; ++e) s[r] = fmaf(qv[e], kv[e], s[r]);
        }
      }
      float ks = 1.f, vs = 1.f;
      if constexpr (kQuant) {
        ks = sc_s[(st * 2) * kKeys + w0 + key];
        vs = sc_s[(st * 2 + 1) * kKeys + w0 + key];
      }
      float pv[kR];  // p as p.V takes it
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r >= nr) continue;
        // the two halves of D, then scores in base-2 units
        float x = (s[r] + __shfl_xor_sync(0xffffffffu, s[r], 16)) * scale2;
        if constexpr (kQuant) x *= ks;
        if (t > fr_s[r]) x = kNegInf;
        float mx = x;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[r], mx);
        // a row with nothing live yet subtracts 0, so exp(NEG_INF)
        // underflows to 0 instead of exp(0) = 1
        const float m_sub = m_new > kNegInf * 0.5f ? m_new : 0.f;
        const float alpha = exp2f(m[r] - m_new);
        const float p = exp2f(x - m_sub);
        m[r] = m_new;
        l[r] = l[r] * alpha + p;  // this lane's key; summed at the end
#pragma unroll
        for (int c = 0; c < kDl; ++c) acc[r][c] *= alpha;
        if constexpr (kQuant)
          pv[r] = p * vs;
        else
          pv[r] = round_p(p, TKV());
      }
      // acc += p . V over the warp's 16 positions (lane u holds key u's p)
      const TKV* vr = v_s + st * kStage + w0 * kLd + lane * kDl;
#pragma unroll 4
      for (int u = 0; u < 16; ++u) {
        float vv[kDl];
        load_f32<TKV, kDl>(vv, vr + u * kLd);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (r >= nr) continue;
          const float pu = __shfl_sync(0xffffffffu, pv[r], u);
#pragma unroll
          for (int c = 0; c < kDl; ++c) acc[r][c] = fmaf(pu, vv[c], acc[r][c]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before its reload
  }
  tc::cp_async_wait<0>();

  // merge the four warps' states in shared memory (the K/V stages, free)
  float* macc = reinterpret_cast<float*>(smem);  // [kWarps][kR][D]
  float* mm = macc + kWarps * kR * D;            // [kWarps][kR]
  float* ml = mm + kWarps * kR;                  // [kWarps][kR]
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= nr) continue;
    float lr = l[r];  // over the 16 keys of one half (the halves agree)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      lr += __shfl_xor_sync(0xffffffffu, lr, o);
#pragma unroll
    for (int c = 0; c < kDl; ++c)
      macc[(warp * kR + r) * D + lane * kDl + c] = acc[r][c];
    if (lane == 0) {
      mm[warp * kR + r] = m[r];
      ml[warp * kR + r] = lr;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nr * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, rr = row0 + r;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, mm[w * kR + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp with nothing live has l = 0 and acc = 0: it weighs 0
      const float c = exp2f(mm[w * kR + r] - mx);
      L += c * ml[w * kR + r];
      A += c * macc[(w * kR + r) * D + d];
    }
    const size_t o = (static_cast<size_t>(b) * S + rr / G) * H + h * G + rr % G;
    if (part.splits == 1) {
      out[o * D + d] = safe_div(A, L);
    } else {
      part.acc(split, o)[d] = A;
      if (d == 0) {
        *part.m(split, o) = mx;
        *part.l(split, o) = L;
      }
    }
  }
}

// Many query rows, bf16 q and pool: tensor cores (see the header)
template <int D>
__global__ void __launch_bounds__(kThreads)
    paged_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ kpool,
                                const __nv_bfloat16* __restrict__ vpool,
                                const int* __restrict__ tables,
                                const int* __restrict__ pos,
                                float* __restrict__ out, Partials part,
                                int S, int H, int KH, int bs, int M,
                                int chunk, float scale2) {
  constexpr int kN = tc_keys(D);
  constexpr int kLd = D + tc::kPad;
  constexpr int kNs = kN / 8;  // n8 blocks of a warp's score tile
  constexpr int kNo = D / 8;   // n8 blocks of a warp's output rows
  constexpr int kStage = kN * kLd;
  const int h = blockIdx.y, b = blockIdx.z;
  // the last row tiles attend the most positions: start them first
  const int split = blockIdx.x % part.splits;
  const int row0 =
      (gridDim.x / part.splits - 1 - blockIdx.x / part.splits) * kTcRows;
  const int G = H / KH, R = S * G;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's rows r0 .. r0+15
  const int c2 = (lane % 4) * 2;           // the lane's column pair
  // the lane's two rows, g and g + 8 of the warp's 16
  const int rows[2] = {row0 + r0 + lane / 4, row0 + r0 + lane / 4 + 8};

  const int pos_b = pos[b];
  const int lim = M * bs - 1;  // the table's last position
  const int last = min(pos_b + (min(row0 + kTcRows, R) - 1) / G, lim);
  const int t_begin = split * chunk;
  if (t_begin > last) return;  // no row of this block reads the split
  const int nt = (min(t_begin + chunk, last + 1) - t_begin + kN - 1) / kN;
  // each lane row's last live position; the warp's first and last
  // rows' (warp-uniform)
  int fr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) fr[i] = min(pos_b + rows[i] / G, lim);
  const bool warp_rows = row0 + r0 < R;
  const int w_first = min(pos_b + (row0 + r0) / G, lim);
  const int w_last = min(pos_b + (min(row0 + r0 + 15, R - 1)) / G, lim);

  extern __shared__ __align__(16) __nv_bfloat16 tiles[];
  __nv_bfloat16* q_s = tiles;                 // [64][kLd]
  __nv_bfloat16* k_s = q_s + kTcRows * kLd;   // [2][kN][kLd]
  __nv_bfloat16* v_s = k_s + 2 * kStage;      // [2][kN][kLd]

  // the block's query rows: row r is query (s = r / G, head h*G + r % G)
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < kTcRows * kChunks / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kChunks, c = idx % kChunks, rr = row0 + r;
    const bool in = rr < R;
    const __nv_bfloat16* src =
        in ? q + ((static_cast<size_t>(b) * S + rr / G) * H + h * G +
                  rr % G) *
                     D +
                 c * 8
           : q;
    tc::cp_async16(q_s + r * kLd + c * 8, src, in ? 16 : 0);
  }
  const int* trow = tables + static_cast<size_t>(b) * M;
  int ent = table_entry<kN>(trow, t_begin, last, bs);
  gather_kv<__nv_bfloat16, D, kN, kLd>(k_s, v_s, kpool, vpool, ent, t_begin,
                                       last, h, KH, bs);
  if (nt > 1) ent = table_entry<kN>(trow, t_begin + kN, last, bs);
  tc::cp_async_commit();

  uint32_t qf[D / 16][4];  // the warp's Q A fragments, resident
  float acc[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // per lane row: running max (base-2 units) and this lane's part of l
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < nt; ++j) {
    const int st = j & 1;
    const int t0 = t_begin + j * kN;
    if (j + 1 < nt) {  // tile j + 1 in flight, the entries of j + 2 read
      gather_kv<__nv_bfloat16, D, kN, kLd>(
          k_s + (st ^ 1) * kStage, v_s + (st ^ 1) * kStage, kpool, vpool,
          ent, t0 + kN, last, h, KH, bs);
      if (j + 2 < nt) ent = table_entry<kN>(trow, t0 + 2 * kN, last, bs);
    }
    tc::cp_async_commit();   // (empty on the last tile)
    tc::cp_async_wait<1>();  // tile j (and, first, the q tile) landed
    __syncthreads();
    if (j == 0) tc::load_a_frags<D>(qf, q_s, r0, lane);

    // warp-uniform: a warp of rows past R, or whose rows all end before
    // this tile, skips it
    if (warp_rows && t0 <= w_last) {
      float s[kNs][4];
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      tc::mma_abt<D, kNs>(s, qf, k_s + st * kStage, lane);

      // only a tile that reaches past the warp's first row's frontier
      // holds a dead position for any of its rows
      const bool edge = t0 + kN - 1 > w_first;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale2;
          if (edge && t0 + n * 8 + c2 + (e & 1) > fr[e / 2]) x = kNegInf;
          s[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      float m_sub[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], tc::quad_max(mx[i]));
        m_sub[i] = m_new > kNegInf * 0.5f ? m_new : 0.f;
        const float alpha = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int n = 0; n < kNo; ++n) {
          acc[n][2 * i] *= alpha;
          acc[n][2 * i + 1] *= alpha;
        }
      }
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - m_sub[e / 2]);
          l[e / 2] += p;
          s[n][e] = p;
        }
      // p rounded to bf16 straight into A fragments: acc += p . V
      tc::mma_xb<D, kN>(acc, s, v_s + st * kStage, lane);
    }
    __syncthreads();  // every warp is done with stage st before its reload
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = tc::quad_sum(l[i]);
    const int r = rows[i];
    if (r >= R) continue;
    const size_t o = (static_cast<size_t>(b) * S + r / G) * H + h * G + r % G;
    float* dst = part.splits == 1 ? out + o * D : part.acc(split, o);
    const float l1 = part.splits == 1 ? li : 1.f;  // partials: unnormalised
#pragma unroll
    for (int n = 0; n < kNo; ++n)
      *reinterpret_cast<float2*>(dst + n * 8 + c2) = make_float2(
          safe_div(acc[n][2 * i], l1), safe_div(acc[n][2 * i + 1], l1));
    if (part.splits > 1 && c2 == 0) {
      *part.m(split, o) = m[i];
      *part.l(split, o) = li;
    }
  }
}

// Output row o of [B, S, H] from the partials of the splits that hold
// any of its live positions (split k does iff k * chunk <= its frontier);
// one warp a row, D / 32 dims a lane
template <int D>
__global__ void __launch_bounds__(kThreads)
    paged_combine_kernel(Partials part, const int* __restrict__ pos,
                         float* __restrict__ out, int S, int H, int bs,
                         int M, int chunk) {
  constexpr int kDl = D / 32;
  const int o = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (o >= part.rows) return;
  const int s = (o / H) % S, b = o / (H * S);
  const int f = min(pos[b] + s, M * bs - 1);
  const int n = min(f / chunk + 1, part.splits);
  float mx = kNegInf;
  for (int k = 0; k < n; ++k) mx = fmaxf(mx, *part.m(k, o));
  float L = 0.f, A[kDl];
#pragma unroll
  for (int c = 0; c < kDl; ++c) A[c] = 0.f;
  for (int k = 0; k < n; ++k) {
    const float w = exp2f(*part.m(k, o) - mx);
    L += w * *part.l(k, o);
    float a[kDl];
    load_f32<float, kDl>(a, part.acc(k, o) + lane * kDl);
#pragma unroll
    for (int c = 0; c < kDl; ++c) A[c] = fmaf(w, a[c], A[c]);
  }
#pragma unroll
  for (int c = 0; c < kDl; ++c)
    out[static_cast<size_t>(o) * D + lane * kDl + c] = safe_div(A[c], L);
}

struct Args {
  const void *q, *k, *v, *ks, *vs;
  const int *tables, *pos;
  float *out, *ws;
  int splits, B, S, H, KH, bs, M;
  cudaStream_t stream;
};

// the tensor-core kernel takes bf16 q and pool from kMmaMinRows rows
bool use_mma(bool q_bf16, int kv_kind, int rows) {
  return q_bf16 && kv_kind == 1 && rows >= kMmaMinRows;
}

// (query rows a block, logical positions a K/V tile) of a path
void path_tiles(bool mma, int D, int* rows, int* keys) {
  *rows = mma ? kTcRows : kCcRows;
  *keys = mma ? tc_keys(D) : kKeys;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const Args& a) {
  const int rows = a.S * (a.H / a.KH);
  constexpr bool kBf16 =
      std::is_same_v<TQ, __nv_bfloat16> && std::is_same_v<TKV, __nv_bfloat16>;
  const bool mma = use_mma(kBf16, kBf16 ? 1 : 0, rows);
  int per_block, keys;
  path_tiles(mma, D, &per_block, &keys);
  const int ntiles = (a.M * a.bs + keys - 1) / keys;
  const int chunk = (ntiles + a.splits - 1) / a.splits * keys;
  const Partials part{a.ws, a.B * a.S * a.H, a.splits, D};
  const dim3 grid((rows + per_block - 1) / per_block * a.splits, a.KH, a.B);
  const float scale2 = tc::kLog2e / sqrtf(static_cast<float>(D));
  cudaError_t e;
  if (mma) {
    if constexpr (kBf16) {
      auto kernel = paged_attention_bf16_kernel<D>;
      const size_t smem = sizeof(__nv_bfloat16) *
                          (kTcRows + 4 * tc_keys(D)) * (D + tc::kPad);
      if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;
      kernel<<<grid, kThreads, smem, a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.q),
          static_cast<const __nv_bfloat16*>(a.k),
          static_cast<const __nv_bfloat16*>(a.v), a.tables, a.pos, a.out,
          part, a.S, a.H, a.KH, a.bs, a.M, chunk, scale2);
    }
  } else {
    auto kernel = paged_attention_kernel<TQ, TKV, D>;
    const size_t smem = 4 * kKeys * (D + 16 / sizeof(TKV)) * sizeof(TKV) +
                        sizeof(float) * (kCcRows * D + 4 * kKeys) +
                        sizeof(int) * kCcRows;
    if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
        static_cast<const TKV*>(a.v),
        static_cast<const __nv_bfloat16*>(a.ks),
        static_cast<const __nv_bfloat16*>(a.vs), a.tables, a.pos, a.out,
        part, a.S, a.H, a.KH, a.bs, a.M, chunk, scale2);
  }
  if ((e = cudaGetLastError()) != cudaSuccess || a.splits == 1) return e;
  paged_combine_kernel<D><<<(part.rows + kWarps - 1) / kWarps, kThreads, 0,
                            a.stream>>>(part, a.pos, a.out, a.S, a.H, a.bs,
                                        a.M, chunk);
  return cudaGetLastError();
}

// the head dims valid() takes: the multiples of 32 up to 128 (a lane of
// the CUDA-core kernel accumulates D / 32 output dims)
template <typename TQ, typename TKV>
cudaError_t launch_d(int D, const Args& a) {
  switch (D) {
    case 32:
      return launch<TQ, TKV, 32>(a);
    case 64:
      return launch<TQ, TKV, 64>(a);
    case 96:
      return launch<TQ, TKV, 96>(a);
    case 128:
      return launch<TQ, TKV, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t launch_kv(int kv_kind, int D, const Args& a) {
  switch (kv_kind) {
    case 0:
      return launch_d<TQ, float>(D, a);
    case 1:
      return launch_d<TQ, __nv_bfloat16>(D, a);
    case 2:
      return launch_d<TQ, int8_t>(D, a);
    default:
      return cudaErrorInvalidValue;
  }
}

bool valid(int kv_kind, int B, int S, int H, int KH, int D, int bs, int M) {
  return B >= 1 && S >= 1 && KH >= 1 && H >= KH && H % KH == 0 && M >= 1 &&
         bs >= 1 && bs <= kMaxBs && B <= 65535 && KH <= 65535 &&
         D % 32 == 0 && D >= 32 && D <= 128 && kv_kind >= 0 &&
         kv_kind <= 2 &&
         static_cast<long long>(M) * bs <= 0x7fffffffLL &&
         static_cast<long long>(B) * S * H <= 0x7fffffffLL;
}

}  // namespace

// How many splits paged_attention_fwd should take for this shape on a
// card of `sms` SMs, from the blocks one split gives (B * KH * query-row
// tiles) and the tiles the table holds.  The CUDA-core kernel (few rows:
// decode) is bound by the latency of its loads, so below two waves of
// SMs it takes one split per K/V tile, at most 16 (chip_smoke.py phase 7
// on an H100, decode at B=8: 1 split 17.0 us, 3: 16.7, 9: 12.3).  The
// tensor-core kernel (many rows) takes one split: of the paged engine's
// prefill shapes, only a one-row 32-token group (12 blocks) ran faster
// split (9.2 us, 9 splits 6.8); the others, 48-384 blocks, ran 1.0-1.9x
// slower at 2-9 splits.  0 for a shape the kernels do not take.
extern "C" int paged_attention_splits(int q_bf16, int kv_kind, int B, int S,
                                      int H, int KH, int D, int bs, int M,
                                      int sms) {
  if (!valid(kv_kind, B, S, H, KH, D, bs, M) || sms < 1) return 0;
  const int rows = S * (H / KH);
  if (use_mma(q_bf16 != 0, kv_kind, rows)) return 1;
  const long long base =
      static_cast<long long>(B) * KH * ((rows + kCcRows - 1) / kCcRows);
  const long long ntiles = (static_cast<long long>(M) * bs + kKeys - 1) /
                           kKeys;
  long long n = base < 2LL * sms ? ntiles : 1;
  n = n < kMaxSplits ? n : kMaxSplits;
  const long long per_split = (ntiles + n - 1) / n;  // no empty tail split
  return static_cast<int>((ntiles + per_split - 1) / per_split);
}

// q [B, S, H, D] f32 (q_bf16 = 0) or bf16 (1); k, v [N, KH, bs, D] of
// kv_kind 0 = f32, 1 = bf16, 2 = int8 with bf16 scales ks, vs [N, KH, bs];
// q, k and v 16-byte aligned (cp.async); tables [B, M] int32; pos [B]
// int32; out [B, S, H, D] f32.  splits >= 1 ranges of logical positions
// (paged_attention_splits); splits > 1 needs a workspace of
// splits * B * S * H * (D + 2) f32 and launches the combine kernel after
// the split kernel.
extern "C" int paged_attention_fwd(const void* q, int q_bf16, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, int kv_kind,
                                   const void* tables, const void* pos,
                                   void* out, void* workspace, int splits,
                                   int B, int S, int H, int KH, int D, int bs,
                                   int M, void* stream) {
  if (!valid(kv_kind, B, S, H, KH, D, bs, M) || splits < 1 ||
      splits > kSplitsLimit || (splits > 1 && workspace == nullptr) ||
      (kv_kind == 2 && !(ks && vs)))
    return cudaErrorInvalidValue;
  const Args a{q,
               k,
               v,
               ks,
               vs,
               static_cast<const int*>(tables),
               static_cast<const int*>(pos),
               static_cast<float*>(out),
               static_cast<float*>(workspace),
               splits,
               B,
               S,
               H,
               KH,
               bs,
               M,
               static_cast<cudaStream_t>(stream)};
  if (q_bf16) return launch_kv<__nv_bfloat16>(kv_kind, D, a);
  return launch_kv<float>(kv_kind, D, a);
}
