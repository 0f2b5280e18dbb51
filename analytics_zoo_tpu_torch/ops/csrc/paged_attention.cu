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
// read its live K/V rows once, and each bf16 K or V element read serves
// 2 * S * G operations (the S * G rows of its kv head): 8 a byte at
// TinyLlama's decode, 40 at its verify, far below the ~295 operations a
// byte at which an H100 stops waiting on memory.  Only prefill groups of
// hundreds of rows a kv head come near both limits (there the q read and
// the f32 output write are most of the bytes).  A decode call moves
// 2.5-7.4 MB (0.8-2.2 us at 3.35 TB/s), so what it really pays is
// latency: the launch, the table read, one round trip per gathered page,
// and merging the splits.  Three kernels, chosen up front in the C
// dispatch (never a fallback after a failed launch):
//
// bf16 q and pool at D = 64 and 128, bs 8, 16, 32 or 64, every row count
// (decode, verify, chunked ticks, prefill groups; every main path):
// paged_attention_wgmma_kernel, on Hopper's own instructions
// (hopper.cuh).
//   - Rows.  The rows r = s*G + g of one kv head (query s, head h*G + g)
//     form tiles of 64 rows, one consumer warpgroup each: 128-row tiles
//     of two consumers (one block an SM by registers, where 64-row
//     blocks fit three), and two consumers taking alternate tiles of the
//     same rows, were tried on an H100 and ran slower (development runs;
//     no committed script measures them).  Q comes
//     straight from device memory into wgmma's register A operand.  A
//     decode tile has 1 (MHA) or 8 (8-way GQA) live rows of its 64: the
//     other rows cost tensor-core work (q = 0), which a call bound by
//     bytes and latency does not feel (one 64 x 64 x 64 product is
//     ~0.1 us of one SM's tensor cores), and a 64-row tile is wgmma's
//     smallest M.
//   - Pages by TMA, driven by the block table.  The pool [N, KH, bs, D]
//     is a 2-D tensor map [N*KH*bs rows, D]: the page of kv head h in
//     block n is bs rows at row (n*KH + h)*bs, one box per 64 columns
//     (128-byte swizzle, the layout wgmma's descriptors read).  A
//     producer warp reads each table entry of its block's tiles once,
//     one page a lane, and issues every page of a 64-position tile (K
//     and V) into a ring of stages (4 at D = 64, 3 at D = 128), each
//     completing on an mbarrier with its byte count; so up to 256
//     positions of pages are in flight at once (deeper rings, and pages
//     of 64 rows instead of 16, did not move a call's time in
//     development runs).  A page
//     past the tile's
//     frontier is never looked up: its box is addressed past the
//     pool's last row, where the copy reads no memory and lands zeros
//     (the table may hold stale or sentinel ids there); an entry outside
//     [0, N) is treated the same.  The pools' maps are encoded once per
//     (pointer, shape) and cached (page_map).
//   - Products: S = Q.K^T (Q from registers, K K-major) and O += P.V (P
//     the S accumulators rounded to bf16 in registers, the TPU kernel's
//     cast point, V MN-major), both wgmma; turn i issues S(i) and
//     P(i-1).V(i-1) together and runs tile i's softmax while P.V runs,
//     the first and last turns peeled so that no wgmma sits under a
//     branch.  The causal mask runs only on a tile that crosses the
//     warp's first row's frontier, branch-free inside it.
//   - Split-K inside a cluster.  The live tiles of a row tile (those up
//     to its last row's frontier) form `splits` ranges; the C = min(
//     splits, 8) blocks of one cluster take ranges rank, rank + C, ...,
//     so every split count computes the same function.  Each block
//     keeps its (m, l, acc) in its consumed stages; after a cluster
//     barrier, block `rank` reads every block's through distributed
//     shared memory, in the order of rank (bitwise repeatable), and
//     writes rows rank, rank + C, ... of the tile normalised, once.  A
//     split with nothing live for a row weighs 0.  One launch a call,
//     no partials, no workspace; at one split the consumers write the
//     output straight from their registers.
//   - A block size that is not whole 8-row swizzle atoms, or does not
//     divide the 64-position tile (1-7, 24, 40, ...), would put a page's
//     box off the layout the descriptors read: such bs take the kernels
//     below (wg_block).
//
// f32 and int8 pools, and bf16 with fewer than 16 rows at D = 32 and 96
// or at such a bs: paged_attention_kernel, CUDA cores, f32 math.  K/V
// tiles of 64 logical positions are copied by 16-byte cp.async into
// shared memory, two stages, each thread reading its position's table
// entry a tile ahead of the copy; positions past the block's frontier are
// zero-filled, never read; int8 scales ride a register loaded at the copy.
// All four warps work even for one query row: warp w takes positions
// w*16 .. w*16+15 of every tile, lane (key = lane % 16, half = lane / 16)
// dots its key's half of D with the block's query rows, a shuffle adds the
// halves, and each warp keeps its own online-softmax state, merged in
// shared memory at the end.  f32 pools stay exact f32 products (the f32
// engine-token parity needs them; TF32 would not give it), int8 pools f32
// on the dequantising scales.  Below two waves of SMs the positions are
// split over blocks (paged_attention_splits); each split writes f32
// partials (m in base-2 units, l, unnormalised acc) to a workspace the
// wrapper allocates and paged_combine_kernel merges them; a split past
// every row's frontier is neither run nor read.
//
// bf16 with 16 or more rows at D = 32 and 96, or at such a bs:
// paged_attention_bf16_kernel, mma.sync: 64-row query tiles by cp.async, 4
// warps of 16 rows, q.k^T by mma_abt with the Q fragments resident and
// p.V by mma_xb (tensor_core.cuh), one split.
//
// In every kernel a split's (and a warp's) p is rounded to bf16 relative
// to its own running max, not the row's: the one-ulp effect the bf16
// tolerance already covers for the plain version's normalised weights.
//
// Left for later work: a 64-position turn of the wgmma kernel takes ~0.6
// us (its tensor-core and exponential work at full rate is ~0.3): mostly
// the softmax and issuing the register-operand products, which holds
// the warp, with P.V's wait placed before the softmax by ptxas; and a
// decode block's start-up (pos, then the table, then the first TMA) is
// ~3 us of its ~6.5.  S from shared memory, and turns of two consumers
// as flash_attention.cu's forward takes, are the next things to try; and
// CUDA graphs against the launch overhead of the eager decode step
// (ROADMAP item 4.7).
//
// Plain C interface (loaded with ctypes): paged_attention_splits returns
// the split count for a shape (0 for a shape the kernels do not take);
// paged_attention_fwd returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for a shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "hopper.cuh"
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
// the wgmma path splits only a table of at least kWgSplitTableTiles
// 64-position tiles, into ranges of at least kWgSplitTiles tiles
// (paged_attention_splits)
constexpr long long kWgSplitTableTiles = 16;
constexpr long long kWgSplitTiles = 4;

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

// ---- bf16 at D = 64 and 128: TMA page gathers, wgmma, split-K merged in
// a thread-block cluster (see the header)

constexpr int kWgRows = 64;        // query rows of a block
constexpr int kWgKeys = 64;        // logical positions a K/V tile
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kConsumerDone = 1;      // named barrier: stages are free
constexpr int kWgThreads = 128 + 32;  // the consumer, then the producer

// The K/V ring: stage s holds the K (then V) rows of kWgKeys positions as
// D / 64 boxes [64][64] (128-byte swizzle), page i of the tile at rows
// i * bs of every box; then the stages' full and empty mbarriers.  4
// stages at D = 64 (64 KB), 3 at D = 128 (96 KB): up to 256 positions
// of pages in flight, and three (two) blocks an SM.  Deeper rings (up to
// 12 stages, a whole decode range in flight) ran no faster on an H100
// in development runs: a tile's time is not its load's.
template <int D>
__host__ __device__ constexpr int stage_elems() {
  return kWgKeys * D;
}
template <int D>
__host__ __device__ constexpr int wg_stages() {
  return D <= 64 ? 4 : 3;
}
template <int D>
constexpr size_t paged_smem_bytes() {
  // + the slack align1024 may skip
  return 1024 + wg_stages<D>() * (2 * sizeof(__nv_bfloat16) *
                                       stage_elems<D>() +
                                   2 * sizeof(uint64_t));
}

// The block sizes the wgmma path takes: a page is whole 8-row atoms of
// the 128-byte swizzle (so its box lands 1024-byte aligned in a stage, in
// the layout the descriptors read), and a 64-position tile is whole
// pages.  Any other bs (1-7, 9-15, 24, 40, 48, 56, ...) takes the
// mma.sync / CUDA-core kernels, chosen up front.
__host__ __device__ constexpr bool wg_block(int bs) {
  return bs == 8 || bs == 16 || bs == 32 || bs == 64;
}

// the split-K merge's scratch, in the consumed K stages: acc [64][D + 8]
// f32 (unnormalised; 8 floats of padding keep the quads' stores on
// distinct banks), then (m, l) [64][2]
template <int D>
__host__ __device__ constexpr int merge_ld() {
  return D + 8;
}
template <int D>
constexpr size_t merge_bytes() {
  return sizeof(float) * kWgRows * (merge_ld<D>() + 2);
}
static_assert(merge_bytes<64>() <= 2 * wg_stages<64>() * stage_elems<64>(),
              "the merge scratch fits in the K stages (D = 64)");
static_assert(merge_bytes<128>() <=
                  2 * wg_stages<128>() * stage_elems<128>(),
              "the merge scratch fits in the K stages (D = 128)");

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (hop::smem_u32(p) & 1023)) & 1023);
}

// One block per (row tile of 64 query rows, kv head h, batch row b, split
// rank); the C blocks of a row tile's splits are one cluster.  Threads
// 0-127 are the consumer warpgroup, 128-159 the producer warp.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    paged_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const __nv_bfloat16* __restrict__ q,
                                 const int* __restrict__ tables,
                                 const int* __restrict__ pos,
                                 float* __restrict__ out, int S, int H,
                                 int KH, int bs, int M, int N, int splits,
                                 float scale2) {
  constexpr int kStages = wg_stages<D>();
  constexpr int kBox = kWgKeys * 64;  // elements of a [64][64] box
  constexpr int kNs = kWgKeys / 8;    // n8 blocks of a score row
  constexpr int kNo = D / 8;          // n8 blocks of an output row
  extern __shared__ uint8_t smem_raw[];
  // the ring (see stage_elems): K stages, V stages, full and empty
  __nv_bfloat16* const k_st =
      reinterpret_cast<__nv_bfloat16*>(align1024(smem_raw));
  __nv_bfloat16* const v_st = k_st + kStages * stage_elems<D>();
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(v_st + kStages * stage_elems<D>());
  uint64_t* const empty = full + kStages;
  const int C = static_cast<int>(hop::cluster_size());
  const int rank = static_cast<int>(hop::cluster_rank());
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = H / KH, R = S * G;
  const int lane = threadIdx.x % 32;
  // the last row tiles attend the most positions: start them first
  const int row0 = (gridDim.x / C - 1 - blockIdx.x / C) * kWgRows;
  const int nrows = min(kWgRows, R - row0);  // live rows of the tile
  const int pos_b = pos[b];
  const int lim = M * bs - 1;  // the table's last position
  // the tile's frontier: its last row attends the furthest
  const int last = min(pos_b + (row0 + nrows - 1) / G, lim);
  // tiles 0 .. nt - 1 hold live positions; they form `splits` ranges of
  // `per` tiles, and this block takes ranges rank, rank + C, ... (every
  // split count computes the same function; a block with no range
  // merges l = 0 and weighs 0)
  const int nt = last / kWgKeys + 1;
  const int per = (nt + splits - 1) / splits;
  int n_tiles = 0;
  for (int k = rank; k < splits && k * per < nt; k += C)
    n_tiles += min(per, nt - k * per);
  auto tile = [&](int i) { return (rank + C * (i / per)) * per + i % per; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 128);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // the producer warp: lane p < P issues page p of each tile, K and V,
    // one TMA box per 64 columns, into a ring of stages
    const int P = kWgKeys / bs;  // pages a tile: 1, 2, 4 or 8
    const int* trow = tables + static_cast<size_t>(b) * M;
    if (lane == 0) {
      hop::prefetch_map(&tm_k);
      hop::prefetch_map(&tm_v);
    }
    int ent = -1;
    for (int i = 0; i < n_tiles; ++i) {
      if ((i * P) % 32 == 0) {
        // the table entries of the next 32 / P tiles, one page a lane,
        // each read once; none of a page past the tile's frontier
        const int ii = i + lane / P;
        const int pg = ii < n_tiles ? tile(ii) * P + lane % P : 0;
        ent = ii < n_tiles && pg * bs <= last ? trow[pg] : -1;
      }
      const int s = i % kStages;
      // the first pass over the ring finds every stage free
      hop::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      if (lane == 0)
        hop::mbar_arrive_expect_tx(&full[s], 2 * kWgKeys * D * 2);
      __syncwarp();
      const int e = __shfl_sync(0xffffffffu, ent, (i * P) % 32 + lane % P);
      if (lane < P) {
        // a page past the frontier (-1), or an entry outside the pool,
        // is addressed past the pool's last row: the copy lands zeros
        // and reads no memory
        const int row = e >= 0 && e < N ? (e * KH + h) * bs : N * KH * bs;
        for (int x = 0; x < D / 64; ++x) {
          hop::tma_load_2d(k_st + s * stage_elems<D>() + x * kBox +
                               lane * bs * 64,
                           &tm_k, &full[s], 64 * x, row);
          hop::tma_load_2d(v_st + s * stage_elems<D>() + x * kBox +
                               lane * bs * 64,
                           &tm_v, &full[s], 64 * x, row);
        }
      }
    }
  } else {
    const int warp = threadIdx.x / 32;
    const int c2 = (lane % 4) * 2;  // the lane's column pair
    // the lane's two rows of the tile: g and g + 8 of the warp's 16
    const int lr0 = 16 * warp + lane / 4;
    // Q as wgmma's register A operand, read straight from device memory
    // (a row past R is 0), and each lane row's last live position
    uint32_t qf[D / 16][4];
    int fr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + lr0 + 8 * i;
      const int rc = min(r, R - 1);
      fr[i] = min(pos_b + rc / G, lim);
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          q + ((static_cast<size_t>(b) * S + rc / G) * H + h * G + rc % G) *
                  D);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qf[kk][i] = r < R ? src[kk * 8 + c2 / 2] : 0u;
        qf[kk][2 + i] = r < R ? src[kk * 8 + 4 + c2 / 2] : 0u;
      }
    }
    // the warp's first row's last live position: a tile that ends at or
    // before it is live for every row of the warp
    const int w_first = min(pos_b + min(row0 + 16 * warp, R - 1) / G, lim);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // per lane row: running max (raw scores) and this lane's part of l
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    // shared-memory descriptors, built once: a k16 step or a stage moves
    // a descriptor by its byte offset >> 4 (hopper.cuh)
    const uint64_t k_desc = hop::desc_sw128(k_st, 16, 1024);
    const uint64_t v_desc = hop::desc_sw128(v_st, kBox * 2, 1024);
    constexpr uint64_t kStageStep = kWgKeys * D * 2 / 16;  // one stage
    // S = Q . K^T of tile i into s: Q from registers, K K-major
    float s[kWgKeys / 2];
    auto issue_scores = [&](int i) {
      const uint64_t kd = k_desc + (i % kStages) * kStageStep;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // box kk / 4, 32 bytes a step
        hop::wgmma_rs_kmajor<kWgKeys>(
            s, qf[kk], kd + ((kk / 4) * kBox * 2 + (kk % 4) * 32) / 16,
            kk > 0);
    };
    // P of the last tile, bf16 A operands of its P . V
    uint32_t pa[kWgKeys / 16][4];
    auto issue_pv = [&](int i) {  // O += P . V, V MN-major, 16 rows a step
      const uint64_t vd = v_desc + (i % kStages) * kStageStep;
#pragma unroll
      for (int kk = 0; kk < kWgKeys / 16; ++kk)
        hop::wgmma_rs<D>(acc, pa[kk], vd + kk * 16 * 128 / 16);
    };
    // the causal mask (only on a tile that crosses the warp's first
    // row's frontier, branch-free inside it: a per-score branch costs a
    // convergence barrier each) and the exponentials of tile i in s: p
    // in s, the rescale of the running sums in alpha, the tile's row sums
    // in ls
    float alpha[2], ls[2][2];
    auto softmax = [&](int i) {
      const int k0 = tile(i) * kWgKeys;
      if (k0 + kWgKeys - 1 > w_first) {
#pragma unroll
        for (int n = 0; n < kNs; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = k0 + n * 8 + c2 + (e & 1);
            s[4 * n + e] = t > fr[e / 2] ? kNegInf : s[4 * n + e];
          }
      }
      float mx[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) mx[r][c] = kNegInf;
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e / 2][(n % 2) * 2 + (e & 1)] =
              fmaxf(mx[e / 2][(n % 2) * 2 + (e & 1)], s[4 * n + e]);
      float m_sub[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float tile_max = fmaxf(fmaxf(mx[r][0], mx[r][1]),
                                     fmaxf(mx[r][2], mx[r][3]));
        const float m_new = fmaxf(m[r], tc::quad_max(tile_max));
        // a row with nothing live yet subtracts 0 (the m_sub guard), in
        // base-2 units
        m_sub[r] = m_new > kNegInf * 0.5f ? m_new * scale2 : 0.f;
        alpha[r] = hop::ex2((m[r] - m_new) * scale2);
        m[r] = m_new;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) ls[r][0] = ls[r][1] = 0.f;
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = hop::ex2(fmaf(s[4 * n + e], scale2, -m_sub[e / 2]));
          ls[e / 2][n % 2] += p;
          s[4 * n + e] = p;
        }
    };
    // fold tile i's softmax in once the last P . V has landed: rescale l
    // and O, and round p to bf16 (the TPU kernel's cast point) straight
    // into A operands
    auto fold = [&]() {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] + ls[r][0] + ls[r][1];
#pragma unroll
        for (int n = 0; n < kNo; ++n) {
          acc[4 * n + 2 * r] *= alpha[r];
          acc[4 * n + 2 * r + 1] *= alpha[r];
        }
      }
#pragma unroll
      for (int kk = 0; kk < kWgKeys / 16; ++kk) {
        pa[kk][0] = tc::pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = tc::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = tc::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = tc::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // Turn i issues S(i) and P(i-1) . V(i-1) together and runs tile i's
    // softmax while P(i-1) . V(i-1) is on the tensor cores.  The first
    // and last turns are peeled: every wgmma of the loop is
    // unconditional, which ptxas needs to keep them asynchronous.  The
    // Q registers are pinned after each wait, so that none is reused
    // while a product may still read it.
    if (n_tiles > 0) {
      hop::mbar_wait(&full[0], 0);
      hop::wgmma_fence();
      issue_scores(0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(s);
      hop::fence_regs(qf);
      softmax(0);
      fold();
      for (int i = 1; i < n_tiles; ++i) {
        hop::mbar_wait(&full[i % kStages], (i / kStages) & 1);
        hop::wgmma_fence();
        issue_scores(i);
        hop::wgmma_commit();
        issue_pv(i - 1);
        hop::wgmma_commit();
        hop::wgmma_wait<1>();  // S(i) has landed; P(i-1) . V(i-1) runs on
        hop::fence_regs(s);
        hop::fence_regs(qf);
        softmax(i);
        hop::wgmma_wait<0>();  // P(i-1) . V(i-1) has landed
        hop::fence_regs(acc);
        hop::fence_regs(pa);
        hop::mbar_arrive(&empty[(i - 1) % kStages]);  // may be refilled
        fold();
      }
      hop::wgmma_fence();
      issue_pv(n_tiles - 1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(pa);
      hop::mbar_arrive(&empty[(n_tiles - 1) % kStages]);
    }

    float lsum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) lsum[i] = tc::quad_sum(l[i]);
    if (C == 1) {  // one split: the normalised output, straight away
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + lr0 + 8 * i;
        if (r >= R) continue;
        float* dst = out + ((static_cast<size_t>(b) * S + r / G) * H +
                            h * G + r % G) *
                               D;
#pragma unroll
        for (int n = 0; n < kNo; ++n)
          *reinterpret_cast<float2*>(dst + n * 8 + c2) =
              make_float2(safe_div(acc[4 * n + 2 * i], lsum[i]),
                          safe_div(acc[4 * n + 2 * i + 1], lsum[i]));
      }
    } else {
      // this block's (m, l, acc) into the merge scratch, once no warp
      // of the consumer reads the stages any more
      hop::bar_sync(kConsumerDone, 128);
      float* macc = reinterpret_cast<float*>(k_st);
      float* mml = macc + kWgRows * merge_ld<D>();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int lr = lr0 + 8 * i;
        if (lr >= nrows) continue;
#pragma unroll
        for (int n = 0; n < kNo; ++n)
          *reinterpret_cast<float2*>(macc + lr * merge_ld<D>() + n * 8 +
                                     c2) =
              make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
        if (c2 == 0) {
          mml[2 * lr] = m[i];
          mml[2 * lr + 1] = lsum[i];
        }
      }
    }
  }

  if (C > 1) {
    // the cluster's merge: block `rank` finishes rows rank, rank + C, ...
    // of the tile, reading every block's (m, l, acc) through distributed
    // shared memory in the order of rank (the same sums whichever block
    // adds them: bitwise repeatable)
    hop::cluster_sync();
    const float* macc = reinterpret_cast<const float*>(k_st);
    const float* mml = macc + kWgRows * merge_ld<D>();
    constexpr int kChunks = D / 4;  // float4s a row
    const int mine = (nrows - rank + C - 1) / C;
    for (int idx = threadIdx.x; idx < mine * kChunks; idx += blockDim.x) {
      const int lr = (idx / kChunks) * C + rank, ch = idx % kChunks;
      // every block's m, l and acc chunk, all loads in flight at once
      float mk[kMaxCluster], lk[kMaxCluster], mx = kNegInf;
      float4 ak[kMaxCluster];
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        if (k < C) {
          mk[k] = hop::ld_cluster(hop::map_rank(mml + 2 * lr, k));
          lk[k] = hop::ld_cluster(hop::map_rank(mml + 2 * lr + 1, k));
          ak[k] = hop::ld_cluster4(
              hop::map_rank(macc + lr * merge_ld<D>() + ch * 4, k));
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k)
        if (k < C) mx = fmaxf(mx, mk[k]);
      float L = 0.f;
      float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        if (k >= C) break;
        // a split with nothing live for the row has l = 0, acc = 0
        const float w = hop::ex2((mk[k] - mx) * scale2);
        L += w * lk[k];
        A.x += w * ak[k].x;
        A.y += w * ak[k].y;
        A.z += w * ak[k].z;
        A.w += w * ak[k].w;
      }
      const int r = row0 + lr;
      float* dst = out +
                   ((static_cast<size_t>(b) * S + r / G) * H + h * G + r % G) *
                       D +
                   ch * 4;
      *reinterpret_cast<float4*>(dst) =
          make_float4(safe_div(A.x, L), safe_div(A.y, L), safe_div(A.z, L),
                      safe_div(A.w, L));
    }
    hop::cluster_sync();  // no block leaves while another reads its scratch
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
  int splits, B, S, H, KH, bs, M, N;
  cudaStream_t stream;
};

// bf16 q and pool at D = 64 or 128 and a block size wg_block takes: the
// wgmma kernel, for every row count (the C dispatch picks it up front)
bool use_wgmma(bool q_bf16, int kv_kind, int D, int bs) {
  return q_bf16 && kv_kind == 1 && (D == 64 || D == 128) && wg_block(bs);
}

// The pools' tensor maps, encoded once per (pointer, rows, D, bs): a
// serving engine reads the same pools call after call, and encoding a
// map costs host time a short call feels.  A map holds nothing but the
// address, the shape and the box, so an entry stays right for any tensor
// later allocated at the same address with the same shape.  Shared by
// the pump threads of several engines, under a lock.
struct PageMap {
  const void* base;
  long long rows;
  int D, bs;
  CUtensorMap map;
};
constexpr int kMapCache = 256;
std::mutex g_map_lock;
PageMap g_maps[kMapCache];
int g_map_count = 0, g_map_next = 0;

cudaError_t page_map(CUtensorMap* map, const void* base, long long rows,
                     int D, int bs) {
  std::lock_guard<std::mutex> lock(g_map_lock);
  for (int i = 0; i < g_map_count; ++i) {
    const PageMap& e = g_maps[i];
    if (e.base == base && e.rows == rows && e.D == D && e.bs == bs) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  PageMap& e = g_maps[g_map_next];  // the oldest entry makes room
  const cudaError_t err = hop::map_rows(&e.map, base, rows, D, bs);
  if (err != cudaSuccess) {
    e.base = nullptr;
    return err;
  }
  e.base = base;
  e.rows = rows;
  e.D = D;
  e.bs = bs;
  *map = e.map;
  g_map_next = (g_map_next + 1) % kMapCache;
  if (g_map_count < kMapCache) ++g_map_count;
  return cudaSuccess;
}

// the wgmma kernel: one launch, the splits of a row tile one cluster
template <int D>
cudaError_t launch_wgmma(const Args& a) {
  const long long pool_rows = static_cast<long long>(a.N) * a.KH * a.bs;
  if (pool_rows + a.bs > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap mk, mv;
  cudaError_t e = page_map(&mk, a.k, pool_rows, D, a.bs);
  if (e == cudaSuccess) e = page_map(&mv, a.v, pool_rows, D, a.bs);
  if (e != cudaSuccess) return e;
  auto kernel = paged_attention_wgmma_kernel<D>;
  constexpr size_t smem = paged_smem_bytes<D>();
  if ((e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess)
    return e;
  const int rows = a.S * (a.H / a.KH);
  const int C = a.splits < kMaxCluster ? a.splits : kMaxCluster;
  const long long tiles = (rows + kWgRows - 1) / kWgRows;
  if (tiles * C > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * C), a.KH, a.B);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale2 = tc::kLog2e / sqrtf(static_cast<float>(D));
  e = cudaLaunchKernelEx(&cfg, kernel, mk, mv,
                         static_cast<const __nv_bfloat16*>(a.q), a.tables,
                         a.pos, a.out, a.S, a.H, a.KH, a.bs, a.M, a.N,
                         a.splits, scale2);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

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
  if constexpr (kBf16 && (D == 64 || D == 128)) {
    if (wg_block(a.bs)) return launch_wgmma<D>(a);
  }
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
// tiles) and the tiles the table holds.  0 for a shape the kernels do not
// take.
//   - The wgmma kernel (bf16, D = 64/128, bs 8/16/32/64): its splits are
//     one cluster and are merged inside it (no launch, no workspace),
//     but a split still costs its block's start-up and the merge (~1-1.5
//     us), against ~0.6 us of a block's time a 64-position tile.  So it
//     takes one split unless the table holds at least 16 tiles (1,024
//     positions) and the row tiles give fewer than two blocks an SM;
//     then at least 4 tiles a split, at most 8 splits (the cluster).  At
//     every main-path shape that is one split.  On an H100 80GB HBM3 at
//     700 W (chip_smoke.py --paged): TinyLlama decode (B=8, 8-way GQA,
//     34 pages of 16) took 6.5 us at 1 split and 6.2-6.9 at 2-16; GPT-2
//     decode 6.9 against 8.4-17.3; the TinyLlama verify 6.6 against
//     7.0-7.8; its chunk grid 6.7 against 7.3-13.4; the prefill groups
//     1.2-6x as long at 2-16 splits, but for a 32-token group of one row
//     (12-16 blocks), 3-15% faster at 5; a decode at ~2,000 positions of
//     a 2,048-position table 22.2 us at 1 split, 11.8-12.1 at 3-8.
//   - The CUDA-core kernel (few rows: decode) is bound by the latency of
//     its loads, so below two waves of SMs it takes one split per K/V
//     tile, at most 16 (chip_smoke.py phase 7 on an H100, decode at
//     B=8: 1 split 17.0 us, 3: 16.7, 9: 12.3).  The mma.sync kernel
//     (many rows, D = 32/96 or a block size the wgmma kernel does not
//     take) takes one split: of the paged engine's prefill shapes, only
//     a one-row 32-token group (12 blocks) ran faster split (9.2 us, 9
//     splits 6.8); the others, 48-384 blocks, ran 1.0-1.9x slower at 2-9
//     splits.
extern "C" int paged_attention_splits(int q_bf16, int kv_kind, int B, int S,
                                      int H, int KH, int D, int bs, int M,
                                      int sms) {
  if (!valid(kv_kind, B, S, H, KH, D, bs, M) || sms < 1) return 0;
  const int rows = S * (H / KH);
  const long long table_tiles =
      (static_cast<long long>(M) * bs + kWgKeys - 1) / kWgKeys;
  if (use_wgmma(q_bf16 != 0, kv_kind, D, bs)) {
    const long long base =
        static_cast<long long>(B) * KH * ((rows + kWgRows - 1) / kWgRows);
    if (base >= 2LL * sms || table_tiles < kWgSplitTableTiles) return 1;
    long long n = table_tiles / kWgSplitTiles;
    const long long fill = (2LL * sms + base - 1) / base;
    n = n < fill ? n : fill;
    return static_cast<int>(n < kMaxCluster ? n : kMaxCluster);
  }
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
// q, k and v 16-byte aligned (cp.async, TMA); tables [B, M] int32; pos [B]
// int32; out [B, S, H, D] f32.  splits >= 1 ranges of logical positions
// (paged_attention_splits).  The wgmma path (use_wgmma) merges its splits
// inside a cluster and takes no workspace; on the others, splits > 1
// needs a workspace of splits * B * S * H * (D + 2) f32 and launches the
// combine kernel after the split kernel.
extern "C" int paged_attention_fwd(const void* q, int q_bf16, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, int kv_kind,
                                   const void* tables, const void* pos,
                                   void* out, void* workspace, int splits,
                                   int B, int S, int H, int KH, int D, int bs,
                                   int M, int N, void* stream) {
  const bool wgmma = use_wgmma(q_bf16 != 0, kv_kind, D, bs);
  if (!valid(kv_kind, B, S, H, KH, D, bs, M) || N < 1 || splits < 1 ||
      splits > kSplitsLimit ||
      (splits > 1 && !wgmma && workspace == nullptr) ||
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
               N,
               static_cast<cudaStream_t>(stream)};
  if (q_bf16) return launch_kv<__nv_bfloat16>(kv_kind, D, a);
  return launch_kv<float>(kv_kind, D, a);
}
