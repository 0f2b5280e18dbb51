// Dense flash-attention backward, for Hopper (sm_90a): two kernels (dq,
// and dk/dv), each with an f32 and a bf16 form, and the delta pass that
// runs before them.
//
// Replaces the TPU kernels of analytics_zoo_tpu/ops/flash_attention.py
// launched by _bwd_call: _bwd_dq_kernel (dq) and _bwd_dkv_kernel (dk and
// dv).  Together they compute what flash_attention_bwd_ref in
// analytics_zoo_tpu_torch/ops/flash_attention.py computes in one pass:
//
//   q, dO [B, Tq, H, D], k, v [B, Tk, H, D] (the model's own layout, read
//   with strides: no [B*H, T, D] transpose, no padded copy), optional key
//   mask [B, Tk] bool, optional causal mask (key t is live for query i iff
//   t <= i), lse and delta = rowsum(dO * O) f32 [B*H, Tq] (row b*H + h;
//   lse is what the forward kernel returns, delta what the delta pass
//   below computes).  Scores s = scale * q.k in f32, masked keys and
//   keys past Tk NEG_INF = -1e30, p = exp(s - lse) (a fully
//   masked row has lse = +1e30, so its p underflows to 0: no NaN),
//   dp = dO.v, ds = p * (dp - delta).  The cast points are the TPU
//   kernels': p is rounded to dO's type before p^T.dO, ds to k's type
//   before ds.K and to q's type before ds^T.Q; every sum is f32.
//     dq = scale * sum_k ds.K        (dq kernel, one block per query tile)
//     dk = scale * sum_q ds^T.Q      (dk/dv kernel, one block per key tile)
//     dv = sum_q p^T.dO
//   No atomics: as in the TPU's split into two kernels, every gradient
//   element is written once by the block that owns it, so the gradients
//   are the same from run to run.
//
// What bounds the work on this card.  At the training shape (B=8, T=1024,
// H=12, D=64, bf16, causal) each product over the live (causal) pairs is
// about 3.2 G multiply-adds.  The dq kernel runs three (q.k, dO.v, ds.K):
// 19.3 GFLOP, 19.5 us at the bf16 tensor-core rate, against 64 MB of
// bytes (q, k, v, dO and dq once, lse and delta), 19 us at 3.35 TB/s.
// The dk/dv kernel runs four (q.k, dO.v, p^T.dO, ds^T.Q): 25.8 GFLOP,
// 26 us, against 76 MB, 23 us.  Both are bound by the products, barely,
// so in bf16 both run them on the tensor cores with the loads in flight.
//
// The dq kernel, bf16, D = 64 and 128 (flash_bwd_dq_wgmma_kernel; every
// training step): warp-specialised wgmma and TMA (hopper.cuh), on the
// forward kernel's skeleton (flash_attention.cu's flash_fwd_wgmma_kernel).
//   - Grid and roles: one block of 384 threads per (128-row query tile,
//     b*H + h), a head's tiles neighbours in the grid (the heaviest
//     causal tile, the last, first), so the blocks in flight share its K
//     and V through L2.  The producer warpgroup gives registers back
//     (setmaxnreg) and one thread loads the Q and dO tiles once, then
//     streams the key tiles (K and V) through a four-stage TMA ring with
//     full and empty mbarriers, up to the causal frontier (the TPU
//     kernel's _block_live skip).  Two consumer warpgroups own 64 query
//     rows each.
//   - Products: S = Q.K^T and dP = dO.V^T are wgmma with A and B from
//     shared memory (K-major, the forward's S pattern, once for Q and K
//     and once for dO and V).  p = exp2(s * scale * log2 e - lse * log2 e)
//     and ds = p * (dp - delta) are f32 in registers; dq += dS.K is
//     wgmma with A = ds rounded to bf16 in registers (the TPU cast point,
//     _bwd_dq_kernel's ds.astype(k.dtype)) and B = the same stage's K
//     read MN-major.  A stage is released on its empty barrier only after
//     its dq product has landed, since K is read twice.
//   - Schedule: turn j issues tile j's S and dP with tile j - 1's dq
//     product; the consumers take turns at the tensor cores (two named
//     barriers), and each computes tile j's ds while the other's products
//     run.  The first and last turns are peeled so that every wgmma of
//     the loop is unconditional.
//   - lse and delta are per row and the block owns its rows: each
//     consumer thread reads its two rows' values once, by plain loads
//     (lse scaled to base 2), so no TMA box of them has to start
//     16-byte aligned.  A row past Tq gets lse = +1e30 and delta = 0
//     (its p and ds are 0) and is never written.
//   - Masks: the key mask is read once a tile into a bit set, one byte
//     a lane and a ballot for every 32 keys (reading each lane's own
//     2 x keys / 8 bytes, as the forward does, held as many registers at
//     once, and ptxas spilled); the dead test (keys past Tk, zero-filled
//     by TMA, masked keys, causal keys past the row) runs only on tiles
//     that have a dead key for the warp, hoisted out of the score loops
//     and branch-free inside them.
//   - Registers: a consumer thread holds D / 2 dq accumulators and the S
//     and dP tiles (keys / 2 each) while it computes ds, then ds as a
//     bf16 A operand (keys / 4) until its product is issued, so D = 64
//     streams 128-key tiles (32 + 128 = 160 live) and D = 128 64-key
//     tiles (64 + 64 = 128), under the 232 that setmaxnreg gives a
//     consumer.  (Holding the last tile's dS operand through the next
//     tile's ds, to overlap its product with that work, is 192 at D = 64,
//     and ptxas spilled 180 bytes.)
//   Shared memory: the Q and dO tiles and four stages of K and V tiles:
//   160 KB (D=64), 192 KB (D=128).
//
// The dq kernel, bf16, D = 32 and 96 (flash_bwd_dq_bf16_kernel; no main
// path runs these head dims): the mma.sync forward kernel's design
// (flash_attention.cu's flash_fwd_bf16_kernel) with two more products.
// One block of 4 warps per (64-row query tile, b*H + h), heaviest causal
// tiles first, walking the key tiles up to the causal frontier; each
// warp owns 16 query rows.  S = Q.K^T, dP = dO.V^T and dq += dS.K are
// mma.sync m16n8k16 bf16 -> f32; the warp's Q and dO A fragments are
// loaded once by ldmatrix and stay in registers, K and V give their B
// fragments by ldmatrix (K again by ldmatrix.trans for dS.K); dS is
// rounded to bf16 and packed into A fragments in registers.  K and V
// tiles stay bf16 in shared memory ([keys][D + 8]), two stages filled by
// 16-byte cp.async.  A lane holds D/2 f32 dq accumulators, the Q and dO
// fragments (D/4 each) and the S and dP tiles (keys/2 each), so D = 32
// walks 64-key tiles and D = 96 32-key tiles.  Shared memory 30 KB
// (D=32), 52 KB (D=96).
//
// The delta pass (flash_bwd_delta_kernel; every training step): delta =
// rowsum(dO * O) in f32, read by both kernels.  It replaces no Pallas
// kernel: the JAX package leaves delta to XLA (_bwd_call), which fuses
// it.  It was added because the eager PyTorch expression wrote f32
// copies of dO and O and their product (five launches, ~470 MB at
// TinyLlama's 4 x 2048 training shape, more than the dq kernel's own
// bound); one pass reads the bf16 (or f32) tensors once and writes the
// f32 rows: bound by bytes (~68 MB there, 0.020 ms at 3.35 TB/s).  One
// block per (b, 32-token tile, 8 heads) stages both tiles in shared
// memory by coalesced 16-byte loads; a thread sums one (token, head) row
// in f32, product by product in order of d, each product and sum rounded
// on its own, as the plain version (flash_attention_bwd_delta) does, so
// the two agree bitwise and the f32 kernels stay exactly equal to the
// plain backward (a bf16 x bf16 product is exact in f32); each head's 32
// sums are written as one 128-byte run of its row.  No atomics.
//
// The dk/dv kernel, bf16, D = 64 and 128 (flash_bwd_dkv_wgmma_kernel;
// every training step): warp-specialised wgmma and TMA (hopper.cuh), as
// the forward kernel (flash_attention.cu).
//   - Grid and roles: one block of 384 threads per (128-key tile,
//     b*H + h), a head's tiles neighbours in the grid (the heaviest
//     causal tile, the first, first), so the blocks in flight share each
//     head's Q, dO, lse and delta through L2.
//     Two consumer warpgroups own 64 keys each; their K and V tiles are
//     loaded once by TMA and stay in shared memory.  The producer
//     warpgroup gives registers back (setmaxnreg) and one thread streams
//     the query tiles (Q and dO rows, their lse and delta) through a
//     four-stage TMA ring (q_stages) with full and empty mbarriers,
//     starting, under causal masking, at the first query tile that
//     reaches k0.
//   - Products: S^T = K.Q^T and dP^T = V.dO^T are wgmma with A = the
//     consumer's K or V rows and B = the streamed tile, both from shared
//     memory (K-major).  p^T = exp2(s^T * scale * log2 e - lse * log2 e)
//     and ds^T = p^T * (dp^T - delta) are f32 in registers, lse and delta
//     read from the stage by the accumulator's column (the query).
//     dV += p^T.dO and dK += ds^T.Q are wgmma with A = p^T and ds^T
//     rounded to bf16 in registers (the TPU cast points,
//     _bwd_dkv_kernel's p.astype(do.dtype) and ds.astype(q.dtype)) and
//     B = dO or Q from shared memory (MN-major).  Descriptors are built
//     once and moved by byte offsets.
//   - Schedule: turn j issues tile j's S^T and dP^T with tile j - 1's
//     dV and dK products; the consumers take turns at the tensor cores
//     (two named barriers), and each computes tile j's p^T and ds^T while
//     tile j - 1's products are in flight.  The first and last turns are
//     peeled so that every wgmma of the loop is unconditional.
//   - Registers: a thread keeps D / 2 dk and D / 2 dv accumulators, the
//     S^T and dP^T tiles (queries / 2 each) and the previous tile's p^T
//     and ds^T as bf16 operands (queries / 4 each), so D = 64 streams
//     64-query tiles (64 + 64 + 32) and D = 128 32-query tiles
//     (128 + 32 + 16); consumers run at 232 registers, with no spill.
//   - Masks: a masked key or one past Tk is dead for the whole loop (its
//     dk and dv rows are 0, rows past Tk are not written); the causal
//     comparison runs only on tiles that cross a warp's keys, and
//     queries past Tq (zero-filled by TMA) only on the last tile; the
//     test is hoisted out of the score loops and branch-free inside
//     them.  Each query column's lse (scaled to base 2) and delta are
//     read from the stage once for both of a lane's key rows.  lse
//     and delta are read as one run of B*H*Tq values (a row of Tq f32 is
//     not 16-byte aligned unless Tq % 4 == 0, and a 2-D map needs 16-byte
//     row strides).  TMA starts a box only at a 16-byte aligned value
//     (an unaligned start faults as an illegal instruction on the H100),
//     so a tile's box starts at the aligned value at or before its first
//     query and holds 4 more; values of the neighbouring rows it reads
//     belong to queries the kernel masks.
//   Shared memory: the K and V tiles and four stages of Q and dO tiles
//   with lse and delta: 99 KB (D=64), 130 KB (D=128).
//
// The dk/dv kernel, bf16, D = 32 and 96 (flash_bwd_dkv_bf16_kernel):
// the dq kernel's machinery on the transposed tiles, kept for these head
// dims (no main path runs them).  One block of 4 warps per (64-key tile,
// b*H + h), walking the query tiles from the first that reaches k0; each
// warp owns 16 keys and holds its K and V fragments in registers at
// D = 32 (64-query tiles) or re-reads them from shared memory at D = 96
// (32-query tiles); the Q and dO tiles, lse and delta come in two stages
// of cp.async; s^T, dp^T, p^T and ds^T are mma.sync accumulators and A
// fragments (mma_abt, mma_xb).  Shared memory 31 KB (D=32), 52 KB
// (D=96).
//
// The f32 dq and dk/dv kernels are CUDA-core f32 products
// (flash_bwd_dq_kernel<float, D>, flash_bwd_dkv_kernel<float, D>).  f32
// stays exact on purpose: the TPU kernel multiplies f32 operands as f32,
// and TF32 tensor cores would break the card's f32 training parity.  The
// TPU grid's sequential axis becomes a loop inside a block: the dq
// kernel walks the key tiles of its 64 query rows up to their causal
// frontier min(nk, q_last / 64 + 1); the dk/dv kernel walks the query
// tiles that can see its 64 keys, from tile k0 / 64 (the first tile
// whose last row qi*64 + 63 >= k0) to the end.  The operand tiles live
// in shared memory as f32, padded by one column so column reads are
// conflict-free; each of the 256 threads computes a 2 x 8 block of every
// 64 x 64 score tile (2 rows, 8 columns), and the p / ds tiles go back
// through shared memory to feed the gradient products, each row of them
// written and read by the 8 lanes of one warp.  Per-row lse and delta
// sit in registers (dq) or shared memory (dk/dv).  Shared memory per
// block: dq 49 / 81 / 113 / 145 KB (D = 32 / 64 / 96 / 128), dk/dv
// 66 / 98 / 130 / 162 KB.
//
// Every launch raises the dynamic shared-memory limit first and returns
// its error if the card refuses, and the wgmma launches return the error
// of any tensor map they cannot encode.  Plain C interface (loaded with
// ctypes): flash_attention_bwd_delta, flash_attention_bwd_dq and
// flash_attention_bwd_dkv each return cudaGetLastError() after their
// launch, or cudaErrorInvalidValue for a shape they do not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kTile = 64;              // query rows / keys per tile
constexpr int kRows = 2;               // tile rows per thread: 32 groups
constexpr int kCols = 8;               // tile columns per thread
constexpr int kLanes = kTile / kCols;  // 8 lanes share a row group
constexpr int kTld = kTile + 1;        // padded row of a p / ds tile

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// x as a product sees it after a cast to the operand type (f32: as is)
__device__ __forceinline__ float round_to(float x, float) { return x; }

// rows t0 .. t0+63 (zero past n) of one head of a [*, n, H, D] tensor
// into shared memory as f32 [64][D + 1]; base points at (b, 0, h, 0)
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int t0,
                                          int n, size_t tok) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, t = t0 + r;
    dst[r * (D + 1) + d] = t < n ? to_f32(base[t * tok + d]) : 0.f;
  }
}

// s[r][c] = a[ty*2 + r] . b[tx + 8c] over D: this thread's 2 x 8 block of
// a 64 x 64 product of two [64][D + 1] shared-memory tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx,
                                         float (&s)[kRows][kCols]) {
  constexpr int kLd = D + 1;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float ar[kRows], br[kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r) ar[r] = a[(ty * kRows + r) * kLd + d];
#pragma unroll
    for (int c = 0; c < kCols; ++c) br[c] = b[(tx + kLanes * c) * kLd + d];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = fmaf(ar[r], br[c], s[r][c]);
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, dO, k, v tiles and the ds tile
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kTld);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, dO tiles, the p^T and ds^T tiles, lse and delta
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kTld + 2 * kTile);
}

// f32 operands (bf16 takes flash_bwd_dq_bf16_kernel below).  Launch
// bounds of one block an SM, as for the dk/dv kernel below
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const uint8_t* __restrict__ kv_mask,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Tq, int Tk, int H, float scale, int causal) {
  constexpr int kLd = D + 1;
  constexpr int kDc = D / kLanes;  // dq columns per thread
  const int bh = blockIdx.x;       // b * H + h
  const int b = bh / H, h = bh % H;
  // the last query tiles carry the most causal work: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int ty = threadIdx.x / kLanes;  // rows ty*2, ty*2 + 1
  const int tx = threadIdx.x % kLanes;  // keys / columns tx + 8c

  extern __shared__ float smem[];
  float* q_s = smem;                // [64][D + 1]
  float* do_s = q_s + kTile * kLd;  // [64][D + 1]
  float* k_s = do_s + kTile * kLd;  // [64][D + 1]
  float* v_s = k_s + kTile * kLd;   // [64][D + 1]
  float* ds_s = v_s + kTile * kLd;  // [64][65]

  const size_t tok = static_cast<size_t>(H) * D;  // stride of one token
  const size_t q_off = static_cast<size_t>(b) * Tq * tok + h * D;
  const size_t k_off = static_cast<size_t>(b) * Tk * tok + h * D;
  const uint8_t* mb =
      kv_mask ? kv_mask + static_cast<size_t>(b) * Tk : nullptr;

  load_tile<T, D>(q_s, q + q_off, q0, Tq, tok);
  load_tile<T, D>(do_s, dout + q_off, q0, Tq, tok);
  float lse_r[kRows], delta_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + ty * kRows + r;
    const size_t i = static_cast<size_t>(bh) * Tq + t;
    lse_r[r] = t < Tq ? lse[i] : -kNegInf;
    delta_r[r] = t < Tq ? delta[i] : 0.f;
  }

  const int q_last = min(q0 + kTile, Tq) - 1;
  int nk = (Tk + kTile - 1) / kTile;
  if (causal) nk = min(nk, q_last / kTile + 1);

  float acc[kRows][kDc];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc[r][c] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // every warp is done with the previous k/v/ds tiles
    load_tile<T, D>(k_s, k + k_off, k0, Tk, tok);
    load_tile<T, D>(v_s, v + k_off, k0, Tk, tok);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    tile_dot<D>(q_s, k_s, ty, tx, s);
    tile_dot<D>(do_s, v_s, ty, tx, dp);
    bool live[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int t = k0 + tx + kLanes * c;
      live[c] = t < Tk && (mb == nullptr || mb[t] != 0);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = ty * kRows + r;
      const int qi = q0 + row;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kk = tx + kLanes * c;
        float sv = scale * s[r][c];
        if (!live[c] || (causal && k0 + kk > qi)) sv = kNegInf;
        const float p = expf(sv - lse_r[r]);
        ds_s[row * kTld + kk] = round_to(p * (dp[r][c] - delta_r[r]), T());
      }
    }
    // a row of ds is written and read by the 8 lanes of its own warp
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        dr[r] = ds_s[(ty * kRows + r) * kTld + kk];
#pragma unroll
      for (int c = 0; c < kDc; ++c) {
        const float kv = k_s[kk * kLd + tx + kLanes * c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(dr[r], kv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = q0 + ty * kRows + r;
    if (t >= Tq) continue;
    T* row = dq + (static_cast<size_t>(b) * Tq + t) * tok + h * D;
#pragma unroll
    for (int c = 0; c < kDc; ++c)
      row[tx + kLanes * c] = from_f32<T>(scale * acc[r][c]);
  }
}

constexpr int kTcThreads = 128;  // 4 warps of 16 query rows

// keys per tile of the bf16 dq kernel (see the header: registers)
template <int D>
__host__ __device__ constexpr int dq_keys() {
  return D <= 64 ? 64 : 32;
}

template <int D>
constexpr size_t dq_bf16_smem_bytes() {
  // q and dO tiles [64][D + 8], two stages of k and v tiles, all bf16
  return sizeof(__nv_bfloat16) * (2 * kTile + 4 * dq_keys<D>()) *
         (D + tc::kPad);
}

// bf16 operands on the tensor cores (see the header)
template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const uint8_t* __restrict__ kv_mask,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int Tq, int Tk,
                             int H, float scale, int causal) {
  constexpr int kBk = dq_keys<D>();
  constexpr int kLd = D + tc::kPad;
  constexpr int kNs = kBk / 8;  // n8 blocks of a warp's score tile
  constexpr int kNo = D / 8;    // n8 blocks of a warp's dq rows
  const int bh = blockIdx.x;    // b * H + h
  const int b = bh / H, h = bh % H;
  // the last query tiles carry the most causal work: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's rows r0 .. r0+15
  const int c2 = (lane % 4) * 2;           // the lane's column pair
  // the lane's two rows, g and g + 8 of the warp's 16
  const int rows[2] = {q0 + r0 + lane / 4, q0 + r0 + lane / 4 + 8};

  extern __shared__ __align__(16) __nv_bfloat16 tiles[];
  __nv_bfloat16* q_s = tiles;                // [64][kLd]
  __nv_bfloat16* do_s = q_s + kTile * kLd;   // [64][kLd]
  __nv_bfloat16* k_s = do_s + kTile * kLd;   // [2][kBk][kLd]
  __nv_bfloat16* v_s = k_s + 2 * kBk * kLd;  // [2][kBk][kLd]

  const size_t tok = static_cast<size_t>(H) * D;  // stride of one token
  const size_t q_off = static_cast<size_t>(b) * Tq * tok + h * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * Tk * tok + h * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * Tk * tok + h * D;
  const uint8_t* mb =
      kv_mask ? kv_mask + static_cast<size_t>(b) * Tk : nullptr;

  const int q_last = min(q0 + kTile, Tq) - 1;
  int nk = (Tk + kBk - 1) / kBk;
  if (causal) nk = min(nk, q_last / kBk + 1);

  // stage 0: the q and dO tiles and the first k/v tile, one group
  tc::load_tile_async<kTile, D, kTcThreads>(q_s, q + q_off, q0, Tq, tok);
  tc::load_tile_async<kTile, D, kTcThreads>(do_s, dout + q_off, q0, Tq, tok);
  tc::load_tile_async<kBk, D, kTcThreads>(k_s, kb, 0, Tk, tok);
  tc::load_tile_async<kBk, D, kTcThreads>(v_s, vb, 0, Tk, tok);
  tc::cp_async_commit();

  // lse (base-2 units, as the scores) and delta of the lane's
  // rows; a row past Tq gets lse = +1e30 and delta = 0, so p and ds are 0
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t idx = static_cast<size_t>(bh) * Tq + rows[i];
    lse2[i] = rows[i] < Tq ? lse[idx] * tc::kLog2e : -kNegInf;
    dlt[i] = rows[i] < Tq ? delta[idx] : 0.f;
  }
  const float scale2 = scale * tc::kLog2e;

  uint32_t qf[D / 16][4], dof[D / 16][4];  // resident A fragments
  float acc[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBk;
    const int st = j & 1;
    if (j + 1 < nk) {  // tile j + 1 into the other stage, in flight
      tc::load_tile_async<kBk, D, kTcThreads>(k_s + (st ^ 1) * kBk * kLd,
                                              kb, k0 + kBk, Tk, tok);
      tc::load_tile_async<kBk, D, kTcThreads>(v_s + (st ^ 1) * kBk * kLd,
                                              vb, k0 + kBk, Tk, tok);
    }
    tc::cp_async_commit();   // (empty on the last tile)
    tc::cp_async_wait<1>();  // tile j (and, first, q and dO) landed
    __syncthreads();
    if (j == 0) {
      tc::load_a_frags<D>(qf, q_s, r0, lane);
      tc::load_a_frags<D>(dof, do_s, r0, lane);
    }
    const __nv_bfloat16* ks = k_s + st * kBk * kLd;

    float s[kNs][4], dp[kNs][4];
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    tc::mma_abt<D, kNs>(s, qf, ks, lane);
    tc::mma_abt<D, kNs>(dp, dof, v_s + st * kBk * kLd, lane);

    // keys past Tk, masked keys, or (causal) keys past the warp's first
    // row: only then is any key of this tile dead for this warp
    const bool edge = k0 + kBk > Tk || mb != nullptr ||
                      (causal && k0 + kBk - 1 > q0 + r0);
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale2;
        if (edge) {
          const int t = k0 + n * 8 + c2 + (e & 1);
          if (t >= Tk || (mb != nullptr && mb[t] == 0) ||
              (causal && t > rows[e / 2]))
            x = kNegInf;
        }
        const float p = exp2f(x - lse2[e / 2]);
        s[n][e] = p * (dp[n][e] - dlt[e / 2]);  // ds, f32
      }
    // ds rounded to bf16 straight into A fragments: acc += ds . K
    tc::mma_xb<D, kBk>(acc, s, ks, lane);
    __syncthreads();  // every warp is done with stage st before its reload
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = rows[i];
    if (t >= Tq) continue;
    __nv_bfloat16* row = dq + (static_cast<size_t>(b) * Tq + t) * tok + h * D;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + c2) =
          __floats2bfloat162_rn(scale * acc[n][2 * i],
                                scale * acc[n][2 * i + 1]);
  }
}

// f32 operands (bf16 takes flash_bwd_dkv_bf16_kernel below).  Launch
// bounds of one block an SM: with none given, ptxas held D=32 to 64
// registers (four blocks an SM) and spilled 4 bytes to get there
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ kv_mask,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int Tq,
                         int Tk, int H, float scale, int causal) {
  constexpr int kLd = D + 1;
  constexpr int kDc = D / kLanes;  // dk/dv columns per thread
  const int bh = blockIdx.x;       // b * H + h
  const int b = bh / H, h = bh % H;
  // the first key tiles carry the most causal work and start first
  const int k0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / kLanes;  // keys k0 + ty*2, k0 + ty*2 + 1
  const int tx = threadIdx.x % kLanes;  // query rows / columns tx + 8c

  extern __shared__ float smem[];
  float* k_s = smem;                   // [64][D + 1]
  float* v_s = k_s + kTile * kLd;      // [64][D + 1]
  float* q_s = v_s + kTile * kLd;      // [64][D + 1]
  float* do_s = q_s + kTile * kLd;     // [64][D + 1]
  float* pt_s = do_s + kTile * kLd;    // [64 keys][65]: p rounded
  float* dst_s = pt_s + kTile * kTld;  // [64 keys][65]: ds rounded
  float* lse_s = dst_s + kTile * kTld;  // [64]
  float* delta_s = lse_s + kTile;       // [64]

  const size_t tok = static_cast<size_t>(H) * D;  // stride of one token
  const size_t q_off = static_cast<size_t>(b) * Tq * tok + h * D;
  const size_t k_off = static_cast<size_t>(b) * Tk * tok + h * D;

  load_tile<T, D>(k_s, k + k_off, k0, Tk, tok);
  load_tile<T, D>(v_s, v + k_off, k0, Tk, tok);
  bool live[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = k0 + ty * kRows + r;
    live[r] = t < Tk &&
              (kv_mask == nullptr ||
               kv_mask[static_cast<size_t>(b) * Tk + t] != 0);
  }

  const int nq = (Tq + kTile - 1) / kTile;
  // causal: the first query tile whose last row (qi*64 + 63) reaches k0
  const int i0 = causal ? k0 / kTile : 0;

  float dk_acc[kRows][kDc], dv_acc[kRows][kDc];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kDc; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  for (int i = i0; i < nq; ++i) {
    const int q0 = i * kTile;
    __syncthreads();  // every warp is done with the previous q/dO tiles
    load_tile<T, D>(q_s, q + q_off, q0, Tq, tok);
    load_tile<T, D>(do_s, dout + q_off, q0, Tq, tok);
    for (int idx = threadIdx.x; idx < kTile; idx += kThreads) {
      const int t = q0 + idx;
      const size_t j = static_cast<size_t>(bh) * Tq + t;
      // a query row past Tq: p underflows to 0 and dO, delta are 0
      lse_s[idx] = t < Tq ? lse[j] : -kNegInf;
      delta_s[idx] = t < Tq ? delta[j] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    tile_dot<D>(k_s, q_s, ty, tx, s);    // s^T: keys x query rows
    tile_dot<D>(v_s, do_s, ty, tx, dp);  // dp^T
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int key = ty * kRows + r;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int row = tx + kLanes * c;
        float sv = scale * s[r][c];
        if (!live[r] || (causal && k0 + key > q0 + row)) sv = kNegInf;
        const float p = expf(sv - lse_s[row]);
        pt_s[key * kTld + row] = round_to(p, T());
        dst_s[key * kTld + row] =
            round_to(p * (dp[r][c] - delta_s[row]), T());
      }
    }
    // a key's p / ds row is written and read by the 8 lanes of its warp
    __syncwarp();

#pragma unroll 4
    for (int row = 0; row < kTile; ++row) {
      float pr[kRows], dr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        pr[r] = pt_s[(ty * kRows + r) * kTld + row];
        dr[r] = dst_s[(ty * kRows + r) * kTld + row];
      }
#pragma unroll
      for (int c = 0; c < kDc; ++c) {
        const int col = tx + kLanes * c;
        const float g = do_s[row * kLd + col];
        const float qv = q_s[row * kLd + col];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          dv_acc[r][c] = fmaf(pr[r], g, dv_acc[r][c]);
          dk_acc[r][c] = fmaf(dr[r], qv, dk_acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = k0 + ty * kRows + r;
    if (t >= Tk) continue;  // a key past Tk in the last tile: no row
    const size_t off = (static_cast<size_t>(b) * Tk + t) * tok + h * D;
#pragma unroll
    for (int c = 0; c < kDc; ++c) {
      dk[off + tx + kLanes * c] = from_f32<T>(scale * dk_acc[r][c]);
      dv[off + tx + kLanes * c] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

// query rows per tile of the bf16 dk/dv kernel, and whether the warp's
// K and V fragments stay in registers (see the header: registers)
template <int D>
__host__ __device__ constexpr bool dkv_resident() {
  return D <= 64;
}

template <int D>
__host__ __device__ constexpr int dkv_queries() {
  return dkv_resident<D>() ? 64 : 32;
}

template <int D>
constexpr size_t dkv_bf16_smem_bytes() {
  // k and v tiles [64][D + 8] and two stages of q and dO tiles
  // [queries][D + 8], bf16; two stages of lse and delta, f32
  return sizeof(__nv_bfloat16) * (2 * kTile + 4 * dkv_queries<D>()) *
             (D + tc::kPad) +
         sizeof(float) * 4 * dkv_queries<D>();
}

// bf16 operands on mma.sync, D = 32 and 96 (see the header)
template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const uint8_t* __restrict__ kv_mask,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int Tq,
                              int Tk, int H, float scale, int causal) {
  constexpr int kBq = dkv_queries<D>();
  constexpr int kLd = D + tc::kPad;
  constexpr int kNs = kBq / 8;  // n8 blocks (queries) of a warp's s^T tile
  constexpr int kNo = D / 8;    // n8 blocks of a warp's dk / dv rows
  // D <= 64 keeps the warp's K and V A fragments in registers; D > 64
  // has no room for them and reads them from shared memory at every tile
  constexpr bool kResident = dkv_resident<D>();
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  // the first key tiles carry the most causal work and start first
  const int k0 = blockIdx.y * kTile;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's keys k0 + r0 ..
  const int c2 = (lane % 4) * 2;           // the lane's column pair
  // the lane's two keys, rows g and g + 8 of the warp's 16
  const int keys[2] = {k0 + r0 + lane / 4, k0 + r0 + lane / 4 + 8};

  extern __shared__ __align__(16) __nv_bfloat16 tiles[];
  __nv_bfloat16* k_s = tiles;                 // [64][kLd]
  __nv_bfloat16* v_s = k_s + kTile * kLd;     // [64][kLd]
  __nv_bfloat16* q_s = v_s + kTile * kLd;     // [2][kBq][kLd]
  __nv_bfloat16* do_s = q_s + 2 * kBq * kLd;  // [2][kBq][kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kBq * kLd);  // [2][kBq]
  float* dlt_s = lse_s + 2 * kBq;                                 // [2][kBq]

  const size_t tok = static_cast<size_t>(H) * D;  // stride of one token
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * Tq * tok + h * D;
  const __nv_bfloat16* dob =
      dout + static_cast<size_t>(b) * Tq * tok + h * D;
  const size_t k_off = static_cast<size_t>(b) * Tk * tok + h * D;
  const float* lse_b = lse + static_cast<size_t>(bh) * Tq;
  const float* dlt_b = delta + static_cast<size_t>(bh) * Tq;

  const int nq = (Tq + kBq - 1) / kBq;
  // causal: the first query tile whose last row reaches k0
  const int i0 = causal ? k0 / kBq : 0;

  // query tile i into stage st: q and dO rows, lse and delta (rows past
  // Tq zero-filled; they are masked below)
  auto load_queries = [&](int st, int i) {
    const int q0 = i * kBq;
    tc::load_tile_async<kBq, D, kTcThreads>(q_s + st * kBq * kLd, qb, q0, Tq,
                                            tok);
    tc::load_tile_async<kBq, D, kTcThreads>(do_s + st * kBq * kLd, dob, q0,
                                            Tq, tok);
    if (threadIdx.x < kBq) {
      const int t = q0 + threadIdx.x;
      const bool in = t < Tq;
      tc::cp_async4(lse_s + st * kBq + threadIdx.x, in ? lse_b + t : lse_b,
                    in ? 4 : 0);
      tc::cp_async4(dlt_s + st * kBq + threadIdx.x, in ? dlt_b + t : dlt_b,
                    in ? 4 : 0);
    }
  };

  // stage 0: the k and v tiles and the first query tile, one group
  tc::load_tile_async<kTile, D, kTcThreads>(k_s, k + k_off, k0, Tk, tok);
  tc::load_tile_async<kTile, D, kTcThreads>(v_s, v + k_off, k0, Tk, tok);
  if (i0 < nq) load_queries(0, i0);
  tc::cp_async_commit();

  // keys past Tk and masked keys: dead for the whole loop, so p, ds and
  // both gradients of that key row are 0
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    live[i] = keys[i] < Tk &&
              (kv_mask == nullptr ||
               kv_mask[static_cast<size_t>(b) * Tk + keys[i]] != 0);
  const float scale2 = scale * tc::kLog2e;  // scores in base-2 units

  uint32_t kf[kResident ? D / 16 : 1][4], vf[kResident ? D / 16 : 1][4];
  float dk_acc[kNo][4], dv_acc[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int i = i0; i < nq; ++i) {
    const int q0 = i * kBq;
    const int st = (i - i0) & 1;
    if (i + 1 < nq) load_queries(st ^ 1, i + 1);  // in flight
    tc::cp_async_commit();   // (empty on the last tile)
    tc::cp_async_wait<1>();  // tile i (and, first, k and v) landed
    __syncthreads();
    const __nv_bfloat16* qs = q_s + st * kBq * kLd;
    const __nv_bfloat16* dos = do_s + st * kBq * kLd;
    const float* lses = lse_s + st * kBq;
    const float* dlts = dlt_s + st * kBq;

    // s^T = K . Q^T and dp^T = V . dO^T: the warp's 16 keys x kBq queries
    float s[kNs][4], dp[kNs][4];
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    if constexpr (kResident) {
      if (i == i0) {
        tc::load_a_frags<D>(kf, k_s, r0, lane);
        tc::load_a_frags<D>(vf, v_s, r0, lane);
      }
      tc::mma_abt<D, kNs>(s, kf, qs, lane);
      tc::mma_abt<D, kNs>(dp, vf, dos, lane);
    } else {
      tc::mma_abt_smem<D, kNs>(s, k_s, r0, qs, lane);
      tc::mma_abt_smem<D, kNs>(dp, v_s, r0, dos, lane);
    }

    // queries past Tq, or (causal) a query tile that starts before the
    // warp's last key: only then is any query of the tile dead here
    const bool edge = q0 + kBq > Tq || (causal && q0 < k0 + r0 + 15);
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + c2 + (e & 1);  // query q0 + col
        float x = live[e / 2] ? s[n][e] * scale2 : kNegInf;
        if (edge) {
          const int t = q0 + col;
          if (t >= Tq || (causal && keys[e / 2] > t)) x = kNegInf;
        }
        const float p = exp2f(fmaf(lses[col], -tc::kLog2e, x));
        s[n][e] = p;                               // p^T, f32
        dp[n][e] = p * (dp[n][e] - dlts[col]);     // ds^T, f32
      }
    // p^T and ds^T rounded to bf16 straight into A fragments (the TPU
    // cast points): dv += p^T . dO, dk += ds^T . Q
    tc::mma_xb<D, kBq>(dv_acc, s, dos, lane);
    tc::mma_xb<D, kBq>(dk_acc, dp, qs, lane);
    __syncthreads();  // every warp is done with stage st before its reload
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = keys[i];
    if (t >= Tk) continue;  // a key past Tk in the last tile: no row
    const size_t off = (static_cast<size_t>(b) * Tk + t) * tok + h * D;
#pragma unroll
    for (int n = 0; n < kNo; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8 + c2) =
          __floats2bfloat162_rn(scale * dk_acc[n][2 * i],
                                scale * dk_acc[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8 + c2) =
          __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// ---- bf16 dk/dv, D = 64 and 128: warp-specialised wgmma + TMA ----------

constexpr int kWgKeys = 128;     // keys a block: two consumers of 64
// stages of the query-tile ring: tile j - 1's Q and dO are still read
// while tile j's are, and a load must stay in flight behind them
template <int D>
__host__ __device__ constexpr int q_stages() {
  return 4;
}
constexpr int kWgThreads = 384;  // the producer warpgroup and two consumers
constexpr int kConsumers = 256;  // consumer threads
// registers a thread: 40 x 128 + 232 x 256 <= 65536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// named barriers kTurn + c: consumer c's turn at the tensor cores
// (barrier 0 is __syncthreads)
constexpr int kTurn = 1;

// query rows a streamed tile (see the header: registers)
template <int D>
__host__ __device__ constexpr int wg_queries() {
  return D <= 64 ? 64 : 32;
}

// lse and delta of a query tile are read from the 16-byte aligned value
// at or before the tile's first (TMA reads a box only from a 16-byte
// aligned start): kBq + 4 values, in a stage padded to 128 bytes
template <int D>
__host__ __device__ constexpr int wg_row_box() {
  return wg_queries<D>() + 4;
}

template <int D>
struct DkvSmem {
  // 1024-byte aligned tiles of D / 64 boxes [rows][64] (128-byte swizzle)
  __nv_bfloat16 k[kWgKeys * D];
  __nv_bfloat16 v[kWgKeys * D];
  __nv_bfloat16 q[q_stages<D>()][wg_queries<D>() * D];
  __nv_bfloat16 dout[q_stages<D>()][wg_queries<D>() * D];
  alignas(128) float lse[q_stages<D>()][wg_queries<D>() + 32];
  alignas(128) float dlt[q_stages<D>()][wg_queries<D>() + 32];
  uint64_t kv_full, full[q_stages<D>()], empty[q_stages<D>()];
};

template <int D>
constexpr size_t dkv_wg_smem_bytes() {
  return sizeof(DkvSmem<D>) + 1024;  // + the slack align1024 may skip
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (hop::smem_u32(p) & 1023)) & 1023);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __grid_constant__ CUtensorMap tm_lse,
                               const __grid_constant__ CUtensorMap tm_dlt,
                               const uint8_t* __restrict__ kv_mask,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int Tq,
                               int Tk, int H, float scale, int causal) {
  constexpr int kBq = wg_queries<D>();
  constexpr int kRowBox = wg_row_box<D>();
  constexpr int kStages = q_stages<D>();
  constexpr int kKBox = kWgKeys * 64;  // elements of a [128][64] K/V box
  constexpr int kQBox = kBq * 64;      // elements of a [kBq][64] Q/dO box
  constexpr int kNs = kBq / 8;         // n8 blocks (queries) of a row
  constexpr int kNo = D / 8;           // n8 blocks of a dk / dv row
  extern __shared__ uint8_t smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(align1024(smem_raw));
  // a head's key tiles are neighbours in the grid, so the blocks in
  // flight share their query tiles through L2; within a head the first
  // key tiles carry the most causal work and start first
  const int n_tiles = (Tk + kWgKeys - 1) / kWgKeys;
  const int bh = blockIdx.x / n_tiles;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int k0 = (blockIdx.x % n_tiles) * kWgKeys;
  const int nq = (Tq + kBq - 1) / kBq;
  // causal: the first query tile whose last row reaches k0
  const int i0 = causal ? k0 / kBq : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&sm.full[s], 1);
      hop::mbar_init(&sm.empty[s], kConsumers);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: one thread issues every load
    hop::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hop::prefetch_map(&tm_q);
      hop::prefetch_map(&tm_k);
      hop::prefetch_map(&tm_v);
      hop::prefetch_map(&tm_do);
      hop::prefetch_map(&tm_lse);
      hop::prefetch_map(&tm_dlt);
      hop::mbar_arrive_expect_tx(&sm.kv_full, 2 * kWgKeys * D * 2);
      for (int x = 0; x < D / 64; ++x) {
        hop::tma_load_3d(sm.k + x * kKBox, &tm_k, &sm.kv_full,
                         h * D + 64 * x, k0, b);
        hop::tma_load_3d(sm.v + x * kKBox, &tm_v, &sm.kv_full,
                         h * D + 64 * x, k0, b);
      }
      for (int i = i0; i < nq; ++i) {
        const int j = i - i0, s = j % kStages;
        // the first pass over the ring finds every stage free
        hop::mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        hop::mbar_arrive_expect_tx(&sm.full[s],
                                   2 * kBq * D * 2 + 2 * kRowBox * 4);
        for (int x = 0; x < D / 64; ++x) {
          hop::tma_load_3d(sm.q[s] + x * kQBox, &tm_q, &sm.full[s],
                           h * D + 64 * x, i * kBq, b);
          hop::tma_load_3d(sm.dout[s] + x * kQBox, &tm_do, &sm.full[s],
                           h * D + 64 * x, i * kBq, b);
        }
        const int first = (bh * Tq + i * kBq) & ~3;  // 16-byte aligned
        hop::tma_load_1d(sm.lse[s], &tm_lse, &sm.full[s], first);
        hop::tma_load_1d(sm.dlt[s], &tm_dlt, &sm.full[s], first);
      }
    }
    return;
  }

  hop::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;  // this consumer's keys: k0 + 64 cw ..
  const int tid = threadIdx.x - 128 * wg;
  const int lane = tid % 32;
  const int r0 = 64 * cw + 16 * (tid / 32);  // the warp's first key row
  const int c2 = (lane % 4) * 2;             // the lane's column pair
  // the lane's two keys, rows g and g + 8 of the warp's 16
  const int keys[2] = {k0 + r0 + lane / 4, k0 + r0 + lane / 4 + 8};
  // keys past Tk and masked keys: dead for the whole loop, so p, ds and
  // both gradients of that key row are 0
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    live[i] = keys[i] < Tk &&
              (kv_mask == nullptr ||
               kv_mask[static_cast<size_t>(b) * Tk + keys[i]] != 0);
  const float scale2 = scale * tc::kLog2e;  // scores in base-2 units
  // this consumer's 64 rows of the K and V tiles, in every box
  const __nv_bfloat16* ks = sm.k + 64 * cw * 64;
  const __nv_bfloat16* vs = sm.v + 64 * cw * 64;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // s^T = K . Q^T and dp^T = V . dO^T of query tile j: this consumer's
  // 64 keys x kBq queries (K-major A and B)
  // shared-memory descriptors, built once: a k16 step or a stage moves
  // a descriptor by its byte offset >> 4 (hopper.cuh)
  const uint64_t k_desc = hop::desc_sw128(ks, 16, 1024);
  const uint64_t v_desc = hop::desc_sw128(vs, 16, 1024);
  const uint64_t q_desc = hop::desc_sw128(sm.q[0], 16, 1024);
  const uint64_t do_desc = hop::desc_sw128(sm.dout[0], 16, 1024);
  const uint64_t q_mn_desc = hop::desc_sw128(sm.q[0], kQBox * 2, 1024);
  const uint64_t do_mn_desc = hop::desc_sw128(sm.dout[0], kQBox * 2, 1024);
  constexpr uint64_t kStageStep = kBq * D * 2 / 16;  // one Q or dO stage
  float s[kBq / 2], dp[kBq / 2];
  auto issue_scores = [&](int j) {
    const uint64_t step = (j % kStages) * kStageStep;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // box kk / 4, k16 step kk % 4
      hop::wgmma_ss<kBq>(
          s, k_desc + ((kk / 4) * kKBox * 2 + (kk % 4) * 32) / 16,
          q_desc + step + ((kk / 4) * kQBox * 2 + (kk % 4) * 32) / 16,
          kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hop::wgmma_ss<kBq>(
          dp, v_desc + ((kk / 4) * kKBox * 2 + (kk % 4) * 32) / 16,
          do_desc + step + ((kk / 4) * kQBox * 2 + (kk % 4) * 32) / 16,
          kk > 0);
  };
  // p^T and ds^T of the last tile, bf16 A operands of its gradient
  // products, which run while the next tile's scores are computed
  uint32_t pa[kBq / 16][4], da[kBq / 16][4];
  // dV += p^T . dO and dK += ds^T . Q of tile j, the queries the k
  // dimension (MN-major, 16 rows a step)
  auto issue_grads = [&](int j) {
    const uint64_t step = (j % kStages) * kStageStep;
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk)  // 16 rows of 128 bytes a step
      hop::wgmma_rs<D>(dv_acc, pa[kk], do_mn_desc + step + kk * 128);
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk)
      hop::wgmma_rs<D>(dk_acc, da[kk], q_mn_desc + step + kk * 128);
  };
  // p^T and ds^T of query tile j, f32, in s and dp
  auto elementwise = [&](int j) {
    const int q0 = (i0 + j) * kBq;
    // queries past Tq, or (causal) a query tile that starts before the
    // warp's last key: only then is any query of the tile dead here
    const bool edge = q0 + kBq > Tq || (causal && q0 < k0 + r0 + 15);
    // the tile's first query is value (its row offset % 4) of the box
    const int skip = (bh * Tq + q0) & 3;
    const float* lses = sm.lse[j % kStages] + skip;
    const float* dlts = sm.dlt[j % kStages] + skip;
    // lse (base-2 units) and delta of the lane's 2 x kNs query columns,
    // read once for both its key rows
    float lse2[kNs][2], dlt[kNs][2];
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        lse2[n][c] = lses[n * 8 + c2 + c] * tc::kLog2e;
        dlt[n][c] = dlts[n * 8 + c2 + c];
      }
    // x = s * scale * log2 e - lse * log2 e, NEG_INF where the pair is
    // dead; the dead test is hoisted out of the element loop and
    // branch-free inside it (a per-element branch costs each score a
    // convergence barrier)
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * n + e] = fmaf(s[4 * n + e], scale2, -lse2[n][e & 1]);
    if (edge || !live[0] || !live[1]) {
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = q0 + n * 8 + c2 + (e & 1);
          const bool dead = !live[e / 2] || t >= Tq ||
                            (causal && keys[e / 2] > t);
          s[4 * n + e] = dead ? kNegInf : s[4 * n + e];
        }
    }
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = hop::ex2(s[4 * n + e]);
        s[4 * n + e] = p;                                        // p^T
        dp[4 * n + e] = p * (dp[4 * n + e] - dlt[n][e & 1]);     // ds^T
      }
  };
  // p^T and ds^T rounded to bf16 straight into A operands (the TPU cast
  // points): n8 blocks 2kk and 2kk + 1 are the k16 step kk
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[kk][e] = tc::pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        da[kk][e] =
            tc::pack_bf16(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
      }
  };

  // Turn j issues tile j's S^T and dP^T with tile j - 1's gradient
  // products; the consumers take turns (named barriers), so one
  // consumer's products run on the tensor cores while the other does its
  // exponentials.  The first and last turns are peeled: every wgmma of
  // the loop is unconditional, which ptxas needs to keep them
  // asynchronous.  Consumer 0 takes the first turn.
  const int n_q = nq - i0;  // query tiles this block walks
  hop::mbar_wait(&sm.kv_full, 0);
  if (n_q > 0) {
    if (cw == 1) hop::bar_arrive(kTurn, kConsumers);
    hop::mbar_wait(&sm.full[0], 0);
    hop::bar_sync(kTurn + cw, kConsumers);
    hop::wgmma_fence();
    issue_scores(0);
    hop::wgmma_commit();
    hop::bar_arrive(kTurn + (cw ^ 1), kConsumers);
    hop::wgmma_wait<0>();
    hop::fence_regs(s);
    hop::fence_regs(dp);
    elementwise(0);
    pack();
    for (int j = 1; j < n_q; ++j) {
      hop::mbar_wait(&sm.full[j % kStages], (j / kStages) & 1);
      hop::bar_sync(kTurn + cw, kConsumers);
      hop::wgmma_fence();
      issue_scores(j);
      hop::wgmma_commit();
      issue_grads(j - 1);
      hop::wgmma_commit();
      hop::bar_arrive(kTurn + (cw ^ 1), kConsumers);
      hop::wgmma_wait<1>();  // S^T(j), dP^T(j) have landed
      hop::fence_regs(s);
      hop::fence_regs(dp);
      elementwise(j);
      hop::wgmma_wait<0>();  // tile j - 1's gradient products have landed
      hop::fence_regs(dv_acc);
      hop::fence_regs(dk_acc);
      hop::fence_regs(pa);
      hop::fence_regs(da);
      hop::mbar_arrive(&sm.empty[(j - 1) % kStages]);  // may be refilled
      pack();
    }
    // the last gradient products (consumer 1's last turn has no
    // successor)
    hop::bar_sync(kTurn + cw, kConsumers);
    hop::wgmma_fence();
    issue_grads(n_q - 1);
    hop::wgmma_commit();
    if (cw == 0) hop::bar_arrive(kTurn + 1, kConsumers);
    hop::wgmma_wait<0>();
    hop::fence_regs(dv_acc);
    hop::fence_regs(dk_acc);
    hop::fence_regs(pa);
    hop::fence_regs(da);
    hop::mbar_arrive(&sm.empty[(n_q - 1) % kStages]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = keys[i];
    if (t >= Tk) continue;  // a key past Tk in the last tile: no row
    const size_t off = (static_cast<size_t>(b) * Tk + t) * H * D + h * D;
#pragma unroll
    for (int n = 0; n < kNo; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8 + c2) =
          __floats2bfloat162_rn(scale * dk_acc[4 * n + 2 * i],
                                scale * dk_acc[4 * n + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8 + c2) =
          __floats2bfloat162_rn(dv_acc[4 * n + 2 * i],
                                dv_acc[4 * n + 2 * i + 1]);
    }
  }
}

// ---- bf16 dq, D = 64 and 128: warp-specialised wgmma + TMA -------------

constexpr int kWgRows = 128;  // query rows a dq block: two consumers of 64
// keys a streamed K/V tile (see the header: registers)
template <int D>
__host__ __device__ constexpr int dq_wg_keys() {
  return D <= 64 ? 128 : 64;
}
// stages of the K/V ring: tile j - 1's K is still read (dS . K) while
// tile j's K and V are, and a load must stay in flight behind them
constexpr int kDqStages = 4;

template <int D>
struct DqSmem {
  // 1024-byte aligned tiles of D / 64 boxes [rows][64] (128-byte swizzle)
  __nv_bfloat16 q[kWgRows * D];
  __nv_bfloat16 dout[kWgRows * D];
  __nv_bfloat16 k[kDqStages][dq_wg_keys<D>() * D];
  __nv_bfloat16 v[kDqStages][dq_wg_keys<D>() * D];
  uint64_t q_full, full[kDqStages], empty[kDqStages];
};

template <int D>
constexpr size_t dq_wg_smem_bytes() {
  return sizeof(DqSmem<D>) + 1024;  // + the slack align1024 may skip
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const uint8_t* __restrict__ kv_mask,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int Tq, int Tk,
                              int H, float scale, int causal) {
  constexpr int kBk = dq_wg_keys<D>();
  constexpr int kStages = kDqStages;
  constexpr int kQBox = kWgRows * 64;  // elements of a [128][64] Q/dO box
  constexpr int kKBox = kBk * 64;      // elements of a [kBk][64] K/V box
  constexpr int kNs = kBk / 8;         // n8 blocks (keys) of a score row
  constexpr int kNo = D / 8;           // n8 blocks of a dq row
  extern __shared__ uint8_t smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(align1024(smem_raw));
  // a head's query tiles are neighbours in the grid, so the blocks in
  // flight share its K and V through L2; within a head the last query
  // tiles carry the most causal work and start first
  const int n_tiles = (Tq + kWgRows - 1) / kWgRows;
  const int bh = blockIdx.x / n_tiles;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int q0 = (n_tiles - 1 - blockIdx.x % n_tiles) * kWgRows;
  const int q_last = min(q0 + kWgRows, Tq) - 1;
  // the key tiles up to the causal frontier (the TPU kernel's
  // _block_live skip); at least one, since Tk >= 1
  int nk = (Tk + kBk - 1) / kBk;
  if (causal) nk = min(nk, q_last / kBk + 1);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hop::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&sm.full[s], 1);
      hop::mbar_init(&sm.empty[s], kConsumers);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer: one thread issues every load
    hop::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hop::prefetch_map(&tm_q);
      hop::prefetch_map(&tm_k);
      hop::prefetch_map(&tm_v);
      hop::prefetch_map(&tm_do);
      hop::mbar_arrive_expect_tx(&sm.q_full, 2 * kWgRows * D * 2);
      for (int x = 0; x < D / 64; ++x) {
        hop::tma_load_3d(sm.q + x * kQBox, &tm_q, &sm.q_full,
                         h * D + 64 * x, q0, b);
        hop::tma_load_3d(sm.dout + x * kQBox, &tm_do, &sm.q_full,
                         h * D + 64 * x, q0, b);
      }
      for (int j = 0; j < nk; ++j) {
        const int s = j % kStages;
        // the first pass over the ring finds every stage free
        hop::mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        hop::mbar_arrive_expect_tx(&sm.full[s], 2 * kBk * D * 2);
        for (int x = 0; x < D / 64; ++x) {
          hop::tma_load_3d(sm.k[s] + x * kKBox, &tm_k, &sm.full[s],
                           h * D + 64 * x, j * kBk, b);
          hop::tma_load_3d(sm.v[s] + x * kKBox, &tm_v, &sm.full[s],
                           h * D + 64 * x, j * kBk, b);
        }
      }
    }
    return;
  }

  hop::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;  // this consumer's rows: 64 cw .. 64 cw + 63
  const int tid = threadIdx.x - 128 * wg;
  const int lane = tid % 32;
  const int r0 = 64 * cw + 16 * (tid / 32);  // the warp's first row
  const int c2 = (lane % 4) * 2;             // the lane's column pair
  // the lane's two rows, g and g + 8 of the warp's 16
  const int rows[2] = {q0 + r0 + lane / 4, q0 + r0 + lane / 4 + 8};
  const uint8_t* mb =
      kv_mask ? kv_mask + static_cast<size_t>(b) * Tk : nullptr;
  const float scale2 = scale * tc::kLog2e;  // scores in base-2 units
  // lse (base-2 units) and delta of the lane's rows, plain loads once: a
  // row past Tq gets lse = +1e30 and delta = 0, so its p and ds are 0
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t idx = static_cast<size_t>(bh) * Tq + rows[i];
    lse2[i] = rows[i] < Tq ? lse[idx] * tc::kLog2e : -kNegInf;
    dlt[i] = rows[i] < Tq ? delta[idx] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // shared-memory descriptors, built once: a k16 step or a stage moves
  // a descriptor by its byte offset >> 4 (hopper.cuh).  This consumer's
  // 64 rows of the Q and dO tiles, in every box
  const uint64_t q_desc = hop::desc_sw128(sm.q + 64 * cw * 64, 16, 1024);
  const uint64_t do_desc = hop::desc_sw128(sm.dout + 64 * cw * 64, 16, 1024);
  const uint64_t k_desc = hop::desc_sw128(sm.k[0], 16, 1024);
  const uint64_t v_desc = hop::desc_sw128(sm.v[0], 16, 1024);
  const uint64_t k_mn_desc = hop::desc_sw128(sm.k[0], kKBox * 2, 1024);
  constexpr uint64_t kStageStep = kBk * D * 2 / 16;  // one K or V stage
  // S = Q . K^T and dP = dO . V^T of key tile j: this consumer's 64 rows
  // x kBk keys (K-major A and B)
  float s[kBk / 2], dp[kBk / 2];
  auto issue_scores = [&](int j) {
    const uint64_t step = (j % kStages) * kStageStep;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // box kk / 4, k16 step kk % 4
      hop::wgmma_ss<kBk>(
          s, q_desc + ((kk / 4) * kQBox * 2 + (kk % 4) * 32) / 16,
          k_desc + step + ((kk / 4) * kKBox * 2 + (kk % 4) * 32) / 16,
          kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hop::wgmma_ss<kBk>(
          dp, do_desc + ((kk / 4) * kQBox * 2 + (kk % 4) * 32) / 16,
          v_desc + step + ((kk / 4) * kKBox * 2 + (kk % 4) * 32) / 16,
          kk > 0);
  };
  // dS of the last tile, the bf16 A operand of its dq product, which is
  // issued with the next tile's scores
  uint32_t da[kBk / 16][4];
  // dq += dS(j) . K(j), K's rows the k dimension (MN-major, 16 rows a
  // step), from the stage S(j) read
  auto issue_dq = [&](int j) {
    const uint64_t step = (j % kStages) * kStageStep;
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)  // 16 rows of 128 bytes a step
      hop::wgmma_rs<D>(acc, da[kk], k_mn_desc + step + kk * 128);
  };
  // ds = p * (dp - delta) of key tile j, f32, in s
  auto elementwise = [&](int j) {
    const int k0 = j * kBk;
    // x = s * scale * log2 e - lse * log2 e, then NEG_INF where the pair
    // is dead: keys past Tk, masked keys, or (causal) keys past the row.
    // Only then is any key of this tile dead for this warp; the test is
    // hoisted out of the score loops and branch-free inside them (a
    // per-score branch costs each score a convergence barrier)
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * n + e] = fmaf(s[4 * n + e], scale2, -lse2[e / 2]);
    const bool edge = k0 + kBk > Tk || mb != nullptr ||
                      (causal && k0 + kBk - 1 > q0 + r0);
    if (edge) {
      // bit i of word w: key k0 + 32 w + i is in range and not masked.
      // The key mask is read once a tile, one byte a lane a word, and
      // shared by ballot (edge is the same for the whole warp): a lane
      // reading its own 2 x kNs bytes held that many registers at once
      uint32_t keep[kBk / 32];
#pragma unroll
      for (int w = 0; w < kBk / 32; ++w) {
        const int t = k0 + 32 * w + lane;
        keep[w] = __ballot_sync(0xffffffffu,
                                t < Tk && (mb == nullptr || mb[t] != 0));
      }
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = n * 8 + c2 + (e & 1);  // key k0 + i, word n / 4
          const bool dead = ((keep[n / 4] >> (i % 32)) & 1u) == 0u ||
                            (causal && k0 + i > rows[e / 2]);
          s[4 * n + e] = dead ? kNegInf : s[4 * n + e];
        }
    }
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * n + e] = hop::ex2(s[4 * n + e]) * (dp[4 * n + e] - dlt[e / 2]);
  };
  // ds rounded to bf16 straight into A operands (the TPU cast point,
  // _bwd_dq_kernel's ds.astype(k.dtype)): n8 blocks 2kk and 2kk + 1 are
  // the k16 step kk
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        da[kk][e] = tc::pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  };

  // Turn j issues tile j's S and dP with tile j - 1's dq product; the
  // consumers take turns (named barriers), so one consumer's products run
  // on the tensor cores while the other does its exponentials.  A
  // consumer waits for all three products before its own elementwise
  // work (issuing a wgmma holds the warps about as long as it runs, so
  // little of that work could overlap them anyway), which keeps the bf16
  // dS operand out of the registers that S and dP hold then: 160 live at
  // D = 64 rather than 192, which spilled.  A stage is released only
  // after its dq product has landed (K is read twice).  The first and
  // last turns are peeled: every wgmma of the loop is unconditional,
  // which ptxas needs to keep them asynchronous.  Consumer 0 takes the
  // first turn.
  hop::mbar_wait(&sm.q_full, 0);
  if (cw == 1) hop::bar_arrive(kTurn, kConsumers);
  hop::mbar_wait(&sm.full[0], 0);
  hop::bar_sync(kTurn + cw, kConsumers);
  hop::wgmma_fence();
  issue_scores(0);
  hop::wgmma_commit();
  hop::bar_arrive(kTurn + (cw ^ 1), kConsumers);
  hop::wgmma_wait<0>();
  hop::fence_regs(s);
  hop::fence_regs(dp);
  elementwise(0);
  pack();
  for (int j = 1; j < nk; ++j) {
    hop::mbar_wait(&sm.full[j % kStages], (j / kStages) & 1);
    hop::bar_sync(kTurn + cw, kConsumers);
    hop::wgmma_fence();
    issue_scores(j);
    issue_dq(j - 1);
    hop::wgmma_commit();
    hop::bar_arrive(kTurn + (cw ^ 1), kConsumers);
    hop::wgmma_wait<0>();  // S(j), dP(j) and tile j - 1's dq have landed
    hop::fence_regs(s);
    hop::fence_regs(dp);
    hop::fence_regs(acc);
    hop::fence_regs(da);
    hop::mbar_arrive(&sm.empty[(j - 1) % kStages]);  // may be refilled
    elementwise(j);
    pack();
  }
  // the last dq product (consumer 1's last turn has no successor)
  hop::bar_sync(kTurn + cw, kConsumers);
  hop::wgmma_fence();
  issue_dq(nk - 1);
  hop::wgmma_commit();
  if (cw == 0) hop::bar_arrive(kTurn + 1, kConsumers);
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);
  hop::fence_regs(da);
  hop::mbar_arrive(&sm.empty[(nk - 1) % kStages]);

  // rows past Tq are never written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = rows[i];
    if (t >= Tq) continue;
    __nv_bfloat16* row = dq + (static_cast<size_t>(b) * Tq + t) * H * D + h * D;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + c2) =
          __floats2bfloat162_rn(scale * acc[4 * n + 2 * i],
                                scale * acc[4 * n + 2 * i + 1]);
  }
}

// ---- delta = rowsum(dO * O), one pass over the model's layout -----------

constexpr int kDeltaTokens = 32;  // tokens a block: one 128-byte run of delta
constexpr int kDeltaMaxThreads = kDeltaTokens * 8;  // at 8 heads a block

// heads a block: 8, or 4 for rows over 256 bytes (f32 at D = 96 and 128),
// so that a block's two staged tiles stay within 136 KB of shared memory
template <typename T, int D>
__host__ __device__ constexpr int delta_heads() {
  return D * sizeof(T) <= 256 ? 8 : 4;
}

// one (token, head) row a thread
template <typename T, int D>
__host__ __device__ constexpr int delta_threads() {
  return kDeltaTokens * delta_heads<T, D>();
}

// the staged O and dO tiles: rows of D values padded by 16 bytes, so that
// the threads of a warp, reading one row each, hit distinct banks
template <typename T, int D>
constexpr size_t delta_smem_bytes() {
  return 2 * sizeof(uint4) * delta_threads<T, D>() *
         (D * sizeof(T) / 16 + 1);
}

// s += the f32 products of 16 bytes of a and b, one at a time in order:
// 8 bf16 values (each product exact in f32) or 4 f32 values.  Each
// product and each sum is rounded on its own (no fused multiply-add), as
// the plain version's multiply and adds are, so the two agree bitwise
template <typename T>
__device__ __forceinline__ void dot16(float& s, uint4 a, uint4 b);

template <>
__device__ __forceinline__ void dot16<__nv_bfloat16>(float& s, uint4 a,
                                                     uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = __fadd_rn(s, __fmul_rn(u.x, w.x));
    s = __fadd_rn(s, __fmul_rn(u.y, w.y));
  }
}

template <>
__device__ __forceinline__ void dot16<float>(float& s, uint4 a, uint4 b) {
  s = __fadd_rn(s, __fmul_rn(__uint_as_float(a.x), __uint_as_float(b.x)));
  s = __fadd_rn(s, __fmul_rn(__uint_as_float(a.y), __uint_as_float(b.y)));
  s = __fadd_rn(s, __fmul_rn(__uint_as_float(a.z), __uint_as_float(b.z)));
  s = __fadd_rn(s, __fmul_rn(__uint_as_float(a.w), __uint_as_float(b.w)));
}

// One block per (b, 32-token tile, 8 or 4 heads).  Each token's run of
// the block's heads is contiguous in O and dO, so the block copies both
// tiles into shared memory with 16-byte loads, neighbouring threads on
// neighbouring addresses (a thread reading its own row touched a line per
// thread per load, and ran 1.5x slower at TinyLlama's shape); then a
// thread sums one (token, head) row of D products in order of d (the
// plain version's order), and the block's sums go out through shared
// memory, each head's 32 tokens as one 128-byte run of delta's row.
template <typename T, int D>
__global__ void __launch_bounds__(kDeltaMaxThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, int Tq, int H) {
  constexpr int kHeads = delta_heads<T, D>();
  constexpr int kThreads = delta_threads<T, D>();
  constexpr int kChunks = D * sizeof(T) / 16;  // 16-byte pieces of a row
  constexpr int kPitch = kChunks + 1;          // a staged row, padded
  extern __shared__ uint4 staged[];  // O rows, then dO rows [kThreads][kPitch]
  __shared__ float sums[kHeads][kDeltaTokens];
  const int n_tiles = (Tq + kDeltaTokens - 1) / kDeltaTokens;
  const int n_groups = (H + kHeads - 1) / kHeads;
  const int b = blockIdx.x / (n_tiles * n_groups);
  const int t0 = (blockIdx.x / n_groups % n_tiles) * kDeltaTokens;
  const int h0 = blockIdx.x % n_groups * kHeads;
  const int nt = min(kDeltaTokens, Tq - t0);
  const int nh = min(kHeads, H - h0);
  const size_t tok = static_cast<size_t>(H) * D;  // stride of one token
  const size_t base = (static_cast<size_t>(b) * Tq + t0) * tok +
                      static_cast<size_t>(h0) * D;
  // piece c of head hh of token t: every load of both tiles in flight
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int i = threadIdx.x + kThreads * k;
    const int t = i / (kHeads * kChunks), hh = i / kChunks % kHeads;
    const int c = i % kChunks;
    if (t < nt && hh < nh) {
      const size_t off = base + t * tok + static_cast<size_t>(hh) * D;
      const int row = t * kHeads + hh;
      staged[row * kPitch + c] =
          __ldg(reinterpret_cast<const uint4*>(o + off) + c);
      staged[(kThreads + row) * kPitch + c] =
          __ldg(reinterpret_cast<const uint4*>(dout + off) + c);
    }
  }
  __syncthreads();
  const int t = threadIdx.x / kHeads, hh = threadIdx.x % kHeads;
  if (t < nt && hh < nh) {
    const uint4* x = staged + threadIdx.x * kPitch;
    const uint4* y = staged + (kThreads + threadIdx.x) * kPitch;
    float s = -0.f;  // -0 + x = x for every x, as the plain version starts
#pragma unroll
    for (int c = 0; c < kChunks; ++c) dot16<T>(s, x[c], y[c]);
    sums[hh][t] = s;
  }
  __syncthreads();
  const int wh = threadIdx.x / kDeltaTokens, wt = threadIdx.x % kDeltaTokens;
  if (wh < nh && wt < nt)
    delta[(static_cast<size_t>(b) * H + h0 + wh) * Tq + t0 + wt] =
        sums[wh][wt];
}

struct Args {
  const void *q, *k, *v, *dout;
  const uint8_t* mask;
  const float *lse, *delta;
  int B, Tq, Tk, H, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  const dim3 grid(a.B * a.H, (a.Tq + kTile - 1) / kTile);
  // the operand type picks the kernel: bf16 on the tensor cores, f32 on
  // the CUDA cores
  void (*kernel)(const T*, const T*, const T*, const uint8_t*, const T*,
                 const float*, const float*, T*, int, int, int, float, int);
  size_t smem;
  int threads;
  if constexpr (std::is_same_v<T, float>) {
    kernel = flash_bwd_dq_kernel<float, D>;
    smem = dq_smem_bytes<D>();
    threads = kThreads;
  } else {
    kernel = flash_bwd_dq_bf16_kernel<D>;
    smem = dq_bf16_smem_bytes<D>();
    threads = kTcThreads;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(dq), a.Tq, a.Tk, a.H, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  const dim3 grid(a.B * a.H, (a.Tk + kTile - 1) / kTile);
  // the operand type picks the kernel, as for dq
  void (*kernel)(const T*, const T*, const T*, const uint8_t*, const T*,
                 const float*, const float*, T*, T*, int, int, int, float,
                 int);
  size_t smem;
  int threads;
  if constexpr (std::is_same_v<T, float>) {
    kernel = flash_bwd_dkv_kernel<float, D>;
    smem = dkv_smem_bytes<D>();
    threads = kThreads;
  } else {
    kernel = flash_bwd_dkv_bf16_kernel<D>;
    smem = dkv_bf16_smem_bytes<D>();
    threads = kTcThreads;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.Tq, a.Tk,
      a.H, a.scale, a.causal);
  return cudaGetLastError();
}

// the wgmma dk/dv kernel: every operand through a tensor map
template <int D>
cudaError_t launch_dkv_wgmma(const Args& a, void* dk, void* dv) {
  constexpr int kBq = wg_queries<D>();
  CUtensorMap mq, mk, mv, mdo, mlse, mdlt;
  const long long rows = static_cast<long long>(a.B) * a.H * a.Tq;
  cudaError_t e = hop::map_bthd(&mq, a.q, a.B, a.Tq, a.H, D, kBq);
  if (e == cudaSuccess) e = hop::map_bthd(&mk, a.k, a.B, a.Tk, a.H, D, kWgKeys);
  if (e == cudaSuccess) e = hop::map_bthd(&mv, a.v, a.B, a.Tk, a.H, D, kWgKeys);
  if (e == cudaSuccess) e = hop::map_bthd(&mdo, a.dout, a.B, a.Tq, a.H, D, kBq);
  if (e == cudaSuccess) e = hop::map_f32(&mlse, a.lse, rows, wg_row_box<D>());
  if (e == cudaSuccess)
    e = hop::map_f32(&mdlt, a.delta, rows, wg_row_box<D>());
  if (e != cudaSuccess) return e;
  constexpr size_t smem = dkv_wg_smem_bytes<D>();
  e = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>(a.B) * a.H *
                           ((a.Tk + kWgKeys - 1) / kWgKeys);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dkv_wgmma_kernel<D><<<static_cast<unsigned>(blocks),
                                  kWgThreads, smem, a.stream>>>(
      mq, mk, mv, mdo, mlse, mdlt, a.mask, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.Tq, a.Tk, a.H, a.scale, a.causal);
  return cudaGetLastError();
}

// the wgmma dq kernel: q, k, v and dO through tensor maps, lse and delta
// by plain loads
template <int D>
cudaError_t launch_dq_wgmma(const Args& a, void* dq) {
  constexpr int kBk = dq_wg_keys<D>();
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e = hop::map_bthd(&mq, a.q, a.B, a.Tq, a.H, D, kWgRows);
  if (e == cudaSuccess) e = hop::map_bthd(&mk, a.k, a.B, a.Tk, a.H, D, kBk);
  if (e == cudaSuccess) e = hop::map_bthd(&mv, a.v, a.B, a.Tk, a.H, D, kBk);
  if (e == cudaSuccess)
    e = hop::map_bthd(&mdo, a.dout, a.B, a.Tq, a.H, D, kWgRows);
  if (e != cudaSuccess) return e;
  constexpr size_t smem = dq_wg_smem_bytes<D>();
  e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>(a.B) * a.H *
                           ((a.Tq + kWgRows - 1) / kWgRows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dq_wgmma_kernel<D><<<static_cast<unsigned>(blocks), kWgThreads,
                                 smem, a.stream>>>(
      mq, mk, mv, mdo, a.mask, a.lse, a.delta,
      static_cast<__nv_bfloat16*>(dq), a.Tq, a.Tk, a.H, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int B, int Tq, int H, cudaStream_t stream) {
  constexpr int kHeads = delta_heads<T, D>();
  constexpr size_t smem = delta_smem_bytes<T, D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_delta_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>(B) *
                           ((Tq + kDeltaTokens - 1) / kDeltaTokens) *
                           ((H + kHeads - 1) / kHeads);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T, D><<<static_cast<unsigned>(blocks),
                                 delta_threads<T, D>(), smem, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, Tq, H);
  return cudaGetLastError();
}

bool valid(int B, int Tq, int Tk, int H) {
  return B >= 1 && Tq >= 1 && Tk >= 1 && H >= 1 &&
         static_cast<long long>(B) * H <= 0x7fffffffLL &&
         (Tq + kTile - 1) / kTile <= 65535 && (Tk + kTile - 1) / kTile <= 65535;
}

Args args(const void* q, const void* k, const void* v, const void* kv_mask,
          const void* dout, const void* lse, const void* delta, int B,
          int Tq, int Tk, int H, int causal, float scale, void* stream) {
  return Args{q,
              k,
              v,
              dout,
              static_cast<const uint8_t*>(kv_mask),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              B,
              Tq,
              Tk,
              H,
              causal,
              scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q, dout [B, Tq, H, D] and k, v [B, Tk, H, D], all f32 (bf16 = 0) or
// bf16 (1), contiguous and 16-byte aligned (cp.async, TMA); kv_mask [B, Tk]
// bool (one byte each) or null for all live; lse, delta [B*H, Tq] f32;
// dq [B, Tq, H, D] in the operand type.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* kv_mask,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq, int bf16,
                                      int B, int Tq, int Tk, int H, int D,
                                      int causal, float scale,
                                      void* stream) {
  if (!valid(B, Tq, Tk, H)) return cudaErrorInvalidValue;
  const Args a = args(q, k, v, kv_mask, dout, lse, delta, B, Tq, Tk, H,
                      causal, scale, stream);
  // the instantiated head dims (flash_attention.cu); bf16 picks its
  // kernel by D up front: wgmma at 64 and 128, mma.sync at 32 and 96
  switch (D) {
    case 32:
      return bf16 ? launch_dq<__nv_bfloat16, 32>(a, dq)
                  : launch_dq<float, 32>(a, dq);
    case 64:
      return bf16 ? launch_dq_wgmma<64>(a, dq) : launch_dq<float, 64>(a, dq);
    case 96:
      return bf16 ? launch_dq<__nv_bfloat16, 96>(a, dq)
                  : launch_dq<float, 96>(a, dq);
    case 128:
      return bf16 ? launch_dq_wgmma<128>(a, dq)
                  : launch_dq<float, 128>(a, dq);
    default:
      return cudaErrorInvalidValue;
  }
}

// o, dout [B, Tq, H, D], both f32 (bf16 = 0) or bf16 (1), contiguous and
// 16-byte aligned; delta [B*H, Tq] f32 (row b*H + h), the layout both
// kernels above read.
extern "C" int flash_attention_bwd_delta(const void* o, const void* dout,
                                         void* delta, int bf16, int B,
                                         int Tq, int H, int D,
                                         void* stream) {
  if (B < 1 || Tq < 1 || H < 1) return cudaErrorInvalidValue;
  float* d = static_cast<float*>(delta);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return bf16 ? launch_delta<__nv_bfloat16, 32>(o, dout, d, B, Tq, H, st)
                  : launch_delta<float, 32>(o, dout, d, B, Tq, H, st);
    case 64:
      return bf16 ? launch_delta<__nv_bfloat16, 64>(o, dout, d, B, Tq, H, st)
                  : launch_delta<float, 64>(o, dout, d, B, Tq, H, st);
    case 96:
      return bf16 ? launch_delta<__nv_bfloat16, 96>(o, dout, d, B, Tq, H, st)
                  : launch_delta<float, 96>(o, dout, d, B, Tq, H, st);
    case 128:
      return bf16
                 ? launch_delta<__nv_bfloat16, 128>(o, dout, d, B, Tq, H, st)
                 : launch_delta<float, 128>(o, dout, d, B, Tq, H, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The same operands; dk, dv [B, Tk, H, D] in the operand type.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* kv_mask,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       int bf16, int B, int Tq, int Tk, int H,
                                       int D, int causal, float scale,
                                       void* stream) {
  if (!valid(B, Tq, Tk, H)) return cudaErrorInvalidValue;
  const Args a = args(q, k, v, kv_mask, dout, lse, delta, B, Tq, Tk, H,
                      causal, scale, stream);
  // bf16 picks its kernel by D up front: wgmma at 64 and 128, mma.sync
  // at 32 and 96
  switch (D) {
    case 32:
      return bf16 ? launch_dkv<__nv_bfloat16, 32>(a, dk, dv)
                  : launch_dkv<float, 32>(a, dk, dv);
    case 64:
      return bf16 ? launch_dkv_wgmma<64>(a, dk, dv)
                  : launch_dkv<float, 64>(a, dk, dv);
    case 96:
      return bf16 ? launch_dkv<__nv_bfloat16, 96>(a, dk, dv)
                  : launch_dkv<float, 96>(a, dk, dv);
    case 128:
      return bf16 ? launch_dkv_wgmma<128>(a, dk, dv)
                  : launch_dkv<float, 128>(a, dk, dv);
    default:
      return cudaErrorInvalidValue;
  }
}
