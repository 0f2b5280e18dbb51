// Dense flash-attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel analytics_zoo_tpu/ops/flash_attention.py:
// _fwd_kernel (launched by _fwd_call).  It computes the same function as
// the plain PyTorch version, flash_attention_ref in
// analytics_zoo_tpu_torch/ops/flash_attention.py:
//
//   q [B, Tq, H, D], k/v [B, Tk, H, D] (the model's own layout: no
//   [B*H, T, D] transpose and no padded copy is made), optional key mask
//   [B, Tk] bool, optional causal mask (key t is live for query i iff
//   t <= i).  Scores s = scale * q.k in f32, masked keys NEG_INF = -1e30,
//   online softmax in f32 with the m_sub guard (a row with nothing live
//   subtracts 0, so exp(NEG_INF) underflows to 0), p rounded to v's
//   dtype before p.V, f32 accumulation.  o = acc / l in q's dtype (0 for
//   a fully masked row); lse f32 [B*H, Tq] = m + log l, or +1e30 where
//   l == 0, kept for the backward kernels.
//
// Three kernels, chosen up front by the operand type and, in bf16, by
// the head dim in flash_attention_fwd (an explicit dispatch, never a
// fallback after a failed launch):
//
// bf16 at D = 64 and 128 (every main path is D = 64):
// flash_fwd_wgmma_kernel, FlashAttention-3's design on Hopper's own
// instructions (hopper.cuh).  What bounds the work: at TinyLlama's
// training shape (B=4, T=2048, H=32, D=64, causal) the causal q.k and
// p.v products are 68.8 GFLOP, 0.0695 ms at the 989 TFLOP/s bf16 tensor
// rate, against 34 MB of bytes (0.010 ms); and its 268.6 M live scores
// need as many exponentials, about 0.069 ms at the ~3.9 T/s of the
// special-function units, besides the masking, maxima, sums and
// conversions around each.  So the softmax of one consumer must run
// while the tensor cores work on the other's products.
//   - Grid and roles: one block of 384 threads per (128-row query tile,
//     b*H + h), a head's tiles neighbours in the grid (the heaviest
//     causal tile first), so the blocks in flight share each head's K
//     and V through L2.  Warpgroup 0 is the producer: it gives
//     registers back (setmaxnreg) and one thread loads the Q tile once
//     and the K and V tiles of 128 keys into a ring by TMA (kv_stages:
//     4 at D = 64, 3 at D = 128), each stage with a full and an empty
//     mbarrier.  Warpgroups 1 and 2 are consumers of 64 query rows each
//     and take the registers (232 a thread).
//   - Products: S = Q.K^T is wgmma with A = Q and B = K both from shared
//     memory (K-major); O += P.V is wgmma with A = P, the S accumulators
//     rounded to bf16 in registers (the TPU kernel's cast point, p to v's
//     dtype), and B = V from shared memory (MN-major).  P never leaves
//     registers.  Descriptors are built once and moved by byte offsets.
//   - Schedule: turn j issues S(j) and P(j-1).V(j-1) together; the
//     consumers take turns at the tensor cores (two named barriers), and
//     each runs tile j's softmax while its P(j-1).V(j-1) is in flight.
//     The first and last turns are peeled so that every wgmma of the
//     loop is unconditional (under a branch ptxas serialises them).
//   - Softmax: the row maxima of the raw scores (four chains a row), the
//     scale folded into the exponent (one FFMA and one ex2.approx a
//     score), the m_sub guard of the TPU kernel, the row sums in two
//     chains; O and l are rescaled once P(j-1).V(j-1) has landed.
//   - Masks: the block walks the key tiles up to its causal frontier
//     min(nk, q_last / 128 + 1) (the TPU kernel's _block_live skip).
//     Only where a warp's rows meet the diagonal, keys run past Tk
//     (zero-filled by TMA) or a key mask is given is any score masked;
//     that test is hoisted out of the score loops and is branch-free
//     inside them (a per-score branch costs each score a convergence
//     barrier, more than its exponential), the key mask read once a tile
//     into a bit set.  A fully masked row keeps o = 0 and lse = +1e30,
//     and rows past Tq are never written.
//   - D = 128 takes two 64-column TMA boxes per tile (128-byte rows are
//     the swizzle's width).  Shared memory: the Q tile and the K/V ring,
//     144 KB (D=64) and 224 KB (D=128), one block an SM.
//
// bf16 at D = 32 and 96: flash_fwd_bf16_kernel, FlashAttention-2's
// design on mma.sync m16n8k16 (tensor_core.cuh), kept for these head
// dims (no main path runs them).  One block of 4 warps per (64-row query
// tile, b*H + h); each warp owns 16 query rows and holds its Q fragments
// in registers; K and V tiles ([64][D + 8] bf16, conflict-free for
// ldmatrix) come in two stages of 16-byte cp.async; P goes from the
// score accumulators straight into A fragments.  Shared memory 25 KB
// (D=32), 65 KB (D=96).
//
// f32: flash_fwd_kernel, CUDA-core f32 products, exact f32 operands as
// the TPU kernel multiplies them (preferred_element_type=f32; TF32
// tensor cores keep about three digits and would break the card's f32
// token-identity and training-parity checks).  One block per (query tile
// of 64 rows, b*H + h), the same key-tile loop; K and V staged in shared
// memory as f32; each of the 128 threads computes a 4 x 8 block of the
// 64 x 64 score tile, and the online-softmax state of a row lives in the
// 8 lanes that hold its scores.
//
// Plain C interface (loaded with ctypes): flash_attention_fwd encodes the
// tensor maps (bf16, D = 64 and 128) and returns cudaGetLastError() after
// the launch, cudaErrorInvalidValue for a shape it does not take, or the
// error of a tensor map cuTensorMapEncodeTiled refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBq = 64;          // query rows per block
constexpr int kBk = 64;          // keys per tile
constexpr int kRows = 4;         // query rows per thread: 16 row groups
constexpr int kKeys = 8;         // keys per thread: 8 key lanes
constexpr int kLanes = kBk / kKeys;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// p as the p.V product sees it: rounded to v's storage type
__device__ __forceinline__ float round_p(float p, float) { return p; }

// max / sum over the 8 consecutive lanes that hold one row's scores
__device__ __forceinline__ float lanes_max(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  // q and k padded by one column (conflict-free column reads), v, p
  return sizeof(float) *
         (kBq * (D + 1) + kBk * (D + 1) + kBk * D + kBq * (kBk + 1));
}

// f32 operands (bf16 takes flash_fwd_bf16_kernel below)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const uint8_t* __restrict__ kv_mask,
                     T* __restrict__ o, float* __restrict__ lse, int Tq,
                     int Tk, int H, float scale, int causal) {
  constexpr int kLd = D + 1;
  constexpr int kPld = kBk + 1;
  constexpr int kCols = D / kLanes;  // output columns per thread
  const int bh = blockIdx.x;         // b * H + h
  const int b = bh / H, h = bh % H;
  // the last query tiles carry the most causal work: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBq;
  const int ty = threadIdx.x / kLanes;  // rows ty*4 .. ty*4+3
  const int tx = threadIdx.x % kLanes;  // keys tx + 8j, columns tx + 8c

  extern __shared__ float smem[];
  float* q_s = smem;                // [kBq][D + 1]
  float* k_s = q_s + kBq * kLd;     // [kBk][D + 1]
  float* v_s = k_s + kBk * kLd;     // [kBk][D]
  float* p_s = v_s + kBk * D;       // [kBq][kBk + 1]

  const size_t tok = static_cast<size_t>(H) * D;  // stride of one token
  const T* qb = q + static_cast<size_t>(b) * Tq * tok + h * D;
  const T* kb = k + static_cast<size_t>(b) * Tk * tok + h * D;
  const T* vb = v + static_cast<size_t>(b) * Tk * tok + h * D;
  const uint8_t* mb =
      kv_mask ? kv_mask + static_cast<size_t>(b) * Tk : nullptr;

  for (int idx = threadIdx.x; idx < kBq * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, t = q0 + r;
    q_s[r * kLd + d] = t < Tq ? to_f32(qb[t * tok + d]) : 0.f;
  }

  const int q_last = min(q0 + kBq, Tq) - 1;
  int nk = (Tk + kBk - 1) / kBk;
  if (causal) nk = min(nk, q_last / kBk + 1);

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[rr][c] = 0.f;
  }

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBk;
    __syncthreads();  // every warp is done with the previous k/v tile
    for (int idx = threadIdx.x; idx < kBk * D; idx += kThreads) {
      const int r = idx / D, d = idx % D, t = k0 + r;
      const bool in = t < Tk;
      k_s[r * kLd + d] = in ? to_f32(kb[t * tok + d]) : 0.f;
      v_s[r * D + d] = in ? to_f32(vb[t * tok + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) s[rr][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qr[kRows], kr[kKeys];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        qr[rr] = q_s[(ty * kRows + rr) * kLd + d];
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj)
        kr[jj] = k_s[(tx + kLanes * jj) * kLd + d];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
        for (int jj = 0; jj < kKeys; ++jj)
          s[rr][jj] = fmaf(qr[rr], kr[jj], s[rr][jj]);
    }

    bool live[kKeys];
#pragma unroll
    for (int jj = 0; jj < kKeys; ++jj) {
      const int t = k0 + tx + kLanes * jj;
      live[jj] = t < Tk && (mb == nullptr || mb[t] != 0);
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int row = ty * kRows + rr;
      const int qi = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const int t = k0 + tx + kLanes * jj;
        float sv = scale * s[rr][jj];
        if (!live[jj] || (causal && t > qi)) sv = kNegInf;
        s[rr][jj] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = lanes_max(mx);
      const float m_new = fmaxf(m[rr], mx);
      const float m_sub = m_new > kNegInf * 0.5f ? m_new : 0.f;
      const float alpha = expf(m[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const float p = expf(s[rr][jj] - m_sub);
        psum += p;
        p_s[row * kPld + tx + kLanes * jj] = round_p(p, T());
      }
      psum = lanes_sum(psum);
      m[rr] = m_new;
      l[rr] = l[rr] * alpha + psum;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[rr][c] *= alpha;
    }
    // a row's p is written and read by the 8 lanes of its own warp
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < kBk; ++kk) {
      float pr[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        pr[rr] = p_s[(ty * kRows + rr) * kPld + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = v_s[kk * D + tx + kLanes * c];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
          acc[rr][c] = fmaf(pr[rr], vv, acc[rr][c]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int t = q0 + ty * kRows + rr;
    if (t >= Tq) continue;
    const float l_safe = l[rr] > 0.f ? l[rr] : 1.f;
    T* orow = o + (static_cast<size_t>(b) * Tq + t) * tok + h * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      orow[tx + kLanes * c] = from_f32<T>(acc[rr][c] / l_safe);
    if (tx == 0)
      lse[static_cast<size_t>(bh) * Tq + t] =
          l[rr] > 0.f ? m[rr] + logf(l_safe) : -kNegInf;
  }
}

constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr size_t bf16_smem_bytes() {
  // the q tile and two stages of k and v tiles, [64][D + 8] bf16 each
  return sizeof(__nv_bfloat16) * (kBq + 4 * kBk) * (D + tc::kPad);
}

// bf16 operands on mma.sync, D = 32 and 96 (see the header)
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const uint8_t* __restrict__ kv_mask,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int Tq, int Tk, int H,
                          float scale, int causal) {
  constexpr int kLd = D + tc::kPad;
  constexpr int kNs = kBk / 8;  // n8 blocks of a warp's score tile
  constexpr int kNo = D / 8;    // n8 blocks of a warp's output rows
  const int bh = blockIdx.x;    // b * H + h
  const int b = bh / H, h = bh % H;
  // the last query tiles carry the most causal work: start them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBq;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's rows r0 .. r0+15
  const int c2 = (lane % 4) * 2;           // the lane's column pair
  // the lane's two rows, g and g + 8 of the warp's 16
  const int rows[2] = {q0 + r0 + lane / 4, q0 + r0 + lane / 4 + 8};

  extern __shared__ __align__(16) __nv_bfloat16 tiles[];
  __nv_bfloat16* q_s = tiles;                // [64][kLd]
  __nv_bfloat16* k_s = q_s + kBq * kLd;      // [2][64][kLd]
  __nv_bfloat16* v_s = k_s + 2 * kBk * kLd;  // [2][64][kLd]

  const size_t tok = static_cast<size_t>(H) * D;  // stride of one token
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * Tq * tok + h * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * Tk * tok + h * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * Tk * tok + h * D;
  const uint8_t* mb =
      kv_mask ? kv_mask + static_cast<size_t>(b) * Tk : nullptr;

  const int q_last = min(q0 + kBq, Tq) - 1;
  int nk = (Tk + kBk - 1) / kBk;
  if (causal) nk = min(nk, q_last / kBk + 1);

  // stage 0: the q tile and the first k/v tile, one cp.async group
  tc::load_tile_async<kBq, D, kThreads>(q_s, qb, q0, Tq, tok);
  if (nk > 0) {
    tc::load_tile_async<kBk, D, kThreads>(k_s, kb, 0, Tk, tok);
    tc::load_tile_async<kBk, D, kThreads>(v_s, vb, 0, Tk, tok);
  }
  tc::cp_async_commit();

  uint32_t qf[D / 16][4];  // the warp's Q A fragments, resident
  float acc[kNo][4];
#pragma unroll
  for (int n = 0; n < kNo; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // per lane row: running max (base-2 units) and this lane's part of l
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = scale * tc::kLog2e;  // scores in base-2 units

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kBk;
    const int st = j & 1;
    if (j + 1 < nk) {  // tile j + 1 into the other stage, in flight
      tc::load_tile_async<kBk, D, kThreads>(k_s + (st ^ 1) * kBk * kLd, kb,
                                            k0 + kBk, Tk, tok);
      tc::load_tile_async<kBk, D, kThreads>(v_s + (st ^ 1) * kBk * kLd, vb,
                                            k0 + kBk, Tk, tok);
    }
    tc::cp_async_commit();  // (empty on the last tile)
    tc::cp_async_wait<1>();  // tile j (and, first, the q tile) landed
    __syncthreads();
    if (j == 0) tc::load_a_frags<D>(qf, q_s, r0, lane);

    float s[kNs][4];
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    tc::mma_abt<D, kNs>(s, qf, k_s + st * kBk * kLd, lane);

    // keys past Tk, masked keys, or (causal) keys past the warp's first
    // row: only then is any key of this tile dead for this warp
    const bool edge = k0 + kBk > Tk || mb != nullptr ||
                      (causal && k0 + kBk - 1 > q0 + r0);
    float mx[2] = {kNegInf, kNegInf};
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
    tc::mma_xb<D, kBk>(acc, s, v_s + st * kBk * kLd, lane);
    __syncthreads();  // every warp is done with stage st before its reload
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = tc::quad_sum(l[i]);
    const int t = rows[i];
    if (t >= Tq) continue;
    const float l_safe = li > 0.f ? li : 1.f;
    __nv_bfloat16* orow = o + (static_cast<size_t>(b) * Tq + t) * tok + h * D;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + c2) =
          __floats2bfloat162_rn(acc[n][2 * i] / l_safe,
                                acc[n][2 * i + 1] / l_safe);
    if (c2 == 0)
      lse[static_cast<size_t>(bh) * Tq + t] =
          li > 0.f ? m[i] * kLn2 + logf(l_safe) : -kNegInf;
  }
}

// ---- bf16, D = 64 and 128: warp-specialised wgmma + TMA (see the header)

constexpr int kWgRows = 128;     // query rows a block: two consumers of 64
constexpr int kWgKeys = 128;     // keys a tile
// stages of the K/V ring: tile j - 1's V is still read while tile j's
// K is, and a load must stay in flight behind them: 4 at D = 64 (144 KB
// of tiles), 3 at D = 128 (224 KB)
template <int D>
__host__ __device__ constexpr int kv_stages() {
  return D <= 64 ? 4 : 3;
}
constexpr int kWgThreads = 384;  // the producer warpgroup and two consumers
constexpr int kConsumers = 256;  // consumer threads
// registers a thread: 40 x 128 + 232 x 256 <= 65536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// named barriers kTurn + c: consumer c's turn at the tensor cores
// (barrier 0 is __syncthreads)
constexpr int kTurn = 1;

template <int D>
struct WgSmem {
  // 1024-byte aligned tiles of D / 64 boxes [rows][64] (128-byte swizzle)
  __nv_bfloat16 q[kWgRows * D];
  __nv_bfloat16 k[kv_stages<D>()][kWgKeys * D];
  __nv_bfloat16 v[kv_stages<D>()][kWgKeys * D];
  uint64_t q_full, full[kv_stages<D>()], empty[kv_stages<D>()];
};

template <int D>
constexpr size_t wg_smem_bytes() {
  return sizeof(WgSmem<D>) + 1024;  // + the slack align1024 may skip
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (hop::smem_u32(p) & 1023)) & 1023);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const uint8_t* __restrict__ kv_mask,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int Tq, int Tk, int H,
                           float scale, int causal) {
  constexpr int kBox = kWgKeys * 64;  // elements of a [128][64] box
  constexpr int kStages = kv_stages<D>();
  constexpr int kNs = kWgKeys / 8;    // n8 blocks of a score row
  constexpr int kNo = D / 8;          // n8 blocks of an output row
  extern __shared__ uint8_t smem_raw[];
  WgSmem<D>& sm = *reinterpret_cast<WgSmem<D>*>(align1024(smem_raw));
  // a head's query tiles are neighbours in the grid, so the blocks in
  // flight share their K and V through L2; within a head the last query
  // tiles carry the most causal work and start first
  const int n_tiles = (Tq + kWgRows - 1) / kWgRows;
  const int bh = blockIdx.x / n_tiles;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int q0 = (n_tiles - 1 - blockIdx.x % n_tiles) * kWgRows;
  const int q_last = min(q0 + kWgRows, Tq) - 1;
  int nk = (Tk + kWgKeys - 1) / kWgKeys;
  if (causal) nk = min(nk, q_last / kWgKeys + 1);
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
      hop::mbar_arrive_expect_tx(&sm.q_full, kWgRows * D * 2);
      for (int x = 0; x < D / 64; ++x)
        hop::tma_load_3d(sm.q + x * kWgRows * 64, &tm_q, &sm.q_full,
                         h * D + 64 * x, q0, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % kStages;
        // the first pass over the ring finds every stage free
        hop::mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        hop::mbar_arrive_expect_tx(&sm.full[s], 2 * kWgKeys * D * 2);
        for (int x = 0; x < D / 64; ++x) {
          hop::tma_load_3d(sm.k[s] + x * kBox, &tm_k, &sm.full[s],
                           h * D + 64 * x, j * kWgKeys, b);
          hop::tma_load_3d(sm.v[s] + x * kBox, &tm_v, &sm.full[s],
                           h * D + 64 * x, j * kWgKeys, b);
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
  const float scale2 = scale * tc::kLog2e;  // to base-2 units
  // this consumer's 64 rows of the Q tile, in every box
  const __nv_bfloat16* qs = sm.q + 64 * cw * 64;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // per lane row: running max (raw scores) and this lane's part of l
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // shared-memory descriptors, built once: a k16 step or a stage moves
  // a descriptor by its byte offset >> 4 (hopper.cuh)
  const uint64_t q_desc = hop::desc_sw128(qs, 16, 1024);
  const uint64_t k_desc = hop::desc_sw128(sm.k[0], 16, 1024);
  const uint64_t v_desc = hop::desc_sw128(sm.v[0], kBox * 2, 1024);
  constexpr uint64_t kStageStep = kWgKeys * D * 2 / 16;  // one K/V stage
  // the tile's scores: S = Q . K^T of tile j into s (K-major A and B),
  // in raw units (the scale is folded into the exponent)
  float s[kWgKeys / 2];
  auto issue_scores = [&](int j) {
    const uint64_t kd = k_desc + (j % kStages) * kStageStep;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // box kk / 4 (kBox elements), k16 step kk % 4 (32 bytes)
      hop::wgmma_ss<kWgKeys>(
          s, q_desc + ((kk / 4) * kWgRows * 128 + (kk % 4) * 32) / 16,
          kd + ((kk / 4) * kBox * 2 + (kk % 4) * 32) / 16, kk > 0);
    }
  };
  // P of the last tile, bf16 A operands of its P . V, which runs while
  // the next tile's softmax does
  uint32_t pa[kWgKeys / 16][4];
  // O += P(j) . V(j), V's rows the k dimension (MN-major, 16 rows a step)
  auto issue_pv = [&](int j) {
    const uint64_t vd = v_desc + (j % kStages) * kStageStep;
#pragma unroll
    for (int kk = 0; kk < kWgKeys / 16; ++kk)  // 16 rows of 128 bytes
      hop::wgmma_rs<D>(acc, pa[kk], vd + kk * 16 * 128 / 16);
  };
  // masks and exponentials of tile j in s: p in s, the rescale of the
  // running sums in alpha, this tile's row sums in ls
  float alpha[2], ls[2][2];
  auto softmax = [&](int j) {
    const int k0 = j * kWgKeys;
    // keys past Tk, masked keys, or (causal) keys past the warp's first
    // row: only then is any key of this tile dead for this warp.  The
    // test is hoisted out of the element loops, and inside them it is
    // branch-free: a per-element branch costs each score a convergence
    // barrier (BSSY/BSYNC), more than its exponential
    const bool edge = k0 + kWgKeys > Tk || mb != nullptr ||
                      (causal && k0 + kWgKeys - 1 > q0 + r0);
    if (edge) {
      // bit 2n + c: key k0 + 8n + c2 + c is in range and not masked (the
      // lane's keys are the same for both its rows)
      uint32_t keep = 0;
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          keep |= static_cast<uint32_t>(k0 + n * 8 + c2 + c < Tk)
                  << (2 * n + c);
      if (mb != nullptr) {
#pragma unroll
        for (int n = 0; n < kNs; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            keep &= ~(static_cast<uint32_t>(
                          mb[min(k0 + n * 8 + c2 + c, Tk - 1)] == 0)
                      << (2 * n + c));
      }
#pragma unroll
      for (int n = 0; n < kNs; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = k0 + n * 8 + c2 + (e & 1);
          const bool dead = ((keep >> (2 * n + (e & 1))) & 1u) == 0u ||
                            (causal && t > rows[e / 2]);
          s[4 * n + e] = dead ? kNegInf : s[4 * n + e];
        }
    }
    // row maxima of the raw scores (the scale is positive), four
    // independent chains a row (max is exact in any order)
    float mx[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx[i][c] = kNegInf;
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e / 2][(n % 2) * 2 + (e & 1)] =
            fmaxf(mx[e / 2][(n % 2) * 2 + (e & 1)], s[4 * n + e]);
    float m_sub[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float tile_max = fmaxf(fmaxf(mx[i][0], mx[i][1]),
                                   fmaxf(mx[i][2], mx[i][3]));
      const float m_new = fmaxf(m[i], tc::quad_max(tile_max));
      // a row with nothing live yet subtracts 0 (the m_sub guard), in
      // base-2 units
      m_sub[i] = m_new > kNegInf * 0.5f ? m_new * scale2 : 0.f;
      alpha[i] = hop::ex2((m[i] - m_new) * scale2);
      m[i] = m_new;
    }
    // p in f32, the row sums in two chains a row
#pragma unroll
    for (int i = 0; i < 2; ++i) ls[i][0] = ls[i][1] = 0.f;
#pragma unroll
    for (int n = 0; n < kNs; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = hop::ex2(fmaf(s[4 * n + e], scale2, -m_sub[e / 2]));
        ls[e / 2][n % 2] += p;
        s[4 * n + e] = p;
      }
  };
  // fold tile j's softmax in once the last P . V has landed: rescale l
  // and O, and round p to bf16 (the TPU cast point) straight into A
  // operands: n8 blocks 2kk and 2kk + 1 are the k16 step kk of P . V
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * alpha[i] + ls[i][0] + ls[i][1];
#pragma unroll
      for (int n = 0; n < kNo; ++n) {
        acc[4 * n + 2 * i] *= alpha[i];
        acc[4 * n + 2 * i + 1] *= alpha[i];
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

  // Turn j issues S(j) and P(j-1) . V(j-1) together, then runs tile j's
  // softmax while P(j-1) . V(j-1) is on the tensor cores.  The consumers
  // take the turns in order (named barriers), so their products reach
  // the tensor cores one consumer at a time and one consumer's masking
  // and exponentials run while the other's products do (issuing a wgmma
  // holds the warp about as long as the product runs).  The first and
  // last turns are peeled: every wgmma of the loop is unconditional,
  // which ptxas needs to keep them asynchronous (under a branch it
  // serialises each one).  Consumer 0 takes the first turn.
  if (nk > 0) {
    if (cw == 1) hop::bar_arrive(kTurn, kConsumers);
    hop::mbar_wait(&sm.q_full, 0);
    hop::mbar_wait(&sm.full[0], 0);
    hop::bar_sync(kTurn + cw, kConsumers);
    hop::wgmma_fence();
    issue_scores(0);
    hop::wgmma_commit();
    hop::bar_arrive(kTurn + (cw ^ 1), kConsumers);
    hop::wgmma_wait<0>();
    hop::fence_regs(s);
    softmax(0);
    fold();
    for (int j = 1; j < nk; ++j) {
      hop::mbar_wait(&sm.full[j % kStages], (j / kStages) & 1);
      hop::bar_sync(kTurn + cw, kConsumers);
      hop::wgmma_fence();
      issue_scores(j);
      hop::wgmma_commit();
      issue_pv(j - 1);
      hop::wgmma_commit();
      hop::bar_arrive(kTurn + (cw ^ 1), kConsumers);
      hop::wgmma_wait<1>();  // S(j) has landed; P(j-1) . V(j-1) runs on
      hop::fence_regs(s);
      softmax(j);
      hop::wgmma_wait<0>();  // P(j-1) . V(j-1) has landed
      hop::fence_regs(acc);
      hop::fence_regs(pa);
      hop::mbar_arrive(&sm.empty[(j - 1) % kStages]);  // may be refilled
      fold();
    }
    // the last P . V (consumer 1's last turn has no successor)
    hop::bar_sync(kTurn + cw, kConsumers);
    hop::wgmma_fence();
    issue_pv(nk - 1);
    hop::wgmma_commit();
    if (cw == 0) hop::bar_arrive(kTurn + 1, kConsumers);
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    hop::fence_regs(pa);
    hop::mbar_arrive(&sm.empty[(nk - 1) % kStages]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = tc::quad_sum(l[i]);
    const int t = rows[i];
    if (t >= Tq) continue;
    const float l_safe = li > 0.f ? li : 1.f;
    __nv_bfloat16* orow =
        o + (static_cast<size_t>(b) * Tq + t) * H * D + h * D;
#pragma unroll
    for (int n = 0; n < kNo; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + c2) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] / l_safe,
                                acc[4 * n + 2 * i + 1] / l_safe);
    if (c2 == 0)
      lse[static_cast<size_t>(bh) * Tq + t] =
          li > 0.f ? m[i] * scale + logf(l_safe) : -kNegInf;
  }
}

// the f32 kernel (T = float) or the mma.sync bf16 kernel, 128 threads,
// one block per 64-row query tile
template <typename T, int D>
cudaError_t launch_rowwise(const void* q, const void* k, const void* v,
                           const uint8_t* mask, void* o, float* lse, int B,
                           int Tq, int Tk, int H, int causal, float scale,
                           cudaStream_t stream) {
  const dim3 grid(B * H, (Tq + kBq - 1) / kBq);
  void (*kernel)(const T*, const T*, const T*, const uint8_t*, T*, float*,
                 int, int, int, float, int);
  size_t smem;
  if constexpr (std::is_same_v<T, float>) {
    kernel = flash_fwd_kernel<float, D>;
    smem = smem_bytes<D>();
  } else {
    kernel = flash_fwd_bf16_kernel<D>;
    smem = bf16_smem_bytes<D>();
  }
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, Tq, Tk, H,
      scale, causal);
  return cudaGetLastError();
}

// the wgmma kernel: q, k and v through tensor maps
template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const uint8_t* mask, void* o, float* lse, int B,
                         int Tq, int Tk, int H, int causal, float scale,
                         cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  // with no keys the K and V maps are never read: q stands in for them
  cudaError_t e = hop::map_bthd(&mq, q, B, Tq, H, D, kWgRows);
  if (e == cudaSuccess)
    e = hop::map_bthd(&mk, Tk > 0 ? k : q, B, Tk, H, D, kWgKeys);
  if (e == cudaSuccess)
    e = hop::map_bthd(&mv, Tk > 0 ? v : q, B, Tk, H, D, kWgKeys);
  if (e != cudaSuccess) return e;
  constexpr size_t smem = wg_smem_bytes<D>();
  e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const long long blocks =
      static_cast<long long>(B) * H * ((Tq + kWgRows - 1) / kWgRows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_wgmma_kernel<D><<<static_cast<unsigned>(blocks), kWgThreads,
                              smem, stream>>>(
      mq, mk, mv, mask, static_cast<__nv_bfloat16*>(o), lse, Tq, Tk, H,
      scale, causal);
  return cudaGetLastError();
}

// The head dims the kernels are instantiated for: the multiples of 32 up
// to 128, the set every kernel of the port takes.  bf16 picks its kernel
// by D up front: wgmma at 64 and 128, mma.sync at 32 and 96.  Any other
// D is refused; the Python dispatch routes it to the plain version first.
cudaError_t launch_d(int bf16, int D, const void* q, const void* k,
                     const void* v, const uint8_t* mask, void* o, float* lse,
                     int B, int Tq, int Tk, int H, int causal, float scale,
                     cudaStream_t stream) {
#define FLASH_ARGS q, k, v, mask, o, lse, B, Tq, Tk, H, causal, scale, stream
  switch (D) {
    case 32:
      return bf16 ? launch_rowwise<__nv_bfloat16, 32>(FLASH_ARGS)
                  : launch_rowwise<float, 32>(FLASH_ARGS);
    case 64:
      return bf16 ? launch_wgmma<64>(FLASH_ARGS)
                  : launch_rowwise<float, 64>(FLASH_ARGS);
    case 96:
      return bf16 ? launch_rowwise<__nv_bfloat16, 96>(FLASH_ARGS)
                  : launch_rowwise<float, 96>(FLASH_ARGS);
    case 128:
      return bf16 ? launch_wgmma<128>(FLASH_ARGS)
                  : launch_rowwise<float, 128>(FLASH_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

}  // namespace

// q [B, Tq, H, D], k, v [B, Tk, H, D], all f32 (bf16 = 0) or bf16 (1),
// contiguous and 16-byte aligned (cp.async, TMA); kv_mask [B, Tk] bool (one
// byte each) or null for all live; o [B, Tq, H, D] in the operand type;
// lse [B*H, Tq] f32.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* kv_mask,
                                   void* o, void* lse, int bf16, int B,
                                   int Tq, int Tk, int H, int D, int causal,
                                   float scale, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 0 || H < 1 ||
      static_cast<long long>(B) * H > 0x7fffffffLL ||
      (Tq + kBq - 1) / kBq > 65535)
    return cudaErrorInvalidValue;
  return launch_d(bf16, D, q, k, v, static_cast<const uint8_t*>(kv_mask), o,
                  static_cast<float*>(lse), B, Tq, Tk, H, causal, scale,
                  static_cast<cudaStream_t>(stream));
}
