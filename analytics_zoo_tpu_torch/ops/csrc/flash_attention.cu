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
// Two kernels, chosen by the operand type in flash_attention_fwd (an
// explicit dispatch, not a fallback):
//
// bf16 (every main path: serving and training compute in bf16):
// flash_fwd_bf16_kernel, FlashAttention-2's design on the tensor cores.
// What bounds the work: at the training shape (B=8, T=1024, H=12, D=64,
// causal) the bytes are 50 MB (q, k, v, o once, lse), 15 us at
// 3.35 TB/s, and the causal q.k and p.v products 12.9 GFLOP, 13 us at the
// 989 TFLOP/s bf16 tensor rate: the two bounds meet, so the products must
// run on tensor cores and the loads must stay in flight behind them.
// One block of 4 warps per (64-row query tile, b*H + h), the heaviest
// causal tiles first; each warp owns 16 query rows.  The block walks the
// key tiles of 64 up to the tile's causal frontier min(nk, q_last/64 + 1)
// (the TPU kernel's _block_live skip).
//   - Tensor cores: q.k and p.V are mma.sync m16n8k16 bf16 -> f32.  The
//     warp's Q A fragments are loaded once by ldmatrix and stay in
//     registers; K's B fragments come from ldmatrix on the K tile (its
//     rows are already the "col" operand), V's from ldmatrix.trans.
//   - P never leaves registers: two neighbouring n8 score accumulators,
//     rounded to bf16 (the TPU cast point) and packed, are one k16 A
//     fragment of p.V.  Row max and row sum reduce over the 4 lanes of a
//     quad; the row sum is reduced once, at the end.
//   - In flight: K and V tiles stay bf16 in shared memory ([64][D + 8],
//     conflict-free for ldmatrix), two stages filled by 16-byte cp.async;
//     tile j + 1 is copied while tile j is multiplied.  Rows past Tk are
//     zero-filled by the copy itself.
//   - Masks: the causal comparison runs only on a warp's diagonal tile;
//     the key mask is read as bytes, per tile, only when given; rows past
//     Tq are never written; a fully masked row keeps o = 0 and
//     lse = +1e30 exactly.
//   Shared memory: (64 + 4 x 64) rows of D + 8 bf16: 25 KB (D=32), 45 KB
//   (D=64), 65 KB (D=96), 85 KB (D=128).
// Where this stops, and what is left: on Hopper only wgmma reaches the
// full tensor-core rate, and cp.async spends a thread's instruction slots on
// every 16-byte copy.  wgmma (a warpgroup's 64-row product, B read from
// shared memory by the tensor cores themselves, asynchronous) and TMA
// (one thread moves a whole tile and an mbarrier reports it), with a
// producer warp and two consumer warpgroups, are the rest of the way to
// the card's rate.  The design stops at mma.sync because the dq kernel
// (flash_attention_bwd.cu) shares it: its 16-row warp tile and register
// fragments carry over unchanged.
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
// Plain C interface (loaded with ctypes): flash_attention_fwd returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// bf16 operands on the tensor cores (see the header)
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* o, float* lse, int B, int Tq,
                   int Tk, int H, int causal, float scale,
                   cudaStream_t stream) {
  const dim3 grid(B * H, (Tq + kBq - 1) / kBq);
  // the operand type picks the kernel: bf16 on the tensor cores, f32 on
  // the CUDA cores
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

// The head dims the kernels are instantiated for: the multiples of 32 up
// to 128, the set every kernel of the port takes.  Any other D is
// refused; the Python dispatch routes it to the plain version up front.
template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const uint8_t* mask, void* o, float* lse, int B, int Tq,
                     int Tk, int H, int causal, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, mask, o, lse, B, Tq, Tk, H, causal,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, mask, o, lse, B, Tq, Tk, H, causal,
                           scale, stream);
    case 96:
      return launch<T, 96>(q, k, v, mask, o, lse, B, Tq, Tk, H, causal,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, mask, o, lse, B, Tq, Tk, H, causal,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Tq, H, D], k, v [B, Tk, H, D], all f32 (bf16 = 0) or bf16 (1),
// contiguous and 16-byte aligned (cp.async); kv_mask [B, Tk] bool (one
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
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(D, q, k, v, mask, o, l, B, Tq, Tk, H,
                                   causal, scale, st);
  return launch_d<float>(D, q, k, v, mask, o, l, B, Tq, Tk, H, causal,
                         scale, st);
}
