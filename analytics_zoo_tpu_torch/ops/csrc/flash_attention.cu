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
// What bounds the work on this card.  At the arena's prefill shapes
// (B=8, T=512, H=12, D=64, bf16, causal) the roofline bound is the bytes:
// q, k, v and o once plus lse, about 25 MB, 7.6 us at 3.35 TB/s; the
// causal q.k and p.v products are about 3.2 GFLOP, 3.3 us at the bf16
// tensor-core rate.  This kernel does the products on CUDA cores in f32
// (the H100 has about 67 TFLOP/s there, 1/15 of the bf16 tensor rate),
// so it is held back by the products, not the bytes: about 50 us at the
// f32 peak, more with the shared-memory traffic of scalar operands.
//
// How the design treats that.  One CUDA block per (query tile of 64
// rows, b*H + h): the TPU grid's sequential axis over key blocks is the
// loop over key tiles of 64 inside the block, and under causal masking
// it stops at the tile's causal frontier, min(nk, q_last / 64 + 1) (the
// TPU kernel's _block_live skip).  Each key tile of K and V is read
// from device memory once per query tile and kept in shared memory as
// f32; each of the 128 threads computes a 4 x 8 block of the 64 x 64
// score tile (4 query rows, 8 keys), so every shared-memory operand
// feeds several multiply-adds, and the online-softmax state of a row
// lives in the 8 lanes that hold its scores.  Keys past Tk or with
// kv_mask == 0 are masked in place.  The heaviest causal tiles (the
// last query tiles) are scheduled first.
//
// Known shortfall, left for later work: CUDA-core f32 products instead
// of tensor cores (mma.sync or wgmma on bf16 operands), no cp.async/TMA
// pipelining of the next key tile behind the current one's products,
// and scalar rather than vector shared-memory loads.
//
// Plain C interface (loaded with ctypes): flash_attention_fwd returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBq = 64;          // query rows per block
constexpr int kBk = 64;          // keys per tile
constexpr int kRows = 4;         // query rows per thread: 16 row groups
constexpr int kKeys = 8;         // keys per thread: 8 key lanes
constexpr int kLanes = kBk / kKeys;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as the p.V product sees it: rounded to v's storage type
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, void* o, float* lse, int B, int Tq,
                   int Tk, int H, int causal, float scale,
                   cudaStream_t stream) {
  const dim3 grid(B * H, (Tq + kBq - 1) / kBq);
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
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

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const uint8_t* mask, void* o, float* lse, int B, int Tq,
                     int Tk, int H, int causal, float scale,
                     cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, mask, o, lse, B, Tq, Tk, H, causal, scale,
                         stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, mask, o, lse, B, Tq, Tk, H, causal,
                          scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, Tq, H, D], k, v [B, Tk, H, D], all f32 (bf16 = 0) or bf16 (1),
// contiguous; kv_mask [B, Tk] bool (one byte each) or null for all live;
// o [B, Tq, H, D] in the operand type; lse [B*H, Tq] f32.
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
