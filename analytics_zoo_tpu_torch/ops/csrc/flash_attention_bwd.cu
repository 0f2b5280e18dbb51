// Dense flash-attention backward, for Hopper (sm_90a): two kernels.
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
//   lse is what the forward kernel returns, delta is computed outside the
//   kernels as the reference does).  Scores s = scale * q.k in f32, masked
//   keys and keys past Tk NEG_INF = -1e30, p = exp(s - lse) (a fully
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
// 26 us, against 76 MB, 23 us.  Both are bound by the products, barely.
// These kernels do the products on CUDA cores in f32 (about 67 TFLOP/s,
// 1/15 of the tensor rate), so they sit far above that bound, held back
// by the products and the shared-memory loads that feed them.
//
// How the design treats that.  The TPU grid's sequential axis becomes a
// loop inside a block: the dq kernel walks the key tiles of its 64 query
// rows up to their causal frontier min(nk, q_last / 64 + 1) (the TPU
// kernel's _block_live skip); the dk/dv kernel walks the query tiles that
// can see its 64 keys, from tile k0 / 64 (the first tile whose last row
// qi*64 + 63 >= k0) to the end.  The operand tiles live in shared memory
// as f32, padded by one column so column reads are conflict-free; each of
// the 256 threads computes a 2 x 8 block of every 64 x 64 score tile
// (2 rows, 8 columns), and the rounded p / ds tiles go back through
// shared memory to feed the gradient products, each row of them written
// and read by the 8 lanes of one warp.  Per-row lse and delta sit in
// registers (dq) or shared memory (dk/dv).  The dq kernel starts the
// heaviest causal tiles (the last query tiles) first; the dk/dv kernel's
// heaviest tiles (the first key tiles) are first already.  Shared memory
// per block: dq 81 KB (D=64) / 145 KB (D=128), dk/dv 98 KB / 162 KB, so
// the launch raises the dynamic shared-memory limit first and returns its
// error if the card refuses.
//
// Known shortfall, left for later work: CUDA-core f32 products instead of
// tensor cores (mma.sync or wgmma on bf16 operands), no cp.async/TMA
// pipelining of the next tile behind the current one's products, scalar
// rather than vector shared-memory loads, and one or two blocks per SM at
// these shared-memory sizes.
//
// Plain C interface (loaded with ctypes): flash_attention_bwd_dq and
// flash_attention_bwd_dkv each return cudaGetLastError() after their
// launch, or cudaErrorInvalidValue for a shape they do not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kTile = 64;              // query rows / keys per tile
constexpr int kRows = 2;               // tile rows per thread: 32 groups
constexpr int kCols = 8;               // tile columns per thread
constexpr int kLanes = kTile / kCols;  // 8 lanes share a row group
constexpr int kTld = kTile + 1;        // padded row of a p / ds tile

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

// x as a product sees it after a cast to the operand type
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
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
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(dq), a.Tq, a.Tk, a.H, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  const dim3 grid(a.B * a.H, (a.Tk + kTile - 1) / kTile);
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.mask, static_cast<const T*>(a.dout),
      a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.Tq, a.Tk,
      a.H, a.scale, a.causal);
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
// bf16 (1), contiguous; kv_mask [B, Tk] bool (one byte each) or null for
// all live; lse, delta [B*H, Tq] f32; dq [B, Tq, H, D] in the operand type.
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
  if (D == 64)
    return bf16 ? launch_dq<__nv_bfloat16, 64>(a, dq)
                : launch_dq<float, 64>(a, dq);
  if (D == 128)
    return bf16 ? launch_dq<__nv_bfloat16, 128>(a, dq)
                : launch_dq<float, 128>(a, dq);
  return cudaErrorInvalidValue;
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
  if (D == 64)
    return bf16 ? launch_dkv<__nv_bfloat16, 64>(a, dk, dv)
                : launch_dkv<float, 64>(a, dk, dv);
  if (D == 128)
    return bf16 ? launch_dkv<__nv_bfloat16, 128>(a, dk, dv)
                : launch_dkv<float, 128>(a, dk, dv);
  return cudaErrorInvalidValue;
}
