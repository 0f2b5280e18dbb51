// Paged attention over a block-pool KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel analytics_zoo_tpu/ops/flash_attention.py:
// _paged_fused_kernel (launched by _paged_attention_fused).  It computes
// the same function as the plain PyTorch version, paged_attention_ref in
// analytics_zoo_tpu_torch/ops/flash_attention.py:
//
//   query s of row b, head h*G + g, attends logical cache positions
//   p <= pos[b] + s; position p of row b lives in physical block
//   tables[b, p / bs] at offset p % bs of a head-major [N, KH, bs, D]
//   pool.  Online softmax in f32 with NEG_INF = -1e30 and scale
//   1/sqrt(D); output f32 [B, S, H, D].  int8 pools carry bf16 scales
//   [N, KH, bs]: k-scales multiply the logit columns, v-scales fold into
//   p before p.V.  f32/bf16 pools round p to the pool dtype before p.V,
//   as the TPU kernel and the gather path both do.
//
// What bounds it on this card: memory bytes.  Each (row, kv head) must
// read its live K/V blocks once, and per byte read the work is a few
// multiply-adds per query row — far below the ~295 operations per byte
// at which an H100 stops waiting on memory, for decode (one query row
// per kv head) and for prefill alike.  The design reads every live K/V
// tile from device memory once per block of query rows: one CUDA block
// per (query-row tile of 16 rows, kv head, batch row) stages the
// [bs, D] K and V tiles of one logical block at a time in shared memory
// (converted to f32), and every query row of the tile, including all G
// query heads of a grouped kv head, reuses them from there.  The TPU
// grid's sequential axis over logical blocks is the loop over j inside
// the block, bounded by the tile's own causal frontier and by the table
// width M; the physical block id is read from the table in the loop,
// which replaces scalar prefetch.  Rows of one warp keep their
// online-softmax state (m, l and a [D] accumulator spread over the
// lanes) in registers.
//
// Left for later work: wgmma, TMA and a ring of tiles in flight,
// split-K across SMs for long caches with few rows, and CUDA graphs
// against launch overhead.
//
// Plain C interface (loaded with ctypes): paged_attention_fwd returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kMaxBs = 64;                    // two key positions per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// p as the p.V product sees it: rounded to the pool's storage type for
// bf16 pools; f32 pools and the int8 path (p * v_scale) keep f32.
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}
__device__ __forceinline__ float round_p(float p, int8_t) { return p; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kWarps * 32)
    paged_attention_kernel(const TQ* __restrict__ q,
                           const TKV* __restrict__ kpool,
                           const TKV* __restrict__ vpool,
                           const __nv_bfloat16* __restrict__ kscale,
                           const __nv_bfloat16* __restrict__ vscale,
                           const int* __restrict__ tables,
                           const int* __restrict__ pos,
                           float* __restrict__ out, int S, int H, int KH,
                           int bs, int M, float scale) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kDPerLane = D / 32;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int SG = S * G;  // query rows of this (b, h): row r = s*G + g
  const int row0 = tile * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ float smem[];
  float* q_s = smem;                   // [kRows][D]
  float* k_s = q_s + kRows * D;        // [bs][D + 1]: padded, lane = key
  float* v_s = k_s + bs * (D + 1);     // [bs][D]: lane = output dim
  float* ks_s = v_s + bs * D;          // [bs] int8 k-scales
  float* vs_s = ks_s + bs;             // [bs] int8 v-scales

  for (int idx = threadIdx.x; idx < kRows * D; idx += blockDim.x) {
    const int r = row0 + idx / D, d = idx % D;
    float val = 0.f;
    if (r < SG) {
      const int s = r / G, g = r % G;
      val = to_f32(q[((static_cast<size_t>(b) * S + s) * H + h * G + g) * D +
                     d]);
    }
    q_s[idx] = val;
  }

  const int pos_b = pos[b];
  // the tile's last token bounds the blocks any of its rows attends;
  // never past the table width (a sliced table ends there)
  const int s_last = (min(row0 + kRows, SG) - 1) / G;
  const int nblk = min(M, (pos_b + s_last) / bs + 1);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) acc[rr][c] = 0.f;
  }

  const size_t tile_elems = static_cast<size_t>(bs) * D;
  for (int j = 0; j < nblk; ++j) {
    const size_t blk = static_cast<size_t>(tables[b * M + j]) * KH + h;
    const TKV* kt = kpool + blk * tile_elems;
    const TKV* vt = vpool + blk * tile_elems;
    __syncthreads();  // the previous tile is consumed by every warp
    for (int idx = threadIdx.x; idx < bs * D; idx += blockDim.x) {
      k_s[(idx / D) * (D + 1) + idx % D] = to_f32(kt[idx]);
      v_s[idx] = to_f32(vt[idx]);
    }
    if (kQuant) {
      for (int i = threadIdx.x; i < bs; i += blockDim.x) {
        ks_s[i] = __bfloat162float(kscale[blk * bs + i]);
        vs_s[i] = __bfloat162float(vscale[blk * bs + i]);
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = row0 + warp * kRowsPerWarp + rr;
      const int frontier = pos_b + r / G;  // last live logical position
      // warp-uniform: a row past S*G, or a block wholly past this row's
      // frontier, contributes nothing
      if (r >= SG || j * bs > frontier) continue;
      const float* qr = q_s + (warp * kRowsPerWarp + rr) * D;
      float p[2];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = lane + 32 * t;
        float sv = kNegInf;
        if (i < bs && j * bs + i <= frontier) {
          const float* kr = k_s + i * (D + 1);
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          sv = scale * dot;
          if (kQuant) sv *= ks_s[i];
        }
        p[t] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[rr], mx);
      // a row with nothing live yet subtracts 0, so exp(NEG_INF)
      // underflows to 0 instead of exp(0) = 1
      const float m_sub = m_new > kNegInf * 0.5f ? m_new : 0.f;
      const float alpha = expf(m[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        p[t] = expf(p[t] - m_sub);
        psum += p[t];
      }
      psum = warp_sum(psum);
      m[rr] = m_new;
      l[rr] = l[rr] * alpha + psum;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = lane + 32 * t;
        if (kQuant)
          p[t] = i < bs ? p[t] * vs_s[i] : 0.f;
        else
          p[t] = round_p(p[t], TKV());
      }
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) acc[rr][c] *= alpha;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int n = min(32, bs - 32 * t);
        for (int u = 0; u < n; ++u) {
          const float pu = __shfl_sync(0xffffffffu, p[t], u);
          const float* vr = v_s + (32 * t + u) * D;
#pragma unroll
          for (int c = 0; c < kDPerLane; ++c)
            acc[rr][c] = fmaf(pu, vr[lane + 32 * c], acc[rr][c]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = row0 + warp * kRowsPerWarp + rr;
    if (r >= SG) continue;
    const int s = r / G, g = r % G;
    const float inv = 1.f / (l[rr] > 0.f ? l[rr] : 1.f);
    float* o = out + ((static_cast<size_t>(b) * S + s) * H + h * G + g) * D;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) o[lane + 32 * c] = acc[rr][c] * inv;
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const int* tables,
                   const int* pos, float* out, int B, int S, int H, int KH,
                   int bs, int M, cudaStream_t stream) {
  const int rows = S * (H / KH);
  const dim3 grid((rows + kRows - 1) / kRows, KH, B);
  const size_t smem =
      sizeof(float) * (kRows * D + bs * (D + 1) + bs * D + 2 * bs);
  auto kernel = paged_attention_kernel<TQ, TKV, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), tables, pos, out, S, H, KH, bs,
      M, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const int* tables,
                     const int* pos, float* out, int B, int S, int H, int KH,
                     int bs, int M, cudaStream_t stream) {
  if (D == 64)
    return launch<TQ, TKV, 64>(q, k, v, ks, vs, tables, pos, out, B, S, H,
                               KH, bs, M, stream);
  if (D == 128)
    return launch<TQ, TKV, 128>(q, k, v, ks, vs, tables, pos, out, B, S, H,
                                KH, bs, M, stream);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_kv(int kv_kind, int D, const void* q, const void* k,
                      const void* v, const void* ks, const void* vs,
                      const int* tables, const int* pos, float* out, int B,
                      int S, int H, int KH, int bs, int M,
                      cudaStream_t stream) {
  switch (kv_kind) {
    case 0:
      return launch_d<TQ, float>(D, q, k, v, ks, vs, tables, pos, out, B, S,
                                 H, KH, bs, M, stream);
    case 1:
      return launch_d<TQ, __nv_bfloat16>(D, q, k, v, ks, vs, tables, pos,
                                         out, B, S, H, KH, bs, M, stream);
    case 2:
      return launch_d<TQ, int8_t>(D, q, k, v, ks, vs, tables, pos, out, B, S,
                                  H, KH, bs, M, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, S, H, D] f32 (q_bf16 = 0) or bf16 (1); k, v [N, KH, bs, D] of
// kv_kind 0 = f32, 1 = bf16, 2 = int8 with bf16 scales ks, vs [N, KH, bs];
// tables [B, M] int32; pos [B] int32; out [B, S, H, D] f32.
extern "C" int paged_attention_fwd(const void* q, int q_bf16, const void* k,
                                   const void* v, const void* ks,
                                   const void* vs, int kv_kind,
                                   const void* tables, const void* pos,
                                   void* out, int B, int S, int H, int KH,
                                   int D, int bs, int M, void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0 || M < 1 || bs < 1 ||
      bs > kMaxBs || B > 65535 || KH > 65535 || (kv_kind == 2 && !(ks && vs)))
    return cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return launch_kv<__nv_bfloat16>(kv_kind, D, q, k, v, ks, vs, t, p, o, B,
                                    S, H, KH, bs, M, st);
  return launch_kv<float>(kv_kind, D, q, k, v, ks, vs, t, p, o, B, S, H, KH,
                          bs, M, st);
}
