// Forward flash attention with GQA, causal and sliding-window masks, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` (launched by
// `flash_attention_kernel`) in src/repro/kernels/flash_attention/kernel.py:
// online softmax with fp32 m, l and accumulator; kv head = h / (H / Hk);
// masked scores -1e30; output acc / max(l, 1e-30).
//
// Layout: q and out are [B, Sq, H, Dh], k and v are [B, Sk, Hk, Dh], all
// contiguous (the model's layout), so no transpose or padding copy is made.
//
// Bound on an H100 SXM at granite-3-2b prefill (B 4, S 512, H 32, Hk 8,
// Dh 64, causal, bf16): 21 MB of q, k, v and out (6.3 us at 3.35 TB/s)
// against 4.3 GFLOP on the causal half (4.3 us at 989 TFLOP/s bf16), so
// memory-bound at about 6.3 us.
//
// Design (simple and right first; tensor cores are later work):
// - One block of 128 threads per (q tile of 64 rows, head, batch). The loop
//   over kv tiles of 64 inside the block replaces the TPU's sequential kv
//   grid axis, and m, l and the accumulator live in registers instead of
//   VMEM scratch.
// - The loop stops at the causal diagonal and starts at the first tile the
//   window reaches: tiles masked for every row of the block are skipped.
//   For a row with at least one unmasked key (every row of self-attention,
//   which keeps its diagonal key) a skipped tile would have contributed
//   exp(-1e30 - m) = 0, so the output is unchanged.
// - q, k and v tiles are staged in shared memory as fp32 (rows padded by
//   one float so the strided reads below hit distinct banks). Thread
//   (ty, tx) owns rows 4ty..4ty+3 and key columns tx + 8j of the score
//   tile, and the same rows times head-dim columns tx + 8c of the
//   accumulator; a row's max and sum are reduced over the 8 lanes that
//   share it with warp shuffles. Both products are scalar fp32 FMAs.
// - Rounding follows the model's call site (src/repro/models/attention.py,
//   chunked_attention): q is scaled by 1/sqrt(Dh) and rounded to the input
//   dtype before q.k, and P is rounded to the input dtype before P.v.
// - Ragged Sq and Sk are masked (kpos < Sk, qpos < Sq); rows past Sk are
//   loaded as zeros and rows past Sq are not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Copy rows [row0, row0 + 64) of one head (rows `stride` elements apart)
// into dst[r * ld + d] as fp32, 16 bytes per load; rows >= n become zeros.
// With `scale` != 0 each value is scaled and rounded to T first.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, size_t stride, int row0, int n,
                                          float* dst, int ld, float scale) {
  constexpr int VN = 16 / sizeof(T);
  constexpr int PER_ROW = DH / VN;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VN;
    T vals[VN];
    if (row0 + r < n) {
      *reinterpret_cast<uint4*>(vals) =
          *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + c);
    } else {
      *reinterpret_cast<uint4*>(vals) = make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) {
      const float f = to_float(vals[e]);
      dst[r * ld + c + e] = scale != 0.f ? round_to<T>(f * scale) : f;
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int Sq, int Sk, int H, int Hk, float scale, int causal,
                     int window) {
  constexpr int LDQ = DH + 1, LDK = DH + 1, LDP = BK + 1, NC = DH / 8;
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][DH + 1]
  float* Ks = Qs + BQ * LDQ;     // [BK][DH + 1]
  float* Vs = Ks + BK * LDK;     // [BK][DH]
  float* Ps = Vs + BK * DH;      // [BQ][BK + 1]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)Hk * DH;
  const T* qb = q + (size_t)b * Sq * q_stride + (size_t)h * DH;
  const T* kb = k + (size_t)b * Sk * kv_stride + (size_t)hk * DH;
  const T* vb = v + (size_t)b * Sk * kv_stride + (size_t)hk * DH;
  T* ob = o + (size_t)b * Sq * q_stride + (size_t)h * DH;

  load_tile<T, DH>(qb, q_stride, q0, Sq, Qs, LDQ, scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;  // this lane's share of the row sum
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's Ks, Vs and Ps are no longer read
    load_tile<T, DH>(kb, kv_stride, k0, Sk, Ks, LDK, 0.f);
    load_tile<T, DH>(vb, kv_stride, k0, Sk, Vs, DH, 0.f);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        bool ok = kpos < Sk && qpos < Sq;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * LDP + tx + 8 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[kk * DH + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int qpos = q0 + ty * 4 + i;
    if (qpos < Sq) {
      const float denom = fmaxf(lt, 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c) store(ob + (size_t)qpos * q_stride + tx + 8 * c, acc[i][c] / denom);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
                   int Hk, float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t SMEM = sizeof(float) * (BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1));
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      Sq, Sk, H, Hk, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// q, out: [B, Sq, H, Dh]; k, v: [B, Sk, Hk, Dh]; contiguous, 16-byte
// aligned, one dtype. `scale` multiplies q (then rounded to the dtype);
// window <= 0 means no window. Dh is 64 or 128. Returns cudaGetLastError().
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o, int B,
                                       int Sq, int Sk, int H, int Hk, int Dh, float scale, int causal,
                                       int window, int is_bf16, void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && Dh == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Sk, H, Hk, scale, causal, window, s);
  if (is_bf16 && Dh == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, H, Hk, scale, causal, window, s);
  if (!is_bf16 && Dh == 64)
    return (int)launch<float, 64>(q, k, v, o, B, Sq, Sk, H, Hk, scale, causal, window, s);
  if (!is_bf16 && Dh == 128)
    return (int)launch<float, 128>(q, k, v, o, B, Sq, Sk, H, Hk, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
