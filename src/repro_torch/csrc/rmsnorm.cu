// Fused RMSNorm x scale over the last dim, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` (launched by
// `rmsnorm_kernel`) in src/repro/kernels/rmsnorm/kernel.py: y = x *
// rsqrt(mean(x^2) + eps) * scale, statistics in fp32, output in x's dtype.
//
// Bound on an H100 SXM: memory. Each element is read once and written once
// against about four flops, so at the prefill shape [2048 rows, 2048] bf16
// the kernel must move 16.8 MB: about 5.0 us at 3.35 TB/s.
//
// Design: one block per row, so a row's sum never leaves the SM. Threads
// move 16-byte vectors (8 bf16 or 4 fp32 values), neighbouring threads on
// neighbouring addresses. Pass 1 sums squares in fp32, reduced by warp
// shuffles and then across the block's warps through shared memory. Pass 2
// reads the row again (a row of 4-8 KB is still in L1/L2) and writes
// (x * rsqrt(mean + eps)) * scale, rounded once to x's dtype. The TPU
// kernel's 256-row blocks and padded tail have no counterpart: the grid is
// exactly one block per row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Vec16;  // values of T in one 16-byte vector
template <>
struct Vec16<float> {
  static constexpr int N = 4;
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = r;
}

// Sum over the block; every thread gets the total. blockDim.x % 32 == 0.
__device__ __forceinline__ float block_sum(float v, float* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                               T* __restrict__ out, int dim, float eps) {
  constexpr int N = Vec16<T>::N;
  __shared__ float partial[32];
  const T* xr = x + (size_t)blockIdx.x * dim;
  T* outr = out + (size_t)blockIdx.x * dim;
  const int nvec = dim / N;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[N];
    load16(xr + i * N, v);
#pragma unroll
    for (int j = 0; j < N; ++j) ss = fmaf(v[j], v[j], ss);
  }
  const float r = rsqrtf(block_sum(ss, partial) / (float)dim + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[N], s[N];
    load16(xr + i * N, v);
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      float s4[4];
      load16(scale + i * N + j, s4);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j + e] = s4[e];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = (v[j] * r) * s[j];
    store16(outr + i * N, v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int64_t rows, int dim, float eps,
                   cudaStream_t stream) {
  const int nvec = dim / Vec16<T>::N;
  int threads = (nvec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  rmsnorm_kernel<T><<<(unsigned)rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out), dim, eps);
  return cudaGetLastError();
}

}  // namespace

// x and out: [rows, dim] contiguous, 16-byte aligned, dim a multiple of the
// vector width; scale: [dim] fp32. Returns cudaGetLastError() after launch.
extern "C" int rmsnorm_forward(const void* x, const void* scale, void* out, int64_t rows, int dim,
                               float eps, int is_bf16, void* stream) {
  if (rows == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(x, scale, out, rows, dim, eps, s)
                       : launch<float>(x, scale, out, rows, dim, eps, s));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
