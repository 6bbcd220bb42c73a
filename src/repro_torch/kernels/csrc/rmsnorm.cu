// Fused RMSNorm for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (_rmsnorm_kernel, launched by rmsnorm_rows): y = x * rsqrt(mean(x^2) + eps)
// * w, with the mean of squares in float32 and w read in float32.
//
// Bound on the H100: bytes.  Each row of d values is read once and written
// once (about 2 * d * sizeof(T) bytes against ~4 flops per value), far
// below the ~295 flops per byte where the tensor cores would limit.  Design:
// one block of 256 threads per row, every thread moving 16 bytes per load
// and store, the sum of squares reduced by warp shuffles and one shared
// array.  The second pass re-reads the row, which stays in L1, so device
// memory sees one read and one write per value.
#include "common.cuh"

constexpr int kRmsThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kRmsThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = out + static_cast<size_t>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x * VEC; i < d; i += kRmsThreads * VEC) {
    float v[VEC];
    load16(xr + i, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) ss += v[j] * v[j];
  }
  __shared__ float partial[kRmsThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kRmsThreads / 32 ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) partial[0] = t;
  }
  __syncthreads();
  const float inv = rsqrtf(partial[0] / static_cast<float>(d) + eps);
  for (int i = threadIdx.x * VEC; i < d; i += kRmsThreads * VEC) {
    float v[VEC];
    load16(xr + i, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = v[j] * inv * w[i + j];
    store16(yr + i, v);
  }
}

// Built for bf16 only, the one type the serving path launches; other types
// are refused until a configuration needs them and chip_smoke.py checks them.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              int rows, int d, float eps, int dtype,
                              void* stream) {
  if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_kernel<__nv_bfloat16>
      <<<rows, kRmsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
          static_cast<__nv_bfloat16*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
