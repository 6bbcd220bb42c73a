// Fused RMSNorm for Hopper: a warp per row, the row in registers.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (_rmsnorm_kernel, launched by rmsnorm_rows): y = x * rsqrt(mean(x^2) + eps)
// * w, with the mean of squares in float32 and w read in float32.
//
// Bound on the H100: bytes.  Each row of d values is read once and written
// once (2 * d * 2 bytes against ~4 flops per value), far below the ~295
// flops per byte where the tensor cores would limit: at (4096, 2048) the
// bound is 10 us at 3.35 TB/s.  Design:
// - One warp per row.  The row's d / 8 16-byte chunks spread over the 32
//   lanes (chunk i * 32 + lane, so each load instruction of a warp covers
//   512 contiguous bytes) and stay in registers between the sum of squares
//   and the scaling: device memory sees one read and one write of the row.
// - The sum of squares reduces by warp shuffles alone: no shared memory and
//   no __syncthreads.
// - The kernel is templated on chunks per lane and instantiated only for
//   the widths the paths launch (d 2048, llama3.2-1b; d 1024, mamba2-370m
//   and granite-moe-1b-a400m; d 256, the small Trainer run of chip_smoke.py;
//   d 3072, llama3.2-3b; d 3584 and 7168, zamba2-7b's d_model and its
//   d_inner and shared block's 2 d_model, and yi-34b's d_model 7168; d
//   5120, llama4-scout-17b-a16e; d 896, internvl2-1b, below).
//   Up to d 2048 each warp reads the f32 weight once, as 16-byte vectors,
//   into registers; then it strides over rows in a grid of as many blocks
//   as the SMs hold at once (2-4 an SM, by its register count), loading
//   its next row before it scales and stores this one.
// - Wider rows do not fit that way: the weight (8 registers a chunk), the
//   row and the prefetched next row (4 each) come to about 16 CPL
//   registers, 224 at d 3584 and 448 at d 7168 against 255.  So at those
//   widths the weight is read through L1 at each row (14 or 28 KB, the
//   same for every row, so it stays resident), by a volatile load that
//   the compiler cannot hoist out of the row loop (hoisted, the weight
//   would sit in registers again: 254 registers at d 3584, a spill at
//   7168), and at d 7168 the next row is loaded only after this one is
//   stored (the row alone is 112 registers a lane; the other warps on the
//   SM hide the load).  Each row is still read once and written once.
//   d 3072 (CPL 12, 96 values a lane) takes d 3584's scheme by the same
//   count: the weight in registers would need ~16 CPL = 192 on top of the
//   loop's own, so it is read through L1 (12 KB); the row and the
//   prefetched next row are 48 registers each.  d 5120 (CPL 20, 160
//   values a lane) takes d 7168's: the weight through L1 (20 KB), the
//   row alone in registers (80 a lane), the next row loaded after this
//   one is stored.
// - A row that is not a whole number of 512-byte warp loads (d 896,
//   internvl2-1b: 112 chunks, 3.5 a lane) gives its last chunk to the
//   first LAST lanes only (16 at d 896): the other lanes neither load nor
//   store it and add nothing to the sum of squares.  Each row is still one
//   read and one write; the last load instruction of a row moves 256
//   contiguous bytes instead of 512.
#include "common.cuh"

constexpr int kRmsWarps = 4;          // warps (rows in flight) per block

// A read-only 16-byte load that stays where it is written: volatile, so
// it is neither hoisted out of a loop nor merged with another.
__device__ __forceinline__ float4 ldg_in_place(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// 16-byte chunks per lane, the last of them held by the first LAST lanes
// only: d = 256 (CPL - 1) + 8 LAST
template <int CPL, int LAST = 32>
__global__ void __launch_bounds__(kRmsWarps * 32)
rmsnorm_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ w, __nv_bfloat16* __restrict__ out,
               int rows, float eps) {
  static_assert(LAST > 0 && LAST <= 32, "the last chunk's lanes");
  constexpr int D = 256 * (CPL - 1) + 8 * LAST;
  constexpr bool kWeightRegs = CPL <= 8;   // the weight held in registers
  constexpr bool kPrefetch = CPL <= 14;    // the next row loaded early
  const int lane = threadIdx.x % 32;
  const int n_warps = gridDim.x * kRmsWarps;
  int r = blockIdx.x * kRmsWarps + threadIdx.x / 32;
  if (r >= rows) return;
  // whether this lane holds chunk i (every chunk but a short last one)
  auto held = [&](int i) { return LAST == 32 || i < CPL - 1 || lane < LAST; };

  // chunk i's 8 weights: from registers, or through L1 at each use
  float wr[kWeightRegs ? CPL : 1][8];
  auto weights = [&](int i, float* dst) {
    const float* wp = w + (i * 32 + lane) * 8;
    const float4 a = ldg_in_place(wp), b = ldg_in_place(wp + 4);
    dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
    dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
  };
  if constexpr (kWeightRegs) {
#pragma unroll
    for (int i = 0; i < CPL; ++i)
      if (held(i)) weights(i, wr[i]);
  }

  // a chunk this lane does not hold stays zero: it adds nothing to the sum
  uint4 cur[CPL];
  const uint4* xr = reinterpret_cast<const uint4*>(x);
#pragma unroll
  for (int i = 0; i < CPL; ++i)
    cur[i] = held(i) ? xr[static_cast<size_t>(r) * (D / 8) + i * 32 + lane]
                     : make_uint4(0, 0, 0, 0);
  for (; r < rows; r += n_warps) {
    const int rn = r + n_warps;
    uint4 nxt[kPrefetch ? CPL : 1];
    if (kPrefetch && rn < rows) {
#pragma unroll
      for (int i = 0; i < (kPrefetch ? CPL : 0); ++i)
        nxt[i] = held(i)
                     ? xr[static_cast<size_t>(rn) * (D / 8) + i * 32 + lane]
                     : make_uint4(0, 0, 0, 0);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const auto* e = reinterpret_cast<const __nv_bfloat16*>(&cur[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = __bfloat162float(e[j]);
        ss += v * v;
      }
    }
    ss = warp_sum(ss);
    const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
    uint4* yr =
        reinterpret_cast<uint4*>(out) + static_cast<size_t>(r) * (D / 8);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      if (!held(i)) continue;
      const auto* e = reinterpret_cast<const __nv_bfloat16*>(&cur[i]);
      float wl[8];
      if constexpr (!kWeightRegs) weights(i, wl);
      const float* wi = kWeightRegs ? wr[i] : wl;
      uint4 o;
      __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        oe[j] = __float2bfloat16(__bfloat162float(e[j]) * inv * wi[j]);
      yr[i * 32 + lane] = o;
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) cur[i] = nxt[i];
    } else if (rn < rows) {
#pragma unroll
      for (int i = 0; i < CPL; ++i)
        if (held(i))
          cur[i] = xr[static_cast<size_t>(rn) * (D / 8) + i * 32 + lane];
    }
  }
}

// Blocks of the kernel resident on the whole card (SMs times blocks an SM
// holds at its register count), found once per instantiation.
template <int CPL, int LAST>
static int resident_blocks(int* blocks) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rmsnorm_kernel<CPL, LAST>, kRmsWarps * 32, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    cached = sms * max(1, per_sm);
  }
  *blocks = cached;
  return 0;
}

template <int CPL, int LAST = 32>
static int launch_rms(const void* x, const void* w, void* out, int rows,
                      float eps, cudaStream_t stream) {
  int resident = 0;
  if (int err = resident_blocks<CPL, LAST>(&resident)) return err;
  const int blocks = min((rows + kRmsWarps - 1) / kRmsWarps, resident);
  rmsnorm_kernel<CPL, LAST><<<blocks, kRmsWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<__nv_bfloat16*>(out), rows, eps);
  return static_cast<int>(cudaGetLastError());
}

// Built for bf16 at d 256, 896, 1024, 2048, 3072, 3584, 5120 and 7168,
// what the serving and training paths launch; other types and widths are
// refused until a configuration needs them and chip_smoke.py checks them
// (kernels/rmsnorm.py names the widths).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              int rows, int d, float eps, int dtype,
                              void* stream) {
  if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 256:
      return launch_rms<1>(x, w, out, rows, eps, s);
    case 896:                         // 3 chunks a lane, a fourth on 16
      return launch_rms<4, 16>(x, w, out, rows, eps, s);
    case 1024:
      return launch_rms<4>(x, w, out, rows, eps, s);
    case 2048:
      return launch_rms<8>(x, w, out, rows, eps, s);
    case 3072:
      return launch_rms<12>(x, w, out, rows, eps, s);
    case 3584:
      return launch_rms<14>(x, w, out, rows, eps, s);
    case 5120:
      return launch_rms<20>(x, w, out, rows, eps, s);
    case 7168:
      return launch_rms<28>(x, w, out, rows, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
