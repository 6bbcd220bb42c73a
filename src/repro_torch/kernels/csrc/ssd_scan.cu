// Mamba2 SSD chunked scan for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py (_ssd_kernel,
// launched by ssd_scan at kernel.py:82), and computes what the reference
// model runs, src/repro/models/ssm.py:ssd_chunked: inputs x (B, S, H, P)
// bf16 (dt-scaled), a (B, S, H) f32 log decay (<= 0), B and C (B, S, G, N)
// bf16, an optional initial state h0 (B, H, N, P) f32; outputs y (B, S, H, P)
// bf16 and the final state (B, H, N, P) f32.  Head h reads group h / (H / G)
// in place (no repeat of B and C per head).  Within a chunk of Q positions,
// with a_cs the inclusive cumulative sum of a over the chunk:
//
//   y[q]  = sum_{k <= q} (C[q] . B[k]) exp(a_cs[q] - a_cs[k]) x[k]
//         + exp(a_cs[q]) C[q] h
//   h    <- exp(a_cs[Q-1]) h + sum_k B[k] exp(a_cs[Q-1] - a_cs[k]) x[k]^T
//
// The ragged last chunk (S not a multiple of Q) is masked here: its rows
// past S read as zeros, which leave the state unchanged, exactly as the
// reference's zero padding does.
//
// Translation.  The TPU kernel runs a (B, H, chunks) grid whose chunk axis
// is sequential and carries the N x P state in VMEM scratch.  Hopper blocks
// run in no order, so one block per (head, batch row) loops over its chunks
// itself and holds the state in shared memory (N x P f32, 32 KB at N 128,
// P 64).  The chunk's cumulative sum is a block scan into shared memory.  A
// chunk of up to 256 positions is cut into 64-row tiles, since its Q x Q
// score matrix alone would be 256 KB: for each query tile the carried
// state's term, then the dual form over the key tiles k <= q; exp is taken
// only where q >= k, so it is never evaluated where it would overflow.
// Then the state update over the chunk's key tiles.  Every sum is in f32.
//
// Bound on the H100: bytes.  The function reads x, a, B, C once and writes
// y and the final state once (44.6 MB at B 8, S 512, H 32, P 64, N 128)
// against about 6.6 GFLOP, far below the ~295 flops per byte where the
// tensor cores would limit.  This first version runs its products on the
// CUDA cores: 256 threads per block in a 16 x 16 grid, each owning a 4 x 4
// piece of a 64 x 64 tile (scores, y) or an (N / 16) x 4 piece of the state,
// with the tiles in shared memory as f32, laid out so that every inner-loop
// read is a float4 that the warp shares or reads contiguously.  At about
// 129 KB of shared memory one block fits on an SM.  Tensor cores (mma /
// wgmma) and TMA, and more than one block per (b, h), are later work.
#include "common.cuh"

constexpr int kSsdThreads = 256;   // a 16 x 16 grid of threads
constexpr int kSsdTile = 64;       // rows of a query or key tile
constexpr int kSsdMaxChunk = 256;  // positions the cumulative-sum buffer holds

// Shared memory layout of one block, in floats.
template <int N, int P>
struct SsdSmem {
  static constexpr int kState = 0;                          // h [N][P]
  static constexpr int kC = kState + N * P;                 // C [N][64] / Bw [64][N]
  static constexpr int kB = kC + N * kSsdTile;              // B [N][64]
  static constexpr int kX = kB + N * kSsdTile;              // x [64][P]
  static constexpr int kScore = kX + kSsdTile * P;          // L o CB^T [key][query]
  static constexpr int kCumsum = kScore + kSsdTile * kSsdTile;  // a_cs [256]
  static constexpr int kWarpSums = kCumsum + kSsdMaxChunk;  // scan scratch [8]
  static constexpr int kFloats = kWarpSums + kSsdThreads / 32;
};

// Rows [0, 64) of a bf16 matrix with row stride ld (elements) and W columns,
// as f32 into dst[W][64] (transposed); rows >= valid read as zero.  Thread t
// takes row t % 64, so a warp's stores fall on consecutive words.
template <int W>
__device__ __forceinline__ void load_tile_t(const __nv_bfloat16* src,
                                            long long ld, int valid,
                                            float* dst) {
  const int r = threadIdx.x % kSsdTile;
  for (int c = threadIdx.x / kSsdTile; c < W / 8;
       c += kSsdThreads / kSsdTile) {
    float v[8];
    if (r < valid) {
      load16(src + r * ld + c * 8, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c * 8 + j) * kSsdTile + r] = v[j];
  }
}

// Rows [0, 64) of a bf16 matrix with row stride ld and W columns, as f32
// into dst[64][W]; rows >= valid read as zero.  With a non-null cumsum, row
// r is scaled by exp(a_tot - cumsum[r]) (the decay to the chunk's end).
template <int W>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src,
                                          long long ld, int valid,
                                          const float* cumsum, float a_tot,
                                          float* dst) {
  constexpr int kGroups = W / 8;
  for (int i = threadIdx.x; i < kSsdTile * kGroups; i += kSsdThreads) {
    const int r = i / kGroups, c = i % kGroups;
    float v[8];
    if (r < valid) {
      load16(src + r * ld + c * 8, v);
      if (cumsum != nullptr) {
        const float w = expf(a_tot - cumsum[r]);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] *= w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * W + c * 8);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Inclusive prefix sum of one value per thread into out[threadIdx.x].
__device__ __forceinline__ void block_inclusive_scan(float v, float* out,
                                                     float* warp_sums) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += up;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += warp_sums[w];
  out[threadIdx.x] = v;
  __syncthreads();
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += u[i] * v[j] for the 4 x 4 outer product of two float4s.
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 u,
                                       float4 v) {
  const float a[4] = {u.x, u.y, u.z, u.w}, b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

template <int N, int P>
__global__ void __launch_bounds__(kSsdThreads)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ a,
                const __nv_bfloat16* __restrict__ Bm,
                const __nv_bfloat16* __restrict__ Cm,
                const float* __restrict__ h0, __nv_bfloat16* __restrict__ y,
                float* __restrict__ h_final, int S, int H, int G, int Q) {
  static_assert(P == 64, "a thread owns 4 of the 64 columns of a y tile");
  static_assert(N % 64 == 0, "a thread owns N / 16 rows of the state, "
                "read four at a time");
  constexpr int RN = N / 16;
  using L = SsdSmem<N, P>;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem + L::kState;
  float* cs = smem + L::kC;
  float* bs = smem + L::kB;
  float* xs = smem + L::kX;
  float* ss = smem + L::kScore;
  float* acs = smem + L::kCumsum;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long ldx = static_cast<long long>(H) * P;  // x, y: per position
  const long long ldb = static_cast<long long>(G) * N;  // B, C: per position
  const long long bs0 = static_cast<long long>(b) * S;  // row b's first
  const __nv_bfloat16* xb = x + bs0 * ldx + h * P;
  __nv_bfloat16* yb = y + bs0 * ldx + h * P;
  const __nv_bfloat16* Bb = Bm + bs0 * ldb + g * N;
  const __nv_bfloat16* Cb = Cm + bs0 * ldb + g * N;
  const float* ab = a + bs0 * H + h;
  const long long hoff = (static_cast<long long>(b) * H + h) * N * P;

  for (int i = threadIdx.x; i < N * P; i += kSsdThreads)
    hs[i] = h0 != nullptr ? h0[hoff + i] : 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int len = min(Q, S - t0);            // rows of this chunk
    const int tiles = (len + kSsdTile - 1) / kSsdTile;
    __syncthreads();  // the state and a_cs of the previous chunk are done
    block_inclusive_scan(
        static_cast<int>(threadIdx.x) < len
            ? ab[static_cast<long long>(t0 + threadIdx.x) * H] : 0.f,
        acs, smem + L::kWarpSums);

    for (int qt = 0; qt < tiles; ++qt) {
      const int q0 = qt * kSsdTile;
      load_tile_t<N>(Cb + (t0 + q0) * ldb, ldb, len - q0, cs);
      __syncthreads();
      // the carried state's term: exp(a_cs[q]) C[q] h
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n)
        outer4(acc, ld4(cs + n * kSsdTile + ty * 4), ld4(hs + n * P + tx * 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(acs[q0 + ty * 4 + i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      // the dual form over key tiles at or before the query tile
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kSsdTile;
        load_tile_t<N>(Bb + (t0 + k0) * ldb, ldb, len - k0, bs);
        load_tile<P>(xb + (t0 + k0) * ldx, ldx, len - k0, nullptr, 0.f, xs);
        __syncthreads();
        float s[4][4] = {};
        for (int n = 0; n < N; ++n)
          outer4(s, ld4(cs + n * kSsdTile + ty * 4),
                 ld4(bs + n * kSsdTile + tx * 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + tx * 4 + j;
          float col[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = q0 + ty * 4 + i;
            col[i] = k <= q ? s[i][j] * expf(acs[q] - acs[k]) : 0.f;
          }
          *reinterpret_cast<float4*>(ss + (tx * 4 + j) * kSsdTile + ty * 4) =
              make_float4(col[0], col[1], col[2], col[3]);
        }
        __syncthreads();
        for (int k = 0; k < kSsdTile; ++k)
          outer4(acc, ld4(ss + k * kSsdTile + ty * 4), ld4(xs + k * P + tx * 4));
        __syncthreads();  // before the next tile overwrites B, x and scores
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty * 4 + i;
        if (q < len) {
          __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
              yb + (t0 + q) * ldx + tx * 4);
          dst[0] = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
          dst[1] = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
        }
      }
    }

    // the state at the chunk's end (a_cs is flat past len)
    const float a_tot = acs[kSsdMaxChunk - 1];
    const float e_tot = expf(a_tot);
    float hacc[RN][4];
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hacc[r][j] = e_tot * hs[(ty * RN + r) * P + tx * 4 + j];
    for (int kt = 0; kt < tiles; ++kt) {
      const int k0 = kt * kSsdTile;
      load_tile<N>(Bb + (t0 + k0) * ldb, ldb, len - k0, acs + k0, a_tot, cs);
      load_tile<P>(xb + (t0 + k0) * ldx, ldx, len - k0, nullptr, 0.f, xs);
      __syncthreads();
      for (int k = 0; k < kSsdTile; ++k) {
        const float4 xv = ld4(xs + k * P + tx * 4);
        const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r4 = 0; r4 < RN; r4 += 4) {
          const float4 bv = ld4(cs + k * N + ty * RN + r4);
          const float bk[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              hacc[r4 + r][j] = fmaf(bk[r], xk[j], hacc[r4 + r][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hs[(ty * RN + r) * P + tx * 4 + j] = hacc[r][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < N * P; i += kSsdThreads)
    h_final[hoff + i] = hs[i];
}

// Built for bf16 x / B / C with f32 a at N 128, P 64, the one shape the
// serving path launches (mamba2-370m) and chip_smoke.py checks; other shapes
// are refused until a configuration needs them.  Q is the chunk length,
// 1..256 (a shorter sequence passes min(chunk, S)).
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* Bm,
                               const void* Cm, const void* h0, void* y,
                               void* h_final, int B, int S, int H, int G,
                               int N, int P, int Q, void* stream) {
  constexpr int kN = 128, kP = 64;
  if (N != kN || P != kP || Q < 1 || Q > kSsdMaxChunk || G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t bytes = SsdSmem<kN, kP>::kFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<kN, kP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<kN, kP>
      <<<dim3(H, B), kSsdThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
          static_cast<const __nv_bfloat16*>(Bm),
          static_cast<const __nv_bfloat16*>(Cm),
          static_cast<const float*>(h0), static_cast<__nv_bfloat16*>(y),
          static_cast<float*>(h_final), S, H, G, Q);
  return static_cast<int>(cudaGetLastError());
}
