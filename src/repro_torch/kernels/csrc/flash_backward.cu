// Flash-attention backward for Hopper: dQ, dK and dV from the saved forward
// output and log-sum-exp.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention/backward.py
// (_dq_kernel and _dkv_kernel, the two pallas_calls of flash_attention_bwd)
// and the GQA handling of ops.py:_fa_train_bwd.  The flash recipe as there:
// the probabilities of a (query, key) tile are recomputed as
// P = exp(s - lse) from the scores s = (q * scale) . k, then
// dP = dO . V, dS = P * (dP - delta) with delta = rowsum(dO * O), and
// dQ = scale * dS K, dK = dS^T (q * scale), dV = P^T dO.  Causal and local
// window masks as in the forward; keys past Sk and queries past Sq count
// nothing.
//
// The scale: the TPU backward scales q in f32 (backward.py:48, :83) and so
// does this kernel, while the forward kernel (flash_prefill.cu) scales q in
// the input dtype, as the reference's chunked_attention does.  At head_dim
// 64 the scale is 2^-3, which is exact in bf16, so the two agree; at head
// dim 128 (scale 2^-3.5) they would not, and the forward's rounding would
// have to be repeated here.
//
// Bound on the H100: operations.  Per admitted (query, key) pair the
// gradient needs 5 products of 2 * D flops (QK^T, dO V^T, dS K, P^T dO,
// dS^T Q) against 2 * D bytes per row read once; these two kernels do 7,
// since each recomputes QK^T and dO V^T.  The wrapper launches them only
// for causal attention with no window and Sq == Sk, what the training path
// gives them; the masks below are written for the general case.  Design of
// this first version (correct and simple):
//
// - delta: a pre-pass computes rowsum(dO * O) once per query row into an f32
//   scratch (B, H, Sq) that both kernels read, instead of recomputing it
//   per tile as the TPU kernels do (that would read O once per key tile).
// - dQ: one block of 256 threads per (64-row query tile, head, batch row),
//   looping over 64-key tiles from the window's first key up to the causal
//   bound; Q, dO and the key tile's K and V sit in shared memory as f32,
//   four threads per query row each own 16 key columns and 16 output
//   columns.  The heaviest query tiles (last under the causal mask) are
//   launched first.
// - dK/dV: one block per (64-key tile, KV head, batch row), looping over
//   the G query heads of its group and, for each, over the query tiles from
//   the causal start; four threads per key row each own 16 query columns
//   and 16 output columns.  The group's sum stays in f32 registers: no KV
//   repeat in memory and no atomics.
//
// Products run on the CUDA cores in f32, as in the forward; tensor cores
// (mma / wgmma) are later work.  Layouts are the model's, contiguous:
// q, o, dO, dQ (B, Sq, H, D); k, v, dK, dV (B, Sk, KV, D); lse, delta
// (B, H, Sq) f32.
#include "common.cuh"

constexpr int kBwdThreads = 256;
constexpr int kBT = 64;            // query rows (dQ) or keys (dK/dV) per tile
constexpr int kCols = kBT / 4;     // tile columns per thread
constexpr int kDeltaLanes = 8;     // threads per row in the delta pre-pass

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int Sq, int H,
                       long long rows) {
  constexpr int VEC = 16 / sizeof(T);
  static_assert(D == kDeltaLanes * VEC, "one 16-byte vector per lane");
  const long long row =
      static_cast<long long>(blockIdx.x) * (kBwdThreads / kDeltaLanes) +
      threadIdx.x / kDeltaLanes;
  const int lane = threadIdx.x % kDeltaLanes;
  float a = 0.f;
  if (row < rows) {
    float x[VEC], y[VEC];
    load16(o + row * D + lane * VEC, x);
    load16(dout + row * D + lane * VEC, y);
#pragma unroll
    for (int i = 0; i < VEC; ++i) a += x[i] * y[i];
  }
#pragma unroll
  for (int off = kDeltaLanes / 2; off > 0; off >>= 1)
    a += __shfl_xor_sync(0xffffffffu, a, off);
  if (row < rows && lane == 0) {
    // row runs over (b, s, h) in memory order; delta is (B, H, Sq)
    const int h = static_cast<int>(row % H);
    const long long bs = row / H;
    const int s = static_cast<int>(bs % Sq);
    const long long b = bs / Sq;
    delta[(b * H + h) * Sq + s] = a;
  }
}

__device__ __forceinline__ bool admitted(int qpos, int kpos, int Sq, int Sk,
                                         int causal, int window) {
  bool ok = qpos < Sq && kpos < Sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

// Rows [row0, row0 + kBT) of a (S, heads, D) slice into shared memory as
// f32 times mul, zeros past S.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* base, long long row_stride,
                                          int row0, int S, float mul,
                                          float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int DP = D + 1;
  for (int idx = threadIdx.x * VEC; idx < kBT * D; idx += kBwdThreads * VEC) {
    const int row = idx / D, d = idx % D;
    float x[VEC];
    if (row0 + row < S) {
      load16(base + (row0 + row) * row_stride + d, x);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[row * DP + d + i] = x[i] * mul;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int KV, int causal, int window,
                    float scale) {
  constexpr int DP = D + 1;
  constexpr int DPT = D / 4;
  constexpr int CP = kBT + 1;
  // the last query tiles see the most keys under the causal mask: launch
  // them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, r = tid / 4, c4 = tid % 4;
  const int qpos = q0 + r;

  extern __shared__ float smem[];
  float* q_s = smem;             // kBT x DP, q * scale
  float* do_s = q_s + kBT * DP;  // kBT x DP
  float* k_s = do_s + kBT * DP;  // kBT x DP
  float* v_s = k_s + kBT * DP;   // kBT x DP
  float* ds_s = v_s + kBT * DP;  // kBT x CP

  const long long q_row = static_cast<long long>(H) * D;
  const long long k_row = static_cast<long long>(KV) * D;
  const long long q_off = static_cast<long long>(b) * Sq * q_row + h * D;
  const long long k_off = static_cast<long long>(b) * Sk * k_row + kvh * D;
  load_tile<T, D>(q + q_off, q_row, q0, Sq, scale, q_s);
  load_tile<T, D>(dout + q_off, q_row, q0, Sq, 1.f, do_s);

  const long long stat = (static_cast<long long>(b) * H + h) * Sq + qpos;
  const float lse_r = qpos < Sq ? lse[stat] : 0.f;
  const float delta_r = qpos < Sq ? delta[stat] : 0.f;
  int kv_end = Sk;
  if (causal) kv_end = min(kv_end, q0 + kBT);
  const int kv_begin =
      window > 0 ? (max(0, q0 - window + 1) / kBT) * kBT : 0;

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBT) {
    __syncthreads();  // previous tile consumed (and q_s, do_s written)
    load_tile<T, D>(k + k_off, k_row, k0, Sk, 1.f, k_s);
    load_tile<T, D>(v + k_off, k_row, k0, Sk, 1.f, v_s);
    __syncthreads();
    const float* qr = q_s + r * DP;
    const float* dr = do_s + r * DP;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = c4 + 4 * i;
      const float* kr = k_s + c * DP;
      const float* vr = v_s + c * DP;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s += qr[d] * kr[d];
        dp += dr[d] * vr[d];
      }
      const float p = admitted(qpos, k0 + c, Sq, Sk, causal, window)
                          ? expf(s - lse_r) : 0.f;
      ds_s[r * CP + c] = p * (dp - delta_r);
    }
    // a row of ds is written and read by the same four lanes
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = c4 + 4 * j;
      float a = acc[j];
      for (int c = 0; c < kBT; ++c) a += ds_s[r * CP + c] * k_s[c * DP + d];
      acc[j] = a;
    }
  }

  if (qpos < Sq) {
    T* out = dq + q_off + qpos * q_row;
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      out[c4 + 4 * j] = from_float<T>(acc[j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                     int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int DPT = D / 4;
  constexpr int CP = kBT + 1;
  const int k0 = blockIdx.x * kBT, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, r = tid / 4, c4 = tid % 4;
  const int kpos = k0 + r;

  extern __shared__ float smem[];
  float* k_s = smem;             // kBT x DP (the block's keys)
  float* v_s = k_s + kBT * DP;   // kBT x DP
  float* q_s = v_s + kBT * DP;   // kBT x DP, q * scale
  float* do_s = q_s + kBT * DP;  // kBT x DP
  float* p_s = do_s + kBT * DP;  // kBT (keys) x CP (queries)
  float* ds_s = p_s + kBT * CP;  // kBT x CP
  float* lse_s = ds_s + kBT * CP;    // kBT
  float* delta_s = lse_s + kBT;      // kBT

  const long long q_row = static_cast<long long>(H) * D;
  const long long k_row = static_cast<long long>(KV) * D;
  const long long k_off = static_cast<long long>(b) * Sk * k_row + kvh * D;
  load_tile<T, D>(k + k_off, k_row, k0, Sk, 1.f, k_s);
  load_tile<T, D>(v + k_off, k_row, k0, Sk, 1.f, v_s);

  // query tiles that can see a key of this tile
  const int q_begin = causal ? (k0 / kBT) * kBT : 0;
  int q_end = Sq;
  if (window > 0) q_end = min(q_end, k0 + kBT - 1 + window);

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long q_off = static_cast<long long>(b) * Sq * q_row + h * D;
    const long long stat0 = (static_cast<long long>(b) * H + h) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kBT) {
      __syncthreads();  // previous tile consumed (and k_s, v_s written)
      load_tile<T, D>(q + q_off, q_row, q0, Sq, scale, q_s);
      load_tile<T, D>(dout + q_off, q_row, q0, Sq, 1.f, do_s);
      if (tid < kBT) {
        const bool in = q0 + tid < Sq;
        lse_s[tid] = in ? lse[stat0 + q0 + tid] : 0.f;
        delta_s[tid] = in ? delta[stat0 + q0 + tid] : 0.f;
      }
      __syncthreads();
      const float* kr = k_s + r * DP;
      const float* vr = v_s + r * DP;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int c = c4 + 4 * i;
        const float* qr = q_s + c * DP;
        const float* dr = do_s + c * DP;
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s += kr[d] * qr[d];
          dp += vr[d] * dr[d];
        }
        const float p = admitted(q0 + c, kpos, Sq, Sk, causal, window)
                            ? expf(s - lse_s[c]) : 0.f;
        p_s[r * CP + c] = p;
        ds_s[r * CP + c] = p * (dp - delta_s[c]);
      }
      // a key row of p and ds is written and read by the same four lanes
      __syncwarp();
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const int d = c4 + 4 * j;
        float a = dv_acc[j], e = dk_acc[j];
        for (int c = 0; c < kBT; ++c) {
          a += p_s[r * CP + c] * do_s[c * DP + d];
          e += ds_s[r * CP + c] * q_s[c * DP + d];
        }
        dv_acc[j] = a;
        dk_acc[j] = e;
      }
    }
  }

  if (kpos < Sk) {
    // q was scaled on load, so dK = dS^T (q * scale) needs no further scale
    T* dko = dk + k_off + kpos * k_row;
    T* dvo = dv + k_off + kpos * k_row;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dko[c4 + 4 * j] = from_float<T>(dk_acc[j]);
      dvo[c4 + 4 * j] = from_float<T>(dv_acc[j]);
    }
  }
}

template <typename T, int D>
static int launch_bwd(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, void* dk, void* dv, int B,
                      int Sq, int Sk, int H, int KV, int causal, int window,
                      cudaStream_t stream) {
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  const long long rows = static_cast<long long>(B) * Sq * H;
  const int per_block = kBwdThreads / kDeltaLanes;
  flash_bwd_delta_kernel<T, D>
      <<<static_cast<unsigned>((rows + per_block - 1) / per_block),
         kBwdThreads, 0, stream>>>(static_cast<const T*>(o), dot, delta, Sq,
                                   H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t tile = sizeof(float) * kBT * (D + 1);
  const size_t ptile = sizeof(float) * kBT * (kBT + 1);
  const size_t dq_smem = 4 * tile + ptile;
  auto dq_kernel = flash_bwd_dq_kernel<T, D>;
  err = cudaFuncSetAttribute(dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<dim3((Sq + kBT - 1) / kBT, H, B), kBwdThreads, dq_smem,
              stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq,
                        Sk, H, KV, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t dkv_smem = 4 * tile + 2 * ptile + 2 * sizeof(float) * kBT;
  auto dkv_kernel = flash_bwd_dkv_kernel<T, D>;
  err = cudaFuncSetAttribute(dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<dim3((Sk + kBT - 1) / kBT, KV, B), kBwdThreads, dkv_smem,
               stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
                         static_cast<T*>(dv), Sq, Sk, H, KV, causal, window,
                         scale);
  return static_cast<int>(cudaGetLastError());
}

// Built for bf16 with head_dim 64 only, the one case the training path
// launches (llama3.2-1b); other cases are refused until a configuration
// needs them and chip_smoke.py checks them.  delta is an f32 scratch of
// B * H * Sq values that the wrapper allocates.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* delta, void* dq,
                                void* dk, void* dv, int B, int Sq, int Sk,
                                int H, int KV, int D, int causal, int window,
                                int dtype, void* stream) {
  if (dtype != kBF16 || D != 64 || KV <= 0 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd<__nv_bfloat16, 64>(
      q, k, v, o, dout, static_cast<const float*>(lse),
      static_cast<float*>(delta), dq, dk, dv, B, Sq, Sk, H, KV, causal,
      window, static_cast<cudaStream_t>(stream));
}
