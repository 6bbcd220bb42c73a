// Prefill flash attention with per-row valid lengths, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_fwd_kernel, launched by flash_attention_fwd), extended by what
// serving prefill computes (src/repro/models/common.py:chunked_attention
// with kv_valid_len): rows of a batch are right-padded to one bucket, and
// row b's keys at positions >= kv_valid_len[b] are masked.  Causal, local
// window and tanh softcap masks as in the TPU kernel; GQA reads KV head
// h / G with no repeat; f32 online softmax; the softmax weights are rounded
// to the input dtype before the PV product, as the reference does.  With a
// non-null lse pointer it also writes the log-sum-exp (B, H, Sq) in f32,
// m + log(max(l, 1e-20)) with m := 0 for a row that saw no key, as the TPU
// kernel does with return_lse (kernel.py:77-82); the training forward saves
// it for the backward (flash_backward.cu).
//
// A padded query row (position >= kv_valid_len) whose causal/window range
// holds no valid key gets what the reference's chunked_attention gives it:
// the reference masks invalid keys by setting their score to -1e30 and
// zeroes the softmax weights by the causal/window mask only, so such a row
// averages the values of the keys that mask admits.  The key loop below
// stops at the valid length and never reads those keys, so the kernel
// takes that average in an explicit branch after the loop.
//
// Bound on the H100: operations at long prompts (2 * D flops per score for
// QK and again for PV against 2 * D bytes per key read once per 64-row query
// tile), bytes at short ones.  Design of this first version: one block of
// 256 threads per (64-row query tile, head, batch row), the tile's Q and a
// 64-key K/V tile in shared memory as f32 (rows padded against bank
// conflicts), four threads per query row each owning 16 key columns and
// D / 4 output columns, and a loop over key tiles that stops at the causal
// and valid-length bound (and starts at the window's first key).  Products
// run on the CUDA cores in f32; tensor cores (mma / wgmma) are later work.
#include "common.cuh"

constexpr int kPreThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kColsPerThread = kBK / 4;

template <typename T, int D>
__global__ void __launch_bounds__(kPreThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int* __restrict__ kv_valid_len, T* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int G,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long o_sb, long long o_ss, long long o_sh,
                     int causal, int window, float softcap) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int DP = D + 1;  // padded row
  constexpr int DPT = D / 4; // output columns per thread
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const int tid = threadIdx.x, r = tid / 4, c4 = tid % 4;

  extern __shared__ float smem[];
  float* q_s = smem;             // kBQ x DP
  float* k_s = q_s + kBQ * DP;   // kBK x DP
  float* v_s = k_s + kBK * DP;   // kBK x DP
  float* p_s = v_s + kBK * DP;   // kBQ x (kBK + 1)

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const float scale = 1.f / sqrtf(static_cast<float>(D));

  for (int idx = tid * VEC; idx < kBQ * D; idx += kPreThreads * VEC) {
    const int row = idx / D, d = idx % D;
    float x[VEC];
    if (q0 + row < Sq) {
      load16(qb + (q0 + row) * q_ss + d, x);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[i] = 0.f;
    }
    // the reference scales q in its own dtype
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      q_s[row * DP + d + i] = round_through<T>(x[i] * scale);
  }

  const int vl = kv_valid_len[b];
  int kv_end = min(Sk, vl);
  if (causal) kv_end = min(kv_end, q0 + kBQ);
  int kv_begin = 0;
  if (window > 0) kv_begin = (max(0, q0 - window + 1) / kBK) * kBK;
  const int qpos = q0 + r;

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  float m_run = kNegInf, l_run = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // previous tile consumed (and q_s written)
    for (int idx = tid * VEC; idx < kBK * D; idx += kPreThreads * VEC) {
      const int row = idx / D, d = idx % D;
      float kx[VEC], vx[VEC];
      if (k0 + row < Sk) {
        load16(kb + (k0 + row) * k_ss + d, kx);
        load16(vb + (k0 + row) * v_ss + d, vx);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kx[i] = vx[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        k_s[row * DP + d + i] = kx[i];
        v_s[row * DP + d + i] = vx[i];
      }
    }
    __syncthreads();

    float s[kColsPerThread];
    bool ok[kColsPerThread];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) {
      const int c = c4 + 4 * i;
      const float* qr = q_s + r * DP;
      const float* kr = k_s + c * DP;
      float a = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) a += qr[d] * kr[d];
      if (softcap > 0.f) a = tanhf(a / softcap) * softcap;
      const int kpos = k0 + c;
      bool valid = kpos < Sk && kpos < vl;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && qpos - kpos < window;
      ok[i] = valid;
      s[i] = valid ? a : kNegInf;
      mx = fmaxf(mx, s[i]);
    }
    // the four threads of a query row are neighbouring lanes
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float m_safe = m_new <= kNegInf ? 0.f : m_new;
    const float corr = m_run <= kNegInf ? 0.f : expf(m_run - m_safe);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) {
      const float p = ok[i] ? expf(s[i] - m_safe) : 0.f;
      psum += p;
      p_s[r * (kBK + 1) + c4 + 4 * i] = round_through<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_run = l_run * corr + psum;
    m_run = m_new;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = c4 + 4 * j;
      float a = acc[j] * corr;
      for (int c = 0; c < kBK; ++c) a += p_s[r * (kBK + 1) + c] * v_s[c * DP + d];
      acc[j] = a;
    }
  }

  if (qpos < Sq) {
    const int lower = window > 0 ? max(0, qpos - window + 1) : 0;
    if (lower >= min(Sk, vl)) {
      // no valid key: the plain mean of the values the causal/window mask
      // admits (every admitted weight is exp(0) = 1 in the reference)
      const int upper = causal ? min(qpos, Sk - 1) : Sk - 1;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
      for (int kk = lower; kk <= upper; ++kk) {
        const T* vrow = vb + kk * v_ss;
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[j] += to_float(vrow[c4 + 4 * j]);
      }
      l_run = static_cast<float>(max(upper - lower + 1, 0));
      m_run = kNegInf;
    }
    const float l = fmaxf(l_run, 1e-20f);
    const float inv = 1.f / l;
    T* orow = out + b * o_sb + qpos * o_ss + h * o_sh;
#pragma unroll
    for (int j = 0; j < DPT; ++j) orow[c4 + 4 * j] = from_float<T>(acc[j] * inv);
    if (lse != nullptr && c4 == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qpos] =
          (m_run <= kNegInf ? 0.f : m_run) + logf(l);
  }
}

template <typename T, int D>
static int launch_prefill(const void* q, const void* k, const void* v,
                          const int* vl, void* out, float* lse, int B,
                          int Sq, int Sk, int H, int KV, const long long* st,
                          int causal, int window, float softcap,
                          cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBQ + 2 * kBK) * (D + 1) +
                       kBQ * (kBK + 1));
  auto kernel = flash_prefill_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kPreThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), vl, static_cast<T*>(out), lse, Sq, Sk,
      H / KV, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// Built for bf16 with head_dim 64 only, the one case the serving and
// training paths launch (llama3.2-1b); other cases are refused until a
// configuration needs them and chip_smoke.py checks them.  lse may be null.
extern "C" int flash_prefill_launch(
    const void* q, const void* k, const void* v, const void* kv_valid_len,
    void* out, void* lse, int B, int Sq, int Sk, int H, int KV, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, int dtype, void* stream) {
  if (dtype != kBF16 || D != 64) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  return launch_prefill<__nv_bfloat16, 64>(
      q, k, v, static_cast<const int*>(kv_valid_len), out,
      static_cast<float*>(lse), B, Sq, Sk, H, KV, st, causal, window, softcap,
      static_cast<cudaStream_t>(stream));
}
