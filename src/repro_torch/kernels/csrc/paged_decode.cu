// Paged single-token decode attention for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/paged.py
// (_paged_decode_kernel, launched by paged_flash_decode): one query token
// per slot attends over the slot's KV pages, found through its row of the
// block table; keys past the slot's position (and outside an optional
// window) are masked, an optional tanh softcap bounds the logits, and the
// softmax runs online in float32.  int8 / fp8-e4m3 pools are dequantized
// in registers with one float32 scale per (page, KV head).
//
// Bound on the H100: bytes.  Each key and value is read once and used by
// the G = H / KV query rows of its KV head (4 flops per byte at G = 4), far
// below the tensor cores' ~295 flops per byte.  Design: one block per
// (slot, KV head) loads the G query rows once, then walks only the pages
// that hold positions <= pos (and >= pos - window + 1), 64 keys per tile
// (several pages when a page holds fewer), with 16-byte loads; the TPU grid
// swept every table entry and masked the rest.  Pages past the position
// would be fully masked, so skipping them computes the same function.
// Scores, probabilities and the (G, D) accumulator stay in shared memory;
// the quantized pools move 1 byte per value and are scaled after the load.
#include "common.cuh"

constexpr int kDecThreads = 128;
constexpr int kDecTileKeys = 64;
constexpr int kDecMaxPagesPerTile = 64;

template <typename QT, typename KT>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                    const KT* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ positions,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, QT* __restrict__ out,
                    int H, int KV, int D, int page, int nb, int pages_per_tile,
                    int window, float softcap) {
  constexpr int VEC = 16 / sizeof(KT);
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int TK = pages_per_tile * page;  // keys per tile
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nwarps = kDecThreads / 32;

  extern __shared__ float smem[];
  float* q_sh = smem;                    // G * D
  float* k_sh = q_sh + G * D;            // TK * (D + 1), padded rows
  float* v_sh = k_sh + TK * (D + 1);     // TK * D
  float* s_sh = v_sh + TK * D;           // G * (TK + 1), padded rows
  float* acc_sh = s_sh + G * (TK + 1);   // G * D
  float* m_sh = acc_sh + G * D;          // G
  float* l_sh = m_sh + G;                // G
  float* corr_sh = l_sh + G;             // G
  __shared__ int tbl_sh[kDecMaxPagesPerTile];
  __shared__ float ks_sh[kDecMaxPagesPerTile], vs_sh[kDecMaxPagesPerTile];

  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const QT* qb = q + (static_cast<size_t>(b) * H + h * G) * D;
  for (int e = tid; e < G * D; e += kDecThreads) {
    q_sh[e] = to_float(qb[e]) * scale;
    acc_sh[e] = 0.f;
  }
  for (int g = tid; g < G; g += kDecThreads) {
    m_sh[g] = kNegInf;
    l_sh[g] = 0.f;
  }

  const int pos = positions[b];
  // pages holding positions <= pos; a frozen slot parked one past its last
  // reserved position may point past the table, which then bounds the walk
  const int n_pages = min(nb, pos / page + 1);
  int first = 0;
  if (window > 0) first = max(0, pos - window + 1) / page;
  const bool quantized = k_scales != nullptr;
  const int* tbl = tables + static_cast<size_t>(b) * nb;

  for (int j0 = first; j0 < n_pages; j0 += pages_per_tile) {
    __syncthreads();  // previous tile fully consumed
    for (int jp = tid; jp < pages_per_tile; jp += kDecThreads) {
      const int j = j0 + jp;
      const int pid = j < n_pages ? tbl[j] : -1;
      tbl_sh[jp] = pid;
      if (pid >= 0 && quantized) {
        ks_sh[jp] = k_scales[static_cast<size_t>(pid) * KV + h];
        vs_sh[jp] = v_scales[static_cast<size_t>(pid) * KV + h];
      } else {
        ks_sh[jp] = 1.f;
        vs_sh[jp] = 1.f;
      }
    }
    __syncthreads();
    for (int idx = tid * VEC; idx < TK * D; idx += kDecThreads * VEC) {
      const int t = idx / D, d = idx % D;
      const int jp = t / page, ti = t % page;
      const int pid = tbl_sh[jp];
      float kv[VEC], vv[VEC];
      if (pid >= 0) {
        const size_t off =
            ((static_cast<size_t>(pid) * page + ti) * KV + h) * D + d;
        load16(kp + off, kv);
        load16(vp + off, vv);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kv[i] = vv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        k_sh[t * (D + 1) + d + i] = kv[i] * ks_sh[jp];
        v_sh[t * D + d + i] = vv[i] * vs_sh[jp];
      }
    }
    __syncthreads();
    // scores: G x TK dot products over D
    for (int e = tid; e < G * TK; e += kDecThreads) {
      const int g = e / TK, t = e % TK;
      const float* qr = q_sh + g * D;
      const float* kr = k_sh + t * (D + 1);
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const int j = j0 + t / page;
      const int kpos = j * page + t % page;
      bool valid = j < n_pages && kpos <= pos;
      if (window > 0) valid = valid && kpos > pos - window;
      s_sh[g * (TK + 1) + t] = valid ? s : kNegInf;
    }
    __syncthreads();
    // online softmax statistics: one warp per query row
    for (int g = warp; g < G; g += nwarps) {
      float* srow = s_sh + g * (TK + 1);
      float mx = kNegInf;
      for (int t = lane; t < TK; t += 32) mx = fmaxf(mx, srow[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_sh[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new <= kNegInf ? 0.f : m_new;
      // invalid keys hold kNegInf, so exp underflows to exactly 0
      float sum = 0.f;
      for (int t = lane; t < TK; t += 32) {
        const float p = expf(srow[t] - m_safe);
        srow[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = m_prev <= kNegInf ? 0.f : expf(m_prev - m_safe);
        corr_sh[g] = corr;
        l_sh[g] = l_sh[g] * corr + sum;
        m_sh[g] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += kDecThreads) {
      const int g = e / D, d = e % D;
      const float* prow = s_sh + g * (TK + 1);
      float a = acc_sh[e] * corr_sh[g];
      for (int t = 0; t < TK; ++t) a += prow[t] * v_sh[t * D + d];
      acc_sh[e] = a;
    }
  }
  __syncthreads();
  QT* ob = out + (static_cast<size_t>(b) * H + h * G) * D;
  for (int e = tid; e < G * D; e += kDecThreads) {
    ob[e] = from_float<QT>(acc_sh[e] / fmaxf(l_sh[e / D], 1e-20f));
  }
}

template <typename QT, typename KT>
static int launch_paged(const void* q, const void* kp, const void* vp,
                        const int* tables, const int* pos, const float* ks,
                        const float* vs, void* out, int B, int H, int KV,
                        int D, int page, int nb, int window, float softcap,
                        cudaStream_t stream) {
  const int G = H / KV;
  const int ppt = page >= kDecTileKeys ? 1 : kDecTileKeys / page;
  const int TK = ppt * page;
  const size_t smem = sizeof(float) * (static_cast<size_t>(G) * D +
                                       TK * (D + 1) + TK * D + G * (TK + 1) +
                                       G * D + 3 * G);
  auto kernel = paged_decode_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(KV, B);
  kernel<<<grid, kDecThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), tables, pos, ks, vs, static_cast<QT*>(out),
      H, KV, D, page, nb, ppt, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// Built for bf16 queries (the serving path's compute type) over bf16, f32,
// int8 and fp8-e4m3 pools; chip_smoke.py checks every one of them.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* pos, const void* k_scales,
                                   const void* v_scales, void* out, int B,
                                   int H, int KV, int D, int page, int nb,
                                   int window, float softcap, int q_dtype,
                                   int kv_dtype, void* stream) {
  if (q_dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  using QT = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  switch (kv_dtype) {
    case kF32:
      return launch_paged<QT, float>(q, k_pages, v_pages, t, p, ks, vs, out, B,
                                     H, KV, D, page, nb, window, softcap, s);
    case kBF16:
      return launch_paged<QT, __nv_bfloat16>(q, k_pages, v_pages, t, p, ks, vs,
                                             out, B, H, KV, D, page, nb,
                                             window, softcap, s);
    case kI8:
      return launch_paged<QT, int8_t>(q, k_pages, v_pages, t, p, ks, vs, out,
                                      B, H, KV, D, page, nb, window, softcap,
                                      s);
    case kFP8:
      return launch_paged<QT, __nv_fp8_e4m3>(q, k_pages, v_pages, t, p, ks, vs,
                                             out, B, H, KV, D, page, nb,
                                             window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
