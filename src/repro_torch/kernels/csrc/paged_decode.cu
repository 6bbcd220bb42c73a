// Paged single-token decode attention for Hopper: split keys (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/paged.py
// (_paged_decode_kernel, launched by paged_flash_decode): one query token
// per slot attends over the slot's KV pages, found through its row of the
// block table; keys past the slot's position (and outside an optional
// window) are masked, an optional tanh softcap bounds the logits, and the
// softmax runs online in float32.  int8 / fp8-e4m3 pools carry one float32
// scale per (page, KV head).
//
// Bound on the H100: bytes.  Each key and value is read once and used by
// the G = H / KV query rows of its KV head: 4 flops a byte at G = 4 for a
// bf16 pool, 8 for int8 (7 and 14 at G = 7: internvl2-1b and yi-34b; 3 and
// 6 at G = 3: llama3.2-3b; 2 and 4 at G = 2; 1 and 2 at G = 1: gpt3-xl,
// seamless-m4t-medium's decoder and zamba2-7b's shared block), far under
// the ~295 where the tensor cores would limit, and under the CUDA cores'
// 67 TFLOP/s f32 too (13-47
// TFLOP/s is what 3.35 TB/s needs).  So the kernel uses no tensor cores: an
// mma.m16n8k16 would hold G = 4 live rows of its 16.  What decides its
// time is how many bytes are in flight across the card, so:
//
// - The key axis is split (flash-decoding): the grid is (KV, B, n_split),
//   split s covering keys [s * kps, (s + 1) * kps), a whole number of
//   pages.  n_split = ceil(nb * page / kps) comes from the table width
//   alone, never from the positions, which live on the device (the grid
//   stays fixed for a CUDA graph).  A split wholly past the slot's last
//   page or before its window's first page writes an empty partial (max
//   -1e30, sum 0) and returns without loading.  At the llama serving
//   shape (KV 8, B 8, 1024 keys, kps 128) that is 512 blocks on 132 SMs.
// - Inside a block (4 warps), tiles of 64 keys arrive by 16-byte cp.async
//   into a 2-stage ring in shared memory, in the pool's own type (1 byte a
//   value for int8 / fp8), the next tile loading while this one computes.
//   The split's table entries and scales are read once.
// - Each warp takes 16 keys of a tile, D / 8 lanes to a key (8 values
//   each): at head_dim 64, 4 keys a step on 8 lanes each; at head_dim 128,
//   2 keys a step on 16 lanes each; at head_dim 192 and 224, one key a
//   step on 24 or 28 lanes, the other 8 or 4 holding zeros.  The dot
//   products with the G query rows (in registers, pre-scaled by D^-0.5)
//   reduce over a key's lanes by shuffles (over the whole warp at 192 and
//   224).
// - A lane holds G query rows, a (G, 8) accumulator and G scores for each
//   of its tile's steps: 7 x (8 + 8 + 8) at (128, 7) took 255 registers.
//   At nemotron-4-340b's (192, 12) a key is one step of 16 a tile, so the
//   scores alone would be 12 x 16.  There the G rows are split over NR
//   blocks (3 of 4 rows each, the grid's x axis KV * NR): a block runs the
//   kernel of a group of G / NR on KV head x / NR, its partials and its
//   output rows are those of "virtual KV head" x, and the combine pass
//   runs as for KV * NR heads of G / NR.  Each KV row is then read by NR
//   blocks of the same (slot, split), which run side by side, so the
//   repeats come from L2.
//   A quantized pool's scales multiply once per key: s = (q . k_q) * k_scale
//   and p * v_scale before P.V.  The (G, 8) accumulator of a lane stays in
//   registers with its warp's running max and sum; the warps merge through
//   shared memory once, at the end of the split.
// - Partials (max, sum, acc[G][D]) go in f32 to a workspace the wrapper
//   allocates; paged_decode_combine_kernel, launched next on the same
//   stream, rescales and sums them and writes acc / max(sum, 1e-20) in q's
//   type.  No atomics: two calls give bitwise-equal outputs.
#include "common.cuh"

constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecTileKeys = 64;     // keys per ring stage
constexpr int kDecWarpKeys = kDecTileKeys / kDecWarps;   // 16
constexpr int kDecLaneElems = 8;     // values of one key a lane holds
constexpr int kDecMaxSplitPages = 2 * kDecThreads;

// How a warp's lanes cover the keys at head_dim D: KEY_LANES lanes a key,
// STEP_KEYS keys a step, STEPS steps a tile; the first ACTIVE lanes hold
// a key.  DOT_SPAN is the span of a key's dot-product reduction: its own
// lanes when their count is a power of two (an xor butterfly stays within
// the group), else the whole warp (the idle lanes add zeros).
template <int D>
struct DecLanes {
  static constexpr int KEY_LANES = D / kDecLaneElems;
  static constexpr int STEP_KEYS = 32 / KEY_LANES;
  static constexpr int STEPS = kDecWarpKeys / STEP_KEYS;
  static constexpr int ACTIVE = STEP_KEYS * KEY_LANES;
  static constexpr int DOT_SPAN =
      (KEY_LANES & (KEY_LANES - 1)) == 0 ? KEY_LANES : 32;
  static_assert(D % kDecLaneElems == 0 && KEY_LANES <= 32 &&
                    kDecWarpKeys % STEP_KEYS == 0,
                "a key fits one warp, whole steps a tile");
};

// The 8 values of one key a lane holds, widened to float: 8, 16 or 32
// bytes of shared memory.
template <typename KT>
__device__ __forceinline__ void load8(const KT* src, float* dst) {
  if constexpr (sizeof(KT) == 1) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const KT* e = reinterpret_cast<const KT*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; i += 16 / sizeof(KT)) load16(src + i, dst + i);
  }
}

template <typename KT, int D, int G, int NR>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const KT* __restrict__ kp, const KT* __restrict__ vp,
                    const int* __restrict__ tables,
                    const int* __restrict__ positions,
                    const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales,
                    float* __restrict__ part, int H, int KV, int page, int nb,
                    int kps, int window, float softcap) {
  using L = DecLanes<D>;
  constexpr int E = kDecLaneElems, TK = kDecTileKeys;
  constexpr int VEC = 16 / sizeof(KT);        // values a 16-byte copy moves
  constexpr int CH = D / VEC;                 // 16-byte copies a key row
  static_assert(TK * CH % kDecThreads == 0, "whole copies per thread");
  // h: the block's group of G query rows (of KV * NR); hk: their KV head
  const int h = blockIdx.x, hk = h / NR, b = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // an idle lane (past L::ACTIVE) shadows the step's first key with zero
  // queries: its loads stay in the tile, its products are zero
  const bool active = lane < L::ACTIVE;
  const int kk = active ? lane / L::KEY_LANES : 0, c = lane % L::KEY_LANES;

  // partial of (b, h, s): max[G], sum[G], acc[G][D]
  float* pm = part + ((static_cast<size_t>(b) * gridDim.x + h) *
                             gridDim.z + s) * (G * (D + 2));
  float* pl = pm + G;
  float* pacc = pl + G;

  launch_dependents();
  // the split's table entries load beside the position, not after it
  const int pps = kps / page;
  const int* tbl = tables + static_cast<size_t>(b) * nb + s * pps;
  int pid_pre[kDecMaxSplitPages / kDecThreads];
#pragma unroll
  for (int i = 0; i < kDecMaxSplitPages / kDecThreads; ++i) {
    const int jp = i * kDecThreads + tid;
    pid_pre[i] = jp < pps && s * pps + jp < nb ? tbl[jp] : 0;
  }
  const int pos = positions[b];
  // pages holding positions <= pos; a frozen slot parked one past its last
  // reserved position may point past the table, which then bounds the walk
  const int n_pages = min(nb, pos / page + 1);
  const int first = window > 0 ? max(0, pos - window + 1) / page : 0;
  const int ja = max(s * pps, first), jb = min((s + 1) * pps, n_pages);
  if (ja >= jb) {                       // nothing of this split is visible
    if (tid < G) {
      pm[tid] = kNegInf;
      pl[tid] = 0.f;
    }
    return;
  }

  // entries and scales of the pages walked, indexed by page - s * pps
  __shared__ int tbl_sh[kDecMaxSplitPages];
  __shared__ float ks_sh[kDecMaxSplitPages], vs_sh[kDecMaxSplitPages];
#pragma unroll
  for (int i = 0; i < kDecMaxSplitPages / kDecThreads; ++i) {
    const int j = s * pps + i * kDecThreads + tid;
    if (j >= ja && j < jb) tbl_sh[j - s * pps] = pid_pre[i];
  }

  extern __shared__ __align__(16) unsigned char ring[];
  KT* k_sh = reinterpret_cast<KT*>(ring);     // [2][TK][D]
  KT* v_sh = k_sh + 2 * TK * D;               // [2][TK][D]
  const int ka = ja * page, kb = jb * page;   // keys this block walks
  const int n_tiles = (kb - ka + TK - 1) / TK;
  __syncthreads();                            // tbl_sh ready

  // keys at or past kb are zero-filled: no stale (NaN) bits reach P.V
  auto load_tile = [&](int i) {
    KT* kd = k_sh + (i & 1) * TK * D;
    KT* vd = v_sh + (i & 1) * TK * D;
    const int t0 = ka + i * TK;
#pragma unroll
    for (int it = 0; it < TK * CH / kDecThreads; ++it) {
      const int e = it * kDecThreads + tid;
      const int t = e / CH, ch = e % CH;
      const int key = t0 + t;
      const bool in = key < kb;
      size_t off = 0;
      if (in) {
        const int pid = tbl_sh[key / page - s * pps];
        off = ((static_cast<size_t>(pid) * page + key % page) * KV + hk) *
                  D + ch * VEC;
      }
      cp_async16(kd + t * D + ch * VEC, kp + off, in);
      cp_async16(vd + t * D + ch * VEC, vp + off, in);
    }
  };

  load_tile(0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1);
  cp_async_commit();

  // the scales and this lane's 8 values of each query row (times D^-0.5)
  // load while the first tiles are in flight; the loop's first barrier
  // publishes the scales
  const bool quantized = k_scales != nullptr;
#pragma unroll
  for (int i = 0; i < kDecMaxSplitPages / kDecThreads; ++i) {
    const int j = s * pps + i * kDecThreads + tid;
    if (j >= ja && j < jb) {
      const size_t at = static_cast<size_t>(pid_pre[i]) * KV + hk;
      ks_sh[j - s * pps] = quantized ? k_scales[at] : 1.f;
      vs_sh[j - s * pps] = quantized ? v_scales[at] : 1.f;
    }
  }
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  float qr[G][E];
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * H + h * G) * D +
                            c * E;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (active) {
      load16(qb + g * D, qr[g]);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] = 0.f;
    }
  }

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<1>();
    __syncthreads();                          // tile i landed for all
    const KT* kt = k_sh + (i & 1) * TK * D;
    const KT* vt = v_sh + (i & 1) * TK * D;
    const int t0 = ka + i * TK;
    float sc[L::STEPS][G];
    float vsc[L::STEPS];
#pragma unroll
    for (int st = 0; st < L::STEPS; ++st) {
      const int t = warp * kDecWarpKeys + st * L::STEP_KEYS + kk;
      const int key = t0 + t;
      float kv[E];
      load8(kt + t * D + c * E, kv);
      bool valid = key < kb && key <= pos;
      if (window > 0) valid = valid && key > pos - window;
      // a masked key's score and weight are never read from shared memory
      const int jp = valid ? key / page - s * pps : 0;
      const float ksc = valid ? ks_sh[jp] : 0.f;
      vsc[st] = valid ? vs_sh[jp] : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d += qr[g][e] * kv[e];
#pragma unroll
        for (int o = 1; o < L::DOT_SPAN; o <<= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        d *= ksc;
        if (softcap > 0.f) d = tanhf(d / softcap) * softcap;
        sc[st][g] = valid ? d : kNegInf;
      }
    }
    // online softmax over the warp's 16 keys of this tile
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int st = 1; st < L::STEPS; ++st) mx = fmaxf(mx, sc[st][g]);
#pragma unroll
      for (int o = L::DOT_SPAN; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      // masked keys hold kNegInf, so their exp underflows to exactly 0
      const float m_safe = m_new <= kNegInf ? 0.f : m_new;
      const float corr = m[g] <= kNegInf ? 0.f : expf(m[g] - m_safe);
      m[g] = m_new;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int st = 0; st < L::STEPS; ++st) {
        const float p = expf(sc[st][g] - m_safe);
        l[g] += p;
        sc[st][g] = p * vsc[st];
      }
    }
#pragma unroll
    for (int st = 0; st < L::STEPS; ++st) {
      const int t = warp * kDecWarpKeys + st * L::STEP_KEYS + kk;
      float vv[E];
      load8(vt + t * D + c * E, vv);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += sc[st][g] * vv[e];
    }
    __syncthreads();                          // stage i & 1 consumed
    if (i + 2 < n_tiles) load_tile(i + 2);
    cp_async_commit();
  }

  // sum over the warp's key lane groups (4 at head_dim 64, 2 at 128, one
  // at 224), then merge the 4 warps
  __shared__ float red_m[kDecWarps][G], red_l[kDecWarps][G];
  __shared__ __align__(16) float red_acc[kDecWarps][G * D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o = L::DOT_SPAN; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
    if (active && kk == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) red_acc[warp][g * D + c * E + e] = acc[g][e];
    }
    if (lane == 0) {
      red_m[warp][g] = m[g];
      red_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  for (int o = tid; o < G * D; o += kDecThreads) {
    const int g = o / D;
    float M = red_m[0][g];
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w) M = fmaxf(M, red_m[w][g]);
    const float M_safe = M <= kNegInf ? 0.f : M;
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float f = expf(red_m[w][g] - M_safe);
      a += red_acc[w][o] * f;
      L += red_l[w][g] * f;
    }
    pacc[o] = a;
    if (o % D == 0) {
      pm[g] = M;
      pl[g] = L;
    }
  }
}

// Merges the n_split partials of one (slot, KV head): out = sum_s
// acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), M = max_s m_s.  An empty
// split (max -1e30) wrote no accumulator and is skipped.
template <typename QT, int D, int G>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_combine_kernel(const float* __restrict__ part,
                            QT* __restrict__ out, int H, int KV,
                            int n_split) {
  constexpr int stride = G * (D + 2);
  const int h = blockIdx.x, b = blockIdx.y;
  const float* base = part + (static_cast<size_t>(b) * KV + h) * n_split *
                                 stride;
  QT* ob = out + (static_cast<size_t>(b) * H + h * G) * D;
  wait_for_prerequisites();
  for (int o = threadIdx.x; o < G * D; o += kDecThreads) {
    const int g = o / D;
    float M = kNegInf;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, base[s * stride + g]);
    float a = 0.f, L = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float* ps = base + s * stride;
      if (ps[g] <= kNegInf) continue;
      const float f = expf(ps[g] - M);
      L += ps[G + g] * f;
      a += ps[2 * G + o] * f;
    }
    ob[o] = from_float<QT>(a / fmaxf(L, 1e-20f));
  }
}

// G query rows a KV head, run as NR blocks of G / NR rows
template <typename KT, int D, int G, int NR = 1>
static int launch_paged(const void* q, const void* kp, const void* vp,
                        const int* tables, const int* pos, const float* ks,
                        const float* vs, float* part, void* out, int B, int H,
                        int KV, int page, int nb, int kps, int window,
                        float softcap, cudaStream_t stream) {
  using QT = __nv_bfloat16;
  static_assert(G % NR == 0, "whole rows a block");
  constexpr int GB = G / NR;
  if (KV <= 0 || H != G * KV || page <= 0 || kps <= 0 || kps % page ||
      kps / page > kDecMaxSplitPages)
    return static_cast<int>(cudaErrorInvalidValue);
  // as kernels/flash_attention/paged.py:split_plan, which sizes the
  // workspace
  const int n_split = (nb * page + kps - 1) / kps;
  const size_t smem = 2 * 2 * sizeof(KT) * kDecTileKeys * D;
  auto kernel = paged_decode_kernel<KT, D, GB, NR>;
  // the ring is dynamic shared memory; beside the static merge buffer
  // (4 x G x D floats: 14 KB at (128, 7)) it can pass the 48 KB a launch
  // gets without opting in even when the ring alone does not (an int8
  // ring at (128, 7): 32 KB + 17.5 KB), so every instantiation opts in
  // to its ring's size once
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  kernel<<<dim3(KV * NR, B, n_split), kDecThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), tables, pos, ks, vs, part, H, KV, page, nb,
      kps, window, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KV * NR, B);
  cfg.blockDim = dim3(kDecThreads);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const float* cpart = part;
  err = cudaLaunchKernelEx(&cfg, paged_decode_combine_kernel<QT, D, GB>,
                           cpart, static_cast<QT*>(out), H, KV * NR,
                           n_split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The pool types of each (head_dim, query group) instantiation, its G
// rows in NR blocks.
template <int D, int G, int NR = 1>
static int launch_pool(int kv_dtype, const void* q, const void* kp,
                       const void* vp, const int* t, const int* p,
                       const float* ks, const float* vs, float* w, void* out,
                       int B, int H, int KV, int page, int nb, int kps,
                       int window, float softcap, cudaStream_t s) {
  switch (kv_dtype) {
    case kBF16:
      return launch_paged<__nv_bfloat16, D, G, NR>(q, kp, vp, t, p, ks, vs,
                                                   w, out, B, H, KV, page,
                                                   nb, kps, window, softcap,
                                                   s);
    case kI8:
      return launch_paged<int8_t, D, G, NR>(q, kp, vp, t, p, ks, vs, w, out,
                                            B, H, KV, page, nb, kps, window,
                                            softcap, s);
  }
  if constexpr (D == 64 && (G == 2 || G == 4)) {  // every pool
    switch (kv_dtype) {
      case kF32:
        return launch_paged<float, D, G>(q, kp, vp, t, p, ks, vs, w, out, B,
                                         H, KV, page, nb, kps, window,
                                         softcap, s);
      case kFP8:
        return launch_paged<__nv_fp8_e4m3, D, G>(q, kp, vp, t, p, ks, vs, w,
                                                 out, B, H, KV, page, nb,
                                                 kps, window, softcap, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Built for bf16 queries (the serving path's compute type) at head_dim 64
// with 4 query heads per KV head (llama3.2-1b) and with 2 (the reduced
// config of a smoke run on the card; granite-moe's attention) over bf16,
// f32, int8 and fp8-e4m3 pools, and at head_dim 128 and 224 with one
// query head per KV head (gpt3-xl; zamba2-7b's shared attention block), at
// head_dim 128 with 3 (llama3.2-3b: a lane holds 3 query rows and a
// (3, 8) accumulator) and with 7 (yi-34b), and at head_dim 64 with 7
// (internvl2-1b) and with 1 (seamless-m4t-medium's decoder, 16 heads over
// 16: a lane holds one query row and a (1, 8) accumulator, as at (128, 1))
// over bf16 and int8 pools, and at head_dim 128 with 5 (llama4-scout's
// global layers) and at head_dim 192 with 12 (nemotron-4-340b, its rows
// in 3 blocks of 4) over bf16 and int8 pools.  At G 7 a lane holds 7
// query rows, a (7, 8) accumulator and 7 scores a step of its tile, and
// the warps' merge buffer is 4 x 7 x D floats (14 KB at D 128);
// chip_smoke.py's build phase logs their registers and spills;
// kernels/flash_attention/paged.py:KERNEL_CASES lists the same, and
// chip_smoke.py checks every one of them.  `workspace` holds
// B * KV * n_split * G * (D + 2) floats.
extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* pos, const void* k_scales,
                                   const void* v_scales, void* workspace,
                                   void* out, int B, int H, int KV, int D,
                                   int page, int nb, int keys_per_split,
                                   int window, float softcap, int q_dtype,
                                   int kv_dtype, void* stream) {
  if (q_dtype != kBF16 || KV <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  float* w = static_cast<float*>(workspace);
  if (D == 64 && H == 4 * KV)
    return launch_pool<64, 4>(kv_dtype, q, k_pages, v_pages, t, p, ks, vs, w,
                              out, B, H, KV, page, nb, keys_per_split, window,
                              softcap, s);
  if (D == 64 && H == 2 * KV)
    return launch_pool<64, 2>(kv_dtype, q, k_pages, v_pages, t, p, ks, vs, w,
                              out, B, H, KV, page, nb, keys_per_split, window,
                              softcap, s);
  if (D == 128 && H == KV)
    return launch_pool<128, 1>(kv_dtype, q, k_pages, v_pages, t, p, ks, vs,
                               w, out, B, H, KV, page, nb, keys_per_split,
                               window, softcap, s);
  if (D == 128 && H == 3 * KV)
    return launch_pool<128, 3>(kv_dtype, q, k_pages, v_pages, t, p, ks, vs,
                               w, out, B, H, KV, page, nb, keys_per_split,
                               window, softcap, s);
  if (D == 64 && H == KV)
    return launch_pool<64, 1>(kv_dtype, q, k_pages, v_pages, t, p, ks, vs, w,
                              out, B, H, KV, page, nb, keys_per_split, window,
                              softcap, s);
  if (D == 64 && H == 7 * KV)
    return launch_pool<64, 7>(kv_dtype, q, k_pages, v_pages, t, p, ks, vs, w,
                              out, B, H, KV, page, nb, keys_per_split, window,
                              softcap, s);
  if (D == 128 && H == 7 * KV)
    return launch_pool<128, 7>(kv_dtype, q, k_pages, v_pages, t, p, ks, vs,
                               w, out, B, H, KV, page, nb, keys_per_split,
                               window, softcap, s);
  if (D == 128 && H == 5 * KV)
    return launch_pool<128, 5>(kv_dtype, q, k_pages, v_pages, t, p, ks, vs,
                               w, out, B, H, KV, page, nb, keys_per_split,
                               window, softcap, s);
  if (D == 192 && H == 12 * KV)
    return launch_pool<192, 12, 3>(kv_dtype, q, k_pages, v_pages, t, p, ks,
                                   vs, w, out, B, H, KV, page, nb,
                                   keys_per_split, window, softcap, s);
  if (D == 224 && H == KV)
    return launch_pool<224, 1>(kv_dtype, q, k_pages, v_pages, t, p, ks, vs,
                               w, out, B, H, KV, page, nb, keys_per_split,
                               window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
