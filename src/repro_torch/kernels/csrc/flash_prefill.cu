// Prefill flash attention with per-row valid lengths, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_fwd_kernel, launched by flash_attention_fwd), extended by what
// serving prefill computes (src/repro/models/common.py:chunked_attention
// with kv_valid_len): rows of a batch are right-padded to one bucket, and
// row b's keys at positions >= kv_valid_len[b] are masked.  Causal, local
// window and tanh softcap masks as in the TPU kernel; GQA reads KV head
// h / G with no repeat; f32 online softmax; q * scale is rounded to the
// input dtype before QK^T and the softmax weights before the PV product, as
// the reference does.  With a non-null lse pointer it also writes the
// log-sum-exp (B, H, Sq) in f32, m + log(max(l, 1e-20)) with m := 0 for a
// row that saw no key, as the TPU kernel does with return_lse
// (kernel.py:77-82); the training forward saves it for the backward
// (flash_backward.cu).
//
// A padded query row (position >= kv_valid_len) whose causal/window range
// holds no valid key gets what the reference's chunked_attention gives it:
// the reference masks invalid keys by setting their score to -1e30 and
// zeroes the softmax weights by the causal/window mask only, so such a row
// averages the values of the keys that mask admits.  The key loop below
// stops at the valid length and never reads those keys, so the kernel
// takes that average in an explicit branch after the loop.
//
// Queries and keys are counted apart: Sq and Sk are independent, query
// position i sits at i and key position j at j (q_offset 0), so the
// kernel serves a decoder's causal self-attention (Sq == Sk), an
// encoder's non-causal self-attention and a decoder's non-causal
// cross-attention (seamless-m4t-medium: a prompt bucket of 32..512 text
// positions over 1024 encoder frames).  Without the causal mask every
// query tile walks the same ceil(kv_valid / 64) key tiles, so the
// heaviest-first order below is moot and a tile is full exactly when its
// keys all lie below the valid length; the "no valid key" branch is taken
// only by a row with kv_valid_len 0, whose mean then runs over all Sk
// keys as the reference's does.  A query tile past Sq (a bucket of 32 or
// 37 rows in the 64-row tile) loads zero rows and stores none of them.
//
// Bound on the H100: operations at long prompts (2 * D flops per score for
// QK and again for PV against 2 * D bytes per key read once per 64-row query
// tile), bytes at short ones.  Design: both products run on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulation; mma.cuh).  One block
// of 4 warps per (64-row query tile, head, batch row); each warp owns 16
// query rows, whose scaled Q fragments stay in registers for the whole key
// loop.  64-key K/V tiles come in by cp.async into a 2-stage ring of
// swizzled shared tiles (the next tile loads while this one computes) and
// are read with ldmatrix (.trans for V).  S = Q K^T lands in accumulator
// fragments; the online softmax runs on them in registers (row max and sum
// over the 4 lanes of a quad); P is packed to bf16 in registers as the A
// operand of P V.  The loop stops at the causal and valid-length bound and
// starts at the window's first key; masks are evaluated only on tiles that
// cut them.  The heaviest causal query tiles are launched first, and the
// output leaves through shared memory in 16-byte stores.
#include "mma.cuh"

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;
// 4 blocks an SM: ptxas then fits the kernel in 128 registers without a
// spill (about 160 uncapped, 3 blocks), and the fourth block's warps hide
// more of the softmax's latency (PERF.md)
constexpr int kFwdBlocksPerSM = 4;
constexpr int kBQ = 16 * kFwdWarps;  // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kTileElems = 64 * kRowElems;
constexpr float kLog2e = 1.4426950408889634f;

// lower end of the window of a query at qpos (0 without a window)
__device__ __forceinline__ int window_lower(int qpos, int window) {
  return window > 0 ? max(0, qpos - window + 1) : 0;
}

// D^-0.5 rounded to bf16: the reference multiplies bf16 q by a weak-typed
// Python float, which JAX rounds to bf16 before the product
__device__ __forceinline__ float bf16_query_scale(int D) {
  return __bfloat162float(
      __float2bfloat16(1.f / sqrtf(static_cast<float>(D))));
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocksPerSM)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ kv_valid_len,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int Sq, int Sk, int G, long long q_sb, long long q_ss,
                     long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, long long o_sb, long long o_ss,
                     long long o_sh, int causal, int window, float softcap) {
  static_assert(D == kRowElems, "tiles hold 64-element rows");
  // the last query tiles see the most keys under the causal mask: launch
  // them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;  // the warp's first row in the tile

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kTileElems;      // 2 stages
  __nv_bfloat16* v_s = k_s + 2 * kTileElems;  // 2 stages

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;
  const int vl = kv_valid_len[b];
  const int kv_valid = min(Sk, vl);
  int kv_end = kv_valid;
  if (causal) kv_end = min(kv_end, q0 + kBQ);
  const int kv_begin = (window_lower(q0, window) / kBK) * kBK;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kBK - 1) / kBK
                                        : 0;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = kv_begin + tile * kBK;
    load_tile_async<kBK, kFwdThreads>(k_s + stage * kTileElems, kb, k_ss, k0,
                                      Sk);
    load_tile_async<kBK, kFwdThreads>(v_s + stage * kTileElems, vb, v_ss, k0,
                                      Sk);
  };
  load_tile_async<kBQ, kFwdThreads>(q_s, qb, q_ss, q0, Sq);
  cp_async_commit();
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has arrived
  __syncthreads();

  // q * scale rounded to bf16, as the reference scales q in its own dtype
  // by a factor it first rounds to that dtype (exact at D 64)
  const float scale = bf16_query_scale(D);
  unsigned qa[4][4];
  load_a_frags(qa, q_s, wrow, lane);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&qa[kc][i]));
      qa[kc][i] = pack_bf16(f.x * scale, f.y * scale);
    }

  const int qpos[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this lane's share; summed over the quad

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kv_begin + j * kBK, stage = j & 1;
    if (j + 1 < n_tiles) load_kv(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j has arrived
    __syncthreads();

    float s[8][4];
    mma_a_tnk(s, qa, k_s + stage * kTileElems, lane);
    // every (query, key) pair of the block's tile admitted: no mask needed
    const bool full = k0 + kBK <= kv_valid &&
                      (!causal || k0 + kBK - 1 <= q0) &&
                      (window <= 0 || q0 + kBQ - 1 - k0 < window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if (!full) {
          const int kpos = k0 + nt * 8 + 2 * t + (i & 1), qp = qpos[i >> 1];
          bool ok = kpos < kv_valid;
          if (causal) ok = ok && kpos <= qp;
          if (window > 0) ok = ok && qp - kpos < window;
          if (!ok) x = kNegInf;
        }
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float corr[2], m_scaled[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four lanes of a quad hold one row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      const float m_safe = m_new <= kNegInf ? 0.f : m_new;
      corr[r] = m_run[r] <= kNegInf ? 0.f : exp2f((m_run[r] - m_safe) * kLog2e);
      m_scaled[r] = m_safe * kLog2e;
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
    // a masked score is -1e30: its weight underflows to exactly 0
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(fmaf(s[nt][i], kLog2e, -m_scaled[i >> 1]));
        l_run[i >> 1] += p;
        s[nt][i] = p;
        acc[nt][i] *= corr[i >> 1];
      }
    unsigned pa[4][4];
    c_to_a(pa, s);  // P rounded to bf16, as the reference rounds it
    mma_a_tkn(acc, pa, v_s + stage * kTileElems, lane);
    __syncthreads();  // the stage is free for the load issued next
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const float l = fmaxf(l_run[r], 1e-20f);
    inv[r] = 1.f / l;
    const bool no_key = window_lower(qpos[r], window) >= kv_valid;
    if (lse != nullptr && t == 0 && qpos[r] < Sq && !no_key)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qpos[r]] =
          (m_run[r] <= kNegInf ? 0.f : m_run[r]) + logf(l);
  }
  // the warp's own rows of q_s (no other warp reads them) stage the output
  stage_c(q_s, acc, wrow, inv[0], inv[1], lane);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int qp = q0 + wrow + r;
    const int lower = window_lower(qp, window);
    if (qp >= Sq || lower < kv_valid) continue;
    // no valid key: the plain mean of the values the causal/window mask
    // admits (every admitted weight is exp(0) = 1 in the reference)
    const int upper = causal ? min(qp, Sk - 1) : Sk - 1;
    float2 sum = make_float2(0.f, 0.f);
    for (int kk = lower; kk <= upper; ++kk) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<
          const __nv_bfloat162*>(vb + kk * v_ss + 2 * lane));
      sum.x += x.x;
      sum.y += x.y;
    }
    const float l = fmaxf(static_cast<float>(max(upper - lower + 1, 0)),
                          1e-20f);
    const float il = 1.f / l;
    *reinterpret_cast<unsigned*>(q_s + swz(wrow + r, 2 * lane)) =
        pack_bf16(sum.x * il, sum.y * il);
    if (lse != nullptr && lane == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qp] = logf(l);
  }
  __syncwarp();
  store_rows16(out + b * o_sb + h * o_sh, o_ss, q_s, wrow, q0 + wrow, Sq,
               lane);
}

template <int D>
static int launch_prefill(const void* q, const void* k, const void* v,
                          const int* vl, void* out, float* lse, int B,
                          int Sq, int Sk, int H, int KV, const long long* st,
                          int causal, int window, float softcap,
                          cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * 5 * kTileElems;  // Q, 2 x K/V
  auto kernel = flash_prefill_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), vl,
      static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, H / KV, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Wide rows: head_dim 128 (gpt3-xl, llama3.2-3b, yi-34b,
// llama4-scout-17b-a16e), 192 (nemotron-4-340b) and 224 (zamba2-7b's
// shared attention block).  The design above, reshaped for rows longer
// than the 64-element tiles of mma.cuh:
// - A 224-element row is 28 16-byte chunks, which the 8-chunk XOR swizzle
//   of those tiles does not tile.  These tiles keep each row at a pitch of
//   D + 8 elements instead: at 224, 29 chunks (116 words, 20 banks on from
//   the row before), so the 8 rows one ldmatrix phase reads at one column
//   start at banks 0, 20, 8, 28, 16, 4, 24, 12; at 192, 25 chunks (100
//   words, 4 banks on) and at 128, 17 chunks (68 words, 4 banks on), so
//   they start at banks 0, 4, .., 28.  Either way they cover the 32 banks
//   once (the epilogue's 4-byte stores likewise).  (192 is 24 chunks, a
//   whole number of the swizzle's 8, but one pitch for every wide row
//   keeps one kernel.)
// - Registers: a warp's 16 x D f32 accumulator is D / 2 a lane (112 at
//   224, 96 at 192, 64 at 128), and Q's fragments would be D / 4 more (56,
//   48, 32).  At 224 they do not fit beside it, so Q is scaled in shared
//   memory once and its fragments are re-read by ldmatrix at every k-step;
//   128 and 192 run the same code (the re-read costs shared-memory
//   bandwidth, not registers).  The key tiles hold 32 keys (16 score
//   registers, not 32).
// - Shared memory: Q (64 rows) and a 2-stage K/V ring of 32-key tiles,
//   87 KB at 224, 75 KB at 192 and 52 KB at 128; two blocks an SM fit in
//   its 227 KB at each, and __launch_bounds__(.., 2) lets ptxas use up to
//   255 registers a thread (chip_smoke.py's build phase logs what it
//   took).
// - A local window (llama4-scout's local layers: 8192) starts the key
//   loop at the tile of the block's first query's window_lower and masks
//   the tiles that cut the window pair by pair, as the 64-wide kernel
//   does; a padded query row whose window lies wholly past its row's
//   valid length takes the no-valid-key branch after the loop.
// ---------------------------------------------------------------------------

constexpr int kWideBK = 32;          // keys per tile at head_dim 128 and 224

// Rows [row0, row0 + ROWS) of a (rows, D) bf16 slice into a tile of pitch
// D + 8; rows at or past `rows` are zero-filled.
template <int ROWS, int D>
__device__ __forceinline__ void load_pitched_async(__nv_bfloat16* dst,
                                                   const __nv_bfloat16* src,
                                                   long long row_stride,
                                                   int row0, int rows) {
  constexpr int CH = D / 8, PITCH = D + 8;
  static_assert(ROWS * CH % kFwdThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / kFwdThreads; ++it) {
    const int i = it * kFwdThreads + threadIdx.x;
    const int r = i / CH, c = i % CH;
    const bool in = row0 + r < rows;
    const __nv_bfloat16* s =
        in ? src + static_cast<long long>(row0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + r * PITCH + c * 8, s, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 2)
flash_prefill_wide_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ kv_valid_len,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int Sq, int Sk, int G,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long v_sb, long long v_ss, long long v_sh,
                          long long o_sb, long long o_ss, long long o_sh,
                          int causal, int window, float softcap) {
  constexpr int PITCH = D + 8, CH = D / 8;
  constexpr int KC = D / 16;         // k-steps of Q K^T
  constexpr int NT = D / 8;          // n-tiles of the P V accumulator
  constexpr int BK = kWideBK, ST = BK / 8;
  static_assert(D % 16 == 0 && CH % 2 == 0, "whole k-steps and n-pairs");
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBQ * PITCH;        // 2 stages
  __nv_bfloat16* v_s = k_s + 2 * BK * PITCH;     // 2 stages

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;
  const int kv_valid = min(Sk, kv_valid_len[b]);
  int kv_end = kv_valid;
  if (causal) kv_end = min(kv_end, q0 + kBQ);
  const int kv_begin = (window_lower(q0, window) / BK) * BK;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK
                                        : 0;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = kv_begin + tile * BK;
    load_pitched_async<BK, D>(k_s + stage * BK * PITCH, kb, k_ss, k0, Sk);
    load_pitched_async<BK, D>(v_s + stage * BK * PITCH, vb, v_ss, k0, Sk);
  };
  load_pitched_async<kBQ, D>(q_s, qb, q_ss, q0, Sq);
  cp_async_commit();
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has arrived
  __syncthreads();
  // q * scale rounded to bf16 in place, once (the reference's rounding)
  const float scale = bf16_query_scale(D);
  for (int i = threadIdx.x; i < kBQ * CH; i += kFwdThreads) {
    uint4* p = reinterpret_cast<uint4*>(q_s + (i / CH) * PITCH + (i % CH) * 8);
    uint4 raw = *p;
    unsigned* w = reinterpret_cast<unsigned*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
      w[j] = pack_bf16(f.x * scale, f.y * scale);
    }
    *p = raw;
  }
  __syncthreads();

  const int qpos[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this lane's share; summed over the quad

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kv_begin + j * BK, stage = j & 1;
    if (j + 1 < n_tiles) load_kv(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j has arrived
    __syncthreads();
    const __nv_bfloat16* kt = k_s + stage * BK * PITCH;
    const __nv_bfloat16* vt = v_s + stage * BK * PITCH;

    // S = Q K^T over the tile's 32 keys, Q's fragments read at each k-step
    float s[ST][4];
#pragma unroll
    for (int i = 0; i < ST; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      unsigned a[4];
      ldsm_x4(a, q_s + (wrow + (lane & 15)) * PITCH + kc * 16 +
                     (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < ST / 2; ++np) {
        unsigned bf[4];
        ldsm_x4(bf, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * PITCH +
                        kc * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }
    const bool full = k0 + BK <= kv_valid &&
                      (!causal || k0 + BK - 1 <= q0) &&
                      (window <= 0 || q0 + kBQ - 1 - k0 < window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < ST; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if (!full) {
          const int kpos = k0 + nt * 8 + 2 * t + (i & 1), qp = qpos[i >> 1];
          bool ok = kpos < kv_valid;
          if (causal) ok = ok && kpos <= qp;
          if (window > 0) ok = ok && qp - kpos < window;
          if (!ok) x = kNegInf;
        }
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float corr[2], m_scaled[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      const float m_safe = m_new <= kNegInf ? 0.f : m_new;
      corr[r] = m_run[r] <= kNegInf ? 0.f : exp2f((m_run[r] - m_safe) * kLog2e);
      m_scaled[r] = m_safe * kLog2e;
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < ST; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(fmaf(s[nt][i], kLog2e, -m_scaled[i >> 1]));
        l_run[i >> 1] += p;
        s[nt][i] = p;
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] *= corr[i >> 1];
    // P rounded to bf16 as the A operand of P V (two k-steps of 16 keys)
    unsigned pa[ST / 2][4];
#pragma unroll
    for (int kc = 0; kc < ST / 2; ++kc) {
      pa[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
    }
#pragma unroll
    for (int kc = 0; kc < ST / 2; ++kc)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned bf[4];
        ldsm_x4_trans(bf, vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   PITCH +
                              np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], pa[kc], bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], pa[kc], bf[2], bf[3]);
      }
    __syncthreads();  // the stage is free for the load issued next
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const float l = fmaxf(l_run[r], 1e-20f);
    inv[r] = 1.f / l;
    const bool no_key = window_lower(qpos[r], window) >= kv_valid;
    if (lse != nullptr && t == 0 && qpos[r] < Sq && !no_key)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qpos[r]] =
          (m_run[r] <= kNegInf ? 0.f : m_run[r]) + logf(l);
  }
  // the warp's own rows of q_s (no other warp reads them) stage the output
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<unsigned*>(q_s + (wrow + g) * PITCH + col) =
        pack_bf16(acc[nt][0] * inv[0], acc[nt][1] * inv[0]);
    *reinterpret_cast<unsigned*>(q_s + (wrow + g + 8) * PITCH + col) =
        pack_bf16(acc[nt][2] * inv[1], acc[nt][3] * inv[1]);
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int qp = q0 + wrow + r;
    const int lower = window_lower(qp, window);
    if (qp >= Sq || lower < kv_valid) continue;
    // no valid key: the plain mean of the values the causal/window mask
    // admits, as in flash_prefill_kernel
    const int upper = causal ? min(qp, Sk - 1) : Sk - 1;
    const float l = fmaxf(static_cast<float>(max(upper - lower + 1, 0)),
                          1e-20f);
    const float il = 1.f / l;
    for (int cp = lane; cp < D / 2; cp += 32) {
      float2 sum = make_float2(0.f, 0.f);
      for (int kk = lower; kk <= upper; ++kk) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<
            const __nv_bfloat162*>(vb + kk * v_ss + 2 * cp));
        sum.x += x.x;
        sum.y += x.y;
      }
      *reinterpret_cast<unsigned*>(q_s + (wrow + r) * PITCH + 2 * cp) =
          pack_bf16(sum.x * il, sum.y * il);
    }
    if (lse != nullptr && lane == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qp] = logf(l);
  }
  __syncwarp();
  __nv_bfloat16* ob = out + b * o_sb + h * o_sh;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH, qp = q0 + wrow + r;
    if (qp < Sq)
      *reinterpret_cast<uint4*>(ob + qp * o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + (wrow + r) * PITCH + c * 8);
  }
}

template <int D>
static int launch_prefill_wide(const void* q, const void* k, const void* v,
                               const int* vl, void* out, float* lse, int B,
                               int Sq, int Sk, int H, int KV,
                               const long long* st, int causal, int window,
                               float softcap, cudaStream_t stream) {
  // Q and a 2-stage K/V ring, rows at a pitch of D + 8
  const size_t smem = sizeof(__nv_bfloat16) * (kBQ + 4 * kWideBK) * (D + 8);
  auto kernel = flash_prefill_wide_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), vl,
      static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, H / KV, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

// Built for bf16 at head_dim 64 (any query group: llama3.2-1b's,
// granite-moe-1b-a400m's and seamless-m4t-medium's serving and training
// paths, the last causal and not), at head_dim 128 and
// 224 with one query head per KV head (gpt3-xl; zamba2-7b's shared
// attention block), at head_dim 128 with 3, 5 and 7 (llama3.2-3b,
// llama4-scout-17b-a16e with its local window, yi-34b: the wide kernel
// reads KV head h / G, so only the grid changes) and at head_dim 192 with
// 12 (nemotron-4-340b); other cases are refused
// until a configuration needs them and chip_smoke.py checks them.
// lse may be null.
// Strides are in elements; the wrapper makes each a multiple of 8 (16-byte
// rows for cp.async) with unit stride along D.
extern "C" int flash_prefill_launch(
    const void* q, const void* k, const void* v, const void* kv_valid_len,
    void* out, void* lse, int B, int Sq, int Sk, int H, int KV, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, int dtype, void* stream) {
  if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const int* vl = static_cast<const int*>(kv_valid_len);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_prefill<64>(q, k, v, vl, out, l, B, Sq, Sk, H, KV, st,
                              causal, window, softcap, s);
  if (D == 128 &&
      (H == KV || H == 3 * KV || H == 5 * KV || H == 7 * KV))
    return launch_prefill_wide<128>(q, k, v, vl, out, l, B, Sq, Sk, H, KV,
                                    st, causal, window, softcap, s);
  if (D == 192 && H == 12 * KV)
    return launch_prefill_wide<192>(q, k, v, vl, out, l, B, Sq, Sk, H, KV,
                                    st, causal, window, softcap, s);
  if (D == 224 && H == KV)
    return launch_prefill_wide<224>(q, k, v, vl, out, l, B, Sq, Sk, H, KV,
                                    st, causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
