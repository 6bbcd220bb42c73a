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
// Rounding: the products run on the tensor cores in bf16 with f32
// accumulation, so q * scale, P and dS are rounded to bf16 before the
// products that take them (P and dS are computed in f32 first).  q * scale
// is rounded as the forward (flash_prefill.cu) rounds it, so both see the
// same scores: scale is D^-0.5 rounded to bf16, and q * scale is rounded to
// bf16 once.  At head_dim 64 the scale is 2^-3: q * scale is exact in
// bf16, and scaling an f32 product by it is exact too, which the 64-wide
// dK/dV kernel uses (it reads the raw q tile and scales its products).  At
// head_dim 128 (bf16 scale 0.08837891) and 224 (0.06689453) neither holds,
// so a pre-pass writes the rounded q * scale once, and the wide kernels
// read that tile in the scores and in dK (second half of this file).
//
// Bound on the H100: operations.  Per admitted (query, key) pair the
// gradient needs 5 products of 2 * D flops (QK^T, dO V^T, dS K, P^T dO,
// dS^T Q) against 2 * D bytes per row read once; these kernels do 7, since
// the dK/dV kernel recomputes QK^T and dO V^T.  The wrapper launches them
// for what the training paths give them: causal attention at Sq == Sk (a
// decoder's self-attention), with a local window (llama4-scout's local
// layers: dQ's key loop starts at the tile of its first query's window,
// dK/dV's query loop ends at the last query whose window reaches the
// tile's last key) or not, and non-causal attention without one at any Sq
// and Sk (an encoder's self-attention at Sq == Sk; a decoder's
// cross-attention, Sq text positions over Sk encoder frames).  Query rows
// and keys are counted separately everywhere: the dQ grid runs over Sq and
// its key loop to Sk, the dK/dV grid over Sk and its query loop to Sq; a
// partial last tile of either (rows past Sq or keys past Sk, zero-filled
// on load) fails tile_full and is masked pair by pair by admitted().
// Design (deterministic: no atomics, every sum in a fixed order, so two
// calls on the same inputs give bitwise-equal gradients):
//
// - delta: a pre-pass computes rowsum(dO * O) once per query row into an f32
//   scratch (B, H, Sq) that both kernels read, instead of recomputing it
//   per tile as the TPU kernels do (that would read O once per key tile).
// - dQ: one block of 4 warps per (64-row query tile, head, batch row); each
//   warp owns 16 query rows, whose scaled Q and dO fragments stay in
//   registers.  It loops over 64-key tiles (cp.async into a 2-stage ring of
//   swizzled shared tiles) from the window's first key up to the causal
//   bound: S = Q K^T and dP = dO V^T on the mma, P and dS in f32 registers,
//   then dS packed to bf16 as the A operand of dQ += dS K (K through
//   ldmatrix.trans).  The heaviest query tiles are launched first.
// - dK/dV: one block of 4 warps per (64-key tile, KV head, batch row); each
//   warp owns 16 key rows, whose K and V fragments stay in registers.  It
//   loops over the G query heads of its group and, for each, over the query
//   tiles from the causal start, or from 0 without the causal mask (a
//   2-stage ring of Q, dO, lse and delta tiles).  The scores come out
//   transposed, S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T lie in
//   accumulator layout and feed dV += P^T dO and dK += dS^T Q directly as
//   bf16 A operands.  The group's sum stays in f32 registers: no KV repeat
//   in memory and no atomics.  Load balance, causal: key tile 0 sees the
//   most query tiles and is launched first; at S 1024 and G 4 it runs 64
//   iterations and the last tile 4, against a mean of 34; the 512 blocks
//   of the training shape fill the card's slots (two blocks an SM at this
//   kernel's register count) about twice, and launching the heaviest first
//   lets the light ones fill in behind them, so the group is not split
//   over blocks (that would need a second pass to add the halves without
//   atomics).  Non-causal, every key tile walks the same G * ceil(Sq / 64)
//   query tiles, so the blocks are equal: at seamless-m4t-medium's encoder
//   (Sq = Sk = 1024, G 1, 16 heads, B 4) 16 iterations each over 1024
//   blocks, at its cross-attention (Sq 512 over Sk 1024) 8 each over the
//   same 1024 blocks, and the dQ grid's 64-row query tiles each walk all
//   Sk / 64 key tiles.
//
// Layouts are the model's, contiguous: q, o, dO, dQ (B, Sq, H, D);
// k, v, dK, dV (B, Sk, KV, D); lse, delta (B, H, Sq) f32.
#include "mma.cuh"

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBT = 16 * kBwdWarps;  // query rows (dQ) or keys (dK/dV)
constexpr int kTileElems = kBT * kRowElems;
constexpr int kDeltaLanes = 8;       // threads per row in the delta pre-pass
constexpr float kLog2e = 1.4426950408889634f;

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

// Every pair of a (64-query tile at q0, 64-key tile at k0) is admitted, so
// the tile needs no mask.
__device__ __forceinline__ bool tile_full(int q0, int k0, int Sq, int Sk,
                                          int causal, int window) {
  return q0 + kBT <= Sq && k0 + kBT <= Sk &&
         (!causal || k0 + kBT - 1 <= q0) &&
         (window <= 0 || q0 + kBT - 1 - k0 < window);
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
                    int KV, int causal, int window, float scale) {
  static_assert(D == kRowElems, "tiles hold 64-element rows");
  // the last query tiles see the most keys under the causal mask: launch
  // them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + kTileElems;
  __nv_bfloat16* k_s = do_s + kTileElems;     // 2 stages
  __nv_bfloat16* v_s = k_s + 2 * kTileElems;  // 2 stages

  const long long q_row = static_cast<long long>(H) * D;
  const long long k_row = static_cast<long long>(KV) * D;
  const long long q_off = static_cast<long long>(b) * Sq * q_row + h * D;
  const long long k_off = static_cast<long long>(b) * Sk * k_row + kvh * D;
  int kv_end = Sk;
  if (causal) kv_end = min(kv_end, q0 + kBT);
  const int kv_begin =
      window > 0 ? (max(0, q0 - window + 1) / kBT) * kBT : 0;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kBT - 1) / kBT : 0;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = kv_begin + tile * kBT;
    load_tile_async<kBT, kBwdThreads>(k_s + stage * kTileElems, k + k_off,
                                      k_row, k0, Sk);
    load_tile_async<kBT, kBwdThreads>(v_s + stage * kTileElems, v + k_off,
                                      k_row, k0, Sk);
  };
  load_tile_async<kBT, kBwdThreads>(q_s, q + q_off, q_row, q0, Sq);
  load_tile_async<kBT, kBwdThreads>(do_s, dout + q_off, q_row, q0, Sq);
  cp_async_commit();
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  const int qpos[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  float lse2[2], delta_r[2];  // lse in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long stat = (static_cast<long long>(b) * H + h) * Sq + qpos[r];
    lse2[r] = qpos[r] < Sq ? lse[stat] * kLog2e : 0.f;
    delta_r[r] = qpos[r] < Sq ? delta[stat] : 0.f;
  }
  cp_async_wait<1>();  // Q and dO have arrived
  __syncthreads();
  unsigned qa[4][4], da[4][4];
  load_a_frags(qa, q_s, wrow, lane);
  load_a_frags(da, do_s, wrow, lane);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&qa[kc][i]));
      qa[kc][i] = pack_bf16(f.x * scale, f.y * scale);
    }

  float acc[8][4];
  zero(acc);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kv_begin + j * kBT, stage = j & 1;
    if (j + 1 < n_tiles) load_kv(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j has arrived
    __syncthreads();
    const __nv_bfloat16* kt = k_s + stage * kTileElems;
    float s[8][4], dp[8][4];
    mma_a_tnk(s, qa, kt, lane);
    mma_a_tnk(dp, da, v_s + stage * kTileElems, lane);
    const bool full = tile_full(q0, k0, Sq, Sk, causal, window);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        float p = exp2f(fmaf(s[nt][i], kLog2e, -lse2[r]));
        if (!full && !admitted(qpos[r], k0 + nt * 8 + 2 * t + (i & 1), Sq,
                               Sk, causal, window))
          p = 0.f;
        s[nt][i] = p * (dp[nt][i] - delta_r[r]);  // dS
      }
    unsigned dsa[4][4];
    c_to_a(dsa, s);
    mma_a_tkn(acc, dsa, kt, lane);
    __syncthreads();  // the stage is free for the load issued next
  }
  cp_async_wait<0>();

  // the warp's own rows of q_s (no other warp reads them) stage dQ
  stage_c(q_s, acc, wrow, scale, scale, lane);
  __syncwarp();
  store_rows16(dq + q_off, q_row, q_s, wrow, q0 + wrow, Sq, lane);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H,
                     int KV, int causal, int window, float scale) {
  static_assert(D == 64, "scale 2^-3 is exact: see the note at the top");
  const int k0 = blockIdx.x * kBT, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kTileElems;
  __nv_bfloat16* q_s = v_s + kTileElems;       // 2 stages
  __nv_bfloat16* do_s = q_s + 2 * kTileElems;  // 2 stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTileElems);  // 2 x kBT
  float* delta_s = lse_s + 2 * kBT;                                // 2 x kBT

  const long long q_row = static_cast<long long>(H) * D;
  const long long k_row = static_cast<long long>(KV) * D;
  const long long k_off = static_cast<long long>(b) * Sk * k_row + kvh * D;
  // query tiles that can see a key of this tile
  const int q_begin = causal ? (k0 / kBT) * kBT : 0;
  int q_end = Sq;
  if (window > 0) q_end = min(q_end, k0 + kBT - 1 + window);
  const int nq = q_end > q_begin ? (q_end - q_begin + kBT - 1) / kBT : 0;
  const int n_iter = G * nq;  // (query head of the group, query tile)

  auto load_q = [&](int it, int stage) {
    const int h = kvh * G + it / nq, q0 = q_begin + (it % nq) * kBT;
    const long long q_off = static_cast<long long>(b) * Sq * q_row + h * D;
    load_tile_async<kBT, kBwdThreads>(q_s + stage * kTileElems, q + q_off,
                                      q_row, q0, Sq);
    load_tile_async<kBT, kBwdThreads>(do_s + stage * kTileElems,
                                      dout + q_off, q_row, q0, Sq);
    const int i = threadIdx.x % kBT;
    const bool in = q0 + i < Sq;
    const long long stat = (static_cast<long long>(b) * H + h) * Sq + q0 + i;
    if (threadIdx.x < kBT)
      cp_async4(lse_s + stage * kBT + i, in ? lse + stat : lse, in);
    else
      cp_async4(delta_s + stage * kBT + i, in ? delta + stat : delta, in);
  };
  static_assert(kBwdThreads == 2 * kBT, "one thread per lse and delta");
  load_tile_async<kBT, kBwdThreads>(k_s, k + k_off, k_row, k0, Sk);
  load_tile_async<kBT, kBwdThreads>(v_s, v + k_off, k_row, k0, Sk);
  cp_async_commit();
  if (n_iter > 0) load_q(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V have arrived
  __syncthreads();
  unsigned ka[4][4], va[4][4];
  load_a_frags(ka, k_s, wrow, lane);
  load_a_frags(va, v_s, wrow, lane);

  const int kpos[2] = {k0 + wrow + g, k0 + wrow + g + 8};
  const float s2 = scale * kLog2e;  // the scores' scale, in log2 units
  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int it = 0; it < n_iter; ++it) {
    const int q0 = q_begin + (it % nq) * kBT, stage = it & 1;
    if (it + 1 < n_iter) load_q(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // iteration it's tiles have arrived
    __syncthreads();
    const __nv_bfloat16* qt = q_s + stage * kTileElems;
    const __nv_bfloat16* dot = do_s + stage * kTileElems;
    const float* lse_t = lse_s + stage * kBT;
    const float* delta_t = delta_s + stage * kBT;
    float s[8][4], dp[8][4];
    mma_a_tnk(s, ka, qt, lane);    // S^T / scale: rows keys, columns queries
    mma_a_tnk(dp, va, dot, lane);  // dP^T
    const bool full = tile_full(q0, k0, Sq, Sk, causal, window);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t;  // this lane's query columns c, c + 1
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_t + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = i & 1;
        float p = exp2f(fmaf(s[nt][i], s2, -(j ? l2.y : l2.x) * kLog2e));
        if (!full && !admitted(q0 + c + j, kpos[i >> 1], Sq, Sk, causal,
                               window))
          p = 0.f;
        s[nt][i] = p;                                   // P^T
        dp[nt][i] = p * (dp[nt][i] - (j ? d2.y : d2.x));  // dS^T
      }
    }
    unsigned pa[4][4];
    c_to_a(pa, s);
    mma_a_tkn(dv_acc, pa, dot, lane);
    c_to_a(pa, dp);
    mma_a_tkn(dk_acc, pa, qt, lane);  // dS^T q; scaled once at the end
    __syncthreads();  // the stage is free for the load issued next
  }
  cp_async_wait<0>();

  // the warp's own rows of k_s and v_s (no other warp reads them) stage
  // dK and dV
  stage_c(k_s, dk_acc, wrow, scale, scale, lane);
  stage_c(v_s, dv_acc, wrow, 1.f, 1.f, lane);
  __syncwarp();
  store_rows16(dk + k_off, k_row, k_s, wrow, k0 + wrow, Sk, lane);
  store_rows16(dv + k_off, k_row, v_s, wrow, k0 + wrow, Sk, lane);
}

template <int D>
static int launch_bwd(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, void* dk, void* dv, int B,
                      int Sq, int Sk, int H, int KV, int causal, int window,
                      cudaStream_t stream) {
  using T = __nv_bfloat16;
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

  const size_t tile = sizeof(T) * kTileElems;
  const size_t dq_smem = 6 * tile;  // Q, dO, 2 x (K, V)
  auto dq_kernel = flash_bwd_dq_kernel<D>;
  err = cudaFuncSetAttribute(dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<dim3((Sq + kBT - 1) / kBT, H, B), kBwdThreads, dq_smem,
              stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq,
                        Sk, H, KV, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // K, V, 2 x (Q, dO, lse, delta)
  const size_t dkv_smem = 6 * tile + 4 * sizeof(float) * kBT;
  auto dkv_kernel = flash_bwd_dkv_kernel<D>;
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

// Built for bf16 at head_dim 64 (any query group: llama3.2-1b,
// granite-moe-1b-a400m) and, in the second half of this file, at head_dim
// 128 and 224 with one query head per KV head (gpt3-xl; zamba2-7b's shared
// attention block) and at head_dim 128 with 3 (llama3.2-3b), 5
// (llama4-scout-17b-a16e, causal with or without its local window) and 7
// (yi-34b: dQ reads KV head h / G, and a dK/dV block walks the G query
// heads of its KV head, so only the grids' work per block changes: at G 7,
// S 1024 the causal key tile 0 runs 112 iterations and the last 7, against
// a mean of 59.5); other cases are refused until a configuration needs them
// and chip_smoke.py checks them.

// ---------------------------------------------------------------------------
// Wide rows: head_dim 128 and 224.  The design above, reshaped for rows
// longer than 64 elements as the wide forward (flash_prefill.cu) reshapes
// its own:
// - Rows sit at a pitch of D + 8 elements (at 224, 29 16-byte chunks, 20
//   banks on from the row before; at 128, 17 chunks, 4 banks on), so the 8
//   rows one ldmatrix phase reads and the epilogue's 4-byte stores cover
//   the 32 banks once.
// - The scale is not a power of two: a pre-pass (a warp a row) writes
//   qs = bf16(q * scale) beside delta = rowsum(dO * O), both kernels read
//   qs, and dQ is scaled by the same bf16 factor at the end.
// - Registers: a warp's 16 x D f32 accumulator is D / 2 a lane (112 at
//   224, 64 at 128), so no fragment of qs, dO, K or V stays resident: each
//   is re-read from shared memory at every k-step, and the inner tiles are
//   32 wide (16 score registers).  dK and dV would need D registers
//   together (224: too many beside the scores), so they come from two
//   passes of one launch: blockIdx.y selects dV (P^T dO) or dK (dS^T qs)
//   for a key tile, each pass recomputing S^T (and the dK pass dP^T): 8
//   products per admitted pair against the function's 5.  128 runs the
//   same code; at 128 one pass could hold both sums, which is work for a
//   PR that makes it faster.
// - Shared memory: dQ holds qs and dO (64 rows each) and a 2-stage ring of
//   32-key K and V tiles, 116 KB at 224 and 68 KB at 128; dK/dV holds K and
//   V (64 rows) and a 2-stage ring of 32-query qs and dO tiles with their
//   lse and delta, 117 KB at 224 and 69 KB at 128.
// Deterministic as above: no atomics, every sum in a fixed order.
// ---------------------------------------------------------------------------

constexpr int kWideBT = 32;  // keys a tile (dQ), queries a tile (dK/dV)

// D^-0.5 rounded to bf16, as the forward scales q (flash_prefill.cu)
__device__ __forceinline__ float bf16_query_scale(int D) {
  return __bfloat162float(
      __float2bfloat16(1.f / sqrtf(static_cast<float>(D))));
}

// Rows [row0, row0 + ROWS) of a (rows, D) bf16 slice with the given row
// stride (elements) into a tile of pitch D + 8; rows at or past `rows` are
// zero-filled.
template <int ROWS, int D>
__device__ __forceinline__ void load_rows_pitched(__nv_bfloat16* dst,
                                                  const __nv_bfloat16* src,
                                                  long long row_stride,
                                                  int row0, int rows) {
  constexpr int CH = D / 8, PITCH = D + 8;
  static_assert(ROWS * CH % kBwdThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / kBwdThreads; ++it) {
    const int i = it * kBwdThreads + threadIdx.x;
    const int r = i / CH, c = i % CH;
    const bool in = row0 + r < rows;
    const __nv_bfloat16* s =
        in ? src + static_cast<long long>(row0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + r * PITCH + c * 8, s, in);
  }
}

// acc (16 x BT) = A (rows [row0, row0 + 16) of the pitched tile `a`, D
// columns) times the transpose of the pitched tile `t` (BT rows, D
// columns): both operands read by ldmatrix at every k-step.
template <int D, int BT>
__device__ __forceinline__ void mma_rows_tnk(float (&acc)[BT / 8][4],
                                             const __nv_bfloat16* a,
                                             int row0,
                                             const __nv_bfloat16* t,
                                             int lane) {
  constexpr int PITCH = D + 8;
#pragma unroll
  for (int i = 0; i < BT / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    unsigned af[4];
    ldsm_x4(af, a + (row0 + (lane & 15)) * PITCH + kc * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < BT / 16; ++np) {
      unsigned bf[4];
      ldsm_x4(bf, t + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * PITCH +
                      kc * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D) += A (16 x BT, as bf16 A fragments) times the pitched tile
// `t` (BT rows along k, D columns), read by ldmatrix.trans.
template <int D, int BT>
__device__ __forceinline__ void mma_frags_tkn(float (&acc)[D / 8][4],
                                              const unsigned (&a)[BT / 16][4],
                                              const __nv_bfloat16* t,
                                              int lane) {
  constexpr int PITCH = D + 8;
#pragma unroll
  for (int kc = 0; kc < BT / 16; ++kc)
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      unsigned bf[4];
      ldsm_x4_trans(bf, t + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                PITCH +
                            np * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * np], a[kc], bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], a[kc], bf[2], bf[3]);
    }
}

// The f32 C tiles of a 16 x BT product as bf16 A fragments along k.
template <int BT>
__device__ __forceinline__ void c_to_a_wide(unsigned (&a)[BT / 16][4],
                                            const float (&c)[BT / 8][4]) {
#pragma unroll
  for (int kc = 0; kc < BT / 16; ++kc) {
    a[kc][0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
    a[kc][1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
    a[kc][2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
    a[kc][3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
  }
}

// Every pair of a (QT-query tile at q0, KT-key tile at k0) is admitted.
template <int QT, int KT>
__device__ __forceinline__ bool block_full(int q0, int k0, int Sq, int Sk,
                                           int causal, int window) {
  return q0 + QT <= Sq && k0 + KT <= Sk && (!causal || k0 + KT - 1 <= q0) &&
         (window <= 0 || q0 + QT - 1 - k0 < window);
}

// A warp's 16 x D f32 accumulator times `mul` as bf16 into its own rows of
// a pitched tile, then those rows to global memory in 16-byte stores
// (rows at or past `rows` skipped; grow0 is row0's index in the slice).
template <int D>
__device__ __forceinline__ void store_acc_pitched(
    __nv_bfloat16* tile, const float (&acc)[D / 8][4], float mul, int row0,
    __nv_bfloat16* dst, long long row_stride, int grow0, int rows,
    int lane) {
  constexpr int PITCH = D + 8, CH = D / 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<unsigned*>(tile + (row0 + g) * PITCH + col) =
        pack_bf16(acc[nt][0] * mul, acc[nt][1] * mul);
    *reinterpret_cast<unsigned*>(tile + (row0 + g + 8) * PITCH + col) =
        pack_bf16(acc[nt][2] * mul, acc[nt][3] * mul);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    if (grow0 + r < rows)
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(grow0 + r) *
                                          row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + (row0 + r) * PITCH + c * 8);
  }
}

// Pre-pass: a warp a (b, s, h) row; lanes below D / 8 each take one
// 16-byte chunk.  delta = rowsum(dO * O) into (B, H, Sq) f32, and
// qs = bf16(q * scale) in q's layout.
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout,
                      __nv_bfloat16* __restrict__ qs,
                      float* __restrict__ delta, int Sq, int H,
                      long long rows) {
  constexpr int CH = D / 8;
  static_assert(D % 8 == 0 && CH <= 32, "one 16-byte chunk a lane");
  const long long row =
      static_cast<long long>(blockIdx.x) * kBwdWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const float scale = bf16_query_scale(D);
  float a = 0.f;
  if (lane < CH) {
    const long long off = row * D + lane * 8;
    float x[8], y[8];
    load16(o + off, x);
    load16(dout + off, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) a += x[i] * y[i];
    load16(q + off, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] *= scale;
    store16(qs + off, x);
  }
  a = warp_sum(a);
  if (lane == 0) {
    // row runs over (b, s, h) in memory order; delta is (B, H, Sq)
    const int h = static_cast<int>(row % H);
    const long long bs = row / H;
    const int s = static_cast<int>(bs % Sq);
    const long long b = bs / Sq;
    delta[(b * H + h) * Sq + s] = a;
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_wide_kernel(const __nv_bfloat16* __restrict__ qs,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int Sq, int Sk,
                         int H, int KV, int causal, int window) {
  constexpr int PITCH = D + 8, BK = kWideBT, ST = BK / 8;
  // the last query tiles see the most keys under the causal mask: launch
  // them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + kBT * PITCH;
  __nv_bfloat16* k_s = do_s + kBT * PITCH;    // 2 stages
  __nv_bfloat16* v_s = k_s + 2 * BK * PITCH;  // 2 stages

  const long long q_row = static_cast<long long>(H) * D;
  const long long k_row = static_cast<long long>(KV) * D;
  const long long q_off = static_cast<long long>(b) * Sq * q_row + h * D;
  const long long k_off = static_cast<long long>(b) * Sk * k_row + kvh * D;
  int kv_end = Sk;
  if (causal) kv_end = min(kv_end, q0 + kBT);
  const int kv_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = kv_begin + tile * BK;
    load_rows_pitched<BK, D>(k_s + stage * BK * PITCH, k + k_off, k_row, k0,
                             Sk);
    load_rows_pitched<BK, D>(v_s + stage * BK * PITCH, v + k_off, k_row, k0,
                             Sk);
  };
  load_rows_pitched<kBT, D>(q_s, qs + q_off, q_row, q0, Sq);
  load_rows_pitched<kBT, D>(do_s, dout + q_off, q_row, q0, Sq);
  cp_async_commit();
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  const int qpos[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  float lse2[2], delta_r[2];  // lse in log2 units
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long stat = (static_cast<long long>(b) * H + h) * Sq + qpos[r];
    lse2[r] = qpos[r] < Sq ? lse[stat] * kLog2e : 0.f;
    delta_r[r] = qpos[r] < Sq ? delta[stat] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = kv_begin + j * BK, stage = j & 1;
    if (j + 1 < n_tiles) load_kv(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // qs, dO and tile j have arrived
    __syncthreads();
    const __nv_bfloat16* kt = k_s + stage * BK * PITCH;
    float s[ST][4], dp[ST][4];
    mma_rows_tnk<D, BK>(s, q_s, wrow, kt, lane);
    mma_rows_tnk<D, BK>(dp, do_s, wrow, v_s + stage * BK * PITCH, lane);
    const bool full = block_full<kBT, BK>(q0, k0, Sq, Sk, causal, window);
#pragma unroll
    for (int nt = 0; nt < ST; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        float p = exp2f(fmaf(s[nt][i], kLog2e, -lse2[r]));
        if (!full && !admitted(qpos[r], k0 + nt * 8 + 2 * t + (i & 1), Sq,
                               Sk, causal, window))
          p = 0.f;
        s[nt][i] = p * (dp[nt][i] - delta_r[r]);  // dS
      }
    unsigned dsa[BK / 16][4];
    c_to_a_wide<BK>(dsa, s);
    mma_frags_tkn<D, BK>(acc, dsa, kt, lane);
    __syncthreads();  // the stage is free for the load issued next
  }
  cp_async_wait<0>();

  // the warp's own rows of q_s (no other warp reads them) stage dQ
  store_acc_pitched<D>(q_s, acc, bf16_query_scale(D), wrow, dq + q_off,
                       q_row, q0 + wrow, Sq, lane);
}

// One pass of the dK/dV kernel over a 64-key tile: dV = P^T dO, or with DK
// dK = dS^T qs (qs is already scaled: no factor at the end).
template <int D, bool DK>
__device__ __forceinline__ void dkv_wide_pass(
    const __nv_bfloat16* __restrict__ qs, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ out,
    int Sq, int Sk, int H, int KV, int causal, int window, int k0, int kvh,
    int b) {
  constexpr int PITCH = D + 8, BQ = kWideBT, ST = BQ / 8;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kBT * PITCH;
  __nv_bfloat16* q_s = v_s + kBT * PITCH;       // 2 stages
  __nv_bfloat16* do_s = q_s + 2 * BQ * PITCH;   // 2 stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * PITCH);  // 2 x BQ
  float* delta_s = lse_s + 2 * BQ;                                 // 2 x BQ

  const long long q_row = static_cast<long long>(H) * D;
  const long long k_row = static_cast<long long>(KV) * D;
  const long long k_off = static_cast<long long>(b) * Sk * k_row + kvh * D;
  // query tiles that can see a key of this tile
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  int q_end = Sq;
  if (window > 0) q_end = min(q_end, k0 + kBT - 1 + window);
  const int nq = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int n_iter = G * nq;  // (query head of the group, query tile)

  auto load_q = [&](int it, int stage) {
    const int h = kvh * G + it / nq, q0 = q_begin + (it % nq) * BQ;
    const long long q_off = static_cast<long long>(b) * Sq * q_row + h * D;
    load_rows_pitched<BQ, D>(q_s + stage * BQ * PITCH, qs + q_off, q_row, q0,
                             Sq);
    load_rows_pitched<BQ, D>(do_s + stage * BQ * PITCH, dout + q_off, q_row,
                             q0, Sq);
    const int i = threadIdx.x % BQ;
    const bool in = q0 + i < Sq;
    const long long stat = (static_cast<long long>(b) * H + h) * Sq + q0 + i;
    if (threadIdx.x < BQ)
      cp_async4(lse_s + stage * BQ + i, in ? lse + stat : lse, in);
    else if (threadIdx.x < 2 * BQ)
      cp_async4(delta_s + stage * BQ + i, in ? delta + stat : delta, in);
  };
  load_rows_pitched<kBT, D>(k_s, k + k_off, k_row, k0, Sk);
  if (DK) load_rows_pitched<kBT, D>(v_s, v + k_off, k_row, k0, Sk);
  cp_async_commit();
  if (n_iter > 0) load_q(0, 0);
  cp_async_commit();

  const int kpos[2] = {k0 + wrow + g, k0 + wrow + g + 8};
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int it = 0; it < n_iter; ++it) {
    const int q0 = q_begin + (it % nq) * BQ, stage = it & 1;
    if (it + 1 < n_iter) load_q(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K (and V) and iteration it's tiles have arrived
    __syncthreads();
    const __nv_bfloat16* qt = q_s + stage * BQ * PITCH;
    const __nv_bfloat16* dot = do_s + stage * BQ * PITCH;
    const float* lse_t = lse_s + stage * BQ;
    const float* delta_t = delta_s + stage * BQ;
    float s[ST][4];  // S^T = K qs^T: rows keys, columns queries
    mma_rows_tnk<D, BQ>(s, k_s, wrow, qt, lane);
    float dp[ST][4];  // dP^T = V dO^T (dK pass only)
    if (DK) mma_rows_tnk<D, BQ>(dp, v_s, wrow, dot, lane);
    const bool full = block_full<BQ, kBT>(q0, k0, Sq, Sk, causal, window);
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
      const int c = nt * 8 + 2 * t;  // this lane's query columns c, c + 1
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_t + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = i & 1;
        float p = exp2f(fmaf(s[nt][i], kLog2e, -(j ? l2.y : l2.x) * kLog2e));
        if (!full && !admitted(q0 + c + j, kpos[i >> 1], Sq, Sk, causal,
                               window))
          p = 0.f;
        s[nt][i] = DK ? p * (dp[nt][i] - (j ? d2.y : d2.x)) : p;
      }
    }
    unsigned pa[BQ / 16][4];
    c_to_a_wide<BQ>(pa, s);
    mma_frags_tkn<D, BQ>(acc, pa, DK ? qt : dot, lane);
    __syncthreads();  // the stage is free for the load issued next
  }
  cp_async_wait<0>();

  // the warp's own rows of k_s (no other warp reads them) stage the result
  store_acc_pitched<D>(k_s, acc, 1.f, wrow, out + k_off, k_row, k0 + wrow,
                       Sk, lane);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_wide_kernel(const __nv_bfloat16* __restrict__ qs,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                          int H, int KV, int causal, int window) {
  // key tile 0 sees the most query tiles under the causal mask and is
  // launched first; blockIdx.y is (KV head, pass)
  const int k0 = blockIdx.x * kBT, kvh = blockIdx.y >> 1, b = blockIdx.z;
  if (blockIdx.y & 1)
    dkv_wide_pass<D, true>(qs, k, v, dout, lse, delta, dk, Sq, Sk, H, KV,
                           causal, window, k0, kvh, b);
  else
    dkv_wide_pass<D, false>(qs, k, v, dout, lse, delta, dv, Sq, Sk, H, KV,
                            causal, window, k0, kvh, b);
}

template <int D>
static int launch_bwd_wide(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* delta, void* qs, void* dq, void* dk,
                           void* dv, int B, int Sq, int Sk, int H, int KV,
                           int causal, int window, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  T* qst = static_cast<T*>(qs);

  const long long rows = static_cast<long long>(B) * Sq * H;
  flash_bwd_prep_kernel<D>
      <<<static_cast<unsigned>((rows + kBwdWarps - 1) / kBwdWarps),
         kBwdThreads, 0, stream>>>(static_cast<const T*>(q),
                                   static_cast<const T*>(o), dot, qst, delta,
                                   Sq, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t pitch_bytes = sizeof(T) * (D + 8);
  const size_t dq_smem = (2 * kBT + 4 * kWideBT) * pitch_bytes;
  auto dq_kernel = flash_bwd_dq_wide_kernel<D>;
  err = cudaFuncSetAttribute(dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<dim3((Sq + kBT - 1) / kBT, H, B), kBwdThreads, dq_smem,
              stream>>>(qst, kt, vt, dot, lse, delta, static_cast<T*>(dq),
                        Sq, Sk, H, KV, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t dkv_smem =
      (2 * kBT + 4 * kWideBT) * pitch_bytes + 4 * sizeof(float) * kWideBT;
  auto dkv_kernel = flash_bwd_dkv_wide_kernel<D>;
  err = cudaFuncSetAttribute(dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<dim3((Sk + kBT - 1) / kBT, 2 * KV, B), kBwdThreads, dkv_smem,
               stream>>>(qst, kt, vt, dot, lse, delta, static_cast<T*>(dk),
                         static_cast<T*>(dv), Sq, Sk, H, KV, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// delta is an f32 scratch of B * H * Sq values and qs a scratch shaped as
// q (null at head_dim 64, which reads q itself), both allocated by the
// wrapper.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* delta, void* qs,
                                void* dq, void* dk, void* dv, int B, int Sq,
                                int Sk, int H, int KV, int D, int causal,
                                int window, int dtype, void* stream) {
  if (dtype != kBF16 || KV <= 0 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_bwd<64>(q, k, v, o, dout, l, d, dq, dk, dv, B, Sq, Sk, H,
                          KV, causal, window, s);
  if (D == 128 && (H == KV || H == 3 * KV || H == 5 * KV || H == 7 * KV) &&
      qs != nullptr)
    return launch_bwd_wide<128>(q, k, v, o, dout, l, d, qs, dq, dk, dv, B,
                                Sq, Sk, H, KV, causal, window, s);
  if (D == 224 && H == KV && qs != nullptr)
    return launch_bwd_wide<224>(q, k, v, o, dout, l, d, qs, dq, dk, dv, B,
                                Sq, Sk, H, KV, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
