// Mamba2 SSD chunked scan for Hopper: three passes, parallel over chunks,
// every product on the tensor cores.
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
// past S are zero-filled before any product, which leaves the state
// unchanged, exactly as the reference's zero padding does.
//
// Bound on the H100: bytes.  The function reads x, a, B, C once and writes
// y and the final state once: 44.6 MB at mamba2-370m's serving shape (B 8,
// S 512, H 32, P 64, G 1, N 128, chunk 256), 0.0133 ms at 3.35 TB/s,
// against about 6.6 GFLOP of causal products (0.0067 ms at 989 TFLOP/s
// bf16); zamba2-7b's (H 112, G 2, N 64) moves about 121 MB.
//
// Translation.  The TPU kernel runs a (B, H, chunks) grid whose chunk axis
// is sequential and carries the N x P state in VMEM.  Here the chunked SSD
// of arXiv:2405.21060 (section 6) runs as three kernels, launched by
// ssd_scan_launch on one stream, the second and third under programmatic
// dependent launch:
//
//   (a) ssd_scan_states_kernel, one block per (chunk, head, batch row): the
//       chunk's cumulative sum of a (a block scan, written to the
//       workspace) and its state contribution S_c = B^T . (decay_out o x),
//       decay_out[k] = exp(a_cs[Q-1] - a_cs[k]), written as f32.
//   (b) ssd_scan_carry_kernel, elementwise over N x P for each (b, h), a
//       short loop over the chunks in f32: the state entering chunk c,
//       h_c = exp(a_tot,c-1) h_c-1 + S_c-1 from h0 or zero, written to the
//       workspace rounded to bf16 (all that (c) reads of it); the state
//       after the last chunk is the final state.
//   (c) ssd_scan_output_kernel, one block per (64-row query tile, chunk,
//       pair of heads of one group, batch row): y = exp(a_cs[q]) C . h_c
//       plus the dual form (L o C B^T) . x over the key tiles k <= q.  The
//       two heads share their B and C tiles and C B^T, which a lane holds
//       in registers while it applies each head's own L.  The heaviest
//       query tiles launch first.
//
// In (a) and (c) warps run mma.sync m16n8k16 (bf16 in, f32 sums; mma.cuh)
// on ldmatrix fragments of XOR-swizzled 64-column tiles, which 16-byte
// cp.async copies fill in a 2-stage ring (the next key tile loads while
// this one computes); a 128-wide B or C row is two such tiles.  In (c) 4
// warps each own 16 query rows: C's fragments stay in registers for the whole
// key loop, C B^T lands in accumulators, and L o C B^T is packed to bf16 in
// registers as the A operand of the product with x.  L = exp(a_cs[q] -
// a_cs[k]) is taken directly, and only where q >= k, on the diagonal tile;
// below it, as exp(a_cs[q] - a_cs[q0]) exp(a_cs[q0] - a_cs[k]) for the
// tile's first row q0, two factors <= 1 from per-row and per-column tables,
// so that the exponentials cost a few per row and column, not one per
// pair.  In (a) 4 warps each own 32 state rows and read B^T with
// ldmatrix.trans.
//
// Rounding recipe (tests/test_torch_ssd_tc.py models it):
//   C.B^T:         bf16 x bf16 inputs, exact products, f32 sums
//   L o C.B^T:     f32, rounded to bf16 as the A operand of the product with x
//   state update:  decay_out o x split into bf16 hi + lo, two products
//   C.h:           h rounded to bf16
//   carried state: f32 throughout, elementwise in pass (b)
// A single bf16 rounding of decay_out o x would put the final state about
// 2e-3 of its largest value off, over chip_smoke.py's 1e-3 gate; the hi + lo
// split leaves about 2^-17 of each term.
//
// No atomics: every sum runs in a fixed order, so two calls are bitwise
// equal.  The grids and the workspace size come from the shapes alone and
// the host reads no device value, so a launch can be captured in a CUDA
// graph.
//
// Resources per block at N 128 (ptxas -v for sm_90a, CUDA 12.8; no
// spills): states pass 128 threads, 132 registers, 67,600 bytes of shared
// memory (3 blocks an SM); carry pass 256 threads, 32 registers, none;
// output pass 128 threads, 224 registers and 86,016 bytes with two heads a
// block (2 blocks an SM), 176 registers and 67,584 bytes with one.  At
// N 64 every B and C row is one tile (N / 64 == 1): a warp of pass (a)
// owns 16 state rows, and pass (c) stages both heads' y in C's one tile,
// one after the other.
#include "mma.cuh"

constexpr int kSsdThreads = 128;     // 4 warps
constexpr int kSsdTile = 64;         // rows of a query or key tile
constexpr int kSsdMaxChunk = 256;    // positions the cumulative sums hold
constexpr int kSsdTileElems = kSsdTile * kRowElems;
constexpr int kSsdHeads = 2;         // heads of one group a block of (c) takes
constexpr int kCarryThreads = 256;   // pass (b): a float4 a thread

// Shared memory of pass (a), in bytes: a ring of 2 stages of N / 64 B
// tiles and one x tile, the hi and lo tiles of decay_out o x, the
// cumulative sums, the decays and the scan's warp sums.
template <int N>
constexpr size_t states_smem() {
  return sizeof(__nv_bfloat16) * kSsdTileElems * (2 * (N / 64 + 1) + 2) +
         sizeof(float) * (2 * kSsdMaxChunk + kSsdThreads / 32);
}

// Shared memory of pass (c), in bytes: the query tile's C (N / 64 tiles,
// then the staging of y), a ring of 2 stages of N / 64 B tiles and HB x
// tiles (stage 1 holds the entering states' bf16 tiles before the key
// loop), and per head the cumulative sums and the column factors.
template <int N, int HB>
constexpr size_t output_smem() {
  return sizeof(__nv_bfloat16) * kSsdTileElems * (N / 64 + 2 * (N / 64 + HB)) +
         sizeof(float) * 2 * HB * kSsdMaxChunk;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device, once per device: the attribute sticks, and setting it on every
// call would cost host time on every scan.  `done` is the caller's own
// record for this kernel, a bit per device (the first 32).
static cudaError_t allow_smem(const void* kernel, size_t bytes,
                              unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done |= bit;
  return err;
}

// ---------------------------------------------------------------------------
// (a) chunk states
// ---------------------------------------------------------------------------

template <int N, int P>
__global__ void __launch_bounds__(kSsdThreads)
ssd_scan_states_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ a,
                       const __nv_bfloat16* __restrict__ Bm,
                       float* __restrict__ states, float* __restrict__ acs,
                       int S, int H, int G, int Q, int nc) {
  static_assert(P == kRowElems && N % 64 == 0 && N <= 128,
                "x rows are one tile, B rows one or two");
  constexpr int NT = N / 64;         // tiles of a B row
  constexpr int MT = N / 64;         // m16 tiles of state rows a warp owns
  constexpr int PER = kSsdMaxChunk / kSsdThreads;  // positions a thread scans
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = c * Q, len = min(Q, S - t0);
  const int tiles = (len + kSsdTile - 1) / kSsdTile;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int kStage = (NT + 1) * kSsdTileElems;
  __nv_bfloat16* w_hi = ring + 2 * kStage;
  __nv_bfloat16* w_lo = w_hi + kSsdTileElems;
  float* acs_s = reinterpret_cast<float*>(w_lo + kSsdTileElems);
  float* dec_s = acs_s + kSsdMaxChunk;
  float* warp_sums = dec_s + kSsdMaxChunk;

  const long long ldx = static_cast<long long>(H) * P;
  const long long ldb = static_cast<long long>(G) * N;
  const long long row0 = static_cast<long long>(b) * S + t0;
  const __nv_bfloat16* xb = x + row0 * ldx + h * P;
  const __nv_bfloat16* Bb = Bm + row0 * ldb + g * N;

  auto load = [&](int tile, int stage) {
    __nv_bfloat16* s = ring + stage * kStage;
#pragma unroll
    for (int i = 0; i < NT; ++i)
      load_tile_async<kSsdTile, kSsdThreads>(s + i * kSsdTileElems,
                                             Bb + i * kRowElems, ldb,
                                             tile * kSsdTile, len);
    load_tile_async<kSsdTile, kSsdThreads>(s + NT * kSsdTileElems, xb, ldx,
                                           tile * kSsdTile, len);
  };
  load(0, 0);
  cp_async_commit();
  launch_dependents();

  // inclusive cumulative sum of a over the chunk, zeros past len (flat):
  // thread t holds positions [PER t, PER t + PER)
  const int i0 = PER * threadIdx.x;
  const float* ab = a + row0 * H + h;
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    v[i] = (i ? v[i - 1] : 0.f) +
           (i0 + i < len ? ab[static_cast<long long>(i0 + i) * H] : 0.f);
  float incl = v[PER - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  float excl = incl - v[PER - 1];
  for (int w = 0; w < warp; ++w) excl += warp_sums[w];
#pragma unroll
  for (int i = 0; i < PER; ++i) acs_s[i0 + i] = excl + v[i];
  __syncthreads();
  const float a_tot = acs_s[Q - 1];
  float* acs_g = acs + (static_cast<long long>(b) * H + h) * nc * Q + t0;
#pragma unroll
  for (int i = i0; i < i0 + PER; ++i) {
    if (i < Q) acs_g[i] = acs_s[i];
    dec_s[i] = expf(a_tot - acs_s[i]);
  }

  float acc[MT][8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.f;
  const int srow = warp * 16 * MT;       // the warp's first state row
  const int half = srow / kRowElems, m0 = srow % kRowElems;

  for (int j = 0; j < tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < tiles) load(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j has arrived
    __syncthreads();     // (the first time also: dec_s is written)
    // decay_out o x as bf16 hi + lo: hi = bf16(v), lo = bf16(v - hi)
    const __nv_bfloat16* xs = ring + stage * kStage + NT * kSsdTileElems;
    for (int i = threadIdx.x; i < kSsdTile * 8; i += kSsdThreads) {
      const int r = i >> 3, off = swz(r, (i & 7) * 8);
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + off);
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float d = dec_s[j * kSsdTile + r];
      uint4 hi, lo;
      unsigned* hp = reinterpret_cast<unsigned*>(&hi);
      unsigned* lp = reinterpret_cast<unsigned*>(&lo);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float2 v = __bfloat1622float2(e[p]);
        const float w0 = d * v.x, w1 = d * v.y;
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(w0, w1);
        const float2 hf = __bfloat1622float2(h2);
        hp[p] = *reinterpret_cast<const unsigned*>(&h2);
        lp[p] = pack_bf16(w0 - hf.x, w1 - hf.y);
      }
      *reinterpret_cast<uint4*>(w_hi + off) = hi;
      *reinterpret_cast<uint4*>(w_lo + off) = lo;
    }
    __syncthreads();
    // S_c (the warp's rows) += B^T (rows: state, columns: keys) . (hi + lo)
    const __nv_bfloat16* bt = ring + stage * kStage + half * kSsdTileElems;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      unsigned af[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        load_a_km(af[m], bt, kc * 16, m0 + m * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bh[4], bl[4];
        load_b_kn(bh, w_hi, kc * 16, np * 16, lane);
        load_b_kn(bl, w_lo, kc * 16, np * 16, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][2 * np], af[m], bh[0], bh[1]);
          mma_bf16(acc[m][2 * np + 1], af[m], bh[2], bh[3]);
          mma_bf16(acc[m][2 * np], af[m], bl[0], bl[1]);
          mma_bf16(acc[m][2 * np + 1], af[m], bl[2], bl[3]);
        }
      }
    }
    __syncthreads();  // the stage and the hi / lo tiles are free
  }
  cp_async_wait<0>();

  float* st = states + ((static_cast<long long>(b) * nc + c) * H + h) * N * P;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float* p = st + (srow + m * 16 + gq) * P + n * 8 + 2 * tq;
      *reinterpret_cast<float2*>(p) = make_float2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<float2*>(p + 8 * P) =
          make_float2(acc[m][n][2], acc[m][n][3]);
    }
}

// ---------------------------------------------------------------------------
// (b) the states entering each chunk, and the final state
// ---------------------------------------------------------------------------

template <int N, int P>
__global__ void __launch_bounds__(kCarryThreads)
ssd_scan_carry_kernel(const float* __restrict__ states,
                      const float* __restrict__ acs,
                      const float* __restrict__ h0,
                      __nv_bfloat16* __restrict__ enter,
                      float* __restrict__ h_final, int H, int Q, int nc) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int i = blockIdx.x * kCarryThreads + threadIdx.x;  // float4 index
  const long long bh = static_cast<long long>(b) * H + h;
  launch_dependents();
  wait_for_prerequisites();
  float4 s = h0 != nullptr
                 ? reinterpret_cast<const float4*>(h0 + bh * N * P)[i]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  const float* ac = acs + bh * nc * Q;
  for (int c = 0; c < nc; ++c) {
    const long long slot =
        ((static_cast<long long>(b) * nc + c) * H + h) * N * P / 4 + i;
    const float4 add = reinterpret_cast<const float4*>(states)[slot];
    // the state entering chunk c, rounded to bf16 for the output pass's
    // C . h; it reads none for a first chunk from zero
    if (c > 0 || h0 != nullptr)
      reinterpret_cast<uint2*>(enter)[slot] =
          make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
    const float e = expf(ac[c * Q + Q - 1]);
    s = make_float4(e * s.x + add.x, e * s.y + add.y, e * s.z + add.z,
                    e * s.w + add.w);
  }
  reinterpret_cast<float4*>(h_final + bh * N * P)[i] = s;
}

// ---------------------------------------------------------------------------
// (c) outputs
// ---------------------------------------------------------------------------

template <int N, int P, int HB>
__global__ void __launch_bounds__(kSsdThreads, 2)
ssd_scan_output_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ Bm,
                       const __nv_bfloat16* __restrict__ Cm,
                       const __nv_bfloat16* __restrict__ enter,
                       const float* __restrict__ acs,
                       __nv_bfloat16* __restrict__ y, int S, int H, int G,
                       int Q, int nc, int has_h0) {
  static_assert(P == kRowElems && N % 64 == 0 && N <= 128,
                "x rows are one tile, B and C rows one or two");
  constexpr int NT = N / 64;
  static_assert(HB * NT <= NT + HB,
                "the entering states' tiles fit in one ring stage");
  const int T = (Q + kSsdTile - 1) / kSsdTile;  // query tiles a chunk
  const int qt = T - 1 - static_cast<int>(blockIdx.x) / nc;
  const int c = blockIdx.x % nc;
  const int hd = blockIdx.y * HB, b = blockIdx.z, g = hd / (H / G);
  const int t0 = c * Q, len = min(Q, S - t0), q0 = qt * kSsdTile;
  if (q0 >= len) return;  // a query tile past a ragged last chunk
  const bool carried = c > 0 || has_h0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int wrow = warp * 16;  // the warp's first row in the query tile

  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kStage = (NT + HB) * kSsdTileElems;
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = c_s + NT * kSsdTileElems;
  __nv_bfloat16* h_s = ring + kStage;  // stage 1, before the key loop
  float* acs_s = reinterpret_cast<float*>(ring + 2 * kStage);  // [HB][256]
  float* colf = acs_s + HB * kSsdMaxChunk;                     // [HB][256]

  const long long ldx = static_cast<long long>(H) * P;
  const long long ldb = static_cast<long long>(G) * N;
  const long long row0 = static_cast<long long>(b) * S + t0;
  const __nv_bfloat16* Cb = Cm + row0 * ldb + g * N;
  const __nv_bfloat16* Bb = Bm + row0 * ldb + g * N;
  const __nv_bfloat16* xb = x + row0 * ldx + hd * P;

  auto load_keys = [&](int kt, int stage) {
    __nv_bfloat16* s = ring + stage * kStage;
#pragma unroll
    for (int i = 0; i < NT; ++i)
      load_tile_async<kSsdTile, kSsdThreads>(s + i * kSsdTileElems,
                                             Bb + i * kRowElems, ldb,
                                             kt * kSsdTile, len);
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
      load_tile_async<kSsdTile, kSsdThreads>(s + (NT + hh) * kSsdTileElems,
                                             xb + hh * P, ldx, kt * kSsdTile,
                                             len);
  };
  // the inputs first: they do not depend on the passes before
#pragma unroll
  for (int i = 0; i < NT; ++i)
    load_tile_async<kSsdTile, kSsdThreads>(c_s + i * kSsdTileElems,
                                           Cb + i * kRowElems, ldb, q0, len);
  cp_async_commit();
  load_keys(0, 0);
  cp_async_commit();
  wait_for_prerequisites();  // the cumulative sums and entering states
  if (carried) {
    // the entering states (bf16), as (state rows, P) tiles
    const __nv_bfloat16* eb =
        enter + ((static_cast<long long>(b) * nc + c) * H + hd) * N * P;
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
#pragma unroll
      for (int i = 0; i < NT; ++i)
        load_tile_async<kSsdTile, kSsdThreads>(
            h_s + (hh * NT + i) * kSsdTileElems,
            eb + (static_cast<long long>(hh) * N + i * kRowElems) * P, P, 0,
            kSsdTile);
  }
  cp_async_commit();

  // cumulative sums of the chunk's rows [0, q0 + 64); rows past Q repeat
  // the last (the sums are flat there)
  const int na = q0 + kSsdTile;
  for (int i = threadIdx.x; i < HB * na; i += kSsdThreads) {
    const int hh = i / na, r = i % na;
    acs_s[hh * kSsdMaxChunk + r] =
        acs[(static_cast<long long>(b) * H + hd + hh) * nc * Q + t0 +
            min(r, Q - 1)];
  }
  __syncthreads();
  // column factors below the diagonal tile: exp(a_cs[q0] - a_cs[k]) <= 1
  for (int i = threadIdx.x; i < HB * q0; i += kSsdThreads) {
    const int hh = i / q0, k = i % q0;
    colf[hh * kSsdMaxChunk + k] =
        expf(acs_s[hh * kSsdMaxChunk + q0] - acs_s[hh * kSsdMaxChunk + k]);
  }
  cp_async_wait<0>();  // C, key tile 0 and the entering states have arrived
  __syncthreads();

  unsigned ca[NT][4][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
    load_a_frags(ca[i], c_s + i * kSsdTileElems, wrow, lane);
  const int qr[2] = {q0 + wrow + gq, q0 + wrow + gq + 8};  // this lane's rows
  float acc[HB][8][4];
  float rowf[HB][2];
#pragma unroll
  for (int hh = 0; hh < HB; ++hh) {
    const float* as = acs_s + hh * kSsdMaxChunk;
#pragma unroll
    for (int r = 0; r < 2; ++r) rowf[hh][r] = expf(as[qr[r]] - as[q0]);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[hh][n][j] = 0.f;
    if (carried) {
      // exp(a_cs[q]) C[q] . h
#pragma unroll
      for (int i = 0; i < NT; ++i)
        mma_a_tkn(acc[hh], ca[i], h_s + (hh * NT + i) * kSsdTileElems, lane);
      const float e0 = expf(as[qr[0]]), e1 = expf(as[qr[1]]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[hh][n][0] *= e0;
        acc[hh][n][1] *= e0;
        acc[hh][n][2] *= e1;
        acc[hh][n][3] *= e1;
      }
    }
  }
  __syncthreads();  // every warp is done with the entering states (stage 1)

  for (int j = 0; j <= qt; ++j) {
    const int k0 = j * kSsdTile, stage = j & 1;
    if (j < qt) load_keys(j + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // key tile j has arrived
    __syncthreads();
    const __nv_bfloat16* s = ring + stage * kStage;
    float cb[8][4];  // C B^T, shared by the block's heads
    mma_a_tnk(cb, ca[0], s, lane);
#pragma unroll
    for (int i = 1; i < NT; ++i)
      mma_a_tnk_add(cb, ca[i], s + i * kSsdTileElems, lane);
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      const float* as = acs_s + hh * kSsdMaxChunk;
      float p[8][4];
      if (j < qt) {
        const float* cf = colf + hh * kSsdMaxChunk + k0;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 f =
              *reinterpret_cast<const float2*>(cf + n * 8 + 2 * tq);
          p[n][0] = cb[n][0] * rowf[hh][0] * f.x;
          p[n][1] = cb[n][1] * rowf[hh][0] * f.y;
          p[n][2] = cb[n][2] * rowf[hh][1] * f.x;
          p[n][3] = cb[n][3] * rowf[hh][1] * f.y;
        }
      } else {
        // the diagonal tile: exp only where q >= k
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = k0 + n * 8 + 2 * tq + (i & 1), q = qr[i >> 1];
            p[n][i] = k <= q ? cb[n][i] * expf(as[q] - as[k]) : 0.f;
          }
      }
      unsigned pa[4][4];
      c_to_a(pa, p);  // L o C B^T rounded to bf16
      mma_a_tkn(acc[hh], pa, s + (NT + hh) * kSsdTileElems, lane);
    }
    __syncthreads();  // the stage is free for the load issued next
  }
  cp_async_wait<0>();

  // the warp's own rows of C's tiles (no other warp reads them) stage y
#pragma unroll
  for (int hh = 0; hh < HB; ++hh) {
    __nv_bfloat16* tile = c_s + (hh % NT) * kSsdTileElems;
    if (hh >= NT) __syncwarp();
    stage_c(tile, acc[hh], wrow, 1.f, 1.f, lane);
    __syncwarp();
    store_rows16(y + row0 * ldx + (hd + hh) * P, ldx, tile, wrow, q0 + wrow,
                 len, lane);
  }
}

template <int N, int P, int HB>
static cudaError_t launch_output(const void* x, const void* Bm,
                                 const void* Cm, const __nv_bfloat16* enter,
                                 const float* acs, void* y, int B, int S,
                                 int H, int G, int Q, int nc, int has_h0,
                                 cudaStream_t stream) {
  auto kernel = ssd_scan_output_kernel<N, P, HB>;
  constexpr size_t smem = output_smem<N, HB>();
  static unsigned done = 0;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), smem, done);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc * ((Q + kSsdTile - 1) / kSsdTile), H / HB, B);
  cfg.blockDim = dim3(kSsdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel,
                            static_cast<const __nv_bfloat16*>(x),
                            static_cast<const __nv_bfloat16*>(Bm),
                            static_cast<const __nv_bfloat16*>(Cm), enter, acs,
                            static_cast<__nv_bfloat16*>(y), S, H, G, Q, nc,
                            has_h0);
}

// The three passes at state N, head P.
template <int N, int P>
static int launch_scan(const void* x, const void* a, const void* Bm,
                       const void* Cm, const void* h0, void* workspace,
                       void* y, void* h_final, int B, int S, int H, int G,
                       int Q, cudaStream_t s) {
  const int nc = (S + Q - 1) / Q;
  const size_t n_states = static_cast<size_t>(B) * nc * H * N * P;
  float* states = static_cast<float*>(workspace);
  __nv_bfloat16* enter = reinterpret_cast<__nv_bfloat16*>(states + n_states);
  float* acs = states + n_states + n_states / 2;
  cudaError_t err;
  if (nc > 0) {
    constexpr size_t smem = states_smem<N>();
    auto kernel = ssd_scan_states_kernel<N, P>;
    static unsigned done = 0;
    err = allow_smem(reinterpret_cast<const void*>(kernel), smem, done);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(nc, H, B), kSsdThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
        static_cast<const __nv_bfloat16*>(Bm), states, acs, S, H, G, Q, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  static_assert(N * P % (4 * kCarryThreads) == 0, "whole carry blocks");
  cfg.gridDim = dim3(N * P / 4 / kCarryThreads, H, B);
  cfg.blockDim = dim3(kCarryThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssd_scan_carry_kernel<N, P>,
                           static_cast<const float*>(states),
                           static_cast<const float*>(acs),
                           static_cast<const float*>(h0), enter,
                           static_cast<float*>(h_final), H, Q, nc);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nc > 0) {
    const int has_h0 = h0 != nullptr;
    err = (H / G) % kSsdHeads == 0
              ? launch_output<N, P, kSsdHeads>(x, Bm, Cm, enter, acs, y, B, S,
                                               H, G, Q, nc, has_h0, s)
              : launch_output<N, P, 1>(x, Bm, Cm, enter, acs, y, B, S, H, G,
                                       Q, nc, has_h0, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// Built for bf16 x / B / C with f32 a at head P 64 and state N 128
// (mamba2-370m) or N 64 (zamba2-7b), the shapes the serving path launches
// and chip_smoke.py checks; other shapes are refused until a configuration
// needs them.  Q is the chunk length, 1..256 (a shorter sequence passes
// min(chunk, S)).  `workspace` holds 3 / 2 * B * nc * H * N * P +
// B * H * nc * Q floats, nc = ceil(S / Q): the chunk states (f32), the
// states entering each chunk (bf16) and the cumulative sums.
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* Bm,
                               const void* Cm, const void* h0,
                               void* workspace, void* y, void* h_final,
                               int B, int S, int H, int G, int N, int P,
                               int Q, void* stream) {
  if (P != 64 || Q < 1 || Q > kSsdMaxChunk || G < 1 || H % G || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 128)
    return launch_scan<128, 64>(x, a, Bm, Cm, h0, workspace, y, h_final, B,
                                S, H, G, Q, s);
  if (N == 64)
    return launch_scan<64, 64>(x, a, Bm, Cm, h0, workspace, y, h_final, B,
                               S, H, G, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
