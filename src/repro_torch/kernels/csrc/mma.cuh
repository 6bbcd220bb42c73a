// Tensor-core building blocks shared by the attention kernels
// (flash_prefill.cu, flash_backward.cu) and the SSD scan (ssd_scan.cu):
// bf16 tiles of 64-element rows in an XOR-swizzled shared layout, cp.async
// 16-byte copies into them (the copies themselves are in common.cuh),
// ldmatrix loads of mma.sync fragments, and the m16n8k16 bf16 product with
// f32 accumulation.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4):
//   A (16 x 16, row-major)  a0: (g, 2t..2t+1)   a1: (g + 8, 2t..2t+1)
//                           a2: (g, 2t+8..+9)   a3: (g + 8, 2t+8..+9)
//   B (16 x 8, k x n)       b0: (2t..2t+1, g)   b1: (2t+8..+9, g)
//   C (16 x 8, f32)         c0, c1: (g, 2t..2t+1)   c2, c3: (g + 8, 2t..2t+1)
// Two neighbouring C tiles along n hold, packed to bf16 pairs, exactly one
// A fragment along k: a product's f32 output feeds the next product as its
// A operand without leaving registers.
#pragma once

#include "common.cuh"

// Elements of one swizzled tile row: 64 bf16 = 128 bytes = 8 chunks of 16
// bytes.  Chunk c of row r lives at chunk c ^ (r % 8), so the 8 rows that
// one ldmatrix phase reads (same logical chunk) hit 8 different chunks,
// i.e. all 32 banks once.
constexpr int kRowElems = 64;

__device__ __forceinline__ int swz(int row, int col) {
  return row * kRowElems + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

// Rows [row0, row0 + ROWS) of a (rows, 64) bf16 slice with the given row
// stride (elements) into a swizzled shared tile; rows at or past `rows`
// are zero-filled, so no garbage (or NaN) bits reach a product.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long row_stride,
                                                int row0, int rows) {
  static_assert(ROWS * 8 % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * 8 / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int r = i >> 3, c = i & 7;
    const bool in = row0 + r < rows;
    const __nv_bfloat16* s =
        in ? src + static_cast<long long>(row0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + swz(r, c * 8), s, in);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores: bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair (round to nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The A fragments of 16 tile rows [row0, row0 + 16) x 64 columns: a[kc][.]
// covers columns 16 kc .. 16 kc + 15.
__device__ __forceinline__ void load_a_frags(unsigned (&a)[4][4],
                                             const __nv_bfloat16* tile,
                                             int row0, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    ldsm_x4(a[kc], tile + swz(row0 + (lane & 15), kc * 16 + (lane >> 4) * 8));
}

// The A fragment of A = T^T for a tile T stored (k rows, m columns): rows
// [m0, m0 + 16) of A at k columns [k0, k0 + 16), read transposed.
__device__ __forceinline__ void load_a_km(unsigned* a,
                                          const __nv_bfloat16* tile, int k0,
                                          int m0, int lane) {
  ldsm_x4_trans(a, tile + swz(k0 + (lane & 7) + ((lane >> 4) << 3),
                              m0 + ((lane >> 3) & 1) * 8));
}

// B fragments of B = T^T for a tile T stored (n rows, k columns): the two
// n-tiles of rows [n0, n0 + 16) at k columns [k0, k0 + 16).  b[0], b[1]
// feed n-tile n0 / 8, b[2], b[3] n-tile n0 / 8 + 1.
__device__ __forceinline__ void load_b_nk(unsigned* b,
                                          const __nv_bfloat16* tile, int n0,
                                          int k0, int lane) {
  ldsm_x4(b, tile + swz(n0 + (lane & 7) + ((lane >> 4) << 3),
                        k0 + ((lane >> 3) & 1) * 8));
}

// B fragments of B = T for a tile T stored (k rows, n columns): k rows
// [k0, k0 + 16) for the two n-tiles at columns [n0, n0 + 16).  b[0], b[1]
// feed n-tile n0 / 8, b[2], b[3] n-tile n0 / 8 + 1.
__device__ __forceinline__ void load_b_kn(unsigned* b,
                                          const __nv_bfloat16* tile, int k0,
                                          int n0, int lane) {
  ldsm_x4_trans(b, tile + swz(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                              n0 + (lane >> 4) * 8));
}

// acc (16 x 64, eight C tiles) += A (16 x 64) times the 64 x 64 tile `t`
// stored (k rows, n columns).
__device__ __forceinline__ void mma_a_tkn(float (&acc)[8][4],
                                          const unsigned (&a)[4][4],
                                          const __nv_bfloat16* t, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      load_b_kn(b, t, kc * 16, np * 16, lane);
      mma_bf16(acc[2 * np], a[kc], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kc], b[2], b[3]);
    }
  }
}

// acc (16 x 64, eight C tiles over the 64 rows of `t`) += A (16 x 64) times
// the transpose of the 64 x 64 tile `t` stored (n rows, k columns).
__device__ __forceinline__ void mma_a_tnk_add(float (&acc)[8][4],
                                              const unsigned (&a)[4][4],
                                              const __nv_bfloat16* t,
                                              int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      load_b_nk(b, t, np * 16, kc * 16, lane);
      mma_bf16(acc[2 * np], a[kc], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[kc], b[2], b[3]);
    }
  }
}

// acc = A (16 x 64) times the transpose of the 64 x 64 tile `t` stored
// (n rows, k columns).
__device__ __forceinline__ void mma_a_tnk(float (&acc)[8][4],
                                          const unsigned (&a)[4][4],
                                          const __nv_bfloat16* t, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  mma_a_tnk_add(acc, a, t, lane);
}

// The f32 C tiles of a 16 x 64 product as bf16 A fragments along k
// (k = the product's 64 columns): a[kc] from C tiles 2 kc and 2 kc + 1.
__device__ __forceinline__ void c_to_a(unsigned (&a)[4][4],
                                       const float (&c)[8][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a[kc][0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
    a[kc][1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
    a[kc][2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
    a[kc][3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
  }
}

// Stores a warp's 16 x 64 f32 accumulator times mul[row half] as bf16 into
// rows [row0, row0 + 16) of a swizzled tile (4-byte stores, no bank
// conflict): c[.][0..1] are row row0 + g, c[.][2..3] row row0 + g + 8.
__device__ __forceinline__ void stage_c(__nv_bfloat16* tile,
                                        const float (&c)[8][4], int row0,
                                        float mul_lo, float mul_hi,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<unsigned*>(tile + swz(row0 + g, col)) =
        pack_bf16(c[nt][0] * mul_lo, c[nt][1] * mul_lo);
    *reinterpret_cast<unsigned*>(tile + swz(row0 + g + 8, col)) =
        pack_bf16(c[nt][2] * mul_hi, c[nt][3] * mul_hi);
  }
}

// Copies rows [row0, row0 + 16) of a swizzled tile to global memory in
// 16-byte stores (eight lanes per 128-byte row), skipping rows at or past
// `rows`; grow0 is the first row's index in the global slice.
__device__ __forceinline__ void store_rows16(__nv_bfloat16* dst,
                                             long long row_stride,
                                             const __nv_bfloat16* tile,
                                             int row0, int grow0, int rows,
                                             int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i * 4 + (lane >> 3), c = lane & 7;
    if (grow0 + r < rows)
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(grow0 + r) *
                                          row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz(row0 + r, c * 8));
  }
}
