// Rows of bf16, int8 or packed int4 values streamed from device memory
// straight into the A fragments of mma.sync.m16n8k16 (bf16 in, f32
// accumulate), and the B fragments of f32 query rows staged to match them.
// Shared by csrc/ivf_fused.cu (the grouped IVF boards) and csrc/maxsim.cu
// (the warp MaxSim variant); ops/_build.py hashes this header into both
// libraries' names.
//
// K order. A warp reads a 16-row tile in 128-byte steps of its rows: lane
// (g, t) (g = lane / 4, t = lane % 4) loads the 16-byte pieces t and 4 + t
// (pp = 0, 1) of rows g and g + 8. A piece holds E values (8 bf16, 16 int8
// or 32 int4), a step KPS = E / 2 k16 slices, and slice pp * (E / 4) + h
// of a step comes from piece pp:
//   bf16, int8  values 4h..4h+3: the first two take the fragment's k = 2t,
//               2t+1, the last two k = 2t+8, 2t+9;
//   int4        word i = h / 2 holds dims 8i..8i+7 (nibble j is dim j, the
//               codec's byte layout), and c = h % 2 picks dims (2c, 2c+4)
//               for k = 2t, 2t+1 and (2c+1, 2c+5) for k = 2t+8, 2t+9: the
//               pairs one widening gives.
// The query's B fragments are staged with the same map (`group_slot`,
// `b_group`), so each lane reads its B fragment as one 8-byte word and
// every dot product is unchanged. bf16 rows are their own fragments; int8
// rows widen to bf16 exactly with a byte permute and one f32 subtract a
// value, int4 rows with one lop3 and one bf16x2 subtract per two values
// (ops/ivf_fused.py::int4_k_order and ops/maxsim.py::fragment_k_order
// write the order out). A zero-filled int4 byte widens to level -8, not 0:
// only a zero query value at its dims cancels it.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum { DT_F32 = 0, DT_BF16 = 1, DT_INT8 = 2, DT_INT4 = 3 };

constexpr int STEP_BYTES = 128;       // row bytes a warp loads a step

// values of the tile type that one 16-byte piece holds
__host__ __device__ constexpr int piece_values(int dt) {
  return dt == DT_BF16 ? 8 : dt == DT_INT8 ? 16 : 32;
}

__device__ __forceinline__ float int8_at(uint32_t w, int byte) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * byte)) & 0xFFu));
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // .x = a (low half)
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes of a tile row: read once, so kept out of L1; L2 fetches the
// whole 128-byte step of the row at the first of its 8 pieces
__device__ __forceinline__ uint4 ldg_stream(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// c += A (16 x 16, row) * B (16 x 8, col): bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The four int8 levels of w as two bf16x2 words (levels 0,1 -> lo; 2,3 ->
// hi), exactly: x + 128 goes into the low byte of 2^23, one f32 subtract
// gives x, and an integer of at most 8 significant bits is its own bf16.
__device__ __forceinline__ void widen_int8(uint32_t w, uint32_t& lo,
                                           uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t m = 0x4B000000u;
  const float f0 = __uint_as_float(__byte_perm(u, m, 0x7440)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, m, 0x7441)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, m, 0x7442)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, m, 0x7443)) - 8388736.0f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Two int4 levels of a word as one bf16x2, exactly: the nibbles at bits
// 0-3 and 16-19 of x go into the low mantissa bits of 128 (bf16 has unit
// spacing on [128, 256)), then one bf16x2 subtract of 136 gives n - 8.
// `magic` is 0x43004300 (bf16x2 128, 128); held in a register (see
// `opaque`) it lets the mask and the or be one lop3.
__device__ __forceinline__ uint32_t int4_pair(uint32_t x,
                                              uint32_t magic = 0x43004300u) {
  const uint32_t v = (x & 0x000F000Fu) | magic;
  const uint32_t bias = 0x43084308u;                  // bf16x2 (136, 136)
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// A constant the compiler cannot fold into an instruction's immediate.
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  uint32_t r;
  asm volatile("mov.b32 %0, %1;" : "=r"(r) : "r"(v));
  return r;
}

// The A fragment of k16 slice r (< KPS) of a step, from the lane's pieces
// p = [row g pp 0, row g pp 1, row g+8 pp 0, row g+8 pp 1] (int4: `magic`
// as for int4_pair).
template <int DT>
__device__ __forceinline__ void a_slice(const uint4 (&p)[4], int r,
                                        uint32_t& a0, uint32_t& a1,
                                        uint32_t& a2, uint32_t& a3,
                                        uint32_t magic = 0x43004300u) {
  constexpr int H = piece_values(DT) / 4;   // slices a piece
  const int pp = r / H, h = r % H;
  if constexpr (DT == DT_BF16) {
    a0 = word(p[pp], 2 * h);
    a2 = word(p[pp], 2 * h + 1);
    a1 = word(p[2 + pp], 2 * h);
    a3 = word(p[2 + pp], 2 * h + 1);
  } else if constexpr (DT == DT_INT8) {
    widen_int8(word(p[pp], h), a0, a2);
    widen_int8(word(p[2 + pp], h), a1, a3);
  } else {
    const int sh = 8 * (h & 1);
    const uint32_t wa = word(p[pp], h >> 1) >> sh;
    const uint32_t wb = word(p[2 + pp], h >> 1) >> sh;
    a0 = int4_pair(wa, magic);
    a2 = int4_pair(wa >> 4, magic);
    a1 = int4_pair(wb, magic);
    a3 = int4_pair(wb >> 4, magic);
  }
}

// Group gi of a query row's B fragments: one lane's 8 bytes of one slice.
// Returns the slice (counted over the row's steps) and sets the lane's t
// and d0, the first dim of its 4 values (bf16, int8) or of its word's 8
// (int4).
template <int DT>
__device__ __forceinline__ int group_slot(int gi, int& t, int& d0) {
  constexpr int E = piece_values(DT), KPS = E / 2;
  d0 = DT == DT_INT4 ? 8 * (gi >> 1) : 4 * gi;
  const int e = d0 % (8 * E);
  const int pp = e / (4 * E);
  t = (e % (4 * E)) / E;
  const int h = DT == DT_INT4 ? 2 * ((e % E) / 8) + (gi & 1) : (e % E) / 4;
  return (d0 / (8 * E)) * KPS + pp * (E / 4) + h;
}

// The bf16-rounded B fragment word pair of group gi, from the query row at
// its d0 (f32; 16-byte aligned for bf16 and int8, 8-byte for int4)
template <int DT>
__device__ __forceinline__ uint2 b_group(const float* qr, int gi) {
  if constexpr (DT == DT_INT4) {
    const int c = 2 * (gi & 1);
    const float2 lo = *reinterpret_cast<const float2*>(qr + c);
    const float2 hi = *reinterpret_cast<const float2*>(qr + c + 4);
    return make_uint2(bf16x2(lo.x, hi.x), bf16x2(lo.y, hi.y));
  } else {
    const float4 f = *reinterpret_cast<const float4*>(qr);
    return make_uint2(bf16x2(f.x, f.y), bf16x2(f.z, f.w));
  }
}

}  // namespace
