// Fused gather + MaxSim rescore of late-interaction candidates for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernels of elasticsearch_tpu/ops/pallas_maxsim.py:
//   maxsim_dense <- _dense_kernel   (f32 / bf16 / int8 token tiles)
//   maxsim_int4  <- _int4_kernel    (packed-nibble int4 token tiles)
// both launched there by _maxsim_impl.
//
// What they compute. For query q with Tq token rows and candidate doc
// n = ids[q, j], over the cap token slots c of that doc's tile:
//   dense: dot[t, c] = sum_d bf16(q[t, d]) * bf16(toks[n, c, d])      (f32)
//   int4:  dot[t, c] = sum_w bf16(q[t, 2w]) * lo(toks[n, c, w])
//                    + sum_w bf16(q[t, 2w+1]) * hi(toks[n, c, w])
//          (two f32 sums added at the end), lo = (x & 0xF) - 8, hi = (x >> 4) - 8
//   board[q, j] = sum_t max_c (s[n, c] > 0 ? dot[t, c] * s[n, c] : -3e38)
// The sum over t runs in a fixed order (lane t mod 32 sums its rows in
// order, then a butterfly over the 32 lanes). A doc with no valid slot (the
// padding row) sums Tq sentinels, which overflows to -inf in f32, as on the
// TPU: the build must not use fast math. Every bf16 x bf16 product is exact
// in f32, so only the order of the f32 sums differs from the plain version.
//
// Layout. The TPU kernel prefetches the candidate ids as scalars and runs
// one [Tq, D] x [cap, D]^T MXU dot per (query, candidate) grid step. Here a
// block of 4 warps owns one query and a run of `cpb` of its candidates: it
// reads its own ids, stages the query as bf16 in shared memory (rows padded
// to 16 with zeros; the int4 query as its even and odd planes), then streams
// each candidate's tile in chunks of 64 token slots. A chunk whose 64 scales
// are all 0 is skipped (its slots are all masked, so the running max would
// not change); otherwise only the rows with a scale > 0 are read from device
// memory and converted to bf16 into shared memory (rows are a doc's tokens,
// so a doc of 70 tokens reads 70 rows of its 256-slot tile). Each warp
// multiplies the query by 16 doc slots with WMMA m16n16k16 (bf16 in, f32
// accumulate) into a per-warp f32 board, applies scale and mask, and keeps
// a running max per query row; the warps' maxima are combined, and one warp
// sums over the query rows.
//
// Shared memory is bounded whatever Tq and D are. Query rows are taken in
// groups of at most 128 (a candidate's chunks are streamed once per group),
// and the feature dim in slabs of `ks` columns, the widest that fits in the
// 227 KB of a block (the whole width at ColBERT's 128; 256 or 128 at 768 or
// 1024 dims), the WMMA boards accumulating over the slabs. At Tq <= 128 and
// one slab the query is staged once per block and the tile read once per
// candidate, and a warp folds each 16 x 16 board into the maxima as soon
// as it is done (a separate instantiation: the many-slab boards would take
// shared memory that holds blocks on the SM).
//
// What bounds it on the H100. At Tq = 32 and D = 128 it does 2 * 32 = 64
// operations per token element it reads (int8: 64 per byte), well under
// the ~295 per byte where the bf16 tensor cores would be the limit, so it
// is bound by bytes: the least bytes are the valid token rows of each
// distinct candidate doc, read once, with their scales. This first version
// reads a doc once per (query, candidate) naming it and leaves reuse across
// queries to L2; cp.async / TMA staging and wgmma over two candidates (64
// rows) are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int THREADS = 128;          // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int CAPC = 16 * WARPS;      // doc token slots per staged chunk
constexpr int QG_MAX = 128;           // query rows per group
constexpr int PAD = 8;                // bf16 padding of a staged row
constexpr int MAX_SMEM = 232448;      // 227 KB, the H100's per-block limit
constexpr float NEG = -3.0e38f;       // the NEG_INF sentinel

enum { DT_F32 = 0, DT_BF16 = 1, DT_INT8 = 2, DT_INT4 = 3 };

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // .x = a (low half)
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float int8_at(uint32_t w, int byte) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * byte)) & 0xFFu));
}

// Convert one 16-byte vector (vector `cv` of a token row's slab) to bf16
// and store it into shared row `r` of the staged planes (row stride ld).
template <int DT>
__device__ __forceinline__ void stage_vec(uint4 x, __nv_bfloat16* ds, int r,
                                          int cv, int ld) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  if constexpr (DT == DT_F32) {
    uint2 o;
    o.x = pack_bf16x2(__uint_as_float(w[0]), __uint_as_float(w[1]));
    o.y = pack_bf16x2(__uint_as_float(w[2]), __uint_as_float(w[3]));
    *reinterpret_cast<uint2*>(ds + (size_t)r * ld + cv * 4) = o;
  } else if constexpr (DT == DT_BF16) {
    *reinterpret_cast<uint4*>(ds + (size_t)r * ld + cv * 8) = x;
  } else if constexpr (DT == DT_INT8) {
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = pack_bf16x2(int8_at(w[i], 0), int8_at(w[i], 1));
      o[2 * i + 1] = pack_bf16x2(int8_at(w[i], 2), int8_at(w[i], 3));
    }
    uint4* dst = reinterpret_cast<uint4*>(ds + (size_t)r * ld + cv * 16);
    dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
    dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
  } else {
    // 16 packed bytes: the low nibbles go to plane 0 (even dims), the high
    // nibbles to plane 1 (odd dims), at the same 16 columns
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float l[4], h[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int byte = (w[i] >> (8 * b)) & 0xFF;
        l[b] = static_cast<float>((byte & 0xF) - 8);
        h[b] = static_cast<float>((byte >> 4) - 8);
      }
      lo[2 * i] = pack_bf16x2(l[0], l[1]);
      lo[2 * i + 1] = pack_bf16x2(l[2], l[3]);
      hi[2 * i] = pack_bf16x2(h[0], h[1]);
      hi[2 * i + 1] = pack_bf16x2(h[2], h[3]);
    }
    uint4* d0 = reinterpret_cast<uint4*>(ds + (size_t)r * ld + cv * 16);
    uint4* d1 = reinterpret_cast<uint4*>(ds + ((size_t)CAPC + r) * ld + cv * 16);
    d0[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    d0[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    d1[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    d1[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  }
}

// Fold one warp's 16 x 16 board (query rows x the warp's 16 chunk slots)
// into the running maxima of its 16 query rows: lane l takes row l / 2 and
// slots 8 * (l % 2) .. + 8. With NP == 2 the board holds the two plane sums
// `plane` floats apart and they are added here, as the TPU kernel does.
template <int NP>
__device__ __forceinline__ void fold_max(const float* board, size_t plane,
                                         const float* sc, float* part,
                                         int lane) {
  const int r = lane >> 1, cb = (lane & 1) * 8;
  const float* b0 = board + r * 16 + cb;
  float m = NEG;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float sv = sc[cb + c];
    float dv = b0[c];
    if constexpr (NP == 2) dv = dv + b0[plane + c];
    m = fmaxf(m, sv > 0.0f ? __fmul_rn(dv, sv) : NEG);
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  if ((lane & 1) == 0) part[r] = fmaxf(part[r], m);
}

// Shared memory: query planes [NP][qg][ks + PAD] bf16, doc chunk planes
// [NP][CAPC][ks + PAD] bf16, the per-warp f32 boards, the chunk's scales,
// and the per-warp running maxima [WARPS][qg]. One slab: a 16 x 16 board a
// warp, folded as soon as a row block is done. Several slabs: a warp keeps
// [NP][qg][16] boards that accumulate over the slabs before the fold.
size_t smem_bytes(int np, int qg, int ks, bool slabs) {
  const size_t ld = (size_t)ks + PAD;
  const size_t board = slabs ? (size_t)np * qg * 16 : 256;
  return (size_t)np * (qg + CAPC) * ld * 2 + (size_t)WARPS * board * 4 +
         CAPC * 4 + (size_t)WARPS * qg * 4;
}

template <int DT, bool SLABS>
__global__ void __launch_bounds__(THREADS) maxsim_kernel(
    const int32_t* __restrict__ ids, const float* __restrict__ q,
    const uint8_t* __restrict__ toks, const float* __restrict__ scales,
    float* __restrict__ out, int nw, int tq, int n_pad, int cap, int w,
    int cpb, int qg, int ks) {
  constexpr int NP = DT == DT_INT4 ? 2 : 1;                 // planes
  constexpr int E = DT == DT_F32 ? 4 : (DT == DT_BF16 ? 2 : 1);
  const int pw = w;                   // plane width (int4: one byte each)
  const int ld = ks + PAD;
  const int tq16 = (tq + 15) & ~15;
  const int ngroups = (tq16 + qg - 1) / qg;
  const int nslabs = SLABS ? (pw + ks - 1) / ks : 1;
  const size_t board_floats = SLABS ? (size_t)NP * qg * 16 : 256;
  extern __shared__ __align__(128) uint8_t smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ds = qs + (size_t)NP * qg * ld;
  float* boards = reinterpret_cast<float*>(ds + (size_t)NP * CAPC * ld);
  float* sc = boards + WARPS * board_floats;
  float* part = sc + CAPC;
  const int qi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* board = boards + warp * board_floats;

  const int dq = NP * pw;
  const float* qrow = q + (size_t)qi * tq * dq;
  const size_t row_bytes = (size_t)w * E;
  int staged = -1;        // the (group, slab) the query planes hold
  const int j0 = static_cast<int>(blockIdx.x) * cpb;
  const int j1 = min(j0 + cpb, nw);
  for (int j = j0; j < j1; ++j) {
    const int id = ids[(size_t)qi * nw + j];
    const bool id_ok = id >= 0 && id < n_pad;
    const uint8_t* tile = toks + (size_t)(id_ok ? id : 0) * cap * row_bytes;
    const float* tscale = scales + (size_t)(id_ok ? id : 0) * cap;
    float total = 0.0f;   // warp 0: lane l sums query rows t = l (mod 32)
    for (int g = 0; g < ngroups; ++g) {
      const int g0 = g * qg;
      const int rows_g = min(qg, tq16 - g0);      // a multiple of 16
      for (int i = threadIdx.x; i < WARPS * qg; i += THREADS) part[i] = NEG;
      for (int c0 = 0; c0 < cap; c0 += CAPC) {
        __syncthreads();  // the last chunk's reads are done; part is set
        float s = 0.0f;
        if (threadIdx.x < CAPC) {
          if (id_ok && c0 + threadIdx.x < cap) s = tscale[c0 + threadIdx.x];
          sc[threadIdx.x] = s;
        }
        if (!__syncthreads_or(s > 0.0f)) continue;  // all masked: max unchanged
        const int rows = min(CAPC, cap - c0);
        for (int sl = 0; sl < nslabs; ++sl) {
          const int k0 = sl * ks, kw = min(ks, pw - k0);
          if (sl > 0) __syncthreads();    // the last slab's reads are done
          if (g * nslabs + sl != staged) {
            // query rows [g0, g0 + rows_g), plane columns [k0, k0 + kw),
            // bf16-rounded; rows tq .. tq16 are zero
            const int span = NP * kw;
            for (int i = threadIdx.x; i < rows_g * span; i += THREADS) {
              const int tl = i / span, dl = i % span, t = g0 + tl;
              const float v =
                  t < tq ? qrow[(size_t)t * dq + (size_t)NP * k0 + dl] : 0.0f;
              const int p = NP == 2 ? (dl & 1) : 0;
              const int col = NP == 2 ? (dl >> 1) : dl;
              qs[((size_t)p * qg + tl) * ld + col] = __float2bfloat16_rn(v);
            }
            staged = g * nslabs + sl;
          }
          const int vps = kw * E / 16;   // 16-byte vectors per row slab
          const uint8_t* slab = tile + (size_t)k0 * E;
          for (int v = threadIdx.x; v < rows * vps; v += THREADS) {
            const int r = v / vps, cv = v % vps;
            if (!(sc[r] > 0.0f)) continue;           // a masked slot: not read
            const uint4 x = __ldg(reinterpret_cast<const uint4*>(
                                      slab + (size_t)(c0 + r) * row_bytes) + cv);
            stage_vec<DT>(x, ds, r, cv, ld);
          }
          __syncthreads();
          // warp w: chunk slots [16w, 16w + 16) against every 16-row query
          // block of the group
          for (int rb = 0; rb < rows_g / 16; ++rb) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NP];
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              float* bp = board + ((size_t)p * qg + rb * 16) * 16;
              if (SLABS && sl > 0)
                wmma::load_matrix_sync(acc[p], bp, 16, wmma::mem_row_major);
              else
                wmma::fill_fragment(acc[p], 0.0f);
              for (int k = 0; k < kw; k += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major> a;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::col_major> b;
                wmma::load_matrix_sync(
                    a, qs + ((size_t)p * qg + rb * 16) * ld + k, ld);
                wmma::load_matrix_sync(
                    b, ds + ((size_t)p * CAPC + warp * 16) * ld + k, ld);
                wmma::mma_sync(acc[p], a, b, acc[p]);
              }
              if constexpr (SLABS)
                wmma::store_matrix_sync(bp, acc[p], 16, wmma::mem_row_major);
            }
            if constexpr (!SLABS) {
              // the whole width in one slab: add the planes in registers
              // and fold this row block now
              if constexpr (NP == 2) {
#pragma unroll
                for (int i = 0; i < acc[0].num_elements; ++i)
                  acc[0].x[i] = acc[0].x[i] + acc[1].x[i];
              }
              wmma::store_matrix_sync(board, acc[0], 16, wmma::mem_row_major);
              __syncwarp();
              fold_max<1>(board, 0, sc + warp * 16,
                          part + warp * qg + rb * 16, lane);
              __syncwarp();  // the board is reused by the next row block
            }
          }
        }
        if constexpr (SLABS) {
          __syncwarp();
          for (int rb = 0; rb < rows_g / 16; ++rb)
            fold_max<NP>(board + (size_t)rb * 16 * 16, (size_t)qg * 16,
                         sc + warp * 16, part + warp * qg + rb * 16, lane);
          __syncwarp();  // the boards are rewritten by the next chunk
        }
      }
      __syncthreads();
      if (warp == 0) {
        for (int t = g0 + lane; t < min(g0 + rows_g, tq); t += 32) {
          float m = part[t - g0];
#pragma unroll
          for (int x = 1; x < WARPS; ++x) m = fmaxf(m, part[x * qg + t - g0]);
          total = __fadd_rn(total, m);
        }
      }
      __syncthreads();  // part is re-initialised for the next group
    }
    if (warp == 0) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        total = __fadd_rn(total, __shfl_xor_sync(0xffffffffu, total, o));
      if (lane == 0) out[(size_t)qi * nw + j] = total;
    }
  }
}

template <int DT>
cudaError_t launch(const void* ids, const void* q, const void* toks,
                   const void* scales, void* out, int nq, int nw, int tq,
                   int n_pad, int cap, int w, cudaStream_t s) {
  if (nq <= 0 || nq > 65535 || nw <= 0 || tq <= 0 || n_pad <= 0 ||
      cap <= 0 || w <= 0 || w % 16)
    return cudaErrorInvalidValue;
  const int np = DT == DT_INT4 ? 2 : 1;
  const int qg = min((tq + 15) & ~15, QG_MAX);
  // the whole plane width in one slab if it fits, else the widest slab
  // that does (a 16-column slab always fits)
  int ks = w;
  if (smem_bytes(np, qg, ks, false) > (size_t)MAX_SMEM)
    for (int cand = 512; smem_bytes(np, qg, ks, true) > (size_t)MAX_SMEM;
         cand /= 2)
      if (cand < ks) ks = cand;
  const bool slabs = ks < w;
  const size_t smem = smem_bytes(np, qg, ks, slabs);
  auto kernel = slabs ? maxsim_kernel<DT, true> : maxsim_kernel<DT, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // a few candidates a block once there are enough blocks to fill the card
  const int cpb = max(1, min(8, (int)(((long long)nq * nw) / 2048)));
  const dim3 grid((unsigned)((nw + cpb - 1) / cpb), (unsigned)nq);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(q),
      static_cast<const uint8_t*>(toks), static_cast<const float*>(scales),
      static_cast<float*>(out), nw, tq, n_pad, cap, w, cpb, qg, ks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32, 1 = bf16, 2 = int8 token tiles. q: [nq, tq, w] f32.
int maxsim_dense(const void* ids, const void* q, const void* toks,
                 const void* scales, void* out, int nq, int nw, int tq,
                 int n_pad, int cap, int w, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch<DT_F32>(ids, q, toks, scales, out, nq, nw, tq, n_pad,
                            cap, w, s);
    case DT_BF16:
      return launch<DT_BF16>(ids, q, toks, scales, out, nq, nw, tq, n_pad,
                             cap, w, s);
    case DT_INT8:
      return launch<DT_INT8>(ids, q, toks, scales, out, nq, nw, tq, n_pad,
                             cap, w, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Packed-nibble tiles [n_pad, cap, w] uint8; q: [nq, tq, 2w] f32 (the
// kernel splits it into its even and odd planes).
int maxsim_int4(const void* ids, const void* q, const void* toks,
                const void* scales, void* out, int nq, int nw, int tq,
                int n_pad, int cap, int w, void* stream) {
  return launch<DT_INT4>(ids, q, toks, scales, out, nq, nw, tq, n_pad, cap,
                         w, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
