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
//          lo = (x & 0xF) - 8, hi = (x >> 4) - 8
//   board[q, j] = sum_t max_c (s[n, c] > 0 ? dot[t, c] * s[n, c] : -3e38)
// The sum over t runs in a fixed order. A doc with no valid slot (the
// padding row), and an id outside [0, n_pad), sums Tq sentinels, which
// overflows to -inf in f32, as on the TPU: the build must not use fast
// math. Every bf16 x bf16 product is exact in f32, so only the order of the
// f32 sums differs from the plain version (int4 may merge its two planes'
// sums into one).
//
// What bounds them on the H100: bytes. At Tq = 32 and D = 128 they do 64
// operations per token value read (int8: 64 a byte, int4: 128), far under
// the ~295 a byte where the bf16 tensor cores would be the limit. The
// least bytes are the valid token rows of each distinct candidate doc,
// read once, with their scales. Docs hold 8-180 tokens (mean ~70) of a
// 256-slot tile, and a (query, candidate) is a chain of dependent reads
// (id -> scales -> rows). Measured, neither bytes nor the tensor-core rate
// sets the warp variant's time: its instruction latency per 16-row tile
// does (below).
//
// Two variants; the caller's launch plan (ops/maxsim.py::launch_plan) picks
// one and passes it in with its candidates a block and shared memory, which
// the entries check:
//
// warp  bf16, int8 and int4 tiles at Tq <= 32 (every served shape). One
//       warp scores one (query, candidate) at a time; a block of 4 warps
//       takes a run of `cpb` candidates of one query (warp w every 4th).
//       The block stages the query once, bf16-rounded, as mma.sync B
//       fragments in the K order of csrc/mma_frag.cuh (4 column tiles of
//       8 tokens, zero past Tq and past D). A warp reads a candidate's
//       scale row (lane l holds slots l, l + 32, ...) and takes its span
//       n_c = 1 + the last slot with scale > 0 by a warp max; only rows
//       [0, n_c) are read, 16 at a time, 16 bytes a lane a 128-byte step
//       (the grouped IVF kernels' layout), into the A fragments of
//       mma.sync.m16n8k16 (bf16 in, f32 accumulate); int8 and int4 widen
//       to bf16 exactly. A slot inside the span whose scale is 0 is still
//       masked: the scale decides, the span only saves bytes. Bytes in
//       flight: a warp copies its units (one step of 16 rows; int4 at 128
//       dims, 64-byte rows: of 32 rows) into its own ring in shared memory
//       with cp.async, W_STAGES - 1 units ahead of the unit it scores,
//       across candidate boundaries, and the next candidate's scale row is
//       loading meanwhile, so the id -> scales -> rows chain is paid once a
//       warp, not once a candidate. Loads past n_c (so past cap) and past
//       the row are zero-filled, never read. At 128 dims the query's
//       fragments are held in registers (64 a lane). Measured on the H100
//       (PERF.md): the time is set by the warps' instruction latency at 3
//       warps a scheduler, not by bytes or tensor-core rate; a register
//       double buffer (one step ahead) ran int4 at 0.084 ms where this
//       ring runs 0.069 at Q=256.
//       Epilogue in registers: each lane holds rows g and g + 8 of 8-token
//       tiles; it scales, masks to -3e38 and keeps a running max per (row
//       pair, token); at the end of the candidate, shuffles take the max
//       over the 8 row groups and sum the tokens t < Tq (each lane its
//       tokens in order, then a butterfly over the 4 lanes of a row
//       group), and lane 0 stores. No shared-memory board and no block
//       barrier after the staging. mma.sync rather than wgmma: docs fit
//       16-row tiles, and a 64-row wgmma tile would spend half its work on
//       padding.
// wmma  f32 tiles, Tq > 32 and query fragments over 64 KB: the first
//       port's kernel, unchanged. A block of 4 warps owns one query and a
//       run of `cpb` of its candidates: it stages the query as bf16 in
//       shared memory (rows padded to 16 with zeros; the int4 query as its
//       even and odd planes), then streams each candidate's tile in chunks
//       of 64 token slots. A chunk whose 64 scales are all 0 is skipped;
//       otherwise only the rows with a scale > 0 are read and converted to
//       bf16 into shared memory. Each warp multiplies the query by 16 doc
//       slots with WMMA m16n16k16 into a per-warp f32 board, applies scale
//       and mask, and keeps a running max per query row; the warps' maxima
//       are combined, and one warp sums over the query rows. Query rows
//       are taken in groups of at most 128, the feature dim in slabs of
//       `ks` columns, the widest that fits in the 227 KB of a block, so any
//       Tq and D fit; at Tq <= 128 and one slab each 16 x 16 board is
//       folded as soon as it is done (a separate instantiation).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "mma_frag.cuh"


using namespace nvcuda;

namespace {

constexpr float NEG = -3.0e38f;       // the NEG_INF sentinel
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- wmma variant

constexpr int THREADS = 128;          // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int CAPC = 16 * WARPS;      // doc token slots per staged chunk
constexpr int QG_MAX = 128;           // query rows per group
constexpr int PAD = 8;                // bf16 padding of a staged row
constexpr int MAX_SMEM = 232448;      // 227 KB, the H100's per-block limit

// Convert one 16-byte vector (vector `cv` of a token row's slab) to bf16
// and store it into shared row `r` of the staged planes (row stride ld).
template <int DT>
__device__ __forceinline__ void stage_vec(uint4 x, __nv_bfloat16* ds, int r,
                                          int cv, int ld) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  if constexpr (DT == DT_F32) {
    uint2 o;
    o.x = bf16x2(__uint_as_float(w[0]), __uint_as_float(w[1]));
    o.y = bf16x2(__uint_as_float(w[2]), __uint_as_float(w[3]));
    *reinterpret_cast<uint2*>(ds + (size_t)r * ld + cv * 4) = o;
  } else if constexpr (DT == DT_BF16) {
    *reinterpret_cast<uint4*>(ds + (size_t)r * ld + cv * 8) = x;
  } else if constexpr (DT == DT_INT8) {
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = bf16x2(int8_at(w[i], 0), int8_at(w[i], 1));
      o[2 * i + 1] = bf16x2(int8_at(w[i], 2), int8_at(w[i], 3));
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
      lo[2 * i] = bf16x2(l[0], l[1]);
      lo[2 * i + 1] = bf16x2(l[2], l[3]);
      hi[2 * i] = bf16x2(h[0], h[1]);
      hi[2 * i + 1] = bf16x2(h[2], h[3]);
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

// The wmma launch's shape: query rows a group, slab columns and whether
// the width is cut into slabs (the whole plane width in one slab if it
// fits, else the widest that does; a 16-column slab always fits); returns
// its shared memory.
size_t wmma_shape(int dt, int tq, int w, int& qg, int& ks, bool& slabs) {
  const int np = dt == DT_INT4 ? 2 : 1;
  qg = min((tq + 15) & ~15, QG_MAX);
  ks = w;
  if (smem_bytes(np, qg, ks, false) > (size_t)MAX_SMEM)
    for (int cand = 512; smem_bytes(np, qg, ks, true) > (size_t)MAX_SMEM;
         cand /= 2)
      if (cand < ks) ks = cand;
  slabs = ks < w;
  return smem_bytes(np, qg, ks, slabs);
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int DT>
cudaError_t launch_wmma(const void* ids, const void* q, const void* toks,
                        const void* scales, void* out, int nq, int nw, int tq,
                        int n_pad, int cap, int w, int cpb, cudaStream_t s) {
  int qg, ks;
  bool slabs;
  const size_t smem = wmma_shape(DT, tq, w, qg, ks, slabs);
  auto kernel = slabs ? maxsim_kernel<DT, true> : maxsim_kernel<DT, false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((nw + cpb - 1) / cpb), (unsigned)nq);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(q),
      static_cast<const uint8_t*>(toks), static_cast<const float*>(scales),
      static_cast<float*>(out), nw, tq, n_pad, cap, w, cpb, qg, ks);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- warp variant

constexpr int W_WARPS = 4;              // warps a block
constexpr int W_THREADS = 32 * W_WARPS;
constexpr int W_NT = 4;                 // 8-token column tiles of the query
constexpr int W_TQ_MAX = 8 * W_NT;
constexpr int W_MAX_CPW = 32;           // candidates a warp: one id a lane
constexpr int W_SP = 8;                 // scale slots a lane prefetches
constexpr int W_MAX_FRAG = 65536;       // the query fragments of a block
constexpr int W_STAGES = 4;             // units in a warp's ring
constexpr int W_D128_SLICES = 8;        // k16 slices of a 128-dim row

// the bytes of a token row of w tile values (int4: w packed bytes)
__host__ __device__ constexpr long long warp_row_bytes(int w, int dt) {
  return dt == DT_BF16 ? 2LL * w : (long long)w;
}

// k16 slices of a row of rb bytes: KPS a whole 128-byte step, half of them
// for a last step of at most 64 bytes (its second pieces lie past the row)
__host__ __device__ constexpr int live_slices(long long rb, int dt) {
  return (int)((rb / STEP_BYTES) * (piece_values(dt) / 2) +
               (rb % STEP_BYTES == 0  ? 0
                : rb % STEP_BYTES <= 64 ? piece_values(dt) / 4
                                        : piece_values(dt) / 2));
}

// the block's query fragments [W_NT][slices][32 lanes] uint2
size_t warp_frag_bytes(int w, int dt) {
  return (size_t)W_NT * live_slices(warp_row_bytes(w, dt), dt) * 32 *
         sizeof(uint2);
}

// shared memory of a warp block: the query fragments, each warp's ring of
// W_STAGES units (4 pieces of 16 bytes a lane) and its candidates' spans
size_t warp_smem(int w, int dt) {
  return warp_frag_bytes(w, dt) +
         (size_t)W_WARPS * W_STAGES * 4 * 32 * sizeof(uint4) +
         (size_t)W_WARPS * W_MAX_CPW * sizeof(int);
}

// 16 bytes from global to shared memory, asynchronously; bytes < 16 fills
// the rest with zeros (0: no read)
__device__ __forceinline__ void cp_async16(uint4* dst, const uint8_t* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;" ::"r"(d),
      "l"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A token tile's candidate: its rows, its scale row and its span (one past
// the last slot with scale > 0; no row past it is read).
struct Cand {
  const uint8_t* tile;
  const float* sc;
  int n;
};

// KSR = 0: any row width, the query fragments read from shared memory.
// KSR > 0: rows of exactly KSR k16 slices (128 dims), the fragments held
// in registers (64 a lane), which keeps the fragment reads off shared
// memory. MT = 2: rows of at most 64 bytes (int4 at 128 dims) go two
// 16-row tiles a unit (pieces pp = 1 of the layout hold rows 16 + g and
// 24 + g), so a unit still moves a 2 KB step; the second tile is skipped
// when the span ends before it.
//
// Each warp runs a producer and a consumer over the same sequence of units
// (step s of tile u of candidate k, candidates with rows only): the
// producer issues a unit's pieces into the warp's ring with cp.async, one
// commit group a unit, W_STAGES - 1 units ahead of the consumer, and
// records each candidate's span in shared memory as it reaches it; the
// consumer waits for the oldest group, reads its own lane's pieces (each
// lane only ever reads what it copied itself, so no barrier), and scores
// them. A lane's slot in the ring is refilled only after its last read
// has fed an mma.
template <int DT, int KSR, int MT>
__global__ void __launch_bounds__(W_THREADS) maxsim_warp_kernel(
    const int32_t* __restrict__ ids, const float* __restrict__ q,
    const uint8_t* __restrict__ toks, const float* __restrict__ scales,
    float* __restrict__ out, int nw, int tq, int n_pad, int cap, int w,
    int cpb) {
  constexpr int KPS = piece_values(DT) / 2;   // k16 slices a step
  constexpr int RMAX = KSR > 0 && KSR < KPS ? KSR : KPS;
  constexpr int RU = 16 * MT;                 // rows a unit
  constexpr long long RB_C =
      KSR == 0 ? 0 : (KSR / KPS) * STEP_BYTES + (KSR % KPS ? 64 : 0);
  extern __shared__ __align__(16) uint8_t smem[];
  const long long rbytes = KSR ? RB_C : warp_row_bytes(w, DT);
  const int ksl = KSR ? KSR : live_slices(rbytes, DT);
  const int ns = (int)((rbytes + STEP_BYTES - 1) / STEP_BYTES);
  const int dq = DT == DT_INT4 ? 2 * w : w;        // query dims
  const int qi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t frag_bytes = (size_t)W_NT * ksl * 32 * sizeof(uint2);
  uint2* frag = reinterpret_cast<uint2*>(smem);   // [W_NT][ksl][32 lanes]
  uint4* ring = reinterpret_cast<uint4*>(smem + frag_bytes) +
                warp * W_STAGES * 4 * 32 + lane;  // [stage][piece][lane]
  int* spans = reinterpret_cast<int*>(
                   smem + frag_bytes + W_WARPS * W_STAGES * 4 * 32 *
                                           sizeof(uint4)) +
               warp * W_MAX_CPW;
  // the warp's candidates: j0, j0 + 4, ... below j_end; lane l holds the
  // id of the l-th
  const int j0 = (int)blockIdx.x * cpb + warp;
  const int j_end = min((int)blockIdx.x * cpb + cpb, nw);
  const int ncand = j0 < j_end ? (j_end - j0 + W_WARPS - 1) / W_WARPS : 0;
  const int my_id =
      lane < ncand ? ids[(long long)qi * nw + j0 + W_WARPS * lane] : -1;
  float* qout = out + (long long)qi * nw + j0;
  auto cand_id = [&](int k) { return __shfl_sync(FULL, my_id, k); };
  auto scale_row = [&](int id) {
    return scales + (long long)(id >= 0 && id < n_pad ? id : 0) * cap;
  };

  float sp[W_SP];  // the producer's next candidate's scales, slot 32 i + lane
  auto prefetch = [&](int id) {
    const bool ok = id >= 0 && id < n_pad;
    const float* sc = scale_row(id);
#pragma unroll
    for (int i = 0; i < W_SP; ++i)
      sp[i] = ok && 32 * i + lane < cap ? __ldg(sc + 32 * i + lane) : 0.0f;
  };
  // the candidate whose scales `sp` holds (slots past 32 W_SP read here)
  auto make = [&](int id) {
    const bool ok = id >= 0 && id < n_pad;
    Cand c;
    c.tile = toks + (long long)(ok ? id : 0) * cap * rbytes;
    c.sc = scale_row(id);
    int last = 0;
#pragma unroll
    for (int i = 0; i < W_SP; ++i)
      if (sp[i] > 0.0f) last = 32 * i + lane + 1;
    if (ok)
      for (int r = 32 * W_SP + lane; r < cap; r += 32)
        if (__ldg(c.sc + r) > 0.0f) last = r + 1;
    c.n = __reduce_max_sync(FULL, last);
    return c;
  };

  // producer: candidate pk (pc), unit (pu, ps); src, the lane's piece t of
  // row RU pu + g at step ps
  int pk = -1, pu = 0, ps = 0;
  Cand pc{toks, scales, 0};
  const uint8_t* src = toks;
  const long long tile_step = RU * rbytes - ns * STEP_BYTES;
  // on to the next candidate with rows, recording each span passed
  auto next_cand = [&]() {
    while (++pk < ncand) {
      pc = make(cand_id(pk));
      prefetch(pk + 1 < ncand ? cand_id(pk + 1) : -1);
      spans[pk] = pc.n;       // every lane writes (and later reads) its own
      if (pc.n > 0) {
        src = pc.tile + g * rbytes + 16 * t;
        return;
      }
    }
  };
  // issue the next unit into ring stage `st`, then commit a group (empty
  // past the last unit). Pieces: [row g pp 0, row g pp 1, row g+8 pp 0,
  // row g+8 pp 1], or with MT = 2 [rows g, g+16, g+8, g+24] at pp 0; zero
  // past the span and the row; a half step wholly past the row is not
  // copied: its slices are skipped.
  auto produce = [&](int st) {
    if (pk < ncand) {
      const int r0 = RU * pu + g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int dr = 8 * (i >> 1) + (MT == 2 ? 16 * (i & 1) : 0);
        const long long half =
            (long long)ps * STEP_BYTES + (MT == 2 ? 0 : 64 * (i & 1));
        if (MT == 2 || half < rbytes) {
          const bool in = half + 16 * t < rbytes && r0 + dr < pc.n;
          cp_async16(ring + (st * 4 + i) * 32,
                     in ? src + dr * rbytes + (half - ps * STEP_BYTES)
                        : pc.tile,
                     in ? 16 : 0);
        }
      }
      src += STEP_BYTES;
      if (++ps == ns) {
        ps = 0;
        src += tile_step;
        if (RU * ++pu >= pc.n) {
          pu = 0;
          next_cand();
        }
      }
    }
    cp_async_commit();
  };

  // prologue: the first candidate's scales load while the block stages the
  // query, bf16-rounded, as B fragments (rows past tq and dims past dq 0);
  // then the first units go in flight
  prefetch(cand_id(0));
  const int groups = ksl * 4;
#pragma unroll 8
  for (int i = threadIdx.x; i < W_TQ_MAX * groups; i += W_THREADS) {
    const int n = i / groups, gi = i - n * groups;
    int tt, d0;
    const int ks = group_slot<DT>(gi, tt, d0);
    const uint2 v =
        n < tq && d0 < dq
            ? b_group<DT>(q + ((long long)qi * tq + n) * dq + d0, gi)
            : make_uint2(0u, 0u);
    frag[((n >> 3) * ksl + ks) * 32 + (n & 7) * 4 + tt] = v;
  }
  next_cand();
#pragma unroll
  for (int i = 0; i < W_STAGES - 1; ++i) produce(i);
  __syncthreads();
  if (ncand == 0) return;

  uint32_t breg[W_NT][KSR > 0 ? KSR : 1][2];
  if constexpr (KSR > 0) {
#pragma unroll
    for (int nt = 0; nt < W_NT; ++nt)
#pragma unroll
      for (int ks = 0; ks < KSR; ++ks) {
        const uint2 b = frag[(nt * KSR + ks) * 32 + lane];
        breg[nt][ks][0] = b.x;
        breg[nt][ks][1] = b.y;
      }
  }
  float acc[W_NT][4], m[W_NT][2];
#pragma unroll
  for (int nt = 0; nt < W_NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
    m[nt][0] = m[nt][1] = NEG;
  }
  // acc += slices [0, rmax) of step cs of the pieces p (skipping the
  // second pieces of a last step of <= 64 bytes: past the row)
  const uint32_t magic = opaque(0x43004300u);
  auto slices = [&](const uint4 (&p)[4], int cs, int rmax) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r >= rmax ||
          (r >= KPS / 2 && (long long)cs * STEP_BYTES + 64 >= rbytes))
        continue;
      uint32_t a0, a1, a2, a3;
      a_slice<DT>(p, r, a0, a1, a2, a3, magic);
#pragma unroll
      for (int nt = 0; nt < W_NT; ++nt) {
        if constexpr (KSR > 0) {
          // slice cs * KPS + r, picked among the steps' registers
          uint32_t b0 = breg[nt][r][0], b1 = breg[nt][r][1];
#pragma unroll
          for (int s2 = 1; s2 * KPS + r < KSR; ++s2)
            if (cs == s2) {
              b0 = breg[nt][s2 * KPS + r][0];
              b1 = breg[nt][s2 * KPS + r][1];
            }
          mma_bf16(acc[nt], a0, a1, a2, a3, b0, b1);
        } else {
          const uint2 b = frag[(nt * ksl + cs * KPS + r) * 32 + lane];
          mma_bf16(acc[nt], a0, a1, a2, a3, b.x, b.y);
        }
      }
    }
  };
  // rows g and g + 8 of a 16-row tile, scales sa and sb: scale, mask,
  // running max, acc cleared (a valid row: acc * s + 0, rounded once, as
  // the product alone; a masked one: acc * 0 - 3e38 = -3e38 exactly, acc
  // being finite)
  auto fold = [&](float sa, float sb) {
    const float xa = sa > 0.0f ? sa : 0.0f, ya = sa > 0.0f ? 0.0f : NEG;
    const float xb = sb > 0.0f ? sb : 0.0f, yb = sb > 0.0f ? 0.0f : NEG;
#pragma unroll
    for (int nt = 0; nt < W_NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float va = __fmaf_rn(acc[nt][j], xa, ya);
        const float vb = __fmaf_rn(acc[nt][2 + j], xb, yb);
        m[nt][j] = fmaxf(m[nt][j], fmaxf(va, vb));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
    }
  };
  // candidate k's board value: the max over the 8 row groups; lane t sums
  // its tokens 8 nt + 2 t + j (< tq) in order, then a butterfly over t;
  // the running maxima start again
  auto emit = [&](int k) {
    float total = 0.0f;
#pragma unroll
    for (int nt = 0; nt < W_NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = m[nt][j];
        v = fmaxf(v, __shfl_xor_sync(FULL, v, 4));
        v = fmaxf(v, __shfl_xor_sync(FULL, v, 8));
        v = fmaxf(v, __shfl_xor_sync(FULL, v, 16));
        if (8 * nt + 2 * t + j < tq) total = __fadd_rn(total, v);
        m[nt][j] = NEG;
      }
    total = __fadd_rn(total, __shfl_xor_sync(FULL, total, 1));
    total = __fadd_rn(total, __shfl_xor_sync(FULL, total, 2));
    if (lane == 0) qout[W_WARPS * k] = total;
  };
  // consumer: candidate ck (span cn, scales csc), unit (cu, cs); the
  // candidates without rows sum their sentinels as they are passed
  int ck = 0, cu = 0, cs = 0, cn = 0;
  const float* csc = scales;
  auto to_rows = [&]() {
    while (ck < ncand && (cn = spans[ck]) == 0) emit(ck++);
    if (ck < ncand) csc = scale_row(cand_id(ck));
  };
  to_rows();
  float sc4[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // the unit's rows' scales
  for (int st = 0; ck < ncand; st = st + 1 == W_STAGES ? 0 : st + 1) {
    produce(st == 0 ? W_STAGES - 1 : st - 1);
    cp_async_wait<W_STAGES - 1>();
    uint4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = ring[(st * 4 + i) * 32];
    if (cs == 0) {
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i) {
        const int row = RU * cu + g + 8 * i;
        sc4[i] = row < cn ? __ldg(csc + row) : 0.0f;
      }
    }
    if constexpr (MT == 2) {
      slices(p, 0, KPS / 2);
      fold(sc4[0], sc4[1]);
      if (RU * cu + 16 < cn) {           // the second tile holds rows
        const uint4 hi[4] = {p[1], p[1], p[3], p[3]};
        slices(hi, 0, KPS / 2);
        fold(sc4[2], sc4[3]);
      }
    } else {
      slices(p, cs, RMAX);
      if (cs + 1 == ns) fold(sc4[0], sc4[1]);
    }
    if (++cs < ns) continue;
    cs = 0;
    if (RU * ++cu < cn) continue;
    cu = 0;
    emit(ck++);
    to_rows();
  }
  cp_async_wait<0>();
}

template <int DT>
cudaError_t launch_warp(const void* ids, const void* q, const void* toks,
                        const void* scales, void* out, int nq, int nw, int tq,
                        int n_pad, int cap, int w, int cpb, size_t smem,
                        cudaStream_t s) {
  // 128 dims: the fragments in registers (int4: 64-byte rows, paired)
  auto kernel = (DT == DT_INT4 ? 2 * w : w) == 128
                    ? maxsim_warp_kernel<DT, W_D128_SLICES,
                                         DT == DT_INT4 ? 2 : 1>
                : warp_row_bytes(w, DT) <= 64 ? maxsim_warp_kernel<DT, 0, 2>
                                              : maxsim_warp_kernel<DT, 0, 1>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((nw + cpb - 1) / cpb), (unsigned)nq);
  kernel<<<grid, W_THREADS, smem, s>>>(
      static_cast<const int32_t*>(ids), static_cast<const float*>(q),
      static_cast<const uint8_t*>(toks), static_cast<const float*>(scales),
      static_cast<float*>(out), nw, tq, n_pad, cap, w, cpb);
  return cudaGetLastError();
}

enum { VARIANT_WMMA = 0, VARIANT_WARP = 1 };

// Both entries: rejects a plan that does not cover the shape (a variant
// that cannot take it, candidates a block out of range, or shared memory
// other than the variant's own), then launches.
int entry(const void* ids, const void* q, const void* toks,
          const void* scales, void* out, int nq, int nw, int tq, int n_pad,
          int cap, int w, int dt, int variant, int cpb, long long smem,
          void* stream) {
  if (nq <= 0 || nq > 65535 || nw <= 0 || tq <= 0 || n_pad <= 0 ||
      cap <= 0 || w <= 0 || w % 16 || cpb < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == VARIANT_WARP) {
    if (dt == DT_F32 || tq > W_TQ_MAX || cpb > W_WARPS * W_MAX_CPW ||
        warp_frag_bytes(w, dt) > (size_t)W_MAX_FRAG ||
        smem != (long long)warp_smem(w, dt))
      return cudaErrorInvalidValue;
    auto launch = dt == DT_BF16   ? &launch_warp<DT_BF16>
                  : dt == DT_INT8 ? &launch_warp<DT_INT8>
                                  : &launch_warp<DT_INT4>;
    return launch(ids, q, toks, scales, out, nq, nw, tq, n_pad, cap, w, cpb,
                  (size_t)smem, s);
  }
  int qg, ks;
  bool slabs;
  if (variant != VARIANT_WMMA ||
      smem != (long long)wmma_shape(dt, tq, w, qg, ks, slabs))
    return cudaErrorInvalidValue;
  auto launch = dt == DT_F32    ? &launch_wmma<DT_F32>
                : dt == DT_BF16 ? &launch_wmma<DT_BF16>
                : dt == DT_INT8 ? &launch_wmma<DT_INT8>
                                : &launch_wmma<DT_INT4>;
  return launch(ids, q, toks, scales, out, nq, nw, tq, n_pad, cap, w, cpb, s);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32, 1 = bf16, 2 = int8 token tiles [n_pad, cap, w]; q:
// [nq, tq, w] f32. variant: 0 = wmma, 1 = warp; cpb candidates a block and
// smem the block's shared memory, as ops/maxsim.py::launch_plan gives them.
int maxsim_dense(const void* ids, const void* q, const void* toks,
                 const void* scales, void* out, int nq, int nw, int tq,
                 int n_pad, int cap, int w, int dtype, int variant, int cpb,
                 long long smem, void* stream) {
  if (dtype != DT_F32 && dtype != DT_BF16 && dtype != DT_INT8)
    return cudaErrorInvalidValue;
  return entry(ids, q, toks, scales, out, nq, nw, tq, n_pad, cap, w, dtype,
               variant, cpb, smem, stream);
}

// Packed-nibble tiles [n_pad, cap, w] uint8; q: [nq, tq, 2w] f32 (the wmma
// kernel splits it into its even and odd planes, the warp kernel takes it
// as it is). The rest as maxsim_dense.
int maxsim_int4(const void* ids, const void* q, const void* toks,
                const void* scales, void* out, int nq, int nw, int tq,
                int n_pad, int cap, int w, int variant, int cpb,
                long long smem, void* stream) {
  return entry(ids, q, toks, scales, out, nq, nw, tq, n_pad, cap, w, DT_INT4,
               variant, cpb, smem, stream);
}

}  // extern "C"
