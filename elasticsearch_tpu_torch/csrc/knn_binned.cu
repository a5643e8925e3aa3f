// Binned-reduction kNN kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of elasticsearch_tpu/ops/pallas_knn_binned.py:
//   knn_binned_bf16 <- _make_kernel (_KERNEL_COSINE / _KERNEL_CLAMPED)
//   knn_binned_int8 <- _int8_kernel
// both launched there by _binned_packed.
//
// What they compute. For each 8192-row corpus tile and each query row q:
//   S[q, j] = Q[q] . C[tile_base + j]        (j in 0..8191)
//   bf16:  s = (clamp(S, -3, 3) or S for cosine + 4) * valid[row]
//   int8:  s = clip(f32(S) * qscale[q] * rsv[row]
//                   + 4 * min(rsv[row] * 1e30, 1), 0, 7)
//   p = (bits(s) & ~63) | (j / 128);   out[q, tile*128 + j%128] = max_t p
// Column j goes to output lane j % 128 with chunk index t = j / 128, so one
// chunk is a contiguous 128-row slab whose rows map one to one onto the 128
// output lanes. The loop over chunks inside a block takes the place of the
// TPU's 64-deep maximum chain.
//
// What bounds them on the H100: bytes, at every served shape. The corpus is
// read once: 1,048,576 x 128 bf16 is 268 MB, 0.080 ms at 3.35 TB/s (0.0864
// ms with the Q=256 output; its 68.7 GFLOP take 0.069 ms at 989 TFLOP/s);
// 1,048,576 x 768 int8 is 805 MB, 0.240 ms (0.2467 ms at Q=256; 412 GOP,
// 0.208 ms at 1979 TOP/s); the hybrid knn leg, 131,072 x 768 bf16 at Q=1,
// 0.060 ms. Only the packed maxima, 1/64 of the scores, are written.
//
// Two variants; the caller's launch plan (ops/knn_binned.py::launch_plan)
// picks one from the shape and passes it in with its grid:
//
// tma   rows whose byte width is a multiple of 16 (every served width). A
//       block owns up to 128 query rows (QN, the wgmma N), one corpus tile
//       and a range of 64/S of its chunks; grid (query groups, tiles, S).
//       S is chosen so that small batches and small corpora still give
//       ~2 blocks per SM; with S > 1 the S blocks of a tile combine with
//       atomicMax into an output filled with INT32_MIN just before (exact:
//       a max of int32 does not depend on order). One producer warp streams
//       the corpus with TMA, each chunk as K-slabs of 128 rows x 128 bytes
//       (128-byte swizzle, as wgmma reads it), through a ring of STAGES
//       slots with full/empty mbarriers; the chunk's 128 per-row weights
//       (validity, or row scale x validity for int8) ride the first slab's
//       barrier. The query group is loaded once per block when all of its
//       slabs fit in shared memory, else streamed beside each corpus slab
//       (from L2). Two consumer warpgroups run wgmma with the corpus rows on
//       M (each takes 64 of the chunk's 128 rows) and the query group on N
//       (rounded up to 8): at Q=1 no tensor work is spent on absent query
//       rows, and every chunk puts the same (lane, query) pair in the same
//       accumulator register, so the running packed maximum lives in
//       registers beside it. The epilogue runs there: no staging buffer and
//       no barrier per chunk; the two warpgroups share the tensor cores, so
//       one's epilogue runs under the other's wgmma.
// wmma  rows whose byte width is not a multiple of 16 (TMA needs 16-byte
//       strides; D = 100 in tests/test_torch_gpu.py). A block owns 64 query
//       rows and one tile and loads 128-byte K-slabs synchronously for WMMA,
//       staging each chunk's scores in shared memory.
//
// The tensor map of the corpus (and of the queries) is encoded on the host
// with cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so
// the library needs no -lcuda, and cached by (device, pointer, shape, box):
// a map stays valid for any tensor at that address and shape.
//
// Bit-exactness. The int8 products are exact int32; the dequant is written
// with __fmul_rn / __fadd_rn in the reference's order so nvcc contracts
// nothing into an FMA, which makes the int8 kernel bit-identical to the
// plain PyTorch version. The bf16 f32 accumulation order differs from
// cuBLAS and XLA, so the bf16 kernel agrees within one packing quantum.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <mutex>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BLOCK_N = 8192;
constexpr int BINS = 128;          // output lanes per tile == rows per chunk
constexpr int CHUNKS = BLOCK_N / BINS;  // 64
constexpr int SLAB_BYTES = 128;    // bytes of one row per K-slab
constexpr int32_t kMinPacked = -2147483647 - 1;  // below every packed value

// ------------------------------------------------------------- wmma variant

constexpr int QB = 64;             // query rows per block
constexpr int WMMA_THREADS = 256;  // 8 warps
constexpr int SLD = BINS + 4;      // score staging row stride (elements)
constexpr int ROWS_PER_THREAD = QB * BINS / WMMA_THREADS;  // 32
constexpr int WMMA_SMEM_BYTES =
    QB * SLAB_BYTES + BINS * SLAB_BYTES + QB * SLD * 4;

// Copy rows [row0, row0 + nrows) x elements [k0, k0 + KT) of a row-major
// [rows_total, d] matrix of E-byte elements into shared memory laid out
// k-slab major: [KT/16][nrows][16]. Each 16-element sub-slab of a row is
// contiguous, so a 16x16 WMMA fragment is one contiguous, aligned run
// (ldm 16). Out-of-range rows and the ragged K edge read as zero.
template <int E>
__device__ __forceinline__ void load_slab(uint8_t* smem, const uint8_t* g,
                                          long long row0, int nrows,
                                          long long rows_total, int d,
                                          int k0, bool vec_ok) {
  constexpr int KT = SLAB_BYTES / E;   // elements per slab row
  constexpr int VE = 16 / E;           // elements per 16-byte vector
  constexpr int VPR = KT / VE;         // vectors per slab row
  for (int v = threadIdx.x; v < nrows * VPR; v += WMMA_THREADS) {
    const int r = v / VPR;
    const int kv = (v % VPR) * VE;
    const int k = k0 + kv;
    const long long row = row0 + r;
    uint8_t* dst = smem + ((long long)((kv / 16) * nrows + r) * 16 + (kv % 16)) * E;
    const uint8_t* src = g + (row * d + k) * E;
    if (vec_ok && row < rows_total && k + VE <= d) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < VE; ++e) {
        const bool in = row < rows_total && k + e < d;
        for (int b = 0; b < E; ++b) dst[e * E + b] = in ? src[e * E + b] : 0;
      }
    }
  }
}

// One chunk's [QB x BINS] score slab, accumulated over all K slabs into the
// warp's fragments and stored to the staging buffer `sS` (row stride SLD).
// Warp w owns rows 16*(w/2) .. +16 and columns 64*(w%2) .. +64.
template <typename In, typename Acc, int E>
__device__ __forceinline__ void chunk_scores(uint8_t* sQ, uint8_t* sC, Acc* sS,
                                             const uint8_t* q, const uint8_t* c,
                                             int nq, long long q0,
                                             long long chunk_row0,
                                             long long n_pad, int d,
                                             bool vec_ok) {
  constexpr int KT = SLAB_BYTES / E;
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 16;
  const int wc = (warp % 2) * 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[4];
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], (Acc)0);
  for (int k0 = 0; k0 < d; k0 += KT) {
    __syncthreads();  // previous slab (and staging reads) finished
    load_slab<E>(sQ, q, q0, QB, nq, d, k0, vec_ok);
    load_slab<E>(sC, c, chunk_row0, BINS, n_pad, d, k0, vec_ok);
    __syncthreads();
    const In* aQ = reinterpret_cast<const In*>(sQ);
    const In* aC = reinterpret_cast<const In*>(sC);
    for (int kk = 0; kk < KT / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, In, wmma::row_major> a;
      wmma::load_matrix_sync(a, aQ + (kk * QB + wr) * 16, 16);
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, In, wmma::col_major> b;
        wmma::load_matrix_sync(b, aC + (kk * BINS + wc + j * 16) * 16, 16);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(sS + wr * SLD + wc + j * 16, acc[j], SLD,
                            wmma::mem_row_major);
  __syncthreads();
}

template <bool CLAMP>
__global__ void __launch_bounds__(WMMA_THREADS)
knn_binned_bf16_wmma(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ c,
                       const float* __restrict__ valid,
                       int32_t* __restrict__ out, int nq, long long n_pad,
                       int d) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sQ = smem;
  uint8_t* sC = sQ + QB * SLAB_BYTES;
  float* sS = reinterpret_cast<float*>(sC + BINS * SLAB_BYTES);
  const long long q0 = (long long)blockIdx.x * QB;
  const long long tile = blockIdx.y;
  const int lane = threadIdx.x % BINS;
  const int rbase = threadIdx.x / BINS;
  const bool vec_ok = (d % 8) == 0;
  int32_t best[ROWS_PER_THREAD];
  for (int r = 0; r < ROWS_PER_THREAD; ++r) best[r] = kMinPacked;

  for (int t = 0; t < CHUNKS; ++t) {
    const long long row0 = tile * BLOCK_N + (long long)t * BINS;
    chunk_scores<__nv_bfloat16, float, 2>(
        sQ, sC, sS, reinterpret_cast<const uint8_t*>(q),
        reinterpret_cast<const uint8_t*>(c), nq, q0, row0, n_pad, d, vec_ok);
    const float v = valid[row0 + lane];
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
      float s = sS[(rbase + 2 * r) * SLD + lane];
      if (CLAMP) s = fminf(fmaxf(s, -3.0f), 3.0f);
      s = __fmul_rn(__fadd_rn(s, 4.0f), v);
      const int32_t p = (__float_as_int(s) & ~63) | t;
      best[r] = max(best[r], p);
    }
  }
  const long long ncols = n_pad / 64;
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const long long qr = q0 + rbase + 2 * r;
    if (qr < nq) out[qr * ncols + tile * BINS + lane] = best[r];
  }
}

__global__ void __launch_bounds__(WMMA_THREADS)
knn_binned_int8_wmma(const int8_t* __restrict__ q,
                       const int8_t* __restrict__ c,
                       const float* __restrict__ qscale,
                       const float* __restrict__ rsv,
                       int32_t* __restrict__ out, int nq, long long n_pad,
                       int d) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sQ = smem;
  uint8_t* sC = sQ + QB * SLAB_BYTES;
  int* sS = reinterpret_cast<int*>(sC + BINS * SLAB_BYTES);
  const long long q0 = (long long)blockIdx.x * QB;
  const long long tile = blockIdx.y;
  const int lane = threadIdx.x % BINS;
  const int rbase = threadIdx.x / BINS;
  const bool vec_ok = (d % 16) == 0;
  int32_t best[ROWS_PER_THREAD];
  float qs[ROWS_PER_THREAD];
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const long long qr = q0 + rbase + 2 * r;
    best[r] = kMinPacked;
    qs[r] = qr < nq ? qscale[qr] : 0.0f;
  }

  for (int t = 0; t < CHUNKS; ++t) {
    const long long row0 = tile * BLOCK_N + (long long)t * BINS;
    chunk_scores<signed char, int, 1>(
        sQ, sC, sS, reinterpret_cast<const uint8_t*>(q),
        reinterpret_cast<const uint8_t*>(c), nq, q0, row0, n_pad, d, vec_ok);
    const float vs = rsv[row0 + lane];
    const float shift = __fmul_rn(4.0f, fminf(__fmul_rn(vs, 1e30f), 1.0f));
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
      const int dot = sS[(rbase + 2 * r) * SLD + lane];
      float s = __fmul_rn(__int2float_rn(dot), qs[r]);
      s = __fadd_rn(__fmul_rn(s, vs), shift);
      s = fminf(fmaxf(s, 0.0f), 7.0f);
      const int32_t p = (__float_as_int(s) & ~63) | t;
      best[r] = max(best[r], p);
    }
  }
  const long long ncols = n_pad / 64;
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const long long qr = q0 + rbase + 2 * r;
    if (qr < nq) out[qr * ncols + tile * BINS + lane] = best[r];
  }
}

dim3 wmma_grid(int nq, long long n_pad) {
  // x = query block (fastest), so the query blocks of one corpus tile are
  // scheduled together and share the tile's reads through L2
  return dim3((unsigned)((nq + QB - 1) / QB), (unsigned)(n_pad / BLOCK_N));
}

bool shapes_ok(int nq, long long n_pad, int d) {
  return nq > 0 && d > 0 && n_pad > 0 && n_pad % BLOCK_N == 0 &&
         n_pad / BLOCK_N <= 65535;
}

// -------------------------------------------------------------- tma variant

constexpr int STAGES = 4;                     // corpus slabs in flight
constexpr int STAGE_BYTES = BINS * SLAB_BYTES;  // 16 KiB: one chunk's K-slab
constexpr int TMA_THREADS = 288;  // consumer warpgroups 0-1, producer warp 8
constexpr int CONSUMER_WARPS = 8;
constexpr int MAX_QN = 128;
constexpr int MAX_SMEM = 232448;  // 227 KB, the most a block may ask for

// Shared memory of one block; ops/knn_binned.py::_tma_smem_bytes mirrors it.
// 1024 bytes of slack align the swizzled slabs to the 1024-byte atom.
size_t tma_smem_bytes(int qn, int ks, bool staged) {
  return 1024 + (size_t)STAGES * STAGE_BYTES +
         (size_t)(staged ? ks : STAGES) * qn * SLAB_BYTES +
         (size_t)STAGES * BINS * 4 + (size_t)qn * 4 + (2 * STAGES + 1) * 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// ~10 s (2^34 cycles) can only be a lost arrival: trap, so the launch fails
// with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > (1LL << 34))
      __trap();
  }
}

// One 2-D TMA box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16) completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma descriptor of a K-major operand in 128-byte swizzle: rows of 128
// bytes, 8-row atoms 1024 bytes apart. Adding 32 bytes to the address steps
// one k-group (16 bf16 or 32 int8) along K inside the swizzled row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from reading an accumulator before the wait.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// D[64 x N] (+)= A[64 x 16|32] . B[N x 16|32]^T, both K-major in shared
// memory; `acc` = 0 overwrites D. Thread layout of D (PTX ISA, wgmma
// m64nNk*): warp w of the warpgroup, lane l hold rows 16w + l/4 (+8) and
// columns 8j + 2(l%4) (+1) in registers 4j + {0, 1 | 2, 3}.
template <int N> struct WgmmaBf16;
template <int N> struct WgmmaInt8;

template <> struct WgmmaBf16<8> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <> struct WgmmaBf16<16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <> struct WgmmaBf16<32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <> struct WgmmaBf16<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <> struct WgmmaBf16<128> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <> struct WgmmaInt8<8> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <> struct WgmmaInt8<16> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <> struct WgmmaInt8<32> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <> struct WgmmaInt8<64> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <> struct WgmmaInt8<128> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a,
                                              uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
};

enum Mode { COSINE = 0, CLAMPED = 1, INT8 = 2 };

// A block: query group blockIdx.x (QN rows), tile blockIdx.y, chunk range
// blockIdx.z of `split`. `ks` K-slabs a row; `staged`: the whole query
// group sits in shared memory, loaded once, else each stage carries its
// query slab too.
template <int MODE, int QN>
__global__ void __launch_bounds__(TMA_THREADS,
                                  QN >= 128 ? 1 : (QN >= 64 ? 2 : 3))
knn_binned_tma(const __grid_constant__ CUtensorMap tm_c,
               const __grid_constant__ CUtensorMap tm_q,
               const float* __restrict__ weight,
               const float* __restrict__ qscale, int32_t* __restrict__ out,
               int nq, long long n_pad, int ks, int split, int staged) {
  using Acc = typename std::conditional<MODE == INT8, int, float>::type;
  using Mma = typename std::conditional<MODE == INT8, WgmmaInt8<QN>,
                                        WgmmaBf16<QN>>::type;
  constexpr int ELEMS = MODE == INT8 ? SLAB_BYTES : SLAB_BYTES / 2;
  constexpr int R = QN / 2;              // accumulator registers a thread
  constexpr int QSLAB = QN * SLAB_BYTES;  // one K-slab of the query group

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sC = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = sC + STAGES * STAGE_BYTES;
  float* sW = reinterpret_cast<float*>(sQ + (staged ? ks : STAGES) * QSLAB);
  float* sQS = sW + STAGES * BINS;
  uint64_t* full = reinterpret_cast<uint64_t*>(sQS + QN);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int tid = threadIdx.x;
  const int group = blockIdx.x;
  const long long tile = blockIdx.y;
  const int per = CHUNKS / split;
  const int t0 = blockIdx.z * per;

  if (MODE == INT8)
    for (int i = tid; i < QN; i += TMA_THREADS) {
      const int qr = group * QN + i;
      sQS[i] = qr < nq ? qscale[qr] : 0.0f;
    }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMER_WARPS * 32) {
    // ---- producer: one thread keeps STAGES slabs in flight
    if (tid != CONSUMER_WARPS * 32) return;
    const int qrow = group * QN;
    if (staged) {
      mbar_expect_tx(qbar, ks * QSLAB);
      for (int s = 0; s < ks; ++s)
        tma_load(sQ + s * QSLAB, &tm_q, s * ELEMS, qrow, qbar);
    }
    int it = 0;
    for (int i = 0; i < per; ++i) {
      const int row0 = (int)(tile * BLOCK_N) + (t0 + i) * BINS;
      for (int s = 0; s < ks; ++s, ++it) {
        const int st = it % STAGES;
        mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], STAGE_BYTES + (s == 0 ? BINS * 4 : 0) +
                                      (staged ? 0 : QSLAB));
        tma_load(sC + st * STAGE_BYTES, &tm_c, s * ELEMS, row0, &full[st]);
        if (s == 0) bulk_load(sW + st * BINS, weight + row0, BINS * 4, &full[st]);
        if (!staged) tma_load(sQ + st * QSLAB, &tm_q, s * ELEMS, qrow, &full[st]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg scores rows wg*64 .. +63 of every chunk
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int lrow = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;  // +8 for h=1
  const int qcol = 2 * (lane % 4);                                 // +8j, +1
  Acc acc[R];
  int32_t best[R];
#pragma unroll
  for (int r = 0; r < R; ++r) best[r] = kMinPacked;
  if (staged) mbar_wait(qbar, 0);

  int it = 0;
  for (int i = 0; i < per; ++i) {
    float w[2] = {0.0f, 0.0f};
    for (int s = 0; s < ks; ++s, ++it) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      if (s == 0) {
        w[0] = sW[st * BINS + lrow];
        w[1] = sW[st * BINS + lrow + 8];
      }
      const uint32_t a = smem_u32(sC + st * STAGE_BYTES + wg * 64 * SLAB_BYTES);
      const uint32_t b = smem_u32(sQ + (staged ? s : st) * QSLAB);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        Mma::mma(acc, sw128_desc(a + 32 * k), sw128_desc(b + 32 * k),
                 s > 0 || k > 0);
      wgmma_commit();
      if (s > 0) {  // the previous slab's products are done: free its stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
#pragma unroll
    for (int r = 0; r < R; ++r) reg_fence(acc[r]);

    const int t = t0 + i;
    float shift[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      shift[h] = __fmul_rn(4.0f, fminf(__fmul_rn(w[h], 1e30f), 1.0f));
#pragma unroll
    for (int j = 0; j < QN / 8; ++j) {
      float2 qs = make_float2(0.0f, 0.0f);
      if (MODE == INT8) qs = *reinterpret_cast<const float2*>(sQS + 8 * j + qcol);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * j + 2 * h + e;
          float s;
          if (MODE == INT8) {
            s = __fmul_rn(__int2float_rn(acc[r]), e ? qs.y : qs.x);
            s = __fadd_rn(__fmul_rn(s, w[h]), shift[h]);
            s = fminf(fmaxf(s, 0.0f), 7.0f);
          } else {
            s = acc[r];
            if (MODE == CLAMPED) s = fminf(fmaxf(s, -3.0f), 3.0f);
            s = __fmul_rn(__fadd_rn(s, 4.0f), w[h]);
          }
          best[r] = max(best[r], (__float_as_int(s) & ~63) | t);
        }
    }
  }

  const long long ncols = n_pad / 64;
#pragma unroll
  for (int j = 0; j < QN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long qr = (long long)group * QN + 8 * j + qcol + e;
        if (qr >= nq) continue;
        int32_t* p = out + qr * ncols + tile * BINS + lrow + 8 * h;
        const int32_t v = best[4 * j + 2 * h + e];
        if (split > 1)
          atomicMax(p, v);
        else
          *p = v;
      }
}

// ------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

struct MapEntry {
  int device;
  const void* ptr;
  long long rows;
  int cols, elt, box_rows;
  CUtensorMap map;
};

// The tensor map of a row-major [rows, cols] matrix of `elt`-byte elements,
// boxes of 128 bytes x box_rows, 128-byte swizzle, zeros outside. Encoded
// once per (device, pointer, shape, box) and kept in a small ring.
cudaError_t tensor_map(CUtensorMap* map, int device, const void* ptr,
                       long long rows, int cols, int elt, int box_rows) {
  static std::mutex mu;
  static EncodeTiled encode = nullptr;
  static MapEntry ring[64];
  static int used = 0, next = 0;
  cudaError_t err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const MapEntry& e = ring[i];
    if (e.device == device && e.ptr == ptr && e.rows == rows &&
        e.cols == cols && e.elt == elt && e.box_rows == box_rows) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                           12000, cudaEnableDefault, &found);
#else
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                  cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elt};
  const cuuint32_t box[2] = {(cuuint32_t)(SLAB_BYTES / elt),
                             (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  MapEntry& e = ring[next];
  const CUresult r = encode(
      &e.map,
      elt == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    e.ptr = nullptr;  // leave no half-written entry that could match
    e.rows = -1;
    return cudaErrorInvalidValue;
  }
  e.device = device;
  e.ptr = ptr;
  e.rows = rows;
  e.cols = cols;
  e.elt = elt;
  e.box_rows = box_rows;
  *map = e.map;
  next = (next + 1) % 64;
  if (used < 64) ++used;
  return cudaSuccess;
}

struct Plan {
  int variant;  // 0 wmma, 1 tma
  int qn, groups, split, staged;
};

// The plan must cover the shape exactly: the kernel trusts it.
bool plan_ok(const Plan& p, int nq, int d, int elt) {
  const bool tma_shape = (d * elt) % 16 == 0;
  if (p.variant == 0)
    return !tma_shape && p.qn == QB && p.split == 1 &&
           p.groups == (nq + QB - 1) / QB;
  if (p.variant != 1 || !tma_shape) return false;
  if (p.qn != 8 && p.qn != 16 && p.qn != 32 && p.qn != 64 && p.qn != MAX_QN)
    return false;
  if (p.split < 1 || p.split > CHUNKS || CHUNKS % p.split != 0) return false;
  if (p.groups < 1 || (long long)p.groups * p.qn < nq ||
      (long long)(p.groups - 1) * p.qn >= nq)
    return false;
  const int ks = (d * elt + SLAB_BYTES - 1) / SLAB_BYTES;
  return tma_smem_bytes(p.qn, ks, p.staged != 0) <= MAX_SMEM;
}

// out[0, n) = INT32_MIN, n a multiple of 4, out 16-byte aligned: the start
// of the maxima that the S blocks of a split tile combine with atomicMax.
__global__ void fill_min(int4* out, long long n4) {
  const int4 v = make_int4(kMinPacked, kMinPacked, kMinPacked, kMinPacked);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = v;
}

template <int MODE, int QN>
cudaError_t launch_tma(const CUtensorMap& tm_c, const CUtensorMap& tm_q,
                       const float* weight, const float* qscale, int32_t* out,
                       int nq, long long n_pad, int ks, const Plan& p,
                       int device, cudaStream_t stream) {
  // the shared-memory ceiling is a per-device attribute: set it once each
  static std::atomic<unsigned long long> attr_set{0};
  const unsigned long long bit = 1ull << (device & 63);
  if (!(attr_set.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_binned_tma<MODE, QN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr_set.fetch_or(bit);
  }
  if (p.split > 1) {
    const long long n4 = (long long)nq * (n_pad / 64) / 4;
    fill_min<<<(unsigned)std::min<long long>((n4 + 255) / 256, 1024), 256, 0,
               stream>>>(reinterpret_cast<int4*>(out), n4);
  }
  const dim3 grid((unsigned)p.groups, (unsigned)(n_pad / BLOCK_N),
                  (unsigned)p.split);
  knn_binned_tma<MODE, QN><<<grid, TMA_THREADS,
                             tma_smem_bytes(QN, ks, p.staged != 0), stream>>>(
      tm_c, tm_q, weight, qscale, out, nq, n_pad, ks, p.split, p.staged);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t run_tma(const void* q, const void* c, const float* weight,
                    const float* qscale, int32_t* out, int nq,
                    long long n_pad, int d, const Plan& p,
                    cudaStream_t stream) {
  const int elt = MODE == INT8 ? 1 : 2;
  const int ks = (d * elt + SLAB_BYTES - 1) / SLAB_BYTES;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_c, tm_q;
  err = tensor_map(&tm_c, device, c, n_pad, d, elt, BINS);
  if (err != cudaSuccess) return err;
  err = tensor_map(&tm_q, device, q, nq, d, elt, p.qn);
  if (err != cudaSuccess) return err;
  switch (p.qn) {
    case 8:
      return launch_tma<MODE, 8>(tm_c, tm_q, weight, qscale, out, nq,
                                   n_pad, ks, p, device, stream);
    case 16:
      return launch_tma<MODE, 16>(tm_c, tm_q, weight, qscale, out, nq,
                                   n_pad, ks, p, device, stream);
    case 32:
      return launch_tma<MODE, 32>(tm_c, tm_q, weight, qscale, out, nq,
                                   n_pad, ks, p, device, stream);
    case 64:
      return launch_tma<MODE, 64>(tm_c, tm_q, weight, qscale, out, nq,
                                   n_pad, ks, p, device, stream);
    default:
      return launch_tma<MODE, 128>(tm_c, tm_q, weight, qscale, out, nq,
                                    n_pad, ks, p, device, stream);
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// `variant`, `qn`, `groups`, `split`, `staged`: the launch plan of
// ops/knn_binned.py::launch_plan. Returns a cudaError_t.
int knn_binned_bf16(const void* q, const void* c, const void* valid,
                    void* out, int nq, long long n_pad, int d, int clamp,
                    int variant, int qn, int groups, int split, int staged,
                    void* stream) {
  const Plan p{variant, qn, groups, split, staged};
  if (!shapes_ok(nq, n_pad, d) || !plan_ok(p, nq, d, 2))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const float* w = static_cast<const float*>(valid);
    int32_t* o = static_cast<int32_t*>(out);
    return clamp ? run_tma<CLAMPED>(q, c, w, nullptr, o, nq, n_pad, d, p, s)
                 : run_tma<COSINE>(q, c, w, nullptr, o, nq, n_pad, d, p, s);
  }
  cudaError_t err;
  if (clamp) {
    err = cudaFuncSetAttribute(knn_binned_bf16_wmma<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WMMA_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    knn_binned_bf16_wmma<true><<<wmma_grid(nq, n_pad), WMMA_THREADS,
                                 WMMA_SMEM_BYTES, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(c),
        static_cast<const float*>(valid), static_cast<int32_t*>(out), nq, n_pad, d);
  } else {
    err = cudaFuncSetAttribute(knn_binned_bf16_wmma<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WMMA_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    knn_binned_bf16_wmma<false><<<wmma_grid(nq, n_pad), WMMA_THREADS,
                                  WMMA_SMEM_BYTES, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(c),
        static_cast<const float*>(valid), static_cast<int32_t*>(out), nq, n_pad, d);
  }
  return cudaGetLastError();
}

int knn_binned_int8(const void* q8, const void* c8, const void* qscale,
                    const void* rsv, void* out, int nq, long long n_pad,
                    int d, int variant, int qn, int groups, int split,
                    int staged, void* stream) {
  const Plan p{variant, qn, groups, split, staged};
  if (!shapes_ok(nq, n_pad, d) || !plan_ok(p, nq, d, 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1)
    return run_tma<INT8>(q8, c8, static_cast<const float*>(rsv),
                         static_cast<const float*>(qscale),
                         static_cast<int32_t*>(out), nq, n_pad, d, p, s);
  cudaError_t err = cudaFuncSetAttribute(
      knn_binned_int8_wmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WMMA_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  knn_binned_int8_wmma<<<wmma_grid(nq, n_pad), WMMA_THREADS, WMMA_SMEM_BYTES,
                         s>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(c8),
      static_cast<const float*>(qscale), static_cast<const float*>(rsv),
      static_cast<int32_t*>(out), nq, n_pad, d);
  return cudaGetLastError();
}

}  // extern "C"
