// Fused gather + score of IVF probes for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of elasticsearch_tpu/ops/pallas_ivf_fused.py:
//   ivf_fused_dense <- _dense_kernel   (f32 / bf16 / int8 partition tiles)
//   ivf_fused_int4  <- _int4_kernel    (packed-nibble int4 tiles)
// both launched there by _fused_probe_board.
//
// What they compute. For query q, probe slot j and partition p = ids[q, j],
// over the cap rows r of that partition's tile:
//   dense: s = sum_d bf16(q[q, d]) * bf16(parts[p, r, d])       (f32 sum)
//   int4:  s = sum_w bf16(qe[q, w]) * lo(parts[p, r, w])
//            + sum_w bf16(qo[q, w]) * hi(parts[p, r, w])         (two f32 sums)
//          lo = (x & 0xF) - 8, hi = (x >> 4) - 8
//   board[q, j, r] = scale[p, r] > 0 ? s * scale[p, r] : -3e38
// The query is rounded to bf16, and f32 tiles are rounded to bf16 inside
// the kernel, as the TPU kernel's `astype(bfloat16)` does; int8 and int4
// levels are exact in bf16. Each bf16 x bf16 product is exact in f32, so
// only the order of the f32 sum differs from the plain version. A probe id
// outside [0, nlist) reads nothing and gets -3e38 across its board row.
//
// What bounds them on the H100: bytes. The least bytes are each distinct
// probed tile read once, plus the board written once. At Q = 256, nprobe
// 32 over 1024 partitions with random probes, ~1023 of the 1024 tiles are
// probed, each by ~8 (query, probe) entries: 2.9 GB of distinct bf16 tiles
// (0.880 ms at 3.35 TB/s), against ~23 GB if every entry reads its tile.
// Even 8 queries a tile are only ~8 operations a byte (int4: ~32, two
// values a byte; 0.58 GB of distinct tiles at D = 768), far below the ~295
// where the tensor cores would set the limit.
//
// Both kernels have two variants; the caller's launch plan
// (ops/ivf_fused.py::launch_plan) picks one and passes it in:
//
// grouped  bf16, int8 and int4 tiles whose row bytes are a multiple of 16
//       (every served layout). The loop is inverted: each probed tile is
//       read once for all the entries (q, j) that probe it. A probe plan
//       groups the entries by partition, on the device and with no host
//       sync: one block counting-sorts them (histogram, scan, scatter in
//       shared memory) into `entries`, and cuts each partition's run into
//       items (p, first, count <= N_MAX). The host sizes the grid by the
//       bound min(nlist, n) + n / N_MAX on the number of items; a block past
//       n_items exits at once. A single query (Q = 1) needs no plan: each
//       entry is its own item (the router's probes of one query are
//       distinct partitions), and the board kernel is the only launch.
//       Grid: (item, row span of span_chunks chunks of 128 rows). A block
//       stages its item's queries once in shared memory, bf16-rounded, in
//       the order of the mma B fragments; each of its 8 warps owns 16 rows
//       of a chunk and streams them straight into A-fragment registers,
//       16 bytes a lane (two pieces a row a 128-byte step, one step ahead),
//       then runs mma.sync.m16n8k16 (bf16 in, f32 accumulate) against each
//       8-query column tile. The K order inside a step is permuted so that
//       a lane's 16-byte piece is exactly its fragment: the same permutation
//       on A and B leaves every dot product unchanged. bf16 rows are their
//       own fragments; int8 rows widen to bf16 exactly with a byte permute
//       and one f32 add a value; int4 rows with one lop3 and one bf16x2
//       subtract per two values (K order: csrc/mma_frag.cuh and, for
//       int4, `int4_k_order` in ops/ivf_fused.py). The epilogue scales,
//       masks and stores each (row, entry) straight to its board slot
//       (32-byte runs).
//       Registers are capped at 80 so 3 blocks (24 warps) share an SM,
//       which keeps ~100 KB of row loads in flight an SM (int4 ran 7%
//       slower at 2 blocks, 101 registers); at Q = 1 the
//       direct grid (nprobe x 12 spans of one chunk) then runs in one wave.
// simt  f32 tiles and rows whose byte width is not a multiple of 16 (and
//       layouts whose query fragments, or whose plan histogram, would not
//       fit in shared memory): the first port's kernels, unchanged. Grid:
//       x = a chunk of 64 rows of the tile, y = probe slot, z = query;
//       each warp walks rows, the lanes reading 16-byte vectors (scalar
//       loads for ragged rows) against the staged query, with a
//       warp-shuffle reduction. It reads a tile once per (query, probe)
//       that names it. The int4 one takes the even and odd query planes,
//       staged transposed so the 32 lanes of a warp read 32 consecutive
//       words of shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "mma_frag.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_BLOCK = 64;
constexpr int UNROLL = 4;            // 16-byte vectors in flight per lane
constexpr float NEG = -3.0e38f;      // the NEG_INF sentinel of the board

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the two bf16 values of one little-endian 32-bit word, widened exactly
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc += <one 16-byte vector of tile elements, the matching query values>;
// query value i of this vector sits at qv[i * stride] (the transposed
// staging)
template <int DT>
__device__ __forceinline__ float dot_vec(uint4 v, const float* qv, int stride,
                                         float acc) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (DT == DT_F32) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc = fmaf(qv[i * stride], bf16_round(__uint_as_float(w[i])), acc);
  } else if constexpr (DT == DT_BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = fmaf(qv[(2 * i) * stride], bf16_lo(w[i]), acc);
      acc = fmaf(qv[(2 * i + 1) * stride], bf16_hi(w[i]), acc);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        acc = fmaf(qv[(4 * i + b) * stride], int8_at(w[i], b), acc);
  }
  return acc;
}

// one tile element, widened (the scalar path)
template <int DT>
__device__ __forceinline__ float elem(const uint8_t* row, int t) {
  if constexpr (DT == DT_F32) {
    return bf16_round(__ldg(reinterpret_cast<const float*>(row) + t));
  } else if constexpr (DT == DT_BF16) {
    const uint32_t bits = __ldg(reinterpret_cast<const unsigned short*>(row) + t);
    return __uint_as_float(bits << 16);
  } else {
    return static_cast<float>(__ldg(reinterpret_cast<const signed char*>(row) + t));
  }
}

template <int DT>
__global__ void __launch_bounds__(THREADS) ivf_dense_kernel(
    const float* __restrict__ q, const int32_t* __restrict__ probe_ids,
    const uint8_t* __restrict__ parts, const float* __restrict__ scales,
    float* __restrict__ out, int nprobe, int nlist, int cap, int d,
    int vec_ok) {
  constexpr int E = DT == DT_F32 ? 4 : (DT == DT_BF16 ? 2 : 1);
  constexpr int VE = 16 / E;                  // elements per 16-byte vector
  // the bf16-rounded query: [VE][nv] on the vector path, [d] otherwise
  extern __shared__ float qs[];
  const int nv = d / VE;
  const int qi = blockIdx.z, j = blockIdx.y;
  const int pid = probe_ids[(long long)qi * nprobe + j];
  for (int t = threadIdx.x; t < d; t += THREADS)
    qs[vec_ok ? (t % VE) * nv + t / VE : t] =
        bf16_round(q[(long long)qi * d + t]);
  __syncthreads();
  float* orow = out + ((long long)qi * nprobe + j) * cap;
  const int r0 = blockIdx.x * ROWS_PER_BLOCK;
  const int r1 = min(r0 + ROWS_PER_BLOCK, cap);
  if (pid < 0 || pid >= nlist) {
    for (int r = r0 + threadIdx.x; r < r1; r += THREADS) orow[r] = NEG;
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row_bytes = (long long)d * E;
  const uint8_t* tile = parts + (long long)pid * cap * row_bytes;
  const float* tscale = scales + (long long)pid * cap;
  for (int r = r0 + warp; r < r1; r += WARPS) {
    const uint8_t* row = tile + r * row_bytes;
    float acc = 0.0f;
    if (vec_ok) {
      const uint4* rv = reinterpret_cast<const uint4*>(row);
      for (int base = lane; base < nv; base += 32 * UNROLL) {
        uint4 buf[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int v = base + u * 32;
          buf[u] = v < nv ? __ldg(rv + v) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int v = base + u * 32;
          if (v < nv) acc = dot_vec<DT>(buf[u], qs + v, nv, acc);
        }
      }
    } else {
      for (int t = lane; t < d; t += 32) acc = fmaf(qs[t], elem<DT>(row, t), acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const float s = tscale[r];
      orow[r] = s > 0.0f ? acc * s : NEG;
    }
  }
}

__device__ __forceinline__ void nibble_dot(uint32_t byte, float qe, float qo,
                                           float& se, float& so) {
  se = fmaf(qe, static_cast<float>(static_cast<int>(byte & 0xFu) - 8), se);
  so = fmaf(qo, static_cast<float>(static_cast<int>(byte >> 4) - 8), so);
}

__global__ void __launch_bounds__(THREADS) ivf_int4_kernel(
    const float* __restrict__ qe, const float* __restrict__ qo,
    const int32_t* __restrict__ probe_ids, const uint8_t* __restrict__ parts,
    const float* __restrict__ scales, float* __restrict__ out, int nprobe,
    int nlist, int cap, int w, int vec_ok) {
  // the even and odd query planes, bf16-rounded: each [16][nv] on the
  // vector path, [w] otherwise
  extern __shared__ float qs[];
  float* qes = qs;
  float* qos = qs + w;
  const int nv = w / 16;
  const int qi = blockIdx.z, j = blockIdx.y;
  const int pid = probe_ids[(long long)qi * nprobe + j];
  for (int t = threadIdx.x; t < w; t += THREADS) {
    const int at = vec_ok ? (t % 16) * nv + t / 16 : t;
    qes[at] = bf16_round(qe[(long long)qi * w + t]);
    qos[at] = bf16_round(qo[(long long)qi * w + t]);
  }
  __syncthreads();
  float* orow = out + ((long long)qi * nprobe + j) * cap;
  const int r0 = blockIdx.x * ROWS_PER_BLOCK;
  const int r1 = min(r0 + ROWS_PER_BLOCK, cap);
  if (pid < 0 || pid >= nlist) {
    for (int r = r0 + threadIdx.x; r < r1; r += THREADS) orow[r] = NEG;
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint8_t* tile = parts + (long long)pid * cap * w;
  const float* tscale = scales + (long long)pid * cap;
  for (int r = r0 + warp; r < r1; r += WARPS) {
    const uint8_t* row = tile + (long long)r * w;
    float se = 0.0f, so = 0.0f;
    if (vec_ok) {
      const uint4* rv = reinterpret_cast<const uint4*>(row);
      for (int base = lane; base < nv; base += 32 * UNROLL) {
        uint4 buf[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int v = base + u * 32;
          buf[u] = v < nv ? __ldg(rv + v) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int v = base + u * 32;
          if (v >= nv) continue;
          const uint32_t words[4] = {buf[u].x, buf[u].y, buf[u].z, buf[u].w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int at = (4 * i + b) * nv + v;
              nibble_dot((words[i] >> (8 * b)) & 0xFFu, qes[at], qos[at],
                         se, so);
            }
        }
      }
    } else {
      for (int t = lane; t < w; t += 32)
        nibble_dot(__ldg(row + t), qes[t], qos[t], se, so);
    }
    se = warp_sum(se);
    so = warp_sum(so);
    if (lane == 0) {
      const float s = tscale[r];
      orow[r] = s > 0.0f ? (se + so) * s : NEG;
    }
  }
}

bool shapes_ok(int nq, int nprobe, int nlist, int cap, int width) {
  return nq > 0 && nq <= 65535 && nprobe > 0 && nprobe <= 65535 &&
         nlist > 0 && cap > 0 && width > 0;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  constexpr size_t kDefault = 48 * 1024;
  if (smem <= kDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

dim3 grid_for(int nq, int nprobe, int cap) {
  return dim3((unsigned)((cap + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK),
              (unsigned)nprobe, (unsigned)nq);
}

template <int DT>
cudaError_t launch_dense(const void* q, const void* ids, const void* parts,
                         const void* scales, void* out, int nq, int nprobe,
                         int nlist, int cap, int d, int vec_ok,
                         cudaStream_t s) {
  const size_t smem = (size_t)d * sizeof(float);
  cudaError_t err = prepare(ivf_dense_kernel<DT>, smem);
  if (err != cudaSuccess) return err;
  ivf_dense_kernel<DT><<<grid_for(nq, nprobe, cap), THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(parts), static_cast<const float*>(scales),
      static_cast<float*>(out), nprobe, nlist, cap, d, vec_ok);
  return cudaGetLastError();
}


// ---------------------------------------------------------- grouped variant

constexpr int G_THREADS = 256;        // 8 warps, 16 rows of a chunk each
constexpr int G_ROWS = 128;           // rows a chunk
constexpr int N_MAX = 32;             // entries (query columns) an item
constexpr int NT_MAX = N_MAX / 8;     // 8-wide mma column tiles an item
constexpr int PLAN_THREADS = 1024;    // the plan is one block
constexpr int PLAN_MAX_NLIST = 32768; // its histogram lives in shared memory
constexpr int MAX_SMEM = 232448;      // 227 KB a block

// a grouped row's bytes: d values of the tile type (int4: two a byte)
__host__ __device__ constexpr long long grouped_row_bytes(long long d, int dt) {
  return dt == DT_BF16 ? 2 * d : dt == DT_INT8 ? d : d / 2;
}

// The probe plan, one block. Entries e = q * nprobe + j are counted by
// partition (shared-memory histogram), scanned, cut into items of at most
// N_MAX entries (p, first, count) in partition order, then scattered into
// `entries` by partition (the order inside a partition is whatever the
// atomics give: every board value is one row times one query, whatever
// its column). Entries whose id lies outside [0, nlist) are set apart, and
// their board rows get -3e38 here when `out` is given.
__global__ void __launch_bounds__(PLAN_THREADS) ivf_plan_kernel(
    const int32_t* __restrict__ probe_ids, int n, int nlist, int cap,
    int32_t* __restrict__ entries, int4* __restrict__ items,
    int32_t* __restrict__ n_items, float* __restrict__ out) {
  extern __shared__ int cnt[];                   // [nlist]
  __shared__ int sums[2][PLAN_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int p = tid; p < nlist; p += PLAN_THREADS) cnt[p] = 0;
  __syncthreads();
  for (int base = warp * 32; base < n; base += PLAN_THREADS) {
    const int e = base + lane;
    const int p = e < n ? probe_ids[e] : 0;
    const bool valid = p >= 0 && p < nlist;
    if (e < n && valid) atomicAdd(&cnt[p], 1);
    unsigned bad = __ballot_sync(0xffffffffu, e < n && !valid);
    while (bad != 0u && out != nullptr) {
      float* row = out + (long long)(base + __ffs(bad) - 1) * cap;
      for (int c = lane; c < cap; c += 32) row[c] = NEG;
      bad &= bad - 1u;
    }
  }
  __syncthreads();
  // each thread owns a run of partitions; a block scan of (entries, items)
  const int per = (nlist + PLAN_THREADS - 1) / PLAN_THREADS;
  const int lo = min(nlist, tid * per), hi = min(nlist, lo + per);
  int sc = 0, si = 0;
  for (int p = lo; p < hi; ++p) {
    sc += cnt[p];
    si += (cnt[p] + N_MAX - 1) / N_MAX;
  }
  int ic = sc, ii = si;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, ic, o);
    const int b = __shfl_up_sync(0xffffffffu, ii, o);
    if (lane >= o) {
      ic += a;
      ii += b;
    }
  }
  if (lane == 31) {
    sums[0][warp] = ic;
    sums[1][warp] = ii;
  }
  __syncthreads();
  if (warp == 0) {
    const int va = sums[0][lane], vb = sums[1][lane];
    int a = va, b = vb;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, a, o);
      const int y = __shfl_up_sync(0xffffffffu, b, o);
      if (lane >= o) {
        a += x;
        b += y;
      }
    }
    sums[0][lane] = a - va;
    sums[1][lane] = b - vb;
  }
  __syncthreads();
  int off = sums[0][warp] + ic - sc, it = sums[1][warp] + ii - si;
  for (int p = lo; p < hi; ++p) {
    const int c = cnt[p];
    cnt[p] = off;                    // the scatter's cursor
    for (int f = 0; f < c; f += N_MAX)
      items[it++] = make_int4(p, off + f, min(N_MAX, c - f), 0);
    off += c;
  }
  if (tid == PLAN_THREADS - 1) *n_items = it;
  __syncthreads();
  for (int e = tid; e < n; e += PLAN_THREADS) {
    const int p = probe_ids[e];
    if (p >= 0 && p < nlist) entries[atomicAdd(&cnt[p], 1)] = e;
  }
}

// The grouped board kernel. Block (x, y) scores item x (in `direct` mode,
// entry x alone) against rows [y * span_chunks * 128, ...) of its tile.
// K order: mma_frag.cuh. The query fragments are zero past the item's
// count and past d. For int4 that zero is what keeps a partial 128-byte
// step right: a zero-filled byte past the end of a row widens to level -8,
// not 0, and only its zero query value cancels it.
template <int DT>
__global__ void __launch_bounds__(G_THREADS, 3) ivf_grouped_kernel(
    const float* __restrict__ q, const int32_t* __restrict__ probe_ids,
    const uint8_t* __restrict__ parts, const float* __restrict__ scales,
    float* __restrict__ out, const int4* __restrict__ items,
    const int32_t* __restrict__ n_items, const int32_t* __restrict__ entries,
    int nprobe, int nlist, int cap, int d, int direct, int span_chunks) {
  constexpr int KPS = piece_values(DT) / 2;   // k16 slices a step
  extern __shared__ __align__(16) uint8_t smem[];
  int* ents = reinterpret_cast<int*>(smem);                          // [N_MAX]
  uint2* frag = reinterpret_cast<uint2*>(smem + N_MAX * sizeof(int));
  const int x = blockIdx.x;
  int pid, first, count;
  if (direct) {
    pid = probe_ids[x];
    first = x;
    count = 1;
  } else {
    if (x >= *n_items) return;
    const int4 item = items[x];
    pid = item.x;
    first = item.y;
    count = item.z;
  }
  const int r_begin = blockIdx.y * span_chunks * G_ROWS;
  const int r_end = min(cap, r_begin + span_chunks * G_ROWS);
  if (pid < 0 || pid >= nlist) {    // direct mode only: the plan sets these apart
    float* orow = out + (long long)first * cap;
    for (int r = r_begin + threadIdx.x; r < r_end; r += G_THREADS)
      orow[r] = NEG;
    return;
  }
  const long long row_bytes = grouped_row_bytes(d, DT);
  const int nsteps = (int)((row_bytes + STEP_BYTES - 1) / STEP_BYTES);
  const int ks_total = nsteps * KPS;
  const int nt_count = (count + 7) >> 3;
  if (threadIdx.x < count)
    ents[threadIdx.x] = direct ? first : entries[first + threadIdx.x];
  __syncthreads();
  // the item's queries, bf16-rounded, as B fragments [nt][k16 slice][lane]:
  // group i of a query row is one lane's 8 bytes of one slice; d0 is the
  // first dim of its 4 (bf16, int8) or of its word's 8 (int4)
  const int groups = ks_total * 4;
  for (int i = threadIdx.x; i < nt_count * 8 * groups; i += G_THREADS) {
    const int n = i / groups, gi = i - n * groups;
    int t, d0;
    const int ks = group_slot<DT>(gi, t, d0);
    const uint2 v =
        n < count && d0 < d
            ? b_group<DT>(q + (long long)(ents[n] / nprobe) * d + d0, gi)
            : make_uint2(0u, 0u);
    frag[((n >> 3) * ks_total + ks) * 32 + (n & 7) * 4 + t] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint8_t* tile = parts + (long long)pid * cap * row_bytes;
  const float* tscale = scales + (long long)pid * cap;
  const int nchunks = (r_end - r_begin + G_ROWS - 1) / G_ROWS;
  const int total = nchunks * nsteps;
  // the lane's piece of row r (rows past cap read the last row: they are
  // never stored)
  auto piece = [&](int c, int half) {
    const int r = min(r_begin + c * G_ROWS + warp * 16 + g + 8 * half,
                      cap - 1);
    return tile + (long long)r * row_bytes + 16 * t;
  };
  // step s of chunk c: pieces [row g p0, row g p1, row g+8 p0, row g+8 p1]
  auto load = [&](uint4 (&buf)[4], int c, int s) {
    const uint8_t* ra = piece(c, 0);
    const uint8_t* rb = piece(c, 1);
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const long long off = (long long)s * STEP_BYTES + 64 * pp;
      if (off + 16 * t < row_bytes) {
        buf[pp] = ldg_stream(ra + off);
        buf[2 + pp] = ldg_stream(rb + off);
      } else {
        buf[pp] = buf[2 + pp] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  float acc[NT_MAX][4];
#pragma unroll
  for (int nt = 0; nt < NT_MAX; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
  uint4 cur[4], nxt[4] = {};
  float sa = 0.0f, sb = 0.0f;
  int c = 0, s = 0;
  load(cur, 0, 0);
  for (int i = 0; i < total; ++i) {
    int cn = c, sn = s + 1;
    if (sn == nsteps) {
      sn = 0;
      ++cn;
    }
    if (i + 1 < total) load(nxt, cn, sn);
    if (s == 0) {                     // the rows' scales, used at the epilogue
      const int ra = r_begin + c * G_ROWS + warp * 16 + g;
      sa = ra < cap ? __ldg(tscale + ra) : 0.0f;
      sb = ra + 8 < cap ? __ldg(tscale + ra + 8) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < KPS; ++r) {
      uint32_t a0, a1, a2, a3;
      a_slice<DT>(cur, r, a0, a1, a2, a3);
      const uint2* fb = frag + (s * KPS + r) * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < NT_MAX; ++nt) {
        if (nt < nt_count) {
          const uint2 b = fb[nt * ks_total * 32];
          mma_bf16(acc[nt], a0, a1, a2, a3, b.x, b.y);
        }
      }
    }
    if (s == nsteps - 1) {            // epilogue of chunk c
      const int ra = r_begin + c * G_ROWS + warp * 16 + g, rb = ra + 8;
#pragma unroll
      for (int nt = 0; nt < NT_MAX; ++nt) {
        if (nt >= nt_count) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = nt * 8 + 2 * t + j;
          if (n >= count) continue;
          float* orow = out + (long long)ents[n] * cap;
          if (ra < r_end) orow[ra] = sa > 0.0f ? acc[nt][j] * sa : NEG;
          if (rb < r_end) orow[rb] = sb > 0.0f ? acc[nt][2 + j] * sb : NEG;
        }
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) acc[nt][i2] = 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) cur[k] = nxt[k];
    c = cn;
    s = sn;
  }
}

// shared memory of a grouped block: the item's entry ids and its query
// fragments (one column tile in direct mode)
size_t grouped_smem(int d, int dtype, int direct) {
  const long long steps =
      (grouped_row_bytes(d, dtype) + STEP_BYTES - 1) / STEP_BYTES;
  const long long kps = dtype == DT_BF16 ? 4 : dtype == DT_INT8 ? 8 : 16;
  return N_MAX * sizeof(int) +
         (size_t)((direct ? 1 : NT_MAX) * steps * kps * 32 * sizeof(uint2));
}

// scratch (int32, 16-byte aligned): items [item_bound][4] | n_items [4] |
// entries [n]
cudaError_t launch_plan_kernel(const void* probe_ids, void* scratch,
                               void* out, int n, int nlist, int cap,
                               int item_bound, cudaStream_t s) {
  int32_t* base = static_cast<int32_t*>(scratch);
  int32_t* n_items = base + 4LL * item_bound;
  const size_t smem = (size_t)nlist * sizeof(int);
  cudaError_t err = prepare(ivf_plan_kernel, smem);
  if (err != cudaSuccess) return err;
  ivf_plan_kernel<<<1, PLAN_THREADS, smem, s>>>(
      static_cast<const int32_t*>(probe_ids), n, nlist, cap, n_items + 4,
      reinterpret_cast<int4*>(base), n_items, static_cast<float*>(out));
  return cudaGetLastError();
}

bool plan_shape_ok(long long n, int nlist, int item_bound, void* scratch) {
  return n > 0 && n <= (1LL << 30) && nlist > 0 && nlist <= PLAN_MAX_NLIST &&
         item_bound >= std::min<long long>(nlist, n) + n / N_MAX &&
         item_bound <= (1 << 28) && scratch != nullptr &&
         reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
}

template <int DT>
cudaError_t launch_grouped(const void* q, const void* ids, const void* parts,
                           const void* scales, void* out, void* scratch,
                           int nprobe, int nlist, int cap, int d, int direct,
                           int item_bound, int split, int span_chunks,
                           size_t smem, long long n, cudaStream_t s) {
  cudaError_t err;
  const int32_t* base = static_cast<const int32_t*>(scratch);
  if (!direct) {
    err = launch_plan_kernel(ids, scratch, out, (int)n, nlist, cap,
                             item_bound, s);
    if (err != cudaSuccess) return err;
  }
  err = prepare(ivf_grouped_kernel<DT>, smem);
  if (err != cudaSuccess) return err;
  const int32_t* n_items = direct ? nullptr : base + 4LL * item_bound;
  ivf_grouped_kernel<DT><<<dim3((unsigned)item_bound, (unsigned)split),
                           G_THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const int32_t*>(ids),
      static_cast<const uint8_t*>(parts), static_cast<const float*>(scales),
      static_cast<float*>(out),
      direct ? nullptr : reinterpret_cast<const int4*>(base), n_items,
      direct ? nullptr : n_items + 4, nprobe, nlist, cap, d, direct,
      span_chunks);
  return cudaGetLastError();
}

// Both grouped entries: rejects a plan that does not cover the shape, then
// launches the plan kernel (unless direct) and the board kernel.
int grouped_entry(const void* q, const void* probe_ids, const void* parts,
                  const void* scales, void* out, void* scratch, int nq,
                  int nprobe, int nlist, int cap, int d, int dtype,
                  int direct, int item_bound, int split, int span_chunks,
                  void* stream) {
  if (!shapes_ok(nq, nprobe, nlist, cap, d)) return cudaErrorInvalidValue;
  if (dtype != DT_BF16 && dtype != DT_INT8 && dtype != DT_INT4)
    return cudaErrorInvalidValue;
  if ((dtype == DT_INT4 && d % 2 != 0) ||
      grouped_row_bytes(d, dtype) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long n = (long long)nq * nprobe;
  if (direct ? (item_bound < n || item_bound > (1 << 28))
             : !plan_shape_ok(n, nlist, item_bound, scratch))
    return cudaErrorInvalidValue;
  const long long span_rows = (long long)span_chunks * G_ROWS;
  if (split < 1 || split > 65535 || span_chunks < 1 ||
      split * span_rows < cap || (split - 1) * span_rows >= cap)
    return cudaErrorInvalidValue;
  const size_t smem = grouped_smem(d, dtype, direct);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = dtype == DT_BF16   ? &launch_grouped<DT_BF16>
                : dtype == DT_INT8 ? &launch_grouped<DT_INT8>
                                   : &launch_grouped<DT_INT4>;
  return launch(q, probe_ids, parts, scales, out, scratch, nprobe, nlist, cap,
                d, direct, item_bound, split, span_chunks, smem, n, s);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The simt variant of ivf_fused_dense.
// dtype: 0 = f32, 1 = bf16, 2 = int8 tiles
int ivf_fused_dense(const void* q, const void* probe_ids, const void* parts,
                    const void* scales, void* out, int nq, int nprobe,
                    int nlist, int cap, int d, int dtype, int vec_ok,
                    void* stream) {
  if (!shapes_ok(nq, nprobe, nlist, cap, d)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch_dense<DT_F32>(q, probe_ids, parts, scales, out, nq,
                                  nprobe, nlist, cap, d, vec_ok, s);
    case DT_BF16:
      return launch_dense<DT_BF16>(q, probe_ids, parts, scales, out, nq,
                                   nprobe, nlist, cap, d, vec_ok, s);
    case DT_INT8:
      return launch_dense<DT_INT8>(q, probe_ids, parts, scales, out, nq,
                                   nprobe, nlist, cap, d, vec_ok, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The grouped variant of ivf_fused_dense (bf16 = 1 or int8 = 2 tiles whose
// row bytes are a multiple of 16), with the caller's launch plan: `direct`
// (each entry its own item, no plan kernel), the item bound (the grid's x)
// and the row spans (split spans of span_chunks 128-row chunks). Rejects a
// plan that does not cover the shape. `scratch` (int32, 16-byte aligned,
// 4 * item_bound + 4 + nq * nprobe values) holds the probe plan; unused in
// direct mode.
int ivf_fused_dense_grouped(const void* q, const void* probe_ids,
                            const void* parts, const void* scales, void* out,
                            void* scratch, int nq, int nprobe, int nlist,
                            int cap, int d, int dtype, int direct,
                            int item_bound, int split, int span_chunks,
                            void* stream) {
  if (dtype == DT_INT4) return cudaErrorInvalidValue;
  return grouped_entry(q, probe_ids, parts, scales, out, scratch, nq, nprobe,
                       nlist, cap, d, dtype, direct, item_bound, split,
                       span_chunks, stream);
}

// The grouped variant of ivf_fused_int4: the same as
// ivf_fused_dense_grouped, for packed-nibble tiles of d / 2 bytes a row
// (d, the query's dims, a multiple of 32) and the f32 query [nq, d] itself
// (no even/odd planes).
int ivf_fused_int4_grouped(const void* q, const void* probe_ids,
                           const void* parts, const void* scales, void* out,
                           void* scratch, int nq, int nprobe, int nlist,
                           int cap, int d, int direct, int item_bound,
                           int split, int span_chunks, void* stream) {
  return grouped_entry(q, probe_ids, parts, scales, out, scratch, nq, nprobe,
                       nlist, cap, d, DT_INT4, direct, item_bound, split,
                       span_chunks, stream);
}

// The probe plan alone (the grouped variant's first launch), for holding
// it against its plain version; `out` may be null (no -3e38 rows written).
int ivf_probe_plan(const void* probe_ids, void* scratch, void* out, int n,
                   int nlist, int cap, int item_bound, void* stream) {
  if (!plan_shape_ok(n, nlist, item_bound, scratch) || cap < 1)
    return cudaErrorInvalidValue;
  return launch_plan_kernel(probe_ids, scratch, out, n, nlist, cap,
                            item_bound, static_cast<cudaStream_t>(stream));
}

// The simt variant of ivf_fused_int4: the even and odd query planes
// [nq, w] f32 against tiles of w bytes a row.
int ivf_fused_int4(const void* qe, const void* qo, const void* probe_ids,
                   const void* parts, const void* scales, void* out, int nq,
                   int nprobe, int nlist, int cap, int w, int vec_ok,
                   void* stream) {
  if (!shapes_ok(nq, nprobe, nlist, cap, w)) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)w * sizeof(float);
  cudaError_t err = prepare(ivf_int4_kernel, smem);
  if (err != cudaSuccess) return err;
  ivf_int4_kernel<<<grid_for(nq, nprobe, cap), THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qe), static_cast<const float*>(qo),
      static_cast<const int32_t*>(probe_ids),
      static_cast<const uint8_t*>(parts), static_cast<const float*>(scales),
      static_cast<float*>(out), nprobe, nlist, cap, w, vec_ok);
  return cudaGetLastError();
}

}  // extern "C"
