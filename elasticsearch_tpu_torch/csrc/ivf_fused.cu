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
// only the order of the f32 sum differs from the plain version.
//
// Layout. The TPU kernel prefetches the probe ids as scalars and lets the
// BlockSpec index map pick each (query, probe) tile out of `parts`. Here a
// block reads its own ids[q, j] and computes the tile's offset from it: no
// [Q, nprobe, cap, D] gather ever exists in device memory, which is the
// point of the kernel. Grid: x = a chunk of 64 rows of the tile (so enough
// blocks are in flight at Q = 1), y = probe slot, z = query. A block stages
// its query in shared memory; each of its 8 warps walks rows of the chunk,
// the lanes reading 16-byte vectors (4 f32, 8 bf16, 16 int8, or 16 packed
// bytes = 32 nibbles), up to 4 vectors in flight per lane, accumulating in
// f32 and reducing with warp shuffles; lane 0 applies scale and mask and
// writes one board value per row. On the vector path the staged query is
// transposed to [element of vector][vector], so the 32 lanes of a warp,
// which work on 32 consecutive vectors, read 32 consecutive words of
// shared memory (no bank conflicts). A row whose bytes are not a multiple of
// 16 takes scalar loads for the whole row (the vector path needs every row
// to start 16-byte aligned); the wrapper passes which path applies. A probe
// id outside [0, nlist) reads nothing and writes -3e38 for the whole chunk.
//
// What bounds it on the H100. It does 2 operations per tile element it
// reads (far below the ~295 operations per byte where the tensor cores
// would be the limit), so it is bound by bytes. The least bytes: each
// distinct probed tile read once, plus the board written once; at Q = 256
// with random probes that is nearly all of `parts`. This first version
// reads a tile once per (query, probe) that names it and relies on L2 for
// any reuse; grouping the queries that share a partition, cp.async / TMA
// staging and tensor cores at large Q are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_BLOCK = 64;
constexpr int UNROLL = 4;            // 16-byte vectors in flight per lane
constexpr float NEG = -3.0e38f;      // the NEG_INF sentinel of the board

enum { DT_F32 = 0, DT_BF16 = 1, DT_INT8 = 2 };

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

__device__ __forceinline__ float int8_at(uint32_t w, int byte) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * byte)) & 0xFFu));
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

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
