// BM25 score board for the lexical leg (the Hopper counterpart of the
// reference's `bm25.topk` XLA program, `ops/bm25.py::_bm25_topk`).
//
// Inputs: zeroed boards scores [nq, w1] f32 and counts [nq, w1] i32 (lane
// w1 - 1 is the trash lane, never written here); the batch's work items
// (query, tile, boost bits) grouped by term position, items
// starts[j]..starts[j+1] being the tiles of every query's j-th term; the
// field's tile-padded impact CSR: tile_slots [T, 128] i32 (-1 padding) and
// tile_impacts [T, 128] f32, bf16 or int8, with per-tile scales [T] f32 for
// int8.
//
// One launch a term position, one block a work item, one thread a lane:
//     scores[q, slot] = scores[q, slot] + (imp [* scale]) * boost
//     counts[q, slot] += 1
// with plain loads and stores. Within one term position a (query, slot)
// pair is written at most once (a posting lies in exactly one tile of its
// term, and a query's j-th term is one term), so no atomics are needed, and
// launching the positions in order on one stream adds to each slot in
// query-term order, the reference's order. The products and the sum use
// __fmul_rn / __fadd_rn, which nvcc never contracts into an FMA, so the
// f32 sums are bit-identical to the reference's host and device boards.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;

template <int DTYPE>
__device__ __forceinline__ float load_impact(const void* impacts,
                                             int64_t at) {
  if (DTYPE == 0) return static_cast<const float*>(impacts)[at];
  if (DTYPE == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(impacts)[at]);
  return static_cast<float>(static_cast<const int8_t*>(impacts)[at]);
}

template <int DTYPE>
__global__ void __launch_bounds__(TILE)
bm25_board_kernel(float* __restrict__ scores, int* __restrict__ counts,
                  int64_t w1, const int* __restrict__ items, int64_t n_items,
                  int64_t first, const int* __restrict__ tile_slots,
                  const void* __restrict__ tile_impacts,
                  const float* __restrict__ tile_scales) {
  const int64_t item = first + blockIdx.x;
  const int q = items[item];
  const int tile = items[n_items + item];
  const float boost = __int_as_float(items[2 * n_items + item]);
  const int64_t at = static_cast<int64_t>(tile) * TILE + threadIdx.x;
  const int slot = tile_slots[at];
  if (slot < 0) return;
  float imp = load_impact<DTYPE>(tile_impacts, at);
  if (DTYPE == 2) imp = __fmul_rn(imp, tile_scales[tile]);
  const int64_t cell = static_cast<int64_t>(q) * w1 + slot;
  scores[cell] = __fadd_rn(scores[cell], __fmul_rn(imp, boost));
  counts[cell] += 1;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = f32, 1 = bf16, 2 = int8 impacts (tile_scales then required).
// items: device int32 [3, n_items] (query, tile, boost as f32 bits);
// starts: HOST int32 [n_pos + 1]. Returns 0 or a cudaError_t code.
int bm25_board(void* scores, void* counts, long long w1, const void* items,
               long long n_items, const int* starts, int n_pos,
               const void* tile_slots, const void* tile_impacts,
               const void* tile_scales, int dtype, long long stream_handle) {
  if (dtype < 0 || dtype > 2 || (dtype == 2 && tile_scales == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_handle);
  for (int j = 0; j < n_pos; ++j) {
    const int n = starts[j + 1] - starts[j];
    if (n <= 0) continue;
    const dim3 grid(n), block(TILE);
    auto* s = static_cast<float*>(scores);
    auto* c = static_cast<int*>(counts);
    auto* it = static_cast<const int*>(items);
    auto* ts = static_cast<const int*>(tile_slots);
    auto* sc = static_cast<const float*>(tile_scales);
    if (dtype == 0)
      bm25_board_kernel<0><<<grid, block, 0, stream>>>(
          s, c, w1, it, n_items, starts[j], ts, tile_impacts, sc);
    else if (dtype == 1)
      bm25_board_kernel<1><<<grid, block, 0, stream>>>(
          s, c, w1, it, n_items, starts[j], ts, tile_impacts, sc);
    else
      bm25_board_kernel<2><<<grid, block, 0, stream>>>(
          s, c, w1, it, n_items, starts[j], ts, tile_impacts, sc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
