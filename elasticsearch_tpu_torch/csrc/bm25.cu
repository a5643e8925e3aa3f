// BM25 score board and its window for the lexical and learned-sparse legs
// (the Hopper counterpart of the reference's `bm25.topk` XLA program,
// `elasticsearch_tpu/ops/bm25.py::_bm25_topk`, also registered as
// `sparse.topk`).
//
// What it computes: for each query, the sum over its term positions, in
// query-term order, of (impact [* tile scale]) * boost into every slot the
// position's term posts to, and the count of those positions; then the
// slots counted at least max(required, 1) times, ranked by (score desc,
// slot asc), cut to a window of k. The f32 products and sums use
// __fmul_rn / __fadd_rn, which nvcc never contracts into an FMA, so every
// sum is bit-identical to the reference's host and device boards.
//
// What bounds it: memory. A posting costs one multiply and one add, and the
// batch's tiles (slot + impact bytes) are read from device memory. So the
// boards never touch device memory, and one pass does the whole batch:
//
// Kernel A (`board_select_kernel`), one block a (query, slot range), the
// queries fastest, so the blocks in flight read the same ranges' tiles and
// the tiles that queries share come from L2. Block (q, r) owns the slots
// [r R, min((r + 1) R, n_slots)) and keeps their scores (f32) and counts
// (i32) in shared memory. It finds, for each of the query's positions at
// once, the tiles of the term's run that touch the range: an L-ary search
// on `tile_first`, which ascends within a run, L lanes a position (32 for
// a short query), both ends at once, so a window costs a few dependent
// loads. Then it walks the positions in order, a pass of 8 tiles' lanes at
// a time, the next DEPTH passes' loads issued before a pass's adds (the
// loads do not depend on the adds). One warp instruction touches 32
// consecutive lanes of a tile, whose slots ascend and are distinct, and
// adds with plain shared-memory stores: within one position a slot is
// written at most once, and a barrier between positions keeps each slot's
// adds in query-term order. Then it masks by count and radix-selects the
// range's exact top k' = min(k, R) on the order-preserving bits of the
// scores (a 12-bit digit, then the keys left in its bin compacted into a
// short list for the next digits), and writes them as 64-bit keys (score
// bits, ~slot) to scratch, 0 past the matches.
//
// Kernel B (`merge_kernel`), one block a query: the top k of its ranges'
// candidates by the same order (the same compacting radix select on the
// unique 64-bit keys; a window of up to 1,024 placed by rank, a longer one
// by a bitonic sort, in shared memory or, past 16,384, in global scratch),
// written as vals [Q, k] f32 and slots [Q, k] i32, -inf / -1 past the
// matched count.
//
// On an H100 the walk's time follows the tiles' bytes, not their latency
// (a deeper prefetch, a cp.async ring, even dropping the barriers moved it
// by at most ~16%): a tile that several queries share is read once a
// query, from L2 at best.
//
// Counts are i32: no cap on a query's positions, so the wrapper need not
// read the plan back from the card to check one; at R = 8192 the board is
// 64 KB and three blocks share an SM.

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;
constexpr int A_THREADS = 256;
constexpr int LANES = 4;                       // lanes a thread loads a pass
constexpr int PASS_LANES = A_THREADS * LANES;  // 8 tiles a pass
constexpr int DEPTH = 2;                       // passes in flight a thread
constexpr int POS_CHUNK = 512;                 // positions' windows held at once
constexpr int A_LIST = 3 * POS_CHUNK;          // keys kernel A compacts (in
                                               // the windows' space)
constexpr int B_THREADS = 512;
constexpr int B_LIST = 2048;                   // keys kernel B compacts
constexpr int RANK_SORT_MAX = 1024;            // kernel B ranks a window this
                                               // short, else sorts it
constexpr int HIST_BINS = 4096;                // a 12-bit digit
constexpr int RANGE_MAX = 16384;
constexpr int SMEM_MAX = 232448;
constexpr int MISC_INTS = 32;
constexpr int HEAD_BYTES = 256 * 4 + MISC_INTS * 4;  // histogram + misc

typedef unsigned long long u64;

// The kernels this library has launched, each counted once the runtime
// accepted its launch: `ops/bm25.py::kernel_launches` reads it to measure
// a call's launches.
std::atomic<long long> g_launches{0};

cudaError_t counted(cudaError_t err) {
  if (err == cudaSuccess) g_launches.fetch_add(1);
  return err;
}

__device__ __forceinline__ unsigned int mono(float f) {
  const unsigned int b = __float_as_uint(f);
  return b ^ ((b >> 31) ? 0xFFFFFFFFu : 0x80000000u);
}

__device__ __forceinline__ float unmono(unsigned int k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xFFFFFFFFu));
}

__device__ __forceinline__ u64 cand_key(unsigned int key, int slot) {
  return (static_cast<u64>(key) << 32) |
         static_cast<u64>(0xFFFFFFFFu - static_cast<unsigned int>(slot));
}

__device__ __forceinline__ unsigned int lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Appends the values each lane takes at out[*counter...], in no fixed
// order, one atomic a warp; the whole warp calls it, and skips it when no
// lane takes any.
template <typename T, int U>
__device__ __forceinline__ void warp_append(const bool (&take)[U],
                                            const T (&v)[U], T* out,
                                            int* counter) {
  int c = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) c += take[u];
  if (!__any_sync(0xFFFFFFFFu, c != 0)) return;
  const int lane = threadIdx.x & 31;
  int incl = c;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += t;
  }
  int at = 0;
  if (lane == 31) at = atomicAdd(counter, incl);
  at = __shfl_sync(0xFFFFFFFFu, at, 31) + incl - c;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (take[u]) out[at++] = v[u];
}

// Of `nb` bins (nb <= HIST_BINS; threads 0..255 scan, from the top), the
// bin that holds the `want`-th largest key: misc[1] = the bin, misc[2] =
// the rank left within it, misc[3] = its count (if want <= the total), and
// misc[4] = the total. Uses misc[8..16).
__device__ void pick_bin(const unsigned int* hist, int nb, int want,
                         int* misc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = nb >= 256 ? nb / 256 : 1;
  const int top = nb - 1 - static_cast<int>(threadIdx.x) * per;
  unsigned int local = 0, incl = 0;
  if (threadIdx.x < 256) {
    for (int b = top; b > top - per && b >= 0; --b) local += hist[b];
    incl = local;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += t;
    }
    if (lane == 31) misc[8 + warp] = static_cast<int>(incl);
  }
  __syncthreads();
  if (threadIdx.x < 256) {
    for (int w = 0; w < warp; ++w)
      incl += static_cast<unsigned int>(misc[8 + w]);
    if (threadIdx.x == 255) misc[4] = static_cast<int>(incl);
    const unsigned int u = static_cast<unsigned int>(want);
    if (incl >= u && incl - local < u) {
      unsigned int cum = incl - local;
      for (int b = top;; --b) {
        const unsigned int h = hist[b];
        if (cum + h >= u) {
          misc[1] = b;
          misc[2] = static_cast<int>(u - cum);
          misc[3] = static_cast<int>(h);
          break;
        }
        cum += h;
      }
    }
  }
  __syncthreads();
}

// Where to cut the nonzero keys for their top kk. Unordered: take every
// nonzero key >= t (t = 0 when matched <= kk: all of them). Ordered (the
// cut splits the keys == t): every key > t (n_gt of them), then need_eq of
// the keys == t, the lowest slots first. A radix select from the top, a
// `first_w`-bit digit then `next_w`-bit ones, histograms in `hist` (plain
// shared-memory atomics: on the H100 cheaper than aggregating a warp's
// equal bins with __match_any_sync); once the keys in the chosen bin fit
// `list` (cap), they are compacted there and the later digits read only
// them; it stops at the first digit whose bin is wanted whole.
template <typename Key>
struct Cut {
  Key t;
  int n_gt, need_eq, matched;
  bool ordered;
};

template <typename Key, int THREADS>
__device__ Cut<Key> select_cut(const Key* keys, int n, int kk, int first_w,
                               int next_w, unsigned int* hist, Key* list,
                               int cap, int* misc) {
  constexpr int U = 4;  // keys a thread loads before it bins them
  Key prefix = 0, mask = 0;
  int remaining = kk, in_bin = 0;
  const Key* src = keys;
  int n_src = n;
  Cut<Key> cut{0, 0, 0, 0, false};
  int shift = 8 * static_cast<int>(sizeof(Key));
  for (int d = 0; shift > 0; ++d) {
    const int w = min(shift, d == 0 ? first_w : next_w);
    shift -= w;
    const int nb = 1 << w;
    if (d > 0 && src == keys && in_bin <= cap) {
      if (threadIdx.x == 0) misc[5] = 0;
      __syncthreads();
      for (int base = 0; base < n_src; base += THREADS * U) {
        Key k[U];
        bool take[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = base + u * THREADS + threadIdx.x;
          k[u] = i < n_src ? src[i] : Key(0);
          take[u] = k[u] != 0 && (k[u] & mask) == prefix;
        }
        warp_append(take, k, list, misc + 5);
      }
      __syncthreads();
      src = list;
      n_src = in_bin;
    }
    for (int i = threadIdx.x; i < nb; i += THREADS) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < n_src; base += THREADS * U) {
      Key k[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * THREADS + threadIdx.x;
        k[u] = i < n_src ? src[i] : Key(0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k[u] != 0 && (k[u] & mask) == prefix)
          atomicAdd(hist + ((k[u] >> shift) & static_cast<Key>(nb - 1)), 1u);
      }
    }
    __syncthreads();
    pick_bin(hist, nb, remaining, misc);
    if (d == 0) {
      cut.matched = misc[4];
      if (cut.matched <= kk) {
        __syncthreads();
        return cut;
      }
    }
    prefix |= static_cast<Key>(misc[1]) << shift;
    mask |= static_cast<Key>(nb - 1) << shift;
    remaining = misc[2];
    in_bin = misc[3];
    __syncthreads();
    if (remaining == in_bin) {  // every key of the bin: every key >= prefix
      cut.t = prefix;
      return cut;
    }
  }
  cut.t = prefix;
  cut.n_gt = kk - remaining;
  cut.need_eq = remaining;
  cut.ordered = true;
  return cut;
}

// A position's cursor: index in the chunk and lane offset in its window.
struct Cursor {
  int p;
  int o;
};

__device__ __forceinline__ void skip_empty(Cursor& c, const int* win_n,
                                           int n_pos) {
  while (c.p < n_pos && win_n[c.p] == 0) ++c.p;
}

__device__ __forceinline__ void advance(Cursor& c, const int* win_n,
                                        int n_pos) {
  if (c.p >= n_pos) return;
  c.o += PASS_LANES;
  if (c.o >= win_n[c.p] * TILE) {
    c.o = 0;
    ++c.p;
    skip_empty(c, win_n, n_pos);
  }
}

// One thread's lanes of one pass: lanes o + j A_THREADS + thread, so one
// warp instruction touches 32 consecutive lanes of one tile, whose slots
// ascend and are distinct: the adds' shared-memory accesses conflict the
// least a scatter can. Past the window a lane reads tile 0 again and is
// marked invalid, so the loads need no branch.
struct Lanes {
  int s[LANES];
  unsigned int v[LANES];  // f32 bits, bf16 bits, or the int8 value
  float sc[LANES];        // int8: the tile's scale
  bool valid[LANES];
};

template <int DTYPE>
__device__ __forceinline__ void load_lanes(
    Lanes& l, const Cursor& c, int n_pos, const int* win_tile,
    const int* win_n, const int* __restrict__ tile_slots,
    const void* __restrict__ tile_impacts,
    const float* __restrict__ tile_scales) {
  const int p = min(c.p, n_pos - 1);
  const int n_lanes = c.p < n_pos ? win_n[p] * TILE : 0;
  const int64_t base = static_cast<int64_t>(win_tile[p]) * TILE;
#pragma unroll
  for (int j = 0; j < LANES; ++j) {
    const int lane = c.o + j * A_THREADS + static_cast<int>(threadIdx.x);
    l.valid[j] = lane < n_lanes;
    const int64_t at = l.valid[j] ? base + lane : 0;
    l.s[j] = __ldg(tile_slots + at);
    if (DTYPE == 0) {
      l.v[j] = __float_as_uint(__ldg(static_cast<const float*>(tile_impacts)
                                     + at));
    } else if (DTYPE == 1) {
      l.v[j] = __ldg(static_cast<const unsigned short*>(tile_impacts) + at);
    } else {
      l.v[j] = static_cast<unsigned int>(
          __ldg(static_cast<const signed char*>(tile_impacts) + at));
      l.sc[j] = __ldg(tile_scales + at / TILE);
    }
  }
}

template <int DTYPE>
__device__ __forceinline__ void add_lanes(const Lanes& l, float boost, int lo,
                                          int width, float* scores,
                                          int* counts) {
#pragma unroll
  for (int j = 0; j < LANES; ++j) {
    const unsigned int local = static_cast<unsigned int>(l.s[j] - lo);
    if (l.valid[j] && l.s[j] >= 0 &&
        local < static_cast<unsigned int>(width)) {
      // bf16 bits are the high half of the f32's; int8 widens exactly
      const float imp =
          DTYPE == 0 ? __uint_as_float(l.v[j])
          : DTYPE == 1 ? __uint_as_float(l.v[j] << 16)
                       : __fmul_rn(static_cast<float>(static_cast<int>(l.v[j])),
                                   l.sc[j]);
      scores[local] = __fadd_rn(scores[local], __fmul_rn(imp, boost));
      counts[local] += 1;
    }
  }
}

// Each chunk position's window of its run's tiles touching [lo, hi): from
// the last tile whose first slot is <= lo (else the run's first) up to, not
// including, the first tile whose first slot is >= hi. `lpp` lanes a
// position probe lpp points of both intervals a step (an lpp-ary search),
// so a window costs about log_(lpp+1)(run tiles) dependent loads.
__device__ void find_windows(const int* __restrict__ runs, int64_t n_runs,
                             int c0, int n_pos,
                             const int* __restrict__ tile_first, int lo,
                             int hi, int* win_tile, int* win_n,
                             float* win_boost) {
  int lpp = 32;
  while (lpp > 1 && lpp * n_pos > A_THREADS) lpp >>= 1;
  const int lane = threadIdx.x & 31;
  const int j = lane & (lpp - 1), g0 = lane & ~(lpp - 1);
  const unsigned int gmask =
      lpp == 32 ? 0xFFFFFFFFu : ((1u << lpp) - 1u) << g0;
  for (int i = threadIdx.x / lpp; i < n_pos; i += A_THREADS / lpp) {
    const int e = c0 + i;
    const int first = __ldg(runs + e), end = first + __ldg(runs + n_runs + e);
    // the first tile whose first slot is > lo (a1) and >= hi (a2)
    int a1 = first, b1 = end, a2 = first, b2 = end;
    while (a1 < b1 || a2 < b2) {
      const int i1 = a1 + static_cast<int>(
          static_cast<int64_t>(b1 - a1) * (j + 1) / (lpp + 1));
      const int i2 = a2 + static_cast<int>(
          static_cast<int64_t>(b2 - a2) * (j + 1) / (lpp + 1));
      const bool p1 = a1 < b1 && __ldg(tile_first + i1) <= lo;
      const bool p2 = a2 < b2 && __ldg(tile_first + i2) < hi;
      const int c1 = __popc(__ballot_sync(gmask, p1) & gmask);
      const int c2 = __popc(__ballot_sync(gmask, p2) & gmask);
      // the answer lies after the c-th probe, up to the (c+1)-th
      const int x1 = __shfl_sync(gmask, i1, g0 + max(c1 - 1, 0));
      const int y1 = __shfl_sync(gmask, i1, g0 + min(c1, lpp - 1));
      const int x2 = __shfl_sync(gmask, i2, g0 + max(c2 - 1, 0));
      const int y2 = __shfl_sync(gmask, i2, g0 + min(c2, lpp - 1));
      if (a1 < b1) {
        if (c1 < lpp) b1 = y1;
        if (c1 > 0) a1 = x1 + 1;
      }
      if (a2 < b2) {
        if (c2 < lpp) b2 = y2;
        if (c2 > 0) a2 = x2 + 1;
      }
    }
    if (j == 0) {
      const int start = max(a1 - 1, first);
      win_tile[i] = start;
      win_n[i] = max(a2 - start, 0);
      win_boost[i] = __int_as_float(__ldg(runs + 2 * n_runs + e));
    }
  }
}

template <int DTYPE>
__global__ void __launch_bounds__(A_THREADS)
board_select_kernel(const int* __restrict__ pos_starts,
                    const int* __restrict__ runs, int64_t n_runs,
                    const int* __restrict__ required, int nq,
                    const int* __restrict__ tile_first,
                    const int* __restrict__ tile_slots,
                    const void* __restrict__ tile_impacts,
                    const float* __restrict__ tile_scales, int64_t n_slots,
                    int range_slots, int n_ranges, int k_range,
                    u64* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned int* hist = reinterpret_cast<unsigned int*>(smem);
  int* misc = reinterpret_cast<int*>(hist + 256);
  float* scores = reinterpret_cast<float*>(smem + HEAD_BYTES);
  int* counts = reinterpret_cast<int*>(scores + range_slots);
  int* win_tile = counts + range_slots;
  int* win_n = win_tile + POS_CHUNK;
  float* win_boost = reinterpret_cast<float*>(win_n + POS_CHUNK);

  const int q = static_cast<int>(blockIdx.x % nq);
  const int r = static_cast<int>(blockIdx.x / nq);
  const int64_t lo64 = static_cast<int64_t>(r) * range_slots;
  const int lo = static_cast<int>(lo64);
  const int width =
      static_cast<int>(min(static_cast<int64_t>(range_slots), n_slots - lo64));
  const int hi = lo + width;
  // zero both boards (2 R words, R a multiple of 32), 16 bytes a store
  for (int i = threadIdx.x; i < range_slots / 2; i += A_THREADS)
    reinterpret_cast<float4*>(scores)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int p0 = __ldg(pos_starts + q), p1 = __ldg(pos_starts + q + 1);
  for (int c0 = p0; c0 < p1; c0 += POS_CHUNK) {
    const int n_pos = min(POS_CHUNK, p1 - c0);
    __syncthreads();  // the board is zeroed, the last chunk walked
    find_windows(runs, n_runs, c0, n_pos, tile_first, lo, hi, win_tile, win_n,
                 win_boost);
    __syncthreads();
    Cursor use{0, 0};
    skip_empty(use, win_n, n_pos);
    Cursor ld = use;
    Lanes buf[DEPTH];
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) {
      load_lanes<DTYPE>(buf[i], ld, n_pos, win_tile, win_n, tile_slots,
                        tile_impacts, tile_scales);
      advance(ld, win_n, n_pos);
    }
    while (use.p < n_pos) {
#pragma unroll
      for (int i = 0; i < DEPTH; ++i) {
        if (use.p >= n_pos) break;
        add_lanes<DTYPE>(buf[i], win_boost[use.p], lo, width, scores, counts);
        const int was = use.p;
        advance(use, win_n, n_pos);
        load_lanes<DTYPE>(buf[i], ld, n_pos, win_tile, win_n, tile_slots,
                          tile_impacts, tile_scales);
        advance(ld, win_n, n_pos);
        // the next position adds to a slot only after this one has
        if (use.p != was) __syncthreads();
      }
    }
  }
  __syncthreads();

  // mask: a slot's key is its score's order-preserving bits, 0 if it
  // matched fewer than max(required, 1) positions (every slot past the
  // range's width counts 0)
  const int need = max(__ldg(required + q), 1);
  unsigned int* keys = reinterpret_cast<unsigned int*>(scores);
  for (int i = threadIdx.x; i < range_slots / 4; i += A_THREADS) {
    const float4 sv = reinterpret_cast<const float4*>(scores)[i];
    const int4 cv = reinterpret_cast<const int4*>(counts)[i];
    reinterpret_cast<uint4*>(keys)[i] = make_uint4(
        cv.x >= need ? mono(sv.x) : 0u, cv.y >= need ? mono(sv.y) : 0u,
        cv.z >= need ? mono(sv.z) : 0u, cv.w >= need ? mono(sv.w) : 0u);
  }
  __syncthreads();
  // the counts are dead: at R >= 4096 they hold a 12-bit digit's histogram
  const bool wide = range_slots >= HIST_BINS;
  const Cut<unsigned int> cut = select_cut<unsigned int, A_THREADS>(
      keys, width, k_range, wide ? 12 : 8, wide ? 10 : 8,
      wide ? reinterpret_cast<unsigned int*>(counts) : hist,
      reinterpret_cast<unsigned int*>(win_tile), A_LIST, misc);
  // the cut's keys in any order; when it splits the keys == t, those in
  // slot order after the keys > t
  u64* out = cand + (static_cast<int64_t>(q) * n_ranges + r) * k_range;
  if (threadIdx.x == 0) misc[6] = 0;
  __syncthreads();
  const uint4* keys4 = reinterpret_cast<const uint4*>(keys);
  for (int base = 0; base < range_slots / 4; base += A_THREADS) {
    const int i = base + threadIdx.x;
    const uint4 kv = i < range_slots / 4 ? keys4[i] : make_uint4(0, 0, 0, 0);
    const unsigned int kq[4] = {kv.x, kv.y, kv.z, kv.w};
    bool take[4];
    u64 key[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      take[u] = cut.ordered ? kq[u] > cut.t : kq[u] != 0 && kq[u] >= cut.t;
      key[u] = cand_key(kq[u], lo + 4 * i + u);
    }
    warp_append(take, key, out, misc + 6);
  }
  if (cut.ordered) {
    // each warp a run of slots: count its ties, then write them in order
    const int warp = threadIdx.x >> 5, n_warps = A_THREADS / 32;
    const int chunk = ((width + 32 * n_warps - 1) / (32 * n_warps)) * 32;
    const int w0 = min(warp * chunk, width), w1 = min(w0 + chunk, width);
    int n_e = 0;
    for (int s0 = w0; s0 < w1; s0 += 32) {
      const int s = s0 + (threadIdx.x & 31);
      n_e += __popc(__ballot_sync(0xFFFFFFFFu, s < w1 && keys[s] == cut.t));
    }
    if ((threadIdx.x & 31) == 0) misc[16 + warp] = n_e;
    __syncthreads();
    int off = 0;
    for (int w = 0; w < warp; ++w) off += misc[16 + w];
    for (int s0 = w0; s0 < w1; s0 += 32) {
      const int s = s0 + (threadIdx.x & 31);
      const bool eq = s < w1 && keys[s] == cut.t;
      const unsigned int be = __ballot_sync(0xFFFFFFFFu, eq);
      const int e = off + __popc(be & lanes_below());
      if (eq && e < cut.need_eq) out[cut.n_gt + e] = cand_key(cut.t, lo + s);
      off += __popc(be);
    }
  }
  for (int i = min(cut.matched, k_range) + threadIdx.x; i < k_range;
       i += A_THREADS)
    out[i] = 0;
}

__global__ void __launch_bounds__(B_THREADS)
merge_kernel(const u64* __restrict__ cand, int n_cand, int k, int sort_n,
             int sort_in_smem, u64* __restrict__ sort_scratch,
             float* __restrict__ vals, int* __restrict__ slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* misc = reinterpret_cast<int*>(smem + 256 * 4);
  unsigned int* hist = reinterpret_cast<unsigned int*>(smem + HEAD_BYTES);
  u64* list = reinterpret_cast<u64*>(hist + HIST_BINS);
  const int q = blockIdx.x;
  const u64* src = cand + static_cast<int64_t>(q) * n_cand;
  u64* buf = sort_in_smem ? list + B_LIST
                          : sort_scratch + static_cast<int64_t>(q) * sort_n;
  // the keys are unique, so the cut is unordered: exactly min(k, matched)
  // keys are >= t
  const Cut<u64> cut = select_cut<u64, B_THREADS>(src, n_cand, k, 12, 10,
                                                  hist, list, B_LIST, misc);
  const int kk = min(k, cut.matched);
  if (threadIdx.x == 0) misc[6] = 0;
  __syncthreads();
  constexpr int U = 4;
  for (int base = 0; base < n_cand; base += B_THREADS * U) {
    u64 key[U];
    bool take[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * B_THREADS + threadIdx.x;
      key[u] = i < n_cand ? src[i] : 0ull;
      take[u] = key[u] != 0 && key[u] >= cut.t;
    }
    warp_append(take, key, buf, misc + 6);
  }
  float* v = vals + static_cast<int64_t>(q) * k;
  int* s = slots + static_cast<int64_t>(q) * k;
  __syncthreads();
  if (kk <= RANK_SORT_MAX) {
    // a key's place is the count of keys above it (the keys are unique)
    for (int i = threadIdx.x; i < kk; i += B_THREADS) {
      const u64 x = buf[i];
      int rank = 0;
      for (int j = 0; j < kk; ++j) rank += buf[j] > x;
      v[rank] = unmono(static_cast<unsigned int>(x >> 32));
      s[rank] = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned int>(x));
    }
  } else {
    int n2 = 1;
    while (n2 < kk) n2 <<= 1;
    for (int i = kk + threadIdx.x; i < n2; i += B_THREADS) buf[i] = 0;
    __syncthreads();
    // bitonic sort, descending
    for (int size = 2; size <= n2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = threadIdx.x; i < n2 / 2; i += B_THREADS) {
          const int a = 2 * i - (i & (stride - 1)), b = a + stride;
          const u64 x = buf[a], y = buf[b];
          if (((a & size) == 0) ? x < y : x > y) {
            buf[a] = y;
            buf[b] = x;
          }
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < kk; i += B_THREADS) {
      const u64 key = buf[i];
      v[i] = unmono(static_cast<unsigned int>(key >> 32));
      s[i] = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned int>(key));
    }
  }
  for (int i = kk + threadIdx.x; i < k; i += B_THREADS) {
    v[i] = __int_as_float(static_cast<int>(0xFF800000u));  // -inf
    s[i] = -1;
  }
}

template <int DTYPE>
cudaError_t launch_a(int blocks, int smem, cudaStream_t stream,
                     const int* pos_starts, const int* runs, int64_t n_runs,
                     const int* required, int nq, const int* tile_first,
                     const int* tile_slots, const void* tile_impacts,
                     const float* tile_scales, int64_t n_slots, int range_slots,
                     int n_ranges, int k_range, u64* cand) {
  cudaError_t err = cudaFuncSetAttribute(
      board_select_kernel<DTYPE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  board_select_kernel<DTYPE><<<blocks, A_THREADS, smem, stream>>>(
      pos_starts, runs, n_runs, required, nq, tile_first, tile_slots,
      tile_impacts, tile_scales, n_slots, range_slots, n_ranges, k_range,
      cand);
  return counted(cudaGetLastError());
}

// The kernels' dynamic shared memory: kernel A's boards, windows and head;
// kernel B's head, histogram, list and (for a window past 16,384, not)
// sort buffer. `ops/bm25.py::kernel_smem` mirrors it for the logs.
void smem_sizes(int range_slots, long long sort_n, int sort_in_smem,
                long long* smem_a, long long* smem_b) {
  *smem_a = HEAD_BYTES + 8LL * range_slots + 12LL * POS_CHUNK;
  *smem_b = HEAD_BYTES + 4LL * HIST_BINS + 8LL * B_LIST +
            (sort_in_smem ? 8 * sort_n : 0);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The kernels launched so far by this library (both kernels, every call).
long long bm25_kernel_launches() { return g_launches.load(); }

// The two kernels of one batch on `stream`. dtype: 0 = f32, 1 = bf16, 2 =
// int8 impacts (tile_scales then required). pos_starts [nq + 1], runs [3,
// n_runs] (first tile, tile count, boost as f32 bits), required [nq],
// tile_first [T], tile_slots [T, 128] i32, tile_impacts [T, 128]: device.
// cand: u64 [nq, ceil(n_slots / range_slots) * min(k, range_slots)];
// sort_scratch: u64 [nq, pow2(k)] unless sort_in_smem; vals [nq, k] f32 and
// slots [nq, k] i32 out. Returns 0 or a cudaError_t code.
int bm25_board(const void* pos_starts, const void* runs, long long n_runs,
               const void* required, int nq, const void* tile_first,
               const void* tile_slots, const void* tile_impacts,
               const void* tile_scales, int dtype, long long n_slots,
               int range_slots, int k, void* cand, int sort_in_smem,
               void* sort_scratch, void* vals, void* slots,
               long long stream_handle) {
  if (dtype < 0 || dtype > 2 || (dtype == 2 && tile_scales == nullptr) ||
      nq < 1 || n_slots < 1 || n_slots > 0x7FFFFFFFLL || range_slots < 32 ||
      range_slots > RANGE_MAX || range_slots % 32 != 0 || k < 1 ||
      k > n_slots || (!sort_in_smem && sort_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_ranges = (n_slots + range_slots - 1) / range_slots;
  const int k_range = k < range_slots ? k : range_slots;
  const long long n_cand = n_ranges * k_range;
  long long sort_n = 1;
  while (sort_n < k) sort_n <<= 1;
  long long smem_a, smem_b;
  smem_sizes(range_slots, sort_n, sort_in_smem, &smem_a, &smem_b);
  if (smem_a > SMEM_MAX || smem_b > SMEM_MAX || n_cand > 0x7FFFFFFFLL ||
      n_ranges * nq > 0x7FFFFFFFLL || sort_n > 0x40000000LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_handle);
  const int blocks = static_cast<int>(n_ranges * nq);
  auto* ps = static_cast<const int*>(pos_starts);
  auto* rn = static_cast<const int*>(runs);
  auto* rq = static_cast<const int*>(required);
  auto* tf = static_cast<const int*>(tile_first);
  auto* ts = static_cast<const int*>(tile_slots);
  auto* sc = static_cast<const float*>(tile_scales);
  auto* cd = static_cast<u64*>(cand);
  const int nr = static_cast<int>(n_ranges);
  cudaError_t err =
      dtype == 0 ? launch_a<0>(blocks, smem_a, stream, ps, rn, n_runs, rq, nq,
                               tf, ts, tile_impacts, sc, n_slots, range_slots,
                               nr, k_range, cd)
      : dtype == 1 ? launch_a<1>(blocks, smem_a, stream, ps, rn, n_runs, rq,
                                 nq, tf, ts, tile_impacts, sc, n_slots,
                                 range_slots, nr, k_range, cd)
                   : launch_a<2>(blocks, smem_a, stream, ps, rn, n_runs, rq,
                                 nq, tf, ts, tile_impacts, sc, n_slots,
                                 range_slots, nr, k_range, cd);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<nq, B_THREADS, static_cast<int>(smem_b), stream>>>(
      cd, static_cast<int>(n_cand), k, static_cast<int>(sort_n), sort_in_smem,
      static_cast<u64*>(sort_scratch), static_cast<float*>(vals),
      static_cast<int*>(slots));
  return static_cast<int>(counted(cudaGetLastError()));
}

}  // extern "C"
