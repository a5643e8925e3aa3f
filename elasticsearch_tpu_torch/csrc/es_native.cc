// Host hot loops of the lexical search path (the port's copy of the
// reference's `es_bm25_score`, `es_intersect_i64`, `es_union_sum_i64` and
// `es_topk_f32`): fused BM25 term scoring, galloping sorted-set
// intersection (bool must), union with score summing (bool should) and
// partial top-k selection (search result ranking).
//
// Built by g++ with the reference's flags (-O3 -fPIC -shared -std=c++17:
// no FMA contraction), so the f32 roundings equal the reference's, and
// bound through ctypes (`native/__init__.py`). Every function is
// allocation-free but es_topk_f32: callers pass numpy-owned buffers.

#include <algorithm>
#include <cstdint>

extern "C" {

// Fused BM25: score[i] = boost * idf * (k1+1) * f / (f + k1*(1-b+b*len/avg))
// (reference formula: LuceneBM25Similarity; queries.py:137 numpy version)
void es_bm25_score(const int32_t* freqs, const float* lengths, int64_t n,
                   float idf, float avg_len, float k1, float b, float boost,
                   float* out) {
    const float scale = boost * idf * (k1 + 1.0f);
    const float one_minus_b = 1.0f - b;
    const float b_over_avg = avg_len > 0.0f ? b / avg_len : 0.0f;
    for (int64_t i = 0; i < n; ++i) {
        const float f = static_cast<float>(freqs[i]);
        const float norm = k1 * (one_minus_b + b_over_avg * lengths[i]);
        out[i] = scale * f / (f + norm);
    }
}

// Galloping intersection of two sorted unique int64 arrays. Writes the
// matching *positions* in a and b (so callers gather scores), returns the
// match count. Gallops from the smaller array like Lucene's
// ConjunctionDISI advance().
int64_t es_intersect_i64(const int64_t* a, int64_t na,
                         const int64_t* b, int64_t nb,
                         int64_t* out_ia, int64_t* out_ib) {
    if (na > nb)  // always gallop through the longer array
        return es_intersect_i64(b, nb, a, na, out_ib, out_ia);
    int64_t count = 0;
    int64_t j = 0;
    for (int64_t i = 0; i < na && j < nb; ++i) {
        const int64_t target = a[i];
        // gallop: double the step until we overshoot, then binary search
        int64_t step = 1;
        int64_t lo = j;
        while (j + step < nb && b[j + step] < target) {
            lo = j + step;
            step <<= 1;
        }
        int64_t hi = std::min(j + step, nb - 1);
        if (b[hi] < target) { j = nb; break; }
        const int64_t* pos = std::lower_bound(b + lo, b + hi + 1, target);
        j = pos - b;
        if (j < nb && b[j] == target) {
            out_ia[count] = i;
            out_ib[count] = j;
            ++count;
            ++j;
        }
    }
    return count;
}

// Union of two sorted unique int64 arrays with score summing (the SHOULD
// accumulation in bool queries). Returns merged length. Output buffers must
// hold na+nb entries. Null score inputs are treated as all-zero.
int64_t es_union_sum_i64(const int64_t* a, const float* sa, int64_t na,
                         const int64_t* b, const float* sb, int64_t nb,
                         int64_t* out_rows, float* out_scores) {
    int64_t i = 0, j = 0, count = 0;
    while (i < na || j < nb) {
        if (j >= nb || (i < na && a[i] < b[j])) {
            out_rows[count] = a[i];
            out_scores[count] = sa ? sa[i] : 0.0f;
            ++i;
        } else if (i >= na || b[j] < a[i]) {
            out_rows[count] = b[j];
            out_scores[count] = sb ? sb[j] : 0.0f;
            ++j;
        } else {
            out_rows[count] = a[i];
            out_scores[count] = (sa ? sa[i] : 0.0f) + (sb ? sb[j] : 0.0f);
            ++i;
            ++j;
        }
        ++count;
    }
    return count;
}

// Partial top-k selection: indices of the k largest scores, ordered by
// (score desc, index asc) — the tie-break SearchPhaseController.mergeTopDocs
// uses (shard/doc order). Min-heap of k entries, one pass, O(n log k).
int64_t es_topk_f32(const float* scores, int64_t n, int64_t k,
                    int32_t* out_idx) {
    if (k <= 0 || n <= 0) return 0;
    if (k > n) k = n;
    // heap entries: (score, idx); `better` orders by (score desc, idx asc),
    // so under std::*_heap the top is the WORST retained element
    struct Entry { float s; int32_t i; };
    auto better = [](const Entry& x, const Entry& y) {
        if (x.s != y.s) return x.s > y.s;
        return x.i < y.i;
    };
    Entry* heap = new Entry[k];
    int64_t size = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float s = scores[i];
        if (size < k) {
            heap[size++] = {s, static_cast<int32_t>(i)};
            std::push_heap(heap, heap + size, better);
        } else if (s > heap[0].s) {
            // ties keep the incumbent: the scan is index-ascending, so the
            // newcomer's larger index loses the (score desc, idx asc) order
            std::pop_heap(heap, heap + k, better);
            heap[k - 1] = {s, static_cast<int32_t>(i)};
            std::push_heap(heap, heap + k, better);
        }
    }
    std::sort_heap(heap, heap + size, better);  // best-first under `better`
    for (int64_t r = 0; r < size; ++r)
        out_idx[r] = heap[r].i;
    delete[] heap;
    return size;
}

}  // extern "C"
