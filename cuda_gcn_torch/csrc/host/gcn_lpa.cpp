// Native label-propagation for the locality reorder (data/reorder.py).
//
// TPU-framework preprocessing component: the LPA rounds that concentrate graph
// communities into contiguous id ranges (feeding the bsr graphsum backend's
// tile selection) are O(rounds * E log deg) and take ~75 s in numpy at ~90M
// edges; this multithreaded C++ version does the same work in seconds. The
// semantics match cuda_gcn_tpu.data.reorder.label_propagation EXACTLY so
// cached permutations stay valid:
//   * synchronous rounds: every node adopts the modal label among its CSR
//     neighbors (self-loops and duplicate edges count with multiplicity);
//   * ties break toward the SMALLEST label;
//   * nodes with empty rows keep their label;
//   * early exit when a round changes nothing.
//
// No reference-code lineage: the reference has no reordering at all (its GPU
// kernels gather per edge regardless of layout; see SURVEY.md §2.3).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void propagate_rows(const int64_t* indptr, const int32_t* indices,
                    const int64_t* labels, int64_t* next, int64_t row_lo,
                    int64_t row_hi, std::atomic<int64_t>* changed) {
    std::vector<int64_t> scratch;
    int64_t local_changed = 0;
    for (int64_t i = row_lo; i < row_hi; ++i) {
        const int64_t beg = indptr[i], end = indptr[i + 1];
        if (beg == end) {
            next[i] = labels[i];
            continue;
        }
        scratch.clear();
        scratch.reserve(static_cast<size_t>(end - beg));
        for (int64_t e = beg; e < end; ++e) scratch.push_back(labels[indices[e]]);
        std::sort(scratch.begin(), scratch.end());
        // scan runs ascending: strictly-greater count wins -> smallest label on tie
        int64_t best_label = scratch[0], best_count = 0;
        size_t r = 0;
        while (r < scratch.size()) {
            size_t r2 = r;
            while (r2 < scratch.size() && scratch[r2] == scratch[r]) ++r2;
            const int64_t count = static_cast<int64_t>(r2 - r);
            if (count > best_count) {
                best_count = count;
                best_label = scratch[r];
            }
            r = r2;
        }
        next[i] = best_label;
        if (best_label != labels[i]) ++local_changed;
    }
    changed->fetch_add(local_changed, std::memory_order_relaxed);
}

}  // namespace

extern "C" {

// Runs <= rounds synchronous LPA rounds over the CSR graph, updating `labels`
// (length n, caller-initialized — arange for a fresh run, or seed labels) in
// place. Returns the number of rounds actually executed (early exit on
// fixpoint), or -1 on invalid arguments.
int64_t gcn_lpa(const int64_t* indptr, const int32_t* indices, int64_t n,
                int32_t rounds, int64_t* labels) {
    if (n < 0 || rounds < 0 || !indptr || !labels || (!indices && indptr[n] > 0))
        return -1;
    if (n == 0) return 0;
    std::vector<int64_t> next(static_cast<size_t>(n));
    unsigned hw = std::thread::hardware_concurrency();
    const int64_t n_threads = std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1, n));
    int64_t done = 0;
    for (int32_t round = 0; round < rounds; ++round) {
        std::atomic<int64_t> changed{0};
        if (n_threads == 1) {
            propagate_rows(indptr, indices, labels, next.data(), 0, n, &changed);
        } else {
            std::vector<std::thread> workers;
            workers.reserve(static_cast<size_t>(n_threads));
            const int64_t chunk = (n + n_threads - 1) / n_threads;
            for (int64_t t = 0; t < n_threads; ++t) {
                const int64_t lo = t * chunk;
                const int64_t hi = std::min(n, lo + chunk);
                if (lo >= hi) break;
                workers.emplace_back(propagate_rows, indptr, indices, labels,
                                     next.data(), lo, hi, &changed);
            }
            for (auto& w : workers) w.join();
        }
        ++done;
        if (changed.load(std::memory_order_relaxed) == 0) break;  // fixpoint
        std::memcpy(labels, next.data(), static_cast<size_t>(n) * sizeof(int64_t));
    }
    return done;
}

}  // extern "C"
