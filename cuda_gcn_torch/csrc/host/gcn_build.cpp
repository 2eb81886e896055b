// Native graph-build steps of cuda_gcn_torch/data/graph.py at 2M edges and
// more (NATIVE_BUILD_MIN_NNZ), the port's copy of the root csrc/gcn_build.cpp.
// Semantics are bit-exact with the numpy implementations
// (tests/test_torch_native.py):
//   * normalization: 1/sqrt(rowlen(src)*rowlen(dst)) computed in double,
//     rounded once to f32 (matches numpy float64 -> astype(float32));
//   * transpose: stable counting sort by dst (matches np.argsort(dst,
//     kind='stable'));
//   * tile selection: histogram -> candidates >= min_edges -> stable
//     densest-first cap -> ascending id order -> optional pair closure, and
//     each edge's tile rank. Unlike the root copy it writes no tiles: the port
//     scatters them straight into device memory, so selection does not depend
//     on the tile dtype.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared, at first use, into build/native/
// (cuda_gcn_torch/data/native.py).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <vector>

extern "C" {

// out_coef: malloc'd [nnz] f32. Returns 0 on success.
int gcn_norm_coef(const int64_t* indptr, const int64_t* indices, int64_t n,
                  float** out_coef) {
  const int64_t nnz = indptr[n];
  float* coef = static_cast<float*>(malloc(sizeof(float) * (size_t)nnz));
  if (!coef) return 1;
  std::vector<double> deg((size_t)n);
  for (int64_t i = 0; i < n; ++i) deg[(size_t)i] = (double)(indptr[i + 1] - indptr[i]);
  for (int64_t i = 0; i < n; ++i) {
    const double ds = deg[(size_t)i];
    for (int64_t e = indptr[i]; e < indptr[i + 1]; ++e) {
      const double dd = deg[(size_t)indices[e]];
      coef[e] = (float)(1.0 / std::sqrt(ds * dd));
    }
  }
  *out_coef = coef;
  return 0;
}

// Stable counting sort of a COO by dst. Outputs malloc'd arrays:
// t_src = dst sorted ascending, t_dst = matching src, t_coef = matching coef.
int gcn_transpose_coo(const int64_t* src, const int64_t* dst, const float* coef,
                      int64_t nnz, int64_t n,
                      int64_t** t_src, int64_t** t_dst, float** t_coef) {
  int64_t* ts = static_cast<int64_t*>(malloc(sizeof(int64_t) * (size_t)nnz));
  int64_t* td = static_cast<int64_t*>(malloc(sizeof(int64_t) * (size_t)nnz));
  float* tc = static_cast<float*>(malloc(sizeof(float) * (size_t)nnz));
  if (!ts || !td || !tc) { free(ts); free(td); free(tc); return 1; }
  std::vector<int64_t> pos((size_t)n + 1, 0);
  for (int64_t e = 0; e < nnz; ++e) pos[(size_t)dst[e] + 1]++;
  for (int64_t i = 0; i < n; ++i) pos[(size_t)i + 1] += pos[(size_t)i];
  for (int64_t e = 0; e < nnz; ++e) {  // forward pass => stable
    const int64_t p = pos[(size_t)dst[e]]++;
    ts[p] = dst[e];
    td[p] = src[e];
    tc[p] = coef[e];
  }
  *t_src = ts;
  *t_dst = td;
  *t_coef = tc;
  return 0;
}

// Densest-tile selection without materialization (the port scatters the
// tiles on the device, cuda_gcn_torch/data/graph.py): histogram of edges per
// [tb, tb] block -> candidates with >= min_edges edges -> stable densest-first
// cap at max_tiles (count desc, id asc) -> ascending id order -> with
// pair_close, drop an off-diagonal tile whose mirror (J, I) did not survive
// the cap, so a symmetric graph keeps a symmetric residual. ids_out: malloc'd
// [k] int64 tile ids (block row * T + block col, ascending); rank_out:
// malloc'd [nnz] int32, each edge's tile rank in ids_out, or -1 for an edge
// left to the residual. Returns 0 on success.
int gcn_select_tiles(const int64_t* src, const int64_t* dst, int64_t nnz, int64_t n,
                     int64_t tb, int64_t min_edges, int64_t max_tiles, int pair_close,
                     int64_t** ids_out, int64_t* k_out, int32_t** rank_out) {
  if (tb <= 0 || n < 0 || nnz < 0) return 2;
  const int64_t t_blocks = (n + tb - 1) / tb;
  const int64_t n_tiles = t_blocks * t_blocks;
  // tb is 2^k in practice: divisions by a runtime value cost ~87M idivs per
  // pass here; use shifts when possible
  const bool pow2 = (tb & (tb - 1)) == 0;
  const int sh = pow2 ? __builtin_ctzll((uint64_t)tb) : 0;
  auto div_tb = [&](int64_t v) { return pow2 ? (v >> sh) : (v / tb); };
  std::vector<int32_t> counts((size_t)n_tiles, 0);
  for (int64_t e = 0; e < nnz; ++e)
    counts[(size_t)(div_tb(src[e]) * t_blocks + div_tb(dst[e]))]++;

  std::vector<int64_t> cand;
  for (int64_t t = 0; t < n_tiles; ++t)
    if (counts[(size_t)t] >= min_edges) cand.push_back(t);
  if ((int64_t)cand.size() > max_tiles) {
    std::stable_sort(cand.begin(), cand.end(), [&](int64_t a, int64_t b) {
      return counts[(size_t)a] > counts[(size_t)b];
    });
    cand.resize((size_t)std::max<int64_t>(max_tiles, 0));
    std::sort(cand.begin(), cand.end());
  }
  if (pair_close) {
    std::vector<int64_t> closed;
    closed.reserve(cand.size());
    for (const int64_t t : cand) {
      const int64_t mirror = (t % t_blocks) * t_blocks + t / t_blocks;
      if (std::binary_search(cand.begin(), cand.end(), mirror)) closed.push_back(t);
    }
    cand.swap(closed);
  }
  const int64_t k = (int64_t)cand.size();

  int64_t* ids = static_cast<int64_t*>(malloc(sizeof(int64_t) * ((size_t)k ? (size_t)k : 1)));
  int32_t* rank = static_cast<int32_t*>(malloc(sizeof(int32_t) * ((size_t)nnz ? (size_t)nnz : 1)));
  if (!ids || !rank) {
    free(ids); free(rank);
    return 1;
  }
  std::vector<int32_t> rank_of((size_t)n_tiles, -1);
  for (int64_t i = 0; i < k; ++i) {
    ids[i] = cand[(size_t)i];
    rank_of[(size_t)cand[(size_t)i]] = (int32_t)i;
  }
  for (int64_t e = 0; e < nnz; ++e)
    rank[e] = rank_of[(size_t)(div_tb(src[e]) * t_blocks + div_tb(dst[e]))];
  *ids_out = ids;
  *k_out = k;
  *rank_out = rank;
  return 0;
}

void gcn_build_free(void* p) { free(p); }

}  // extern "C"
