// CSR matrix-graph construction kernels (host-native).
//
// Parity: the reference builds its sparse-matrix graph in C++
// (src/linalg/sparse_matrix.cpp GomaSparseMatrix_SetProblemGraph / create_graph)
// from node-node connectivity. Here the graph is the sorted unique set of
// (row*n + col) keys from all element dof cross-products; the hot primitive
// is a parallel sort + unique over hundreds of millions of int64 keys for
// production meshes, which numpy does single-threaded with an extra copy.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

void merge_ranges(int64_t *keys, std::vector<int64_t> &bounds) {
  // repeatedly inplace_merge adjacent sorted ranges (log passes)
  while (bounds.size() > 2) {
    std::vector<int64_t> next;
    next.push_back(bounds.front());
    std::vector<std::thread> ts;
    for (size_t i = 0; i + 2 < bounds.size(); i += 2) {
      int64_t a = bounds[i], b = bounds[i + 1], c = bounds[i + 2];
      ts.emplace_back([keys, a, b, c]() {
        std::inplace_merge(keys + a, keys + b, keys + c);
      });
      next.push_back(c);
    }
    if (bounds.size() % 2 == 0) // odd number of ranges: last one passes through
      next.push_back(bounds.back());
    for (auto &t : ts) t.join();
    bounds = next;
  }
}

} // namespace

extern "C" {

// Sort keys ascending (parallel) and deduplicate in place; returns the
// number of unique keys.
int64_t sort_unique_i64(int64_t *keys, int64_t n, int nthreads) {
  if (n <= 0) return 0;
  int T = nthreads > 0 ? nthreads
                       : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if (n < (int64_t)T * 4096) T = 1;

  std::vector<int64_t> bounds;
  bounds.push_back(0);
  for (int t = 0; t < T; t++)
    bounds.push_back(n * (int64_t)(t + 1) / T);

  std::vector<std::thread> ts;
  for (int t = 0; t < T; t++) {
    int64_t a = bounds[t], b = bounds[t + 1];
    ts.emplace_back([keys, a, b]() { std::sort(keys + a, keys + b); });
  }
  for (auto &t : ts) t.join();
  merge_ranges(keys, bounds);

  int64_t m = (int64_t)(std::unique(keys, keys + n) - keys);
  return m;
}

// out[i] = lower_bound index of q[i] in sorted[0..n)
void searchsorted_i64(const int64_t *sorted, int64_t n, const int64_t *q,
                      int64_t nq, int64_t *out, int nthreads) {
  int T = nthreads > 0 ? nthreads
                       : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if (nq < (int64_t)T * 4096) T = 1;
  std::vector<std::thread> ts;
  for (int t = 0; t < T; t++) {
    int64_t a = nq * (int64_t)t / T, b = nq * (int64_t)(t + 1) / T;
    ts.emplace_back([=]() {
      for (int64_t i = a; i < b; i++)
        out[i] = (int64_t)(std::lower_bound(sorted, sorted + n, q[i]) - sorted);
    });
  }
  for (auto &t : ts) t.join();
}

} // extern "C"
