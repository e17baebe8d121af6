// Native host-side graph preprocessing.
//
// The reference delegates all native work to prebuilt CUDA kernels in its
// pip deps (SURVEY.md section 2: dgl/torch_sparse/torch_scatter); its own
// repo ships no native code. This framework's device compute is XLA; the
// native layer lives on the HOST side of the pipeline, where graph
// preparation is genuinely hot for production-scale graphs:
//
//   - ring_buckets: double-bucket edges by (dst_shard, src_shard) for the
//     ring-overlapped distributed SpMM (parallel/distributed.py)
//   - edge_graph_pairs: the edge-graph expansion of linkpred/edge_lp.py
//
// Exposed through a plain C ABI consumed via ctypes (no pybind11 needed).
// Build: `make -C <package>/native` (or the auto-build in
// native/__init__.py). Python fallbacks remain available.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Max bucket size over the (dst_shard, src_shard) grid.
int64_t ring_max_bucket(const int64_t* senders, const int64_t* receivers,
                        int64_t n_edge, int64_t rows_per_shard,
                        int64_t n_shards) {
  std::vector<int64_t> counts(n_shards * n_shards, 0);
  for (int64_t i = 0; i < n_edge; ++i) {
    int64_t k = receivers[i] / rows_per_shard;
    int64_t j = senders[i] / rows_per_shard;
    counts[k * n_shards + j]++;
  }
  return *std::max_element(counts.begin(), counts.end());
}

// Fill [S, S, e_bucket] ring buckets with LOCAL indices; padding zeroed by
// the caller. Layout row-major (k, j, slot).
void ring_buckets(const int64_t* senders, const int64_t* receivers,
                  const float* weights, int64_t n_edge,
                  int64_t rows_per_shard, int64_t n_shards, int64_t e_bucket,
                  int32_t* out_senders_local, int32_t* out_recv_local,
                  float* out_w) {
  std::vector<int64_t> fill(n_shards * n_shards, 0);
  for (int64_t i = 0; i < n_edge; ++i) {
    int64_t k = receivers[i] / rows_per_shard;
    int64_t j = senders[i] / rows_per_shard;
    int64_t slot = fill[k * n_shards + j]++;
    int64_t base = (k * n_shards + j) * e_bucket + slot;
    out_senders_local[base] = (int32_t)(senders[i] - j * rows_per_shard);
    out_recv_local[base] = (int32_t)(receivers[i] - k * rows_per_shard);
    out_w[base] = weights[i];
  }
}

// ---- edge-graph expansion (linkpred/edge_lp.py:build_edge_graph) --------
//
// Two scored edges are adjacent iff they share an endpoint; per node the
// incident edge set (optionally uniformly subsampled to max_degree with a
// splitmix-style per-node generator) expands to all ordered distinct
// pairs. Python/numpy is the fallback; this path exists because the
// expansion is pure memory streaming that numpy does ~100x slower than C
// on some hosts.

static inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// Pass 1: number of ordered distinct pairs (excl. self loops) with the cap
// applied. max_degree <= 0 means uncapped.
int64_t edge_graph_num_pairs(const int64_t* src, const int64_t* dst,
                             int64_t m, int64_t max_degree) {
  int64_t n = 0;
  for (int64_t i = 0; i < m; ++i) {
    if (src[i] + 1 > n) n = src[i] + 1;
    if (dst[i] + 1 > n) n = dst[i] + 1;
  }
  std::vector<int64_t> counts(n, 0);
  for (int64_t i = 0; i < m; ++i) { counts[src[i]]++; counts[dst[i]]++; }
  int64_t pairs = 0;
  for (int64_t v = 0; v < n; ++v) {
    int64_t k = counts[v];
    if (max_degree > 0 && k > max_degree) k = max_degree;
    pairs += k * (k - 1);
  }
  return pairs;
}

// Pass 2: fill out_a/out_b (int64[m + n_pairs]) with m self loops followed
// by the pair expansion; returns the number of entries actually written
// (m + true pairs — edge_graph_num_pairs is an upper bound: a scored
// self-edge occupies two slots of its node's incidence list but must not
// pair with itself). int64 output and in-C self loops keep the Python
// side free of numpy copies.
int64_t edge_graph_pairs(const int64_t* src, const int64_t* dst, int64_t m,
                         int64_t max_degree, uint64_t seed, int64_t* out_a,
                         int64_t* out_b) {
  for (int64_t i = 0; i < m; ++i) { out_a[i] = i; out_b[i] = i; }
  out_a += m;
  out_b += m;
  int64_t n = 0;
  for (int64_t i = 0; i < m; ++i) {
    if (src[i] + 1 > n) n = src[i] + 1;
    if (dst[i] + 1 > n) n = dst[i] + 1;
  }
  std::vector<int64_t> row_ptr(n + 1, 0);
  for (int64_t i = 0; i < m; ++i) { row_ptr[src[i] + 1]++; row_ptr[dst[i] + 1]++; }
  for (int64_t v = 0; v < n; ++v) row_ptr[v + 1] += row_ptr[v];
  std::vector<int32_t> inc(row_ptr[n]);
  std::vector<int64_t> cur(row_ptr.begin(), row_ptr.end() - 1);
  for (int64_t i = 0; i < m; ++i) {
    inc[cur[src[i]]++] = (int32_t)i;
    inc[cur[dst[i]]++] = (int32_t)i;
  }
  int64_t p = 0;
  std::vector<int32_t> grp;
  for (int64_t v = 0; v < n; ++v) {
    int64_t k = row_ptr[v + 1] - row_ptr[v];
    int32_t* g = inc.data() + row_ptr[v];
    if (max_degree > 0 && k > max_degree) {
      // partial Fisher-Yates with a per-(seed, node) generator: the first
      // max_degree slots become a uniform sample without replacement
      uint64_t s = mix64(seed ^ (uint64_t)v * 0x9e3779b97f4a7c15ULL);
      for (int64_t t = 0; t < max_degree; ++t) {
        s = mix64(s);
        int64_t j = t + (int64_t)(s % (uint64_t)(k - t));
        std::swap(g[t], g[j]);
      }
      k = max_degree;
    }
    for (int64_t i = 0; i < k; ++i) {
      int32_t a = g[i];
      for (int64_t j = 0; j < k; ++j) {
        // compare VALUES: a scored self-edge (u == v) sits twice in its
        // node's incidence list and must not pair with itself
        if (a == g[j]) continue;
        out_a[p] = a;
        out_b[p] = g[j];
        ++p;
      }
    }
  }
  return m + p;
}

}  // extern "C"
