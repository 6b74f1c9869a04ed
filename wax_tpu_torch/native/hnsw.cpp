// Verbatim copy of wax_tpu/native/hnsw.cpp, built by wax_tpu_torch/native/build.py. Keep the two in step.
// Native HNSW graph builder.
//
// The TPU build's counterpart of the reference's USearch C++ HNSW engine
// (reference: Sources/WaxVectorSearch/USearchVectorEngine.swift wrapping the USearch
// C++ library — connectivity M=16, upsert = remove-then-add, reserve doubling).
// Construction is inherently sequential pointer-chasing work, so it lives in C++ on
// the host; *queries* run on TPU over the exported padded adjacency
// (wax_tpu/ops/beam_search.py). Exposed as a plain C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libwaxhnsw.so hnsw.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Pair {
  float sim;
  int32_t node;
};
struct SimLess {
  bool operator()(const Pair& a, const Pair& b) const { return a.sim < b.sim; }
};
struct SimGreater {
  bool operator()(const Pair& a, const Pair& b) const { return a.sim > b.sim; }
};

struct Hnsw {
  int dim;
  int m;
  int m0;
  int efc;
  double ml;
  bool normalize;
  std::mt19937_64 rng;
  std::uniform_real_distribution<double> uni{0.0, 1.0};

  std::vector<float> vecs;          // count * dim
  std::vector<int64_t> frame_ids;   // count
  std::vector<uint8_t> active;      // count
  std::vector<int32_t> levels;      // count
  // neighbors[level] : node -> vector<int32>
  std::vector<std::unordered_map<int32_t, std::vector<int32_t>>> neighbors;
  std::unordered_map<int64_t, int32_t> row_of;
  int32_t entry = -1;
  int32_t max_level = -1;
  int64_t generation = 0;

  bool extend_candidates = false;  // HNSW paper alg. 4 option (see add())

  Hnsw(int dim_, int m_, int efc_, uint64_t seed, bool norm)
      : dim(dim_), m(m_), m0(2 * m_), efc(efc_), ml(1.0 / std::log((double)m_)),
        normalize(norm), rng(seed) {
    neighbors.resize(1);
  }

  inline const float* vec(int32_t row) const { return vecs.data() + (size_t)row * dim; }

  inline float sim(const float* __restrict a, const float* __restrict b) const {
    // four accumulators so the compiler can vectorize the reduction
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int i = 0;
    for (; i + 4 <= dim; i += 4) {
      s0 += a[i] * b[i];
      s1 += a[i + 1] * b[i + 1];
      s2 += a[i + 2] * b[i + 2];
      s3 += a[i + 3] * b[i + 3];
    }
    for (; i < dim; ++i) s0 += a[i] * b[i];
    return (s0 + s1) + (s2 + s3);
  }

  std::vector<Pair> search_layer(const float* q, const std::vector<int32_t>& entries,
                                 int ef, int level) {
    auto& neigh = neighbors[level];
    std::unordered_set<int32_t> visited(entries.begin(), entries.end());
    std::priority_queue<Pair, std::vector<Pair>, SimLess> cand;     // max-sim first
    std::priority_queue<Pair, std::vector<Pair>, SimGreater> best;  // min-sim top
    for (int32_t e : entries) {
      float s = sim(q, vec(e));
      cand.push({s, e});
      best.push({s, e});
    }
    while ((int)best.size() > ef) best.pop();
    while (!cand.empty()) {
      Pair c = cand.top();
      cand.pop();
      if ((int)best.size() >= ef && c.sim < best.top().sim) break;
      auto it = neigh.find(c.node);
      if (it == neigh.end()) continue;
      const auto& nbrs = it->second;
      // prefetch neighbor vectors ahead of the distance loop (scattered reads are
      // DRAM-latency bound otherwise)
      for (int32_t nb : nbrs) {
        if (active[nb] && !visited.count(nb)) {
          const char* p = (const char*)vec(nb);
          for (int off = 0; off < dim * (int)sizeof(float); off += 64)
            __builtin_prefetch(p + off, 0, 1);
        }
      }
      for (int32_t nb : nbrs) {
        if (!active[nb] || visited.count(nb)) continue;
        visited.insert(nb);
        float s = sim(q, vec(nb));
        if ((int)best.size() < ef || s > best.top().sim) {
          cand.push({s, nb});
          best.push({s, nb});
          if ((int)best.size() > ef) best.pop();
        }
      }
    }
    std::vector<Pair> out;
    out.reserve(best.size());
    while (!best.empty()) {
      out.push_back(best.top());
      best.pop();
    }
    std::sort(out.begin(), out.end(), [](const Pair& a, const Pair& b) { return a.sim > b.sim; });
    return out;
  }

  // HNSW paper alg. 4: diversity-pruned neighbor selection
  std::vector<int32_t> select_neighbors(const std::vector<Pair>& cands, int mm) {
    std::vector<int32_t> out;
    for (const Pair& c : cands) {
      if ((int)out.size() >= mm) break;
      bool ok = true;
      for (int32_t chosen : out) {
        if (sim(vec(c.node), vec(chosen)) > c.sim) {
          ok = false;
          break;
        }
      }
      if (ok) out.push_back(c.node);
    }
    if ((int)out.size() < mm) {
      for (const Pair& c : cands) {
        if ((int)out.size() >= mm) break;
        if (std::find(out.begin(), out.end(), c.node) == out.end()) out.push_back(c.node);
      }
    }
    return out;
  }

  void link(int32_t a, int32_t b, int level) {
    auto& neigh = neighbors[level];
    int cap = level == 0 ? m0 : m;
    int32_t xs[2] = {a, b}, ys[2] = {b, a};
    for (int t = 0; t < 2; ++t) {
      auto& lst = neigh[xs[t]];
      if (std::find(lst.begin(), lst.end(), ys[t]) != lst.end()) continue;
      lst.push_back(ys[t]);
      if ((int)lst.size() > cap) {
        // prune with the diversity heuristic, NOT plain most-similar: keeping only
        // the closest neighbors severs long-range links and detaches cluster islands
        const float* xv = vec(xs[t]);
        std::vector<Pair> scored;
        scored.reserve(lst.size());
        for (int32_t n : lst) scored.push_back({sim(xv, vec(n)), n});
        std::sort(scored.begin(), scored.end(),
                  [](const Pair& p, const Pair& q2) { return p.sim > q2.sim; });
        lst = select_neighbors(scored, cap);
      }
    }
  }

  void add(int64_t fid, const float* v_in) {
    auto old = row_of.find(fid);
    if (old != row_of.end()) remove(fid);
    std::vector<float> v(v_in, v_in + dim);
    if (normalize) {
      float n = 0.f;
      for (float x : v) n += x * x;
      n = std::sqrt(n);
      if (n > 0) for (float& x : v) x /= n;
    }
    int32_t row = (int32_t)frame_ids.size();
    vecs.insert(vecs.end(), v.begin(), v.end());
    frame_ids.push_back(fid);
    active.push_back(1);
    row_of[fid] = row;

    int level = (int)(-std::log(std::max(uni(rng), 1e-12)) * ml);
    levels.push_back(level);
    while ((int)neighbors.size() <= level) neighbors.emplace_back();

    if (entry < 0) {
      entry = row;
      max_level = level;
      ++generation;
      return;
    }

    int32_t cur = entry;
    for (int lvl = max_level; lvl > level; --lvl) {
      bool improved = true;
      float cur_sim = sim(v.data(), vec(cur));
      while (improved) {
        improved = false;
        auto it = neighbors[lvl].find(cur);
        if (it == neighbors[lvl].end()) break;
        for (int32_t nb : it->second) {
          if (!active[nb]) continue;
          float s = sim(v.data(), vec(nb));
          if (s > cur_sim) {
            cur = nb;
            cur_sim = s;
            improved = true;
          }
        }
      }
    }

    std::vector<int32_t> entries{cur};
    for (int lvl = std::min(level, (int)max_level); lvl >= 0; --lvl) {
      auto cands = search_layer(v.data(), entries, efc, lvl);
      if (extend_candidates) {
        // HNSW paper alg. 4 option: extend the working set with candidates'
        // neighbors before the diversity prune — helps tight-cluster regimes where
        // efConstruction search surfaces only one basin.
        std::unordered_set<int32_t> seen;
        for (const Pair& c : cands) seen.insert(c.node);
        auto& neigh = neighbors[lvl];
        std::vector<Pair> extended = cands;
        for (const Pair& c : cands) {
          auto it = neigh.find(c.node);
          if (it == neigh.end()) continue;
          for (int32_t nb : it->second) {
            if (!active[nb] || seen.count(nb)) continue;
            seen.insert(nb);
            extended.push_back({sim(v.data(), vec(nb)), nb});
          }
        }
        std::sort(extended.begin(), extended.end(),
                  [](const Pair& a, const Pair& b) { return a.sim > b.sim; });
        cands.swap(extended);
      }
      int mm = lvl == 0 ? m0 : m;
      for (int32_t nb : select_neighbors(cands, mm)) link(row, nb, lvl);
      entries.clear();
      for (int i = 0; i < (int)cands.size() && i < m; ++i) entries.push_back(cands[i].node);
      if (entries.empty()) entries.push_back(cur);
    }

    if (level > max_level) {
      max_level = level;
      entry = row;
    }
    ++generation;
  }

  // Classic HNSW search (paper alg. 5): greedy descent from the entry point, then
  // an ef-bounded best-first pass over level 0. Used by the construction-parity
  // harness so our graph and the reference-style comparator graph are evaluated
  // with the SAME algorithm (the TPU beam lives in wax_tpu/ops/beam_search.py).
  void search(const float* q_in, int k, int ef, int64_t* out_fids) {
    std::vector<float> q(q_in, q_in + dim);
    if (normalize) {
      float n = 0.f;
      for (float x : q) n += x * x;
      n = std::sqrt(n);
      if (n > 0) for (float& x : q) x /= n;
    }
    for (int i = 0; i < k; ++i) out_fids[i] = -1;
    if (entry < 0) return;
    int32_t cur = entry;
    float cur_sim = sim(q.data(), vec(cur));
    for (int lvl = max_level; lvl >= 1; --lvl) {
      bool improved = true;
      while (improved) {
        improved = false;
        auto it = neighbors[lvl].find(cur);
        if (it == neighbors[lvl].end()) break;
        for (int32_t nb : it->second) {
          if (!active[nb]) continue;
          float s = sim(q.data(), vec(nb));
          if (s > cur_sim) {
            cur = nb;
            cur_sim = s;
            improved = true;
          }
        }
      }
    }
    std::vector<int32_t> entries{cur};
    auto res = search_layer(q.data(), entries, std::max(ef, k), 0);
    int n_out = std::min((int)res.size(), k);
    for (int i = 0; i < n_out; ++i) out_fids[i] = frame_ids[res[i].node];
  }

  bool remove(int64_t fid) {
    auto it = row_of.find(fid);
    if (it == row_of.end()) return false;
    int32_t row = it->second;
    row_of.erase(it);
    active[row] = 0;
    frame_ids[row] = -1;
    if (entry == row) {
      entry = -1;
      max_level = -1;
      for (int32_t i = 0; i < (int32_t)frame_ids.size(); ++i) {
        if (active[i] && levels[i] > max_level) {
          max_level = levels[i];
          entry = i;
        }
      }
    }
    ++generation;
    return true;
  }
};

}  // namespace

extern "C" {

void* wax_hnsw_create(int dim, int m, int efc, uint64_t seed, int normalize) {
  return new Hnsw(dim, m, efc, seed, normalize != 0);
}

void wax_hnsw_free(void* h) { delete (Hnsw*)h; }

void wax_hnsw_add(void* h, int64_t fid, const float* vec) { ((Hnsw*)h)->add(fid, vec); }

void wax_hnsw_add_batch(void* h, int64_t n, const int64_t* fids, const float* vecs) {
  Hnsw* g = (Hnsw*)h;
  for (int64_t i = 0; i < n; ++i) g->add(fids[i], vecs + (size_t)i * g->dim);
}

int wax_hnsw_remove(void* h, int64_t fid) { return ((Hnsw*)h)->remove(fid) ? 1 : 0; }

void wax_hnsw_set_extend_candidates(void* h, int enable) {
  ((Hnsw*)h)->extend_candidates = enable != 0;
}

void wax_hnsw_search_batch(void* h, int64_t nq, const float* queries, int k, int ef,
                           int64_t* out_fids) {
  Hnsw* g = (Hnsw*)h;
  for (int64_t i = 0; i < nq; ++i)
    g->search(queries + (size_t)i * g->dim, k, ef, out_fids + (size_t)i * k);
}

int64_t wax_hnsw_count(void* h) { return (int64_t)((Hnsw*)h)->frame_ids.size(); }

int64_t wax_hnsw_live(void* h) { return (int64_t)((Hnsw*)h)->row_of.size(); }

int wax_hnsw_contains(void* h, int64_t fid) {
  return ((Hnsw*)h)->row_of.count(fid) ? 1 : 0;
}

int64_t wax_hnsw_generation(void* h) { return ((Hnsw*)h)->generation; }

int64_t wax_hnsw_edge_count(void* h) {
  Hnsw* g = (Hnsw*)h;
  int64_t e = 0;
  for (auto& lvl : g->neighbors)
    for (auto& kv : lvl) e += (int64_t)kv.second.size();
  return e;
}

// Export full state: caller allocates via sizes from count/edge_count.
// edges laid out as [E][3] = (level, node, neighbor). meta = {entry, max_level, m, efc}.
void wax_hnsw_export(void* h, float* vecs, int64_t* fids, uint8_t* active_out,
                     int32_t* levels_out, int64_t* edges, int64_t* meta) {
  Hnsw* g = (Hnsw*)h;
  size_t n = g->frame_ids.size();
  std::memcpy(vecs, g->vecs.data(), n * g->dim * sizeof(float));
  std::memcpy(fids, g->frame_ids.data(), n * sizeof(int64_t));
  std::memcpy(active_out, g->active.data(), n * sizeof(uint8_t));
  std::memcpy(levels_out, g->levels.data(), n * sizeof(int32_t));
  int64_t e = 0;
  for (int lvl = 0; lvl < (int)g->neighbors.size(); ++lvl) {
    // deterministic export order: sorted by node id
    std::vector<int32_t> keys;
    keys.reserve(g->neighbors[lvl].size());
    for (auto& kv : g->neighbors[lvl]) keys.push_back(kv.first);
    std::sort(keys.begin(), keys.end());
    for (int32_t node : keys) {
      for (int32_t nb : g->neighbors[lvl][node]) {
        edges[e * 3 + 0] = lvl;
        edges[e * 3 + 1] = node;
        edges[e * 3 + 2] = nb;
        ++e;
      }
    }
  }
  meta[0] = g->entry;
  meta[1] = g->max_level;
  meta[2] = g->m;
  meta[3] = g->efc;
}

void wax_hnsw_import(void* h, int64_t n, const float* vecs, const int64_t* fids,
                     const uint8_t* active_in, const int32_t* levels_in, int64_t e,
                     const int64_t* edges, const int64_t* meta) {
  Hnsw* g = (Hnsw*)h;
  g->vecs.assign(vecs, vecs + (size_t)n * g->dim);
  g->frame_ids.assign(fids, fids + n);
  g->active.assign(active_in, active_in + n);
  g->levels.assign(levels_in, levels_in + n);
  g->row_of.clear();
  for (int64_t i = 0; i < n; ++i)
    if (fids[i] >= 0 && active_in[i]) g->row_of[fids[i]] = (int32_t)i;
  g->entry = (int32_t)meta[0];
  g->max_level = (int32_t)meta[1];
  int max_lvl = 0;
  for (int64_t i = 0; i < e; ++i) max_lvl = std::max(max_lvl, (int)edges[i * 3]);
  max_lvl = std::max(max_lvl, (int)g->max_level);
  g->neighbors.clear();
  g->neighbors.resize(max_lvl + 1);
  for (int64_t i = 0; i < e; ++i) {
    g->neighbors[edges[i * 3]][(int32_t)edges[i * 3 + 1]].push_back((int32_t)edges[i * 3 + 2]);
  }
  ++g->generation;
}

}  // extern "C"
