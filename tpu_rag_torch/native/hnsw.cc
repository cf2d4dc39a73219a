// First-party CPU HNSW index — the honest baseline for the TPU engine.
//
// The reference system's ANN path is Chroma -> hnswlib (C++ HNSW graphs
// persisted under vector_store/, see SURVEY.md §2.4).  hnswlib is not in this
// image, so BASELINE config #1 ("reference build_index + query_local flow on
// CPU") is measured against this implementation instead: the standard HNSW
// algorithm (Malkov & Yashunin 2016) with cosine similarity, greedy descent
// over upper layers, ef-beam search on layer 0, and heuristic neighbor
// selection.  Exposed via a C ABI for ctypes (tpu_rag/baseline/hnsw_cpu.py).
//
// This is a measurement tool, not the serving path: single-writer build,
// multi-threaded batch queries (one thread per query slice).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <random>
#include <thread>
#include <utility>
#include <vector>

namespace {

using DistNode = std::pair<float, int>;  // (distance, node)

// Globally unique visit epochs so thread-local visited arrays can be reused
// across searches (and across index instances) without clearing.
std::atomic<uint64_t> g_epoch{1};
thread_local std::vector<uint64_t> tl_visited;

struct HNSW {
  int dim, M, Mmax0, efc, max_elements;
  float level_mult;
  int cur = 0;
  int entry = -1;
  int max_level = -1;
  std::vector<float> data;       // normalized vectors, row-major [max_elements, dim]
  std::vector<int64_t> ids;      // external ids
  std::vector<int> levels;       // top layer of each node
  // links[node][layer] -> neighbor node indices
  std::vector<std::vector<std::vector<int>>> links;
  std::mt19937 rng;

  HNSW(int dim_, int max_elements_, int M_, int efc_, unsigned seed)
      : dim(dim_), M(M_), Mmax0(2 * M_), efc(efc_), max_elements(max_elements_),
        level_mult(1.0f / std::log(float(M_))), rng(seed) {
    data.reserve(size_t(max_elements) * dim);
    ids.reserve(max_elements);
    levels.reserve(max_elements);
    links.reserve(max_elements);
  }

  const float* vec(int node) const { return data.data() + size_t(node) * dim; }

  float dist(const float* a, const float* b) const {
    float dot = 0.f;
    for (int i = 0; i < dim; ++i) dot += a[i] * b[i];
    return 1.0f - dot;  // cosine distance over pre-normalized vectors
  }

  int random_level() {
    std::uniform_real_distribution<float> u(0.0f, 1.0f);
    float r = u(rng);
    if (r < 1e-12f) r = 1e-12f;
    return int(-std::log(r) * level_mult);
  }

  // Beam search within one layer: returns up to ef closest nodes (sorted asc).
  std::vector<DistNode> search_layer(const float* q, int ep, int ef, int layer) const {
    uint64_t epoch = g_epoch.fetch_add(1, std::memory_order_relaxed);
    if (int(tl_visited.size()) < cur) tl_visited.resize(cur + 1024, 0);

    std::priority_queue<DistNode, std::vector<DistNode>, std::greater<>> cand;  // min by dist
    std::priority_queue<DistNode> top;                                          // max by dist
    float d0 = dist(q, vec(ep));
    cand.emplace(d0, ep);
    top.emplace(d0, ep);
    tl_visited[ep] = epoch;

    while (!cand.empty()) {
      auto [d, node] = cand.top();
      if (d > top.top().first && int(top.size()) >= ef) break;
      cand.pop();
      for (int nb : links[node][layer]) {
        if (tl_visited[nb] == epoch) continue;
        tl_visited[nb] = epoch;
        float dn = dist(q, vec(nb));
        if (int(top.size()) < ef || dn < top.top().first) {
          cand.emplace(dn, nb);
          top.emplace(dn, nb);
          if (int(top.size()) > ef) top.pop();
        }
      }
    }
    std::vector<DistNode> out(top.size());
    for (int i = int(top.size()) - 1; i >= 0; --i) { out[i] = top.top(); top.pop(); }
    return out;
  }

  // Paper heuristic (Alg. 4): keep a candidate only if it is closer to the
  // query than to every already-kept neighbor — spreads links directionally.
  std::vector<int> select_neighbors(std::vector<DistNode> cands, int m) const {
    std::vector<int> kept;
    kept.reserve(m);
    for (const auto& [d, node] : cands) {  // cands sorted asc by distance
      if (int(kept.size()) >= m) break;
      bool good = true;
      for (int kn : kept) {
        if (dist(vec(node), vec(kn)) < d) { good = false; break; }
      }
      if (good) kept.push_back(node);
    }
    // backfill with nearest skipped candidates if the heuristic was too strict
    if (int(kept.size()) < m) {
      for (const auto& [d, node] : cands) {
        if (int(kept.size()) >= m) break;
        bool present = false;
        for (int kn : kept) if (kn == node) { present = true; break; }
        if (!present) kept.push_back(node);
      }
    }
    return kept;
  }

  void shrink(int node, int layer) {
    int cap = layer == 0 ? Mmax0 : M;
    auto& lnk = links[node][layer];
    if (int(lnk.size()) <= cap) return;
    std::vector<DistNode> cands;
    cands.reserve(lnk.size());
    for (int nb : lnk) cands.emplace_back(dist(vec(node), vec(nb)), nb);
    std::sort(cands.begin(), cands.end());
    lnk = select_neighbors(std::move(cands), cap);
  }

  int add(const float* v, int64_t id) {
    if (cur >= max_elements) return -1;
    int node = cur++;
    // normalize on ingest (cosine space, like hnswlib's "cosine")
    float norm = 0.f;
    for (int i = 0; i < dim; ++i) norm += v[i] * v[i];
    norm = norm > 0 ? 1.0f / std::sqrt(norm) : 0.f;
    for (int i = 0; i < dim; ++i) data.push_back(v[i] * norm);
    ids.push_back(id);
    int level = random_level();
    levels.push_back(level);
    links.emplace_back(level + 1);

    if (entry < 0) { entry = node; max_level = level; return node; }

    const float* q = vec(node);
    int ep = entry;
    // greedy descent through layers above the node's top level
    for (int l = max_level; l > level; --l) {
      bool moved = true;
      float d = dist(q, vec(ep));
      while (moved) {
        moved = false;
        for (int nb : links[ep][l]) {
          float dn = dist(q, vec(nb));
          if (dn < d) { d = dn; ep = nb; moved = true; }
        }
      }
    }
    // connect on layers min(level, max_level) .. 0
    for (int l = std::min(level, max_level); l >= 0; --l) {
      auto cands = search_layer(q, ep, efc, l);
      ep = cands.front().second;
      int m = l == 0 ? Mmax0 : M;
      auto nbrs = select_neighbors(cands, std::min(m, M));
      links[node][l] = nbrs;
      for (int nb : nbrs) {
        links[nb][l].push_back(node);
        shrink(nb, l);
      }
    }
    if (level > max_level) { max_level = level; entry = node; }
    return node;
  }

  int search(const float* query, int k, int ef, int64_t* out_ids, float* out_scores) const {
    if (entry < 0) return 0;
    std::vector<float> qn(dim);
    float norm = 0.f;
    for (int i = 0; i < dim; ++i) norm += query[i] * query[i];
    norm = norm > 0 ? 1.0f / std::sqrt(norm) : 0.f;
    for (int i = 0; i < dim; ++i) qn[i] = query[i] * norm;

    int ep = entry;
    float d = dist(qn.data(), vec(ep));
    for (int l = max_level; l > 0; --l) {
      bool moved = true;
      while (moved) {
        moved = false;
        for (int nb : links[ep][l]) {
          float dn = dist(qn.data(), vec(nb));
          if (dn < d) { d = dn; ep = nb; moved = true; }
        }
      }
    }
    auto res = search_layer(qn.data(), ep, std::max(ef, k), 0);
    int n = std::min<int>(k, res.size());
    for (int i = 0; i < n; ++i) {
      out_ids[i] = ids[res[i].second];
      out_scores[i] = res[i].first;
    }
    return n;
  }
};

// Flat binary serialization — the baseline analogue of hnswlib's persisted
// data_level0.bin / link_lists.bin segments under the reference's
// vector_store/ directory.
bool save_index(const HNSW& h, const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  auto w = [&](const void* p, size_t n) { return std::fwrite(p, 1, n, f) == n; };
  int32_t header[6] = {0x484E5357, h.dim, h.M, h.efc, h.max_elements, h.cur};
  int32_t tail[2] = {h.entry, h.max_level};
  bool ok = w(header, sizeof header) && w(tail, sizeof tail) &&
            w(h.data.data(), sizeof(float) * size_t(h.cur) * h.dim) &&
            w(h.ids.data(), sizeof(int64_t) * h.cur) &&
            w(h.levels.data(), sizeof(int) * h.cur);
  for (int n = 0; ok && n < h.cur; ++n) {
    for (int l = 0; ok && l <= h.levels[n]; ++l) {
      int32_t cnt = int32_t(h.links[n][l].size());
      ok = w(&cnt, sizeof cnt) && w(h.links[n][l].data(), sizeof(int) * cnt);
    }
  }
  std::fclose(f);
  return ok;
}

HNSW* load_index(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto r = [&](void* p, size_t n) { return std::fread(p, 1, n, f) == n; };
  int32_t header[6], tail[2];
  if (!r(header, sizeof header) || header[0] != 0x484E5357 || !r(tail, sizeof tail)) {
    std::fclose(f);
    return nullptr;
  }
  auto* h = new HNSW(header[1], header[4], header[2], header[3], 100);
  h->cur = header[5];
  h->entry = tail[0];
  h->max_level = tail[1];
  h->data.resize(size_t(h->cur) * h->dim);
  h->ids.resize(h->cur);
  h->levels.resize(h->cur);
  bool ok = r(h->data.data(), sizeof(float) * h->data.size()) &&
            r(h->ids.data(), sizeof(int64_t) * h->cur) &&
            r(h->levels.data(), sizeof(int) * h->cur);
  h->links.resize(h->cur);
  for (int n = 0; ok && n < h->cur; ++n) {
    h->links[n].resize(h->levels[n] + 1);
    for (int l = 0; ok && l <= h->levels[n]; ++l) {
      int32_t cnt = 0;
      ok = r(&cnt, sizeof cnt);
      if (ok) {
        h->links[n][l].resize(cnt);
        ok = r(h->links[n][l].data(), sizeof(int) * cnt);
      }
    }
  }
  std::fclose(f);
  if (!ok) { delete h; return nullptr; }
  return h;
}

}  // namespace

extern "C" {

void* hnsw_create(int dim, int max_elements, int M, int ef_construction, unsigned seed) {
  return new HNSW(dim, max_elements, M, ef_construction, seed);
}

void hnsw_free(void* h) { delete static_cast<HNSW*>(h); }

int hnsw_size(void* h) { return static_cast<HNSW*>(h)->cur; }

int hnsw_add(void* h, const float* vecs, const int64_t* ids, int n) {
  auto* idx = static_cast<HNSW*>(h);
  for (int i = 0; i < n; ++i) {
    if (idx->add(vecs + size_t(i) * idx->dim, ids[i]) < 0) return i;
  }
  return n;
}

int hnsw_search(void* h, const float* query, int k, int ef,
                int64_t* out_ids, float* out_scores) {
  return static_cast<HNSW*>(h)->search(query, k, ef, out_ids, out_scores);
}

// Batch query API: splits nq queries across n_threads.  Output rows for
// queries with fewer than k results are padded with id -1.
void hnsw_search_batch(void* h, const float* queries, int nq, int k, int ef,
                       int64_t* out_ids, float* out_scores, int n_threads) {
  auto* idx = static_cast<HNSW*>(h);
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int start, int end) {
    for (int i = start; i < end; ++i) {
      int64_t* oid = out_ids + size_t(i) * k;
      float* osc = out_scores + size_t(i) * k;
      int n = idx->search(queries + size_t(i) * idx->dim, k, ef, oid, osc);
      for (int j = n; j < k; ++j) { oid[j] = -1; osc[j] = 0.f; }
    }
  };
  if (n_threads == 1 || nq < 2) { worker(0, nq); return; }
  std::vector<std::thread> threads;
  int per = (nq + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int s = t * per, e = std::min(nq, s + per);
    if (s >= e) break;
    threads.emplace_back(worker, s, e);
  }
  for (auto& th : threads) th.join();
}

int hnsw_save(void* h, const char* path) {
  return save_index(*static_cast<HNSW*>(h), path) ? 0 : -1;
}

void* hnsw_load(const char* path) { return load_index(path); }

}  // extern "C"
