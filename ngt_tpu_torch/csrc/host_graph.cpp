// Host runtime of ngt_tpu_torch: the union-find, edge-merge, constrained
// reverse-edge and text codec routines of the JAX package's native library
// (ngt_tpu/native/src/ngt_tpu_native.cpp: merge_edges,
// connected_components, union_pairs, constrained_reverse, tsv_parse,
// tsv_count_rows and the export stream's formatters and parsers), copied
// with the same C ABI so both packages give the same graphs, the same
// component labels and the same export bytes.  Built by g++ at first use
// (ngt_tpu_torch/native.py) and called through ctypes.
//
//  * merge_edges — the serial graph update of a build batch (the analogue
//    of the reference's coordinator-thread insert, Index.cpp:670-719): bulk
//    sorted-insert of reverse edges into fixed-width rows, dropping the
//    farthest edge when a row is full (addEdgeDeletingExcessEdges,
//    Graph.h:888-934);
//  * connected_components — union-find labels (root ids) of the undirected
//    view of the adjacency;
//  * union_pairs — merge extra label pairs into a labeling, min-id labels;
//  * constrained_reverse — the serial reverse-edge selection of the
//    indegree-balanced ONNG reconstruction (graph/reconstruct.py);
//  * tsv_parse / tsv_count_rows — TSV vector ingestion of the CLI;
//  * format_obj_rows / format_graph_rows / parse_obj_rows /
//    parse_graph_rows — the lossless v2 text export stream
//    (Index.export_index / import_index), with the same %.9g and
//    integer digit-loop formatting, so both packages write the same bytes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <utility>
#include <vector>

extern "C" {

// Bulk sorted-insert of edges target->src into fixed-width rows.
//   nbr_ids  [cap * e_max] int32, -1 padded, each row ascending by dist
//   nbr_dist [cap * e_max] float, +inf padded
//   degree   [cap] int32
//   has_node [cap] uint8
// adds: (targets[i] -> srcs[i], dists[i]) for i < n_adds.
// Duplicate (target, src) pairs are skipped; full rows drop the farthest.
void merge_edges(int32_t *nbr_ids, float *nbr_dist, int32_t *degree,
                 uint8_t *has_node, int64_t e_max, const int64_t *targets,
                 const int32_t *srcs, const float *dists, int64_t n_adds) {
  if (n_adds <= 0) return;
  // group adds by target
  std::vector<int64_t> order(n_adds);
  for (int64_t i = 0; i < n_adds; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return targets[a] < targets[b];
  });
  // one group per distinct target; groups touch disjoint rows, so they
  // run on threads freely
  std::vector<int64_t> starts;
  starts.reserve(1024);
  for (int64_t i = 0; i < n_adds; ++i)
    if (i == 0 || targets[order[i]] != targets[order[i - 1]])
      starts.push_back(i);
  starts.push_back(n_adds);
  const int64_t n_groups = static_cast<int64_t>(starts.size()) - 1;

  auto work = [&](int64_t g0, int64_t g1) {
    std::vector<std::pair<float, int32_t>> row;
    row.reserve(e_max * 2);
    for (int64_t g = g0; g < g1; ++g) {
      const int64_t i0 = starts[g], i1 = starts[g + 1];
      const int64_t t = targets[order[i0]];
      int32_t *ids = nbr_ids + t * e_max;
      float *ds = nbr_dist + t * e_max;
      row.clear();
      for (int64_t j = 0; j < e_max && ids[j] >= 0; ++j)
        row.emplace_back(ds[j], ids[j]);
      const size_t existing = row.size();
      for (int64_t i = i0; i < i1; ++i) {
        const int32_t s = srcs[order[i]];
        if (s < 0) continue;
        bool dup = false;
        for (size_t j = 0; j < row.size(); ++j)
          if (row[j].second == s) { dup = true; break; }
        if (!dup) row.emplace_back(dists[order[i]], s);
      }
      if (row.size() != existing) {
        std::stable_sort(row.begin(), row.end(),
                         [](const std::pair<float, int32_t> &a,
                            const std::pair<float, int32_t> &b) {
                           return a.first < b.first;
                         });
        const int64_t n = std::min<int64_t>(row.size(), e_max);
        for (int64_t j = 0; j < n; ++j) {
          ds[j] = row[j].first;
          ids[j] = row[j].second;
        }
        for (int64_t j = n; j < e_max; ++j) {
          ds[j] = __builtin_inff();
          ids[j] = -1;
        }
        degree[t] = static_cast<int32_t>(n);
        has_node[t] = 1;
      }
    }
  };

  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw ? static_cast<int64_t>(hw) : 4;
  if (n_threads > n_groups / 64) n_threads = n_groups / 64;  // small batches
  if (n_threads <= 1) {
    work(0, n_groups);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  const int64_t per = (n_groups + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t g0 = t * per;
    const int64_t g1 = std::min(g0 + per, n_groups);
    if (g0 >= g1) break;
    pool.emplace_back(work, g0, g1);
  }
  for (auto &th : pool) th.join();
}

// Connected components of the (undirected view of the) adjacency.
//   nbr_ids [n * e_max] int32, -1 padded;  has_node [n] uint8
//   labels  [n] int32 out: component root id per node, -1 for non-nodes.
// Union-find with path halving.  Returns the component count.
int64_t connected_components(const int32_t *nbr_ids, const uint8_t *has_node,
                             int64_t n, int64_t e_max, int32_t *labels) {
  std::vector<int32_t> parent(n);
  for (int64_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  auto find = [&](int32_t v) {
    while (parent[v] != v) {
      parent[v] = parent[parent[v]];  // path halving
      v = parent[v];
    }
    return v;
  };
  for (int64_t u = 0; u < n; ++u) {
    if (!has_node[u]) continue;
    const int32_t *row = nbr_ids + u * e_max;
    for (int64_t j = 0; j < e_max; ++j) {
      const int32_t v = row[j];
      if (v < 0) break;  // rows are -1 padded at the tail
      if (v >= n || !has_node[v]) continue;
      int32_t ru = find(static_cast<int32_t>(u)), rv = find(v);
      if (ru != rv) parent[rv] = ru;
    }
  }
  int64_t roots = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!has_node[i]) {
      labels[i] = -1;
    } else {
      labels[i] = find(static_cast<int32_t>(i));
      if (labels[i] == static_cast<int32_t>(i)) ++roots;
    }
  }
  return roots;
}

// Merge extra undirected edges (given in LABEL space) into an existing
// component labeling: labels[n] int32 in/out holds a component
// representative per node (-1 for non-nodes; a representative's label is
// itself).  Pairs (a[i], b[i]) are representative ids to union.  On return
// labels hold the MIN node id of each merged component.  Returns the
// component count.
int64_t union_pairs(int32_t *labels, int64_t n, const int32_t *a,
                    const int32_t *b, int64_t m) {
  std::vector<int32_t> parent(n);
  for (int64_t i = 0; i < n; ++i)
    parent[i] = labels[i] >= 0 ? labels[i] : static_cast<int32_t>(i);
  auto find = [&](int32_t v) {
    while (parent[v] != v) {
      parent[v] = parent[parent[v]];  // path halving
      v = parent[v];
    }
    return v;
  };
  for (int64_t i = 0; i < m; ++i) {
    const int32_t x = a[i], y = b[i];
    if (x < 0 || x >= n || y < 0 || y >= n) continue;
    const int32_t rx = find(x), ry = find(y);
    if (rx != ry) parent[ry] = rx;
  }
  std::vector<int32_t> mn(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    if (labels[i] < 0) continue;
    const int32_t r = find(static_cast<int32_t>(i));
    if (mn[r] < 0 || static_cast<int32_t>(i) < mn[r])
      mn[r] = static_cast<int32_t>(i);
  }
  int64_t comps = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (labels[i] < 0) continue;
    const int32_t r = find(static_cast<int32_t>(i));
    labels[i] = mn[r];
    if (mn[r] == static_cast<int32_t>(i)) ++comps;
  }
  return comps;
}

// Constrained reverse-edge selection — the serial core of
// reconstructGraphWithConstraint (reference GraphReconstructor.h:565-715):
// process reverse lists smallest-first; add reversed edge (rid -> src)
// unless src already received `in_edges` reversed edges, or rid's row is
// full (`out_edges`) and src already has at least one.  Emits the selected
// (rid, src, dist) triples; returns the count (<= total input edges).
int64_t constrained_reverse(const int32_t *nbr, const float *dist,
                            const int32_t *deg, int64_t n, int64_t e_w,
                            int64_t out_edges, int64_t in_edges,
                            int32_t *out_rid, int32_t *out_src,
                            float *out_d) {
  // reverse CSR: rev[t] = list of (src, d) for edges src -> t, src ascending
  std::vector<int64_t> rcount(n, 0);
  for (int64_t u = 0; u < n; ++u)
    for (int64_t j = 0; j < deg[u]; ++j) {
      const int32_t t = nbr[u * e_w + j];
      if (t >= 0 && t < n) ++rcount[t];
    }
  std::vector<int64_t> rstart(n + 1, 0);
  for (int64_t t = 0; t < n; ++t) rstart[t + 1] = rstart[t] + rcount[t];
  std::vector<int32_t> rsrc(rstart[n]);
  std::vector<float> rd(rstart[n]);
  std::vector<int64_t> fill(rstart.begin(), rstart.end() - 1);
  for (int64_t u = 0; u < n; ++u)  // ascending u preserves the reference's
    for (int64_t j = 0; j < deg[u]; ++j) {  // push order (id-major)
      const int32_t t = nbr[u * e_w + j];
      if (t < 0 || t >= n) continue;
      rsrc[fill[t]] = static_cast<int32_t>(u);
      rd[fill[t]] = dist[u * e_w + j];
      ++fill[t];
    }
  // rids by increasing reverse-list size (stable: ties by id)
  std::vector<int32_t> order;
  order.reserve(n);
  for (int64_t t = 0; t < n; ++t)
    if (rcount[t] > 0) order.push_back(static_cast<int32_t>(t));
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return rcount[a] < rcount[b];
  });
  std::vector<int32_t> indeg(n, 0), outdeg(n, 0);
  int64_t m = 0;
  for (const int32_t rid : order) {
    for (int64_t p = rstart[rid]; p < rstart[rid] + rcount[rid]; ++p) {
      const int32_t s = rsrc[p];
      if (indeg[s] >= in_edges) continue;
      if (indeg[s] > 0 && outdeg[rid] >= out_edges) continue;
      out_rid[m] = rid;
      out_src[m] = s;
      out_d[m] = rd[p];
      ++m;
      ++indeg[s];
      ++outdeg[rid];
    }
  }
  return m;
}

// Parse up to max_rows lines of TSV floats into out[max_rows * dim].
// Columns beyond `dim` are ignored; lines with fewer than `dim` columns are
// zero-padded.  Returns rows parsed, or -1 on I/O error.
long tsv_parse(const char *path, float *out, long max_rows, long dim) {
  FILE *fh = std::fopen(path, "rb");
  if (!fh) return -1;
  long rows = 0;
  char *line = nullptr;
  size_t cap = 0;
  ssize_t len;
  while (rows < max_rows && (len = getline(&line, &cap, fh)) != -1) {
    if (len == 0 || line[0] == '\n') continue;
    char *p = line;
    float *dst = out + rows * dim;
    long col = 0;
    while (col < dim) {
      char *end = p;
      float v = strtof(p, &end);
      if (end == p) break;  // no more numbers on this line
      dst[col++] = v;
      p = end;
      while (*p == '\t' || *p == ' ' || *p == ',') ++p;
      if (*p == '\n' || *p == '\0') break;
    }
    if (col == 0) continue;  // no parseable numbers (e.g. a header line):
                             // ignore like ObjectRepository::appendText
                             // rather than inserting a zero vector
    for (; col < dim; ++col) dst[col] = 0.0f;
    ++rows;
  }
  free(line);
  std::fclose(fh);
  return rows;
}

// Count data rows of a file (for pre-allocation).
long tsv_count_rows(const char *path) {
  FILE *fh = std::fopen(path, "rb");
  if (!fh) return -1;
  long rows = 0;
  int c, prev = '\n';
  bool nonempty = false;
  while ((c = std::fgetc(fh)) != EOF) {
    if (c == '\n') {
      if (nonempty) ++rows;
      nonempty = false;
    } else {
      nonempty = true;
    }
    prev = c;
  }
  (void)prev;
  if (nonempty) ++rows;
  std::fclose(fh);
  return rows;
}

// ---- text export/import (the Serializer analogue, Common.h:668-809) ------
//
// The lossless v2 text stream (Index::exportIndex twin, Index.h:703-727)
// spends all its time formatting/parsing floats; Python-level repr()/float()
// per element is ~100x slower than these single-pass C loops.  %.9g is
// lossless for binary32 (9 significant digits uniquely identify a float).

// Shortest-exact f32 formatting with an integer fast path (u8/encoded
// corpora are overwhelmingly small integers; snprintf "%.9g" costs ~430 ns
// while the digit loop costs ~20 ns).  %.9g is lossless for binary32.
static inline char *fmt_f32(char *p, float v) {
  const int64_t iv = static_cast<int64_t>(v);
  if (v == static_cast<float>(iv) && iv > -16777216 && iv < 16777216) {
    uint64_t u = iv < 0 ? (*p++ = '-', static_cast<uint64_t>(-iv))
                        : static_cast<uint64_t>(iv);
    char tmp[12];
    int k = 0;
    do {
      tmp[k++] = static_cast<char>('0' + u % 10);
      u /= 10;
    } while (u);
    while (k) *p++ = tmp[--k];
    return p;
  }
  return p + snprintf(p, 20, "%.9g", static_cast<double>(v));
}

// Format `n` object rows: "+v\tv...\n" when valid[i], else "-\n".
// Returns bytes written, or -1 if `cap` would be exceeded.
int64_t format_obj_rows(const float *x, const uint8_t *valid, int64_t n,
                        int64_t d, char *out, int64_t cap) {
  char *p = out;
  char *end = out + cap;
  for (int64_t i = 0; i < n; ++i) {
    if (end - p < 2 + d * 20) return -1;
    if (!valid[i]) {
      *p++ = '-';
      *p++ = '\n';
      continue;
    }
    *p++ = '+';
    const float *row = x + i * d;
    for (int64_t j = 0; j < d; ++j) {
      if (j) *p++ = '\t';
      p = fmt_f32(p, row[j]);
    }
    *p++ = '\n';
  }
  return p - out;
}

// Format `n` graph rows: "id:dist\tid:dist...\n" for nodes (empty line for
// degree-0 nodes), "-\n" for non-nodes.  Returns bytes written or -1.
int64_t format_graph_rows(const int32_t *nbr, const float *dist,
                          const int32_t *deg, const uint8_t *has, int64_t n,
                          int64_t e, char *out, int64_t cap) {
  char *p = out;
  char *end = out + cap;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t dg = has[i] ? deg[i] : 0;
    if (end - p < 2 + dg * 34) return -1;
    if (!has[i]) {
      *p++ = '-';
      *p++ = '\n';
      continue;
    }
    const int32_t *ids = nbr + i * e;
    const float *ds = dist + i * e;
    for (int64_t j = 0; j < dg; ++j) {
      if (j) *p++ = '\t';
      p += snprintf(p, 13, "%d", ids[j]);
      *p++ = ':';
      p = fmt_f32(p, ds[j]);
    }
    *p++ = '\n';
  }
  return p - out;
}

// Parse `n` object rows from buf back into x[n*d] / valid[n].
// Accepts both %.9g and Python-repr floats.  Returns bytes consumed or -1.
int64_t parse_obj_rows(const char *buf, int64_t len, int64_t n, int64_t d,
                       float *x, uint8_t *valid) {
  const char *p = buf;
  const char *end = buf + len;
  for (int64_t i = 0; i < n; ++i) {
    if (p >= end) return -1;
    if (*p == '-') {
      valid[i] = 0;
      for (int64_t j = 0; j < d; ++j) x[i * d + j] = 0.0f;
      while (p < end && *p != '\n') ++p;
      ++p;
      continue;
    }
    if (*p != '+') return -1;
    ++p;
    valid[i] = 1;
    float *row = x + i * d;
    for (int64_t j = 0; j < d; ++j) {
      char *q;
      row[j] = strtof(p, &q);
      if (q == p) return -1;
      p = q;
      if (*p == '\t') ++p;
    }
    while (p < end && *p != '\n') ++p;
    ++p;
  }
  return p - buf;
}

// Parse `n` graph rows back into fixed-width adjacency.  Returns bytes
// consumed or -1.
int64_t parse_graph_rows(const char *buf, int64_t len, int64_t n, int64_t e,
                         int32_t *nbr, float *dist, int32_t *deg,
                         uint8_t *has) {
  const char *p = buf;
  const char *end = buf + len;
  for (int64_t i = 0; i < n; ++i) {
    int32_t *ids = nbr + i * e;
    float *ds = dist + i * e;
    for (int64_t j = 0; j < e; ++j) {
      ids[j] = -1;
      ds[j] = __builtin_inff();
    }
    if (p >= end) return -1;
    if (*p == '-' && (p + 1 >= end || p[1] == '\n')) {
      has[i] = 0;
      deg[i] = 0;
      while (p < end && *p != '\n') ++p;
      ++p;
      continue;
    }
    has[i] = 1;
    int64_t dg = 0;
    while (p < end && *p != '\n' && dg < e) {
      char *q;
      const long id = strtol(p, &q, 10);
      if (q == p) break;  // empty line: degree-0 node
      p = q;
      if (*p != ':') return -1;
      ++p;
      const float dd = strtof(p, &q);
      if (q == p) return -1;
      p = q;
      ids[dg] = static_cast<int32_t>(id);
      ds[dg] = dd;
      ++dg;
      if (*p == '\t') ++p;
    }
    deg[i] = static_cast<int32_t>(dg);
    while (p < end && *p != '\n') ++p;
    ++p;
  }
  return p - buf;
}

}  // extern "C"
