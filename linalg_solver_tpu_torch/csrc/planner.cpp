// Native combinatorial planner for linalg_solver_tpu_torch (the JAX
// package's csrc/planner.cpp, unchanged but for this header).
//
// Implements the determinant-strategy search and its supporting graph
// algorithms (Hopcroft–Karp matching, Tarjan SCC, Dulmage–Mendelsohn
// decomposition, Weisfeiler–Lehman canonicalization) over boolean
// sparsity patterns, mirroring the semantics of the Python engine in
// linalg_solver_tpu_torch/planner/.  Exposed through a C ABI returning
// JSON; loaded from Python via ctypes (planner/native.py).
//
// Patterns are limited to 64x64 (row bitmasks in uint64_t) — far beyond
// the practical range of the exhaustive search.
//
// Built at first use by planner/native.py:
//   g++ -O2 -std=c++17 -fPIC -shared -o _build/libplanner_<hash>.so planner.cpp

#include <algorithm>
#include <functional>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

using std::string;
using std::vector;

// ---------------------------------------------------------------------------
// Sparsity pattern
// ---------------------------------------------------------------------------

struct Pattern {
  int rows = 0, cols = 0;
  vector<uint64_t> bits;  // one mask per row

  bool get(int r, int c) const { return (bits[r] >> c) & 1; }
  void set(int r, int c, bool v) {
    if (v) bits[r] |= (1ull << c);
    else bits[r] &= ~(1ull << c);
  }
  int row_nnz(int r) const { return __builtin_popcountll(bits[r]); }
  int col_nnz(int c) const {
    int n = 0;
    for (int r = 0; r < rows; ++r) n += get(r, c);
    return n;
  }
  int total_nnz() const {
    int n = 0;
    for (auto b : bits) n += __builtin_popcountll(b);
    return n;
  }
  vector<int> row_neighbors(int r) const {
    vector<int> out;
    uint64_t b = bits[r];
    while (b) {
      out.push_back(__builtin_ctzll(b));
      b &= b - 1;
    }
    return out;
  }
  vector<int> col_neighbors(int c) const {
    vector<int> out;
    for (int r = 0; r < rows; ++r)
      if (get(r, c)) out.push_back(r);
    return out;
  }
  Pattern submatrix(const vector<int>& rs, const vector<int>& cs) const {
    Pattern out;
    out.rows = (int)rs.size();
    out.cols = (int)cs.size();
    out.bits.assign(out.rows, 0);
    for (int i = 0; i < out.rows; ++i)
      for (int j = 0; j < out.cols; ++j)
        if (get(rs[i], cs[j])) out.set(i, j, true);
    return out;
  }
  Pattern with_add_row(int src, int dst, int pivot_col) const {
    Pattern out = *this;
    out.bits[dst] = (out.bits[dst] | out.bits[src]) & ~(1ull << pivot_col);
    return out;
  }
  vector<std::pair<int, int>> entries() const {
    vector<std::pair<int, int>> out;
    for (int r = 0; r < rows; ++r)
      for (int c : row_neighbors(r)) out.emplace_back(r, c);
    return out;
  }
};

Pattern pattern_from_bytes(const uint8_t* data, int rows, int cols) {
  Pattern p;
  p.rows = rows;
  p.cols = cols;
  p.bits.assign(rows, 0);
  for (int r = 0; r < rows; ++r)
    for (int c = 0; c < cols; ++c)
      if (data[r * cols + c]) p.set(r, c, true);
  return p;
}

// ---------------------------------------------------------------------------
// Hopcroft–Karp maximum bipartite matching
// ---------------------------------------------------------------------------

struct Matching {
  vector<int> row_to_col, col_to_row;  // -1 = unmatched
};

Matching hopcroft_karp(const Pattern& g) {
  const int R = g.rows, NIL = g.rows;
  const int INF = 1 << 30;
  Matching m;
  m.row_to_col.assign(g.rows, -1);
  m.col_to_row.assign(g.cols, -1);
  vector<int> dist(R + 1);

  auto bfs = [&]() {
    std::deque<int> q;
    for (int r = 0; r < R; ++r) {
      if (m.row_to_col[r] < 0) {
        dist[r] = 0;
        q.push_back(r);
      } else {
        dist[r] = INF;
      }
    }
    dist[NIL] = INF;
    while (!q.empty()) {
      int r = q.front();
      q.pop_front();
      if (dist[r] < dist[NIL]) {
        for (int c : g.row_neighbors(r)) {
          int nxt = m.col_to_row[c] < 0 ? NIL : m.col_to_row[c];
          if (dist[nxt] == INF) {
            dist[nxt] = dist[r] + 1;
            if (nxt != NIL) q.push_back(nxt);
          }
        }
      }
    }
    return dist[NIL] != INF;
  };

  std::function<bool(int)> dfs = [&](int r) -> bool {
    if (r == NIL) return true;
    for (int c : g.row_neighbors(r)) {
      int nxt = m.col_to_row[c] < 0 ? NIL : m.col_to_row[c];
      if (dist[nxt] == dist[r] + 1 && dfs(nxt)) {
        m.row_to_col[r] = c;
        m.col_to_row[c] = r;
        return true;
      }
    }
    dist[r] = INF;
    return false;
  };

  while (bfs())
    for (int r = 0; r < R; ++r)
      if (m.row_to_col[r] < 0) dfs(r);
  return m;
}

// ---------------------------------------------------------------------------
// Tarjan SCC (iterative; sinks first)
// ---------------------------------------------------------------------------

vector<vector<int>> tarjan_scc(const vector<vector<int>>& adj) {
  const int n = (int)adj.size();
  vector<int> index(n, -1), lowlink(n, 0);
  vector<bool> on_stack(n, false);
  vector<int> stack;
  vector<vector<int>> sccs;
  int counter = 0;

  struct Frame {
    int v;
    size_t edge;
  };
  for (int root = 0; root < n; ++root) {
    if (index[root] >= 0) continue;
    vector<Frame> work{{root, 0}};
    while (!work.empty()) {
      Frame& f = work.back();
      int v = f.v;
      if (f.edge == 0) {
        index[v] = lowlink[v] = counter++;
        stack.push_back(v);
        on_stack[v] = true;
      }
      bool advanced = false;
      while (f.edge < adj[v].size()) {
        int w = adj[v][f.edge++];
        if (index[w] < 0) {
          work.push_back({w, 0});
          advanced = true;
          break;
        }
        if (on_stack[w]) lowlink[v] = std::min(lowlink[v], index[w]);
      }
      if (advanced) continue;
      work.pop_back();
      if (!work.empty())
        lowlink[work.back().v] = std::min(lowlink[work.back().v], lowlink[v]);
      if (lowlink[v] == index[v]) {
        vector<int> scc;
        while (true) {
          int w = stack.back();
          stack.pop_back();
          on_stack[w] = false;
          scc.push_back(w);
          if (w == v) break;
        }
        sccs.push_back(std::move(scc));
      }
    }
  }
  return sccs;
}

// ---------------------------------------------------------------------------
// Dulmage–Mendelsohn decomposition
// ---------------------------------------------------------------------------

struct DMResult {
  vector<int> row_perm, col_perm;
  vector<int> block_sizes;
};

DMResult dm_trivial(int rows, int cols) {
  DMResult res;
  res.row_perm.resize(rows);
  res.col_perm.resize(cols);
  for (int i = 0; i < rows; ++i) res.row_perm[i] = i;
  for (int j = 0; j < cols; ++j) res.col_perm[j] = j;
  res.block_sizes = {rows};
  return res;
}

DMResult dulmage_mendelsohn(const Pattern& g) {
  const int rows = g.rows, cols = g.cols;
  if (rows == 0 || cols == 0) {
    DMResult res = dm_trivial(rows, cols);
    res.block_sizes.clear();
    return res;
  }
  Matching m = hopcroft_karp(g);

  // H: reachable from unmatched rows (rows via any edge, cols back via
  // matching); V: can reach unmatched columns (mirrored).
  vector<bool> h_row(rows, false), h_col(cols, false);
  {
    std::deque<std::pair<int, bool>> q;  // (vertex, is_row)
    for (int r = 0; r < rows; ++r)
      if (m.row_to_col[r] < 0) {
        h_row[r] = true;
        q.emplace_back(r, true);
      }
    while (!q.empty()) {
      auto [v, is_row] = q.front();
      q.pop_front();
      if (is_row) {
        for (int c : g.row_neighbors(v))
          if (!h_col[c]) {
            h_col[c] = true;
            q.emplace_back(c, false);
          }
      } else if (m.col_to_row[v] >= 0 && !h_row[m.col_to_row[v]]) {
        h_row[m.col_to_row[v]] = true;
        q.emplace_back(m.col_to_row[v], true);
      }
    }
  }
  vector<bool> v_row(rows, false), v_col(cols, false);
  {
    std::deque<std::pair<int, bool>> q;
    for (int c = 0; c < cols; ++c)
      if (m.col_to_row[c] < 0) {
        v_col[c] = true;
        q.emplace_back(c, false);
      }
    while (!q.empty()) {
      auto [v, is_row] = q.front();
      q.pop_front();
      if (!is_row) {
        for (int r : g.col_neighbors(v))
          if (!v_row[r]) {
            v_row[r] = true;
            q.emplace_back(r, true);
          }
      } else if (m.row_to_col[v] >= 0 && !v_col[m.row_to_col[v]]) {
        v_col[m.row_to_col[v]] = true;
        q.emplace_back(m.row_to_col[v], false);
      }
    }
  }

  vector<int> s_rows;
  vector<bool> s_col(cols, false);
  for (int r = 0; r < rows; ++r)
    if (!h_row[r] && !v_row[r]) s_rows.push_back(r);
  for (int c = 0; c < cols; ++c)
    if (!h_col[c] && !v_col[c]) s_col[c] = true;

  // Digraph on the square part: i -> j iff row s_rows[i] touches the
  // column matched to row s_rows[j].
  vector<int> s_index(rows, -1);
  for (size_t i = 0; i < s_rows.size(); ++i) s_index[s_rows[i]] = (int)i;
  vector<vector<int>> s_adj(s_rows.size());
  for (size_t i = 0; i < s_rows.size(); ++i)
    for (int c : g.row_neighbors(s_rows[i]))
      if (s_col[c] && m.col_to_row[c] >= 0) {
        int j = s_index[m.col_to_row[c]];
        if (j >= 0 && j != (int)i) s_adj[i].push_back(j);
      }
  auto sccs = tarjan_scc(s_adj);

  using Block = std::pair<vector<std::pair<int, int>>, int>;
  vector<Block> blocks;

  // H partition first.
  {
    vector<int> hr, hc;
    for (int r = 0; r < rows; ++r)
      if (h_row[r]) hr.push_back(r);
    for (int c = 0; c < cols; ++c)
      if (h_col[c]) hc.push_back(c);
    if (!hr.empty() || !hc.empty()) {
      if (hr.size() != hc.size()) return dm_trivial(rows, cols);
      vector<std::pair<int, int>> pairs;
      for (size_t i = 0; i < hr.size(); ++i) pairs.emplace_back(hr[i], hc[i]);
      blocks.emplace_back(pairs, pairs.front().first);
    }
  }
  // Square part: SCCs reversed (sources first), rows sorted inside.
  for (auto it = sccs.rbegin(); it != sccs.rend(); ++it) {
    vector<std::pair<int, int>> pairs;
    for (int idx : *it) {
      int r = s_rows[idx];
      if (m.row_to_col[r] >= 0) pairs.emplace_back(r, m.row_to_col[r]);
    }
    if (pairs.empty()) continue;
    std::sort(pairs.begin(), pairs.end());
    blocks.emplace_back(pairs, pairs.front().first);
  }
  // V partition last.
  {
    vector<int> vr, vc;
    for (int r = 0; r < rows; ++r)
      if (v_row[r]) vr.push_back(r);
    for (int c = 0; c < cols; ++c)
      if (v_col[c]) vc.push_back(c);
    if (!vr.empty() || !vc.empty()) {
      if (vr.size() != vc.size()) return dm_trivial(rows, cols);
      vector<std::pair<int, int>> pairs;
      for (size_t i = 0; i < vr.size(); ++i) pairs.emplace_back(vr[i], vc[i]);
      blocks.emplace_back(pairs, pairs.front().first);
    }
  }

  // Block-diagonal normalization: if no inter-block edges exist at all,
  // sort blocks by their minimal original row.
  if (blocks.size() > 1) {
    bool inter_block = false;
    vector<int> col_block(cols, -1);
    for (size_t b = 0; b < blocks.size(); ++b)
      for (auto& rc : blocks[b].first) col_block[rc.second] = (int)b;
    for (size_t b = 0; b < blocks.size() && !inter_block; ++b)
      for (auto& rc : blocks[b].first) {
        for (int c : g.row_neighbors(rc.first))
          if (col_block[c] >= 0 && col_block[c] != (int)b) {
            inter_block = true;
            break;
          }
        if (inter_block) break;
      }
    if (!inter_block)
      std::sort(blocks.begin(), blocks.end(),
                [](const Block& a, const Block& b) {
                  return a.second < b.second;
                });
  }

  DMResult res;
  for (auto& [pairs, min_row] : blocks) {
    if (pairs.empty()) continue;
    res.block_sizes.push_back((int)pairs.size());
    for (auto& [r, c] : pairs) {
      res.row_perm.push_back(r);
      res.col_perm.push_back(c);
    }
  }
  if ((int)res.row_perm.size() != rows || (int)res.col_perm.size() != cols)
    return dm_trivial(rows, cols);
  return res;
}

// ---------------------------------------------------------------------------
// WL canonicalization
// ---------------------------------------------------------------------------

struct CanonicalForm {
  vector<int> row_perm, col_perm;  // canonical index -> original index
  uint64_t hash = 0;
};

// Colors are compressed to dense ranks each round; using sorted u64
// signatures instead of vector<int> keys avoids allocation churn in the
// refinement loop (the planner's hottest constant factor).
vector<int> compress_colors(const vector<vector<int>>& colors) {
  vector<std::pair<const vector<int>*, int>> order;
  order.reserve(colors.size());
  for (size_t i = 0; i < colors.size(); ++i)
    order.emplace_back(&colors[i], (int)i);
  std::sort(order.begin(), order.end(),
            [](const auto& a, const auto& b) { return *a.first < *b.first; });
  vector<int> out(colors.size());
  int rank = -1;
  const vector<int>* prev = nullptr;
  for (auto& [ptr, idx] : order) {
    if (!prev || *ptr != *prev) {
      ++rank;
      prev = ptr;
    }
    out[idx] = rank;
  }
  return out;
}

CanonicalForm canonicalize(const Pattern& g) {
  const int R = g.rows, C = g.cols;
  CanonicalForm cf;
  if (R == 0 || C == 0) {
    cf.row_perm.resize(R);
    cf.col_perm.resize(C);
    for (int i = 0; i < R; ++i) cf.row_perm[i] = i;
    for (int j = 0; j < C; ++j) cf.col_perm[j] = j;
    return cf;
  }

  vector<vector<int>> row_colors(R), col_colors(C);
  for (int r = 0; r < R; ++r) row_colors[r] = {g.row_nnz(r)};
  for (int c = 0; c < C; ++c) col_colors[c] = {g.col_nnz(c)};

  for (int iter = 0; iter < R + C; ++iter) {
    auto row_ids = compress_colors(row_colors);
    auto col_ids = compress_colors(col_colors);
    vector<vector<int>> new_rows(R), new_cols(C);
    for (int r = 0; r < R; ++r) {
      vector<int> nb;
      for (int c : g.row_neighbors(r)) nb.push_back(col_ids[c]);
      std::sort(nb.begin(), nb.end());
      new_rows[r] = {row_ids[r]};
      new_rows[r].insert(new_rows[r].end(), nb.begin(), nb.end());
    }
    for (int c = 0; c < C; ++c) {
      vector<int> nb;
      for (int r : g.col_neighbors(c)) nb.push_back(row_ids[r]);
      std::sort(nb.begin(), nb.end());
      new_cols[c] = {col_ids[c]};
      new_cols[c].insert(new_cols[c].end(), nb.begin(), nb.end());
    }
    if (new_rows == row_colors && new_cols == col_colors) break;
    row_colors.swap(new_rows);
    col_colors.swap(new_cols);
  }

  auto group = [](const vector<vector<int>>& colors) {
    std::map<vector<int>, vector<int>> groups;
    for (size_t i = 0; i < colors.size(); ++i)
      groups[colors[i]].push_back((int)i);
    vector<vector<int>> out;
    for (auto& kv : groups) out.push_back(kv.second);
    return out;
  };
  auto row_parts = group(row_colors);
  auto col_parts = group(col_colors);

  auto row_sig = [&](int r, const vector<int>& col_order) {
    vector<bool> sig;
    sig.reserve(col_order.size());
    for (int c : col_order) sig.push_back(g.get(r, c));
    return sig;
  };
  auto col_sig = [&](int c, const vector<int>& row_order) {
    vector<bool> sig;
    sig.reserve(row_order.size());
    for (int r : row_order) sig.push_back(g.get(r, c));
    return sig;
  };

  vector<int> col_order;
  for (auto& part : col_parts)
    col_order.insert(col_order.end(), part.begin(), part.end());

  vector<int> row_order;
  auto order_rows = [&]() {
    row_order.clear();
    for (auto& part : row_parts) {
      vector<int> p = part;
      std::stable_sort(p.begin(), p.end(), [&](int a, int b) {
        return row_sig(a, col_order) < row_sig(b, col_order);
      });
      row_order.insert(row_order.end(), p.begin(), p.end());
    }
  };
  order_rows();
  {
    col_order.clear();
    for (auto& part : col_parts) {
      vector<int> p = part;
      std::stable_sort(p.begin(), p.end(), [&](int a, int b) {
        return col_sig(a, row_order) < col_sig(b, row_order);
      });
      col_order.insert(col_order.end(), p.begin(), p.end());
    }
  }
  order_rows();

  // FNV-1a over dims + canonically ordered bits (8 bits per byte), matching
  // the Python engine's hash so mixed-engine runs share semantics.
  uint64_t h = 0xCBF29CE484222325ull;
  auto mix = [&](uint8_t byte) {
    h ^= byte;
    h *= 0x100000001B3ull;
  };
  for (int dim : {R, C})
    for (int shift = 0; shift < 64; shift += 8)
      mix((uint8_t)((uint64_t)dim >> shift));
  {
    int acc = 0, nbits = 0;
    for (int r : row_order)
      for (int c : col_order) {
        acc = (acc << 1) | (g.get(r, c) ? 1 : 0);
        if (++nbits == 8) {
          mix((uint8_t)acc);
          acc = nbits = 0;
        }
      }
    if (nbits) mix((uint8_t)(acc << (8 - nbits)));
  }

  cf.row_perm = row_order;
  cf.col_perm = col_order;
  cf.hash = h;
  return cf;
}

bool perm_equivalent(const Pattern& a, const Pattern& b) {
  if (a.rows != b.rows || a.cols != b.cols) return false;
  CanonicalForm ca = canonicalize(a), cb = canonicalize(b);
  if (ca.hash != cb.hash) return false;
  for (int i = 0; i < a.rows; ++i)
    for (int j = 0; j < a.cols; ++j)
      if (a.get(ca.row_perm[i], ca.col_perm[j]) !=
          b.get(cb.row_perm[i], cb.col_perm[j]))
        return false;
  return true;
}

// ---------------------------------------------------------------------------
// Process algebra + optimal search
// ---------------------------------------------------------------------------

struct Cost {
  long long mults = 0, adds = 0;
  long long total() const { return mults + adds; }
  Cost operator+(const Cost& o) const { return {mults + o.mults, adds + o.adds}; }
};

Cost direct_cost(int size) {
  if (size <= 1) return {0, 0};
  if (size == 2) return {2, 1};
  long long fact = 1;
  for (int i = 2; i <= size; ++i) fact *= i;
  return {fact * (size - 1), fact - 1};
}

struct Process;
using ProcPtr = std::shared_ptr<const Process>;

struct Process {
  enum Kind { kDirect, kRowExp, kColExp, kBlockTri, kAddRow } kind;
  int size = 0;                                // Direct
  int line = 0;                                // expansion row/col
  vector<std::pair<int, ProcPtr>> minors;      // expansions
  vector<ProcPtr> blocks;                      // block triangular
  vector<int> row_perm, col_perm;              // block triangular
  int src = 0, dst = 0, pivot_col = 0;         // add row
  ProcPtr result;                              // add row
  vector<std::pair<int, int>> nz;              // expected nonzeros
};

ProcPtr make_direct(int size, vector<std::pair<int, int>> nz) {
  auto p = std::make_shared<Process>();
  p->kind = Process::kDirect;
  p->size = size;
  p->nz = std::move(nz);
  return p;
}

vector<int> invert_perm(const vector<int>& p) {
  vector<int> inv(p.size());
  for (size_t i = 0; i < p.size(); ++i) inv[p[i]] = (int)i;
  return inv;
}

vector<int> compose_perm(const vector<int>& a, const vector<int>& b) {
  // (a ∘ b)(i) = a[b[i]]
  vector<int> out(a.size());
  for (size_t i = 0; i < a.size(); ++i) out[i] = a[b[i]];
  return out;
}

// The permutation a top-level remap induces on a minor's local (sorted
// remaining index) coordinate system: old local i = i-th remaining index
// without `exclude_old`; it lands at the sorted position of its image
// among the new remaining indices.
vector<int> induced_minor_perm(int exclude_old, const vector<int>& index_map) {
  const int n = (int)index_map.size();
  vector<int> images;
  images.reserve(n - 1);
  for (int k = 0; k < n; ++k)
    if (k != exclude_old) images.push_back(index_map[k]);
  vector<int> sorted_images = images;
  std::sort(sorted_images.begin(), sorted_images.end());
  vector<int> pos((size_t)n, -1);
  for (size_t i = 0; i < sorted_images.size(); ++i)
    pos[sorted_images[i]] = (int)i;
  vector<int> out;
  out.reserve(images.size());
  for (int v : images) out.push_back(pos[v]);
  return out;
}

bool is_identity(const vector<int>& p) {
  for (size_t i = 0; i < p.size(); ++i)
    if (p[i] != (int)i) return false;
  return true;
}

// Remap a process's coordinates, recursively.  Block-triangular blocks
// live in coordinates defined by the composed block permutation and are
// shared untouched; expansion minors live in sorted-remaining-index
// coordinates whose ORDER changes under a general remap, so each minor is
// remapped by the induced local permutation.  (Soundness fix over the
// reference's remap, which left minors in stale coordinates.)
ProcPtr remap_process(const ProcPtr& proc, const vector<int>& row_map,
                      const vector<int>& col_map) {
  if (is_identity(row_map) && is_identity(col_map)) return proc;
  auto p = std::make_shared<Process>(*proc);
  switch (proc->kind) {
    case Process::kDirect:
      break;
    case Process::kRowExp: {
      p->line = row_map[proc->line];
      vector<int> rho = induced_minor_perm(proc->line, row_map);
      for (auto& m : p->minors) {
        vector<int> sigma = induced_minor_perm(m.first, col_map);
        m.second = remap_process(m.second, rho, sigma);
        m.first = col_map[m.first];
      }
      break;
    }
    case Process::kColExp: {
      p->line = col_map[proc->line];
      vector<int> sigma = induced_minor_perm(proc->line, col_map);
      for (auto& m : p->minors) {
        vector<int> rho = induced_minor_perm(m.first, row_map);
        m.second = remap_process(m.second, rho, sigma);
        m.first = row_map[m.first];
      }
      break;
    }
    case Process::kBlockTri:
      p->row_perm = compose_perm(row_map, proc->row_perm);
      p->col_perm = compose_perm(col_map, proc->col_perm);
      break;
    case Process::kAddRow:
      p->src = row_map[proc->src];
      p->dst = row_map[proc->dst];
      p->pivot_col = col_map[proc->pivot_col];
      p->result = remap_process(proc->result, row_map, col_map);
      break;
  }
  for (auto& rc : p->nz) rc = {row_map[rc.first], col_map[rc.second]};
  std::sort(p->nz.begin(), p->nz.end());
  return p;
}

struct CacheEntry {
  Cost cost;
  ProcPtr proc;   // in canonical coordinates (null if !exact)
  bool exact;     // proven optimum vs bound-limited lower bound
  long long lb;   // best lower bound proved so far (= cost if exact)
};

using Cache = std::unordered_map<uint64_t, CacheEntry>;

constexpr long long kInfBudget = (1LL << 62);

// Search result: exact optimum (proc set) or a proved lower bound
// >= the caller's budget (proc null, bound in cost.mults).
struct SearchResult {
  Cost cost;
  ProcPtr proc;
  bool exact;
};

SearchResult search(const Pattern& g, Cache& cache, long long budget);

// Admissible lower bound on Cost.total (mirrors planner/bound.py):
// det(P) depends on exactly the entries lying on some perfect matching
// (permutation monomials never cancel), and computing a function of m
// variables needs >= m-1 counted binary ops.  Structurally singular
// patterns bound at 0.  Entry (r, c) not in matching M is on some
// perfect matching iff r and M^-1(c) share an SCC of the matching
// digraph (rows as vertices, r -> M^-1(c) per nonzero).
long long influential_lower_bound(const Pattern& g) {
  const int n = g.rows;
  if (n != g.cols || n <= 1) return 0;
  Matching m = hopcroft_karp(g);
  for (int r = 0; r < n; ++r)
    if (m.row_to_col[r] < 0) return 0;

  vector<vector<int>> adj(n);
  for (int r = 0; r < n; ++r) {
    uint64_t bits = g.bits[r];
    while (bits) {
      int c = __builtin_ctzll(bits);
      bits &= bits - 1;
      if (c != m.row_to_col[r]) adj[r].push_back(m.col_to_row[c]);
    }
  }
  vector<int> scc_id(n, 0);
  auto comps = tarjan_scc(adj);
  for (int i = 0; i < (int)comps.size(); ++i)
    for (int v : comps[i]) scc_id[v] = i;

  long long influential = 0;
  for (int r = 0; r < n; ++r) {
    uint64_t bits = g.bits[r];
    while (bits) {
      int c = __builtin_ctzll(bits);
      bits &= bits - 1;
      if (c == m.row_to_col[r] || scc_id[r] == scc_id[m.col_to_row[c]])
        ++influential;
    }
  }
  return influential > 0 ? influential - 1 : 0;
}

void consider(std::pair<Cost, ProcPtr>& best, bool& has_best, Cost cost,
              ProcPtr proc) {
  if (!has_best || cost.total() < best.first.total()) {
    best = {cost, std::move(proc)};
    has_best = true;
  }
}

struct PatternKey {
  int rows, cols;
  vector<uint64_t> bits;
  bool operator==(const PatternKey& o) const {
    return rows == o.rows && cols == o.cols && bits == o.bits;
  }
};
struct PatternKeyHash {
  size_t operator()(const PatternKey& k) const {
    uint64_t h = 0xCBF29CE484222325ull;
    auto mix = [&](uint64_t v) {
      h ^= v;
      h *= 0x100000001B3ull;
    };
    mix((uint64_t)k.rows);
    mix((uint64_t)k.cols);
    for (uint64_t b : k.bits) mix(b);
    return (size_t)h;
  }
};
// Identical (not merely permutation-equivalent) subpatterns recur
// constantly during the search; an exact-bits front cache skips the WL
// canonicalization for them entirely.
using ExactCache =
    std::unordered_map<PatternKey, std::pair<Cost, ProcPtr>, PatternKeyHash>;
ExactCache* g_exact_cache = nullptr;

SearchResult search(const Pattern& g, Cache& cache, long long budget) {
  const int n = g.rows;
  if (n <= 2)
    return {direct_cost(n), make_direct(n, g.entries()), true};

  PatternKey key{g.rows, g.cols, g.bits};
  if (g_exact_cache) {
    auto hit = g_exact_cache->find(key);
    if (hit != g_exact_cache->end())
      return {hit->second.first, hit->second.second, true};
  }

  CanonicalForm canon = canonicalize(g);
  auto it = cache.find(canon.hash);
  if (it != cache.end()) {
    if (it->second.exact)
      return {it->second.cost,
              remap_process(it->second.proc, canon.row_perm,
                            canon.col_perm),
              true};
    if (it->second.lb >= budget)
      return {Cost{it->second.lb, 0}, nullptr, false};
  }

  // Static admissible bound (planner/bound.py twin): prune before any
  // recursion when it already proves the optimum >= budget.
  long long lb0 = influential_lower_bound(g);
  if (it != cache.end() && it->second.lb > lb0) lb0 = it->second.lb;
  if (lb0 >= budget) {
    cache[canon.hash] = {Cost{lb0, 0}, nullptr, false, lb0};
    return {Cost{lb0, 0}, nullptr, false};
  }

  // Sentinel against AddRow recursion cycles: direct cost upper bound,
  // stored on canonical indices.
  {
    auto inv_r = invert_perm(canon.row_perm);
    auto inv_c = invert_perm(canon.col_perm);
    vector<std::pair<int, int>> canonical_nz;
    for (auto& rc : g.entries())
      canonical_nz.emplace_back(inv_r[rc.first], inv_c[rc.second]);
    std::sort(canonical_nz.begin(), canonical_nz.end());
    cache[canon.hash] = {direct_cost(n), make_direct(n, canonical_nz),
                         true, 0};
  }

  std::pair<Cost, ProcPtr> best;
  bool has_best = false;
  long long node_lb = kInfBudget;  // min candidate bound (all-pruned)

  auto ub = [&]() -> long long {
    long long b = budget;
    if (has_best && best.first.total() < b) b = best.first.total();
    return b;
  };
  auto note_lb = [&](long long v) {
    if (v < node_lb) node_lb = v;
  };

  // Strategy 1: block triangular via DM.
  {
    DMResult dm = dulmage_mendelsohn(g);
    if (dm.block_sizes.size() > 1) {
      long long immediate = (long long)dm.block_sizes.size() - 1;
      Cost total{0, 0};
      vector<ProcPtr> blocks;
      int offset = 0;
      bool abandoned = false;
      for (int bs : dm.block_sizes) {
        long long sub_budget = ub() - immediate - total.total();
        if (sub_budget <= 0) {
          note_lb(immediate + total.total());
          abandoned = true;
          break;
        }
        vector<int> brs(dm.row_perm.begin() + offset,
                        dm.row_perm.begin() + offset + bs);
        vector<int> bcs(dm.col_perm.begin() + offset,
                        dm.col_perm.begin() + offset + bs);
        SearchResult sr = search(g.submatrix(brs, bcs), cache, sub_budget);
        if (!sr.exact) {
          note_lb(immediate + total.total() + sr.cost.total());
          abandoned = true;
          break;
        }
        total = total + sr.cost;
        blocks.push_back(sr.proc);
        offset += bs;
      }
      if (!abandoned) {
        total.mults += immediate;
        auto p = std::make_shared<Process>();
        p->kind = Process::kBlockTri;
        p->blocks = std::move(blocks);
        p->row_perm = dm.row_perm;
        p->col_perm = dm.col_perm;
        p->nz = g.entries();
        consider(best, has_best, total, p);
      }
    }
  }

  // Strategies 2/3: row and column expansions.
  for (int axis = 0; axis < 2; ++axis) {
    for (int line = 0; line < n; ++line) {
      vector<int> nonzeros =
          axis == 0 ? g.row_neighbors(line) : g.col_neighbors(line);
      if (nonzeros.empty()) {
        // Zero line: determinant trivially zero.
        consider(best, has_best, Cost{0, 0}, make_direct(n, g.entries()));
        continue;
      }
      int k = (int)nonzeros.size();
      long long immediate = 2LL * k - 1;  // k mults + (k-1) adds
      Cost total{0, 0};
      bool abandoned = false;
      vector<std::pair<int, ProcPtr>> minors;
      for (int crossing : nonzeros) {
        long long sub_budget = ub() - immediate - total.total();
        if (sub_budget <= 0) {
          note_lb(immediate + total.total());
          abandoned = true;
          break;
        }
        vector<int> rs, cs;
        for (int i = 0; i < n; ++i) {
          if (axis == 0) {
            if (i != line) rs.push_back(i);
            if (i != crossing) cs.push_back(i);
          } else {
            if (i != crossing) rs.push_back(i);
            if (i != line) cs.push_back(i);
          }
        }
        SearchResult sr = search(g.submatrix(rs, cs), cache, sub_budget);
        if (!sr.exact) {
          note_lb(immediate + total.total() + sr.cost.total());
          abandoned = true;
          break;
        }
        total = total + sr.cost;
        minors.emplace_back(crossing, sr.proc);
      }
      if (abandoned) continue;
      total.mults += k;
      if (k > 1) total.adds += k - 1;
      auto p = std::make_shared<Process>();
      p->kind = axis == 0 ? Process::kRowExp : Process::kColExp;
      p->line = line;
      p->minors = std::move(minors);
      p->nz = g.entries();
      consider(best, has_best, total, p);
    }
  }

  // Strategy 4: AddRow eliminations that strictly reduce nnz.
  {
    int nnz_before = g.total_nnz();
    for (int src = 0; src < n; ++src) {
      int src_nnz = g.row_nnz(src);
      for (int dst = 0; dst < n; ++dst) {
        if (src == dst) continue;
        uint64_t both = g.bits[src] & g.bits[dst];
        uint64_t b = both;
        while (b) {
          int pivot_col = __builtin_ctzll(b);
          b &= b - 1;
          Pattern mod = g.with_add_row(src, dst, pivot_col);
          if (mod.total_nnz() >= nnz_before) continue;
          int overlap =
              __builtin_popcountll(both & ~(1ull << pivot_col));
          Cost op{src_nnz - 1, overlap};
          // Static bound first: skip without recursing (this is
          // where the exponential AddRow branching gets cut).
          long long mod_lb = influential_lower_bound(mod);
          if (op.total() + mod_lb >= ub()) {
            note_lb(op.total() + mod_lb);
            continue;
          }
          SearchResult sr = search(mod, cache, ub() - op.total());
          if (!sr.exact) {
            note_lb(op.total() + sr.cost.total());
            continue;
          }
          auto p = std::make_shared<Process>();
          p->kind = Process::kAddRow;
          p->src = src;
          p->dst = dst;
          p->pivot_col = pivot_col;
          p->result = sr.proc;
          p->nz = g.entries();
          consider(best, has_best, op + sr.cost, p);
        }
      }
    }
  }

  if (has_best && best.first.total() < budget) {
    auto inv_r = invert_perm(canon.row_perm);
    auto inv_c = invert_perm(canon.col_perm);
    cache[canon.hash] = {best.first,
                         remap_process(best.second, inv_r, inv_c), true,
                         best.first.total()};
    if (g_exact_cache) (*g_exact_cache)[key] = best;
    return {best.first, best.second, true};
  }

  if (!has_best && node_lb >= kInfBudget) {
    // No strategy applied at all: direct evaluation fallback.
    best = {direct_cost(n), make_direct(n, g.entries())};
    auto inv_r = invert_perm(canon.row_perm);
    auto inv_c = invert_perm(canon.col_perm);
    cache[canon.hash] = {best.first,
                         remap_process(best.second, inv_r, inv_c), true,
                         best.first.total()};
    if (g_exact_cache) (*g_exact_cache)[key] = best;
    return {best.first, best.second, true};
  }

  // Bound-limited: every candidate proved >= budget.
  long long lb = node_lb;
  if (has_best && best.first.total() < lb) lb = best.first.total();
  if (lb0 > lb) lb = lb0;
  cache[canon.hash] = {Cost{lb, 0}, nullptr, false, lb};
  return {Cost{lb, 0}, nullptr, false};
}

// ---------------------------------------------------------------------------
// JSON emission
// ---------------------------------------------------------------------------

void emit_int_array(string& out, const vector<int>& v) {
  out += '[';
  for (size_t i = 0; i < v.size(); ++i) {
    if (i) out += ',';
    out += std::to_string(v[i]);
  }
  out += ']';
}

void emit_nz(string& out, const vector<std::pair<int, int>>& nz) {
  out += '[';
  for (size_t i = 0; i < nz.size(); ++i) {
    if (i) out += ',';
    out += '[';
    out += std::to_string(nz[i].first);
    out += ',';
    out += std::to_string(nz[i].second);
    out += ']';
  }
  out += ']';
}

void emit_process(string& out, const ProcPtr& p) {
  out += '{';
  switch (p->kind) {
    case Process::kDirect:
      out += "\"kind\":\"Direct\",\"size\":" + std::to_string(p->size);
      break;
    case Process::kRowExp:
    case Process::kColExp:
      out += p->kind == Process::kRowExp ? "\"kind\":\"RowExpansion\",\"row\":"
                                         : "\"kind\":\"ColExpansion\",\"col\":";
      out += std::to_string(p->line);
      out += ",\"minors\":[";
      for (size_t i = 0; i < p->minors.size(); ++i) {
        if (i) out += ',';
        out += "[" + std::to_string(p->minors[i].first) + ",";
        emit_process(out, p->minors[i].second);
        out += ']';
      }
      out += ']';
      break;
    case Process::kBlockTri:
      out += "\"kind\":\"BlockTriangular\",\"row_perm\":";
      emit_int_array(out, p->row_perm);
      out += ",\"col_perm\":";
      emit_int_array(out, p->col_perm);
      out += ",\"blocks\":[";
      for (size_t i = 0; i < p->blocks.size(); ++i) {
        if (i) out += ',';
        emit_process(out, p->blocks[i]);
      }
      out += ']';
      break;
    case Process::kAddRow:
      out += "\"kind\":\"AddRow\",\"src\":" + std::to_string(p->src);
      out += ",\"dst\":" + std::to_string(p->dst);
      out += ",\"pivot_col\":" + std::to_string(p->pivot_col);
      out += ",\"result\":";
      emit_process(out, p->result);
      break;
  }
  out += ",\"nz\":";
  emit_nz(out, p->nz);
  out += '}';
}

char* dup_string(const string& s) {
  char* out = (char*)std::malloc(s.size() + 1);
  std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

}  // namespace

extern "C" {

// All functions return malloc'd JSON; free with planner_free.

const char* planner_find_optimal(const uint8_t* data, int rows, int cols) {
  if (rows != cols || rows > 64) return nullptr;
  Pattern g = pattern_from_bytes(data, rows, cols);
  Cache cache;
  ExactCache exact;
  g_exact_cache = &exact;
  SearchResult sres = search(g, cache, kInfBudget);
  Cost cost = sres.cost;
  ProcPtr proc = sres.proc;
  g_exact_cache = nullptr;
  string out = "{\"cost\":{\"mults\":" + std::to_string(cost.mults) +
               ",\"adds\":" + std::to_string(cost.adds) + "},\"process\":";
  emit_process(out, proc);
  out += '}';
  return dup_string(out);
}

const char* planner_dm(const uint8_t* data, int rows, int cols) {
  if (rows > 64 || cols > 64) return nullptr;
  DMResult res = dulmage_mendelsohn(pattern_from_bytes(data, rows, cols));
  string out = "{\"row_perm\":";
  emit_int_array(out, res.row_perm);
  out += ",\"col_perm\":";
  emit_int_array(out, res.col_perm);
  out += ",\"block_sizes\":";
  emit_int_array(out, res.block_sizes);
  out += '}';
  return dup_string(out);
}

const char* planner_canonicalize(const uint8_t* data, int rows, int cols) {
  if (rows > 64 || cols > 64) return nullptr;
  CanonicalForm cf = canonicalize(pattern_from_bytes(data, rows, cols));
  string out = "{\"row_perm\":";
  emit_int_array(out, cf.row_perm);
  out += ",\"col_perm\":";
  emit_int_array(out, cf.col_perm);
  out += ",\"hash\":" + std::to_string(cf.hash);
  out += '}';
  return dup_string(out);
}

int planner_perm_equivalent(const uint8_t* a, const uint8_t* b, int rows,
                            int cols) {
  if (rows > 64 || cols > 64) return -1;
  return perm_equivalent(pattern_from_bytes(a, rows, cols),
                         pattern_from_bytes(b, rows, cols))
             ? 1
             : 0;
}

void planner_free(const char* p) { std::free((void*)p); }
}
