#include "maxflow.h"

#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <limits>

namespace omvs {

namespace {
constexpr double kEps = 1e-12;  // capacities below this count as saturated
}

MaxFlow::MaxFlow(int64_t n_nodes) : n_(n_nodes) {
  tr_cap_.assign(n_, 0.0);
  out_.resize(n_);
  level_.assign(n_, -1);
  cur_.assign(n_, 0);
}

void MaxFlow::add_terminal(int64_t node, double cap_s, double cap_t) {
  // antagonistic terminal capacities cancel; only the difference matters for
  // the cut (the cancelled part is immediate flow)
  flow_ += std::min(cap_s, cap_t);
  tr_cap_[node] += cap_s - cap_t;
}

void MaxFlow::add_edge(int64_t a, int64_t b, double cap_ab, double cap_ba) {
  int64_t ia = (int64_t)arcs_.size();
  arcs_.push_back({b, cap_ab});
  arcs_.push_back({a, cap_ba});
  out_[a].push_back(ia);
  out_[b].push_back(ia + 1);
}

// BFS from all source-attached nodes; returns true if any sink-attached node
// is reachable in the residual graph.
bool MaxFlow::bfs() {
  std::fill(level_.begin(), level_.end(), -1);
  std::vector<int64_t> q;
  q.reserve(1024);
  for (int64_t i = 0; i < n_; ++i) {
    if (tr_cap_[i] > kEps) {
      level_[i] = 0;
      q.push_back(i);
    }
  }
  bool reached = false;
  for (size_t h = 0; h < q.size(); ++h) {
    int64_t v = q[h];
    if (tr_cap_[v] < -kEps) reached = true;
    for (int64_t a : out_[v]) {
      if (arcs_[a].r_cap <= kEps) continue;
      int64_t w = arcs_[a].head;
      if (level_[w] >= 0) continue;
      level_[w] = level_[v] + 1;
      q.push_back(w);
    }
  }
  return reached;
}

// DFS blocking flow: push up to `pushed` units from v toward any sink node.
double MaxFlow::dfs(int64_t v, double pushed) {
  if (tr_cap_[v] < -kEps) {
    double d = std::min(pushed, -tr_cap_[v]);
    tr_cap_[v] += d;
    return d;
  }
  for (int32_t& ci = cur_[v]; ci < (int32_t)out_[v].size(); ++ci) {
    int64_t a = out_[v][ci];
    Arc& arc = arcs_[a];
    if (arc.r_cap <= kEps) continue;
    int64_t w = arc.head;
    if (level_[w] != level_[v] + 1) continue;
    double d = dfs(w, std::min(pushed, arc.r_cap));
    if (d > 0) {
      arc.r_cap -= d;
      arcs_[a ^ 1].r_cap += d;
      return d;
    }
  }
  level_[v] = -1;  // dead end: prune
  return 0;
}

double MaxFlow::compute() {
  const bool dbg = getenv("OMVS_CUT_DEBUG") != nullptr;
  double t_bfs = 0, t_dfs = 0;
  int phases = 0;
  auto now = [] { return std::chrono::duration<double>(
      std::chrono::steady_clock::now().time_since_epoch()).count(); };
  for (;;) {
    double t0 = now();
    bool r = bfs();
    t_bfs += now() - t0;
    if (!r) break;
    ++phases;
    t0 = now();
    std::fill(cur_.begin(), cur_.end(), 0);
    for (int64_t i = 0; i < n_; ++i) {
      if (tr_cap_[i] <= kEps || level_[i] != 0) continue;
      while (tr_cap_[i] > kEps) {
        double d = dfs(i, tr_cap_[i]);
        if (d <= 0) break;
        tr_cap_[i] -= d;
        flow_ += d;
      }
    }
    t_dfs += now() - t0;
    if (dbg && (phases % 10 == 0))
      fprintf(stderr, "[maxflow] phase %d flow=%.9e\n", phases, flow_);
  }
  if (dbg) fprintf(stderr, "[maxflow] phases=%d bfs=%.1fs dfs=%.1fs\n",
                   phases, t_bfs, t_dfs);
  // final reachability defines the cut: source side = reachable from a
  // source-attached node in the residual graph
  bfs();
  return flow_;
}

bool MaxFlow::is_source_side(int64_t node) const { return level_[node] >= 0; }

// ---------------------------------------------------------------------------
// IBFS-class incremental solver (see maxflow.h).  The two-tree phase does the
// heavy lifting with incremental orphan adoption; a Dinic sweep afterwards
// certifies optimality (it finds zero or near-zero augmenting paths when the
// tree phase converged, and guarantees an exact max flow in all cases).

IBFS::IBFS(int64_t n_nodes) : n_(n_nodes) {
  tr_cap_.assign(n_, 0.0);
  out_.resize(n_);
  label_.assign(n_, 0);
  par_.assign(n_, kNone);
  first_son_.assign(n_, kNone);
  next_sib_.assign(n_, kNone);
  prev_sib_.assign(n_, kNone);
  inq_.assign(n_, 0);
  act_.assign(n_, 0);
}

void IBFS::add_terminal(int64_t node, double cap_s, double cap_t) {
  flow_ += std::min(cap_s, cap_t);
  tr_cap_[node] += cap_s - cap_t;
}

void IBFS::add_edge(int64_t a, int64_t b, double cap_ab, double cap_ba) {
  int64_t ia = (int64_t)arcs_.size();
  arcs_.push_back({b, cap_ab});
  arcs_.push_back({a, cap_ba});
  out_[a].push_back(ia);
  out_[b].push_back(ia + 1);
}

// par_[v] = arc v->parent; the tree-supporting residual is
//   S-tree: arcs_[par^1].r_cap (parent->v),  T-tree: arcs_[par].r_cap (v->parent)
void IBFS::set_parent(int64_t v, int64_t arc) {
  par_[v] = arc;
  if (arc == kTerm) return;
  int64_t p = arcs_[arc].head;
  next_sib_[v] = first_son_[p];
  prev_sib_[v] = kNone;
  if (first_son_[p] != kNone) prev_sib_[first_son_[p]] = v;
  first_son_[p] = v;
}

void IBFS::cut_from_parent(int64_t v) {
  int64_t arc = par_[v];
  if (arc != kNone && arc != kTerm) {
    int64_t p = arcs_[arc].head;
    if (prev_sib_[v] != kNone)
      next_sib_[prev_sib_[v]] = next_sib_[v];
    else
      first_son_[p] = next_sib_[v];
    if (next_sib_[v] != kNone) prev_sib_[next_sib_[v]] = prev_sib_[v];
  }
  par_[v] = kNone;
  next_sib_[v] = prev_sib_[v] = kNone;
}

void IBFS::make_orphan(int64_t v) {
  if (inq_[v]) return;
  cut_from_parent(v);
  size_t lvl = (size_t)(label_[v] > 0 ? label_[v] : -label_[v]);
  if (orph_.size() <= lvl) orph_.resize(lvl + 1);
  orph_[lvl].push_back(v);
  inq_[v] = 1;
}

void IBFS::orphan_children(int64_t v) {
  int64_t c = first_son_[v];
  first_son_[v] = kNone;
  while (c != kNone) {
    int64_t nx = next_sib_[c];
    par_[c] = kNone;
    next_sib_[c] = prev_sib_[c] = kNone;
    if (!inq_[c]) {
      size_t lvl = (size_t)(label_[c] > 0 ? label_[c] : -label_[c]);
      if (orph_.size() <= lvl) orph_.resize(lvl + 1);
      orph_[lvl].push_back(c);
      inq_[c] = 1;
    }
    c = nx;
  }
}

// true iff u's parent chain reaches a terminal without passing through
// `avoid` (prevents an orphan from adopting its own descendant, which would
// create a cycle — possible here because labels are relaxed lower bounds)
bool IBFS::rooted_without(int64_t u, int64_t avoid) const {
  while (u != avoid) {
    int64_t pa = par_[u];
    if (pa == kTerm) return true;
    if (pa == kNone) return false;
    u = arcs_[pa].head;
  }
  return false;
}

void IBFS::process_orphans(std::vector<int64_t>& next_s,
                           std::vector<int64_t>& next_t) {
  // BK-style adoption: an orphan may adopt ANY same-tree neighbor with a
  // residual tree arc whose parent chain reaches a terminal without passing
  // through the orphan (rooted_without prevents cycles).  If none exists the
  // node leaves the tree; its neighbors are re-activated so growth can
  // reclaim it later.
  for (size_t lvl = 1; lvl < orph_.size(); ++lvl) {
    while (!orph_[lvl].empty()) {
      int64_t v = orph_[lvl].back();
      orph_[lvl].pop_back();
      inq_[v] = 0;
      int32_t lab = label_[v];
      if (lab == 0) continue;
      bool sside = lab > 0;
      int64_t found = kNone;
      if (sside ? tr_cap_[v] > kEps : tr_cap_[v] < -kEps) {
        found = kTerm;
      } else {
        for (int64_t a : out_[v]) {
          int64_t u = arcs_[a].head;
          if (par_[u] == kNone) continue;
          if (label_[u] != (sside ? 1 : -1)) continue;
          double r = sside ? arcs_[a ^ 1].r_cap : arcs_[a].r_cap;
          if (r <= kEps) continue;
          if (rooted_without(u, v)) {
            found = a;
            break;
          }
        }
      }
      if (found != kNone) {
        set_parent(v, found);
        continue;
      }
      // leave the tree; re-activate neighbors that could re-grow this node
      orphan_children(v);
      label_[v] = 0;
      par_[v] = kNone;
      for (int64_t a : out_[v]) {
        int64_t u = arcs_[a].head;
        if (par_[u] == kNone || label_[u] == 0) continue;
        bool us = label_[u] > 0;
        double r = us ? arcs_[a ^ 1].r_cap : arcs_[a].r_cap;
        if (r > kEps && !act_[u]) {
          act_[u] = 1;
          (us ? next_s : next_t).push_back(u);
        }
      }
    }
  }
}

void IBFS::augment(int64_t v, int64_t bridge, int64_t w,
                   std::vector<int64_t>& next_s, std::vector<int64_t>& next_t) {
  // bottleneck along s->...->v -bridge-> w->...->t
  double b = arcs_[bridge].r_cap;
  int64_t x = v;
  while (par_[x] != kTerm) {
    int64_t pa = par_[x];
    b = std::min(b, arcs_[pa ^ 1].r_cap);
    x = arcs_[pa].head;
  }
  b = std::min(b, tr_cap_[x]);
  int64_t y = w;
  while (par_[y] != kTerm) {
    int64_t pa = par_[y];
    b = std::min(b, arcs_[pa].r_cap);
    y = arcs_[pa].head;
  }
  b = std::min(b, -tr_cap_[y]);
  if (b <= 0) return;
  flow_ += b;
  arcs_[bridge].r_cap -= b;
  arcs_[bridge ^ 1].r_cap += b;
  x = v;
  while (par_[x] != kTerm) {
    int64_t pa = par_[x];
    arcs_[pa ^ 1].r_cap -= b;
    arcs_[pa].r_cap += b;
    int64_t p = arcs_[pa].head;
    if (arcs_[pa ^ 1].r_cap <= kEps) make_orphan(x);
    x = p;
  }
  tr_cap_[x] -= b;
  if (tr_cap_[x] <= kEps) make_orphan(x);
  y = w;
  while (par_[y] != kTerm) {
    int64_t pa = par_[y];
    arcs_[pa].r_cap -= b;
    arcs_[pa ^ 1].r_cap += b;
    int64_t p = arcs_[pa].head;
    if (arcs_[pa].r_cap <= kEps) make_orphan(y);
    y = p;
  }
  tr_cap_[y] += b;
  if (tr_cap_[y] >= -kEps) make_orphan(y);
  process_orphans(next_s, next_t);
}

double IBFS::compute() {
  const bool dbg = getenv("OMVS_CUT_DEBUG") != nullptr;
  auto now = [] { return std::chrono::duration<double>(
      std::chrono::steady_clock::now().time_since_epoch()).count(); };
  double t_start = now();
  int64_t n_aug = 0;
  std::vector<int64_t> fs, ft, nfs, nft;
  for (int64_t i = 0; i < n_; ++i) {
    if (tr_cap_[i] > kEps) {
      label_[i] = 1;
      par_[i] = kTerm;
      fs.push_back(i);
    } else if (tr_cap_[i] < -kEps) {
      label_[i] = -1;
      par_[i] = kTerm;
      ft.push_back(i);
    }
  }
  // BK-style growth: FIFO over active nodes of both trees
  for (int64_t v : fs) act_[v] = 1;
  for (int64_t v : ft) act_[v] = 1;
  std::vector<int64_t> active;
  active.reserve(fs.size() + ft.size());
  active.insert(active.end(), fs.begin(), fs.end());
  active.insert(active.end(), ft.begin(), ft.end());
  for (size_t qi = 0; qi < active.size(); ++qi) {
    int64_t v = active[qi];
    act_[v] = 0;
    if (par_[v] == kNone || label_[v] == 0) continue;
    bool grow_s = label_[v] > 0;
    for (size_t ai = 0; ai < out_[v].size(); ++ai) {
      int64_t a = out_[v][ai];
      double r = grow_s ? arcs_[a].r_cap : arcs_[a ^ 1].r_cap;
      if (r <= kEps) continue;
      int64_t w = arcs_[a].head;
      int32_t lw = label_[w];
      if (lw == 0) {
        label_[w] = grow_s ? 1 : -1;
        set_parent(w, a ^ 1);
        if (!act_[w]) {
          act_[w] = 1;
          active.push_back(w);
        }
      } else if (grow_s ? lw < 0 : lw > 0) {
        // drain this bridge: re-augment until it saturates or either
        // endpoint leaves its tree (adoption may reroute the upstream path,
        // freeing more capacity through the same bridge)
        while (par_[w] != kNone && (grow_s ? label_[w] < 0 : label_[w] > 0) &&
               (grow_s ? arcs_[a].r_cap : arcs_[a ^ 1].r_cap) > kEps) {
          if (grow_s)
            augment(v, a, w, active, active);
          else
            augment(w, a ^ 1, v, active, active);
          ++n_aug;
          if (par_[v] == kNone || label_[v] == 0) break;
        }
        if (par_[v] == kNone || label_[v] == 0) break;
      }
    }
    if (dbg && (qi % 2000000) == 0)
      fprintf(stderr, "[bk] scanned=%zu queue=%zu aug=%lld flow=%.6e t=%.1fs\n",
              qi, active.size(), (long long)n_aug, flow_, now() - t_start);
  }
  if (dbg) fprintf(stderr, "[bk] tree phase done: flow=%.6e aug=%lld t=%.1fs\n",
                   flow_, (long long)n_aug, now() - t_start);
  // certification sweep: plain Dinic on the residual graph.  When the tree
  // phase converged this finds no augmenting path and costs one BFS.
  level_.assign(n_, -1);
  cur_.assign(n_, 0);
  for (;;) {
    // BFS
    std::fill(level_.begin(), level_.end(), -1);
    std::vector<int64_t> q;
    for (int64_t i = 0; i < n_; ++i)
      if (tr_cap_[i] > kEps) {
        level_[i] = 0;
        q.push_back(i);
      }
    bool reached = false;
    for (size_t h = 0; h < q.size(); ++h) {
      int64_t vv = q[h];
      if (tr_cap_[vv] < -kEps) reached = true;
      for (int64_t a : out_[vv]) {
        if (arcs_[a].r_cap <= kEps) continue;
        int64_t wv = arcs_[a].head;
        if (level_[wv] >= 0) continue;
        level_[wv] = level_[vv] + 1;
        q.push_back(wv);
      }
    }
    if (!reached) break;
    std::fill(cur_.begin(), cur_.end(), 0);
    for (int64_t i = 0; i < n_; ++i) {
      if (tr_cap_[i] <= kEps || level_[i] != 0) continue;
      while (tr_cap_[i] > kEps) {
        double d = dinic_dfs(i, tr_cap_[i]);
        if (d <= 0) break;
        tr_cap_[i] -= d;
        flow_ += d;
      }
    }
  }
  return flow_;
}

double IBFS::dinic_dfs(int64_t v, double pushed) {
  if (tr_cap_[v] < -kEps) {
    double d = std::min(pushed, -tr_cap_[v]);
    tr_cap_[v] += d;
    return d;
  }
  for (int32_t& ci = cur_[v]; ci < (int32_t)out_[v].size(); ++ci) {
    int64_t a = out_[v][ci];
    Arc& arc = arcs_[a];
    if (arc.r_cap <= kEps) continue;
    int64_t w = arc.head;
    if (level_[w] != level_[v] + 1) continue;
    double d = dinic_dfs(w, std::min(pushed, arc.r_cap));
    if (d > 0) {
      arc.r_cap -= d;
      arcs_[a ^ 1].r_cap += d;
      return d;
    }
  }
  level_[v] = -1;
  return 0;
}

bool IBFS::is_source_side(int64_t node) const { return level_[node] >= 0; }

}  // namespace omvs
