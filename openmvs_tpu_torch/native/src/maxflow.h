// s-t max-flow / min-cut for graph-cut surface extraction.  Role equivalent
// of the reference's IBFS solver (libs/Math/IBFS/IBFS.h, used by
// SceneReconstruct.cpp:58-108).  Implemented as Dinic's algorithm (level-graph
// BFS + blocking-flow DFS with current-arc): terminates in at most V phases
// regardless of capacity values, which matters with float weights, and the
// level graphs are shallow for visibility graphs (source and sink regions are
// separated by a thin surface band).
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace omvs {

class MaxFlow {
 public:
  explicit MaxFlow(int64_t n_nodes);

  // terminal capacities: source edge cap_s, sink edge cap_t
  void add_terminal(int64_t node, double cap_s, double cap_t);
  // bidirectional edge with independent capacities
  void add_edge(int64_t a, int64_t b, double cap_ab, double cap_ba);

  double compute();                         // returns max flow value
  bool is_source_side(int64_t node) const;  // after compute()

 private:
  struct Arc {
    int64_t head;   // target node
    double r_cap;   // residual capacity
  };

  int64_t n_;
  // terminal residuals: tr_cap > 0 source->node, < 0 node->sink
  std::vector<double> tr_cap_;
  std::vector<Arc> arcs_;                  // sister of arc a is a^1
  std::vector<std::vector<int64_t>> out_;  // per-node arc indices
  std::vector<int32_t> level_;
  std::vector<int32_t> cur_;
  double flow_ = 0;

  bool bfs();
  double dfs(int64_t v, double pushed);
};

// Two-tree incremental max-flow in the Boykov-Kolmogorov / IBFS family (the
// algorithm class of the reference's solver, libs/Math/IBFS).  S- and T-trees
// grow breadth-first; when they touch, each bridge arc is drained by repeated
// augmentation with incremental orphan re-adoption (cycle-safe via a
// root-walk guard), instead of rebuilding level graphs per phase.  A final
// Dinic sweep certifies optimality (it mops up the tiny flow remainder the
// heuristic tree phase leaves and computes the exact min-cut reachability).
// On the bundled scene's 622k-cell instance: Dinic alone 50s (292 BFS
// phases) -> 5.7s (tree phase 4.5s + certification 1.2s), identical cut.
class IBFS {
 public:
  explicit IBFS(int64_t n_nodes);

  void add_terminal(int64_t node, double cap_s, double cap_t);
  void add_edge(int64_t a, int64_t b, double cap_ab, double cap_ba);

  double compute();
  bool is_source_side(int64_t node) const;

 private:
  struct Arc {
    int64_t head;
    double r_cap;
  };
  static constexpr int64_t kNone = -1;
  static constexpr int64_t kTerm = -2;  // parent is s or t directly

  int64_t n_;
  std::vector<double> tr_cap_;
  std::vector<Arc> arcs_;                  // sister of arc a is a^1
  std::vector<std::vector<int64_t>> out_;  // per-node outgoing arc indices
  std::vector<int32_t> label_;             // >0 S-tree depth, <0 -T depth, 0 free
  std::vector<int64_t> par_;               // parent arc (see .cpp), kTerm, kNone
  std::vector<int64_t> first_son_, next_sib_, prev_sib_;
  std::vector<char> inq_;                  // orphan-queue membership
  std::vector<char> act_;                  // active-queue membership
  std::vector<std::vector<int64_t>> orph_; // orphan buckets by |label|
  std::vector<int32_t> level_;             // certification sweep + final cut
  std::vector<int32_t> cur_;
  double flow_ = 0;

  double dinic_dfs(int64_t v, double pushed);
  bool rooted_without(int64_t u, int64_t avoid) const;
  void set_parent(int64_t v, int64_t arc);
  void cut_from_parent(int64_t v);
  void make_orphan(int64_t v);
  void orphan_children(int64_t v);
  void process_orphans(std::vector<int64_t>& next_s, std::vector<int64_t>& next_t);
  void augment(int64_t v, int64_t bridge, int64_t w,
               std::vector<int64_t>& next_s, std::vector<int64_t>& next_t);
};

}  // namespace omvs
