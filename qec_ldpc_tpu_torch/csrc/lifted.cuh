// The lifted-graph description read by both lifted kernels
// (csrc/lifted_min_sum.cu and csrc/lifted_bp.cu): their compile-time limits,
// the by-value graph and its validation on the host, and the variable-side
// routing resolved on the host (RankEdge, Routing).  Both kernels run one
// lane per CTA.  kernels/launch.py::lifted_description builds the host
// tables.
//
// Messages are (E*P, batch) float32 with the batch trailing, edge blocks in
// check-major order (check row c owns blocks c*Dc .. c*Dc+Dc-1), each
// block's rows check-indexed: row e*P + r is check lane r of block e.  Block
// e with shift (a, b) joins check lane (r1, r2) to var lane
// ((r1 + a) % l, (r2 + b) % m), lanes flattened row-major (r1*m + r2); a
// 1-D group Z_P is (P, 1).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxEdgeBlocks = 64;
constexpr int kMaxDc = 16;     // check degree (edge blocks per check row)
constexpr int kMaxDv = 8;      // variable degree (edge blocks per var column)

struct Lifted {
  int l, m, P;                   // lift group Z_l x Z_m, P = l*m
  int C, V, Dc, Dv;              // check and var blocks, degrees
  int shift_a[kMaxEdgeBlocks];   // per edge block, in [0, l)
  int shift_b[kMaxEdgeBlocks];   // per edge block, in [0, m)
  int rank_edge[kMaxEdgeBlocks]; // (Dv, V): var block v's rank-i edge block
};

// Fill `g` from the HOST tables `edges` (E, 4) = (check block, var block, a,
// b) per edge block in check-major order with (a, b) in [0, l) x [0, m), and
// `ranks` (Dv, V) edge ids.  False for a graph outside the limits or not in
// check-major rank form, and for launch arguments no kernel takes.
inline bool describe_lifted(Lifted* g, const int32_t* edges,
                            const int32_t* ranks, int l, int m, int C, int V,
                            int Dc, int Dv, int E, int batch, int max_iters,
                            int check_every) {
  if (l < 1 || m < 1 || C < 1 || V < 1 || Dc < 1 || Dc > kMaxDc || Dv < 1 ||
      Dv > kMaxDv || E != C * Dc || E != V * Dv || E > kMaxEdgeBlocks ||
      batch < 1 || max_iters < 0 || check_every < 1) {
    return false;
  }
  g->l = l;
  g->m = m;
  g->P = l * m;
  g->C = C;
  g->V = V;
  g->Dc = Dc;
  g->Dv = Dv;
  for (int i = 0; i < kMaxEdgeBlocks; ++i) {
    g->shift_a[i] = g->shift_b[i] = g->rank_edge[i] = 0;
  }
  for (int eb = 0; eb < E; ++eb) {
    const int32_t* row = edges + 4 * eb;
    if (row[0] != eb / Dc || row[1] < 0 || row[1] >= V || row[2] < 0 ||
        row[2] >= l || row[3] < 0 || row[3] >= m) {
      return false;
    }
    g->shift_a[eb] = row[2];
    g->shift_b[eb] = row[3];
  }
  for (int i = 0; i < E; ++i) {
    const int eb = ranks[i];
    if (eb < 0 || eb >= E || edges[4 * eb + 1] != i % V) return false;
    g->rank_edge[i] = eb;
  }
  return true;
}

// One rank entry i*V + vb of the variable side: edge block eb =
// rank_edge[i*V + vb] resolved into what a variable phase needs.  Variable
// (vb, q1, q2)'s rank-i edge is check lane r = ((q1 - a) mod l)*m +
// (q2 - b) mod m of block eb: message row edge_base + r, check row
// check_base + r, position d in that check row.
struct RankEdge {
  int a, b;        // the block's shift, in [0, l) x [0, m)
  int edge_base;   // eb * P: the block's first message row
  int check_base;  // (eb / Dc) * P: its check row's first check
  int d;           // eb % Dc: its position in the check row
};

struct Routing {
  int l, m, P, C, V, Dc;
  RankEdge rank[kMaxEdgeBlocks];
};

// The routing of a graph describe_lifted accepted, with E edge blocks.
inline Routing resolve_routing(const Lifted& lg, int E) {
  Routing g;
  g.l = lg.l;
  g.m = lg.m;
  g.P = lg.P;
  g.C = lg.C;
  g.V = lg.V;
  g.Dc = lg.Dc;
  for (int i = 0; i < kMaxEdgeBlocks; ++i) g.rank[i] = RankEdge{0, 0, 0, 0, 0};
  for (int i = 0; i < E; ++i) {
    const int eb = lg.rank_edge[i];
    g.rank[i] = RankEdge{lg.shift_a[eb], lg.shift_b[eb], eb * lg.P,
                         (eb / lg.Dc) * lg.P, eb % lg.Dc};
  }
  return g;
}

}  // namespace
