"""Structural analysis of Tanner graphs: girth and cycle census.

The reference asserts its construction yields girth >= 6 Tanner graphs
("twisted duality ... girth at least six", commented construction notes at
``QEC_LDPC_CSS.cu:161-164``) but ships no code to check it; this module
supplies the verifier.  Girth is the key structural quality measure for BP —
4-cycles make messages correlate after one iteration and visibly degrade the
decoder, which is why the Hagiwara–Imai exponent construction is designed to
avoid them.

Two independent implementations (each tests the other):

* :func:`tanner_girth` — exact BFS girth on the expanded bipartite graph
  (works for ANY parity-check matrix).
* :func:`qc_has_4cycles` — O((JL)^2) exponent-table test special to QC
  codes: block rows b1 != b2 and columns l1 != l2 close a 4-cycle iff
  ``C[b1,l1] - C[b1,l2] + C[b2,l2] - C[b2,l1] == 0 (mod P)`` (the circulant
  alternating-sum condition).
"""

from __future__ import annotations

from collections import deque

import numpy as np


def _adjacency(pcm: np.ndarray) -> tuple[list[list[int]], int, int]:
    """Bipartite adjacency lists: nodes 0..m-1 are checks, m..m+n-1 vars."""
    pcm = np.asarray(pcm) % 2
    m, n = pcm.shape
    adj: list[list[int]] = [[] for _ in range(m + n)]
    rows, cols = np.nonzero(pcm)
    for r, c in zip(rows.tolist(), cols.tolist()):
        adj[r].append(m + c)
        adj[m + c].append(r)
    return adj, m, n


def tanner_girth(pcm: np.ndarray, cap: int | None = None) -> int:
    """Exact girth (length of the shortest cycle) of the Tanner graph of
    ``pcm``; returns 0 for an edgeless graph.  Bipartite, so always even and
    >= 4.  ``cap``: optional early-out — stop once a cycle <= cap is found
    (the returned value is then exact only if <= cap).

    BFS from every node; the shortest cycle through node s shows up as an
    edge between two visited vertices whose depths certify a closed walk
    (standard unweighted-girth BFS).
    """
    adj, m, n = _adjacency(pcm)
    total = m + n
    best = 0
    for s in range(total):
        depth = np.full(total, -1, dtype=np.int64)
        parent = np.full(total, -1, dtype=np.int64)
        depth[s] = 0
        dq = deque([s])
        while dq:
            u = dq.popleft()
            if best and 2 * depth[u] >= best:
                break  # no shorter cycle can be found from s
            for v in adj[u]:
                if depth[v] < 0:
                    depth[v] = depth[u] + 1
                    parent[v] = u
                    dq.append(v)
                elif parent[u] != v:
                    # non-tree edge: cycle length through (u, v)
                    cyc = int(depth[u] + depth[v] + 1)
                    if cyc % 2 == 1:
                        cyc += 1  # bipartite: odd closures are re-meets, round up
                    if best == 0 or cyc < best:
                        best = cyc
        if best == 4 or (cap is not None and best and best <= cap):
            return best
    return best


def qc_has_4cycles(table: np.ndarray, P: int) -> bool:
    """QC-specific 4-cycle test on the exponent table (B x L over Z_P):
    some pair of block rows and block columns closes a 4-cycle iff the
    alternating exponent sum vanishes mod P."""
    t = np.asarray(table, dtype=np.int64) % P
    B, L = t.shape
    for b1 in range(B):
        for b2 in range(b1 + 1, B):
            d = (t[b1] - t[b2]) % P  # (L,)
            # 4-cycle iff d[l1] == d[l2] for some l1 != l2
            if len(np.unique(d)) < L:
                return True
    return False


def girth_report(code) -> dict:
    """Girth census for a QuantumLDPCCode: both PCMs, via both methods."""
    gx = tanner_girth(code.pcm_x)
    gz = tanner_girth(code.pcm_z)
    return {
        "girth_x": gx,
        "girth_z": gz,
        "qc_4cycles_x": qc_has_4cycles(code.hc, code.P),
        "qc_4cycles_z": qc_has_4cycles(code.hd, code.P),
        "reference_claim_girth_ge_6": gx >= 6 and gz >= 6,
    }
