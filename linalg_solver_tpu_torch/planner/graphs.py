"""Graph algorithms underpinning the Dulmage–Mendelsohn decomposition:
Hopcroft–Karp maximum bipartite matching (O(E·sqrt(V))) and Tarjan's SCC
(O(V+E), iterative, SCCs returned sinks-first i.e. reverse topological).

Mirrors linalg-solver's linalg-helper/src/hopcroft_karp.rs:13-84 and
tarjan.rs:17-66.
"""

from __future__ import annotations

from collections import deque
from typing import List

from .pattern import Matching, SparsityPattern

_INF = float("inf")


def hopcroft_karp(pattern: SparsityPattern) -> Matching:
    """Maximum matching between rows and columns of a sparsity pattern."""
    rows = pattern.rows
    matching = Matching(rows, pattern.cols)
    NIL = rows
    dist = [0.0] * (rows + 1)

    def bfs() -> bool:
        queue = deque()
        for r in range(rows):
            if matching.row_to_col[r] is None:
                dist[r] = 0
                queue.append(r)
            else:
                dist[r] = _INF
        dist[NIL] = _INF
        while queue:
            r = queue.popleft()
            if dist[r] < dist[NIL]:
                for c in pattern.row_neighbors(r):
                    nxt = matching.col_to_row[c]
                    nxt = NIL if nxt is None else nxt
                    if dist[nxt] == _INF:
                        dist[nxt] = dist[r] + 1
                        if nxt != NIL:
                            queue.append(nxt)
        return dist[NIL] != _INF

    def dfs(r: int) -> bool:
        if r == NIL:
            return True
        for c in pattern.row_neighbors(r):
            nxt = matching.col_to_row[c]
            nxt = NIL if nxt is None else nxt
            if dist[nxt] == dist[r] + 1 and dfs(nxt):
                matching.match_pair(r, c)
                return True
        dist[r] = _INF
        return False

    while bfs():
        for r in range(rows):
            if matching.row_to_col[r] is None:
                dfs(r)
    return matching


def tarjan_scc(adj: List[List[int]]) -> List[List[int]]:
    """Strongly connected components, sinks first (reverse topological).

    Implemented with an explicit stack to avoid Python recursion limits.
    """
    n = len(adj)
    indices: List[int | None] = [None] * n
    lowlink = [0] * n
    on_stack = [False] * n
    stack: List[int] = []
    sccs: List[List[int]] = []
    counter = 0

    for root in range(n):
        if indices[root] is not None:
            continue
        # Each frame: (vertex, iterator position into adj[vertex])
        work = [(root, 0)]
        while work:
            v, edge_i = work[-1]
            if edge_i == 0:
                indices[v] = counter
                lowlink[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            advanced = False
            while edge_i < len(adj[v]):
                w = adj[v][edge_i]
                edge_i += 1
                if indices[w] is None:
                    work[-1] = (v, edge_i)
                    work.append((w, 0))
                    advanced = True
                    break
                if on_stack[w]:
                    lowlink[v] = min(lowlink[v], indices[w])
            if advanced:
                continue
            # All edges of v processed.
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[v])
            if lowlink[v] == indices[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc.append(w)
                    if w == v:
                        break
                sccs.append(scc)
    return sccs
