"""Lightweight undirected graph with NetworkX-compatible iteration order.

A copy of ``tmat_tpu/topo/lightgraph.py`` (the port has no networkx). It
keeps exactly the semantics the Morse forest analysis depends on:

- node iteration order = first-appearance order over added edges
- neighbor iteration order = edge insertion order
- degree/remove/isolate APIs used by MorseGraph

so results are identical to a NetworkX-based implementation, with plain
dict/list operations.
"""

from __future__ import annotations

from typing import Dict, Iterable, List


class LightGraph:
    __slots__ = ("_adj",)

    def __init__(self):
        self._adj: Dict[int, List[int]] = {}

    @classmethod
    def from_edges(cls, edges: Iterable) -> "LightGraph":
        g = cls()
        for u, v in edges:
            g.add_edge(int(u), int(v))
        return g

    def add_edge(self, u: int, v: int) -> None:
        if u == v:
            # nx.Graph keeps self-loops (degree +2); none of the Morse
            # pipelines can produce one, so fail loudly rather than let a
            # silent isolate-deletion divergence slip in
            raise ValueError(f"self-loop edges are not supported (node {u})")
        adj = self._adj
        if u not in adj:
            adj[u] = []
        if v not in adj:
            adj[v] = []
        if v not in adj[u]:
            adj[u].append(v)
            adj[v].append(u)

    @property
    def nodes(self):
        return self._adj.keys()

    def number_of_nodes(self) -> int:
        return len(self._adj)

    def neighbors(self, n: int):
        return self._adj[n]

    class _DegreeView:
        __slots__ = ("_adj",)

        def __init__(self, adj):
            self._adj = adj

        def __getitem__(self, n):
            return len(self._adj[n])

        def __iter__(self):
            for n, nbrs in self._adj.items():
                yield n, len(nbrs)

    @property
    def degree(self):
        return LightGraph._DegreeView(self._adj)

    def remove_edge(self, u: int, v: int) -> None:
        adj = self._adj
        if u in adj and v in adj[u]:
            adj[u].remove(v)
            adj[v].remove(u)

    def remove_edges_from(self, edges: Iterable) -> None:
        for u, v in edges:
            self.remove_edge(int(u), int(v))

    def remove_nodes_from(self, nodes: Iterable) -> None:
        adj = self._adj
        for n in list(nodes):
            n = int(n)
            if n in adj:
                for nbr in adj[n]:
                    adj[nbr].remove(n)
                del adj[n]

    def copy(self) -> "LightGraph":
        """Copy with nx.Graph.copy() adjacency semantics.

        nx's copy rebuilds via add_edges_from over the adjacency scan, so
        a node's neighbor order in the COPY follows each incident edge's
        first occurrence in node-scan order — NOT the original adjacency
        order (a neighbor that precedes the node in insertion order moves
        to the front). MorseGraph's trim/forest walks are neighbor-order
        dependent, so replicating this quirk is required for bit-equal
        branch decompositions.
        """
        g = LightGraph()
        adj: Dict[int, List[int]] = {n: [] for n in self._adj}
        for u, nbrs in self._adj.items():
            for v in nbrs:
                if v not in adj[u]:
                    adj[u].append(v)
                if u not in adj[v]:
                    adj[v].append(u)
        g._adj = adj
        return g

    def edges(self, nbunch: Iterable) -> List[tuple]:
        """Edges incident to the given nodes (may list both directions;
        callers treat the result as a set of removals)."""
        adj = self._adj
        out = []
        for n in nbunch:
            n = int(n)
            if n in adj:
                out.extend((n, nbr) for nbr in adj[n])
        return out

    def isolates(self) -> List[int]:
        return [n for n, nbrs in self._adj.items() if not nbrs]

    def connected_components(self):
        """Components as node lists, in first-appearance order (BFS), like
        nx.connected_components over an insertion-ordered graph."""
        from collections import deque

        seen = set()
        for start in self._adj:
            if start in seen:
                continue
            comp = [start]
            seen.add(start)
            queue = deque([start])
            while queue:
                v = queue.popleft()
                for n in self._adj[v]:
                    if n not in seen:
                        seen.add(n)
                        comp.append(n)
                        queue.append(n)
            yield comp
