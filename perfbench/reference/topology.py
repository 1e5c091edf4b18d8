"""Plain reference of the plate's host tail: the component filter and the
Morse graph's branch count and lengths.

Written for the benchmark in NumPy and SciPy, in float64, from the
published description of the original tool (fl_tissue_model_tools:
``transforms.filter_branch_seg_mask``, ``dmtgraph.compute_dmt_graph``, a
port of pydmtgraph, and ``topology.MorseGraph``, as set out in SURVEY.md
§2 and in the JAX package's docstrings). It shares no code with the
program's C++ engines. Where the tool's result depends on an order (which
of two equal values wins, which walk claims a vertex first, which node of
highest degree roots a tree), the order is the tool's own: the graph is a
dict of dicts in insertion order as NetworkX keeps it, and the sets are
Python's, built by the same additions, so they iterate as the tool's did.

- ``component_filter``: 8-connected components of the mask, each dropped
  when too circular (4 pi area / perimeter^2 > 0.8, perimeter as
  ``skimage.measure.perimeter`` gives it for the region alone) or when its
  skeleton has no fork;
- ``dmt_graph``: the discrete-Morse graph of an image: 0- and
  1-dimensional persistence of the negated image on the triangulated pixel
  grid, low-persistence vertex-edge pairs cancelled, and the unstable
  manifolds of the high saddles traced down to their minima;
- ``branch_stats``: the Morse graph's chains smoothed with fixed ends,
  short leaf segments trimmed in alternating passes, a BFS forest rooted at
  a node of highest degree, each vertex given to the branch of its farthest
  leaf, and the barcode's bars at least ``min_branch_length`` long.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, List, Tuple

import numpy as np
from scipy import ndimage

EIGHT = np.ones((3, 3), bool)
ZERO_ATOL = 1e-8  # a vertex this close to 0 is background: its edges are dropped

# skimage.measure.perimeter's weights by border code (1 + 2 x 4-neighbours
# + 10 x diagonal neighbours, each a border pixel of the same region)
_PERIM_W = np.zeros(50)
_PERIM_W[[5, 7, 15, 17, 25, 27]] = 1.0
_PERIM_W[[21, 33]] = math.sqrt(2)
_PERIM_W[[13, 23]] = (1 + math.sqrt(2)) / 2


def _shifted(a: np.ndarray, dr: int, dc: int) -> np.ndarray:
    """``a`` read at (r + dr, c + dc), zero outside."""
    h, w = a.shape
    p = np.pad(a, 1)
    return p[1 + dr : h + 1 + dr, 1 + dc : w + 1 + dc]


def perimeters(labels: np.ndarray, n: int) -> np.ndarray:
    """(n + 1,) perimeter of each labelled region taken alone (index 0 unused)."""
    fg = labels > 0
    border = fg & np.logical_or.reduce([_shifted(labels, dr, dc) != labels
                                        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1))])
    code = np.ones(labels.shape, np.int64)
    for weight, offsets in ((2, ((-1, 0), (1, 0), (0, -1), (0, 1))),
                            (10, ((-1, -1), (-1, 1), (1, -1), (1, 1)))):
        for dr, dc in offsets:
            code += weight * ((_shifted(labels, dr, dc) == labels) & _shifted(border, dr, dc))
    return np.bincount(labels[border], weights=_PERIM_W[code[border]], minlength=n + 1)


def component_filter(mask: np.ndarray, skeleton: np.ndarray, remove_isolated: bool = True) -> np.ndarray:
    """The mask without its components that are too circular or, with
    ``remove_isolated``, whose skeleton has no fork (a pixel with more
    than two 8-neighbours on the skeleton): bool."""
    mask, skeleton = mask > 0, skeleton > 0
    labels, n = ndimage.label(mask, structure=EIGHT)
    if n == 0:
        return mask
    area = np.bincount(labels.ravel(), minlength=n + 1).astype(np.float64)
    perim = perimeters(labels, n)
    sk_labels, n_sk = ndimage.label(skeleton, structure=EIGHT)
    keep = np.ones(n + 1, bool)
    if n_sk:
        degree = ndimage.convolve(skeleton.astype(np.int64), EIGHT.astype(np.int64), mode="constant") - 1
        on = sk_labels > 0
        max_degree = np.zeros(n_sk + 1, np.int64)
        np.maximum.at(max_degree, sk_labels[on], degree[on])
        owner = np.zeros(n_sk + 1, np.int64)
        owner[sk_labels[on]] = labels[on]  # a skeleton lies inside one component
        for k in range(1, n_sk + 1):
            lbl = owner[k]
            if lbl == 0:
                continue
            p = perim[lbl]
            circular = 4 * math.pi * area[lbl] / (p * p) > 0.8 if p > 0 else True
            if circular or (remove_isolated and max_degree[k] <= 2):
                keep[lbl] = False
    return keep[labels] & mask


# ---------------------------------------------------------------- Morse graph


def _grid_edges(nr: int, nc: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The triangulated grid's edges (vertical, horizontal, anti-diagonal,
    each in raster order) as vertex and dual-vertex (triangle) indices.
    Cell (r, c) holds triangles 2 (r (nc - 1) + c) (upper left) and that
    plus 1 (lower right); the outside is one more dual vertex."""
    nd = 2 * (nr - 1) * (nc - 1)
    idx = np.arange(nr * nc).reshape(nr, nc)
    r, c = np.mgrid[0 : nr - 1, 0:nc]
    base = 2 * (r * (nc - 1) + c)
    vert = (idx[:-1, :], idx[1:, :], np.where(c == 0, nd, base - 1), np.where(c == nc - 1, nd, base))
    r, c = np.mgrid[0:nr, 0 : nc - 1]
    base = 2 * (r * (nc - 1) + c)
    horiz = (idx[:, :-1], idx[:, 1:], np.where(r == 0, nd, base - 2 * (nc - 1) + 1),
             np.where(r == nr - 1, nd, base))
    r, c = np.mgrid[0 : nr - 1, 0 : nc - 1]
    base = 2 * (r * (nc - 1) + c)
    diag = (idx[:-1, 1:], idx[1:, :-1], base, base + 1)
    return tuple(np.concatenate([f[i].ravel() for f in (vert, horiz, diag)]) for i in range(4))


def _find(parent: List[int], v: int) -> int:
    root = v
    while parent[root] != root:
        root = parent[root]
    while parent[v] != root:
        parent[v], v = root, parent[v]
    return root


def dmt_graph(img: np.ndarray, delta1: float, delta2: float) -> Tuple[np.ndarray, np.ndarray]:
    """The discrete-Morse graph of a 2-D image, in float64: (vertices (V,
    2) as (row, col), edges (E, 2) as vertex indices), vertices numbered by
    their first appearance in the edge list."""
    val = -np.asarray(img, np.float64)
    nr, nc = val.shape
    flat = val.ravel()
    a, b, d, e = val[:-1, :-1], val[:-1, 1:], val[1:, :-1], val[1:, 1:]
    dual = np.stack([np.maximum(np.maximum(a, b), d), np.maximum(np.maximum(b, d), e)], axis=-1)
    dval = np.append(dual.ravel(), np.inf)
    v1, v2, d1, d2 = _grid_edges(nr, nc)
    live = (np.abs(flat[v1]) > ZERO_ATOL) & (np.abs(flat[v2]) > ZERO_ATOL)
    v1, v2, d1, d2 = v1[live], v2[live], d1[live], d2[live]
    height = np.maximum(flat[v1], flat[v2])
    order = np.lexsort((np.arange(len(height)), height))  # by (height, index)

    vals, dvals, hs = flat.tolist(), dval.tolist(), height.tolist()
    e1, e2, f1, f2 = v1.tolist(), v2.tolist(), d1.tolist(), d2.tolist()
    kind = [0] * len(hs)  # 1: paired with a vertex, 2: with a triangle
    pers = [math.inf] * len(hs)
    # 0-dimensional: edges upward; the younger component (the larger
    # (value, index) minimum) dies
    parent = list(range(len(vals)))
    for i in order.tolist():
        p, q = _find(parent, e1[i]), _find(parent, e2[i])
        if p == q:
            continue
        if (vals[p], p) > (vals[q], q):
            p, q = q, p
        parent[q] = p
        kind[i], pers[i] = 1, hs[i] - vals[q]
    # 1-dimensional: the remaining edges downward on the dual graph; the
    # component of the smaller (value, index) maximum dies
    parent = list(range(len(dvals)))
    for i in order[::-1].tolist():
        if kind[i]:
            continue
        p, q = _find(parent, f1[i]), _find(parent, f2[i])
        if p == q:
            continue
        if (dvals[p], p) < (dvals[q], q):
            p, q = q, p
        parent[q] = p
        kind[i], pers[i] = 2, dvals[q] - hs[i]

    # cancel the low-persistence vertex-edge pairs: their edges, taken
    # downward, join each vertex to at most four neighbours (as the tool's
    # fixed slots hold them), and each tree is rooted at its minimum
    slots: Dict[int, List[int]] = {}
    for i in order[::-1].tolist():
        if kind[i] == 1 and pers[i] < delta1:
            for u, w in ((e1[i], e2[i]), (e2[i], e1[i])):
                s = slots.setdefault(u, [])
                if len(s) < 4:
                    s.append(w)
    morse_parent = [-1] * len(vals)
    for i in range(len(vals)):
        if morse_parent[i] != -1:
            continue
        if i not in slots:
            morse_parent[i] = i
            continue
        seen, queue, low = {i}, deque([i]), i
        while queue:
            cur = queue.popleft()
            if (vals[cur], cur) < (vals[low], low):
                low = cur
            for nb in slots.get(cur, ()):
                if nb not in seen:
                    seen.add(nb)
                    queue.append(nb)
        morse_parent[low] = low
        queue = deque([low])
        while queue:
            cur = queue.popleft()
            for nb in slots.get(cur, ()):
                if morse_parent[nb] == -1:
                    morse_parent[nb] = cur
                    queue.append(nb)

    # the unstable manifolds: each high saddle edge below -delta2 and the
    # paths from its ends down to their minima, taken downward
    taken = set()
    pairs: List[Tuple[int, int]] = []

    def down(v: int) -> None:
        while v not in taken and morse_parent[v] not in (v, -1):
            taken.add(v)
            pairs.append((v, morse_parent[v]))
            v = morse_parent[v]

    for i in order[::-1].tolist():
        if pers[i] > delta1 and hs[i] < -delta2:
            down(e1[i])
            down(e2[i])
            pairs.append((e1[i], e2[i]))
    index: Dict[int, int] = {}
    for u, w in pairs:
        index.setdefault(u, len(index))
        index.setdefault(w, len(index))
    verts = np.array([divmod(v, nc) for v in index], np.int64).reshape(-1, 2)
    edges = np.array([(index[u], index[w]) for u, w in pairs], np.int64).reshape(-1, 2)
    return verts, edges


# ---------------------------------------------------------------- branches

Graph = Dict[int, Dict[int, None]]  # adjacency in insertion order, as NetworkX keeps it


def _graph(edges: np.ndarray) -> Graph:
    g: Graph = {}
    for u, w in edges.tolist():
        g.setdefault(u, {})[w] = None
        g.setdefault(w, {})[u] = None
    return g


def _copy(g: Graph) -> Graph:
    """A copy rebuilt edge by edge over the adjacency scan, as
    ``networkx.Graph.copy`` rebuilds one (a node's neighbours come in the
    order its edges are first met)."""
    out: Graph = {n: {} for n in g}
    for u, nbrs in g.items():
        for w in nbrs:
            out[u][w] = None
            out[w][u] = None
    return out


def _remove(g: Graph, nodes) -> None:
    for n in nodes:
        if n in g:
            for nb in g.pop(n):
                del g[nb][n]


def _moving_average(pts: np.ndarray, window: int) -> np.ndarray:
    """Box filter of width ``window`` along a polyline with both ends held
    (vertex k from an end repeated window - k times), resampled to as many
    points at even arc length."""
    n = min(window, math.ceil(len(pts) / 2))
    if n <= 1:
        return pts
    reps = np.ones(len(pts), np.int64)
    reps[: n - 1] = np.arange(n, 1, -1)
    reps[len(pts) - n + 1 :] = np.arange(2, n + 1)
    padded = np.repeat(pts, reps, axis=0)
    csum = np.cumsum(padded, axis=0)
    avg = (csum[n - 1 :] - np.concatenate([np.zeros((1, 2)), csum[:-n]])) / n
    arc = np.concatenate([[0.0], np.cumsum(np.sqrt(((avg[1:] - avg[:-1]) ** 2).sum(axis=1)))])
    targets = np.arange(1, len(pts) - 1) * (arc[-1] / (len(pts) - 1))
    cell = np.minimum(np.searchsorted(arc, targets, side="right") - 1, len(avg) - 2)
    width = arc[cell + 1] - arc[cell]
    frac = np.divide(targets - arc[cell], width, out=np.zeros_like(targets), where=width != 0)
    inner = avg[cell] + (avg[cell + 1] - avg[cell]) * frac[:, None]
    return np.concatenate([avg[:1], inner, avg[-1:]])


def _smooth(g: Graph, pos: np.ndarray, window: int) -> None:
    """Each chain from a fixed node (degree not 2) smoothed in place; a
    chain is skipped when its first vertex is the end of one already done.
    A walk steps to the first listed neighbour, as the tool's does."""
    if window <= 1:
        return
    fixed = {v for v in g if len(g[v]) != 2}
    done = set()
    for start in fixed:
        for first in list(g[start]):
            if first in done:
                continue
            chain, stepped, tip = [start, first], set(), first
            while len(g[tip]) == 2:
                nbrs = list(g[tip])
                step = nbrs[1] if nbrs[0] == tip else nbrs[0]
                if step in stepped:
                    break
                stepped.add(step)
                chain.append(step)
                tip = step
            pos[chain] = _moving_average(pos[chain], window)
            done.add(chain[0])
            done.add(chain[-1])


def _trim(g: Graph, pos: np.ndarray, min_length: float, pruning=None) -> Graph:
    """Segments between junctions peeled by walks from the leaves (first
    pass) or the junctions (second); leaf-ended segments whose bounding
    box's diagonal is under ``min_length`` go, and so do the others whose
    median vertex (rounded half to even) falls on a set pixel of
    ``pruning``, until a second pass removes nothing."""
    g = _copy(g)
    phase = 1
    while True:
        hubs = {v for v in g if len(g[v]) > 2}
        seeds = {v for v in g if len(g[v]) == 1} if phase == 1 else hubs
        walkable = {v for v in g if v not in hubs}
        doomed = []
        while seeds:
            seed = seeds.pop()
            frontier = {v for v in g[seed] if v in walkable}
            while frontier:
                tip = frontier.pop()
                seg = [seed, tip] if phase == 1 else [tip]
                while True:
                    onward = [v for v in g[tip] if v in walkable]
                    if not onward:
                        break
                    tip = onward[0]
                    seg.append(tip)
                    walkable.remove(tip)
                if (len(g[seg[0]]) == 1 or len(g[seg[-1]]) == 1):
                    span = pos[seg].max(axis=0) - pos[seg].min(axis=0)
                    if math.sqrt(float((span**2).sum())) < min_length:
                        doomed.append(seg)
                        continue
                if pruning is not None:
                    r, c = np.round(np.median(pos[seg], axis=0)).astype(int)
                    if 0 <= r < pruning.shape[0] and 0 <= c < pruning.shape[1] and pruning[r, c]:
                        doomed.append(seg)
        for seg in doomed:
            _remove(g, seg)
        _remove(g, [v for v in g if not g[v]])
        if phase == 2 and not doomed:
            return g
        phase = 3 - phase


def _edge_len(pos: List[List[float]], a: int, b: int) -> float:
    dx, dy = pos[a][0] - pos[b][0], pos[a][1] - pos[b][1]
    return math.sqrt(dx * dx + dy * dy)


def _forest(g: Graph, pos: List[List[float]]):
    """BFS forest of each component (in order of first appearance), rooted
    at its first node of highest degree in the order the tool iterates the
    component: its set of nodes rebuilt one by one where the component
    holds under half of the graph, else the graph's node order."""
    forest: Graph = {}
    parent: Dict[int, int] = {}
    dist: Dict[int, float] = {}
    seen = set()
    for start in g:
        if start in seen:
            continue
        comp, queue = [start], deque([start])
        seen.add(start)
        while queue:
            v = queue.popleft()
            for nb in g[v]:
                if nb not in seen:
                    seen.add(nb)
                    comp.append(nb)
                    queue.append(nb)
        if 2 * len(comp) < len(g):
            members = set()
            for v in comp:
                members.add(v)
            order = set()
            for v in members:
                order.add(v)
        else:
            members = set(comp)
            order = [v for v in g if v in members]
        root = max(order, key=lambda v: len(g[v]))
        parent[root], dist[root] = root, 0.0
        queue = deque([root])
        while queue:
            v = queue.popleft()
            for nb in g[v]:
                if nb not in parent:
                    forest.setdefault(v, {})[nb] = None
                    forest.setdefault(nb, {})[v] = None
                    parent[nb] = v
                    dist[nb] = dist[v] + _edge_len(pos, v, nb)
                    queue.append(nb)
    return forest, parent, dist


def branch_stats(img: np.ndarray, thresholds: Tuple[float, float], smoothing_window: int,
                 min_branch_length: float, pruning=None) -> Tuple[int, float, float]:
    """(branches, total length, mean length) in px of the Morse graph of
    ``img`` (float64, 0-255); ``pruning``, a bool raster of ``img``'s
    shape, prunes the segments whose median lies on it."""
    verts, edges = dmt_graph(img, *thresholds)
    if len(edges) == 0:
        return 0, 0.0, 0.0
    g = _graph(edges)
    pos = verts.astype(np.float64)
    _smooth(g, pos, smoothing_window)
    g = _trim(g, pos, min_branch_length, pruning)
    pos = pos.tolist()
    forest, parent, dist = _forest(g, pos)
    leaves = [v for v in forest if len(forest[v]) == 1]
    # each vertex goes to the leaf farthest below it (ties: the later leaf)
    claim = {v: -math.inf for v in forest}
    owner = {}
    for leaf in leaves:
        owner[leaf], claim[leaf] = leaf, 0.0
        v, climbed = leaf, 0.0
        while parent[v] != v:
            up = parent[v]
            climbed += _edge_len(pos, up, v)
            if climbed < claim[up]:
                break
            v = up
            claim[v], owner[v] = climbed, leaf
    # a leaf's bar: born at -(its distance to the root), dying one branch later
    lengths = []
    for leaf in leaves:
        v, span = leaf, 0.0
        while owner.get(v) == leaf and parent[v] != v:
            span += _edge_len(pos, parent[v], v)
            v = parent[v]
        birth = -dist[leaf]
        if (birth + span) - birth >= min_branch_length:
            lengths.append((birth + span) - birth)
    total = float(sum(lengths))
    return len(lengths), total, (total / len(lengths) if lengths else 0.0)
