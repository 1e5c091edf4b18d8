"""Morse skeleton forest analysis (the Python ``MorseGraph``).

A copy of ``tmat_tpu/topo/morse.py`` on the port's discrete-Morse graph
(``topo/dmtgraph.py``, native): sliding-window vertex smoothing with fixed
leaves and junctions, two-pass iterated trimming (short, long, isolated
and pruning-masked segments), a BFS spanning forest rooted at the
max-degree node of each component, farthest-descendant-leaf branch
ownership, branch decomposition with a persistence barcode (birth =
-dist_to_root(leaf), death = birth + branch length), the drop of short
branches, and the colored tree and barcode plots (matplotlib is imported
inside the plot functions only).

Exact parity with the JAX package and with the native engine
(``topo/morse_native.py``), down to float accumulation order and the
CPython set iteration orders the pruning walk depends on, is required, so
the traversal is the JAX package's, statement for statement.
"""

from __future__ import annotations

import math
from numbers import Number
from typing import Optional, Tuple

import numpy as np
import numpy.typing as npt

from tmat_torch.topo.dmtgraph import compute_dmt_graph
from tmat_torch.topo.lightgraph import LightGraph


def _cv2_hsv_to_bgr_unit(h: float, s: float, v: float) -> tuple:
    """cv2 COLOR_HSV2BGR for uint8 inputs, returned as floats in [0, 1].

    cv2's uint8 HSV uses H in [0, 180) (2-degree units), S/V in [0, 255].
    Reproduces topology.py:517-527's golden-ratio branch colors.
    """
    h = float(h % 256) * 2.0  # uint8 wrap, then to degrees (can exceed 360)
    s_f = s / 255.0
    v_f = v / 255.0
    c = v_f * s_f
    hp = (h / 60.0) % 6.0  # wrap hue like cv2 (H in (180, 255] -> >360 deg)
    x = c * (1 - abs(hp % 2 - 1))
    if hp < 1:
        r, g, b = c, x, 0
    elif hp < 2:
        r, g, b = x, c, 0
    elif hp < 3:
        r, g, b = 0, c, x
    elif hp < 4:
        r, g, b = 0, x, c
    elif hp < 5:
        r, g, b = x, 0, c
    else:
        r, g, b = c, 0, x
    m = v_f - c
    r, g, b = r + m, g + m, b + m
    # reference returns BGR/255 (fed to matplotlib as-is)
    return (b, g, r)


class MorseGraph:
    """Morse skeleton of an image represented as a forest
    (topology.py:15-50)."""

    def __init__(
        self,
        img: npt.NDArray,
        thresholds: Tuple[Number, Number] = (1, 4),
        min_branch_length: int = 15,
        max_branch_length: Optional[int] = None,
        remove_isolated_branches: bool = False,
        smoothing_window: int = 15,
        pruning_mask: Optional[npt.NDArray] = None,
    ):
        self.smoothing_window = smoothing_window
        self.thresholds = thresholds
        self.min_branch_length = min_branch_length
        self.max_branch_length = max_branch_length
        self.remove_isolated_branches = remove_isolated_branches
        self.pruning_mask = pruning_mask
        self._shape = img.shape[:2]
        self.barcode = None
        self._leaves = None
        self._branches = None
        self._parent = None
        self._dist_to_root = None
        self._edges_and_colors = None
        self._barcode_and_colors = None
        self._G = None
        self._branch_label = None
        self._vertices = None
        self.__compute_graph(img, thresholds)
        self.__assign_branch_owners()
        self.__decompose_into_branches()
        self.__drop_short_branches()

    # ---------------------------------------------------------------- public

    def get_total_branch_length(self) -> float:
        """Sum of persistence interval lengths (topology.py:54-57)."""
        return float(np.sum(self.__barcode_interval_lengths()))

    def get_average_branch_length(self) -> float:
        """Average bar length (topology.py:59-65)."""
        lengths = self.__barcode_interval_lengths()
        total = np.sum(lengths)
        if total == 0:
            return 0
        return float(total / len(lengths))

    def plot_colored_barcode(self, scaling_factor=1.0, ax=None, **kwargs):
        """Horizontal barcode plot colored per branch (topology.py:67-107)."""
        import matplotlib.pyplot as plt

        if not self._barcode_and_colors:
            self.__compute_colored_tree_and_barcode(scaling_factor)
        ax_provided = ax is not None
        ax = ax if ax_provided else plt.gca()
        if self._barcode_and_colors:
            self._barcode_and_colors.sort(reverse=True, key=lambda pair: pair[0])
            heights = [*range(len(self._barcode_and_colors))]
            barcode, colors = zip(*self._barcode_and_colors)
            births, widths = zip(*[(bar[0], bar[1] - bar[0]) for bar in barcode])
        else:
            heights, widths, births, colors = [], [], [], []
        ax.barh(heights, widths, left=births, color=colors, **kwargs)
        ax.set_yticks([])
        ax.set_xlabel("Barcode")
        if not ax_provided:
            plt.show()

    def plot_colored_tree(self, scaling_factor=1.0, ax=None, **kwargs):
        """Tree plot with per-branch colors (topology.py:109-144)."""
        import matplotlib.pyplot as plt
        from matplotlib.collections import LineCollection

        if not self._edges_and_colors:
            self.__compute_colored_tree_and_barcode(scaling_factor)
        ax_provided = ax is not None
        ax = ax if ax_provided else plt.gca()
        if self._edges_and_colors:
            edges, colors = zip(*self._edges_and_colors)
            colors = [(*c, 1.0) for c in colors]
            ax.add_collection(LineCollection(edges, colors=colors, **kwargs))
        ax.set_axis_off()
        ax.autoscale()
        if not ax_provided:
            plt.show()

    # --------------------------------------------------------------- private

    def __compute_graph(self, img, thresholds):
        G, vertices = self.__compute_nx_graph(img, *thresholds)
        vertices = self.__relax_chains(G, vertices, self.smoothing_window)
        G = self.__prune_segments(
            G,
            vertices,
            self._shape,
            self.min_branch_length,
            self.max_branch_length,
            self.pruning_mask,
            self.remove_isolated_branches,
        )
        self._G, self._parent, self._dist_to_root = self.__get_forest(
            G, vertices, self.remove_isolated_branches
        )
        self._vertices = vertices

    def __assign_branch_owners(self):
        """Give every forest vertex to the branch of its farthest descendant
        leaf (behavior of topology.py:181-222).

        Each leaf climbs toward its root claiming the vertices it passes; the
        climb stops at the first ancestor already claimed by a strictly more
        distant leaf. Leaves are processed in forest node order, and the
        per-edge distance accumulation runs leaf-upward — both load-bearing
        for bit-parity with the goldens and the native engine.
        """
        up = self._parent
        pos = self._vertices
        leaves = [v for v in self._G.nodes if self._G.degree[v] == 1]
        best_claim = dict.fromkeys(self._G.nodes, -np.inf)
        owner = {}
        for leaf in leaves:
            owner[leaf] = leaf
            best_claim[leaf] = 0.0
            climbed = 0.0
            v = leaf
            while True:
                anc = up[v]
                if anc == v:  # reached this tree's root
                    break
                climbed += self.__edge_len(pos, anc, v)
                if climbed < best_claim[anc]:
                    break  # a farther leaf owns everything from here up
                v = anc
                best_claim[v] = climbed
                owner[v] = leaf
        self._leaves = leaves
        self._branch_label = owner

    def __decompose_into_branches(self):
        """Split the forest into leaf-owned branches and build the barcode
        (behavior of topology.py:224-271).

        A leaf's branch is the maximal run of edges it owns on its root path.
        Its bar is born at -dist_to_root(leaf) and dies one branch length
        later (where a longer branch takes over).
        """
        up = self._parent
        pos = self._vertices
        owner = self._branch_label
        branches = []
        bars = []
        for leaf in self._leaves:
            edges = []
            span = 0.0
            v = leaf
            while owner[v] == leaf:
                anc = up[v]
                if anc == v:
                    break
                span += self.__edge_len(pos, anc, v)
                edges.append((v, anc))
                v = anc
            branches.append(np.array(edges))
            birth = -self._dist_to_root[leaf]
            bars.append((birth, birth + span))
        self._branches = branches
        self.barcode = bars

    def __relax_chains(self, G, pos, window):
        """Moving-average the positions along every degree-2 chain, keeping
        leaves and junctions anchored (behavior of topology.py:273-316).

        Chains are walked from each anchor (degree != 2 vertex) outward; a
        chain is skipped when its first vertex was already covered from the
        other end. The walk steps to the first adjacency-listed neighbor
        that isn't the current vertex (which can double back — the goldens
        pin that quirk), and bails if it revisits a chain vertex (cycles).
        """
        if window <= 1:
            return pos
        pos = pos.copy()
        anchors = {v for v in G.nodes if G.degree[v] != 2}
        covered = set()
        for anchor in anchors:
            for first in G.neighbors(anchor):
                if first in covered:
                    continue
                chain = [anchor, first]
                stepped = set()
                tip = first
                while G.degree[tip] == 2:
                    adj = list(G.neighbors(tip))
                    step = adj[1] if adj[0] == tip else adj[0]
                    if step in stepped:
                        break
                    stepped.add(step)
                    chain.append(step)
                    tip = step
                pos[chain] = self.__moving_average_fixed_ends(pos[chain], window)
                covered.add(chain[0])
                covered.add(chain[-1])
        return pos

    def __drop_short_branches(self):
        """Discard branches whose bar is shorter than min_branch_length
        (behavior of topology.py:318-347)."""
        keep = [death - birth >= self.min_branch_length
                for birth, death in self.barcode]
        doomed_edges = [edge
                        for branch, kept in zip(self._branches, keep) if not kept
                        for edge in branch]
        self._branches = [b for b, kept in zip(self._branches, keep) if kept]
        self.barcode = [bar for bar, kept in zip(self.barcode, keep) if kept]
        self._G.remove_edges_from(doomed_edges)
        self._G.remove_nodes_from(self._G.isolates())

    def __barcode_interval_lengths(self):
        if not self.barcode:
            return np.array([])
        barcode = np.array(self.barcode)
        lengths = barcode[:, 1] - barcode[:, 0]
        return lengths[~np.isinf(lengths)]

    def __compute_colored_tree_and_barcode(self, scaling_factor=1.0):
        """Per-branch display geometry: a golden-ratio color per branch, the
        scaled bar, and the branch polyline (lightly smoothed, window 3) as
        (x, y) line segments (behavior of topology.py:358-389)."""
        segments = []
        bars = []
        for i, (branch, bar) in enumerate(zip(self._branches, self.barcode)):
            color = self.__random_color(i)
            bars.append(((bar[0] * scaling_factor, bar[1] * scaling_factor), color))
            path = [edge[0] for edge in branch]
            path.append(branch[-1][1])
            pts = self.__moving_average_fixed_ends(
                self._vertices[path] * scaling_factor, 3
            )
            # vertices are (row, col); matplotlib wants (x, y) -> flip
            xy = pts[:, ::-1]
            for a, b in zip(xy[:-1], xy[1:]):
                segments.append(([a, b], color))
        self._edges_and_colors = segments
        self._barcode_and_colors = bars

    # -------------------------------------------------------------- utilities

    @staticmethod
    def __compute_nx_graph(im, threshold1=0.5, threshold2=0.0):
        V, E = compute_dmt_graph(im.astype(np.float32), threshold1, threshold2)
        G = LightGraph.from_edges(E)
        # An empty Morse graph flows through like the reference: the forest,
        # branch list and barcode all come out empty and branch statistics
        # report 0 (topology.py writes a 0-branch result, it does not raise).
        return G, V.astype(np.float32)

    @staticmethod
    def __repeat_endpoints(A, n):
        """Pad a polyline for endpoint-anchored box filtering: vertex k from
        either end is duplicated (n - k) times, so the width-n window average
        at each end reproduces the endpoint exactly (behavior of
        topology.py:420-448, vectorized)."""
        assert n >= 2
        assert min(n, math.ceil(len(A) / 2)) == n
        reps = np.ones(len(A), dtype=np.intp)
        ramp = np.arange(n, 1, -1)
        reps[: n - 1] = ramp
        reps[len(A) - n + 1 :] = ramp[::-1]
        return np.repeat(A, reps, axis=0)

    @staticmethod
    def __moving_average_fixed_ends(A, n):
        """Width-n box filter over a polyline's positions with both endpoints
        held fixed, resampled back to the original vertex count (behavior of
        topology.py:457-476)."""
        n = min(n, math.ceil(len(A) / 2))
        assert n != 0
        if n == 1:
            return A
        padded = MorseGraph.__repeat_endpoints(A, n)
        # running-sum box filter (cumsum difference), float64 accumulation
        csum = np.cumsum(padded, axis=0, dtype=float)
        csum[n:] = csum[n:] - csum[:-n]
        smoothed = csum[n - 1 :] / n
        return MorseGraph.__resample_uniform(smoothed, len(A))

    @staticmethod
    def __resample_uniform(verts, n):
        """Resample a polyline to n vertices at uniform arclength spacing,
        keeping the exact endpoints (behavior of topology.py:479-515,
        vectorized over the interior points)."""
        assert len(verts) >= 2
        assert n >= 2
        gaps = np.linalg.norm(verts[1:] - verts[:-1], axis=1)
        arc = np.cumsum(np.concatenate(([0], gaps)))
        targets = np.arange(1, n - 1) * (np.sum(gaps) / (n - 1))
        cell = np.searchsorted(arc, targets, side="right") - 1
        width = arc[cell + 1] - arc[cell]
        frac = np.zeros_like(targets)
        np.divide(targets - arc[cell], width, out=frac, where=width != 0)
        interior = verts[cell] + (verts[cell + 1] - verts[cell]) * frac[:, None]
        return np.concatenate(([verts[0]], interior, [verts[-1]]))

    @staticmethod
    def __random_color(i: int):
        """Golden-ratio HSV color wheel (topology.py:517-527)."""
        phi = 0.618033988749895
        step = 180 * phi
        # np.uint8 cast truncates then wraps mod 256
        return _cv2_hsv_to_bgr_unit(int(step * i) % 256, 220, 255)

    @staticmethod
    def __get_forest(G, verts, remove_isolated_branches):
        """BFS spanning forest per component (topology.py:541-581)."""
        from collections import deque

        forest = LightGraph()
        parent = {n: None for n in G.nodes}
        dist_to_root = {}
        n_total = G.number_of_nodes()
        for comp in G.connected_components():
            # root = first max-degree node in nx's subgraph-view iteration
            # order. FilterAtlas.__iter__ iterates the component SET itself
            # when 2*len(set) < len(graph) (CPython set order, insertion
            # sequence = _plain_bfs BFS order, which our BFS reproduces),
            # and the graph's node order filtered by membership otherwise.
            # Degree ties across components are common on real rasters —
            # wrong order here silently changes the branch decomposition.
            if 2 * len(comp) < n_total:
                cset = set()
                for v in comp:
                    cset.add(v)
                # nx show_nodes REBUILDS the set from nbunch_iter (a
                # generator), i.e. element-by-element in the BFS set's own
                # iteration order with incremental growth — a different
                # table layout (and thus iteration order) than the BFS
                # set itself. Emulate exactly: re-add one by one.
                order = set()
                for v in cset:
                    order.add(v)
            else:
                member = set(comp)
                order = [v for v in G.nodes if v in member]
            root = max(order, key=lambda n: G.degree[n])
            if remove_isolated_branches and G.degree[root] <= 2:
                continue
            parent[root] = root
            dist_to_root[root] = 0
            unvisited = deque([root])
            while unvisited:
                v = unvisited.popleft()
                for n in G.neighbors(v):
                    if parent[n] is None:
                        forest.add_edge(v, n)
                        parent[n] = v
                        dist_to_root[n] = dist_to_root[v] + MorseGraph.__edge_len(
                            verts, v, n
                        )
                        unvisited.append(n)
        return forest, parent, dist_to_root

    @staticmethod
    def __edge_len(verts, v1_idx, v2_idx):
        # hot path (called per edge in BFS/labeling): plain sqrt beats
        # np.linalg.norm's ufunc machinery on 2-vectors by ~10x. sqrt of
        # the explicit sum (NOT math.hypot, whose correctly-rounded
        # algorithm differs from libm's in the last ulp) keeps this
        # bit-identical to the native engine (csrc/morse.cpp): IEEE 754
        # +, * and sqrt are correctly rounded, so C++ and Python agree.
        a = verts[v1_idx]
        b = verts[v2_idx]
        dx = float(a[0]) - float(b[0])
        dy = float(a[1]) - float(b[1])
        return math.sqrt(dx * dx + dy * dy)

    @staticmethod
    def __prune_segments(
        G,
        vertices,
        shape,
        min_branch_length,
        max_branch_length=None,
        pruning_mask=None,
        remove_isolated_branches=False,
    ):
        """Iterated two-phase segment pruning (behavior of
        topology.py:588-706).

        Phase 1 seeds walks at leaves, phase 2 at junctions; each walk peels
        a maximal junction-free segment. Segments are condemned when leaf-
        ended and out of [min, max] length bounds, when isolated (both ends
        leaves, no junction inside, if enabled), or when their median point
        lands in the pruning mask. Phases alternate until a phase-2 sweep
        removes nothing. All the seed/frontier sets are built from the same
        iteration sources as the goldens — their CPython pop() order decides
        which of two overlapping walks claims shared vertices, so set
        construction order is load-bearing here.
        """
        work = G.copy()
        if pruning_mask is None:
            pruning_mask = np.zeros(shape, dtype=bool)
        elif pruning_mask.dtype != bool:
            pruning_mask = pruning_mask > 0

        def diag_extent(seg):
            pts = vertices[seg]
            span = pts.max(axis=0) - pts.min(axis=0)
            return np.sqrt(np.sum(span**2))

        phase = 1
        while True:
            hubs = {v for v in work.nodes if work.degree[v] > 2}
            seeds = (
                {v for v in work.nodes if work.degree[v] == 1}
                if phase == 1
                else hubs
            )
            walkable = {v for v in work.nodes if v not in hubs}
            kept = []
            too_short = []
            too_long = []
            lone = []

            while seeds:
                seed = seeds.pop()
                frontier = {v for v in work.neighbors(seed) if v in walkable}
                while frontier:
                    tip = frontier.pop()
                    seg = [seed, tip] if phase == 1 else [tip]
                    while True:
                        onward = [v for v in work.neighbors(tip) if v in walkable]
                        if not onward:
                            break
                        tip = onward[0]
                        seg.append(tip)
                        walkable.remove(tip)
                    leaf_ends = (work.degree[seg[0]] == 1) + (
                        work.degree[seg[-1]] == 1
                    )
                    if (
                        remove_isolated_branches
                        and leaf_ends == 2
                        and all(work.degree[v] <= 2 for v in seg)
                    ):
                        lone.append(seg)
                    elif leaf_ends:
                        extent = diag_extent(seg)
                        if extent < min_branch_length:
                            too_short.append(seg)
                        elif max_branch_length and extent > max_branch_length:
                            too_long.append(seg)
                        else:
                            kept.append(seg)
                    else:
                        kept.append(seg)

            if kept:
                medians = [
                    np.round(np.median(vertices[s], axis=0)).astype(int)
                    for s in kept
                ]
                in_mask = np.argwhere(
                    pruning_mask[tuple(zip(*medians))]
                ).flatten()
                condemned = [kept[i] for i in in_mask]
            else:
                condemned = []
            condemned += too_short + too_long + lone

            for seg in condemned:
                work.remove_edges_from(set(work.edges(seg)))
                work.remove_nodes_from(seg)
            work.remove_nodes_from(work.isolates())

            if phase == 2 and not condemned:
                return work
            phase = 3 - phase
