// Morse graph analysis engine: smooth -> trim -> forest -> branch labels
// -> barcode -> filter, bit-compatible with the Python MorseGraph
// (tmat_tpu/topo/morse.py, itself reference-parity-proven against
// fl_tissue_model_tools/topology.py:15-706 by tests/test_reference_parity).
//
// The trim and pop-driven walks in the reference are ORDER-DEPENDENT on
// CPython set-of-int iteration and pop order, so this file includes a
// faithful emulation of CPython's set table layout (open addressing with
// LINEAR_PROBES blocks and the *5+1+perturb recurrence, growth at
// fill*5 >= mask*3, pop via the search finger). Only the operations the
// Morse pipeline performs are supported: build-by-adds, iterate, pop.
// The emulation is fuzz-tested against real Python sets
// (tests/test_morse_native.py).
//
// Numeric fidelity notes (each replicates a NumPy behavior the Python
// code relies on):
//  - vertex positions are float32; smoothing computes in float64
//    (np.cumsum dtype=float) and stores back to float32
//  - segment bbox lengths use float32 arithmetic then compare as double
//  - pruning-mask positions use float32 median + round-half-to-even
//  - edge lengths and distances accumulate in float64 (math.hypot)

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CPython set-of-small-int emulation
// ---------------------------------------------------------------------------

struct PySet {
    static constexpr int LINEAR_PROBES = 9;
    static constexpr int PERTURB_SHIFT = 5;
    enum State : uint8_t { UNUSED = 0, ACTIVE = 1, DUMMY = 2 };
    struct Slot {
        int64_t key;
        State state;
    };
    std::vector<Slot> table;
    size_t mask;
    size_t fill;   // active + dummy
    size_t used;   // active
    size_t finger; // pop() search start

    PySet() : table(8), mask(7), fill(0), used(0), finger(0) {
        for (auto &s : table) s = {0, UNUSED};
    }

    // set_insert_clean: probe for the first UNUSED slot (no dummies exist
    // during a resize rebuild)
    void insert_clean(int64_t key) {
        uint64_t hash = (uint64_t)key;
        uint64_t perturb = hash;
        size_t i = (size_t)hash & mask;
        while (true) {
            size_t j = i;
            size_t probes = (i + LINEAR_PROBES <= mask) ? LINEAR_PROBES : 0;
            while (true) {
                if (table[j].state == UNUSED) {
                    table[j] = {key, ACTIVE};
                    fill++;
                    used++;
                    return;
                }
                if (probes == 0) break;
                probes--;
                j++;
            }
            perturb >>= PERTURB_SHIFT;
            i = (i * 5 + 1 + perturb) & mask;
        }
    }

    void resize(size_t minused) {
        size_t newsize = 8;
        while (newsize <= minused) newsize <<= 1;
        std::vector<Slot> old;
        old.swap(table);
        table.assign(newsize, {0, UNUSED});
        mask = newsize - 1;
        fill = used = 0;
        for (const auto &s : old)
            if (s.state == ACTIVE) insert_clean(s.key);
    }

    void add(int64_t key) {
        uint64_t hash = (uint64_t)key;
        uint64_t perturb = hash;
        size_t i = (size_t)hash & mask;
        long freeslot = -1;
        while (true) {
            size_t j = i;
            size_t probes = (i + LINEAR_PROBES <= mask) ? LINEAR_PROBES : 0;
            while (true) {
                Slot &e = table[j];
                if (e.state == UNUSED) {
                    if (freeslot >= 0) {
                        table[(size_t)freeslot] = {key, ACTIVE};
                        used++;
                        return;
                    }
                    e = {key, ACTIVE};
                    fill++;
                    used++;
                    if (fill * 5 >= mask * 3)
                        resize(used > 50000 ? used * 2 : used * 4);
                    return;
                }
                if (e.state == ACTIVE && e.key == key) return;
                if (e.state == DUMMY && freeslot < 0) freeslot = (long)j;
                if (probes == 0) break;
                probes--;
                j++;
            }
            perturb >>= PERTURB_SHIFT;
            i = (i * 5 + 1 + perturb) & mask;
        }
    }

    bool empty() const { return used == 0; }

    // set.pop(): scan from the finger for the first active slot
    int64_t pop() {
        size_t i = finger;
        while (true) {
            Slot &e = table[i & mask];
            if (e.state == ACTIVE) {
                e.state = DUMMY;
                used--;
                finger = i + 1;
                return e.key;
            }
            i++;
        }
    }

    // iteration order: ascending table scan
    template <typename F>
    void for_each(F f) const {
        for (size_t j = 0; j <= mask; j++)
            if (table[j].state == ACTIVE) f(table[j].key);
    }
};

// ---------------------------------------------------------------------------
// LightGraph-compatible adjacency
// ---------------------------------------------------------------------------

struct Graph {
    // node ids index into the vertex array; adjacency preserves insertion
    // order; node iteration order = first-appearance order minus removals
    std::vector<std::vector<int32_t>> adj;
    std::vector<int32_t> order;      // first-appearance order (with tombstones)
    std::vector<uint8_t> present;

    explicit Graph(size_t n_possible)
        : adj(n_possible), present(n_possible, 0) {}

    void touch(int32_t n) {
        if (!present[n]) {
            present[n] = 1;
            order.push_back(n);
        }
    }

    void add_edge(int32_t u, int32_t v) {
        touch(u);
        touch(v);
        auto &au = adj[u];
        if (std::find(au.begin(), au.end(), v) == au.end()) {
            au.push_back(v);
            adj[v].push_back(u);
        }
    }

    int degree(int32_t n) const { return (int)adj[n].size(); }

    void remove_edge(int32_t u, int32_t v) {
        if (!present[u] || !present[v]) return;
        auto &au = adj[u];
        auto it = std::find(au.begin(), au.end(), v);
        if (it == au.end()) return;
        au.erase(it);
        auto &av = adj[v];
        av.erase(std::find(av.begin(), av.end(), u));
    }

    void remove_node(int32_t n) {
        if (!present[n]) return;
        for (int32_t nbr : adj[n]) {
            auto &a = adj[nbr];
            a.erase(std::find(a.begin(), a.end(), n));
        }
        adj[n].clear();
        present[n] = 0;  // order tombstone: skipped during iteration
    }

    template <typename F>
    void for_each_node(F f) const {
        for (int32_t n : order)
            if (present[n]) f(n);
    }

    // nx.Graph.copy() adjacency rebuild quirk (LightGraph.copy): scan
    // nodes in order; each directed occurrence (u -> v) appends v to
    // adj[u] and u to adj[v] when missing.
    Graph copy() const {
        Graph g(adj.size());
        for (int32_t n : order)
            if (present[n]) {
                g.present[n] = 1;
                g.order.push_back(n);
            }
        for (int32_t u : order) {
            if (!present[u]) continue;
            for (int32_t v : adj[u]) {
                auto &gu = g.adj[u];
                if (std::find(gu.begin(), gu.end(), v) == gu.end())
                    gu.push_back(v);
                auto &gv = g.adj[v];
                if (std::find(gv.begin(), gv.end(), u) == gv.end())
                    gv.push_back(u);
            }
        }
        return g;
    }
};

// ---------------------------------------------------------------------------
// Smoothing (moving average with fixed endpoints; morse.py:219-352)
// ---------------------------------------------------------------------------

using Vec2 = std::array<double, 2>;

// __prep_moving_avg_fixed_endpoints + __moving_average + uniform resample,
// computed in float64 like np.cumsum(dtype=float); caller stores results
// back into the float32 vertex array.
static std::vector<Vec2> moving_average_fixed_ends(
    const std::vector<Vec2> &A, int n_in) {
    const size_t len = A.size();
    int n = std::min<int>(n_in, (int)((len + 1) / 2));
    if (n <= 1) return A;

    // endpoint-repeat transform
    std::vector<Vec2> t;
    t.reserve(len + (size_t)n * n);
    // core: A[n-1 : -(n-1)]
    std::vector<Vec2> core(A.begin() + (n - 1), A.end() - (n - 1));
    // build by prepending/appending repeats for i = n-2 .. 0 (reversed)
    std::vector<Vec2> cur = core;
    for (int i = n - 2; i >= 0; i--) {
        int repeat = n - i;
        std::vector<Vec2> next;
        next.reserve(cur.size() + 2 * repeat);
        for (int r = 0; r < repeat; r++) next.push_back(A[i]);
        next.insert(next.end(), cur.begin(), cur.end());
        const Vec2 &tail = A[len - 1 - i];
        for (int r = 0; r < repeat; r++) next.push_back(tail);
        cur.swap(next);
    }

    // moving average window n (cumsum in double)
    const size_t m = cur.size();
    std::vector<Vec2> avg(m - (size_t)n + 1);
    Vec2 run{0, 0};
    std::vector<Vec2> cum(m);
    for (size_t i = 0; i < m; i++) {
        run[0] += cur[i][0];
        run[1] += cur[i][1];
        cum[i] = run;
    }
    for (size_t i = 0; i + n <= m; i++) {
        Vec2 hi = cum[i + n - 1];
        Vec2 lo = (i == 0) ? Vec2{0, 0} : cum[i - 1];
        avg[i] = {(hi[0] - lo[0]) / n, (hi[1] - lo[1]) / n};
    }

    // uniform-arclength resample back to len points
    const size_t k = avg.size();
    std::vector<double> accum(k, 0.0);
    double total = 0;
    for (size_t i = 1; i < k; i++) {
        double dx = avg[i][0] - avg[i - 1][0];
        double dy = avg[i][1] - avg[i - 1][1];
        total += std::sqrt(dx * dx + dy * dy);
        accum[i] = total;
    }
    std::vector<Vec2> out;
    out.reserve(len);
    out.push_back(avg.front());
    double step = total / (double)(len - 1);
    for (size_t i = 1; i + 1 < len; i++) {
        double d = (double)i * step;
        // np.searchsorted(accum, d, side='right') - 1
        size_t idx =
            (size_t)(std::upper_bound(accum.begin(), accum.end(), d) -
                     accum.begin()) -
            1;
        if (idx + 1 >= k) idx = k - 2;
        double denom = accum[idx + 1] - accum[idx];
        double prop = denom == 0 ? 0.0 : (d - accum[idx]) / denom;
        out.push_back({avg[idx][0] + (avg[idx + 1][0] - avg[idx][0]) * prop,
                       avg[idx][1] + (avg[idx + 1][1] - avg[idx][1]) * prop});
    }
    out.push_back(avg.back());
    return out;
}

static void smooth_graph(const Graph &G, std::vector<float> &verts,
                         int window) {
    if (window <= 1) return;
    PySet fixed;
    G.for_each_node([&](int32_t n) {
        if (G.degree(n) != 2) fixed.add(n);
    });
    std::vector<uint8_t> visited(G.adj.size(), 0);

    std::vector<int64_t> fixed_order;
    fixed.for_each([&](int64_t k) { fixed_order.push_back(k); });

    std::vector<uint8_t> seg_visited(G.adj.size(), 0);
    std::vector<int32_t> seg_stamp_list;

    for (int64_t fixed_start : fixed_order) {
        for (int32_t base : G.adj[(size_t)fixed_start]) {
            int32_t branch_vert = base;
            if (visited[branch_vert]) continue;
            std::vector<int32_t> segment{(int32_t)fixed_start, branch_vert};
            // branch_verts_visited (membership only)
            for (int32_t s : seg_stamp_list) seg_visited[s] = 0;
            seg_stamp_list.clear();
            while (G.degree(branch_vert) == 2) {
                const auto &nbrs = G.adj[branch_vert];
                int32_t next_vert =
                    (nbrs[0] != branch_vert) ? nbrs[0] : nbrs[1];
                if (seg_visited[next_vert]) break;
                branch_vert = next_vert;
                seg_visited[branch_vert] = 1;
                seg_stamp_list.push_back(branch_vert);
                segment.push_back(branch_vert);
            }
            std::vector<Vec2> pos(segment.size());
            for (size_t i = 0; i < segment.size(); i++)
                pos[i] = {(double)verts[2 * segment[i]],
                          (double)verts[2 * segment[i] + 1]};
            std::vector<Vec2> sm = moving_average_fixed_ends(pos, window);
            for (size_t i = 0; i < segment.size(); i++) {
                verts[2 * segment[i]] = (float)sm[i][0];
                verts[2 * segment[i] + 1] = (float)sm[i][1];
            }
            visited[segment.front()] = 1;
            visited[segment.back()] = 1;
        }
    }
}

// ---------------------------------------------------------------------------
// Trim (morse.py:401-497 / topology.py:588-706)
// ---------------------------------------------------------------------------

static float segment_bbox_length(const std::vector<int32_t> &seg,
                                 const std::vector<float> &verts) {
    float min_x = INFINITY, min_y = INFINITY, max_x = -INFINITY,
          max_y = -INFINITY;
    for (int32_t n : seg) {
        float x = verts[2 * n], y = verts[2 * n + 1];
        min_x = std::min(min_x, x);
        max_x = std::max(max_x, x);
        min_y = std::min(min_y, y);
        max_y = std::max(max_y, y);
    }
    float dx = max_x - min_x, dy = max_y - min_y;
    return std::sqrt(dx * dx + dy * dy);  // float32 math like np
}

// np.median along axis 0 of float32 coords, then np.round (half-to-even)
static void segment_median_pos(const std::vector<int32_t> &seg,
                               const std::vector<float> &verts, long &out_r,
                               long &out_c) {
    std::vector<float> xs, ys;
    xs.reserve(seg.size());
    ys.reserve(seg.size());
    for (int32_t n : seg) {
        xs.push_back(verts[2 * n]);
        ys.push_back(verts[2 * n + 1]);
    }
    auto median = [](std::vector<float> &v) -> float {
        size_t n = v.size();
        std::sort(v.begin(), v.end());
        if (n % 2) return v[n / 2];
        return (v[n / 2 - 1] + v[n / 2]) / 2.0f;  // float32 mean, like np
    };
    float mx = median(xs), my = median(ys);
    out_r = (long)std::nearbyint(mx);  // round-half-to-even (np.round)
    out_c = (long)std::nearbyint(my);
}

static Graph trim_graph(const Graph &G_in, const std::vector<float> &verts,
                        double min_branch_length, double max_branch_length,
                        const uint8_t *pruning_mask, int64_t mask_h,
                        int64_t mask_w, bool remove_isolated) {
    Graph G = G_in.copy();
    const size_t N = G.adj.size();
    std::vector<uint8_t> is_junction(N, 0), unmarked(N, 0);

    int pass_num = 1;
    bool pruning_complete = false;
    while (!pruning_complete) {
        PySet junctions;
        std::fill(is_junction.begin(), is_junction.end(), 0);
        G.for_each_node([&](int32_t n) {
            if (G.degree(n) > 2) {
                junctions.add(n);
                is_junction[n] = 1;
            }
        });
        PySet base_p1;
        if (pass_num == 1)
            G.for_each_node([&](int32_t n) {
                if (G.degree(n) == 1) base_p1.add(n);
            });
        PySet &base_nodes = (pass_num == 1) ? base_p1 : junctions;

        std::fill(unmarked.begin(), unmarked.end(), 0);
        G.for_each_node([&](int32_t n) {
            if (!is_junction[n]) unmarked[n] = 1;
        });

        std::vector<std::vector<int32_t>> segments, short_segments,
            long_segments, isolated_segments;

        while (!base_nodes.empty()) {
            int32_t starting = (int32_t)base_nodes.pop();
            PySet neighbors;
            for (int32_t n : G.adj[starting])
                if (unmarked[n]) neighbors.add(n);
            while (!neighbors.empty()) {
                int32_t node = (int32_t)neighbors.pop();
                std::vector<int32_t> segment;
                if (pass_num == 1) segment = {starting, node};
                else segment = {node};
                while (true) {
                    int32_t next = -1;
                    for (int32_t n : G.adj[node])
                        if (unmarked[n]) {
                            next = n;
                            break;
                        }
                    if (next < 0) break;
                    node = next;
                    segment.push_back(node);
                    unmarked[node] = 0;
                }
                int n_leaf = (G.degree(segment.front()) == 1) +
                             (G.degree(segment.back()) == 1);
                bool all_deg_le2 = true;
                for (int32_t v : segment)
                    if (G.degree(v) > 2) {
                        all_deg_le2 = false;
                        break;
                    }
                if (remove_isolated && n_leaf == 2 && all_deg_le2) {
                    isolated_segments.push_back(std::move(segment));
                } else if (n_leaf > 0) {
                    double seg_len = (double)segment_bbox_length(segment, verts);
                    if (seg_len < min_branch_length)
                        short_segments.push_back(std::move(segment));
                    else if (max_branch_length > 0 &&
                             seg_len > max_branch_length)
                        long_segments.push_back(std::move(segment));
                    else
                        segments.push_back(std::move(segment));
                } else {
                    segments.push_back(std::move(segment));
                }
            }
        }

        std::vector<std::vector<int32_t>> to_remove;
        if (pruning_mask != nullptr) {
            for (auto &seg : segments) {
                long r, c;
                segment_median_pos(seg, verts, r, c);
                if (r >= 0 && r < mask_h && c >= 0 && c < mask_w &&
                    pruning_mask[r * mask_w + c])
                    to_remove.push_back(seg);
            }
        }
        for (auto &s : short_segments) to_remove.push_back(std::move(s));
        for (auto &s : long_segments) to_remove.push_back(std::move(s));
        for (auto &s : isolated_segments) to_remove.push_back(std::move(s));

        for (const auto &seg : to_remove) {
            for (int32_t n : seg) {
                // remove all incident edges (copy: removal mutates adj)
                std::vector<int32_t> nbrs = G.adj[n];
                for (int32_t v : nbrs) G.remove_edge(n, v);
            }
            for (int32_t n : seg) G.remove_node(n);
        }
        // remove isolates
        std::vector<int32_t> isolates;
        G.for_each_node([&](int32_t n) {
            if (G.degree(n) == 0) isolates.push_back(n);
        });
        for (int32_t n : isolates) G.remove_node(n);

        pruning_complete = (pass_num == 2) && to_remove.empty();
        pass_num = (pass_num == 1) ? 2 : 1;
    }
    return G;
}

// ---------------------------------------------------------------------------
// Forest + branches + barcode (morse.py:151-217, 363-390)
// ---------------------------------------------------------------------------

static double edge_len(const std::vector<float> &verts, int32_t a, int32_t b) {
    // sqrt of the explicit sum, NOT hypot: libm hypot and CPython
    // math.hypot differ in the last ulp; IEEE-correctly-rounded +, *,
    // sqrt keep this bit-identical to topo/morse.py.__edge_len
    double dx = (double)verts[2 * a] - (double)verts[2 * b];
    double dy = (double)verts[2 * a + 1] - (double)verts[2 * b + 1];
    return std::sqrt(dx * dx + dy * dy);
}

struct AnalysisResult {
    std::vector<double> barcode;  // filtered (birth, death) pairs
};

static AnalysisResult analyze(const Graph &trimmed,
                              const std::vector<float> &verts,
                              double min_branch_length, bool remove_isolated) {
    const size_t N = trimmed.adj.size();
    // ---- forest: BFS spanning tree per component, root = first max-degree
    Graph forest(N);
    std::vector<int32_t> parent(N, -1);
    std::vector<double> dist_to_root(N, 0.0);
    std::vector<uint8_t> seen(N, 0);

    // components in first-appearance order (LightGraph.connected_components);
    // root = first max-degree node in nx's subgraph-view iteration order:
    // FilterAtlas iterates the component SET itself when 2*|c| < |V|
    // (CPython set order, where the set was built by show_nodes RE-ADDING
    // the BFS-order set's elements one by one in its iteration order), and
    // the graph's node order filtered by membership otherwise. Matches
    // topo/morse.py::__get_forest exactly (tests/test_morse_native.py and
    // the real-data goldens assert this).
    std::vector<int64_t> order_index(N, -1);
    int64_t n_total = 0;
    {
        int64_t oi = 0;
        trimmed.for_each_node([&](int32_t n) { order_index[n] = oi++; });
        n_total = oi;
    }
    trimmed.for_each_node([&](int32_t start) {
        if (seen[start]) return;
        std::vector<int32_t> comp{start};
        seen[start] = 1;
        std::vector<int32_t> q{start};
        size_t qi = 0;
        while (qi < q.size()) {
            int32_t v = q[qi++];
            for (int32_t n : trimmed.adj[v])
                if (!seen[n]) {
                    seen[n] = 1;
                    comp.push_back(n);
                    q.push_back(n);
                }
        }
        int32_t root = -1;
        if (2 * (int64_t)comp.size() < n_total) {
            PySet bfs_set;
            for (int32_t v : comp) bfs_set.add(v);
            PySet rebuilt;
            bfs_set.for_each([&](int64_t v) { rebuilt.add(v); });
            rebuilt.for_each([&](int64_t v) {
                if (root < 0 ||
                    trimmed.degree((int32_t)v) > trimmed.degree(root))
                    root = (int32_t)v;
            });
        } else {
            std::sort(comp.begin(), comp.end(),
                      [&](int32_t a, int32_t b) {
                          return order_index[a] < order_index[b];
                      });
            root = comp[0];
            for (int32_t n : comp)
                if (trimmed.degree(n) > trimmed.degree(root)) root = n;
        }
        if (remove_isolated && trimmed.degree(root) <= 2) return;
        parent[root] = root;
        dist_to_root[root] = 0.0;
        std::vector<int32_t> bfs{root};
        size_t bi = 0;
        while (bi < bfs.size()) {
            int32_t v = bfs[bi++];
            for (int32_t n : trimmed.adj[v])
                if (parent[n] < 0) {
                    forest.add_edge(v, n);
                    parent[n] = v;
                    dist_to_root[n] = dist_to_root[v] + edge_len(verts, v, n);
                    bfs.push_back(n);
                }
        }
    });

    // ---- branch labels: farthest-descendant-leaf per vertex
    std::vector<int32_t> leaves;
    forest.for_each_node([&](int32_t n) {
        if (forest.degree(n) == 1) leaves.push_back(n);
    });
    std::vector<double> max_dist_to_leaf(N, -INFINITY);
    std::vector<int32_t> branch_label(N, -1);
    for (int32_t leaf : leaves) {
        int32_t cur = leaf;
        int32_t par = parent[cur];
        double cur_dist = 0.0;
        max_dist_to_leaf[leaf] = 0.0;
        branch_label[leaf] = leaf;
        while (par != cur) {
            cur_dist += edge_len(verts, par, cur);
            if (cur_dist < max_dist_to_leaf[par]) break;
            cur = par;
            par = parent[cur];
            max_dist_to_leaf[cur] = cur_dist;
            branch_label[cur] = leaf;
        }
    }

    // ---- branches + barcode, then min-length filter
    AnalysisResult res;
    for (int32_t leaf : leaves) {
        int32_t cur = leaf;
        int32_t par = parent[leaf];
        double cur_dist = 0.0;
        while (branch_label[cur] == leaf && cur != par) {
            cur_dist += edge_len(verts, par, cur);
            cur = par;
            par = parent[cur];
        }
        double birth = -dist_to_root[leaf];
        double death = birth + cur_dist;
        if (death - birth >= min_branch_length) {
            res.barcode.push_back(birth);
            res.barcode.push_back(death);
        }
    }
    return res;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Full Morse-graph analysis from a dmtgraph (V, E) pair.
// verts: n_verts x 2 int32 positions; edges: n_edges x 2 int32 indices.
// out_barcode must have capacity 2 * n_verts doubles.
// Returns the number of (filtered) bars, or -1 on invalid input.
int64_t morse_analyze(const int32_t *verts_in, int64_t n_verts,
                      const int32_t *edges, int64_t n_edges,
                      int32_t smoothing_window, double min_branch_length,
                      double max_branch_length, int32_t remove_isolated,
                      const uint8_t *pruning_mask, int64_t mask_h,
                      int64_t mask_w, double *out_barcode) {
    if (n_verts < 0 || n_edges < 0) return -1;
    if (n_verts == 0 || n_edges == 0) return 0;

    Graph G((size_t)n_verts);
    for (int64_t e = 0; e < n_edges; e++)
        G.add_edge(edges[2 * e], edges[2 * e + 1]);

    std::vector<float> verts(2 * (size_t)n_verts);
    for (int64_t i = 0; i < 2 * n_verts; i++)
        verts[(size_t)i] = (float)verts_in[i];

    smooth_graph(G, verts, smoothing_window);
    Graph trimmed =
        trim_graph(G, verts, min_branch_length, max_branch_length,
                   pruning_mask, mask_h, mask_w, remove_isolated != 0);
    AnalysisResult res =
        analyze(trimmed, verts, min_branch_length, remove_isolated != 0);

    int64_t n_bars = (int64_t)(res.barcode.size() / 2);
    std::memcpy(out_barcode, res.barcode.data(),
                res.barcode.size() * sizeof(double));
    return n_bars;
}

// --- CPython-set emulation trace hooks (fuzz-tested from Python) ---------
// ops: sequence of (op, value) pairs. op 0 = add(value); op 1 = pop
// (value ignored; result appended to out); op 2 = snapshot iteration order
// (appends count then keys to out). Returns number of int64s written.
int64_t pyset_trace(const int64_t *ops, int64_t n_ops, int64_t *out,
                    int64_t out_cap) {
    PySet s;
    int64_t w = 0;
    for (int64_t i = 0; i < n_ops; i++) {
        int64_t op = ops[2 * i], val = ops[2 * i + 1];
        if (op == 0) {
            s.add(val);
        } else if (op == 1) {
            if (w < out_cap) out[w++] = s.empty() ? -1 : s.pop();
        } else if (op == 2) {
            std::vector<int64_t> keys;
            s.for_each([&](int64_t k) { keys.push_back(k); });
            if (w < out_cap) out[w++] = (int64_t)keys.size();
            for (int64_t k : keys)
                if (w < out_cap) out[w++] = k;
        }
    }
    return w;
}

}  // extern "C"
