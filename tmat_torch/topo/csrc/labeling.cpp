// Native connected-component labeling + region statistics.
//
// Replaces the host-side hot path of the plate pipeline's postprocess
// stage (topo/regionprops.py + filter_branch_seg_mask in
// topo/transforms.py): scipy.ndimage.label + a per-region Python
// perimeter loop + per-component filter decisions become one or two C
// calls per well. Semantics are pinned to the Python implementations
// (which are themselves pinned to skimage/scipy — see
// tests/test_labeling_native.py for the exact-equality oracles):
//
//  - ccl_label: two-pass union-find CCL, labels numbered by raster-scan
//    first occurrence (scipy.ndimage.label order), connectivity 1 or 2.
//  - region_props: per-label area / perimeter / eccentricity /
//    equivalent diameter in two passes. Perimeter reproduces
//    skimage.measure.perimeter's weighted border-code histogram computed
//    per region in isolation (neighbors of a border pixel only count
//    when they carry the same label, which is exactly what the Python
//    fallback's bounding-box crop computes).
//  - branch_filter: the full filter_branch_seg_mask decision pass —
//    label the mask, compute circularity 4*pi*A/P^2, label the skeleton,
//    per-skeleton-component max 8-neighbor degree and owning mask label,
//    then zero out components that are too circular (>0.8) or fork-free.
//
// All loops are cache-friendly raster scans; no allocation beyond the
// label raster and O(n_labels) accumulators.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  int32_t make() {
    parent.push_back((int32_t)parent.size());
    return (int32_t)parent.size() - 1;
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b) parent[b] = a; else parent[a] = b;
  }
};

}  // namespace

extern "C" {

// Label a binary raster (any nonzero = foreground). Writes int32 labels
// (0 = background) to labels_out and returns the number of labels.
// connectivity: 1 = 4-neighborhood, 2 = 8-neighborhood.
int64_t ccl_label(const uint8_t* mask, int64_t h, int64_t w, int32_t connectivity,
                  int32_t* labels_out) {
  UnionFind uf;
  // provisional labels stored in labels_out as (id+1); 0 = background
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* mrow = mask + r * w;
    int32_t* lrow = labels_out + r * w;
    const int32_t* lprev = labels_out + (r - 1) * w;
    for (int64_t c = 0; c < w; ++c) {
      if (!mrow[c]) { lrow[c] = 0; continue; }
      int32_t lbl = -1;
      // west
      if (c > 0 && lrow[c - 1]) lbl = lrow[c - 1] - 1;
      if (r > 0) {
        // north
        if (lprev[c]) {
          int32_t o = lprev[c] - 1;
          if (lbl < 0) lbl = o; else uf.unite(lbl, o);
        }
        if (connectivity >= 2) {
          if (c > 0 && lprev[c - 1]) {
            int32_t o = lprev[c - 1] - 1;
            if (lbl < 0) lbl = o; else uf.unite(lbl, o);
          }
          if (c + 1 < w && lprev[c + 1]) {
            int32_t o = lprev[c + 1] - 1;
            if (lbl < 0) lbl = o; else uf.unite(lbl, o);
          }
        }
      }
      if (lbl < 0) lbl = uf.make();
      lrow[c] = lbl + 1;
    }
  }
  // renumber roots by raster order of first occurrence
  std::vector<int32_t> remap(uf.parent.size(), 0);
  int32_t next = 0;
  for (int64_t i = 0; i < h * w; ++i) {
    if (!labels_out[i]) continue;
    int32_t root = uf.find(labels_out[i] - 1);
    if (remap[root] == 0) remap[root] = ++next;
    labels_out[i] = remap[root];
  }
  return next;
}

// Per-label statistics over an int32 label raster (labels 1..n_labels).
// area/eqd/ecc/perim are arrays of length n_labels (index i = label i+1);
// pass nullptr to skip a property (perimeter and eccentricity each cost
// an extra accumulation but no extra raster pass).
void region_props(const int32_t* labels, int64_t h, int64_t w, int32_t n_labels,
                  double* area, double* perim, double* ecc, double* eqd) {
  if (n_labels <= 0) return;
  std::vector<double> cnt(n_labels + 1, 0.0);
  std::vector<double> sr, sc, srr, scc, src;
  if (ecc) {
    sr.assign(n_labels + 1, 0.0);
    sc.assign(n_labels + 1, 0.0);
    srr.assign(n_labels + 1, 0.0);
    scc.assign(n_labels + 1, 0.0);
    src.assign(n_labels + 1, 0.0);
  }
  // perimeter border-code weights: code = 1 + 2*(same-label border
  // 4-neighbors) + 10*(same-label border diagonals), histogrammed at
  // border pixels (skimage.measure.perimeter kernel 10-2-10).
  static const double SQRT2 = std::sqrt(2.0);
  double wts[50];
  for (int i = 0; i < 50; ++i) wts[i] = 0.0;
  wts[5] = wts[7] = wts[15] = wts[17] = wts[25] = wts[27] = 1.0;
  wts[21] = wts[33] = SQRT2;
  wts[13] = wts[23] = (1.0 + SQRT2) / 2.0;

  std::vector<uint8_t> border;
  if (perim) {
    border.assign((size_t)(h * w), 0);
    for (int64_t r = 0; r < h; ++r) {
      const int32_t* lrow = labels + r * w;
      uint8_t* brow = border.data() + r * w;
      for (int64_t c = 0; c < w; ++c) {
        int32_t L = lrow[c];
        if (!L) continue;
        // border pixel of region L: any 4-neighbor (or OOB) != L
        bool b = (r == 0 || labels[(r - 1) * w + c] != L) ||
                 (r + 1 >= h || labels[(r + 1) * w + c] != L) ||
                 (c == 0 || lrow[c - 1] != L) ||
                 (c + 1 >= w || lrow[c + 1] != L);
        brow[c] = b ? 1 : 0;
      }
    }
  }

  for (int64_t r = 0; r < h; ++r) {
    const int32_t* lrow = labels + r * w;
    for (int64_t c = 0; c < w; ++c) {
      int32_t L = lrow[c];
      if (!L) continue;
      cnt[L] += 1.0;
      if (ecc) {
        double rr = (double)r, cc = (double)c;
        sr[L] += rr; sc[L] += cc;
        srr[L] += rr * rr; scc[L] += cc * cc; src[L] += rr * cc;
      }
      if (perim && border[(size_t)(r * w + c)]) {
        int a4 = 0, d4 = 0;
        // same-label border neighbors
        auto sb = [&](int64_t rr2, int64_t cc2) -> bool {
          if (rr2 < 0 || rr2 >= h || cc2 < 0 || cc2 >= w) return false;
          return labels[rr2 * w + cc2] == L && border[(size_t)(rr2 * w + cc2)];
        };
        if (sb(r - 1, c)) ++a4;
        if (sb(r + 1, c)) ++a4;
        if (sb(r, c - 1)) ++a4;
        if (sb(r, c + 1)) ++a4;
        if (sb(r - 1, c - 1)) ++d4;
        if (sb(r - 1, c + 1)) ++d4;
        if (sb(r + 1, c - 1)) ++d4;
        if (sb(r + 1, c + 1)) ++d4;
        int code = 1 + 2 * a4 + 10 * d4;
        if (code < 50) perim[L - 1] += wts[code];
      }
    }
  }

  for (int32_t L = 1; L <= n_labels; ++L) {
    double n = cnt[L];
    if (area) area[L - 1] = n;
    if (eqd) eqd[L - 1] = std::sqrt(4.0 * n / M_PI);
    if (ecc) {
      if (n <= 0) { ecc[L - 1] = 0.0; continue; }
      double r0 = sr[L] / n, c0 = sc[L] / n;
      double mu20 = srr[L] / n - r0 * r0;
      double mu02 = scc[L] / n - c0 * c0;
      double mu11 = src[L] / n - r0 * c0;
      double t = mu20 + mu02;
      double d = std::sqrt(std::fmax((mu20 - mu02) * (mu20 - mu02)
                                     + 4.0 * mu11 * mu11, 0.0));
      double l1 = (t + d) / 2.0, l2 = (t - d) / 2.0;
      ecc[L - 1] = (l1 <= 0.0) ? 0.0
                               : std::sqrt(std::fmax(1.0 - l2 / l1, 0.0));
    }
  }
}

// filter_branch_seg_mask decision pass (transforms.py:306-361 semantics):
// mask and skel are binary uint8 rasters (skel subset of mask); writes the
// filtered mask to out (may alias mask). remove_isolated drops fork-free
// components. Returns the number of mask components.
int64_t branch_filter(const uint8_t* mask, const uint8_t* skel, int64_t h,
                      int64_t w, int32_t remove_isolated, uint8_t* out) {
  std::vector<int32_t> labels((size_t)(h * w));
  int64_t n = ccl_label(mask, h, w, 2, labels.data());
  if (n == 0) {
    if (out != mask) std::memcpy(out, mask, (size_t)(h * w));
    return 0;
  }
  std::vector<double> area(n, 0.0), perim(n, 0.0);
  region_props(labels.data(), h, w, (int32_t)n, area.data(), perim.data(),
               nullptr, nullptr);

  std::vector<int32_t> sklabels((size_t)(h * w));
  int64_t nsk = ccl_label(skel, h, w, 2, sklabels.data());

  std::vector<uint8_t> keep((size_t)(n + 1), 1);
  if (nsk > 0) {
    std::vector<int32_t> max_deg((size_t)(nsk + 1), 0);
    std::vector<int32_t> seg_lbl((size_t)(nsk + 1), 0);
    for (int64_t r = 0; r < h; ++r) {
      for (int64_t c = 0; c < w; ++c) {
        int32_t k = sklabels[r * w + c];
        if (!k) continue;
        int deg = 0;
        for (int dr = -1; dr <= 1; ++dr) {
          for (int dc = -1; dc <= 1; ++dc) {
            if (!dr && !dc) continue;
            int64_t rr = r + dr, cc = c + dc;
            if (rr < 0 || rr >= h || cc < 0 || cc >= w) continue;
            if (skel[rr * w + cc]) ++deg;
          }
        }
        if (deg > max_deg[k]) max_deg[k] = deg;
        seg_lbl[k] = labels[r * w + c];  // constant within a component
      }
    }
    for (int64_t k = 1; k <= nsk; ++k) {
      int32_t lbl = seg_lbl[k];
      if (!lbl) continue;
      bool has_fork = max_deg[k] > 2;
      double p = perim[lbl - 1];
      double circ = 4.0 * M_PI * area[lbl - 1] / (p * p + 1e-7);
      if ((remove_isolated && !has_fork) || circ > 0.8) keep[lbl] = 0;
    }
  }
  for (int64_t i = 0; i < h * w; ++i)
    out[i] = keep[labels[i]] ? mask[i] : 0;
  return n;
}

// Zero out labeled regions with size < min_size (skimage
// remove_small_objects over a label raster); modifies labels in place.
void drop_small_regions(int32_t* labels, int64_t h, int64_t w,
                        int32_t n_labels, int64_t min_size) {
  if (n_labels <= 0) return;
  std::vector<int64_t> cnt((size_t)(n_labels + 1), 0);
  for (int64_t i = 0; i < h * w; ++i) cnt[labels[i]] += 1;
  std::vector<uint8_t> drop((size_t)(n_labels + 1), 0);
  for (int32_t L = 1; L <= n_labels; ++L) drop[L] = cnt[L] < min_size;
  for (int64_t i = 0; i < h * w; ++i)
    if (drop[labels[i]]) labels[i] = 0;
}

}  // extern "C"
