"""Plain reference of a focus-stacked, well-masked plate well (``-m fs -w``).

Written for the benchmark from the published description of each step
(the JAX package's and the port's docstrings, skimage's and OpenCV's
documented semantics), in plain PyTorch, NumPy and SciPy. It imports
nothing of the program, its PRNG included, and takes none of its
outputs but to judge them. What ``segment.py`` already holds (the
resize, the stretch, the GMM, the UNet, the tiling and the host tail) is
taken from there.

- ``focus_project``: over a well's valid depth only, each slice blurred by
  OpenCV's 5-tap Gaussian, its ksize-5 Laplacian (deriv (1,0,-2,0,1) x
  smooth (1,4,6,4,1) along each axis, summed), REFLECT_101 borders, the
  absolute value as the score, and per pixel the source pixel of the
  first slice of the largest score; float64.
- ``fit_well``: the well mask of the projection resized to the
  segmentor's scale: Gaussian blur (sigma 1, edge border), stretch to
  0-255 and truncation, corner-polarity inversion, Otsu (256 bins),
  disk(5) erosion (outside counts as set), nearest downsampling to at most
  200 px, Canny (Gaussian sigma 1 with a zero border, unnormalised Sobel,
  interpolated non-maximum suppression, hysteresis 0.1 / 0.2 over
  8-connected edges), the frame's mask pixels added, the convex hull, the
  superellipse exponent from the hull mask's Canny perimeter over its
  area (n = 8 above 0.027, else 2; both within ``EXP_TOL`` of it), and the smallest superellipse that
  encloses the hull's vertices among 25,000 candidates drawn by JAX's
  ``uniform(PRNGKey(seed), (25000, 6))`` (threefry-2x32, written here in
  numpy), shrunk by 0.9 for the mask and by 0.81 for the shrunken mask; a
  mask under 40% of the frame is dropped for all-set masks.

Two steps of the fit meet ties that rounding decides, so the fit gives
every mask that some resolution of them allows (``Fit.candidates``):

- Otsu: the stretch maps the brightest pixel to exactly 255, where
  float32 may land a hair below and truncate it to 254, which moves every
  bin centre of the histogram; and on a soft rim the between-class
  variances of neighbouring cuts agree to 1e-5, within what float32
  moves them. Both ranges, and every cut within ``OTSU_TOL`` of the
  largest variance, give a rough mask each.
- Canny's non-maximum suppression compares equal magnitudes across a
  straight run of the digitised rim (two pixels tie in exact arithmetic),
  and which of the two a float32 program keeps is its rounding's choice.
  For each rough mask, the candidates that enclose the hull of the edges
  kept without the tied pixels and are no larger than the one that
  encloses the hull with all of them.

The search and the rasters run in float32 on the given device, as the
configuration states them; the rest in float64.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy import ndimage
from scipy.spatial import ConvexHull

from perfbench.reference.segment import (  # noqa: F401  (the plate driver's names)
    UNetRef, blend, branch_row, gmm_threshold, no_tf32, resize2d, stretch, tile)

NUM_ITERS = 25000
MAX_POINTS = 256
MAX_SIDE = 200  # the mask's fit runs at most this wide
COVERAGE_MIN = 0.4
N_CUT = 0.027  # perimeter / area above it: a squircle (n = 8), else an ellipse
EXP_TOL = 0.05  # a ratio this close to N_CUT (relative) admits both exponents
TIE_TOL = 3e-5  # magnitudes this close compare as equal (float32 rounding is far below)
OTSU_TOL = 3e-5  # Otsu's between-class variances this close (relative) tie (rounding moves them ~6e-6)
# (low, high) of theta, d, s_a, s_b, c_x, c_y, in float32
BOUNDS = np.array([(-np.pi / 20, np.pi / 20), (0.67, 1.33), (0.9, 1.1), (0.9, 1.1), (-0.3, 0.3),
                   (-0.3, 0.3)], np.float32)

# ---------------------------------------------------------------- focus stacking

_BLUR = np.array([1, 4, 6, 4, 1], np.float64) / 16
_DERIV = np.array([1, 0, -2, 0, 1], np.float64)
_SMOOTH = np.array([1, 4, 6, 4, 1], np.float64)


def _corr5(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """5-tap correlation along ``dim`` (-2 rows, -1 columns), valid part."""
    n = x.shape[dim] - 4
    return sum(float(t) * x.narrow(dim, u, n) for u, t in enumerate(taps) if t != 0)


def focus_project(stack: np.ndarray, device="cpu") -> torch.Tensor:
    """The focus-stacking projection of a (z, H, W) stack over all its z
    slices (the caller trims it to the well's depth): (H, W) float64."""
    x = torch.from_numpy(np.ascontiguousarray(stack)).to(device).double()
    padded = torch.nn.functional.pad(x[None], (4, 4, 4, 4), mode="reflect")[0]  # REFLECT_101
    blurred = _corr5(_corr5(padded, _BLUR, -2), _BLUR, -1)
    lap = (_corr5(_corr5(blurred, _DERIV, -2), _SMOOTH, -1)
           + _corr5(_corr5(blurred, _SMOOTH, -2), _DERIV, -1))
    best = torch.argmax(lap.abs(), dim=0, keepdim=True)  # the first of equal maxima
    return torch.gather(x, 0, best)[0]


# ---------------------------------------------------------------- JAX's uniform draws

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as JAX hashes a
    counter pair under a key; uint32 arrays."""
    k = [np.uint32(key[0]), np.uint32(key[1])]
    k.append(k[0] ^ k[1] ^ np.uint32(0x1BD11BDA))
    a, b = x0 + k[0], x1 + k[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            a = a + b
            b = _rotl(b, r) ^ a
        a = a + k[(i + 1) % 3]
        b = b + k[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def unit_draws(seed: int, shape=(NUM_ITERS, 6)) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(seed), shape)`` in float32:
    the key is (0, the seed's low 32 bits); with partitionable threefry
    each element hashes its flat index's (high, low) words and keeps the
    two outputs' XOR; the 23 high bits become the mantissa of a float in
    [1, 2), less 1."""
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    with np.errstate(over="ignore"):
        a, b = threefry2x32((0, int(seed) & 0xFFFFFFFF), (idx >> np.uint64(32)).astype(np.uint32),
                            idx.astype(np.uint32))
    bits = ((a ^ b) >> np.uint32(9)) | np.uint32(0x3F800000)
    return (bits.view(np.float32) - np.float32(1.0)).reshape(shape)


# ---------------------------------------------------------------- raster steps


def nearest(img: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize, jax.image's rule: output i reads input
    floor((i + 0.5) * n_in / n_out)."""
    rows = np.floor((np.arange(shape[0]) + 0.5) * img.shape[0] / shape[0]).astype(int)
    cols = np.floor((np.arange(shape[1]) + 0.5) * img.shape[1] / shape[1]).astype(int)
    return img[rows][:, cols]


def disk(radius: int) -> np.ndarray:
    y, x = np.mgrid[-radius: radius + 1, -radius: radius + 1]
    return x * x + y * y <= radius * radius


def otsu_levels(img: np.ndarray, nbins: int = 256) -> List[int]:
    """The grey levels L for which ``img >= L`` is skimage's Otsu mask of
    an integer-valued image, or could be under rounding: a histogram of
    ``nbins`` over the value range, the between-class variance of each
    bin's cut, and for the bins within ``OTSU_TOL`` of the largest, the
    least level at or above the bin's centre (the threshold)."""
    lo, hi = float(img.min()), float(img.max())
    span = max(hi - lo, 1e-12)
    idx = np.clip(((img.ravel() - lo) / span * nbins).astype(int), 0, nbins - 1)
    hist = np.bincount(idx, minlength=nbins).astype(np.float64)
    centres = lo + (np.arange(nbins) + 0.5) * span / nbins
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    s0 = np.cumsum(hist * centres)
    with np.errstate(divide="ignore", invalid="ignore"):
        between = w0 * w1 * (s0 / w0 - (s0[-1] - s0) / w1) ** 2
    between = np.where((w0 > 0) & (w1 > 0), between, -1.0)
    best = between.max()
    return sorted({int(np.ceil(centres[i])) for i in np.flatnonzero(between >= best * (1 - OTSU_TOL))})


def rough_masks(img: np.ndarray) -> List[np.ndarray]:
    """The well's rough masks: blur, stretch to 0-255 and truncate, invert
    if the corners lie nearer the top of the range, Otsu, disk(5) erosion.
    The stretch maps the brightest pixel to 255 exactly, where float32
    may land a hair below and truncate it to 254, which moves every bin
    of Otsu's histogram; and cuts whose variances tie within rounding
    could each be Otsu's. So every mask that these allow, each once."""
    blur = ndimage.gaussian_filter(img.astype(np.float64), 1.0, mode="nearest", truncate=4.0)
    lo, hi = blur.min(), blur.max()
    blur = np.floor((blur - lo) * (255.0 / (hi - lo))) if hi > lo else np.zeros_like(blur)
    h, w = img.shape
    r0, r1, c0, c1 = int(h * 0.05), int(h * 0.95), int(w * 0.05), int(w * 0.95)
    out = {}
    for top in (255.0, 254.0):
        v = np.minimum(blur, top)
        corners = [np.median(v[:r0, :c0]), np.median(v[:r0, c1:]), np.median(v[r1:, :c0]),
                   np.median(v[r1:, c1:])]
        if abs(v.min() - min(corners)) > abs(v.max() - max(corners)):
            v = 255.0 - v
        for level in otsu_levels(v):
            mask = ndimage.binary_erosion(v >= level, disk(5), border_value=1)
            out.setdefault(mask.tobytes(), mask)
    return list(out.values())


def _shift(a: np.ndarray, dr: int, dc: int) -> np.ndarray:
    """out[r, c] = a[r + dr, c + dc], zero outside."""
    p = np.pad(a, 1)
    h, w = a.shape
    return p[1 + dr: 1 + dr + h, 1 + dc: 1 + dc + w]


def canny(mask: np.ndarray, sigma: float = 1.0, low: float = 0.1, high: float = 0.2):
    """Canny edges of a binary image as (kept, tied): ``kept`` the pixels
    that survive non-maximum suppression whatever the rounding, ``tied``
    those whose survival turns on magnitudes equal within ``TIE_TOL``
    (in exact arithmetic they are kept), both after hysteresis."""
    smoothed = ndimage.gaussian_filter(mask.astype(np.float64), sigma, mode="constant", truncate=4.0)
    gr = ndimage.correlate1d(ndimage.correlate1d(smoothed, [1, 0, -1], 0, mode="mirror"), [1, 2, 1], 1,
                             mode="mirror")
    gc = ndimage.correlate1d(ndimage.correlate1d(smoothed, [1, 2, 1], 0, mode="mirror"), [1, 0, -1], 1,
                             mode="mirror")
    mag = np.hypot(gr, gc)
    ar, ac = np.abs(gr), np.abs(gc)
    horizontal = ac >= ar
    with np.errstate(divide="ignore", invalid="ignore"):
        wc = np.where(horizontal, ar / (ac + 1e-12), ac / (ar + 1e-12))
    sr, sc = np.where(gr >= 0, 1, -1), np.where(gc >= 0, 1, -1)
    margin = np.full(mag.shape, np.inf)
    for direction in (1, -1):
        along = np.zeros_like(mag)
        for vr in (1, -1):
            for vc in (1, -1):
                n_c = _shift(mag, 0, direction * vc)
                n_r = _shift(mag, direction * vr, 0)
                n_d = _shift(mag, direction * vr, direction * vc)
                val = np.where(horizontal, n_c * (1 - wc) + n_d * wc, n_r * (1 - wc) + n_d * wc)
                along = np.where((sr == vr) & (sc == vc), val, along)
        margin = np.minimum(margin, mag - along)
    interior = np.zeros(mask.shape, bool)
    interior[1:-1, 1:-1] = True
    candidates = interior & (mag > 0)
    sure, maybe = candidates & (margin > TIE_TOL), candidates & (np.abs(margin) <= TIE_TOL)

    def hysteresis(local_max):
        weak = local_max & (mag > low)
        labels, n = ndimage.label(weak, structure=np.ones((3, 3), bool))
        strong = np.unique(labels[local_max & (mag > high)])
        return np.isin(labels, strong[strong > 0])

    kept = hysteresis(sure)
    return kept, hysteresis(sure | maybe) & ~kept


def with_frame(edges: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The edges with the mask's pixels on the image's frame added."""
    out = edges.copy()
    out[0, :] |= mask[0, :]
    out[-1, :] |= mask[-1, :]
    out[:, 0] |= mask[:, 0]
    out[:, -1] |= mask[:, -1]
    return out


def hull_mask(shape: Tuple[int, int], points: np.ndarray) -> np.ndarray:
    """The filled convex hull of integer points: pixels on the inner side
    of every edge of the counter-clockwise hull, the edges included."""
    verts = points[ConvexHull(points).vertices].astype(np.float64)
    rr, cc = np.mgrid[: shape[0], : shape[1]]
    inside = np.ones(shape, bool)
    for a, b in zip(verts, np.roll(verts, -1, axis=0)):
        inside &= (b[0] - a[0]) * (cc - a[1]) - (b[1] - a[1]) * (rr - a[0]) >= -1e-9
    return inside


def _pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n by repeated squaring (the products an integer power takes)."""
    acc = None
    while n:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def linspace32(num: int, device) -> torch.Tensor:
    """``jnp.linspace(-1, 1, num)`` in float32 as XLA evaluates it:
    -(1 - s) + s for s = i * (1 / (num - 1)), the end point exact."""
    s = np.arange(num - 1, dtype=np.float32) * (np.float32(1.0) / np.float32(num - 1))
    return torch.as_tensor(np.append(-(np.float32(1.0) - s) + s, np.float32(1.0)).astype(np.float32),
                           device=device)


def superellipse(p: Tuple[float, ...], d: float, n: int, shape, device) -> np.ndarray:
    """The raster of the superellipse of parameters ``p`` (theta, d, s_a,
    s_b, c_x, c_y) with ``d`` in place of p[1], in float32: rows span x,
    columns y, each over [-1, 1]."""
    t = torch.tensor(p[0], dtype=torch.float32, device=device)
    xs, ys = linspace32(shape[0], device)[:, None], linspace32(shape[1], device)[None, :]
    c_x, c_y, d, s_a, s_b = (float(np.float32(v)) for v in (p[4], p[5], d, p[2], p[3]))
    da = torch.tensor(d, dtype=torch.float32, device=device) * s_a
    db = torch.tensor(d, dtype=torch.float32, device=device) * s_b
    u = (((xs - c_x) * torch.cos(t) - (ys - c_y) * torch.sin(t)) / da).abs()
    v = (((xs - c_x) * torch.sin(t) + (ys - c_y) * torch.cos(t)) / db).abs()
    return (_pow(u, n) + _pow(v, n) < 1.0).cpu().numpy()


def _search(points: np.ndarray, shape, n: int, params: torch.Tensor) -> torch.Tensor:
    """The area of every candidate that encloses the hull vertices
    ``points`` (row, col), infinite for the others; float32 on
    ``params``' device."""
    if len(points) > MAX_POINTS:
        points = points[np.linspace(0, len(points) - 1, MAX_POINTS).astype(int)]
    x = torch.as_tensor((points[:, 0] / shape[0] * 2 - 1).astype(np.float32), device=params.device)
    y = torch.as_tensor((points[:, 1] / shape[1] * 2 - 1).astype(np.float32), device=params.device)
    t, d, s_a, s_b, c_x, c_y = (params[:, i: i + 1] for i in range(6))
    if n == 2:
        val = _pow((x - c_x) / (d * s_a), 2) + _pow((y - c_y) / (d * s_b), 2)
    else:
        u = ((x - c_x) * torch.cos(t) - (y - c_y) * torch.sin(t)) / (d * s_a)
        v = ((x - c_x) * torch.sin(t) + (y - c_y) * torch.cos(t)) / (d * s_b)
        val = _pow(u.abs(), n) + _pow(v.abs(), n)
    feasible = val.amax(dim=1) < 1.0
    gamma = 4.0 * math.gamma(1 + 1 / n) ** 2 / math.gamma(1 + 2 / n)
    area = gamma * params[:, 1] ** 2 * params[:, 2] * params[:, 3]
    return torch.where(feasible, area, float("inf"))


class Fit:
    """The masks a well's fit allows: ``candidates`` of (well mask,
    shrunken mask), both bool at the image's size, and the exponents
    that the ties allow."""

    def __init__(self):
        self.candidates: List[Tuple[np.ndarray, np.ndarray]] = []
        self.exponents: Tuple[int, ...] = ()


def _masks(img_shape, small_shape, p, n, device):
    d = float(p[1]) * 0.9
    well = nearest(superellipse(p, d, n, small_shape, device), img_shape)
    shrunken = superellipse(p, d * 0.9, n, img_shape, device)
    if well.mean() < COVERAGE_MIN:
        return np.ones(img_shape, bool), np.ones(img_shape, bool)
    return well, shrunken


def fit_well(img: np.ndarray, seed: int = 0, device="cpu") -> Fit:
    """Every (well mask, shrunken mask) that the fit allows for the 2-D
    image ``img`` (see the module doc), each once."""
    h, w = img.shape
    ratio = min(1.0, MAX_SIDE / max(h, w))
    small_shape = (int(round(h * ratio)), int(round(w * ratio)))
    lo, hi = torch.as_tensor(BOUNDS[:, 0], device=device), torch.as_tensor(BOUNDS[:, 1], device=device)
    params = lo + (hi - lo) * torch.as_tensor(unit_draws(seed), device=device)
    fit = Fit()
    seen = set()
    for rough in rough_masks(img):
        for well, shrunken in _fit_rough(nearest(rough, small_shape), img.shape, params, fit):
            key = well.tobytes() + shrunken.tobytes()
            if key not in seen:
                seen.add(key)
                fit.candidates.append((well, shrunken))
    return fit


def exponents(ratio: float) -> set:
    """The superellipse exponents that a hull mask's perimeter over its
    area allows: 8 above ``N_CUT``, else 2, and both within ``EXP_TOL``
    of it. The ratio of the program's hull may lie between those of the
    tie resolutions the reference enumerates (the rough mask's edges and
    the hull mask's resolved all one way or all the other), so a ratio
    near the cut does not decide."""
    if abs(ratio - N_CUT) <= EXP_TOL * N_CUT:
        return {2, 8}
    return {8} if ratio > N_CUT else {2}


def _fit_rough(small: np.ndarray, img_shape, params: torch.Tensor, fit: Fit):
    """The (well mask, shrunken mask) candidates of one rough mask at the
    fit's scale, smallest first; the exponents it allows go into ``fit``."""
    kept, tied = canny(small)
    sure, loose = np.argwhere(with_frame(kept, small)), np.argwhere(with_frame(kept | tied, small))
    try:
        hulls = [p[ConvexHull(p).vertices] for p in (sure, loose)]
    except Exception:  # too few points: a centred circle of 2.5% of the image's height
        h, w = img_shape
        rr, cc = np.mgrid[:h, :w]
        circ = (rr - h // 2) ** 2 + (cc - w // 2) ** 2 < int(h * 0.5 * 0.05) ** 2
        return [_coverage(circ, circ, img_shape)]
    # the exponent from the hull mask's perimeter (its own Canny edges, ties either way)
    exps = set()
    for verts in hulls:
        hm = hull_mask(small.shape, verts)
        e_kept, e_tied = canny(hm)
        for edges in (e_kept, e_kept | e_tied):
            exps |= exponents(with_frame(edges, hm).sum() / max(hm.sum(), 1))
    fit.exponents = tuple(sorted(set(fit.exponents) | exps))
    out, chosen = [], []
    for n in sorted(exps):
        area = _search(hulls[0], small.shape, n, params)
        top = float(_search(hulls[1], small.shape, n, params).min())
        if not math.isfinite(top):  # no candidate encloses every point: the hull itself
            well = nearest(hull_mask(small.shape, hulls[0]), img_shape)
            out.append(_coverage(well, ndimage.binary_erosion(well, disk(5), border_value=1), img_shape))
            continue
        chosen += [(float(area[i]), i, n) for i in torch.nonzero(area <= top).flatten().tolist()]
    for _, i, n in sorted(chosen):
        p = tuple(float(v) for v in params[i].cpu())
        out.append(_masks(img_shape, small.shape, p, n, params.device))
    return out


def _coverage(well: np.ndarray, shrunken: np.ndarray, shape) -> Tuple[np.ndarray, np.ndarray]:
    if well.mean() < COVERAGE_MIN:
        return np.ones(shape, bool), np.ones(shape, bool)
    return well, shrunken


# ---------------------------------------------------------------- the well's row


def mask_gap(fit: Fit, program: Optional[Tuple[np.ndarray, np.ndarray]]) -> Tuple[float, int]:
    """(share of pixels that differ, index) of the fit's candidate nearest
    the program's (well mask, shrunken mask); a share of 1 without one."""
    if program is None or not fit.candidates:
        return 1.0, 0
    gaps = [(np.count_nonzero(wm != program[0]) + np.count_nonzero(sh != program[1])) / (2 * wm.size)
            for wm, sh in fit.candidates]
    k = int(np.argmin(gaps))
    return float(gaps[k]), k


def proj_gap(proj: torch.Tensor, programs) -> float:
    """The share of pixels by which the nearest of the program's
    projections (of ``programs``) differs from the reference's ``proj``;
    1 without one."""
    gaps = [float((q.to(proj.device).double() != proj).double().mean()) for q in programs]
    return min(gaps, default=1.0)


def well_row(stack: np.ndarray, model: UNetRef, seg_cfg: Dict, traffic: Dict, device="cuda",
             kept: Optional[Dict] = None) -> Dict:
    """What the reference makes of a well's raw stack, trimmed to its
    depth: the focus projection, the well-mask fit (``fit``) and in
    ``gaps`` the ``proj_gap`` and ``mask_gap`` to what the program made
    (``kept``: its ``projections`` of the plate and its ``masks``, (image,
    well mask, shrunken mask) each, the one fitted on the image nearest
    the reference's), then, inside the allowed mask nearest the program's,
    the patch batch's probabilities (``probs``), the area's band
    (``area_band``: the GMM of the well's pixels), the segmentor's scale
    (``target``) and the host tail's pruning mask (``pruning``)."""
    kept = kept or {}
    proj = focus_project(stack, device)
    h, w = proj.shape
    target = (int(round(h * seg_cfg["ds_ratio"])), int(round(w * seg_cfg["ds_ratio"])))
    resized = resize2d(proj, target, "lanczos3")
    img = resized.cpu().numpy()
    fit = fit_well(img, traffic.get("run_plate", {}).get("seed", 0), device)
    mine = None
    if kept.get("masks"):
        mine = min(kept["masks"], key=lambda m: float(np.abs(m[0] - img).max()))[1:]
    gap, k = mask_gap(fit, mine)
    wm, shrunken = fit.candidates[k]
    small = stretch(resized) * torch.from_numpy(wm).to(device)
    probs = model.predict(tile(small, seg_cfg["patch_size"], seg_cfg.get("tta", 8)))
    wm_full = torch.from_numpy(nearest(wm, (h, w))).to(device)
    dsamp = (int(round(target[0] * 384 / target[1])), 384)
    return {"probs": probs, "area_band": masked_area_band(proj, wm_full), "target": target,
            "pruning": nearest(~shrunken, dsamp), "fit": fit, "proj": proj, "wm_full": wm_full,
            "gaps": {"proj_gap": proj_gap(proj, kept.get("projections", ())), "mask_gap": gap}}


def masked_area_band(proj: torch.Tensor, mask: torch.Tensor, delta: float = 1e-4,
                     dtype=torch.float64) -> Tuple[float, float]:
    """``segment.area_band`` over the well: the projection stretched over
    the whole frame, the GMM fitted to the well's pixels only (in
    ``dtype``), and the area the share of the well's pixels above the
    threshold moved by ``delta``: (least, most)."""
    scaled = stretch(proj.double())
    t = gmm_threshold(scaled[mask], dtype=dtype)
    n = float(mask.sum())

    def area(th):
        return 100 * float(((scaled > th) & (scaled > 0) & mask).sum()) / max(n, 1.0)

    return area(t + delta), area(t - delta)


def control_area(want: Dict) -> float:
    """The control's area of a well: its GMM run in bfloat16."""
    return 0.5 * sum(masked_area_band(want["proj"], want["wm_full"], 0.0, torch.bfloat16))


def tail_row(probs: torch.Tensor, want: Dict, seg_cfg: Dict, traffic: Dict,
             dtype=torch.float64) -> Tuple[int, float, float]:
    """The host tail's row from given patch outputs (the program's own):
    blended, rounded to ``dtype``, then ``branch_row`` with the branches
    whose median falls outside the shrunken well pruned."""
    preds = blend(probs, *want["target"], seg_cfg["patch_size"], seg_cfg.get("tta", 8))
    return branch_row(preds.to(dtype).double(), traffic["image_width_microns"], traffic.get("graph", {}),
                      pruning=want["pruning"])
