"""Well-boundary mask generation.

Counterpart of ``tmat_tpu/ops/wellmask.py`` and of ``make_well_mask`` in
``tmat_tpu/tools/compute_branches.py``: auto-threshold (blur,
corner-polarity inversion, Otsu, disk(5) erosion), downsample to <= 200 px,
Canny border + image-edge injection, convex hull, circularity-based
superellipse exponent (perimeter/area > 0.027 -> n=8 squircle, else n=2
ellipse), a 25,000-candidate random search for the smallest enclosing
superellipse, and circle / convex-hull fallbacks.

The raster stages run on the image's device; the search is one vectorised
feasibility test and area argmin there; the convex hull (scipy, dozens of
points) stays on the host.

The search's unit draws are an argument. When none are given they are
``jax.random.uniform(PRNGKey(seed), (25000, 6))``'s, bit for bit
(``core/prng.py``), drawn on the CPU: every device and the JAX package
search the same candidates for one ``seed``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from tmat_torch.core import prng
from tmat_torch.core.log import SFM
from tmat_torch.ops import morphology
from tmat_torch.ops.canny import canny
from tmat_torch.ops.filters import gaussian
from tmat_torch.ops.rescale import rescale_intensity
from tmat_torch.ops.resize import resize
from tmat_torch.ops.threshold import otsu_threshold

# Random-search parameter bounds: theta, d, s_a, s_b, c_x, c_y
_BOUNDS = np.array(
    [(-np.pi / 20, np.pi / 20), (0.67, 1.33), (0.9, 1.1), (0.9, 1.1), (-0.3, 0.3), (-0.3, 0.3)],
    np.float32,
)
NUM_ITERS = 25000


def auto_threshold_well(image: torch.Tensor) -> torch.Tensor:
    """Rough boolean well mask of a 2-D image."""
    im_blur = gaussian(image.float(), sigma=1.0, mode="nearest")
    im_blur = torch.floor(rescale_intensity(im_blur, out_range=(0, 255)))  # uint8 truncation
    lo, hi = im_blur.min(), im_blur.max()

    h, w = image.shape
    x_stop_left, x_start_right = int(h * 0.05), int(h * 0.95)
    y_stop_top, y_start_bottom = int(w * 0.05), int(w * 0.95)
    corners = torch.stack([
        _median(im_blur[:x_stop_left, :y_stop_top]),
        _median(im_blur[:x_stop_left, y_start_bottom:]),
        _median(im_blur[x_start_right:, :y_stop_top]),
        _median(im_blur[x_start_right:, y_start_bottom:]),
    ])
    invert = torch.abs(lo - corners.min()) > torch.abs(hi - corners.max())
    im_blur = torch.where(invert, 255.0 - im_blur, im_blur)

    im_thresh = im_blur >= otsu_threshold(im_blur)
    return morphology.binary_erosion(im_thresh, morphology.disk(5))


def _median(x: torch.Tensor) -> torch.Tensor:
    """np.median of all elements: the mean of the two middle order
    statistics (NaN for an empty corner, as numpy gives)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    if n == 0:
        return torch.full((), float("nan"), device=x.device)
    return (s[(n - 1) // 2] + s[n // 2]) / 2.0


def unit_draws(seed: int, num_iters: int = NUM_ITERS) -> np.ndarray:
    """The search's default (num_iters, 6) float32 draws in [0, 1):
    ``jax.random.uniform(jax.random.PRNGKey(seed), (num_iters, 6))``."""
    return prng.uniform(prng.prng_key(seed), (num_iters, 6)).numpy()


def _superellipse_search(x: torch.Tensor, y: torch.Tensor, point_mask: torch.Tensor, n: int,
                         lw: torch.Tensor):
    """Random search for the smallest enclosing superellipse over the
    candidates spanned by the unit draws ``lw`` (num_iters, 6). Returns
    (params[6], whether any candidate encloses the points). ``point_mask``
    marks the real hull vertices among the padded points."""
    lo = torch.as_tensor(_BOUNDS[:, 0], device=lw.device)
    hi = torch.as_tensor(_BOUNDS[:, 1], device=lw.device)
    params = lo + (hi - lo) * lw
    t, d, s_a, s_b, c_x, c_y = (params[:, i : i + 1] for i in range(6))

    if n == 2:
        val = _int_pow((x - c_x) / (d * s_a), 2) + _int_pow((y - c_y) / (d * s_b), 2)
    else:
        u = ((x - c_x) * torch.cos(t) - (y - c_y) * torch.sin(t)) / (d * s_a)
        v = ((x - c_x) * torch.sin(t) + (y - c_y) * torch.cos(t)) / (d * s_b)
        val = _int_pow(u, n) + _int_pow(v, n) if n % 2 == 0 else _int_pow(u.abs(), n) + _int_pow(v.abs(), n)
    val = torch.where(point_mask[None, :], val, float("-inf"))
    feasible = val.amax(dim=1) < 1.0

    gamma_const = 4.0 * math.gamma(1 + 1 / n) ** 2 / math.gamma(1 + 2 / n)
    area = gamma_const * params[:, 1] ** 2 * params[:, 2] * params[:, 3]
    area = torch.where(feasible, area, float("inf"))
    return params[torch.argmin(area)], feasible.any()


def get_superellipse_hull(x: np.ndarray, y: np.ndarray, n: int, num_iters: int = NUM_ITERS,
                          seed: int = 0, draws: Optional[np.ndarray] = None, device="cpu"
                          ) -> Tuple[float, float, float, float, float, float]:
    """Smallest random-search superellipse enclosing the points. ``draws``
    are the (num_iters, 6) unit draws; by default ``unit_draws(seed)``.
    Raises if no candidate encloses the points."""
    max_pts = 256
    pts = len(x)
    if pts > max_pts:
        idx = np.linspace(0, pts - 1, max_pts).astype(int)
        x, y = x[idx], y[idx]
        pts = max_pts
    xp = np.zeros(max_pts, np.float32)
    yp = np.zeros(max_pts, np.float32)
    mask = np.zeros(max_pts, bool)
    xp[:pts], yp[:pts], mask[:pts] = x, y, True
    if draws is None:
        draws = unit_draws(seed, num_iters)

    def dev(a):
        return torch.as_tensor(a, device=device)

    params, ok = _superellipse_search(dev(xp), dev(yp), dev(mask), n,
                                      dev(np.array(draws, np.float32)))
    if not bool(ok):
        raise RuntimeError("No feasible superellipse found for hull points")
    t, d, s_a, s_b, c_x, c_y = (float(v) for v in params.cpu())
    return t, d, s_a, s_b, c_x, c_y


def gen_superellipse_mask(t, d, s_a, s_b, c_x, c_y, n: int, shape, device="cpu") -> torch.Tensor:
    """Rasterise a superellipse mask: the row coordinate spans shape[0]
    via x, the column via y."""
    t = torch.tensor(t, dtype=torch.float32, device=device)
    xs = _linspace(shape[0], device)[:, None]
    ys = _linspace(shape[1], device)[None, :]
    c_x, c_y, d, s_a, s_b = (np.float32(v).item() for v in (c_x, c_y, d, s_a, s_b))
    da = torch.tensor(d, dtype=torch.float32, device=device) * s_a
    db = torch.tensor(d, dtype=torch.float32, device=device) * s_b
    u = (((xs - c_x) * torch.cos(t) - (ys - c_y) * torch.sin(t)) / da).abs()
    v = (((xs - c_x) * torch.sin(t) + (ys - c_y) * torch.cos(t)) / db).abs()
    return _int_pow(u, n) + _int_pow(v, n) < 1.0


def _linspace(num: int, device) -> torch.Tensor:
    """``jnp.linspace(-1, 1, num)`` as XLA computes it in float32:
    -(1 - s) + s with s = i * (1 / (num - 1)), and the end point exact."""
    if num == 1:
        return torch.full((1,), -1.0, device=device)
    s = np.arange(num - 1, dtype=np.float32) * (np.float32(1.0) / np.float32(num - 1))
    out = np.append(-(np.float32(1.0) - s) + s, np.float32(1.0)).astype(np.float32)
    return torch.as_tensor(out, device=device)


def _int_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for a positive integer n by repeated squaring, the products
    ``lax.integer_pow`` takes (``torch.pow`` may round otherwise)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def create_convex_hull_mask(array_shape: Tuple[int, int], hull_vertices: np.ndarray) -> np.ndarray:
    """Rasterise the filled convex hull: a half-plane test against the
    ordered hull edges."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(hull_vertices)
    verts = hull_vertices[hull.vertices]  # counter-clockwise order
    rows, cols = np.mgrid[0 : array_shape[0], 0 : array_shape[1]]
    pts = np.stack([rows.ravel(), cols.ravel()], axis=1).astype(np.float64)
    inside = np.ones(pts.shape[0], bool)
    for i in range(len(verts)):
        a = verts[i]
        b = verts[(i + 1) % len(verts)]
        edge = b - a
        rel = pts - a
        cross = edge[0] * rel[:, 1] - edge[1] * rel[:, 0]
        inside &= cross >= -1e-9
    return inside.reshape(array_shape)


def _inject_image_edges(border: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Include mask pixels on the image frame in the border set."""
    border = border.clone()
    border[0, :] |= mask[0, :]
    border[-1, :] |= mask[-1, :]
    border[:, 0] |= mask[:, 0]
    border[:, -1] |= mask[:, -1]
    return border


def generate_well_mask(image, mask_val: int = 1, return_superellipse_params: bool = False,
                       seed: int = 0, draws: Optional[np.ndarray] = None, device="cpu"):
    """Binary uint8 mask over the well of a 2-D image (numpy in, numpy
    out; the raster stages run on ``device``)."""
    from scipy.spatial import ConvexHull

    image = np.asarray(image)
    im_thresh = auto_threshold_well(torch.as_tensor(image.astype(np.float32), device=device))

    downsamp_ratio = min(1, 200 / max(im_thresh.shape))
    small_shape = tuple(int(round(s * downsamp_ratio)) for s in im_thresh.shape)
    im_small = resize(im_thresh.float(), small_shape, "nearest") > 0

    border = _inject_image_edges(canny(im_small.float()), im_small)
    border_points = np.argwhere(border.cpu().numpy())

    def circ_mask():
        center = image.shape[0] // 2, image.shape[1] // 2
        radius = int(image.shape[0] * 0.5 * (1 - 0.95))
        rows, cols = np.mgrid[0 : image.shape[0], 0 : image.shape[1]]
        circ = (rows - center[0]) ** 2 + (cols - center[1]) ** 2 < radius**2
        return (circ * mask_val).astype(np.uint8)

    try:
        hull = ConvexHull(border_points)
    except Exception:  # too few or degenerate points: scipy raises QhullError or ValueError
        return circ_mask()
    hull_vertices = border_points[hull.vertices]

    well_mask = create_convex_hull_mask(small_shape, hull_vertices)
    wm_dev = torch.as_tensor(well_mask, device=device)
    wm_border = _inject_image_edges(canny(wm_dev.float()), wm_dev).cpu().numpy()

    area = well_mask.sum()
    perimeter = wm_border.sum()
    n = 8 if (perimeter / max(area, 1)) > 0.027 else 2

    x = hull_vertices[:, 0] / small_shape[0] * 2 - 1
    y = hull_vertices[:, 1] / small_shape[1] * 2 - 1
    params = None
    try:
        t, d, s_a, s_b, c_x, c_y = get_superellipse_hull(x, y, n, seed=seed, draws=draws,
                                                         device=device)
        d *= 0.9
        well_mask = gen_superellipse_mask(t, d, s_a, s_b, c_x, c_y, n, small_shape,
                                          device).cpu().numpy()
        params = (t, d, s_a, s_b, c_x, c_y, n)
    except RuntimeError:
        print("Falling back to convex hull well mask.", flush=True)

    well_mask = torch.as_tensor(well_mask.astype(np.float32) * mask_val, device=device)
    well_mask = resize(well_mask, image.shape[:2], "nearest").cpu().numpy().astype(np.uint8)

    if params is not None and return_superellipse_params:
        return (well_mask, *params)
    return well_mask


def make_well_mask(img: np.ndarray, seed: int = 0, draws: Optional[np.ndarray] = None,
                   device="cpu"):
    """(well mask, shrunken mask) of a 2-D image, both boolean numpy: the
    shrunken one, inverted, prunes branches at the well's edge. A mask that
    covers under 40% of the frame is dropped for all-True masks."""
    well_mask = generate_well_mask(img, return_superellipse_params=True, seed=seed, draws=draws,
                                   device=device)
    if isinstance(well_mask, tuple):
        well_mask, t, d, s_a, s_b, c_x, c_y, n = well_mask
        well_mask = well_mask > 0
        d *= 0.9
        shrunken = gen_superellipse_mask(t, d, s_a, s_b, c_x, c_y, n, img.shape[:2],
                                         device).cpu().numpy()
    else:
        well_mask = well_mask > 0
        shrunken = morphology.binary_erosion(torch.as_tensor(well_mask, device=device),
                                             morphology.disk(5)).cpu().numpy()

    coverage = well_mask.sum() / well_mask.size
    if coverage < 0.4:
        print(f"{SFM.warning} Well mask coverage is too low ({coverage * 100:.2f}%) "
              "so it will not be used for analysis.")
        well_mask = np.full(img.shape[:2], True)
        shrunken = np.full(img.shape[:2], True)
    return well_mask, shrunken
