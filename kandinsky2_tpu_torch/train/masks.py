"""Random inpainting-mask synthesis on the host (numpy and scipy), the
counterpart of ``kandinsky2_tpu/train/masks.py`` (reference:
kandinsky2/train_utils/utils.py:11-209): boxes, smoothed random polygons,
circle and square frames.

Every draw is the JAX package's, in its order, including
``generate_mask``'s vertex count from the global ``np.random`` (which
ignores ``rng``, as there): a seeded run repeats only with the global seed
set too.  The JAX package fills polygons with ``cv2.fillPoly``; the port
fills the same integer-rounded polygon itself (``_rasterize``), so a mask
may differ from cv2's on a pixel that touches an edge.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import interp1d


def _smooth_curve(x: np.ndarray, y: np.ndarray):
    """Quadratic resampling of a closed polygon (train_utils/utils.py:34-43)."""
    n = x.shape[0]
    x = np.concatenate((x[-3:-1], x, x[1:3]))
    y = np.concatenate((y[-3:-1], y, y[1:3]))
    t = np.arange(x.shape[0])
    ti = np.linspace(2, n + 1, 4 * n)
    return interp1d(t, x, kind="quadratic")(ti), interp1d(t, y, kind="quadratic")(ti)


def _rasterize(mask_size, points) -> np.ndarray:
    """1 outside the polygon, 0 inside.  The vertices (x = column, y = row)
    are rounded to integers; a pixel is inside where a scanline through
    its centre crosses the edges an odd number of times to its left (the
    even-odd rule) or where an edge passes through it."""
    rows, cols = mask_size
    canvas = np.zeros(mask_size, np.uint8)
    pts = np.asarray(points, np.float32).round().astype(np.int64)
    x0, y0 = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    spans = y0 != y1
    ex0, ey0, ex1, ey1 = x0[spans], y0[spans], x1[spans], y1[spans]
    lo, hi = np.minimum(ey0, ey1), np.maximum(ey0, ey1)
    for r in range(max(0, int(lo.min(initial=0))), min(rows, int(hi.max(initial=-1)) + 1)):
        live = (lo <= r) & (r < hi)
        xs = np.sort(ex0[live] + (r - ey0[live]) * (ex1[live] - ex0[live])
                     / (ey1[live] - ey0[live]))
        for a, b in zip(xs[0::2], xs[1::2]):
            c0, c1 = max(0, int(np.ceil(a))), min(cols - 1, int(np.floor(b)))
            if c0 <= c1:
                canvas[r, c0:c1 + 1] = 1
    # the edges themselves, one sample per pixel step along each
    for ax, ay, bx, by in zip(x0, y0, x1, y1):
        n = int(max(abs(bx - ax), abs(by - ay))) + 1
        s = np.linspace(0.0, 1.0, n)
        cx = np.round(ax + s * (bx - ax)).astype(np.int64)
        cy = np.round(ay + s * (by - ay)).astype(np.int64)
        keep = (cx >= 0) & (cx < cols) & (cy >= 0) & (cy < rows)
        canvas[cy[keep], cx[keep]] = 1
    return 1.0 - canvas.astype(np.float64)


def polygon_mask_params(mask_size, box, num_vertices, mask_scale, min_scale, max_scale):
    """train_utils/utils.py:11-31."""
    center = ((box[2] + box[0]) / 2, (box[3] + box[1]) / 2)
    sizes = (box[2] - box[0], box[3] - box[1])
    part = np.linspace(
        mask_scale * sizes[0] / 2, mask_scale * sizes[1] / 2, num_vertices // 4
    )
    part = np.clip(part, min_scale * min(mask_size), max_scale * min(mask_size))
    radii = np.concatenate([part, part[::-1], part, part[::-1]])
    return center, radii


def generate_polygon(
    mask_size, center, num_vertices, radii, radii_var, angle_var, smooth=True,
    rng: np.random.RandomState | None = None,
):
    """Random star-polygon mask (train_utils/utils.py:57-75)."""
    rng = rng or np.random
    steps = rng.uniform(1.0 - angle_var, 1.0 + angle_var, size=(num_vertices,))
    steps = 2 * np.pi * steps / steps.sum()
    radii = rng.normal(radii, radii_var * radii)
    radii = np.clip(radii, 0, 2 * radii)
    angles = np.cumsum(steps)
    x = center[0] + radii * np.cos(angles)
    y = center[1] + radii * np.sin(angles)
    if smooth:
        x, y = _smooth_curve(x, y)
    return _rasterize(mask_size, np.stack([x, y], axis=-1))


def generate_circle_frame(mask_size, side_scales, num_vertices, radii_var, rng=None):
    """train_utils/utils.py:78-104: keep a rounded center, inpaint the frame."""
    nv4 = num_vertices // 4
    xs, ys = mask_size
    up = np.full(nv4, ys * (1.0 - side_scales[0]) // 2)
    down = np.full(nv4, ys * (1.0 - side_scales[1]) // 2)
    left = np.full(nv4, xs * (1.0 - side_scales[2]) // 2)
    right = np.full(nv4, xs * (1.0 - side_scales[3]) // 2)
    radii = np.concatenate([right[nv4 // 2 :], down, left, up, right[: nv4 // 2]])
    return 1.0 - generate_polygon(
        mask_size, (xs // 2, ys // 2), num_vertices, radii, radii_var, 0.0, rng=rng
    )


def generate_square_frame(mask_size, side_scales, num_vertices, radii_var, rng=None):
    """train_utils/utils.py:107-148."""
    nv8 = num_vertices // 8
    xs, ys = mask_size
    diag = np.sqrt(xs**2 + ys**2)

    def edge(scale, straight):
        return np.linspace(diag * (1.0 - scale) // 2, straight * (1.0 - scale) // 2, nv8)

    up, down = edge(side_scales[0], ys), edge(side_scales[1], ys)
    left, right = edge(side_scales[2], xs), edge(side_scales[3], xs)
    radii = np.concatenate(
        [right[::-1], down, down[::-1], left, left[::-1], up, up[::-1], right]
    )
    return 1.0 - generate_polygon(
        mask_size, (xs // 2, ys // 2), num_vertices, radii, radii_var, 0.0, rng=rng
    )


def generate_mask(mask_size, box, box_prob=0.1, rng=None):
    """Mixture of box / polygon / frame masks (train_utils/utils.py:151-185)."""
    rng = rng or np.random
    mask = np.ones(mask_size)
    if rng.binomial(1, box_prob):
        box = [int(i) for i in box]
        mask[box[1] : box[3], box[0] : box[2]] = 0
        return mask
    actions = rng.randint(0, 2, (2,))
    if 0 in actions:
        nv = 16
        center, radii = polygon_mask_params(
            mask_size, box, nv, mask_scale=1.5, min_scale=0.1, max_scale=0.6
        )
        mask *= generate_polygon(
            mask_size, center, nv, radii, radii_var=0.15, angle_var=0.15, rng=rng
        )
    if 1 in actions:
        radii_var = 0.15 * rng.random()
        # the global generator, as in the JAX package (see the module note)
        nv = int(np.random.choice([16, 32]))
        if rng.random() < 0.5:
            side_scales = 0.25 * rng.random(4) + 0.05
            mask *= generate_square_frame(mask_size, side_scales, nv, radii_var, rng)
        else:
            side_scales = 0.15 * rng.random(4) + 0.1
            mask *= generate_circle_frame(mask_size, side_scales, nv, radii_var, rng)
    return mask


def get_boxes(bs, target_size, min_scale=0.1, max_scale=0.62, rng=None):
    """train_utils/utils.py:188-201."""
    rng = rng or np.random
    min_x, max_x = min_scale * target_size[0], max_scale * target_size[0]
    min_y, max_y = min_scale * target_size[1], max_scale * target_size[1]
    sx = (max_x - min_x) * rng.random((bs, 1)) + min_x
    sy = (max_y - min_y) * rng.random((bs, 1)) + min_y
    x0 = (target_size[0] - max_x) * rng.random((bs, 1))
    y0 = (target_size[1] - max_y) * rng.random((bs, 1))
    return np.concatenate((x0, y0, x0 + sx, y0 + sx), -1).tolist()


def get_image_mask(bs, target_size, rng=None) -> np.ndarray:
    """[bs, H, W] random inpainting masks (train_utils/utils.py:204-209)."""
    boxes = get_boxes(bs, target_size, rng=rng)
    return np.stack([generate_mask(target_size, box, rng=rng) for box in boxes])
