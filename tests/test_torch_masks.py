"""The port's inpainting-mask synthesis (``kandinsky2_tpu_torch/train/
masks.py``, numpy and scipy) against the JAX package's
(``kandinsky2_tpu/train/masks.py``, which fills polygons with cv2): the
boxes, the polygon parameters and every vertex drawn, exactly, for one
``RandomState`` and one global seed; and each rasterised mask against
cv2's, where the two may differ only on pixels that touch a polygon
edge."""

import numpy as np
import pytest

from kandinsky2_tpu.train import masks as jmasks
from kandinsky2_tpu_torch.train import masks as tmasks

SEEDS = range(8)


def _draw(mod, fn, size, seed):
    """``fn`` of ``mod`` on a fresh RandomState, the global seed set."""
    np.random.seed(1000 + seed)
    rng = np.random.RandomState(seed)
    if fn == "mask":
        return mod.generate_mask((size, size), mod.get_boxes(1, (size, size), rng=rng)[0],
                                 rng=rng)
    if fn == "square":
        return mod.generate_square_frame((size, size), 0.25 * rng.random(4) + 0.05,
                                         int(rng.choice([16, 32])), 0.15 * rng.random(),
                                         rng)
    return mod.generate_circle_frame((size, size), 0.15 * rng.random(4) + 0.1,
                                     int(rng.choice([16, 32])), 0.15 * rng.random(), rng)


def _polygons(monkeypatch, mod):
    """Record the (size, vertices) of every polygon ``mod`` rasterises."""
    seen = []
    inner = mod._rasterize

    def rasterize(mask_size, points):
        seen.append((tuple(mask_size), np.asarray(points)))
        return inner(mask_size, points)

    monkeypatch.setattr(mod, "_rasterize", rasterize)
    return seen


@pytest.mark.parametrize("size", [64, 96])
def test_boxes_and_polygon_params_match_jax(size):
    for seed in SEEDS:
        boxes = [mod.get_boxes(4, (size, size), rng=np.random.RandomState(seed))
                 for mod in (tmasks, jmasks)]
        assert boxes[0] == boxes[1]
        for box in boxes[0]:
            got = tmasks.polygon_mask_params((size, size), box, 16, 1.5, 0.1, 0.6)
            want = jmasks.polygon_mask_params((size, size), box, 16, 1.5, 0.1, 0.6)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("fn", ["mask", "square", "circle"])
def test_polygon_vertices_match_jax_exactly(monkeypatch, fn):
    """The same draws in the same order, the global one included: every
    polygon either package rasterises has the same vertices."""
    got, want = _polygons(monkeypatch, tmasks), _polygons(monkeypatch, jmasks)
    for seed in SEEDS:
        for mod in (tmasks, jmasks):
            _draw(mod, fn, 96, seed)
    assert len(got) == len(want) > 0
    for (gs, gp), (ws, wp) in zip(got, want):
        assert gs == ws
        np.testing.assert_array_equal(gp, wp)


def _edge_distance(cols, rows, points):
    """Distance from each pixel centre to the nearest edge of the polygon of
    integer-rounded ``points`` (x = column, y = row)."""
    a = np.asarray(points, np.float32).round().astype(np.float64)
    d = np.roll(a, -1, axis=0) - a
    length2 = np.maximum((d ** 2).sum(1), 1e-12)
    p = np.stack([cols, rows], -1)[:, None, :].astype(np.float64)
    s = np.clip(((p - a) * d).sum(-1) / length2, 0.0, 1.0)
    return np.sqrt(((p - (a + s[..., None] * d)) ** 2).sum(-1)).min(1)


@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("fn", ["mask", "square", "circle"])
def test_masks_match_cv2_up_to_edge_pixels(monkeypatch, fn, size):
    """Over 8 seeds: at least 99 % of each mask's pixels equal JAX's cv2
    mask, and every pixel that differs lies within 1 px of an edge of one
    of the mask's polygons."""
    polys = _polygons(monkeypatch, tmasks)
    for seed in SEEDS:
        polys.clear()
        got = _draw(tmasks, fn, size, seed)
        want = _draw(jmasks, fn, size, seed)
        assert got.shape == want.shape == (size, size)
        assert set(np.unique(got)) <= {0.0, 1.0}
        assert (got == want).mean() >= 0.99, (seed, (got == want).mean())
        rows, cols = np.nonzero(got != want)
        if len(rows):
            dist = np.min([_edge_distance(cols, rows, p) for _, p in polys], axis=0)
            assert dist.max() <= 1.0, (seed, dist.max())


def test_image_mask_batch_matches_jax():
    """``get_image_mask`` as the inpainting CLI calls it (the global
    generator only): the same boxes and mask kinds, [B, H, W], within the
    edge tolerance of cv2's."""
    out = []
    for mod in (tmasks, jmasks):
        np.random.seed(7)
        out.append(mod.get_image_mask(4, (96, 96)))
    got, want = out
    assert got.shape == want.shape == (4, 96, 96)
    assert (got == want).mean() >= 0.99


def test_rasterize_fills_a_square_and_its_edges():
    """An axis-aligned square, vertices on pixel centres: its interior and
    its boundary pixels are 0, everything else 1 (cv2's fill)."""
    square = [(2, 1), (5, 1), (5, 6), (2, 6)]
    m = tmasks._rasterize((8, 8), square)
    want = np.ones((8, 8))
    want[1:7, 2:6] = 0
    np.testing.assert_array_equal(m, want)
    np.testing.assert_array_equal(m, jmasks._rasterize((8, 8), square))


def test_the_vertex_count_follows_the_global_generator_in_both():
    """A quirk both packages share: ``generate_mask`` draws a frame's vertex
    count from the global ``np.random``, not from ``rng``, so one
    ``RandomState`` seed gives other polygons under another global seed,
    in the port as in the JAX package."""
    counts = {}
    for mod in (tmasks, jmasks):
        for global_seed in (0, 1, 2, 3):
            for seed in range(6):
                np.random.seed(global_seed)
                rng = np.random.RandomState(seed)
                box = mod.get_boxes(1, (64, 64), rng=rng)[0]
                mask = mod.generate_mask((64, 64), box, box_prob=0.0, rng=rng)
                counts.setdefault(mod.__name__, {})[(global_seed, seed)] = mask.sum()
    got, want = counts[tmasks.__name__], counts[jmasks.__name__]
    assert any(len({got[(g, seed)] for g in range(4)}) > 1 for seed in range(6))
    assert any(len({want[(g, seed)] for g in range(4)}) > 1 for seed in range(6))
