"""Seeded images of filled shapes with their boxes, for the SSD detector.

The port's numpy-only counterpart of ``tools/datasets.py::shapes_det300``,
the labelled set that ``assets/trained/ssd_shapes_ms`` was trained and is
scored on: 300×300 RGB images, each with 1 to 3 shapes (circle, square,
triangle, star) in distinct cells of a 2×2 grid, on a plain background of
contrasting colour, with Gaussian noise and now and then a blur.  The JAX
package draws them with OpenCV; this module fills the same kinds of shapes
with numpy, so it runs where OpenCV is missing (the machine with the card).
The pixels differ from the OpenCV drawing; the task is the same, and the
trained detector finds the shapes (``chip_smoke.py`` prints its mAP).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

CLASSES = ("circle", "square", "triangle", "star")  # detector labels 1 .. 4
SIZE = 300

Box = Tuple[float, float, float, float]


def _colors(rng):
    """(fg, bg) RGB colours with guaranteed contrast."""
    while True:
        fg = rng.integers(0, 256, 3)
        bg = rng.integers(0, 256, 3)
        if np.abs(fg.astype(int) - bg.astype(int)).sum() > 180:
            return fg.astype(np.uint8), bg.astype(np.uint8)


def _polygon(cx, cy, r, n_vertices, rot, star=False) -> np.ndarray:
    """Vertices of a regular polygon (or a 5-point star), rounded to pixels."""
    n = n_vertices * (2 if star else 1)
    a = rot + 2 * np.pi * np.arange(n) / n
    rad = np.where(np.arange(n) % 2 == 0, r, r * 0.45) if star else np.full(n, r)
    return np.round(np.stack([cx + rad * np.cos(a), cy + rad * np.sin(a)], axis=1))


def _fill_polygon(canvas, pts, color):
    """Fill the pixels whose centres lie inside the polygon (even-odd rule)."""
    x0, y0 = np.maximum(np.floor(pts.min(axis=0)).astype(int), 0)
    x1, y1 = np.minimum(np.ceil(pts.max(axis=0)).astype(int) + 1, SIZE)
    ys, xs = np.mgrid[y0:y1, x0:x1].astype(np.float64)
    inside = np.zeros(ys.shape, bool)
    for (xa, ya), (xb, yb) in zip(pts, np.roll(pts, -1, axis=0)):
        if ya == yb:
            continue
        crosses = (ya > ys) != (yb > ys)
        inside ^= crosses & (xs < (xb - xa) * (ys - ya) / (yb - ya) + xa)
    canvas[y0:y1, x0:x1][inside] = color


def _fill_circle(canvas, cx, cy, r, color):
    ys, xs = np.mgrid[0:SIZE, 0:SIZE]
    canvas[(xs - cx) ** 2 + (ys - cy) ** 2 <= r * r] = color


def _draw(rng, canvas, cls, region) -> Box:
    """One shape of class ``cls`` inside ``region``; returns its box in
    pixels (the circumscribed square clipped to the region)."""
    fg, _ = _colors(rng)
    rx0, ry0, rx1, ry1 = region
    r = int(min(rx1 - rx0, ry1 - ry0) * rng.uniform(0.28, 0.42))
    cx = int(rng.uniform(rx0 + r + 1, rx1 - r - 1))
    cy = int(rng.uniform(ry0 + r + 1, ry1 - r - 1))
    rot = float(rng.uniform(0, 2 * np.pi))
    name = CLASSES[cls]
    if name == "circle":
        _fill_circle(canvas, cx, cy, r, fg)
    elif name == "square":
        _fill_polygon(canvas, _polygon(cx, cy, r, 4, rot + np.pi / 4), fg)
    elif name == "triangle":
        _fill_polygon(canvas, _polygon(cx, cy, r, 3, rot), fg)
    else:
        _fill_polygon(canvas, _polygon(cx, cy, r, 5, rot, star=True), fg)
    return (max(rx0, cx - r), max(ry0, cy - r), min(rx1, cx + r), min(ry1, cy + r))


def _blur(img):
    """3×3 binomial blur ([1, 2, 1] / 4 along each axis), edges repeated."""
    p = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    p = (p[:-2] + 2 * p[1:-1] + p[2:]) / 4
    return (p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]) / 4


def shapes_det300(n: int, seed: int):
    """(x (n, 3, 300, 300) float32 in [0, 255], boxes): boxes[i] is a list of
    (label, (xmin, ymin, xmax, ymax)) with the label in the detector's
    space (1 .. 4; 0 is the background) and the corners normalized by the
    image size."""
    rng = np.random.default_rng(seed)
    half = SIZE // 2
    cells = [(0, 0, half, half), (half, 0, SIZE, half),
             (0, half, half, SIZE), (half, half, SIZE, SIZE)]
    xs, boxes = [], []
    for _ in range(n):
        _, bg = _colors(rng)
        canvas = np.empty((SIZE, SIZE, 3), np.uint8)
        canvas[:] = bg
        recs: List[Tuple[int, Box]] = []
        for ci in rng.choice(len(cells), size=int(rng.integers(1, 4)), replace=False):
            cls = int(rng.integers(len(CLASSES)))
            x0, y0, x1, y1 = _draw(rng, canvas, cls, cells[ci])
            recs.append((cls + 1, (x0 / SIZE, y0 / SIZE, x1 / SIZE, y1 / SIZE)))
        img = canvas.astype(np.float32)
        if rng.random() < 0.3:
            img = _blur(img)
        img = np.clip(img + rng.normal(0, 5, img.shape), 0, 255)
        xs.append(img.transpose(2, 0, 1))
        boxes.append(recs)
    return np.stack(xs).astype(np.float32), boxes
