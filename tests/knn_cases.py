"""Seeded adversarial inputs for the KNN blend kernels K2 and K5, shared
by their CPU rehearsal (tests/test_torch_knn.py) and their card tests
(tests/test_torch_cuda.py). numpy only.

The vertex cloud is a box longest along y, as a standing body is, so the
kernels' tested axis is y unless a case flattens it. Kinds:
  * cloud: queries around the vertices;
  * duplicates: the second half of the vertices copies the first;
  * ties_off_axis: the second half mirrors the first in x, and the
    queries sit at x = 0, so vertices that differ only off the tested
    axis tie, at the k-th distance too;
  * plane: every vertex at y = 0.1, and the queries on that plane (the
    y test never rejects there);
  * on_vertices: every query exactly on a vertex;
  * far: queries 1e3 away from the cloud, where squared distances tie
    in float32;
  * nan: a cloud whose second query has a NaN coordinate.
"""

import numpy as np

KINDS = ("cloud", "duplicates", "ties_off_axis", "plane", "on_vertices",
         "far", "nan")
EXTENT = np.array([0.6, 1.6, 0.4], np.float32)


def knn_inputs(kind, n, m, c, seed):
    """(src (n, 3), ref (m, 3), vals (m, c)) float32 for one kind."""
    rng = np.random.RandomState(seed)
    ref = (rng.uniform(-0.5, 0.5, (m, 3)) * EXTENT).astype(np.float32)
    half = m // 2
    if kind == "duplicates":
        ref[half:2 * half] = ref[:half]
    elif kind == "ties_off_axis":
        ref[half:2 * half] = ref[:half] * np.array([-1, 1, 1], np.float32)
    elif kind == "plane":
        ref[:, 1] = 0.1
    pick = rng.randint(0, m, n)
    src = (ref[pick] + rng.normal(0, 0.03, (n, 3))).astype(np.float32)
    if kind == "ties_off_axis":
        src[:, 0] = 0.0
    elif kind == "plane":
        src[:, 1] = 0.1
    elif kind == "on_vertices":
        src = ref[pick].copy()
    elif kind == "far":
        away = rng.normal(0, 1, (n, 3))
        away /= np.linalg.norm(away, axis=1, keepdims=True)
        src = (src + 1e3 * away).astype(np.float32)
    elif kind == "nan" and n > 1:
        src[1, 2] = np.nan
    vals = rng.uniform(0, 1, (m, c)).astype(np.float32)
    return src, ref, vals


BLOCKED_CASES = [(kind, "exact") for kind in KINDS] + [
    ("corner", "exact"), ("away", "zero"), ("cloud", "huge")]


def blocked_inputs(kind, radius, n, m, c, k, seed):
    """K5's inputs: knn_inputs' case and each query's radius, (src, ref,
    vals, d5ub). radius: "exact" (the query's k-th distance in float64,
    with a margin that covers float32 rounding), "zero" or "huge" (10).
    Two more kinds: `corner` squeezes the cloud's queries into y in
    [-0.78, -0.62], the cloud's bottom, so that a tile's radius culls
    blocks; `away` moves them 1e3 along x, so that with radius 0 a tile
    of them keeps no block (a tile's zero pads count in its box)."""
    src, ref, vals = knn_inputs(kind if kind in KINDS else "cloud", n, m, c,
                                seed)
    if kind == "corner":
        src[:, 1] = src[:, 1] * 0.1 - 0.7
    elif kind == "away":
        src[:, 0] += 1e3
    if radius == "exact":
        d2 = ((src[:, None].astype(np.float64) - ref[None]) ** 2).sum(-1)
        d5 = np.sqrt(np.partition(d2, k - 1, axis=1)[:, k - 1])
        d5ub = (d5 * (1 + 1e-5) + 1e-6).astype(np.float32)
    else:
        d5ub = np.full(n, 0.0 if radius == "zero" else 10.0, np.float32)
    return src, ref, vals, d5ub
