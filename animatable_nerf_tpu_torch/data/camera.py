"""The camera image operations of the datasets, in numpy, as OpenCV
computes them.

JAX counterpart: the cv2 calls of animatable_nerf_tpu/data/dataset.py:131-158
(`load_image`): cv2.undistort of the image and both masks,
cv2.resize with INTER_AREA (the image) and INTER_NEAREST (the masks).
The machines the port runs on have no OpenCV, so this module repeats
its arithmetic:

  * `undistort_map`: cv2.undistort's map (initUndistortRectifyMap with
    the camera matrix as the new one), built in float64 stripe by stripe
    as cv2.undistort builds it, pixel -> normalized -> k1 k2 p1 p2 k3 ->
    pixel, rounded to 1/32 pixel (INTER_BITS 5);
  * `undistort`: cv2.remap's INTER_LINEAR on that map with a constant
    border of 0: float32 taps weighted in float32 and summed in tap
    order; uint8 taps weighted in integers at 2^15 and rounded as
    (acc + 2^14) >> 15, which is floor(sum + 1/2) of the same float32
    sum, exact for uint8 taps;
  * `resize_area`: INTER_AREA, the mean of the blocks at an integer
    factor (summed in OpenCV's order), OpenCV's fractional-area rule
    otherwise (in float64; OpenCV sums it in float32);
  * `resize_nearest`: INTER_NEAREST's index rule;
  * `dilate`: cv2.dilate with a square kernel of ones, its default
    anchor and border (pixels outside the image take no part), which
    the mesh datasets apply to the training views' masks (JAX
    data/novel_view.py:57-98);
  * `resize_linear`: INTER_LINEAR, which the NT dataset applies to a uv
    map of another size than its image (JAX data/baselines.py:104-107).

tests/test_torch_camera.py and tests/test_torch_baselines.py hold each against cv2.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS


def _coeffs(D) -> np.ndarray:
    """k1, k2, p1, p2, k3 from a (5, 1) or (5,) distortion array."""
    d = np.asarray(D, np.float64).reshape(-1)
    if d.size != 5:
        raise ValueError(
            f"lens distortion needs 5 coefficients (k1 k2 p1 p2 k3), got {d.size}")
    return d


def is_identity(D) -> bool:
    """True for a camera without lens distortion, whose undistort map is
    the identity (each pixel maps to itself, its taps weighted 1, 0, 0,
    0)."""
    return not np.any(_coeffs(D))


class UndistortMap(NamedTuple):
    """Per output pixel (row-major), its four taps (y, x), (y, x + 1),
    (y + 1, x), (y + 1, x + 1): flat int32 source indices (H * W for a
    tap outside the image, which reads 0) and float32 weights. Each
    array is (4, H * W) and read-only."""
    index: np.ndarray
    weight: np.ndarray


def _inverse3(m: np.ndarray) -> list:
    """cv2's inverse of a 3x3 float64 matrix (Mat::inv with DECOMP_LU:
    cofactors times 1/det). `m` is (..., 3, 3); returns the nine
    entries row by row, each (...,)."""
    s = lambda r, c: m[..., r, c]  # noqa: E731
    d = (s(0, 0) * (s(1, 1) * s(2, 2) - s(1, 2) * s(2, 1))
         - s(0, 1) * (s(1, 0) * s(2, 2) - s(1, 2) * s(2, 0))
         + s(0, 2) * (s(1, 0) * s(2, 1) - s(1, 1) * s(2, 0)))
    d = 1.0 / d
    return [
        (s(1, 1) * s(2, 2) - s(1, 2) * s(2, 1)) * d,
        (s(0, 2) * s(2, 1) - s(0, 1) * s(2, 2)) * d,
        (s(0, 1) * s(1, 2) - s(0, 2) * s(1, 1)) * d,
        (s(1, 2) * s(2, 0) - s(1, 0) * s(2, 2)) * d,
        (s(0, 0) * s(2, 2) - s(0, 2) * s(2, 0)) * d,
        (s(0, 2) * s(1, 0) - s(0, 0) * s(1, 2)) * d,
        (s(1, 0) * s(2, 1) - s(1, 1) * s(2, 0)) * d,
        (s(0, 1) * s(2, 0) - s(0, 0) * s(2, 1)) * d,
        (s(0, 0) * s(1, 1) - s(0, 1) * s(1, 0)) * d,
    ]


def _fixed_point_map(K, d, H, W):
    """cv2.undistort's source coordinates in 1/32 pixel, (H, W) int64
    each. cv2 builds the map in stripes of max(1, 4096 // W) rows, each
    with the new camera matrix's cy moved to the stripe's first row, and
    rounds u * 32 and v * 32 to the nearest integer, ties to even."""
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2, k3 = d
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    stripe = min(max(1, 4096 // max(W, 1)), H)
    rows = np.arange(H)
    first = rows - rows % stripe
    Ar = np.broadcast_to(K, (H, 3, 3)).copy()
    Ar[:, 1, 2] = v0 - first
    ir = _inverse3(Ar)
    i = (rows % stripe).astype(np.float64)[:, None]
    j = np.arange(W, dtype=np.float64)[None, :]
    col = lambda t: t[:, None]  # noqa: E731
    _x = i * col(ir[1]) + col(ir[2]) + j * col(ir[0])
    _y = i * col(ir[4]) + col(ir[5]) + j * col(ir[3])
    _w = i * col(ir[7]) + col(ir[8]) + j * col(ir[6])
    w = 1.0 / _w
    x, y = _x * w, _y * w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy
    u = fx * xd + u0
    v = fy * yd + v0
    return (np.rint(u * INTER_TAB_SIZE).astype(np.int64),
            np.rint(v * INTER_TAB_SIZE).astype(np.int64))


@functools.lru_cache(maxsize=32)
def _cached_map(K_bytes, d_bytes, H, W):
    K = np.frombuffer(K_bytes, np.float64).reshape(3, 3)
    d = np.frombuffer(d_bytes, np.float64)
    iu, iv = _fixed_point_map(K, d, H, W)
    sx, sy = iu >> INTER_BITS, iv >> INTER_BITS
    a = (iu & (INTER_TAB_SIZE - 1)).astype(np.float32) * np.float32(
        1.0 / INTER_TAB_SIZE)
    b = (iv & (INTER_TAB_SIZE - 1)).astype(np.float32) * np.float32(
        1.0 / INTER_TAB_SIZE)
    one = np.float32(1.0)
    weight = np.stack([(one - b) * (one - a), (one - b) * a,
                       b * (one - a), b * a]).reshape(4, -1)
    index = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        ty, tx = sy + dy, sx + dx
        inside = (ty >= 0) & (ty < H) & (tx >= 0) & (tx < W)
        index.append(np.where(inside, ty * W + tx, H * W).reshape(-1))
    out = UndistortMap(np.stack(index).astype(np.int32), weight)
    for arr in out:
        arr.flags.writeable = False
    return out


def undistort_map(K, D, H: int, W: int) -> UndistortMap:
    """cv2.undistort's map for the camera (K, D) on H x W images,
    built once per (K, D, H, W) and kept (32 cameras at most; 32 bytes
    a pixel)."""
    K = np.ascontiguousarray(K, np.float64).reshape(3, 3)
    return _cached_map(K.tobytes(), _coeffs(D).tobytes(), int(H), int(W))


def undistort(img: np.ndarray, K, D) -> np.ndarray:
    """cv2.undistort(img, K, D) for a float32 or uint8 image, (H, W) or
    (H, W, C)."""
    d = _coeffs(D)
    if img.dtype not in (np.float32, np.uint8):
        raise TypeError(f"undistort takes float32 or uint8 images, not {img.dtype}")
    H, W = img.shape[:2]
    m = undistort_map(K, d, H, W)
    flat = img.reshape(H * W, -1)
    src = np.concatenate([flat, np.zeros((1, flat.shape[1]), img.dtype)])
    taps = np.take(src, m.index, axis=0)  # (4, H * W, C)
    w = m.weight[..., None]
    out = taps[0] * w[0] + taps[1] * w[1]
    out += taps[2] * w[2]
    out += taps[3] * w[3]
    if img.dtype == np.uint8:
        # cv2 weights uint8 taps by the weights times 2^15 (integers: the
        # bilinear weights are multiples of 2^-10 that sum to 1) and
        # rounds the sum as (acc + 2^14) >> 15. Each float32 product and
        # partial sum above is a multiple of 2^-10 below 256, so exact,
        # and acc is 2^15 times the sum: the result is floor(sum + 1/2).
        out = np.floor(out + np.float32(0.5)).astype(np.uint8)
    return out.reshape(img.shape)


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """INTER_NEAREST's source index of each output index: floor(i / f)
    with f = dst / src in float64, at most src - 1."""
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64), src - 1)


def resize_nearest(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST)."""
    h, w = img.shape[:2]
    if (h, w) == (H, W):
        return img.copy()
    return img[_nearest_index(h, H)[:, None], _nearest_index(w, W)[None, :]]


def dilate(img: np.ndarray, size: int = 5) -> np.ndarray:
    """cv2.dilate(img, np.ones((size, size), np.uint8)) of an integer
    image (H, W): the maximum over the size x size window centred on
    each pixel (anchor size // 2), over the pixels inside the image."""
    if img.ndim != 2 or img.dtype.kind not in "ub":
        raise TypeError(f"dilate takes (H, W) integer images, not {img.dtype} {img.shape}")
    H, W = img.shape
    r = size // 2
    low = np.iinfo(img.dtype).min if img.dtype.kind != "b" else False
    padded = np.full((H + size - 1, W + size - 1), low, img.dtype)
    padded[r:r + H, r:r + W] = img
    out = img.copy()
    for dy in range(size):
        for dx in range(size):
            np.maximum(out, padded[dy:dy + H, dx:dx + W], out=out)
    return out


def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of INTER_AREA along one axis
    (computeResizeAreaTab): each output cell of width src / dst takes
    each source pixel by the share of the cell it covers."""
    scale = src / dst
    out = np.zeros((dst, src))
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            out[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        out[dx, sx1:sx2] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            out[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return out


def resize_area(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA) of a
    float32 image, (h, w) or (h, w, C), to a size no larger. At integer
    factors each output is its block's pixels summed row by row, left
    to right, in float32, times 1 / area, as OpenCV's fast path; at
    other factors the fractional-area rule in float64."""
    h, w = img.shape[:2]
    if img.dtype != np.float32:
        raise TypeError(f"resize_area takes float32 images, not {img.dtype}")
    if (h, w) == (H, W):
        return img.copy()
    sy, sx = h / H, w / W
    if sy < 1 or sx < 1:
        raise ValueError("resize_area only shrinks")
    if sy == int(sy) and sx == int(sx):
        sy, sx = int(sy), int(sx)
        blocks = img.reshape(H, sy, W, sx, *img.shape[2:])
        terms = [blocks[:, k // sx, :, k % sx] for k in range(sy * sx)]
        # OpenCV's scalar loop adds the terms four at a time, each four
        # left to right in one expression, then the rest one by one
        acc = np.zeros_like(terms[0])
        for k in range(0, len(terms) - 3, 4):
            acc += ((terms[k] + terms[k + 1]) + terms[k + 2]) + terms[k + 3]
        for t in terms[len(terms) // 4 * 4:]:
            acc += t
        channels = 1 if img.ndim == 2 else img.shape[2]
        if (sy, sx) == (2, 2) and channels in (1, 4):
            # its SIMD loop at 2x2 adds the two rows' pairs, 4 floats at a
            # time: one channel leaves the last W % 4 outputs to the scalar
            # loop
            simd = ((terms[0] + terms[1]) + (terms[2] + terms[3]))
            n = W - W % 4 if channels == 1 else W
            acc[:, :n] = simd[:, :n]
        return acc * np.float32(1.0 / (sy * sx))
    ay, ax = _area_weights(h, H), _area_weights(w, W)
    rows = np.tensordot(ay, img.astype(np.float64), axes=(1, 0))
    out = np.moveaxis(np.tensordot(ax, rows, axes=(1, 1)), 0, 1)
    return out.astype(np.float32)


def _linear_taps(src: int, dst: int):
    """INTER_LINEAR's taps along one axis (resizeGeneric's coefficient
    table): for output i, source (i + 0.5) * src / dst - 0.5 rounded to
    float32, its floor s and the weights (1 - f, f) in float32, the
    borders clamped to the edge pixel with f = 0."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    edge = (s < 0) | (s >= src - 1)
    f[edge] = 0.0
    s = np.clip(s, 0, src - 1)
    return s, np.minimum(s + 1, src - 1), np.float32(1.0) - f, f


def resize_linear(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR) of a
    float32 image, (h, w) or (h, w, C), to any size: the horizontal pass,
    then the vertical one, each a two-tap blend in float32 (OpenCV's own
    loop, which it takes for two-channel maps such as the NT baseline's
    uv maps: within one float32 rounding of it; where OpenCV hands 1, 3
    or 4 channels to IPP, within 2.5e-6 on [0, 1] values)."""
    h, w = img.shape[:2]
    if img.dtype != np.float32:
        raise TypeError(f"resize_linear takes float32 images, not {img.dtype}")
    if (h, w) == (H, W):
        return img.copy()
    x0, x1, ax0, ax1 = _linear_taps(w, W)
    y0, y1, by0, by1 = _linear_taps(h, H)
    cshape = (1, -1) + (1,) * (img.ndim - 2)
    rows = img[:, x0] * ax0.reshape(cshape) + img[:, x1] * ax1.reshape(cshape)
    rshape = (-1,) + (1,) * (img.ndim - 1)
    return rows[y0] * by0.reshape(rshape) + rows[y1] * by1.reshape(rshape)
