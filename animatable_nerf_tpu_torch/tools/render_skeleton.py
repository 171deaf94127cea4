"""Debug renders of the SMPL skeleton over dataset frames.

JAX counterpart: tools/render_skeleton.py (`render_human` :25), which
draws with cv2.line (thickness 2) and cv2.circle (radius 3, filled) and
writes with cv2.imwrite. The machines the port runs on have no OpenCV,
so the drawing here is OpenCV's own 8-connected rasterization in numpy
(imgproc/drawing.cpp: the segment clipped to the image grown by the
thickness, `ThickLine`, a convex polygon in 16-bit fixed point with its
outline and two round caps, and the midpoint `Circle`),
and the file is written by visualizers/image.py `write_png`, so that it
decodes to cv2's pixels. Mirrors tools/render_skeleton.py of the
reference: project the posed joints into each camera and draw the
kinematic-tree bones on a black canvas, writing
`skeleton/<frame>_<cam>.png`.

Usage:
  python -m animatable_nerf_tpu_torch.tools.render_skeleton \\
      --data_dir data/zju_mocap --humans CoreView_313
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core.skeleton import rigid_transforms_host as rigid_transforms
from ..smpl.body_model import batch_rodrigues
from ..visualizers.image import write_png

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(img, y, x1, x2, color):
    img[y, x1:x2 + 1] = color


def circle_filled(img, center, radius: int, color):
    """OpenCV's `Circle` with fill (cv2.circle at thickness -1, LINE_8,
    shift 0): the midpoint walk, a span of each of the four rows it
    reaches at each step."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, xl, xr in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= y < h and xl < w and xr >= 0:
                _hline(img, y, max(xl, 0), min(xr, w - 1), color)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _clip_line(w: int, h: int, x1, y1, x2, y2):
    """OpenCV's `clipLine` on a (w, h) box; None when nothing is left."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line_fixed(img, p1, p2, color):
    """OpenCV's `Line2`: an 8-connected line between points in 16-bit
    fixed point."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, *p1, *p2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color

    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex_poly(img, v, color, shift: int):
    """OpenCV's `FillConvexPoly` at LINE_8: the outline by `Line2`, then
    each row's span between the two edges that the walk from the top
    vertex follows."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = 1 << shift >> 1
    delta1 = delta2 = XY_ONE >> 1
    p0 = (v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift))
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << (XY_SHIFT - shift), py << (XY_SHIFT - shift))
        _line_fixed(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": npts - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0, di = e["idx"], e["di"]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e["ye"] = ty
                        e["dx"] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta1) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def line(img, pt1, pt2, color, thickness: int = 2):
    """cv2.line(img, pt1, pt2, color, thickness) at LINE_8, shift 0, for
    thickness > 1: the segment clipped to the image grown by
    `thickness` on each side, then OpenCV's `ThickLine` (the rectangle
    of the line's width, then a round cap at each end)."""
    h, w = img.shape[:2]
    t = thickness
    clipped = _clip_line(w + 2 * t, h + 2 * t, int(pt1[0]) + t, int(pt1[1]) + t,
                         int(pt2[0]) + t, int(pt2[1]) + t)
    if clipped is None:
        return
    x1, y1, x2, y2 = (v - t for v in clipped)
    p0 = [x1 << XY_SHIFT, y1 << XY_SHIFT]
    p1 = [x2 << XY_SHIFT, y2 << XY_SHIFT]
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / np.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        pts = [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
               (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)]
        _fill_convex_poly(img, pts, color, XY_SHIFT)
    for p in (p0, p1):
        center = ((p[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                  (p[1] + (XY_ONE >> 1)) >> XY_SHIFT)
        circle_filled(img, center, (thickness + (XY_ONE >> 1)) >> XY_SHIFT,
                      color)


def render_human(data_dir, human, params_dir="params", ratio: float = 1.0,
                 max_frames: int = -1):
    root = os.path.join(data_dir, human)
    annots = np.load(
        os.path.join(root, "annots.npy"), allow_pickle=True
    ).item()
    cams = annots["cams"]
    joints = np.load(os.path.join(root, "lbs", "joints.npy")).astype(
        np.float32
    )
    parents = np.load(os.path.join(root, "lbs", "parents.npy"))
    out_dir = os.path.join(root, "skeleton")
    os.makedirs(out_dir, exist_ok=True)

    pdir = os.path.join(root, params_dir)
    frame_ids = sorted(
        int(os.path.splitext(nm)[0])
        for nm in os.listdir(pdir)
        if os.path.splitext(nm)[0].isdigit()
    )
    if max_frames > 0:
        frame_ids = frame_ids[:max_frames]

    for i in frame_ids:
        prm = np.load(
            os.path.join(pdir, f"{i}.npy"), allow_pickle=True
        ).item()
        poses = np.asarray(prm["poses"], np.float32).reshape(-1, 3)[:24]
        Rh = np.asarray(prm["Rh"], np.float32).reshape(3)
        Th = np.asarray(prm["Th"], np.float32).reshape(1, 3)
        Rw = batch_rodrigues(Rh[None])[0]
        _, posed = rigid_transforms(poses, joints, parents, return_joints=True)
        world = np.asarray(posed) @ Rw.T + Th

        for c in range(len(cams["K"])):
            K = np.asarray(cams["K"][c], np.float64).copy()
            K[:2] *= ratio
            R = np.asarray(cams["R"][c], np.float64)
            T = np.asarray(cams["T"][c], np.float64).reshape(3, 1) / 1000.0
            cam_pts = world @ R.T + T.T
            pix = cam_pts @ K.T
            uv = (pix[:, :2] / np.maximum(pix[:, 2:], 1e-8)).astype(int)
            H = int(round(K[1, 2] * 2))
            W = int(round(K[0, 2] * 2))
            canvas = np.zeros((H, W, 3), np.uint8)  # BGR, as cv2 draws
            for j in range(1, len(parents)):
                p = int(parents[j])
                line(canvas, uv[p], uv[j], (0, 255, 0), 2)
            for j in range(len(uv)):
                circle_filled(canvas, uv[j], 3, (0, 0, 255))
            write_png(os.path.join(out_dir, f"{i}_{c}.png"), canvas[..., ::-1])
    return out_dir


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--humans", nargs="+", required=True)
    ap.add_argument("--params", default="params")
    ap.add_argument("--ratio", type=float, default=1.0)
    ap.add_argument("--max_frames", type=int, default=-1)
    args = ap.parse_args(argv)
    for human in args.humans:
        out = render_human(
            args.data_dir, human, args.params, args.ratio, args.max_frames
        )
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
