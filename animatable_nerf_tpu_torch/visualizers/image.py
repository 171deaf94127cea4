"""Image visualizers in the reference's output layout, and the PNG
writer they and the evaluator's comparison images use.

JAX counterpart: animatable_nerf_tpu/visualizers/image.py:1-81
(`_scatter_image` :20, `_write` :26, `ImageVisualizer` :32,
`NovelViewVisualizer` :48, `PoseSequenceVisualizer` :71; reference
lib/visualizers/if_nerf.py, if_nerf_demo.py, if_nerf_perform.py). JAX
writes with cv2.imwrite, which the machines the port runs on lack, so
`write_png` encodes the file with numpy and zlib: 8-bit RGB, filter 0 on
every row. The pixels are JAX's: `write_image` keeps `_write`'s
conversion, which truncates (np.clip(img, 0, 1) * 255 in float32, then
astype(uint8));
JAX hands cv2 the BGR flip of the image, which cv2 stores as RGB, so the
file holds the image's own channel order. The compressed bytes may
differ from cv2's; the decoded pixels do not.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb_uint8) -> str:
    """Write an (H, W, 3) uint8 RGB image as a PNG (color type 2, bit
    depth 8, no interlace, filter 0 on every row); returns the path."""
    img = np.ascontiguousarray(rgb_uint8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # column 0: filter type 0
    rows[:, 1:] = img.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    data = (_PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
    return path


def write_image(path: str, img_rgb01) -> str:
    """An (H, W, 3) float image in [0, 1] as JAX's `_write` stores it,
    its directory made first; returns the path."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return write_png(path, (np.clip(img_rgb01, 0, 1) * 255).astype(np.uint8))


def _scatter_image(rgb, mask_at_box, H, W):
    """The rays' colours (n, 3) at the True pixels of mask_at_box (H*W
    bools), zero elsewhere: (H, W, 3) float32."""
    img = np.zeros((H, W, 3), np.float32)
    img[mask_at_box.reshape(H, W)] = rgb
    return img


def _scatter_map(values, mask_at_box, H, W):
    out = np.zeros((H, W), np.float32)
    out[mask_at_box.reshape(H, W)] = np.asarray(values).reshape(-1)
    return out


class ImageVisualizer:
    """An eval view's prediction and ground truth under
    <result_dir>/vis/frame<f:04d>_view<v:04d>[_gt].png (if_nerf.py:16-51)."""

    def __init__(self, result_dir: str):
        self.result_dir = result_dir

    def visualize(self, rgb_pred, rgb_gt, mask_at_box, H, W, frame_index,
                  view_index):
        base = os.path.join(self.result_dir, "vis",
                            f"frame{frame_index:04d}_view{view_index:04d}")
        write_image(f"{base}.png",
                    _scatter_image(rgb_pred, mask_at_box, H, W))
        if rgb_gt is not None:
            write_image(f"{base}_gt.png",
                        _scatter_image(rgb_gt, mask_at_box, H, W))


class NovelViewVisualizer:
    """data/novel_view/<exp>/frame_<f:04d>/<v:04d>.png, and with depth
    and acc their (H, W) float32 maps as <v:04d>_depth.npy and
    <v:04d>_acc.npy (if_nerf_demo.py:15-37)."""

    def __init__(self, exp_name: str, out_root: str = "data/novel_view"):
        self.dir = os.path.join(out_root, exp_name)

    def visualize(self, rgb_pred, mask_at_box, H, W, frame_index, view_index,
                  depth=None, acc=None):
        frame_dir = os.path.join(self.dir, f"frame_{frame_index:04d}")
        path = write_image(os.path.join(frame_dir, f"{view_index:04d}.png"),
                           _scatter_image(rgb_pred, mask_at_box, H, W))
        if depth is not None:
            np.save(os.path.join(frame_dir, f"{view_index:04d}_depth.npy"),
                    _scatter_map(depth, mask_at_box, H, W))
        if acc is not None:
            np.save(os.path.join(frame_dir, f"{view_index:04d}_acc.npy"),
                    _scatter_map(acc, mask_at_box, H, W))
        return path


class PoseSequenceVisualizer:
    """data/perform/<exp>/frame<f:04d>_view<v:04d>.png (if_nerf_perform.py)."""

    def __init__(self, exp_name: str, out_root: str = "data/perform"):
        self.dir = os.path.join(out_root, exp_name)

    def visualize(self, rgb_pred, mask_at_box, H, W, frame_index, view_index):
        return write_image(
            os.path.join(self.dir,
                         f"frame{frame_index:04d}_view{view_index:04d}.png"),
            _scatter_image(rgb_pred, mask_at_box, H, W))
