"""Decoded images of a dataset root, kept in one `decoded.npz`.

The port reads images through `DecodedImages`, which needs no image
codec: the machines it runs on may lack OpenCV and PIL. The archive is
written once, on a machine with OpenCV, by

    python -m animatable_nerf_tpu_torch.data.decode_cache data/synthetic/human

which stores every .jpg and .png under the root exactly as
`cv2.imread(path, cv2.IMREAD_UNCHANGED)` returns it (BGR channel order),
keyed by the path relative to the root.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ARCHIVE = "decoded.npz"
_EXTS = (".jpg", ".jpeg", ".png")


class DecodedImages:
    """Read access to `<data_root>/decoded.npz`."""

    def __init__(self, data_root: str):
        self.data_root = data_root
        path = os.path.join(data_root, ARCHIVE)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} is missing: run `python -m "
                f"animatable_nerf_tpu_torch.data.decode_cache {data_root}` "
                "on a machine with OpenCV"
            )
        with np.load(path) as z:
            self._arrays = {k: z[k] for k in z.files}

    def key(self, path: str) -> str:
        return os.path.relpath(path, self.data_root).replace(os.sep, "/")

    def __contains__(self, path: str) -> bool:
        return self.key(path) in self._arrays

    def items(self):
        """(key, array) of every image, keyed by its path relative to
        the root."""
        return self._arrays.items()

    def imread(self, path: str) -> np.ndarray:
        """The array cv2.imread(path, cv2.IMREAD_UNCHANGED) returns."""
        try:
            return self._arrays[self.key(path)]
        except KeyError:
            raise FileNotFoundError(path) from None


def image_files(data_root: str) -> list:
    out = []
    for dirpath, _, files in os.walk(data_root):
        for f in files:
            if f.lower().endswith(_EXTS):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def write_archive(data_root: str) -> str:
    import cv2

    arrays = {}
    for path in image_files(data_root):
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise OSError(f"cv2 could not decode {path}")
        arrays[os.path.relpath(path, data_root).replace(os.sep, "/")] = img
    out = os.path.join(data_root, ARCHIVE)
    np.savez_compressed(out, **arrays)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit(
            "usage: python -m animatable_nerf_tpu_torch.data.decode_cache "
            "<data_root>"
        )
    out = write_archive(argv[0])
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
