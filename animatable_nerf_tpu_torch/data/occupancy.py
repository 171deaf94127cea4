"""Point clouds (.ply) to compressed occupancy grids, `--type light_stage`.

JAX counterpart: tools/ply_to_occupancy.py:31-136 (reference
lib/utils/light_stage/ply_to_occupancy.py), which `run.py --type
light_stage` calls. Per frame the cloud is centred and scaled into the
unit cube, the nearest node of a 256^3 grid over [-0.5, 0.5] is marked
for each point (the reference's cKDTree assignment: a floor into cells
shifted by half a step, by the host C++ `voxelize_occupancy`), and
`voxel/<human>/<i>.npz` gets `compressed_occupancies` (packbits) and
`bounds`. JAX falls back to numpy rounding where its native library does
not build, which can differ from the native cell at exact half-step
ties; the port takes the native path only (native.py raises if g++
fails).
"""

from __future__ import annotations

import os

import numpy as np

from ..native import voxelize_occupancy

RES = 256
BB_MIN, BB_MAX = -0.5, 0.5

# PLY property types -> numpy
_PLY_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
}


def load_ply(path: str) -> np.ndarray:
    """The vertices' x, y, z (N, 3) float32 of an ascii or binary
    little-endian PLY (JAX tools/ply_to_occupancy.py:35-85)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a ply file: {path}")
        fmt, n_verts, props, in_vertex = None, 0, [], False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            line = line.strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element"):
                _, name, cnt = line.split()[:3]
                in_vertex = name == b"vertex"
                if in_vertex:
                    n_verts = int(cnt)
            elif line.startswith(b"property") and in_vertex:
                parts = line.split()
                props.append((parts[-1].decode(), parts[1].decode()))
            elif line == b"end_header":
                break
        names = [n for n, _ in props]
        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=n_verts, dtype=np.float64, ndmin=2)
            cols = [names.index(c) for c in ("x", "y", "z")]
            return data[:, cols].astype(np.float32)
        if fmt != "binary_little_endian":
            raise ValueError(f"{path}: unsupported ply format {fmt}")
        dt = np.dtype([(n, "<" + _PLY_TYPES[t]) for n, t in props])
        arr = np.frombuffer(f.read(dt.itemsize * n_verts), dtype=dt,
                            count=n_verts)
        return np.stack([arr["x"], arr["y"], arr["z"]], axis=1).astype(
            np.float32)


def get_scaled_model(model: np.ndarray):
    """The cloud centred on its box and scaled by its longest side, and
    its box (2, 3) (ply_to_occupancy.py:11-18)."""
    mn, mx = model.min(0), model.max(0)
    bounds = np.stack([mn, mx], axis=0)
    center = (mn + mx) / 2
    scale = np.max(mx - mn)
    return (model - center) / scale, bounds


def voxelize(model: np.ndarray) -> np.ndarray:
    """Nearest-node occupancy of the RES^3 grid over [BB_MIN, BB_MAX],
    packbits-compressed: cells whose edges sit half a step below each
    node."""
    step = (BB_MAX - BB_MIN) / (RES - 1)
    bounds = np.array([BB_MIN - step / 2] * 3 + [BB_MAX + step / 2] * 3,
                      np.float32).reshape(2, 3)
    grid = voxelize_occupancy(model, bounds, (RES, RES, RES))
    return np.packbits(grid.reshape(-1).astype(np.int8))


def ply_to_occupancy(data_root: str) -> list:
    """Voxelize every <data_root>/point_cloud/<human>/<i>.ply into
    <data_root>/voxel/<human>/<i>.npz; returns the files written."""
    pc_dir = os.path.join(data_root, "point_cloud")
    voxel_dir = os.path.join(data_root, "voxel")
    written = []
    for human in sorted(os.listdir(pc_dir)):
        src = os.path.join(pc_dir, human)
        dst = os.path.join(voxel_dir, human)
        os.makedirs(dst, exist_ok=True)
        for name in sorted(os.listdir(src)):
            if not name.endswith(".ply"):
                continue
            model, bounds = get_scaled_model(load_ply(os.path.join(src, name)))
            out = os.path.join(dst, f"{int(name.split('.')[0])}.npz")
            np.savez(out, compressed_occupancies=voxelize(model),
                     bounds=bounds)
            written.append(out)
        print(f"voxelized {human} -> {dst}")
    return written
