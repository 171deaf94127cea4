"""ctypes shim of the port's host C++ (csrc/mesh_native.cpp): marching
tetrahedra for mesh extraction, the z-buffered rasterizer of the mesh
previews and the occupancy voxelizer of `--type light_stage`.

JAX counterpart: animatable_nerf_tpu/native.py (`mesh_native` :42,
`marching_cubes_native` :90, `rasterize_mesh_native` :135-162,
`voxelize_occupancy_native` :167). The library is built with g++ at first
use into `build/libmesh_native.so` at the checkout root, beside the CUDA
libraries of ops/build.py, with the JAX loader's flags. Unlike the JAX
loader, which returns None when the build fails and lets its callers
fall back to a numpy twin, this shim raises: the port has no fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .ops.build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "mesh_native.cpp"
LIBRARY = BUILD_DIR / "libmesh_native.so"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile csrc/mesh_native.cpp into build/libmesh_native.so unless
    the library is newer than the source; raises if g++ fails. Writes
    to a temporary name first, so concurrent builds never load a
    half-written file."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return str(LIBRARY)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return str(LIBRARY)


def mesh_native():
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.marching_tets.restype = ctypes.c_int
            lib.marching_tets.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # vol
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # D H W
                ctypes.c_float,  # level
                ctypes.POINTER(ctypes.c_float),  # spacing
                ctypes.POINTER(ctypes.c_float),  # origin
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.mesh_native_free.argtypes = [ctypes.c_void_p]
            fp = ctypes.POINTER(ctypes.c_float)
            lib.rasterize_mesh.restype = None
            lib.rasterize_mesh.argtypes = [
                fp, ctypes.c_int64,  # verts, n_verts
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,  # faces
                fp, ctypes.c_int,  # attrs, n_channels
                fp, fp, fp,  # K R T
                ctypes.c_int, ctypes.c_int,  # H W
                fp, fp, ctypes.POINTER(ctypes.c_uint8),  # attr depth mask
            ]
            lib.voxelize_occupancy.restype = None
            lib.voxelize_occupancy.argtypes = [
                fp, ctypes.c_int64, fp,  # points, n, bounds
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # D H W
                ctypes.POINTER(ctypes.c_uint8),  # grid
            ]
            _lib = lib
        return _lib


def marching_tets(volume, level, spacing=(1.0, 1.0, 1.0),
                  origin=(0.0, 0.0, 0.0)):
    """The isosurface {volume == level} of a (D, H, W) grid: (vertices
    (V, 3) float32, faces (F, 3) int64)."""
    lib = mesh_native()
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    D, H, W = vol.shape
    sp = np.asarray(spacing, np.float32)
    org = np.asarray(origin, np.float32)
    pv = ctypes.POINTER(ctypes.c_float)()
    pf = ctypes.POINTER(ctypes.c_int64)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.marching_tets(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        D, H, W, ctypes.c_float(float(level)),
        sp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        org.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(pv), ctypes.byref(pf),
        ctypes.byref(nv), ctypes.byref(nf),
    )
    if rc != 0:
        raise RuntimeError(f"marching_tets returned {rc}")
    try:
        verts = (np.ctypeslib.as_array(pv, shape=(nv.value, 3)).copy()
                 if nv.value else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(pf, shape=(nf.value, 3)).copy()
                 if nf.value else np.zeros((0, 3), np.int64))
        return verts, faces
    finally:
        if nv.value:
            lib.mesh_native_free(pv)
        if nf.value:
            lib.mesh_native_free(pf)


def rasterize_mesh(verts, faces, attrs, K, R, T, H: int, W: int):
    """Z-buffered rasterization of a world-space mesh (verts (V, 3),
    faces (F, 3)) into the camera K (3, 3), R (3, 3), T (3,), with the
    per-vertex attributes (V, C) interpolated perspective-correctly:
    {attr (H, W, C), depth (H, W), mask (H, W) uint8}, zero where no
    triangle covers a pixel."""
    lib = mesh_native()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int64)
    attrs = np.ascontiguousarray(attrs, np.float32)
    C = attrs.shape[1]
    cams = [np.ascontiguousarray(np.asarray(a, np.float32).reshape(shape))
            for a, shape in ((K, (3, 3)), (R, (3, 3)), (T, (3,)))]
    out_attr = np.zeros((H, W, C), np.float32)
    out_depth = np.zeros((H, W), np.float32)
    out_mask = np.zeros((H, W), np.uint8)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.rasterize_mesh(
        verts.ctypes.data_as(fp), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(faces),
        attrs.ctypes.data_as(fp), C,
        *(a.ctypes.data_as(fp) for a in cams), H, W,
        out_attr.ctypes.data_as(fp), out_depth.ctypes.data_as(fp),
        out_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return {"attr": out_attr, "depth": out_depth, "mask": out_mask}


def voxelize_occupancy(points, bounds, shape):
    """Point cloud (N, 3) -> (D, H, W) uint8 occupancy: 1 in each cell of
    the grid over `bounds` ((2, 3): min, max) that a point falls in,
    its cell index truncated toward zero; points outside are dropped."""
    lib = mesh_native()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    b = np.ascontiguousarray(np.asarray(bounds, np.float32).reshape(6))
    D, H, W = (int(n) for n in shape)
    grid = np.zeros((D, H, W), np.uint8)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.voxelize_occupancy(pts.ctypes.data_as(fp), len(pts),
                           b.ctypes.data_as(fp), D, H, W,
                           grid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return grid
