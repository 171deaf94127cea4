"""Mesh visualizer: each extracted mesh as .ply and as a raw .npy.

JAX counterpart: animatable_nerf_tpu/visualizers/mesh.py (`MeshVisualizer`
:14-27; reference lib/visualizers/mesh_visualizer.py:16-42): posed or
T-pose meshes under data/animation/<exp>/{posed_mesh,tpose_mesh}/.
"""

from __future__ import annotations

import os

import numpy as np

from ..evaluators.mesh import export_ply


class MeshVisualizer:
    def __init__(self, exp_name: str, out_root: str = "data/animation"):
        self.dir = os.path.join(out_root, exp_name)

    def visualize(self, verts, faces, frame_index: int, posed: bool = True):
        """Write <frame:04d>.ply and <frame:04d>.npy ({vertex, triangle})
        under posed_mesh/ or tpose_mesh/; returns the PLY's path."""
        sub = "posed_mesh" if posed else "tpose_mesh"
        path = os.path.join(self.dir, sub, f"{frame_index:04d}.ply")
        export_ply(path, verts, faces)
        np.save(os.path.join(self.dir, sub, f"{frame_index:04d}.npy"),
                {"vertex": verts, "triangle": faces})
        return path
