"""Mesh-quality evaluation: chamfer and point-to-surface distances, and
the PLY export of the extracted meshes.

JAX counterpart: animatable_nerf_tpu/evaluators/mesh.py:19-221
(reference lib/evaluators/mesh_evaluator.py, the PIFuHD protocol):
chamfer is the mean closest-surface distance both ways over 1,000
surface samples, P2S one way over 10,000; RenderPeople subjects get the
axis flip; the posed mesh of each frame goes to
data/animation/<exp>/posed_mesh/<frame:04d>.ply. Host numpy and scipy,
with the JAX package's sampling order, so the same RandomState gives
the same numbers.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.spatial import cKDTree


def sample_surface(verts, faces, n: int, rng=None):
    """Area-weighted uniform surface sampling (trimesh.sample semantics)."""
    rng = rng or np.random
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    probs = areas / areas.sum()
    idx = rng.choice(len(faces), size=n, p=probs)
    u = rng.rand(n, 1)
    v = rng.rand(n, 1)
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return v0[idx] + u * (v1[idx] - v0[idx]) + v * (v2[idx] - v0[idx])


def _point_triangle_dist(p, a, b, c):
    """Exact distance from points p (N,3) to triangles (a,b,c) (N,3 each)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = np.einsum("nd,nd->n", ab, ap)
    d2 = np.einsum("nd,nd->n", ac, ap)
    bp = p - b
    d3 = np.einsum("nd,nd->n", ab, bp)
    d4 = np.einsum("nd,nd->n", ac, bp)
    cp = p - c
    d5 = np.einsum("nd,nd->n", ab, cp)
    d6 = np.einsum("nd,nd->n", ac, cp)

    # barycentric regions (Ericson, Real-Time Collision Detection)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    closest = np.zeros_like(p)
    # vertex regions
    m_a = (d1 <= 0) & (d2 <= 0)
    m_b = (d3 >= 0) & (d4 <= d3)
    m_c = (d6 >= 0) & (d5 <= d6)
    # edge regions
    v_ab = np.where(np.abs(d1 - d3) > 1e-30, d1 / (d1 - d3 + 1e-30), 0.0)
    m_ab = (~m_a) & (~m_b) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    w_ac = np.where(np.abs(d2 - d6) > 1e-30, d2 / (d2 - d6 + 1e-30), 0.0)
    m_ac = (~m_a) & (~m_c) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    t_bc = (d4 - d3) / ((d4 - d3) + (d5 - d6) + 1e-30)
    m_bc = (~m_b) & (~m_c) & (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    denom = va + vb + vc + 1e-30
    v_in = vb / denom
    w_in = vc / denom
    inside = a + v_in[:, None] * ab + w_in[:, None] * ac

    closest = inside
    closest = np.where(m_bc[:, None], b + t_bc[:, None] * (c - b), closest)
    closest = np.where(m_ac[:, None], a + w_ac[:, None] * ac, closest)
    closest = np.where(m_ab[:, None], a + v_ab[:, None] * ab, closest)
    closest = np.where(m_c[:, None], c, closest)
    closest = np.where(m_b[:, None], b, closest)
    closest = np.where(m_a[:, None], a, closest)
    return np.linalg.norm(p - closest, axis=1)


def point_to_surface(points, verts, faces, k: int = 24):
    """Distance from each point to the mesh surface: exact
    point-triangle distance over the k nearest triangles (by centroid)."""
    cent = verts[faces].mean(axis=1)
    tree = cKDTree(cent)
    k = min(k, len(faces))
    _, cand = tree.query(points, k=k)
    if k == 1:
        cand = cand[:, None]
    n = len(points)
    best = np.full(n, np.inf)
    for j in range(cand.shape[1]):
        f = faces[cand[:, j]]
        d = _point_triangle_dist(
            points, verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
        )
        best = np.minimum(best, d)
    return best


def chamfer_distance(src_verts, src_faces, tgt_verts, tgt_faces,
                     num_samples: int = 1000, rng=None):
    """Symmetric chamfer (mesh_evaluator.py:100-123)."""
    sp = sample_surface(src_verts, src_faces, num_samples, rng)
    tp = sample_surface(tgt_verts, tgt_faces, num_samples, rng)
    d_st = np.nan_to_num(point_to_surface(sp, tgt_verts, tgt_faces)).mean()
    d_ts = np.nan_to_num(point_to_surface(tp, src_verts, src_faces)).mean()
    return (d_st + d_ts) / 2


def export_ply(path, verts, faces):
    """Minimal binary-little-endian PLY writer."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.asarray(verts).astype("<f4").tobytes())
        if len(faces):  # an empty mesh (e.g. under-trained density
            # below mesh_th) still writes a valid 0-element PLY
            counts = np.full((len(faces), 1), 3, dtype=np.uint8)
            body = np.concatenate(
                [counts.view(np.uint8),
                 np.asarray(faces).astype("<i4").view(np.uint8)
                 .reshape(len(faces), -1)],
                axis=1,
            )
            f.write(body.tobytes())


def load_obj(path):
    """Minimal OBJ loader (v/f lines) for GT meshes."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:4]]
                faces.append(idx)
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


class MeshEvaluator:
    """Accumulating chamfer/P2S evaluator with the reference's output
    layout (mesh_metrics.npy, posed .ply export,
    mesh_evaluator.py:19-72)."""

    def __init__(self, result_dir: str, data_root: str = "", human: str = "",
                 exp_name: str = ""):
        self.result_dir = result_dir
        self.data_root = data_root
        self.human = str(human)
        self.exp_name = exp_name
        self.p2ss = []
        self.chamfers = []

    def evaluate(self, posed_verts, faces, frame_index: int,
                 tgt_mesh_path: str | None = None, rng=None):
        verts = posed_verts
        if "rp" in self.human:
            # RenderPeople axis flip (mesh_evaluator.py:23-27)
            v = np.zeros_like(verts)
            v[:, 0] = verts[:, 0]
            v[:, 1] = verts[:, 2]
            v[:, 2] = -verts[:, 1]
            verts = v

        if tgt_mesh_path is None:
            tgt_mesh_path = os.path.join(
                self.data_root, f"object/{frame_index:06d}.obj"
            )
        out = None
        if os.path.exists(tgt_mesh_path):
            tv, tf = load_obj(tgt_mesh_path)
            rng = rng or np.random.RandomState(0)
            chamfer = chamfer_distance(verts, faces, tv, tf, 1000, rng)
            sp = sample_surface(verts, faces, 10000, rng)
            p2s = np.nan_to_num(point_to_surface(sp, tv, tf)).mean()
            self.chamfers.append(float(chamfer))
            self.p2ss.append(float(p2s))
            out = {"chamfer": float(chamfer), "p2s": float(p2s)}

        mesh_dir = os.path.join("data/animation", self.exp_name, "posed_mesh")
        export_ply(os.path.join(mesh_dir, f"{frame_index:04d}.ply"), verts, faces)
        return out

    def summarize(self):
        os.makedirs(self.result_dir, exist_ok=True)
        np.save(
            os.path.join(self.result_dir, "mesh_metrics.npy"),
            {"p2s": self.p2ss, "chamfer": self.chamfers},
        )
        out = {
            "p2s": float(np.mean(self.p2ss)) if self.p2ss else float("nan"),
            "chamfer": float(np.mean(self.chamfers)) if self.chamfers else float("nan"),
        }
        print(f"the results are saved at {self.result_dir}")
        for k, v in out.items():
            print(f"{k}: {v}")
        self.p2ss, self.chamfers = [], []
        return out
