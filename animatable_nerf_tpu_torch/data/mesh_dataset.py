"""Mesh-extraction datasets: one item a test frame, with a dense point
grid over the subject's bounds and the training views' carve masks.

JAX counterpart: animatable_nerf_tpu/data/mesh_dataset.py (`grid_points`
:25-38, `MeshDataset`, `SDFMeshDataset`, `PDFMeshDataset` :41-93;
reference lib/datasets/aninerf_mesh_dataset.py:100-156 and
anisdf_mesh_dataset.py). MeshDataset (AniNeRF) and PDFMeshDataset (the
KNN families that extract by density) grid the world bounds;
SDFMeshDataset (SDF-PDF, NeuS-PDF) the canonical ones.
"""

from __future__ import annotations

import numpy as np

from .novel_view import _GridFrameMixin, _PDFFrameMixin, _VisMixin


def grid_points(bounds, voxel_size):
    """(X, Y, Z, 3) float32 nodes from bounds[0] to bounds[1] at
    voxel_size (aninerf_mesh_dataset.py:144-156). The steps stay Python
    floats, so np.arange runs in the bounds' float32 as in the reference;
    a float64 step moves the nodes by about 4e-7."""
    vs = [float(v) for v in np.asarray(voxel_size).ravel()]
    x = np.arange(bounds[0, 0], bounds[1, 0] + vs[0], vs[0])
    y = np.arange(bounds[0, 1], bounds[1, 1] + vs[1], vs[1])
    z = np.arange(bounds[0, 2], bounds[1, 2] + vs[2], vs[2])
    return np.stack(np.meshgrid(x, y, z, indexing="ij"), axis=-1).astype(
        np.float32)


def _make_mesh_dataset(base_cls, canonical: bool):
    class _Mesh(base_cls, _VisMixin):
        def __init__(self, cfg, split="test"):
            super().__init__(cfg, split)
            # one item a frame: its file id (the params and vertices
            # files) and its position in annots.npy (the training views'
            # masks)
            n_frames = len(self.ims) // self.num_cams
            name_to_pos = {nm: pos for pos, entry in enumerate(self.annots_ims)
                           for nm in entry["ims"]}
            names = [self.ims[k * self.num_cams] for k in range(n_frames)]
            self.frame_ids = [self.frame_index_of(nm)[1] for nm in names]
            self.frame_positions = [name_to_pos[nm] for nm in names]
            # the frame sampler reads len(dataset) // num_cams
            # (aninerf_mesh_dataset.py:45 sets num_cams = 1)
            self.num_cams = 1

        def __len__(self):
            return len(self.frame_ids)

        def __getitem__(self, index):
            i = self.frame_ids[index]
            annot_pos = self.frame_positions[index]
            item = self._frame_item(i, annot_pos)
            bounds = item["tbounds"] if canonical else item["wbounds"]
            item["pts"] = grid_points(bounds, self.cfg.voxel_size)
            item["frame_index"] = i
            H, W = self._image_size()
            item["msks"] = self._train_view_masks(annot_pos, H, W)
            item["Ks"], item["RT"] = self._vis_cams(H, W)
            item["voxel_size"] = np.asarray(self.cfg.voxel_size, np.float32)
            return item

    return _Mesh


MeshDataset = _make_mesh_dataset(_GridFrameMixin, canonical=False)
SDFMeshDataset = _make_mesh_dataset(_PDFFrameMixin, canonical=True)
PDFMeshDataset = _make_mesh_dataset(_PDFFrameMixin, canonical=False)
