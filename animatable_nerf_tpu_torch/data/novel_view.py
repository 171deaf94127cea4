"""Per-frame metadata and the training views' carve masks of the
visualization datasets (the mesh datasets, data/mesh_dataset.py, so far).

JAX counterpart: animatable_nerf_tpu/data/novel_view.py (`_VisMixin`
:44-111, `_GridFrameMixin` :220-241, `_PDFFrameMixin` :244-272;
reference tpose_novel_view_dataset.py:85-122). The novel-view and
pose-sequence datasets of that module are not ported yet. The masks come
from the root's decoded archive (`DecodedImages`), through
data/camera.py's undistort, dilate and INTER_NEAREST, as OpenCV computes
them.
"""

from __future__ import annotations

import os

import numpy as np

from . import camera
from .dataset import TPoseDataset, TPosePDFDataset
from .utils import get_bounds


class _VisMixin:
    """The training views' dilated masks for visibility carving and their
    cameras. `annot_pos` indexes the annots.npy image table by position;
    the frame's file id is the number in its file names (they differ
    for CoreView_313/315, whose file ids are 1-based)."""

    def _train_view_masks(self, annot_pos, H, W):
        """(V, H, W) uint8: each training view's mask of the frame
        (mask_cihp/ or mask/), nonzero -> 1, undistorted with its
        camera, dilated by a 5x5 square and resized to (H, W) by
        INTER_NEAREST (JAX novel_view.py:57-98). Only the training views:
        the reference packages the masks of cfg.training_view. The last
        four frames' masks are kept."""
        cache = getattr(self, "_vis_mask_cache", None)
        if cache is None:
            cache = self._vis_mask_cache = {}
        key = (annot_pos, H, W)
        if key in cache:
            return cache[key]
        views = list(self.cfg.training_view)
        ims = np.array(self.annots_ims[annot_pos]["ims"])[views]
        msks = []
        for nv, im in zip(views, ims):
            candidates = [
                os.path.join(self.data_root, "mask_cihp", im)[:-4] + ".png",
                os.path.join(self.data_root, im.replace("images", "mask"))[:-4]
                + ".png",
                os.path.join(self.data_root, im.replace("images", "mask"))[:-4]
                + ".jpg",
            ]
            p = next((c for c in candidates if c in self.images), candidates[0])
            msk = self._imread_rgb(p)
            if msk.ndim == 3:
                msk = msk[..., 0]
            msk = (msk != 0).astype(np.uint8)
            D = np.array(self.cams["D"][nv])
            if not camera.is_identity(D):
                msk = camera.undistort(msk, np.array(self.cams["K"][nv]), D)
            msk = camera.dilate(msk)
            msks.append(camera.resize_nearest(msk, H, W))
        out = np.array(msks)
        if len(cache) >= 4:
            cache.pop(next(iter(cache)))
        cache[key] = out
        return out

    def _vis_cams(self, H, W):
        """The training views' K (V, 3, 3), scaled by `ratio`, and [R |
        T / 1000] (V, 3, 4), float32."""
        Ks, RTs = [], []
        for i in list(self.cfg.training_view):
            K = np.array(self.cams["K"][i]).copy()
            K[:2] = K[:2] * self.cfg.ratio
            Ks.append(K)
            r = np.array(self.cams["R"][i])
            t = (np.array(self.cams["T"][i]) / 1000.0).reshape(3, 1)
            RTs.append(np.concatenate([r, t], 1))
        return np.array(Ks).astype(np.float32), np.array(RTs).astype(np.float32)


def _latent_index(cfg, annot_pos):
    return min(annot_pos // max(cfg.frame_interval, 1), cfg.num_train_frame - 1)


class _GridFrameMixin(TPoseDataset):
    """Frame i's metadata for the grid blend-weight model (AniNeRF),
    without image reads."""

    def _frame_item(self, i, annot_pos=None):
        wpts, A, pbw, pbounds, wbounds, Rh, Th, Rw = self._frame_inputs(i)
        return {
            "A": A,
            "big_A": self.big_A,
            "pbw": pbw,
            "tbw": self.tbw,
            "pbounds": pbounds,
            "wbounds": wbounds,
            "tbounds": self.tbounds,
            "R": Rw,
            "Th": Th,
            "latent_index": _latent_index(
                self.cfg, i if annot_pos is None else annot_pos),
            "bw_latent_index": 0,
        }


class _PDFFrameMixin(TPosePDFDataset):
    """Frame i's metadata for the KNN families, without image reads. The
    latent is the nearest training frame's where the root has
    lbs/training_joints.npy and the run asks for novel poses."""

    def _frame_item(self, i, annot_pos=None):
        wpts, ppts, A, poses, Rh, Th, Rw = self._pose_inputs(i)
        latent_index = _latent_index(self.cfg,
                                     i if annot_pos is None else annot_pos)
        if self.training_joints is not None:
            latent_index = self.nearest_training_frame(
                self._posed_joints(poses, Th, Rw))
        return {
            "A": A,
            "big_A": self.big_A,
            "poses": poses.reshape(-1),
            "weights": self.weights,
            "tvertices": self.tpose,
            "pvertices": ppts,
            "pbounds": get_bounds(ppts, self.cfg.box_padding),
            "wbounds": get_bounds(wpts, self.cfg.box_padding),
            "tbounds": self.tbounds,
            "R": Rw,
            "Th": Th,
            "latent_index": latent_index,
            "bw_latent_index": 0,
        }
