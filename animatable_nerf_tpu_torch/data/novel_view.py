"""The visualization datasets: a novel-view spiral around one frame and
a pose sequence seen from one camera, each item with the training views'
carve masks; and the per-frame metadata and masks the mesh datasets
(data/mesh_dataset.py) share with them.

JAX counterpart: animatable_nerf_tpu/data/novel_view.py
(`get_rays_within_bounds` :28-41, `_VisMixin` :44-111, the novel view
:114-163, the pose sequence :166-217, `_GridFrameMixin` :220-241,
`_PDFFrameMixin` :244-272; reference tpose_novel_view_dataset.py,
tpose_pose_sequence_dataset.py and their pdf variants). The masks come
from the root's decoded archive (`DecodedImages`), through
data/camera.py's undistort, dilate and INTER_NEAREST, as OpenCV computes
them; the image size (H, W) from the archive's first image of the split.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.rays import get_near_far_np, get_rays_np
from . import camera
from .camera_path import gen_path, load_cams
from .dataset import TPoseDataset, TPosePDFDataset
from .utils import get_bounds


def get_rays_within_bounds(H, W, K, R, T, bounds):
    """The rays of every pixel whose slab test against `bounds` passes,
    their near and far, and the (H, W) hit mask
    (if_nerf_data_utils.py:310-339)."""
    ray_o, ray_d = get_rays_np(H, W, K, R, T)
    ray_o = ray_o.reshape(-1, 3)
    ray_d = ray_d.reshape(-1, 3)
    near, far, mask = get_near_far_np(bounds, ray_o, ray_d)
    return ray_o[mask], ray_d[mask], near, far, mask.reshape(H, W)


class _VisMixin:
    """The training views' dilated masks for visibility carving and their
    cameras. `annot_pos` indexes the annots.npy image table by position;
    the frame's file id is the number in its file names (they differ
    for CoreView_313/315, whose file ids are 1-based)."""

    def read(self, index):
        """The whole item: these items draw no random numbers."""
        return self[index]

    def draw(self, index, part):
        return part

    def _file_id_at(self, annot_pos: int) -> int:
        """The file id of the frame at position annot_pos of annots.npy."""
        return self.frame_index_of(self.annots_ims[annot_pos]["ims"][0])[1]

    def _image_size(self):
        """(H, W) of the split's first image scaled by `ratio`, the size
        the visualization items render at."""
        img0 = self._imread_rgb(os.path.join(self.data_root, self.ims[0]))
        return (int(img0.shape[0] * self.cfg.ratio),
                int(img0.shape[1] * self.cfg.ratio))

    def _vis_item(self, item, annot_pos, frame_index, K, R, T, view_index):
        """`item` with the rays of camera (K, R, T) through the frame's
        world box and the training views' carve masks and cameras."""
        H, W = self._image_size()
        ray_o, ray_d, near, far, mask_at_box = get_rays_within_bounds(
            H, W, K, R, T, item["wbounds"])
        Ks, RTs = self._vis_cams(H, W)
        item.update(ray_o=ray_o, ray_d=ray_d, near=near, far=far,
                    mask_at_box=mask_at_box,
                    msks=self._train_view_masks(annot_pos, H, W),
                    Ks=Ks, RT=RTs, H=H, W=W, view_index=view_index,
                    frame_index=frame_index)
        return item

    def _train_view_masks(self, annot_pos, H, W):
        """(V, H, W) uint8: each training view's mask of the frame
        (mask_cihp/ or mask/), nonzero -> 1, undistorted with its
        camera, dilated by a 5x5 square and resized to (H, W) by
        INTER_NEAREST (JAX novel_view.py:57-98). Only the training views:
        the reference packages the masks of cfg.training_view. The last
        four frames' masks are kept."""
        with self._cache_lock:
            cache = self.__dict__.setdefault("_vis_mask_cache", {})
            if (annot_pos, H, W) in cache:
                return cache[(annot_pos, H, W)]
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
        with self._cache_lock:
            if len(cache) >= 4 and (annot_pos, H, W) not in cache:
                cache.pop(next(iter(cache)))
            cache[(annot_pos, H, W)] = out
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


def _make_novel_view(base_cls):
    class _NovelView(_VisMixin, base_cls):
        """One frame (`begin_ith_frame`) seen from `render_views` cameras
        on the spiral of camera_path.gen_path around the split's cameras,
        all with the first camera's K (float64, scaled by `ratio`); R
        and T go to the rays in float32, as in JAX. The appearance latent
        is min(begin_ith_frame, num_train_frame - 1) whatever the frame
        mixin chose (JAX novel_view.py:156-158)."""

        def __init__(self, cfg, split="test"):
            super().__init__(cfg, split)
            dcfg = cfg.test_dataset if split == "test" else cfg.train_dataset
            Ks, RTs = load_cams(dcfg["ann_file"], ratio=cfg.ratio)
            self.render_w2c = gen_path(RTs, cfg.render_views)
            self.K_render = np.array(Ks[0])

        def __len__(self):
            return len(self.render_w2c)

        def __getitem__(self, index):
            annot_pos = self.cfg.begin_ith_frame * self.cfg.frame_interval
            frame_index = self._file_id_at(annot_pos)
            item = self._frame_item(frame_index, annot_pos)
            RT = self.render_w2c[index]
            item = self._vis_item(item, annot_pos, frame_index, self.K_render,
                                  RT[:3, :3].astype(np.float32),
                                  RT[:3, 3].astype(np.float32), index)
            item["latent_index"] = min(self.cfg.begin_ith_frame,
                                       self.cfg.num_train_frame - 1)
            return item

    return _NovelView


def _make_pose_sequence(base_cls):
    class _PoseSequence(_VisMixin, base_cls):
        """The frames of the training window (or with `test_novel_pose`
        or `aninerf_animation` the novel-pose window) seen from the
        split's first camera (JAX novel_view.py:166-217); the latent is
        the frame mixin's."""

        def __init__(self, cfg, split="test"):
            super().__init__(cfg, split)
            self.fixed_cam = self.cam_inds[0]

        def _novel(self):
            return bool(self.cfg.test_novel_pose or self.cfg.aninerf_animation)

        def __len__(self):
            return (self.cfg.num_eval_frame if self._novel()
                    else self.cfg.num_train_frame)

        def __getitem__(self, index):
            i0 = self.cfg.begin_ith_frame
            if self._novel():
                i0 += self.cfg.num_train_frame
            annot_pos = (i0 + index) * self.cfg.frame_interval
            frame_index = self._file_id_at(annot_pos)
            item = self._frame_item(frame_index, annot_pos)
            cam = self.fixed_cam
            K = np.array(self.cams["K"][cam]).copy()
            K[:2] = K[:2] * self.cfg.ratio
            R = np.array(self.cams["R"][cam]).astype(np.float32)
            T = (np.array(self.cams["T"][cam]) / 1000.0).astype(
                np.float32).reshape(3)
            return self._vis_item(item, annot_pos, frame_index, K, R, T, cam)

    return _PoseSequence


NovelViewDataset = _make_novel_view(_GridFrameMixin)
NovelViewPDFDataset = _make_novel_view(_PDFFrameMixin)
PoseSequenceDataset = _make_pose_sequence(_GridFrameMixin)
PoseSequencePDFDataset = _make_pose_sequence(_PDFFrameMixin)
