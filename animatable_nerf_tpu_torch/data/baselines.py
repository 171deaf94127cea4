"""The datasets of the image-space baselines NHR and NT, train and test
splits: whole images.

JAX counterpart: animatable_nerf_tpu/data/baselines.py (`NHRDataset`
:26, `NTDataset` :94; reference lib/datasets/h36m/nhr.py, nt.py), on the
port's `_BaseDataset` (images from `decoded.npz`, data/camera.py's
resizes). cv2.Rodrigues is core/skeleton.py `rodrigues_np`; the uv map's
cv2.resize (INTER_LINEAR) is data/camera.py `resize_linear`. `RT` is the
(3, 4) world -> camera matrix [R | T]; images are channels-last.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.rays import get_bound_2d_mask
from ..core.skeleton import rigid_transforms_host, rodrigues_np
from .camera import resize_linear
from .dataset import _BaseDataset
from .utils import get_bounds


class NHRDataset(_BaseDataset):
    """Whole images with the posed SMPL metadata of the point renderer:
    the big-pose vertices `tpose`, their blend-weight volume `tbw`
    (lbs/bigpose_bw.npy) and bounds, and the frame's bone transforms."""

    def __init__(self, cfg, split: str):
        super().__init__(cfg, split)
        self.tpose = np.load(
            os.path.join(self.lbs_root, "bigpose_vertices.npy")).astype(np.float32)
        self.tbounds = get_bounds(self.tpose, cfg.box_padding)
        self.tbw = np.load(
            os.path.join(self.lbs_root, "bigpose_bw.npy")).astype(np.float32)

    def prepare_pose(self, file_index):
        """(world vertices, A, R, Th) of a frame (h36m/nhr.py:71-104)."""
        cfg = self.cfg
        wxyz = np.load(os.path.join(self.data_root, cfg.vertices,
                                    f"{file_index}.npy")).astype(np.float32)
        params = np.load(os.path.join(self.data_root, cfg.params,
                                      f"{file_index}.npy"),
                         allow_pickle=True).item()
        Rh = np.asarray(params["Rh"], np.float32).reshape(3)
        Th = np.asarray(params["Th"], np.float32).reshape(1, 3)
        R = rodrigues_np(Rh).astype(np.float32)
        poses = np.asarray(params["poses"]).reshape(-1, 3).astype(np.float32)
        A = rigid_transforms_host(poses[:24], self.joints,
                                  self.parents).astype(np.float32)
        return wxyz, A, R, Th

    def __getitem__(self, index):
        img, msk, _, K, R_cam, T_cam, cam_ind, img_path = self.load_image(index)
        frame_index, file_index = self.frame_index_of(img_path)
        wxyz, A, R, Th = self.prepare_pose(file_index)
        wbounds = get_bounds(wxyz, self.cfg.box_padding)
        H, W = img.shape[:2]
        RT = np.concatenate([R_cam, T_cam], axis=1)
        latent_index, _ = self.latent_indices(index)
        return {
            "img": img.astype(np.float32),
            "msk": msk.astype(np.float32),
            "K": K.astype(np.float32),
            "RT": RT.astype(np.float32),
            "mask_at_box": get_bound_2d_mask(wbounds, K, RT, H, W).astype(bool),
            "A": A,
            "big_A": self.big_A,
            "R": R,
            "Th": Th,
            "tpose": self.tpose,
            "tbw": self.tbw,
            "tbounds": self.tbounds,
            "wbounds": wbounds,
            "latent_index": np.asarray(latent_index, np.int32),
            "frame_index": np.asarray(frame_index, np.int32),
            "cam_ind": np.asarray(cam_ind, np.int32),
        }


class NTDataset(_BaseDataset):
    """Whole images with the SMPL uv render of each view,
    `uv/<frame>_<view>.npy`, resized to the image where its size
    differs; `uv_msk` marks the pixels with a nonzero uv."""

    def __init__(self, cfg, split: str):
        super().__init__(cfg, split)
        self.uv_dir = os.path.join(self.data_root, "uv")

    def load_uv(self, file_index, cam_ind, H, W):
        uv = np.load(os.path.join(self.uv_dir, f"{file_index}_{cam_ind}.npy")
                     ).astype(np.float32)
        if uv.shape[:2] != (H, W):
            uv = resize_linear(uv, H, W)
        msk = (np.abs(uv).sum(-1) > 0).astype(np.float32)
        return uv[..., :2], msk

    def __getitem__(self, index):
        img, msk, _, _, _, _, cam_ind, img_path = self.load_image(index)
        frame_index, file_index = self.frame_index_of(img_path)
        uv, uv_msk = self.load_uv(file_index, cam_ind, *img.shape[:2])
        return {
            "img": img.astype(np.float32),
            "msk": msk.astype(np.float32),
            "uv": uv,
            "uv_msk": uv_msk,
            "mask_at_box": msk > 0,
            "frame_index": np.asarray(frame_index, np.int32),
            "cam_ind": np.asarray(cam_ind, np.int32),
        }
