"""The datasets of the grid blend-weight models (AniNeRF) and of the
KNN/displacement models (NeRF-PDF, SDF-PDF, NeuS-PDF), train and test
splits.

JAX counterpart: animatable_nerf_tpu/data/dataset.py:52-456
(`_BaseDataset`, `TPoseDataset`, `TPosePDFDataset` :324; reference
lib/datasets/tpose_dataset.py, tpose_pdf_dataset.py).
Differences forced by the machines the port runs on, which lack OpenCV:
  * images come from the root's `decoded.npz` (data/decode_cache.py),
    decoded as cv2.imread decodes them;
  * cv2.undistort and cv2.resize (JAX dataset.py:136-152) are
    data/camera.py's numpy versions, equal to OpenCV's; a step that is an
    identity (masks of the image's size, a camera without distortion,
    ratio 1) is skipped;
  * cv2.Rodrigues is core/skeleton.py `rodrigues_np`.
Per-frame volumes are edge-padded to the dataset-wide max shape, as in
JAX, so every frame samples identically.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.skeleton import big_pose_A, rigid_transforms_host, rodrigues_np
from . import camera
from .decode_cache import DecodedImages
from .utils import (
    crop_mask_edge,
    erode_mask_edge,
    get_bounds,
    pad_volume_to,
    sample_rays_image,
)


class _BaseDataset:
    """Cameras, images and views of a split (JAX dataset.py:52-105
    `_BaseDataset`): the training views on the train split, the test
    views otherwise. The train split draws its rays from `self._rng`
    (the trainer seeds it under `fix_random`, as JAX does)."""

    def __init__(self, cfg, split: str):
        self.cfg = cfg
        self.split = split
        dcfg = cfg.train_dataset if split == "train" else cfg.test_dataset
        self.data_root = dcfg["data_root"]
        self.human = dcfg["human"]
        annots = np.load(dcfg["ann_file"], allow_pickle=True).item()
        self.cams = annots["cams"]
        self.annots_ims = annots["ims"]  # every frame's image table
        self.images = DecodedImages(self.data_root)

        num_cams = len(self.cams["K"])
        if split == "train":
            view = list(cfg.training_view)
        elif len(cfg.test_view) == 0:
            view = [i for i in range(num_cams) if i not in cfg.training_view]
            view = view or [0]
        else:
            view = list(cfg.test_view)

        i = cfg.begin_ith_frame
        i_intv = cfg.frame_interval
        ni = cfg.num_train_frame
        if cfg.test_novel_pose or cfg.aninerf_animation:
            i = cfg.begin_ith_frame + cfg.num_train_frame * i_intv
            ni = cfg.num_eval_frame
        frames = annots["ims"][i : i + ni * i_intv][::i_intv]
        self.ims = np.array(
            [np.array(f["ims"])[view] for f in frames]
        ).ravel()
        self.cam_inds = np.array(
            [np.arange(len(f["ims"]))[view] for f in frames]
        ).ravel()
        self.num_cams = len(view)
        for cam in np.unique(self.cam_inds):
            # undistort reads k1 k2 p1 p2 k3; any other count raises here
            camera.is_identity(self.cams["D"][cam])

        self.lbs_root = os.path.join(self.data_root, "lbs")
        self.joints = np.load(os.path.join(self.lbs_root, "joints.npy")).astype(
            np.float32
        )
        self.parents = np.load(os.path.join(self.lbs_root, "parents.npy"))
        self.big_A = big_pose_A(self.joints, self.parents).astype(np.float32)
        self._rng = np.random.RandomState()

    def __len__(self):
        return len(self.ims)

    # ---------------------------------------------------------- images
    def _imread_rgb(self, path):
        img = self.images.imread(path)
        if img.ndim == 3:
            img = img[..., :3][..., ::-1]
        return np.ascontiguousarray(img)

    def get_mask(self, index):
        """tpose_dataset.py:92-123 (path fallbacks + edge erosion)."""
        im = self.ims[index]
        candidates = [
            os.path.join(self.data_root, "mask_cihp", im)[:-4] + ".png",
            os.path.join(self.data_root, im.replace("images", "mask"))[:-4] + ".png",
            os.path.join(self.data_root, im.replace("images", "mask"))[:-4] + ".jpg",
            os.path.join(self.data_root, "mask", im)[:-4] + ".png",
        ]
        msk_path = next((p for p in candidates if p in self.images), candidates[0])
        msk = self._imread_rgb(msk_path)
        if msk.ndim == 3:
            msk = msk[..., 0]
        if "deepcap" in self.data_root:
            msk = (msk > 125).astype(np.uint8)
        else:
            msk = (msk != 0).astype(np.uint8)
        orig_msk = msk.copy()
        if not self.cfg.eval and self.cfg.erode_edge:
            msk = erode_mask_edge(msk, border=5)
        return msk, orig_msk

    def load_image(self, index):
        """JAX dataset.py:131-158: the masks resized to the image
        (INTER_NEAREST), the image and both masks undistorted with the
        item's K and D, all resized by `ratio` (INTER_AREA for the image,
        INTER_NEAREST for the masks), the background masked, and K[:2]
        scaled on a copy."""
        img_path = os.path.join(self.data_root, self.ims[index])
        img = self._imread_rgb(img_path).astype(np.float32) / 255.0
        msk, orig_msk = self.get_mask(index)
        cam_ind = self.cam_inds[index]
        K = np.array(self.cams["K"][cam_ind])
        D = np.array(self.cams["D"][cam_ind])
        H, W = img.shape[:2]
        if msk.shape[:2] != (H, W):
            msk = camera.resize_nearest(msk, H, W)
            orig_msk = camera.resize_nearest(orig_msk, H, W)
        if not camera.is_identity(D):
            img = camera.undistort(img, K, D)
            msk = camera.undistort(msk, K, D)
            orig_msk = camera.undistort(orig_msk, K, D)
        ratio = self.cfg.ratio
        H, W = int(H * ratio), int(W * ratio)
        if (H, W) != img.shape[:2]:
            img = camera.resize_area(img, H, W)
            msk = camera.resize_nearest(msk, H, W)
            orig_msk = camera.resize_nearest(orig_msk, H, W)
        R = np.array(self.cams["R"][cam_ind])
        T = np.array(self.cams["T"][cam_ind]) / 1000.0
        if self.cfg.mask_bkgd:
            img[msk == 0] = 0
        K = K.copy()
        K[:2] = K[:2] * ratio
        return img, msk, orig_msk, K, R, T, cam_ind, img_path

    def frame_index_of(self, img_path):
        if self.human in ["CoreView_313", "CoreView_315"]:
            i = int(os.path.basename(img_path).split("_")[4])
            return i - 1, i
        i = int(os.path.basename(img_path)[:-4])
        return i, i

    def latent_indices(self, index):
        """tpose_dataset.py:264-276."""
        latent_index = index // self.num_cams
        bw_latent_index = index // self.num_cams
        if self.cfg.test_novel_pose:
            if "h36m" in self.data_root:
                latent_index = 0
            else:
                latent_index = self.cfg.num_train_frame - 1
        return latent_index, bw_latent_index

    def frame_file_index(self, index):
        """The index of the item's frame files (vertices/params)."""
        return self.frame_index_of(self.ims[index])[1]

    def _image_rays(self, index, wbounds):
        """The fields every item carries: its pixels, its rays (on the
        test split all of its camera's rays that hit the frame's world
        bounds, on the train split N_rand drawn by
        `sample_rays_image`), its indices."""
        img, msk, orig_msk, K, R, T, cam_ind, img_path = self.load_image(index)
        frame_index, _ = self.frame_index_of(img_path)
        rgb, ray_o, ray_d, near, far, coord, mask_at_box = sample_rays_image(
            img, msk, K, R, T, wbounds, self.split,
            mask_bkgd=self.cfg.mask_bkgd, nrays=self.cfg.N_rand,
            body_sample_ratio=self.cfg.body_sample_ratio,
            face_sample_ratio=self.cfg.face_sample_ratio, rng=self._rng,
        )
        if self.cfg.erode_edge:
            orig_msk = crop_mask_edge(orig_msk)
        latent_index, bw_latent_index = self.latent_indices(index)
        return {
            "rgb": rgb,
            "occupancy": orig_msk[coord[:, 0], coord[:, 1]],
            "ray_o": ray_o,
            "ray_d": ray_d,
            "near": near,
            "far": far,
            "mask_at_box": mask_at_box,
            "H": img.shape[0],
            "W": img.shape[1],
            "coord": coord,
            "latent_index": latent_index,
            "bw_latent_index": bw_latent_index,
            "frame_index": frame_index,
            "cam_ind": cam_ind,
        }

    def _pose_inputs(self, i):
        """Frame i's world and posed vertices, bone transforms A, SMPL
        poses (24, 3), Rh (3,), Th (1, 3) and R, float32
        (tpose_dataset.py:125-161)."""
        wxyz = np.load(
            os.path.join(self.data_root, self.cfg.vertices, f"{i}.npy")
        ).astype(np.float32)
        params = np.load(
            os.path.join(self.data_root, self.cfg.params, f"{i}.npy"),
            allow_pickle=True,
        ).item()
        Rh = params["Rh"].astype(np.float32).reshape(3)
        Th = params["Th"].astype(np.float32).reshape(1, 3)
        R = rodrigues_np(Rh).astype(np.float32)
        pxyz = np.dot(wxyz - Th, R).astype(np.float32)
        poses = params["poses"].reshape(-1, 3).astype(np.float32)
        A = rigid_transforms_host(poses, self.joints, self.parents).astype(
            np.float32
        )
        return wxyz, pxyz, A, poses, Rh, Th, R


class TPoseDataset(_BaseDataset):
    """Items of the grid blend-weight dataset (tpose_dataset.py; JAX
    dataset.py:283-325 `__getitem__`)."""

    def __init__(self, cfg, split: str):
        super().__init__(cfg, split)
        tpose = np.load(os.path.join(self.lbs_root, "tvertices.npy")).astype(
            np.float32
        )
        self.tbounds = get_bounds(tpose, cfg.box_padding)
        self.tbw = np.load(os.path.join(self.lbs_root, "tbw.npy")).astype(
            np.float32
        )
        frame_ids = sorted(
            {self.frame_index_of(im)[1] for im in self.ims}
        )
        shapes = [
            np.load(os.path.join(self.lbs_root, f"bweights/{fid}.npy"),
                    mmap_mode="r").shape[:3]
            for fid in frame_ids
        ]
        self.max_pbw_shape = tuple(np.max(np.array(shapes), axis=0))
        self._frame_cache = {}

    # ------------------------------------------------------ per frame
    def prepare_input(self, i):
        """tpose_dataset.py:125-161."""
        wxyz, pxyz, A, _, Rh, Th, R = self._pose_inputs(i)
        pbw = np.asarray(
            np.load(os.path.join(self.lbs_root, f"bweights/{i}.npy")),
            dtype=np.float32,
        )
        return wxyz, pxyz, A, pbw, Rh, Th, R

    def _frame_inputs(self, i):
        """Per-frame pose data + padded bw grid, cached (all views of a
        frame share them)."""
        hit = self._frame_cache.get(i)
        if hit is None:
            wpts, ppts, A, pbw, Rh, Th, Rw = self.prepare_input(i)
            pbounds = get_bounds(ppts, self.cfg.box_padding)
            wbounds = get_bounds(wpts, self.cfg.box_padding)
            pbw, pbounds = pad_volume_to(pbw, pbounds, self.max_pbw_shape)
            hit = (wpts, A, pbw, pbounds, wbounds, Rh, Th, Rw)
            if len(self._frame_cache) >= 8:
                self._frame_cache.pop(next(iter(self._frame_cache)))
            self._frame_cache[i] = hit
        return hit

    def __getitem__(self, index):
        wpts, A, pbw, pbounds, wbounds, Rh, Th, Rw = self._frame_inputs(
            self.frame_file_index(index))
        item = self._image_rays(index, wbounds)
        item.update({
            "A": A,
            "big_A": self.big_A,
            "pbw": pbw,
            "tbw": self.tbw,
            "pbounds": pbounds,
            "wbounds": wbounds,
            "tbounds": self.tbounds,
            "R": Rw,
            "Th": Th,
        })
        return item


class TPosePDFDataset(_BaseDataset):
    """Items of the KNN/displacement dataset (JAX dataset.py:324-456;
    tpose_pdf_dataset.py): raw SMPL blend weights, the frame's posed
    vertices and the canonical bounds from the big-pose vertices
    (`use_bigpose`) or the T-pose ones. On the train split the rays are
    drawn as `TPoseDataset`'s (`_image_rays`), with the occupancy of
    the silhouette loss. Under `test_novel_pose` an item's appearance
    latent is that of the training frame whose posed joints lie nearest
    to its own (`nearest_training_frame`, JAX dataset.py:340-356,
    :424-427), where the root has lbs/training_joints.npy; without it,
    `num_train_frame - 1`."""

    def __init__(self, cfg, split: str):
        super().__init__(cfg, split)
        self.weights = np.load(
            os.path.join(self.lbs_root, "weights.npy")).astype(np.float32)
        vert_name = ("bigpose_vertices.npy" if cfg.get("use_bigpose", False)
                     else "tvertices.npy")
        self.tpose = np.load(
            os.path.join(self.lbs_root, vert_name)).astype(np.float32)
        self.tbounds = get_bounds(self.tpose, cfg.box_padding)
        # the training frames' world-space posed joints (F, 24, 3), read
        # only for novel poses (tpose_pdf_dataset.py:36-38)
        self.training_joints = None
        path = os.path.join(self.lbs_root, "training_joints.npy")
        if (cfg.test_novel_pose or cfg.aninerf_animation) and os.path.exists(path):
            self.training_joints = np.load(path)

    def nearest_training_frame(self, posed_joints):
        """The training frame whose joints lie nearest, on average over
        the joints, to posed_joints (24, 3) in world space
        (tpose_pdf_dataset.py:176-184); None without training joints."""
        if self.training_joints is None:
            return None
        d = np.linalg.norm(self.training_joints - posed_joints[None],
                           axis=-1).mean(-1)
        return int(d.argmin())

    def _posed_joints(self, poses, Th, R):
        """The joints posed by poses (24, 3), in world space (JAX
        dataset.py:372-378; training_joints.npy is written in world
        coordinates)."""
        _, joints = rigid_transforms_host(poses, self.joints, self.parents,
                                          return_joints=True)
        return np.asarray(joints) @ R.T + Th

    def __getitem__(self, index):
        # JAX dataset.py:357 prepare_input
        wpts, ppts, A, poses, Rh, Th, Rw = self._pose_inputs(
            self.frame_file_index(index))
        wbounds = get_bounds(wpts, self.cfg.box_padding)
        item = self._image_rays(index, wbounds)
        if self.cfg.test_novel_pose and self.training_joints is not None:
            item["latent_index"] = self.nearest_training_frame(
                self._posed_joints(poses, Th, Rw))
        item.update({
            "A": A,
            "big_A": self.big_A,
            "poses": poses.reshape(-1),
            "weights": self.weights,
            "tvertices": self.tpose,
            "pvertices": ppts,
            "pbounds": get_bounds(ppts, self.cfg.box_padding),
            "wbounds": wbounds,
            "tbounds": self.tbounds,
            "R": Rw,
            "Th": Th,
        })
        return item
