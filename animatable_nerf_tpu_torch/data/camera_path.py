"""The novel-view camera path: a spiral around the training cameras'
mean pose, in float64.

JAX counterpart: animatable_nerf_tpu/data/camera_path.py:25-78
(`load_cams`, `gen_path`; reference lib/utils/render_utils.py:36-130),
with LLFF's [down, right, backwards] axis shuffle, the 80th-percentile
spiral radii and the look-at point z_off = 1.3 ahead of the mean camera.
"""

from __future__ import annotations

import numpy as np

# how far along the mean camera's axis the spiral looks, when the centre
# is the cameras' mean (render_utils.py:100)
Z_OFF = 1.3
_LOWER = np.array([[0.0, 0.0, 0.0, 1.0]])


def _normalize(x):
    return x / np.linalg.norm(x)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec1 = _normalize(np.cross(vec2, up))
    vec0 = _normalize(np.cross(vec1, vec2))
    return np.stack([vec0, vec1, vec2, pos], 1)


def load_cams(ann_file, ratio: float = 1.0):
    """(Ks, RTs) of every camera in annots.npy: K (3, 3) float64 with
    its first two rows scaled by `ratio`, and [R | T / 1000] (4, 4)
    (render_utils.py:36-65)."""
    cams = np.load(ann_file, allow_pickle=True).item()["cams"]
    Ks, RTs = [], []
    for i in range(len(cams["K"])):
        K = np.array(cams["K"][i]).astype(np.float64).copy()
        K[:2] = K[:2] * ratio
        Ks.append(K)
        r = np.array(cams["R"][i])
        t = np.array(cams["T"][i]) / 1000.0
        RTs.append(np.concatenate(
            [np.concatenate([r, t.reshape(3, 1)], 1), _LOWER], 0))
    return Ks, RTs


def gen_path(RT, render_views: int, center=None):
    """`render_views` world-to-camera matrices (4, 4) on a spiral around
    the mean of the cameras RT (render_utils.py:75-130)."""
    RT = np.array(RT).copy()
    RT[:] = np.linalg.inv(RT[:])
    # LLFF axis order [down, right, backwards]
    RT = np.concatenate(
        [RT[:, :, 1:2], RT[:, :, 0:1], -RT[:, :, 2:3], RT[:, :, 3:4]], 2)
    up = _normalize(RT[:, :3, 0].sum(0))
    z = _normalize(RT[0, :3, 2])
    vec1 = _normalize(np.cross(z, up))
    vec2 = _normalize(np.cross(up, vec1))
    z_off = 0.0
    if center is None:
        center = RT[:, :3, 3].mean(0)
        z_off = Z_OFF
    c2w = np.stack([up, vec1, vec2, center], 1)

    tt = np.matmul(c2w[:3, :3].T,
                   (RT[:, :3, 3] - c2w[:3, 3])[..., None])[..., 0].T
    rads = np.percentile(np.abs(tt), 80, -1) * 1.3
    rads = np.array(list(rads) + [1.0])

    render_w2c = []
    for theta in np.linspace(0.0, 2 * np.pi, render_views + 1)[:-1]:
        cam_pos = np.array([0, np.sin(theta), np.cos(theta), 1] * rads)
        cam_pos_world = np.dot(c2w[:3, :4], cam_pos)
        z = _normalize(cam_pos_world
                       - np.dot(c2w[:3, :4], np.array([z_off, 0, 0, 1.0])))
        mat = _viewmatrix(z, up, cam_pos_world)
        mat = np.concatenate(
            [mat[:, 1:2], mat[:, 0:1], -mat[:, 2:3], mat[:, 3:4]], 1)
        render_w2c.append(np.linalg.inv(np.concatenate([mat, _LOWER], 0)))
    return render_w2c
