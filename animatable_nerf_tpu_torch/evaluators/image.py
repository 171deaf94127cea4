"""Image-quality evaluation: PSNR + SSIM with the reference's protocol.

JAX counterpart: animatable_nerf_tpu/evaluators/image.py:26-155
(reference lib/evaluators/if_nerf.py): PSNR over the rays inside the
projected box, SSIM on the bounding-rect crop of the scattered image
with skimage's float defaults (7x7 uniform window, K1=0.01, K2=0.03,
data_range=2.0); and each view's prediction and ground truth written
as PNGs under <result_dir>/comparison/ (JAX :111-122) by the port's own
writer (visualizers/image.py `write_png`), with JAX's pixels: its
conversion here is np.clip(img * 255, 0, 255).astype(np.uint8) on the
float64 images, not the visualizers' (which clip to [0, 1] in float32
first).
"""

from __future__ import annotations

import os

import numpy as np
from scipy.ndimage import uniform_filter

from ..visualizers.image import write_png


def psnr_metric(img_pred, img_gt):
    mse = np.mean((img_pred - img_gt) ** 2)
    return -10 * np.log(mse) / np.log(10)


def ssim_single(im1, im2, data_range=2.0, win_size=7, K1=0.01, K2=0.03):
    """skimage structural_similarity for 2-D float images, default args
    (gaussian_weights=False path)."""
    im1 = im1.astype(np.float64)
    im2 = im2.astype(np.float64)
    # box means with reflect padding (scipy.ndimage's default, as skimage)
    NP = win_size**2
    cov_norm = NP / (NP - 1)

    ux = uniform_filter(im1, win_size)
    uy = uniform_filter(im2, win_size)
    uxx = uniform_filter(im1 * im1, win_size)
    uyy = uniform_filter(im2 * im2, win_size)
    uxy = uniform_filter(im1 * im2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    R = data_range
    C1 = (K1 * R) ** 2
    C2 = (K2 * R) ** 2
    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux**2 + uy**2 + C1
    B2 = vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    return S[pad:-pad, pad:-pad].mean()


def ssim_metric(img_pred, img_gt, data_range=2.0):
    """Multichannel SSIM: per-channel mean (skimage multichannel=True)."""
    if img_pred.ndim == 2:
        return ssim_single(img_pred, img_gt, data_range)
    return np.mean(
        [
            ssim_single(img_pred[..., c], img_gt[..., c], data_range)
            for c in range(img_pred.shape[-1])
        ]
    )


class ImageEvaluator:
    """Accumulating evaluator; `summarize` writes metrics.npy to
    `result_dir` as the JAX evaluator does."""

    def __init__(self, result_dir: str):
        self.result_dir = result_dir
        self.mse = []
        self.psnr = []
        self.ssim = []

    def evaluate(self, rgb_pred, rgb_gt, mask_at_box, H, W, frame_index=0,
                 view_index=0):
        """rgb_pred/rgb_gt: (n_rays, 3) for the True entries of
        mask_at_box (flattened H*W bools). Writes
        comparison/frame<f:04d>_view<v:04d>.png and its _gt.png. Returns
        the item's metrics, or None for an all-black ground truth
        (skipped, as in JAX, before any write)."""
        if rgb_gt.sum() == 0:
            return None
        mse = float(np.mean((rgb_pred - rgb_gt) ** 2))
        psnr = float(psnr_metric(rgb_pred, rgb_gt))

        mab = mask_at_box.reshape(H, W)
        img_pred = np.zeros((H, W, 3))
        img_pred[mab] = rgb_pred
        img_gt = np.zeros((H, W, 3))
        img_gt[mab] = rgb_gt

        comp = os.path.join(self.result_dir, "comparison")
        os.makedirs(comp, exist_ok=True)
        base = f"{comp}/frame{frame_index:04d}_view{view_index:04d}"
        for path, img in ((f"{base}.png", img_pred), (f"{base}_gt.png", img_gt)):
            write_png(path, np.clip(img * 255, 0, 255).astype(np.uint8))

        # bbox crop before SSIM (if_nerf.py:51-56)
        ys, xs = np.where(mab)
        y0, y1 = ys.min(), ys.max() + 1
        x0, x1 = xs.min(), xs.max() + 1
        ssim = float(ssim_metric(img_pred[y0:y1, x0:x1], img_gt[y0:y1, x0:x1]))

        self.mse.append(mse)
        self.psnr.append(psnr)
        self.ssim.append(ssim)
        return {"mse": mse, "psnr": psnr, "ssim": ssim}

    def summarize(self):
        os.makedirs(self.result_dir, exist_ok=True)
        metrics = {"mse": self.mse, "psnr": self.psnr, "ssim": self.ssim}
        np.save(os.path.join(self.result_dir, "metrics.npy"), metrics)
        out = {
            k: float(np.mean(v)) if v else float("nan")
            for k, v in metrics.items()
        }
        print(f"the results are saved at {self.result_dir}")
        for k, v in out.items():
            print(f"{k}: {v}")
        self.mse, self.psnr, self.ssim = [], [], []
        return out
