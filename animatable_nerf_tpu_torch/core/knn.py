"""K-nearest-vertex blend weights over the SMPL vertices.

JAX counterpart: animatable_nerf_tpu/core/knn.py:37
`sample_blend_closest_points` (reference lib/utils/sample_utils.py:
309-348): K=5 nearest vertices, inverse-distance weights 1/(d + exp),
the weighted blend of the vertices' values and the weighted distance.
This is the contract kernel K2 serves. The JAX module computes it in the
matmul form |s|^2 - 2 s.r + |r|^2 with top_k; the port computes it by
direct differences on both devices (ops/knn.py: the kernel on the card,
its plain version on the CPU), as the JAX package's Pallas kernel does.
Where autograd needs a gradient of an input (the aligned families'
canonical prior at the warped points, JAX models/aligned.py:425-430),
the call takes K2's differentiable form: the same launch with its
selection, and the vjp of the blend over those k vertices.
"""

from __future__ import annotations

import torch

from ..ops.knn import knn_blend, knn_blend_differentiable


def sample_blend_closest_points(src, ref, values, k: int = 5,
                                exp: float = 1e-8):
    """src (N, 3) query points, ref (M, 3) vertices, values (M, C) ->
    (sampled (N, C), dists (N, 1))."""
    args = (src.contiguous(), ref.contiguous(), values.contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return knn_blend_differentiable(*args, k=k, eps=exp)
    return knn_blend(*args, k=k, eps=exp)
