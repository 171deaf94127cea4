"""K-nearest-vertex blend weights over the SMPL vertices.

JAX counterpart: animatable_nerf_tpu/core/knn.py:37
`sample_blend_closest_points` (reference lib/utils/sample_utils.py:
309-348): K=5 nearest vertices, inverse-distance weights 1/(d + exp),
the weighted blend of the vertices' values and the weighted distance.
This is the contract kernel K2 serves. The JAX module computes it in the
matmul form |s|^2 - 2 s.r + |r|^2 with top_k; the port computes it by
direct differences on both devices (ops/knn.py: the kernel on the card,
its plain version on the CPU), as the JAX package's Pallas kernel does.
"""

from __future__ import annotations

from ..ops.knn import knn_blend


def sample_blend_closest_points(src, ref, values, k: int = 5,
                                exp: float = 1e-8):
    """src (N, 3) query points, ref (M, 3) vertices, values (M, C) ->
    (sampled (N, C), dists (N, 1))."""
    return knn_blend(src.contiguous(), ref.contiguous(), values.contiguous(),
                     k=k, eps=exp)
