"""PointNet++'s point operations in plain PyTorch, for the NHR baseline.

JAX counterpart: animatable_nerf_tpu/ops/pointnet2.py (XLA, not Pallas:
no kernel of the TPU lies here; reference lib/csrc/pointnet2's CUDA
extension). Layout channels-last, (B, N, C).

  furthest_point_sample: greedy max-min sampling seeded at index 0; the
    first maximum wins (torch.argmax, as jnp.argmax). On a cloud smaller
    than `npoint` it repeats index 0 once every distance is 0.
  ball_query: per centre, the first `nsample` points in input order with
    d2 < radius^2; a short ball is padded with its first index, an empty
    ball gives index 0.
  three_nn / three_interpolate: the 3 nearest known points (ties to the
    lower index) and their inverse-distance blend.

Squared distances between clouds take JAX's matmul form a^2 - 2ab + b^2
clamped at 0, so ball membership and the 3-NN choice are decided on the
same numbers; the squared norms are fused as XLA's CPU code fuses them
(`square_norm`). FPS takes its distances by differences, as JAX does, and
runs one step per point on the caller's device without a host sync: a
few small launches a step (5436 steps in an NHR forward at the default
sizes).
"""

from __future__ import annotations

import torch


def square_norm(x: torch.Tensor) -> torch.Tensor:
    """x0^2 + x1^2 + x2^2 of (..., 3) as XLA's CPU code computes it, each
    later square fused into the sum (two fused multiply-adds)."""
    x0, x1, x2 = x.unbind(-1)
    return torch.addcmul(torch.addcmul(x0 * x0, x1, x1), x2, x2)


def pairwise_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3), (..., M, 3) -> (..., N, M) squared distances in the
    matmul form, clamped at 0 (JAX `_pairwise_d2`, :38). Where a point
    of one cloud is a point of the other, the form leaves a rounding
    residue instead of 0, which the 3-NN weights amplify. So the dot
    products are two fused multiply-adds in coordinate order, as XLA's
    CPU matmul forms them at 16 columns and more (and torch's CPU
    matmul), and the squared norms are fused as XLA fuses them: the
    residue is JAX's, and it is the same on every device (a GPU's GEMM
    may order its sums otherwise)."""
    a2 = square_norm(a)[..., None]
    b2 = square_norm(b)
    A, B = a[..., :, None, :], b[..., None, :, :]
    ab = torch.addcmul(torch.addcmul(A[..., 0] * B[..., 0], A[..., 1], B[..., 1]),
                       A[..., 2], B[..., 2])
    d2 = a2 - 2.0 * ab + b2[..., None, :]
    return torch.clamp(d2, min=0.0)


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) -> (B, npoint) int64 indices (JAX :46-67)."""
    B, N, _ = xyz.shape
    mind2 = torch.full((B, N), float("inf"), dtype=xyz.dtype,
                       device=xyz.device)
    picks = [torch.zeros(B, 1, dtype=torch.long, device=xyz.device)]
    for _ in range(1, npoint):
        d = xyz - torch.gather(xyz, 1, picks[-1][..., None].expand(B, 1, 3))
        torch.minimum(mind2, square_norm(d), out=mind2)
        picks.append(torch.argmax(mind2, dim=1, keepdim=True))
    return torch.cat(picks, dim=1)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, S) -> (B, S, C)."""
    B, _, C = points.shape
    return torch.gather(points, 1, idx[..., None].expand(B, idx.shape[1], C))


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, S, nsample) -> (B, S, nsample, C)."""
    B, S, K = idx.shape
    return gather_points(points, idx.reshape(B, S * K)).reshape(B, S, K, -1)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """xyz (B, N, 3), new_xyz (B, S, 3) -> (B, S, nsample) int64 (JAX
    :75-96): the in-ball points rank first by index, then the others by
    index; the picks outside the ball take the first pick if it is in
    the ball, else 0."""
    N = xyz.shape[1]
    inball = pairwise_d2(new_xyz, xyz) < radius * radius
    col = torch.arange(N, device=xyz.device)
    score = torch.where(inball, col, col + N)
    idx = torch.topk(score, nsample, dim=-1, largest=False, sorted=True).indices
    picked = torch.gather(inball, -1, idx)
    fill = torch.where(picked[..., :1], idx[..., :1], torch.zeros_like(idx[..., :1]))
    return torch.where(picked, idx, fill)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """unknown (B, n, 3), known (B, m, 3) -> (dist (B, n, 3), idx (B, n,
    3)): the three smallest squared distances, ties to the lower index
    (a stable sort, as XLA's top_k), and their square roots (JAX
    :104-114)."""
    d2, idx = torch.sort(pairwise_d2(unknown, known), dim=-1, stable=True)
    return torch.sqrt(d2[..., :3]), idx[..., :3]


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """points (B, m, C), idx (B, n, 3), weight (B, n, 3) -> (B, n, C)
    (JAX :117, einsum 'bnkc,bnk->bnc')."""
    g = group_points(points, idx)
    return torch.einsum("bnkc,bnk->bnc", g, weight)


def interpolation_weights(dist: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights from three_nn's distances (JAX :123)."""
    recip = 1.0 / (dist + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)
