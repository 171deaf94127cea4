"""The closest point on a triangle mesh, in PyTorch, on the card by
default.

JAX counterpart: animatable_nerf_tpu/smpl/point_mesh.py:1-149
(`_closest_on_tri` :24, `_closest_point_jit` :102,
`closest_point_on_mesh` :135), which replaces the psbody / CGAL queries
of the reference's blend-weight prep (prepare_blend_weights.py:195-203,
268-274). JAX runs it in XLA, outside any Pallas kernel, so this is plain
PyTorch: Ericson's region test over (chunk of points) x (all faces),
each pair's squared distance, and the argmin over the faces, which takes
the lowest face of a tie as jnp.argmin does. The closest point and the
barycentric coordinates are then computed again for the chosen face
alone, by the same elementwise operations, so the (chunk, faces) grid
holds only what the distances need.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import select_device

# points a chunk: the (chunk, faces) temporaries of one chunk peak at
# about 3.6 GiB at SMPL's 13,776 faces (chip_smoke.py phase 22, H100)
CHUNK = 2048


def _where(cond, x):
    return torch.where(cond, 1.0, x)


def _closest_on_tri(p, a, b, c):
    """The barycentric coordinates (u, v, w), each (...,), of the closest
    point u a + v b + w c on triangle abc to p; p, a, b, c (..., 3)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = torch.sum(ab * ap, -1)
    d2 = torch.sum(ac * ap, -1)
    bp = p - b
    d3 = torch.sum(ab * bp, -1)
    d4 = torch.sum(ac * bp, -1)
    cp = p - c
    d5 = torch.sum(ab * cp, -1)
    d6 = torch.sum(ac * cp, -1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom_sum = va + vb + vc
    v_face = vb / _where(denom_sum == 0, denom_sum)
    w_face = vc / _where(denom_sum == 0, denom_sum)
    t_ab = torch.clamp(d1 / _where(d1 - d3 == 0, d1 - d3), 0.0, 1.0)
    t_ac = torch.clamp(d2 / _where(d2 - d6 == 0, d2 - d6), 0.0, 1.0)
    bc = (d4 - d3) + (d5 - d6)
    t_bc = torch.clamp((d4 - d3) / _where(bc == 0, bc), 0.0, 1.0)

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (~in_a) & (~in_b) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (~in_a) & (~in_c) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = ((~in_b) & (~in_c) & (va <= 0) & ((d4 - d3) >= 0)
             & ((d5 - d6) >= 0))

    one, zero = torch.ones_like(d1), torch.zeros_like(d1)
    face = ~(in_a | in_b | in_c | on_ab | on_ac | on_bc)
    u = torch.where(face, 1.0 - v_face - w_face, one)
    v = torch.where(face, v_face, zero)
    w = torch.where(face, w_face, zero)
    v = torch.where(on_ab, t_ab, v)
    u = torch.where(on_ab, 1.0 - t_ab, u)
    w = torch.where(on_ab, zero, w)
    w = torch.where(on_ac, t_ac, w)
    u = torch.where(on_ac, 1.0 - t_ac, u)
    v = torch.where(on_ac, zero, v)
    v = torch.where(on_bc, 1.0 - t_bc, v)
    w = torch.where(on_bc, t_bc, w)
    u = torch.where(on_bc, zero, u)
    u = torch.where(in_b, zero, u)
    v = torch.where(in_b, one, v)
    w = torch.where(in_b, zero, w)
    u = torch.where(in_c, zero, u)
    v = torch.where(in_c, zero, v)
    w = torch.where(in_c, one, w)
    return u, v, w


def _point(u, v, w, a, b, c):
    return u[..., None] * a + v[..., None] * b + w[..., None] * c


@torch.no_grad()
def closest_point_on_mesh(pts, verts, faces, chunk: int = CHUNK, device=None):
    """For each point (N, 3): the distance to the mesh verts (V, 3),
    faces (F, 3), the face it is nearest (the lowest of a tie), the
    closest point and its barycentric coordinates on that face. Runs on
    `device`, the card unless it says otherwise (it raises without one;
    device.py). Returns numpy {dist (N,), face (N,), point (N, 3),
    bary (N, 3)}."""
    dev = select_device(device)
    pts = torch.as_tensor(np.asarray(pts, np.float32), device=dev)
    verts = torch.as_tensor(np.asarray(verts, np.float32), device=dev)
    faces = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
    tri = verts[faces]  # (F, 3, 3)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    dist, fidx = [], []
    for s in range(0, pts.shape[0], chunk):
        p = pts[s:s + chunk, None, :]
        a1, b1, c1 = a[None], b[None], c[None]
        cp = _point(*_closest_on_tri(p, a1, b1, c1), a1, b1, c1)
        d2 = torch.sum((p - cp) ** 2, -1)  # (chunk, F)
        f = torch.argmin(d2, dim=1)
        dist.append(torch.sqrt(torch.gather(d2, 1, f[:, None])[:, 0]))
        fidx.append(f)
        del cp, d2
    dist, fidx = torch.cat(dist), torch.cat(fidx)
    a, b, c = a[fidx], b[fidx], c[fidx]
    u, v, w = _closest_on_tri(pts, a, b, c)
    return {"dist": dist.cpu().numpy(), "face": fidx.cpu().numpy(),
            "point": _point(u, v, w, a, b, c).cpu().numpy(),
            "bary": torch.stack([u, v, w], dim=-1).cpu().numpy()}
