"""Kernels K4, K5 and K6 (ops/knn.py) and the grids and tables they
serve, against the JAX package on the CPU: the plain versions against
the XLA twin (K4, which JAX runs off the TPU) and the Pallas kernels run
in interpret mode (K5, K6); the d5 grid, its upper bound, the Morton
blocks and the cell lists against JAX's.

Tolerances:
  * plain versions against JAX: rtol = atol = 1e-6, the same float32
    operations (K5 and K6 gather values by a one-hot matmul in JAX,
    by indexing here, so they may differ in the last bits);
  * the bf16 d5 grid: one bf16 ulp (2^-8 relative), since a torch node
    may differ from jnp.linspace's by a float32 ulp before rounding;
  * the upper bounds: 1e-6 on the same grid; certified against the exact
    5th distance within 1e-5, the reader's own slack;
  * Morton blocks and cell lists: exact (integer keys, stable sorts,
    copies of the inputs).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu.core.grid import (
    grid_corner_distance_upper as j_upper,
    pack_corner_volume as j_pack,
)
from animatable_nerf_tpu.models.common import grid_d5_upper as j_d5_upper
from animatable_nerf_tpu.ops import knn_pallas as jk

from animatable_nerf_tpu_torch.core.grid import (
    grid_corner_distance_upper,
    pack_corner_volume,
)
from animatable_nerf_tpu_torch.models.common import grid_d5_upper
from animatable_nerf_tpu_torch.ops import knn

TOL = dict(rtol=1e-6, atol=1e-6)
CELL_KEYS = ("cknn_verts", "cknn_vals", "cknn_lut", "cknn_bounds")


def cloud(n, m, c, seed, dup=0, scale=0.3):
    """Seeded gaussian vertices and queries; the last `dup` vertices are
    exact copies of vertex 0, and the first queries sit on vertex 0."""
    rng = np.random.RandomState(seed)
    ref = (rng.randn(m, 3) * scale).astype(np.float32)
    if dup:
        ref[-dup:] = ref[0]
    src = (rng.randn(n, 3) * (scale + 0.05)).astype(np.float32)
    if dup:
        src[:3] = ref[0]
    vals = rng.rand(m, c).astype(np.float32)
    return src, ref, vals / vals.sum(-1, keepdims=True)


def exact_d5(src, ref):
    d2 = ((src[:, None] - ref[None]) ** 2).sum(-1)
    return np.sqrt(np.sort(d2, axis=-1)[:, 4])


# M = k, duplicates counted with multiplicity, and an ordinary cloud
@pytest.mark.parametrize("n,m,dup", [(31, 5, 2), (64, 300, 3), (300, 97, 0)])
def test_kth_distance_plain_matches_jax(n, m, dup):
    src, ref, _ = cloud(n, m, 1, 1, dup)
    want = np.asarray(jk.kth_distance(jnp.asarray(src), jnp.asarray(ref)))
    got = knn.kth_distance_plain(torch.tensor(src), torch.tensor(ref), chunk=50)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if m == 5:  # the k-th of k vertices is the farthest
        far = np.sqrt(((src[:, None] - ref[None]) ** 2).sum(-1).max(-1))
        np.testing.assert_allclose(got.numpy(), far, **TOL)


def test_morton_key_matches_jax():
    q = np.random.RandomState(2).randint(0, 256, (500, 3)).astype(np.int32)
    want = np.asarray(jk._morton_key(jnp.asarray(q)))
    got = knn.morton_key(torch.tensor(q))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("m", [300, 700])  # not multiples of 128
def test_build_knn_blocks_matches_jax(m):
    _, ref, vals = cloud(1, m, 24, 3)
    want = jk.build_knn_blocks(jnp.asarray(ref), jnp.asarray(vals))
    got = knn.build_knn_blocks(torch.tensor(ref), torch.tensor(vals))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (-(-m // 128) * 128, 3)
    assert np.isfinite(got[2].numpy()).all()  # no block of pads alone


def test_d5_payload_matches_jax():
    _, ref, _ = cloud(1, 150, 1, 5)
    j_packed, j_bounds = jax.jit(functools.partial(jk.build_d5_payload, res=16))(
        jnp.asarray(ref))
    packed, bounds = knn.build_d5_payload(torch.tensor(ref), res=16)
    assert packed.dtype == torch.bfloat16 and packed.shape == (15, 15, 15, 8)
    np.testing.assert_array_equal(bounds.numpy(), np.asarray(j_bounds))
    np.testing.assert_allclose(packed.float().numpy(),
                               np.asarray(j_packed.astype(jnp.float32)),
                               rtol=2.0 ** -8, atol=0)


def test_corner_upper_bound_matches_jax():
    rng = np.random.RandomState(6)
    vol = rng.uniform(0, 1, (6, 7, 5, 1)).astype(np.float32)
    pts01 = rng.uniform(-0.2, 1.2, (400, 3)).astype(np.float32)
    cell = np.array([0.1, 0.07, 0.12], np.float32)
    want = j_upper(j_pack(jnp.asarray(vol)), jnp.asarray(pts01), jnp.asarray(cell))
    got = grid_corner_distance_upper(pack_corner_volume(torch.tensor(vol)),
                                     torch.tensor(pts01), torch.tensor(cell))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_grid_d5_upper_matches_jax_and_is_certified():
    """As tests/test_ops.py:293: the bound is >= the exact 5th distance
    everywhere, in and far out of the grid, and not uselessly loose."""
    rng = np.random.RandomState(5)
    ref = (rng.randn(150, 3) * 0.3).astype(np.float32)
    q = np.concatenate([rng.randn(3000, 3).astype(np.float32) * 0.45,
                        rng.randn(100, 3).astype(np.float32) * 2.0])
    j_packed, j_bounds = jax.jit(functools.partial(jk.build_d5_payload, res=16))(
        jnp.asarray(ref))
    want = np.asarray(j_d5_upper(jnp.asarray(q), {"d5_packed": j_packed,
                                                  "pdist_bounds": j_bounds}))
    # the same (JAX-built) grid through the port's reader
    same = {"d5_packed": torch.tensor(np.asarray(j_packed.astype(jnp.float32))
                                      ).to(torch.bfloat16),
            "pdist_bounds": torch.tensor(np.asarray(j_bounds))}
    np.testing.assert_allclose(grid_d5_upper(torch.tensor(q), same).numpy(),
                               want, **TOL)
    packed, bounds = knn.build_d5_payload(torch.tensor(ref), res=16)
    ub = grid_d5_upper(torch.tensor(q), {"d5_packed": packed,
                                         "pdist_bounds": bounds}).numpy()
    d5 = exact_d5(q, ref)
    assert (ub >= d5 - 1e-5).all(), np.max(d5 - ub)
    b = bounds.numpy()
    inb = ((q >= b[0]) & (q <= b[1])).all(-1)
    assert np.median(ub[inb] - d5[inb]) < 0.2


@pytest.mark.parametrize("radius", ["exact", "payload"])
def test_knn_blend_blocked_plain_matches_jax(radius):
    """tests/test_ops.py:323 and :371: the Pallas kernel in interpret mode
    with the exact 5th distance as the radius, and with the d5 grid's
    bound (what the engine uses)."""
    if radius == "exact":
        src, ref, vals = cloud(600, 700, 24, 7)
        d5ub = exact_d5(src, ref) + 1e-5
    else:
        src, ref, vals = cloud(500, 512, 24, 9, scale=0.3)
        packed, bounds = knn.build_d5_payload(torch.tensor(ref), res=12)
        d5ub = grid_d5_upper(torch.tensor(src), {"d5_packed": packed,
                                                 "pdist_bounds": bounds}).numpy()
    blocks = jk.build_knn_blocks(jnp.asarray(ref), jnp.asarray(vals))
    want_v, want_d = jk.knn_blend_blocked(jnp.asarray(src), jnp.asarray(d5ub),
                                          *blocks, interpret=True)
    t_blocks = knn.build_knn_blocks(torch.tensor(ref), torch.tensor(vals))
    got_v, got_d = knn.knn_blend_blocked_plain(torch.tensor(src),
                                               torch.tensor(d5ub), *t_blocks)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)
    # no ties in these clouds: the flat plain version's bits
    flat_v, flat_d = knn.knn_blend_plain(torch.tensor(src), torch.tensor(ref),
                                         torch.tensor(vals))
    assert torch.equal(got_v, flat_v) and torch.equal(got_d, flat_d)
    # the cull table: one row per tile of 256 queries, one column per block
    _, _, meta, bb = knn.blocked_tiles(torch.tensor(src), torch.tensor(d5ub),
                                       t_blocks[2])
    assert knn.blocked_cull(meta, bb).shape == (-(-len(src) // 256), len(bb))


def shell_case():
    """tests/test_ops.py:401's case: vertices on a sphere, queries around
    them, 16 far outside the grid, and a coincident-vertex tie."""
    rng = np.random.RandomState(0)
    m, n = 800, 4096
    verts = rng.randn(m, 3).astype(np.float32)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    verts *= 0.5
    vals = rng.rand(m, 24).astype(np.float32)
    vals /= vals.sum(-1, keepdims=True)
    q = verts[rng.randint(0, m, n)] + rng.randn(n, 3).astype(np.float32) * 0.06
    q[:16] = 5.0
    verts[10] = verts[11]
    q[100] = verts[10] + 0.001
    return q, verts, vals


@pytest.fixture(scope="module")
def shell():
    q, verts, vals = shell_case()
    j_payload, j_ovf = jax.jit(lambda v, w: jk.build_cell_knn(
        v, w, res=(8, 8, 8), cap=800, slot_cap=512))(jnp.asarray(verts),
                                                      jnp.asarray(vals))
    payload, ovf = knn.build_cell_knn(torch.tensor(verts), torch.tensor(vals),
                                      res=(8, 8, 8), cap=800, slot_cap=512)
    return {"q": q, "verts": verts, "vals": vals, "j_payload": j_payload,
            "j_ovf": j_ovf, "payload": payload, "ovf": ovf}


def test_build_cell_knn_matches_jax(shell):
    assert not bool(shell["j_ovf"]) and not bool(shell["ovf"])
    for key in CELL_KEYS:
        np.testing.assert_array_equal(shell["payload"][key].numpy(),
                                      np.asarray(shell["j_payload"][key]), key)
    assert shell["payload"]["cknn_lut"].dtype == torch.int32


def test_build_cell_knn_overflow_matches_jax():
    """tests/test_ops.py:450: a dense blob overflows cap 64 and slot_cap 8."""
    rng = np.random.RandomState(1)
    verts = (rng.randn(500, 3) * 0.05).astype(np.float32)
    vals = rng.rand(500, 24).astype(np.float32)
    j_payload, j_ovf = jax.jit(lambda v, w: jk.build_cell_knn(
        v, w, res=(6, 6, 6), cap=64, slot_cap=8))(jnp.asarray(verts),
                                                  jnp.asarray(vals))
    payload, ovf = knn.build_cell_knn(torch.tensor(verts), torch.tensor(vals),
                                      res=(6, 6, 6), cap=64, slot_cap=8)
    assert bool(j_ovf) and bool(ovf)
    for key in CELL_KEYS:
        np.testing.assert_array_equal(payload[key].numpy(),
                                      np.asarray(j_payload[key]), key)


def test_knn_blend_celled_plain_matches_jax(shell):
    """tests/test_ops.py:401: equal to the flat K2 on every row that can
    pass the 0.1 filter, conservative elsewhere, a valid simplex
    everywhere; and the Pallas kernel's numbers."""
    q = shell["q"]
    want_v, want_d = jk.knn_blend_celled(
        jnp.asarray(q), *(shell["j_payload"][key] for key in CELL_KEYS),
        interpret=True)
    got_v, got_d = knn.knn_blend_celled_plain(
        torch.tensor(q), *(shell["payload"][key] for key in CELL_KEYS))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)
    flat_v, flat_d = knn.knn_blend_plain(torch.tensor(q),
                                         torch.tensor(shell["verts"]),
                                         torch.tensor(shell["vals"]))
    got_v, got_d, flat_v, flat_d = map(np.asarray, (got_v, got_d, flat_v, flat_d))
    keep = flat_d[:, 0] < 0.1
    assert keep.sum() > 1000
    np.testing.assert_array_equal(got_v[keep], flat_v[keep])
    np.testing.assert_array_equal(got_d[keep], flat_d[keep])
    assert float((got_d[~keep] - flat_d[~keep]).min()) >= 0.0
    assert np.isfinite(got_v).all() and np.isfinite(got_d).all()
    np.testing.assert_allclose(got_v.sum(-1), 1.0, atol=1e-4)


@pytest.mark.parametrize("n", [4096, 1001])
def test_celled_routing_covers_each_query_once(shell, n):
    """The CUDA path's routing, checked here on all of the queries and
    on a ragged prefix: each tile lies in one slot's run of the
    slot-sorted queries, holds at most CELLED_TILE of them, and the tiles
    cover every query once."""
    payload = shell["payload"]
    slot = knn.cell_slots(torch.tensor(shell["q"][:n]), payload["cknn_lut"],
                          payload["cknn_bounds"])
    sorted_slot = slot[torch.argsort(slot, stable=True)]
    tiles = knn.celled_tiles(slot, payload["cknn_verts"].shape[0])
    covered = torch.zeros(len(slot), dtype=torch.int64)
    for s, begin, rows in tiles.tolist():
        assert 0 <= rows <= knn.CELLED_TILE
        assert bool((sorted_slot[begin:begin + rows] == s).all())
        covered[begin:begin + rows] += 1
    assert bool((covered == 1).all())
    assert int((slot == payload["cknn_verts"].shape[0] - 1).sum()) >= 16


def test_cull_wrappers_take_the_plain_version_on_the_cpu(shell):
    src, ref, vals = (torch.tensor(a) for a in cloud(300, 200, 24, 4))
    blocks = knn.build_knn_blocks(ref, vals)
    d5ub = torch.tensor(exact_d5(src.numpy(), ref.numpy()) + 1e-5)
    lists = [shell["payload"][key] for key in CELL_KEYS]
    q = torch.tensor(shell["q"][:500])
    counts = (knn.kth_distance.launches, knn.knn_blend_blocked.launches,
              knn.knn_blend_celled.launches)
    assert torch.equal(knn.kth_distance(src, ref),
                       knn.kth_distance_plain(src, ref))
    for got, want in zip(knn.knn_blend_blocked(src, d5ub, *blocks),
                         knn.knn_blend_blocked_plain(src, d5ub, *blocks)):
        assert torch.equal(got, want)
    for got, want in zip(knn.knn_blend_celled(q, *lists),
                         knn.knn_blend_celled_plain(q, *lists)):
        assert torch.equal(got, want)
    assert counts == (knn.kth_distance.launches, knn.knn_blend_blocked.launches,
                      knn.knn_blend_celled.launches)
    assert knn.kth_distance(src[:0], ref).shape == (0,)
    assert knn.knn_blend_blocked(src[:0], d5ub[:0], *blocks)[0].shape == (0, 24)
    assert knn.knn_blend_celled(q[:0], *lists)[1].shape == (0, 1)
    with pytest.raises(ValueError, match="k=5"):
        knn.kth_distance(src, ref[:4])
    with pytest.raises(ValueError):
        knn.kth_distance(src.double(), ref)
    with pytest.raises(ValueError):
        knn.knn_blend_blocked(src, d5ub[:10], *blocks)
    with pytest.raises(ValueError, match="whole blocks"):
        knn.knn_blend_blocked(src, d5ub, blocks[0][:201], blocks[1][:201],
                              blocks[2])
    with pytest.raises(ValueError):
        knn.knn_blend_celled(q, *lists[:2], lists[2].long(), lists[3])
    with pytest.raises(ValueError):
        knn.knn_blend_celled(q.double(), *lists)
    # fewer vertices (200) than list entries: every list ends in pads
    few, _ = knn.build_cell_knn(ref, vals, res=(8, 8, 8), cap=256)
    assert few["cknn_verts"].shape == (513, 3, 256)
    assert bool((few["cknn_verts"][:, :, 200:] == 1e6).all())
    assert bool((few["cknn_vals"][:, 200:] == 0).all())
    with pytest.raises(ValueError, match="pad >= th"):
        knn.build_cell_knn(ref, vals, pad=0.05)
    with pytest.raises(ValueError, match="slot_cap"):
        knn.build_cell_knn(ref, vals, res=(4, 4, 4), slot_cap=512)
