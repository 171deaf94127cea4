"""The evaluation options on the CPU, against the JAX package on the same
weights and the same rays (64 rays of 16 samples of test item 0), JAX
through its plain XLA path as its own tests run it:

  * `sample_pdf`, the deterministic inverse-CDF draw of hierarchical
    importance sampling, against JAX's, a ray of all-zero weights
    included;
  * the importance render (`use_importance`, N_importance 8) of
    AniNeRF, SDF-PDF and NeuS-PDF tiles against JAX `render_rays` with
    n_importance: the coarse pass's alpha on the (R, S) grid, the fine
    z drawn from its weights, the fine pass on the sorted union;
  * AniNeRF's slab pre-filter (`slab_filter` 4): its helpers (the
    occupied supercell boxes, the rays' slab spans, the kept segments)
    and its tile against JAX's `_eval_slab`, plain, with a box list
    that overflows (`slab_box_capacity 1`), through the novel-pose field
    and on a tile whose rays meet no box; and against the port's own
    flat tile (a list of BOXES boxes: the synthetic subject's 1,412
    occupied supercells overflow the default 1,024);
  * the config rules: `compute_dtype float16` raises, `seg_filter` and
    `slab_filter` off AniNeRF change nothing, `use_importance` does not
    change a train step.

Tolerances:
  * sample_pdf: within SAMPLE_TOL = 1e-5 of the rays' z range (float32
    sums in other orders move a CDF entry by an ulp); the last sample
    of a ray whose last weight is 0 at either end of that empty bin
    (see the test). Measured: within 2.4e-7 but for such last samples.
  * The slab helpers: the boxes within BOX_TOL = 1e-6 of JAX's (XLA
    may fuse the corner's multiply and add; the boxes are grown by 1e-4
    against such rounding); the spans and kept segments from the same
    boxes equal JAX's to the bit.
  * A tile's maps (AniNeRF's slab tile, the importance renders): within
    MAP_TOL = 1e-4 on all but 0.1% of the values and MAP_MAX = 5e-4 on
    every value, depth relative to its largest value, as
    tests/test_torch_pdf_families.py holds a flat tile (an 8x256 MLP
    summed in another order). The importance renders add the fine z:
    sample_pdf reads the coarse weights, which JAX's NeuS-PDF forms
    from sdf - 10 + 10 (about 1e-6 off the sdf), so a fine sample moves
    by a few ulps of z. JAX rebuilds the slab candidates' points from
    the ray origins, the port gathers the tile's own points. Measured:
    the slab tiles within 1.1e-5 (the novel pose; 1.1e-6 otherwise),
    the importance renders within 3.1e-6 (NeuS-PDF's depth).
  * The slab tile against the port's flat tile: rtol 1e-4, atol 1e-5,
    JAX's own bound (tests/test_render.py:364-366). Measured: equal to
    the bit where the tile has survivors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.core.composite import sample_pdf as j_sample_pdf
from animatable_nerf_tpu.core.lbs import (
    world_dirs_to_pose_dirs as j_world_dirs_to_pose_dirs,
    world_points_to_pose_points as j_world_points_to_pose_points,
)
from animatable_nerf_tpu.models import common as j_common
from animatable_nerf_tpu.render.renderer import (
    RenderSettings as JRenderSettings,
    render_rays as j_render_rays,
)

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.core.composite import sample_pdf
from animatable_nerf_tpu_torch.core.lbs import (
    world_dirs_to_pose_dirs,
    world_points_to_pose_points,
)
from animatable_nerf_tpu_torch.core.sampling import stratified_z_vals, z_vals_to_pts
from animatable_nerf_tpu_torch.models import common
from animatable_nerf_tpu_torch.models.aninerf import AniNeRF
from animatable_nerf_tpu_torch.render.renderer import RenderSettings, render_rays
from animatable_nerf_tpu_torch.train.trainer import Trainer, collate_rays, stack_batch

TILE_RAYS = 64
N_SAMPLES = 16
N_IMPORTANCE = 8
SLAB = 4
# the synthetic subject at its norm_th 0.25 has 1,412 occupied
# supercells, more than the default list of 1,024 holds
BOXES = 2048
GRID = ["knn_grid_res", "16"]
SAMPLE_TOL = 1e-5
MAP_TOL = 1e-4
MAP_MAX = 5e-4
OUTLIER_SHARE = 1e-3
BOX_TOL = 1e-6
SLAB_RTOL = 1e-4
SLAB_ATOL = 1e-5
ANINERF = ("configs/synthetic.yaml", "data/trained_model/deform/synthetic")
NOVEL_POSE = ("configs/synthetic_novel_pose.yaml",
              "data/trained_model/deform/synthetic_2f_anim")
IMPORTANCE = {
    "aninerf": ANINERF,
    "sdf_pdf": ("configs/synthetic_sdf_pdf.yaml",
                "data/trained_model/deform/synthetic_sdf_pdf"),
    "neus_pdf": ("configs/synthetic_neus_pdf.yaml",
                 "data/trained_model/deform/synthetic_neus_pdf"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Beside the suite's other workers, torch's intra-op threads would
    oversubscribe the cores; module-scoped, so the module fixtures'
    torch work runs on one thread too (tests/test_torch_mesh.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def as_flax(tree):
    """A param tree as flax holds it: every `layers` that a msgpack file
    keys "0", "1", ... a list."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if (k == "layers" and isinstance(v, dict)
                and sorted(v) == sorted(map(str, range(len(v))))):
            v = [v[str(i)] for i in range(len(v))]
        out[k] = [as_flax(x) for x in v] if isinstance(v, list) else as_flax(v)
    return out


class Case:
    """One config in both packages: JAX's engine, frame of test item 0
    and model (every point within its capacities), the port's engine
    and frame on the same weights, and a tile of the item's rays."""

    def __init__(self, cfg_ckpt, opts=(), jax_model=None):
        cfg, ckpt = cfg_ckpt
        opts = list(opts)
        jc = j_load_config(cfg, opts, run_type="evaluate")
        tc = load_config(cfg, opts, run_type="evaluate")
        jc.eval = tc.eval = True
        j_eng = j_engine.Engine(jc)
        j_item = j_engine.make_dataset(jc, "test")[0]
        self.j_frame = j_eng._device_frame(j_item)
        self.params = as_flax(read_checkpoint(ckpt + "/latest.flax")["params"])
        self.jm = j_eng.model.clone(eval_keep_frac=1.0, **(jax_model or {}))
        self.eng = t_engine.Engine(tc, "cpu")
        self.eng.load_params(self.params)
        self.frame = self.eng._device_frame(
            t_engine.make_dataset(tc, "test")[0])
        self.rays = {k: np.asarray(j_item[k], np.float32)[::7][:TILE_RAYS]
                     for k in ("ray_o", "ray_d", "near", "far")}

    def tile(self, shift=0.0):
        """(wpts, viewdir, z_vals) of the tile, its origins moved by
        `shift` (3,) in world metres."""
        ray_o = torch.tensor(self.rays["ray_o"] + np.float32(shift))
        z = stratified_z_vals(torch.tensor(self.rays["near"]),
                              torch.tensor(self.rays["far"]), N_SAMPLES)
        viewdir = torch.tensor(self.rays["ray_d"])
        return z_vals_to_pts(ray_o, viewdir, z), viewdir, z


_CASES = {}


def case(name):
    """The module's cases, built once each."""
    if name not in _CASES:
        slab = ["slab_filter", str(SLAB), "slab_box_capacity", str(BOXES)]
        jslab = {"slab_filter": SLAB, "slab_box_capacity": BOXES}
        _CASES[name] = {
            "slab": lambda: Case(ANINERF, slab, jslab),
            "slab_cap1": lambda: Case(
                ANINERF, slab + ["slab_box_capacity", "1"],
                {**jslab, "slab_box_capacity": 1}),
            "slab_novel_pose": lambda: Case(
                NOVEL_POSE, slab + ["test_novel_pose", "True", "exp_name",
                                    "synthetic_2f_anim"], jslab),
            "flat": lambda: Case(ANINERF),
            **{f"importance_{f}": (lambda f=f: Case(
                IMPORTANCE[f], GRID + ["use_importance", "True",
                                       "N_importance", str(N_IMPORTANCE)]))
               for f in IMPORTANCE},
        }[name]()
    return _CASES[name]


def assert_maps_match(ref, got):
    for k in ("rgb_map", "acc_map", "depth_map"):
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), k
        diff = np.abs(g - r) / (1.0 if k != "depth_map" else max(1.0, np.abs(r).max()))
        assert diff.max() <= MAP_MAX, (k, diff.max())
        assert (diff > MAP_TOL).mean() <= OUTLIER_SHARE, (k, (diff > MAP_TOL).sum())


# ---------------------------------------------------------- sample_pdf

@pytest.mark.parametrize("seed", [0, 1])
def test_sample_pdf_matches_jax(seed):
    """Random bins and weights, sparse ones, and a ray of all-zero
    weights, whose 1e-5 floor spreads its samples evenly. The last
    sample (u = 1) of a ray whose last weight is 0 may sit at either end
    of that empty bin: where the CDF's last entry rounds to 1 or just
    below or above it (the two frameworks sum the weights in other
    orders) the inverse CDF jumps across the bin."""
    rng = np.random.default_rng(seed)
    n_rays, n_bins = 64, N_SAMPLES - 1
    bins = np.sort(rng.uniform(1.0, 4.0, (n_rays, n_bins)), -1).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, (n_rays, n_bins - 1)).astype(np.float32)
    weights[rng.uniform(size=weights.shape) < 0.6] = 0.0
    weights[0] = 0.0
    ref = np.asarray(jax.jit(
        lambda b, w: j_sample_pdf(b, w, N_IMPORTANCE, det=True))(bins, weights))
    got = sample_pdf(torch.tensor(bins), torch.tensor(weights),
                     N_IMPORTANCE).numpy()
    tol = SAMPLE_TOL * 3.0  # the bins span 3
    assert np.abs(got[:, :-1] - ref[:, :-1]).max() <= tol
    off = np.abs(got[:, -1] - ref[:, -1]) > tol
    jump = (weights[:, -1] == 0.0) & np.all(
        [(v >= bins[:, -2] - tol) & (v <= bins[:, -1] + tol)
         for v in (got[:, -1], ref[:, -1])], axis=0)
    assert (~off | jump).all()
    assert off.sum() <= 0.25 * n_rays
    # all-zero weights: every bin equally likely
    even = np.interp(np.linspace(0, 1, N_IMPORTANCE),
                     np.linspace(0, 1, n_bins), bins[0])
    assert np.abs(got[0] - even).max() <= tol
    assert (np.diff(got, axis=-1) >= 0).all()


# ------------------------------------------------------- slab helpers

@pytest.mark.parametrize("capacity", [BOXES, 3])
def test_slab_helpers_match_jax(capacity):
    """The occupied supercell boxes of the frame's distance volume, the
    tile's spans over them and its kept segments, against JAX's helpers
    (JAX's dead box slots left out); with capacity 3 the box list
    overflows."""
    c = case("flat")
    dist = np.asarray(c.j_frame["pbw"])[..., 24]
    bounds = np.asarray(c.j_frame["pbounds"])
    th = c.eng.model.norm_th
    j_lo, j_hi, j_ovf = jax.jit(lambda d, b: j_common.occupied_supercell_boxes(
        d, b, th, 4, capacity))(dist, bounds)
    lo, hi, ovf = common.occupied_supercell_boxes(
        torch.tensor(dist), torch.tensor(bounds), th, 4, capacity)
    n = lo.shape[0]
    assert ovf == bool(j_ovf[0]) == (capacity == 3) and 0 < n <= capacity
    # XLA may fuse bounds + index * cell into one multiply-add
    np.testing.assert_allclose(lo.numpy(), np.asarray(j_lo)[:n], rtol=0,
                               atol=BOX_TOL)
    np.testing.assert_allclose(hi.numpy(), np.asarray(j_hi)[:n], rtol=0,
                               atol=BOX_TOL)
    assert (np.asarray(j_lo)[n:] > np.asarray(j_hi)[n:]).all()
    # the spans and kept segments from JAX's boxes, to the bit
    lo = torch.tensor(np.asarray(j_lo)[:n])
    hi = torch.tensor(np.asarray(j_hi)[:n])

    wpts, viewdir, z = c.tile()
    ray_o = wpts[:, 0, :] - viewdir * z[:, :1]
    frame = c.frame
    pose_o = world_points_to_pose_points(ray_o, frame["R"], frame["Th"])
    pose_d = world_dirs_to_pose_dirs(viewdir, frame["R"])

    def jax_span(o, d, z_vals, lo_, hi_):
        jf = c.j_frame
        po = j_world_points_to_pose_points(o, jf["R"], jf["Th"])
        pd = j_world_dirs_to_pose_dirs(d, jf["R"])
        s_lo, s_hi = j_common.slab_span(po, pd, lo_, hi_)
        return po, s_lo, s_hi, j_common.slab_segment_keep(s_lo, s_hi, z_vals, SLAB)

    j_po, j_slo, j_shi, j_keep = jax.jit(jax_span)(
        ray_o.numpy(), viewdir.numpy(), z.numpy(), j_lo, j_hi)
    assert np.array_equal(pose_o.numpy(), np.asarray(j_po))
    span_lo, span_hi = common.slab_span(pose_o, pose_d, lo, hi)
    assert np.array_equal(span_lo.numpy(), np.asarray(j_slo))
    assert np.array_equal(span_hi.numpy(), np.asarray(j_shi))
    keep = common.slab_segment_keep(span_lo, span_hi, z, SLAB)
    assert np.array_equal(keep.numpy(), np.asarray(j_keep))
    assert int(keep.sum()) > 0


# ---------------------------------------------------------- slab tile

def slab_tile(name, shift=0.0):
    c = case(name)
    wpts, viewdir, z = c.tile(shift)
    novel = name == "slab_novel_pose"
    apply = jax.jit(lambda p, w, v, zz, f: c.jm.apply(
        p, w, v, zz, f, train=False, precomposite=True, analytic_z=True,
        novel_pose=novel))
    ref = apply(c.params, wpts.numpy(), viewdir.numpy(), z.numpy(), c.j_frame)
    assert not bool(np.asarray(ref["compact_overflow"]).any())
    got = c.eng.model(wpts, viewdir, z, c.frame, analytic_z=True)
    flat = c.eng.model(wpts, viewdir, z, c.frame)
    return c, ref, got, flat


@pytest.mark.parametrize("name,shift", [
    ("slab", 0.0), ("slab_cap1", 0.0), ("slab_novel_pose", 0.0),
    ("slab", (3.0, 0.0, 0.0)), ("slab", (3.0, 3.0, 3.0))],
    ids=["plain", "box_overflow", "novel_pose", "pruned", "no_segment"])
def test_slab_tile_matches_jax(name, shift):
    """The slab tile against JAX's `_eval_slab` render. On the body every
    segment of this coarse subject meets a box (its shell at norm_th
    0.25 is wide); with the box list overflowing every segment is a
    candidate; 3 away along x most segments miss every box; 3 away
    along each axis no ray meets one, so only the first segment is kept
    and its argmin forced, as in JAX, where the flat filter forces the
    tile's argmin. JAX's count is the larger of its pass-1 candidates
    and a third of its kept segments' samples."""
    c, ref, got, flat = slab_tile(name, shift)
    assert_maps_match(ref, got)
    n_pts = TILE_RAYS * N_SAMPLES
    slab_pts = got["n_slab_points"]
    assert int(np.asarray(ref["compact_count"]).sum()) in [
        max(n, (slab_pts + 2) // 3)
        for n in (got["n_candidates"], got["n_candidates"] - 1)]
    if name == "slab_cap1":
        assert slab_pts == n_pts
    elif shift == (3.0, 3.0, 3.0):
        assert slab_pts == SLAB
        assert got["n_candidates"] == got["n_survivors"] == 1
        assert float(got["acc_map"].max()) < 1e-3
    elif shift:
        assert SLAB < slab_pts < n_pts // 2
    else:
        assert got["n_survivors"] > 100
        assert float(got["acc_map"].max()) > 0.3
    if not shift:
        # the flat tile's survivors, so its maps
        assert got["n_survivors"] == flat["n_survivors"]
        assert got["n_candidates"] <= flat["n_candidates"]
        for k in ("rgb_map", "acc_map", "depth_map"):
            np.testing.assert_allclose(got[k].numpy(), flat[k].numpy(),
                                       rtol=SLAB_RTOL, atol=SLAB_ATOL)


def test_slab_needs_the_plain_grid_and_a_divisor():
    """The slab path runs only on the plain stratified grid
    (`analytic_z`) with `slab_filter` dividing N_samples and
    eval_keep_frac > 0, as JAX dispatches (aninerf.py:760-767)."""
    c = case("slab")
    wpts, viewdir, z = c.tile()
    model = c.eng.model
    assert "n_slab_points" in model(wpts, viewdir, z, c.frame, analytic_z=True)
    assert "n_slab_points" not in model(wpts, viewdir, z, c.frame)
    for attr, value in (("slab_filter", 3), ("eval_keep_frac", 0.0)):
        old = getattr(model, attr)
        setattr(model, attr, value)
        try:
            out = model(wpts, viewdir, z, c.frame, analytic_z=True)
        finally:
            setattr(model, attr, old)
        assert "n_slab_points" not in out


# ---------------------------------------------------- importance render

@pytest.mark.parametrize("family", sorted(IMPORTANCE))
def test_importance_render_matches_jax(family):
    """A tile rendered with N_importance fine samples against JAX
    render_rays with n_importance; the maps differ from the stratified
    render's."""
    c = case(f"importance_{family}")
    assert c.eng.settings.n_importance == N_IMPORTANCE
    js = JRenderSettings(n_samples=N_SAMPLES, perturb=False,
                         white_bkgd=c.eng.settings.white_bkgd,
                         eval_tile=TILE_RAYS, n_importance=N_IMPORTANCE)
    jrays = {k: jnp.asarray(v) for k, v in c.rays.items()}
    ref = jax.jit(lambda p, r, f: j_render_rays(
        c.jm, p, r, f, js, train=False))(c.params, jrays, c.j_frame)
    assert not bool(np.asarray(ref["compact_overflow"]).any())
    assert ref["z_vals"].shape == (TILE_RAYS, N_SAMPLES + N_IMPORTANCE)
    rays = {k: torch.tensor(v) for k, v in c.rays.items()}
    settings = c.eng.settings._replace(n_samples=N_SAMPLES)
    got = render_rays(c.eng.model, rays, c.frame, settings)
    assert_maps_match(ref, got)
    plain = render_rays(c.eng.model, rays, c.frame,
                        settings._replace(n_importance=0))
    assert got["n_survivors"] > plain["n_survivors"]
    assert float((got["rgb_map"] - plain["rgb_map"]).abs().max()) > 1e-3


# --------------------------------------------------------- config rules

def test_compute_dtype_float16_raises():
    cfg = load_config(ANINERF[0], ["compute_dtype", "float16"],
                      run_type="evaluate")
    with pytest.raises(ValueError, match="compute_dtype"):
        t_engine.make_model(cfg)


@pytest.mark.parametrize("opts", [["seg_filter", "4"], ["slab_filter", "8"]])
def test_filter_keys_off_aninerf_are_ignored(opts):
    """JAX's make_model passes slab_filter to AniNeRF alone and
    seg_filter to no model: an SDF-PDF model built with either has the
    plain one's attributes, and AniNeRF reads no seg_filter."""
    plain = t_engine.make_model(load_config(IMPORTANCE["sdf_pdf"][0], []))
    model = t_engine.make_model(load_config(IMPORTANCE["sdf_pdf"][0], opts))
    assert vars(model).keys() == vars(plain).keys()
    assert not hasattr(model, "slab_filter") and not hasattr(model, "seg_filter")
    ani = t_engine.make_model(load_config(ANINERF[0], opts))
    assert isinstance(ani, AniNeRF) and not hasattr(ani, "seg_filter")
    assert ani.slab_filter == (8 if opts[0] == "slab_filter" else 0)


def test_use_importance_does_not_change_a_train_step():
    """Training ignores use_importance, as JAX's Trainer does: the same
    settings and the same loss on the same batch and weights."""
    base = ["N_rand", "64", "N_samples", str(N_SAMPLES), "perturb", "0"]
    losses = []
    for opts in (base, base + ["use_importance", "True"]):
        cfg = load_config(ANINERF[0], opts)
        model = t_engine.make_model(cfg)
        model.load_state_dict(case("flat").eng.model.state_dict())
        trainer = Trainer(cfg, model, "cpu")
        assert trainer.settings.n_importance == 0
        ds = t_engine.make_dataset(cfg, "train")
        ds._rng = np.random.RandomState(0)
        batch = stack_batch([collate_rays(ds[0], 64)])
        losses.append(trainer.train_step(batch)["loss"])
    assert losses[0] == losses[1]
