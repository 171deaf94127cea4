"""The NHR and NT baselines' ops, modules, datasets and weights on the
CPU: the port against the JAX package on the same numpy-seeded inputs
and the same weights (crossed over by compat/jax_params.py), at JAX's
tiny widths (`TINY_PN`, `TINY_UNET` of tests/test_baselines.py), 32x32
images and a few hundred points, on a root written by JAX's
`generate_synthetic_dataset` (which also writes the baselines' files).

Tolerances:
  * Point ops: the squared distances are bit-equal to XLA's on the CPU
    (the matmul form with XLA's fused squared norms, ops/pointnet2.py),
    so FPS indices are equal; ball-query and 3-NN indices may differ only
    on a near-tie (a distance within one float32 rounding of the radius,
    or of another neighbour's), at most MAX_INDEX_TIES entries a call;
    grouped and interpolated features within FEAT_TOL = 1e-6.
  * The splat: the pixels whose winning point differs (a projection on
    a rounding boundary, a depth within z_eps of another), at most
    MAX_SPLAT_PIXELS of an image; every other pixel's features, depth
    and index equal; the features' gradient equal on the pixels both
    keep.
  * grid_bilerp: values within 1e-6; the gradient to the image and to
    the uv (jnp.clip's 0.5 on a bound) within 1e-6.
  * resize_linear: within 1e-6 of cv2.resize(INTER_LINEAR) on two-channel
    float32 uv maps (OpenCV's own loop; it hands 1, 3 and 4 channels to
    IPP, within 2.5e-6).
  * Modules at tiny widths (PointNet++ at TINY_PN16, see there; the UNet
    inside NT's and NHR's): forward
    within FWD_TOL = 1e-4 absolute; NHR's within the larger of FWD_TOL
    and twice what one ulp of the canonical vertices moves the port's own
    output (its 16 batch norms over a few points each double a rounding
    difference: 1e-6 after the first level, 2.3e-4 at the last, measured
    on this root, then the UNet), its gradient likewise, each under a
    fixed ceiling (CONTROL_FWD_CEIL = 1e-3, CONTROL_GRAD_CEIL = 2e-2); the
    gradient of a scalar loss as one vector within GRAD_REL = 1e-2 of its
    L2 norm. NHR's gradient differs from JAX's by 9.99e-3 of its L2 norm
    here, and that is JAX's float32 error: against the port's float64
    gradient, JAX's differs by 9.8e-3 and the port's float32 one by
    1.5e-4.
  * Weights: the codecs exact both ways at make_model's full widths.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu.baselines import NHR as JNHR
from animatable_nerf_tpu.baselines import NT as JNT
from animatable_nerf_tpu.baselines import PointNet2MSG as JPointNet2MSG
from animatable_nerf_tpu.baselines import UNet as JUNet
from animatable_nerf_tpu.baselines.unet import upsample2x_align_corners as j_up
from animatable_nerf_tpu.compat.torch_import import convert_nhr, convert_nt
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.core.grid import grid_bilerp as j_grid_bilerp
from animatable_nerf_tpu.data.baselines import NHRDataset as JNHRDataset
from animatable_nerf_tpu.data.baselines import NTDataset as JNTDataset
from animatable_nerf_tpu.data.synthetic import generate_synthetic_dataset
from animatable_nerf_tpu.ops import pointnet2 as jpn2
from animatable_nerf_tpu.ops.rasterize import rasterize_points as j_rasterize
from animatable_nerf_tpu.train.checkpoints import (
    load_checkpoint as j_load_checkpoint,
    save_checkpoint as j_save_checkpoint,
)

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch.baselines.nhr import NHR
from animatable_nerf_tpu_torch.baselines.nt import NT
from animatable_nerf_tpu_torch.baselines.pointnet2_msg import PointNet2MSG
from animatable_nerf_tpu_torch.baselines.unet import UNet, upsample2x_align_corners
from animatable_nerf_tpu_torch.compat.jax_params import (
    nhr_param_tree,
    nhr_state_dict,
    nt_param_tree,
    nt_state_dict,
    pointnet2_arrays,
    pointnet2_tree,
    to_tensors,
    unet_arrays,
)
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.core.grid import grid_bilerp
from animatable_nerf_tpu_torch.data.camera import resize_linear
from animatable_nerf_tpu_torch.data.decode_cache import write_archive
from animatable_nerf_tpu_torch.ops import pointnet2 as pn2
from animatable_nerf_tpu_torch.ops.rasterize import rasterize_points
from animatable_nerf_tpu_torch.train.checkpoints import (
    load_checkpoint,
    save_checkpoint,
)

TINY_PN = dict(
    npoints=(32, 16, 8, 4),
    radii=((0.2, 0.5), (0.5, 1.0), (1.0, 2.0), (2.0, 4.0)),
    nsamples=((4, 8),) * 4,
    mlps=(((8, 8), (8, 8)), ((8, 8), (8, 8)), ((16, 16), (16, 16)),
          ((16, 16), (16, 16))),
    fp_widths=(None, (16, 16), (32, 32), (32, 32)),
)
# TINY_PN with at least 16 points a level: at 8 columns and fewer, XLA's
# CPU matmul takes a narrow-dot path whose rounding differs from the one
# torch's CPU matmul shares with XLA's wider path, and where one cloud's
# point is the other's, the matmul-form distance is that rounding residue,
# which the 3-NN weights and the batch norms amplify. NHR's own levels
# (4096, 1024, 256, 64 points) never take it.
TINY_PN16 = dict(TINY_PN, npoints=(64, 32, 16, 16))
TINY_UNET = (4, 4, 8, 8, 8, 8, 8, 4, 4)
FEAT_TOL = 1e-6
MAX_INDEX_TIES = 2
MAX_SPLAT_PIXELS = 4
FWD_TOL = 1e-4
GRAD_REL = 1e-2
# the ceilings of NHR's bounds sized by its ulp control (`_held`): on this
# root the control moves the port's rgb by 2.9e-4 and its gradient by
# 1.1e-4 of its L2 norm
CONTROL_FWD_CEIL = 1e-3
CONTROL_GRAD_CEIL = 2e-2
IMAGE_SIZE = 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread beside the suite's other workers; module scope, so
    that it holds before the module-scoped fixtures."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A root of JAX's generator (2 frames, 2 views, 300 vertices, 32x32),
    with the baselines' files, and its decoded.npz for the port."""
    path = str(tmp_path_factory.mktemp("baselines") / "human")
    generate_synthetic_dataset(path, n_frames=2, n_views=2,
                               image_size=IMAGE_SIZE, n_verts=300, n_blobs=64)
    write_archive(path)
    return path


def _opts(root, module):
    dataset = "lib.datasets.h36m." + module
    return ["train_dataset.data_root", root,
            "train_dataset.ann_file", os.path.join(root, "annots.npy"),
            "test_dataset.data_root", root,
            "test_dataset.ann_file", os.path.join(root, "annots.npy"),
            "train_dataset_module", dataset, "test_dataset_module", dataset,
            "training_view", "[0]", "test_view", "[1]", "num_train_frame", "2",
            "H", str(IMAGE_SIZE), "W", str(IMAGE_SIZE)]


def _items(root, module, split="test"):
    """Item 0 of each package's dataset for `module` (nhr, nt)."""
    cfg_file = f"configs/synthetic_{module}.yaml"
    jcls = JNHRDataset if module == "nhr" else JNTDataset
    jds = jcls(j_load_config(cfg_file, _opts(root, module)), split)
    ds = t_engine.make_dataset(load_config(cfg_file, _opts(root, module)), split)
    return jds[0], ds[0]


@pytest.fixture(scope="module")
def nhr_items(root):
    return _items(root, "nhr")


@pytest.fixture(scope="module")
def nt_items(root):
    return _items(root, "nt")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _count_differing(a, b):
    return int(np.sum(np.asarray(a) != np.asarray(b)))


# ------------------------------------------------------------- point ops
@pytest.mark.parametrize("n,npoint", [(128, 32), (500, 100), (300, 400)])
def test_furthest_point_sample_equals_jax(n, npoint):
    """Equal indices, including a cloud smaller than npoint (index 0
    repeated once every distance is 0)."""
    xyz = np.random.RandomState(n).randn(2, n, 3).astype(np.float32)
    want = np.asarray(jpn2.furthest_point_sample(jnp.asarray(xyz), npoint))
    got = pn2.furthest_point_sample(torch.from_numpy(xyz), npoint).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius,nsample", [(0.3, 8), (0.8, 16), (2.0, 32)])
def test_ball_query_and_group_equal_jax(radius, nsample):
    """Short balls (padded with their first index), full balls and empty
    ones (index 0); the grouped offsets within FEAT_TOL."""
    rng = np.random.RandomState(int(radius * 10))
    xyz = rng.randn(1, 400, 3).astype(np.float32)
    centres = np.concatenate([xyz[:, :60], rng.randn(1, 20, 3) * 3],
                             axis=1).astype(np.float32)
    want = np.asarray(jpn2.ball_query(radius, nsample, jnp.asarray(xyz),
                                      jnp.asarray(centres)))
    got = pn2.ball_query(radius, nsample, torch.from_numpy(xyz),
                         torch.from_numpy(centres)).numpy()
    assert _count_differing(got, want) <= MAX_INDEX_TIES
    same = (got == want).all(-1)
    jg = np.asarray(jpn2.group_points(jnp.asarray(xyz), jnp.asarray(want)))
    tg = pn2.group_points(torch.from_numpy(xyz), torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(tg[same], jg[same], atol=FEAT_TOL, rtol=0)
    assert (want == 0).all(-1).any()  # an empty ball was met


def test_three_nn_and_interpolate_equal_jax():
    """The unknown points include the known ones (FPS picks them from the
    cloud), where the matmul form leaves its rounding residue: the
    distances equal JAX's, so the weights do too."""
    rng = np.random.RandomState(7)
    xyz = rng.randn(1, 300, 3).astype(np.float32)
    known = xyz[:, ::5].copy()
    feats = rng.randn(1, known.shape[1], 6).astype(np.float32)
    jd, ji = jpn2.three_nn(jnp.asarray(xyz), jnp.asarray(known))
    td, ti = pn2.three_nn(torch.from_numpy(xyz), torch.from_numpy(known))
    assert _count_differing(ti.numpy(), ji) <= MAX_INDEX_TIES
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=FEAT_TOL, rtol=0)
    jw = jpn2.interpolation_weights(jd)
    tw = pn2.interpolation_weights(td)
    want = np.asarray(jpn2.three_interpolate(jnp.asarray(feats), ji, jw))
    got = pn2.three_interpolate(torch.from_numpy(feats), ti, tw).numpy()
    np.testing.assert_allclose(got, want, atol=FEAT_TOL, rtol=1e-6)


# ----------------------------------------------------------------- splat
def test_rasterize_points_equals_jax(nhr_items):
    """The generator's world vertices through a test camera at splat
    radius 2, with a point behind the camera and one off screen."""
    jitem, item = nhr_items
    K, RT = item["K"], item["RT"]
    rng = np.random.RandomState(3)
    pts = np.asarray(jitem["tpose"], np.float32)
    pts = np.concatenate([pts, [[0, 0, -10.0], [50.0, 0, 0]]]).astype(np.float32)
    feats = rng.randn(len(pts), 5).astype(np.float32)
    args = (K, RT[:, :3], RT[:, 3:])
    want = j_rasterize(jnp.asarray(pts), jnp.asarray(feats),
                       *map(jnp.asarray, args), IMAGE_SIZE, IMAGE_SIZE,
                       splat_radius=2)
    tp, tf = torch.from_numpy(pts), torch.from_numpy(feats).requires_grad_(True)
    got = rasterize_points(tp, tf, *map(torch.from_numpy, args), IMAGE_SIZE,
                           IMAGE_SIZE, splat_radius=2)
    differ = got["index"].numpy() != np.asarray(want["index"])
    assert differ.sum() <= MAX_SPLAT_PIXELS
    assert got["mask"].numpy().sum() > 100
    for key in ("feature_map", "depth", "mask"):
        np.testing.assert_array_equal(got[key].detach().numpy()[~differ],
                                      np.asarray(want[key])[~differ])
    # the gradient reaches the winners only: weight the pixels both keep
    w = rng.randn(IMAGE_SIZE, IMAGE_SIZE, 5).astype(np.float32) * ~differ[..., None]
    jg = jax.grad(lambda f: jnp.sum(j_rasterize(
        jnp.asarray(pts), f, *map(jnp.asarray, args), IMAGE_SIZE, IMAGE_SIZE,
        splat_radius=2)["feature_map"] * w))(jnp.asarray(feats))
    (got["feature_map"] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(tf.grad.numpy(), np.asarray(jg))


# ---------------------------------------------------------- grid, resize
def test_grid_bilerp_and_its_gradient_equal_jax():
    """Inside, on the bounds 0 and 1 (jnp.clip's half gradient) and
    outside them (clamped, no gradient to the uv)."""
    rng = np.random.RandomState(11)
    img = rng.randn(9, 13, 4).astype(np.float32)
    uv = np.concatenate([rng.rand(40, 2), [[0, 0], [1, 1], [0, 0.5], [1.0, 0.3],
                                           [-0.2, 1.4], [0.5, -3]]]
                        ).astype(np.float32)
    w = rng.randn(len(uv), 4).astype(np.float32)

    def j_loss(i, u):
        return jnp.sum(j_grid_bilerp(i, u) * w)

    want = np.asarray(j_grid_bilerp(jnp.asarray(img), jnp.asarray(uv)))
    jgi, jgu = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(uv))
    ti = torch.from_numpy(img).requires_grad_(True)
    tu = torch.from_numpy(uv).requires_grad_(True)
    got = grid_bilerp(ti, tu)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(jgi), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(jgu), atol=1e-6, rtol=0)
    g = tu.grad.numpy()
    assert (g[-2] == 0).all() and g[-1, 1] == 0 and g[-1, 0] != 0


@pytest.mark.parametrize("size", [(64, 64), (37, 53), (256, 256)])
def test_resize_linear_equals_cv2(size):
    """A uv map of the generator's form (two channels, zero off the body)
    at 2:1, at a non-integer factor and upsampled."""
    import cv2

    rng = np.random.RandomState(size[0])
    uv = rng.rand(128, 128, 2).astype(np.float32)
    uv[rng.rand(128, 128) < 0.6] = 0
    H, W = size
    want = cv2.resize(uv, (W, H), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(resize_linear(uv, H, W), want, atol=1e-6, rtol=0)


def test_upsample_equals_jax(monkeypatch):
    """The sample positions within one float32 rounding of jnp.linspace's
    (XLA rounds some a last bit apart); on jnp.linspace's own positions
    the values within 1e-6 (XLA fuses the lerp's multiply-adds)."""
    from animatable_nerf_tpu_torch.baselines import unet

    for n in (3, 8, 63, 125):
        want = np.asarray(jnp.linspace(0.0, n - 1.0, 2 * n))
        np.testing.assert_allclose(unet._linspace(n, "cpu").numpy(), want,
                                   rtol=float(np.finfo(np.float32).eps), atol=0)
    monkeypatch.setattr(unet, "_linspace", lambda n, device: torch.from_numpy(
        np.asarray(jnp.linspace(0.0, n - 1.0, 2 * n))))
    for n in (3, 63):
        x = np.random.RandomState(n).randn(1, 2, n, n + 1).astype(np.float32)
        want = np.asarray(j_up(jnp.asarray(x.transpose(0, 2, 3, 1))))
        got = upsample2x_align_corners(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=1e-6,
                                   rtol=0)


# ---------------------------------------------------------------- modules
def _tiny(module, size=IMAGE_SIZE):
    """(JAX model, a port model factory, frame keys, codecs) at tiny
    widths, NHR at images of size x size."""
    if module == "nhr":
        kw = dict(feature_dim=8, pointnet_kwargs=TINY_PN16, unet_widths=TINY_UNET)
        return (JNHR(H=size, W=size, **kw),
                lambda: NHR(size, size, **kw), NHR.frame_keys,
                nhr_state_dict, nhr_param_tree)
    kw = dict(size=16, feature_dim=4, unet_widths=TINY_UNET)
    return (JNT(**kw), lambda: NT(**kw), NT.frame_keys, nt_state_dict,
            nt_param_tree)


def _grad_rel(jgrads: dict, model) -> float:
    """L2 of (port - JAX) over the whole gradient / L2 of JAX's, by
    reference name (a parameter without a gradient counts as 0)."""
    num = den = 0.0
    for name, p in model.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        want = jgrads[name].detach().numpy()
        num += float(np.sum((g - want) ** 2))
        den += float(np.sum(want ** 2))
    return float(np.sqrt(num / den))


def _grads(model):
    return {name: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
            for name, p in model.named_parameters()}


def _held(jmodel, jparams, tmodel, to_state, jinputs, tinputs, outputs, loss,
          nudged=None):
    """Forward of both packages on the same weights, each output within
    FWD_TOL, and the gradient of `loss` within GRAD_REL. With `nudged`
    (the port's inputs one ulp away), an output may also differ from
    JAX's by up to twice what that ulp moves the port's own output, and
    the gradient by twice what it moves the port's own gradient: the part
    float32 cannot resolve; but never by more than CONTROL_FWD_CEIL and
    CONTROL_GRAD_CEIL."""
    tmodel.load_state_dict(to_state(jparams), strict=True)
    # the forward as JAX's engine compiles it, alone: compiled with its
    # gradient, XLA fuses the matmul-form distances otherwise
    jout = jax.jit(jmodel.apply)(jparams, *jinputs)
    jg = jax.jit(jax.grad(lambda p: loss(jmodel.apply(p, *jinputs))))(jparams)
    grad_tol, moved = GRAD_REL, None
    if nudged is not None:
        moved = tmodel(*nudged)
        loss(moved).backward()
        moved_grads = _grads(tmodel)
        tmodel.zero_grad(set_to_none=True)
    tout = tmodel(*tinputs)
    for key in outputs:
        tol = FWD_TOL
        if moved is not None:
            tol = max(tol, 2 * float((moved[key].float()
                                      - tout[key].float()).abs().max()))
            assert tol <= CONTROL_FWD_CEIL, (key, tol)
        np.testing.assert_allclose(tout[key].detach().numpy(),
                                   np.asarray(jout[key]), atol=tol, rtol=0,
                                   err_msg=key)
    loss(tout).backward()
    if moved is not None:
        grad_tol = max(grad_tol, 2 * _grad_rel(moved_grads, tmodel))
        assert grad_tol <= CONTROL_GRAD_CEIL, grad_tol
    assert _grad_rel(to_state(_np(jg)), tmodel) <= grad_tol


def _port_tree(to_tree, model):
    """A seeded port model's weights as the JAX tree (a copy), the
    weights both packages run on (tracing JAX's init costs as much as a
    compile)."""
    return jax.tree_util.tree_map(np.array, to_tree(dict(model.named_parameters())))


def _sq_loss(out):
    return sum((out[k] ** 2).mean() for k in ("rgb_map", "mask"))


def _dict_out(fn):
    class Wrap(torch.nn.Module):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, *a):
            return fn(self.m(*a))
    return Wrap


def test_pointnet2_msg_equals_jax():
    xyz = np.random.RandomState(2).randn(1, 200, 3).astype(np.float32)
    jnet = JPointNet2MSG(out_dim=8, **TINY_PN16)
    torch.manual_seed(2)
    jp = _port_tree(lambda named: {"params": pointnet2_tree(named, "")},
                    PointNet2MSG(out_dim=8, **TINY_PN16))

    class JWrap:
        @staticmethod
        def apply(p, x):
            return {"f": jnet.apply(p, x)}

    tnet = _dict_out(lambda o: {"f": o})(PointNet2MSG(out_dim=8, **TINY_PN16))
    _held(JWrap, jp, tnet, lambda t: {f"m.{k}": v for k, v in to_tensors(
        pointnet2_arrays(t["params"], "")).items()},
        (jnp.asarray(xyz),), (torch.from_numpy(xyz),), ("f",),
        lambda o: (o["f"] ** 2).mean())


def _frame(item, keys):
    return ({k: jnp.asarray(np.asarray(item[0][k])) for k in keys},
            {k: torch.as_tensor(np.asarray(item[1][k], np.float32)) for k in keys})


def test_nhr_equals_jax(nhr_items):
    jmodel, make, *_ = _tiny("nhr")
    jf, tf = _frame(nhr_items, NHR.frame_keys)
    jp = _np(jax.jit(jmodel.init)(jax.random.PRNGKey(3), jf))
    tmodel = make()
    nudged = dict(tf, tpose=torch.nextafter(tf["tpose"],
                                            torch.tensor(np.inf)))
    _held(jmodel, jp, tmodel, nhr_state_dict, (jf,), (tf,),
          ("rgb_map", "mask", "depth", "point_mask"), _sq_loss, (nudged,))


def test_nt_equals_jax(nt_items):
    """NT at tiny widths: the texture's lookup feeds the UNet directly, so
    this holds the UNet (gated convolutions, batch-statistics norms, blur
    and max pools, the upsampling with its pad, both heads) as well."""
    jmodel, make, _, _, to_tree = _tiny("nt")
    jf, tf = _frame(nt_items, NT.frame_keys)
    torch.manual_seed(4)
    jp = _port_tree(to_tree, make())
    tmodel = make()
    _held(jmodel, jp, tmodel, nt_state_dict, (jf,), (tf,), ("rgb_map", "mask"),
          _sq_loss)


# ---------------------------------------------------------------- datasets
@pytest.mark.parametrize("module,split", [("nhr", "test"), ("nhr", "train"),
                                          ("nt", "test"), ("nt", "train")])
def test_dataset_items_equal_jax(root, module, split):
    """Every key equal, but the bone transforms A and big_A within 1e-6:
    the port composes them in torch, JAX in jnp (a few ulps)."""
    jitem, item = _items(root, module, split)
    assert sorted(jitem) == sorted(item)
    for key in jitem:
        tol = 1e-6 if key in ("A", "big_A") else 0
        np.testing.assert_allclose(np.asarray(item[key]), np.asarray(jitem[key]),
                                   atol=tol, rtol=0, err_msg=key)


def test_nt_resizes_a_uv_map_of_another_size(root, tmp_path):
    """A uv map at half the image's size goes through resize_linear, as
    JAX's through cv2.resize; the mask follows the resized map."""
    import shutil

    copy = str(tmp_path / "root")
    shutil.copytree(root, copy, symlinks=True)
    for name in os.listdir(os.path.join(copy, "uv")):
        path = os.path.join(copy, "uv", name)
        uv = np.load(path)
        np.save(path, uv[::2, ::2])
    jitem, item = _items(copy, "nt")
    np.testing.assert_allclose(item["uv"], jitem["uv"], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(item["uv_msk"], jitem["uv_msk"])


# ----------------------------------------------------------------- weights
def _full_trees(nhr_items, nt_items):
    """make_model's full widths: the JAX trees' shapes from
    jax.eval_shape (no compile), each leaf filled with distinct values
    (its index in C order, scaled, plus an offset drawn from a numpy
    seed), so that any transposition or swapped name shows."""
    rng = np.random.RandomState(5)

    def fill(shapes):
        return jax.tree_util.tree_map(
            lambda s: (np.arange(int(np.prod(s.shape)), dtype=np.float32)
                       * np.float32(1e-3) + np.float32(rng.randn())
                       ).reshape(s.shape), shapes)

    jf, _ = _frame(nhr_items, NHR.frame_keys)
    nhr = fill(jax.eval_shape(JNHR(H=IMAGE_SIZE, W=IMAGE_SIZE, feature_dim=18).init,
                              jax.random.PRNGKey(0), jf))
    jf, _ = _frame(nt_items, NT.frame_keys)
    nt = fill(jax.eval_shape(JNT(size=1024, feature_dim=16).init,
                             jax.random.PRNGKey(0), jf))
    return nhr, nt


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(a),
                            jax.tree_util.tree_leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and np.array_equal(x, y), path


def test_full_width_codecs_round_trip(nhr_items, nt_items):
    """convert_nhr / convert_nt of the port's state dicts give the trees
    back; make_model's modules strict-load the state dicts; the inverse
    codecs give the trees back from the modules' parameters."""
    nhr, nt = _full_trees(nhr_items, nt_items)
    base = ["H", str(IMAGE_SIZE), "W", str(IMAGE_SIZE)]
    for tree, to_state, to_tree, convert, cfg_file in (
            (nhr, nhr_state_dict, nhr_param_tree, convert_nhr,
             "configs/synthetic_nhr.yaml"),
            (nt, nt_state_dict, nt_param_tree, convert_nt,
             "configs/synthetic_nt.yaml")):
        state = to_state(tree)
        back = convert({k: v.numpy() for k, v in state.items()})
        _assert_trees_equal(back, tree)
        model = t_engine.make_model(load_config(cfg_file, base))
        model.load_state_dict(state, strict=True)
        _assert_trees_equal(to_tree(dict(model.named_parameters())), tree)


@pytest.mark.parametrize("module", ["nhr", "nt"])
def test_checkpoints_cross_both_ways(module, nhr_items, nt_items, tmp_path):
    """A latest.flax written by the port (after one Adam update) restores
    in JAX's load_checkpoint, weights and Adam moments equal (the batch
    norms' stored statistics with moments of 0); one written by JAX
    restores in the port's."""
    from animatable_nerf_tpu.train.optim import make_optimizer as j_make_optimizer

    from animatable_nerf_tpu_torch.train.optim import make_optimizer

    _, make, keys, _, to_tree = _tiny(module)
    items = nhr_items if module == "nhr" else nt_items
    cfg = load_config(f"configs/synthetic_{module}.yaml", [])
    _, tf = _frame(items, keys)
    # the restore's template: a tree of the family's layout (the codecs
    # are held to JAX's own trees at full widths above)
    jparams = jax.tree_util.tree_map(np.zeros_like, to_tree(dict(
        make().named_parameters())))
    jopt = j_make_optimizer(j_load_config(f"configs/synthetic_{module}.yaml",
                                          []))[0].init(jparams)
    tmodel = make()
    opt = make_optimizer(cfg, [p for p in tmodel.parameters() if p.requires_grad])
    _sq_loss(tmodel(tf)).backward()
    opt.step()
    port_dir = str(tmp_path / "port")
    save_checkpoint(port_dir, tmodel, opt, 3, 7, {"step": 7}, latest=True)
    out = j_load_checkpoint(port_dir, jparams, jopt)
    assert out is not None and out[2:4] == (3, 7)
    _assert_trees_equal(out[0], to_tree(dict(tmodel.named_parameters())))
    adam = out[1][1][0]
    assert int(adam.count) == 1
    for moments, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        _assert_trees_equal(moments, to_tree({
            n: opt.state[p][key] if p in opt.state else torch.zeros_like(p)
            for n, p in tmodel.named_parameters()}))

    jax_dir = str(tmp_path / "jax")
    j_save_checkpoint(jax_dir, out[0], out[1], 4, 9, {"step": 9}, latest=True)
    fresh = make()
    fopt = make_optimizer(cfg, [p for p in fresh.parameters() if p.requires_grad])
    assert load_checkpoint(jax_dir, fresh, fopt)[:3] == (4, 9, 1)
    for (name, a), b in zip(tmodel.named_parameters(), fresh.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)
        if a in opt.state:
            for key in ("exp_avg", "exp_avg_sq"):
                torch.testing.assert_close(fopt.state[b][key], opt.state[a][key],
                                           rtol=0, atol=0, msg=name)
