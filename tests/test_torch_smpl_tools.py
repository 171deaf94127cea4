"""The port's SMPL body model, closest point on a mesh and dataset-prep
tools (animatable_nerf_tpu_torch/smpl/, tools/) against the JAX
package's and the repository's tools/, on the CPU.

  * `SMPLModel` on tests/test_smpl_tools.py's `_fake_smpl` (with pose
    blend shapes) and the SMPL-X functions on its `_fake_smplx`: what
    stays numpy in float64 bit for bit, what passes the float32
    Rodrigues and rigid-transform chain within CHAIN_TOL = 1e-6;
  * `closest_point_on_mesh`: the face equal but at ties (another face
    at the same distance within TIE_TOL), the distance within 1e-6, the
    barycentric coordinates and point within 1e-5 where the face is
    equal; without a card it raises unless the CPU is asked for;
  * `prepare_lbs_meta`, `prepare_blend_weights`, `render_uv_maps` and
    `render_skeleton`, run by their CLIs, against the JAX tools on the
    same roots: the same files, dtypes and shapes; integers equal,
    floats within CHAIN_TOL (the blend-weight grids' distance channel
    too; their weights within GRID_TOL but at ties, TIE_GRID_TOL), the
    uv maps equal, the skeleton PNG's pixels equal to cv2's.
"""

import os
import pickle
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
import prepare_blend_weights as j_pbw  # noqa: E402
import prepare_lbs_meta as j_plm  # noqa: E402
import render_skeleton as j_skel  # noqa: E402
import render_uv_maps as j_uv  # noqa: E402

from animatable_nerf_tpu import smpl as jsmpl  # noqa: E402
from animatable_nerf_tpu.data.synthetic import generate_synthetic_dataset  # noqa: E402

from animatable_nerf_tpu_torch import smpl as tsmpl  # noqa: E402
from animatable_nerf_tpu_torch.smpl import body_model as tbm  # noqa: E402
from animatable_nerf_tpu_torch.tools import (  # noqa: E402
    prepare_blend_weights,
    prepare_lbs_meta,
    render_skeleton,
    render_uv_maps,
)
from animatable_nerf_tpu_torch.visualizers.image import read_png  # noqa: E402

import test_smpl_tools as jt  # noqa: E402

CHAIN_TOL = 1e-6
TIE_TOL = 1e-6
BARY_TOL = 1e-5
GRID_TOL = 1e-5
# a grid point at a tie takes another face's barycentric coordinates of
# (nearly) the same point: its weights may move by more than GRID_TOL,
# never by more than TIE_GRID_TOL, on at most TIE_GRID_SHARE of the cells
TIE_GRID_TOL = 1e-4
TIE_GRID_SHARE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smpl(seed=0):
    """`_fake_smpl` at a third of its scale (a 0.1 m body, so the prep
    tools' 0.025 m grids stay small) with pose blend shapes."""
    rng = np.random.RandomState(seed)
    smpl = jt._fake_smpl(rng)
    smpl["v_template"] = smpl["v_template"] * (1.0 / 3.0)
    smpl["posedirs"] = rng.randn(40, 3, 207) * 0.001
    return smpl


def _close(a, b, tol=CHAIN_TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def test_smpl_model_equals_jax(tmp_path):
    smpl = _smpl()
    with open(tmp_path / "smpl.pkl", "wb") as f:
        pickle.dump(smpl, f)
    np.savez(tmp_path / "smpl.npz", **smpl)
    for path in ("smpl.pkl", "smpl.npz"):
        got, want = (m.load_smpl(str(tmp_path / path)) for m in (tsmpl, jsmpl))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    model, jmodel = tsmpl.SMPLModel(smpl), jsmpl.SMPLModel(smpl)
    for k in ("v_template", "shapedirs", "J_regressor", "weights", "parents",
              "faces", "posedirs"):
        np.testing.assert_array_equal(getattr(model, k), getattr(jmodel, k))
    rng = np.random.RandomState(1)
    betas = rng.randn(10) * 0.5
    poses = (rng.randn(24, 3) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(model.shaped_vertices(betas),
                                  jmodel.shaped_vertices(betas))
    joints = model.joints(model.shaped_vertices(betas))
    np.testing.assert_array_equal(joints, jmodel.joints(jmodel.shaped_vertices(betas)))
    _close(model.transforms(poses, joints), np.asarray(jmodel.transforms(poses, joints)))
    params = {"poses": poses.reshape(1, 72), "shapes": betas[None],
              "Rh": rng.randn(1, 3) * 0.3, "Th": rng.randn(1, 3)}
    for got, want in zip(model.transform_params(params),
                         jmodel.transform_params(params)):
        _close(got, np.asarray(want))
    for pose_blend in (False, True):
        got = model.lbs(poses, betas, pose_blend=pose_blend)
        want = jmodel.lbs(poses, betas, pose_blend=pose_blend)
        for g, w in zip(got, want):
            _close(g, np.asarray(w))
    posed, _, A = model.lbs(poses, betas)
    _close(model.inverse_lbs(posed, A), jmodel.inverse_lbs(posed, A))
    for n in (24, 52):
        np.testing.assert_array_equal(tsmpl.big_pose_vector(n),
                                      jsmpl.big_pose_vector(n))
    val, coords = rng.rand(7, 3, 24), rng.dirichlet(np.ones(3), 7)
    np.testing.assert_array_equal(tsmpl.barycentric_interpolation(val, coords),
                                  jsmpl.barycentric_interpolation(val, coords))


def test_smplx_functions_equal_jax():
    from animatable_nerf_tpu.smpl import body_model as jbm

    rng = np.random.RandomState(3)
    m = jt.TestSMPLXGolden()._fake_smplx(rng)
    V = m["v_template"].shape[0]
    m["f"] = np.stack([np.arange(V - 2), np.arange(1, V - 1), np.arange(2, V)], 1)
    F = len(m["f"])
    m.update(lmk_faces_idx=rng.randint(0, F, 51),
             lmk_bary_coords=rng.dirichlet(np.ones(3), 51),
             dynamic_lmk_faces_idx=rng.randint(0, F, (79, 17)),
             dynamic_lmk_bary_coords=rng.dirichlet(np.ones(3), (79, 17)))
    vids = {k: int(v) % V for k, v in tsmpl.SMPLX_VERTEX_IDS.items()}
    assert tsmpl.SMPLX_VERTEX_IDS == jsmpl.SMPLX_VERTEX_IDS
    parts = dict(global_orient=rng.randn(3) * 0.3, body_pose=rng.randn(63) * 0.3,
                 jaw_pose=rng.randn(3) * 0.1, leye_pose=rng.randn(3) * 0.1,
                 reye_pose=rng.randn(3) * 0.1, left_hand_pose=rng.randn(6),
                 right_hand_pose=rng.randn(6))
    hands = {k: m[k] for k in ("hands_componentsl", "hands_componentsr",
                               "hands_meanl", "hands_meanr")}
    full = tsmpl.smplx_full_pose(**parts, **hands)
    np.testing.assert_array_equal(full, jsmpl.smplx_full_pose(**parts, **hands))
    betas, expr = rng.randn(10) * 0.5, rng.randn(10) * 0.5
    for g, w in zip(tsmpl.smplx_lbs(m, betas, expr, full),
                    jsmpl.smplx_lbs(m, betas, expr, full)):
        _close(g, w)
    for contour in (False, True):
        kw = dict(betas=betas, expression=expr, transl=rng.randn(3),
                  use_face_contour=contour, vertex_ids=vids, **parts)
        got, want = tsmpl.smplx_forward(m, **kw), jsmpl.smplx_forward(m, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    for hands_, feet in ((True, True), (False, True), (True, False)):
        np.testing.assert_array_equal(tsmpl.extra_joint_ids(vids, hands_, feet),
                                      jsmpl.extra_joint_ids(vids, hands_, feet))
    verts = rng.randn(V, 3)
    np.testing.assert_array_equal(
        tsmpl.vertices2landmarks(verts, m["f"], m["lmk_faces_idx"], m["lmk_bary_coords"]),
        jsmpl.vertices2landmarks(verts, m["f"], m["lmk_faces_idx"], m["lmk_bary_coords"]))
    parents = jt.TestSMPLXGolden.SMPLX_PARENTS.copy()
    parents[0] = -1
    chain = tbm.find_joint_kin_chain(12, parents)
    assert chain == jbm.find_joint_kin_chain(12, parents)
    for g, w in zip(tbm.dynamic_lmk_idx_and_bcoords(
                        full, m["dynamic_lmk_faces_idx"],
                        m["dynamic_lmk_bary_coords"], chain),
                    jbm.dynamic_lmk_idx_and_bcoords(
                        full, m["dynamic_lmk_faces_idx"],
                        m["dynamic_lmk_bary_coords"], chain)):
        np.testing.assert_array_equal(g, w)


def _ties(got, want, pts, verts, faces):
    """Points whose face differs: each must be a tie, the port's
    distance to JAX's face within TIE_TOL of its own. Returns their
    mask."""
    differ = got["face"] != want["face"]
    theirs = [tsmpl.closest_point_on_mesh(p[None], verts, faces[[f]],
                                          device="cpu")["dist"][0]
              for p, f in zip(pts[differ], want["face"][differ])]
    np.testing.assert_allclose(theirs, got["dist"][differ], rtol=0, atol=TIE_TOL)
    return differ


def test_closest_point_on_mesh_equals_jax():
    r = np.random.RandomState(0)
    verts = r.randn(120, 3).astype(np.float32)
    faces = np.stack([np.arange(118), np.arange(1, 119), np.arange(2, 120)], 1)
    pts = (r.randn(1500, 3) * 1.5).astype(np.float32)
    pts[:10] = verts[:10]  # on vertices: exact ties among the faces sharing one
    got = tsmpl.closest_point_on_mesh(pts, verts, faces, chunk=256, device="cpu")
    want = {k: np.asarray(v) for k, v in
            jsmpl.closest_point_on_mesh(pts, verts, faces).items()}
    differ = _ties(got, want, pts, verts, faces)
    print(f"faces differing at ties: {int(differ.sum())} of {len(pts)}")
    assert (~differ).sum() > len(pts) // 2
    np.testing.assert_allclose(got["dist"], want["dist"], rtol=0, atol=CHAIN_TOL)
    same = ~differ
    np.testing.assert_allclose(got["bary"][same], want["bary"][same], rtol=0,
                               atol=BARY_TOL)
    np.testing.assert_allclose(got["point"][same], want["point"][same], rtol=0,
                               atol=BARY_TOL)
    assert got["dist"].dtype == np.float32 and got["bary"].dtype == np.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsmpl.closest_point_on_mesh(pts, verts, faces)


# ------------------------------------------------------------ prep tools
@pytest.fixture(scope="module")
def fake_roots(tmp_path_factory):
    """tests/test_smpl_tools.py's fake SMPL root (3 frames of params and
    posed vertices), twice: one for each package's tools."""
    tmp = tmp_path_factory.mktemp("fake_smpl")
    smpl = _smpl(5)
    smpl_path = str(tmp / "smpl.pkl")
    with open(smpl_path, "wb") as f:
        pickle.dump(smpl, f)
    model = jsmpl.SMPLModel(smpl)
    rng = np.random.RandomState(6)
    human = tmp / "jax" / "H1"
    (human / "params").mkdir(parents=True)
    (human / "vertices").mkdir(parents=True)
    for i in range(3):
        poses = rng.randn(24, 3) * 0.1
        params = {"poses": poses.reshape(1, 72), "shapes": rng.randn(1, 10) * 0.03,
                  "Rh": rng.randn(1, 3) * 0.1, "Th": rng.randn(1, 3) * 0.1}
        np.save(human / "params" / f"{i}.npy", params)
        _, R, T, _, _, _ = model.transform_params(params)
        posed, _, _ = model.lbs(poses, params["shapes"])
        np.save(human / "vertices" / f"{i}.npy", (posed @ R.T + T).astype(np.float32))
    shutil.copytree(tmp / "jax", tmp / "port")
    return str(tmp / "jax"), str(tmp / "port"), smpl_path


def _grid_close(got, want):
    """A (D, H, W, 25) blend-weight grid: the distance channel within
    CHAIN_TOL, the weights within GRID_TOL but on the tie cells."""
    assert got.shape == want.shape and got.dtype == want.dtype
    _close(got[..., 24], want[..., 24])
    err = np.abs(got[..., :24] - want[..., :24]).max(-1)
    ties = err > GRID_TOL
    print(f"grid cells at ties: {int(ties.sum())} of {ties.size}")
    assert ties.sum() <= TIE_GRID_SHARE * ties.size and err.max() <= TIE_GRID_TOL


def _same_files(jdir, tdir, tol=CHAIN_TOL, close=_close):
    names = sorted(n for n in os.listdir(jdir) if n.endswith(".npy"))
    assert names == sorted(n for n in os.listdir(tdir) if n.endswith(".npy"))
    for name in names:
        want = np.load(os.path.join(jdir, name), allow_pickle=True)
        got = np.load(os.path.join(tdir, name), allow_pickle=True)
        if want.dtype == object:
            want, got = want.item(), got.item()
            assert sorted(want) == sorted(got)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        elif want.dtype.kind in "iub":
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif close is _close:
            _close(got, want, tol)
        else:
            close(got, want)
    return names


def test_prepare_lbs_meta_equals_jax(fake_roots):
    jroot, troot, smpl_path = fake_roots
    jout = j_plm.prepare_human(jroot, "H1", smpl_path)
    prepare_lbs_meta.main(["--data_dir", troot, "--humans", "H1",
                           "--smpl_path", smpl_path])
    names = _same_files(jout, os.path.join(troot, "H1", "lbs"))
    assert names == sorted(["parents.npy", "joints.npy", "weights.npy", "faces.npy",
                            "tvertices.npy", "bigpose_vertices.npy",
                            "smpl_params.npy", "training_joints.npy"])


def test_prepare_blend_weights_equals_jax(fake_roots):
    jroot, troot, smpl_path = fake_roots
    jout = j_pbw.prepare_human(jroot, "H1", smpl_path, frame_interval=2)
    prepare_blend_weights.main(["--data_dir", troot, "--humans", "H1",
                                "--smpl_path", smpl_path, "--frame_interval", "2",
                                "--device", "cpu"])
    tout = os.path.join(troot, "H1", "lbs")
    for name in ("tbw.npy", "bigpose_bw.npy"):
        _grid_close(np.load(os.path.join(tout, name)),
                    np.load(os.path.join(jout, name)))
    names = _same_files(os.path.join(jout, "bweights"),
                        os.path.join(tout, "bweights"), close=_grid_close)
    assert names == ["0.npy", "2.npy"]
    tbw = np.load(os.path.join(tout, "tbw.npy"))
    assert tbw.ndim == 4 and tbw.shape[-1] == 25 and tbw.shape[0] > 4


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A small synthetic root (2 frames, 2 views, 40x40) of JAX's
    generator, twice."""
    tmp = tmp_path_factory.mktemp("render_tools")
    generate_synthetic_dataset(str(tmp / "jax" / "human"), n_frames=2, n_views=2,
                               image_size=40, n_verts=150, n_blobs=24)
    shutil.copytree(tmp / "jax", tmp / "port")
    return str(tmp / "jax"), str(tmp / "port")


def test_render_uv_maps_equals_jax(synth, tmp_path):
    jbase, tbase = synth
    jout = j_uv.render_human(jbase, "human")
    render_uv_maps.main(["--data_dir", tbase, "--humans", "human"])
    names = sorted(os.listdir(jout))
    assert len(names) == 4 and names == sorted(os.listdir(os.path.join(tbase, "human", "uv")))
    for name in names:
        want = np.load(os.path.join(jout, name))
        got = np.load(os.path.join(tbase, "human", "uv", name))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (np.abs(got).sum(-1) > 0).sum() > 10
    tverts = np.load(os.path.join(tbase, "human", "lbs", "tvertices.npy"))
    np.testing.assert_array_equal(render_uv_maps.planar_uv(tverts), j_uv.planar_uv(tverts))
    obj = tmp_path / "m.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
                   "vt 0.1 0.2\nvt 0.9 0.2\nvt 0.1 0.8\nvt 0.7 0.7\n"
                   "f 1/1 2/2 3/3\nf 2/2 4/4 3/3\n")
    for g, w in zip(render_uv_maps.load_obj_uv(str(obj)), j_uv.load_obj_uv(str(obj))):
        np.testing.assert_array_equal(g, w)


def test_render_skeleton_equals_cv2(synth):
    """The port's PNG decodes to the pixels of JAX's cv2 drawing (read
    by cv2.imread from both files)."""
    jbase, tbase = synth
    jout = j_skel.render_human(jbase, "human")
    render_skeleton.main(["--data_dir", tbase, "--humans", "human"])
    names = sorted(os.listdir(jout))
    assert len(names) == 4
    for name in names:
        want = cv2.imread(os.path.join(jout, name))
        path = os.path.join(tbase, "human", "skeleton", name)
        np.testing.assert_array_equal(cv2.imread(path), want, err_msg=name)
        np.testing.assert_array_equal(read_png(path), want[..., ::-1])
        assert (want.sum(-1) > 0).sum() > 20
