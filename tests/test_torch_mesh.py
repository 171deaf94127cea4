"""Mesh extraction on the CPU (`--type visualize` with vis_posed_mesh /
vis_tpose_mesh, `--type animation`): the port against the JAX package
(animatable_nerf_tpu/engine.py:344-375, :606-692, render/mesh.py,
render/visibility.py, data/mesh_dataset.py, evaluators/mesh.py) on the
same inputs and weights. AniNeRF runs on its tracked checkpoint (the
human subject), SDF-PDF and NeRF-PDF on theirs (the capsule),
AlignedLBWPDF on weights composed in memory from the tracked AniNeRF and
NeRF-PDF files (compat/compose.py; its deform is the aligned families'
learned blend weights followed by NeRF-PDF's displacement field); grids
at voxel
VOXEL, swept in tiles of TILE points by both packages (the JAX engine's
`density_grid_sweep` and the port engine's SWEEP_TILE patched to it), so
a grid spans several tiles and each tile forces its own argmin.

Tolerances:
  * `grid_points`, `dilate` (against cv2), the mesh items' grids, carve
    masks and cameras, `prepare_inside_mask`, the native marching tetrahedra
    and `largest_component`, the tiled sweep of a cheap field and
    `MeshEvaluator` on a given mesh: equal bit for bit (the same float32
    and float64 operations; both packages build the same C++ with the
    same flags). The items' other arrays (the frame's bone transforms,
    volumes and vertices): FRAME_TOL, 1e-6 (the port's skeleton code
    rounds the bone chain's products otherwise by an ulp).
  * The density and SDF grids: FIELD_TOL (rtol 1e-4, atol 1e-3), 8x256
    float32 stacks summed in another order, at nodes that both packages'
    filters keep. The KNN filter's weighted distance, by differences in
    the port and in JAX's matmul form, may flip a node within FLIP_BAND
    of its threshold: such nodes are counted, at most MAX_FLIPS of them,
    and every other node's value is compared.
  * The meshes: equal vertex and face counts, the same faces, vertices
    within VERT_TOL (in metres; a vertex moves by the field's error over
    its gradient along a grid edge), and the re-posed SDF vertices
    within REPOSE_TOL, except at most MAX_REPOSE_OUTLIERS vertices whose
    5-NN blend takes another vertex on a near-tie.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.data.mesh_dataset import grid_points as j_grid_points
from animatable_nerf_tpu.evaluators import mesh as j_mesh_eval
from animatable_nerf_tpu.models.common import keep_mask_with_argmin as j_keep
from animatable_nerf_tpu.render import mesh as j_mesh
from animatable_nerf_tpu.render.visibility import (
    prepare_inside_mask as j_prepare_inside_mask,
)
from animatable_nerf_tpu.visualizers.mesh import MeshVisualizer as JMeshVisualizer

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch import native
from animatable_nerf_tpu_torch import run as t_run
from animatable_nerf_tpu_torch.compat.compose import compose_aligned
from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.core.knn import sample_blend_closest_points
from animatable_nerf_tpu_torch.core.lbs import world_points_to_pose_points
from animatable_nerf_tpu_torch.data import camera
from animatable_nerf_tpu_torch.data.distorted_copy import (
    config_opts,
    write_distorted_copy,
)
from animatable_nerf_tpu_torch.data.mesh_dataset import grid_points
from animatable_nerf_tpu_torch.evaluators import mesh as t_mesh_eval
from animatable_nerf_tpu_torch.models.common import keep_mask_with_argmin
from animatable_nerf_tpu_torch.render import mesh as t_mesh
from animatable_nerf_tpu_torch.render.visibility import prepare_inside_mask

REPO = Path(__file__).resolve().parents[1]
VOXEL = 0.1
TILE = 1024
FIELD_TOL = dict(rtol=1e-4, atol=1e-3)
FLIP_BAND = 1e-5
MAX_FLIPS = 4
VERT_TOL = 1e-4
REPOSE_TOL = 1e-4
MAX_REPOSE_OUTLIERS = 4
FRAME_TOL = dict(rtol=1e-6, atol=1e-6)
EXACT_ITEM_KEYS = ("pts", "msks", "Ks", "RT", "voxel_size", "frame_index",
                   "latent_index", "bw_latent_index")
SDF_DATASET = ["test_dataset_module", "lib.datasets.anisdf_mesh_dataset"]
PDF_DATASET = ["test_dataset_module", "lib.datasets.aninerf_pdf_mesh_dataset"]
# family: (config, opts, tracked checkpoint or None for composed weights)
FAMILIES = {
    "aninerf": ("configs/synthetic.yaml", [],
                "data/trained_model/deform/synthetic/latest.flax"),
    "sdf_pdf": ("configs/synthetic_sdf_pdf.yaml", SDF_DATASET,
                "data/trained_model/deform/synthetic_sdf_pdf/latest.flax"),
    "nerf_pdf": ("configs/synthetic_nerf_pdf.yaml", PDF_DATASET,
                 "data/trained_model/deform/synthetic_nerf_pdf/latest.flax"),
    "aligned_lbw_pdf": ("configs/synthetic_aligned_lbw_pdf.yaml", PDF_DATASET,
                        None),
}
MESH_OPTS = ["vis_posed_mesh", "True", "voxel_size", f"[{VOXEL}, {VOXEL}, {VOXEL}]",
             "knn_grid_res", "0"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Beside the suite's other workers, torch's intra-op threads would
    oversubscribe the cores, so this file runs on one thread. Module
    scope, so that it holds before the module-scoped family fixture
    (pytest sets up wider scopes first): on the default threads, that
    fixture's torch work ran 10-100 times slower under the suite."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flax_tree(tree):
    """A checkpoint's param tree as flax applies it: a dict keyed "0",
    "1", ... (how msgpack keeps a list) becomes the list."""
    if isinstance(tree, dict):
        if tree and all(k.isdigit() for k in tree):
            return [flax_tree(tree[str(i)]) for i in range(len(tree))]
        return {k: flax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def params_of(family):
    path = FAMILIES[family][2]
    if path is None:
        return compose_aligned(family[len("aligned_"):])
    return read_checkpoint(str(REPO / path))["params"]




@pytest.fixture(scope="module")
def small_tiles():
    """Both engines sweep in tiles of TILE points (JAX's jitted sweeps
    read `density_grid_sweep` when first traced). The JAX engine's carve
    (`prepare_inside_mask`, which its `extract_mesh` calls eagerly) runs
    jitted: one program in place of a compile per operation, the same
    function, whose mask the items test holds to the port's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_engine, "density_grid_sweep",
                   functools.partial(j_mesh.density_grid_sweep, tile=TILE))
        mp.setattr(j_engine, "prepare_inside_mask",
                   jax.jit(j_engine.prepare_inside_mask))
        mp.setattr(t_engine, "SWEEP_TILE", TILE)
        yield


@pytest.fixture(scope="module", params=list(FAMILIES))
def fam(request, small_tiles):
    """A family's engines, weights and frame-0 mesh items in both
    packages, both meshes, and the port's swept grid (recorded from its
    `extract_mesh`, so the family sweeps once). JAX's SDF-PDF mesh is its
    `extract_mesh`'s two steps, `canonical_sdf_mesh` and
    `repose_canonical_mesh`, the second on the port's canonical vertices,
    so the re-pose is compared on the same vertices and runs once."""
    family = request.param
    cfg_file, opts, _ = FAMILIES[family]
    jc = j_load_config(cfg_file, MESH_OPTS + opts, run_type="visualize")
    tc = load_config(cfg_file, MESH_OPTS + opts, run_type="visualize")
    params = params_of(family)
    j_eng = j_engine.Engine(jc)
    j_params = {"params": flax_tree(params["params"] if "params" in params
                                    else params)}
    t_eng = t_engine.Engine(tc, "cpu")
    t_eng.load_params(params)
    j_item = j_engine.make_dataset(jc, "test")[0]
    t_item = t_engine.make_dataset(tc, "test")[0]
    sweeps = []
    real_sweep = t_eng.sweep_field

    def recorded_sweep(item):
        sweeps.append(real_sweep(item))
        return sweeps[-1]

    t_eng.sweep_field = recorded_sweep
    t_mesh = t_eng.extract_mesh(t_item)
    (t_grid,) = sweeps
    if family == "sdf_pdf":
        verts, tris = j_eng.canonical_sdf_mesh(j_params, j_item)
        j_mesh = {"vertex": verts, "triangle": tris,
                  "posed_vertex": j_eng.repose_canonical_mesh(
                      j_params, t_mesh["vertex"], j_item)}
    else:
        j_mesh = j_eng.extract_mesh(j_params, j_item)
    return {"family": family, "j_eng": j_eng, "j_params": j_params,
            "t_eng": t_eng, "j_item": j_item, "t_item": t_item,
            "j_mesh": j_mesh, "t_mesh": t_mesh, "t_grid": t_grid}


# ------------------------------------------------------------ host parts
@pytest.mark.parametrize("bounds, voxel", [
    ([[-0.31, -0.92, -0.17], [0.33, 0.88, 0.21]], 0.02),
    ([[0.1, 0.2, 0.3], [0.6, 0.9, 0.4]], 0.005),
    ([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], [0.1, 0.05, 0.07]),
])
def test_grid_points_bit_equal(bounds, voxel):
    """The grid's nodes in float32 steps, as JAX's (and the reference's)."""
    b = np.asarray(bounds, np.float32)
    v = np.broadcast_to(np.asarray(voxel, np.float32), (3,))
    got, want = grid_points(b, v), j_grid_points(b, v)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape, density", [
    ((128, 128), 0.02), ((37, 53), 0.3), ((4, 3), 0.5), ((1, 9), 0.4)])
def test_dilate_matches_cv2(shape, density):
    """5x5 ones, cv2's default anchor and border (pixels outside the
    image take no part)."""
    import cv2

    rng = np.random.RandomState(shape[0])
    img = ((rng.rand(*shape) < density) * rng.randint(1, 256, shape)).astype(np.uint8)
    np.testing.assert_array_equal(camera.dilate(img),
                                  cv2.dilate(img, np.ones((5, 5), np.uint8)))


@pytest.fixture(scope="module")
def distorted_root(tmp_path_factory):
    """A copy of the capsule root with lens distortion on every camera and
    half-size masks, written as PNG for JAX's cv2.imread."""
    import cv2

    return write_distorted_copy("data/synthetic/capsule",
                                str(tmp_path_factory.mktemp("capsule_d")),
                                png_writer=cv2.imwrite)


@pytest.mark.parametrize("root", ["human", "distorted"])
def test_mesh_items_and_inside_mask_match_jax(root, distorted_root):
    """The human subject's frame-1 mesh item (MeshDataset) and a
    distorted capsule copy's (PDFMeshDataset) equal JAX's: the grid, the
    carve masks (undistorted, dilated, resized), the cameras and the
    indices bit for bit, the frame's arrays (bone transforms, volumes,
    vertices, the port's own skeleton code as in its evaluate items)
    within FRAME_TOL; and `prepare_inside_mask` over the grid equals
    JAX's."""
    if root == "human":
        cfg, opts = "configs/synthetic.yaml", []
    else:
        cfg = "configs/synthetic_sdf_pdf.yaml"
        opts = PDF_DATASET + config_opts(distorted_root)
    jc = j_load_config(cfg, MESH_OPTS + opts, run_type="visualize")
    tc = load_config(cfg, MESH_OPTS + opts, run_type="visualize")
    j_ds, t_ds = j_engine.make_dataset(jc, "test"), t_engine.make_dataset(tc, "test")
    assert len(j_ds) == len(t_ds)
    j_item, t_item = j_ds[1], t_ds[1]
    assert set(t_item) <= set(j_item)
    for k, v in t_item.items():
        if k in EXACT_ITEM_KEYS:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(j_item[k]),
                                          err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(v), np.asarray(j_item[k]),
                                       **FRAME_TOL, err_msg=k)
    if root == "distorted":  # ratio 0.5
        assert t_item["msks"].shape[1:] == (64, 64)
    flat = t_item["pts"].reshape(-1, 3)
    got = prepare_inside_mask(*(torch.as_tensor(np.asarray(a)) for a in (
        flat, t_item["Ks"], t_item["RT"], t_item["msks"]))).numpy()
    want = np.asarray(j_prepare_inside_mask(*(jnp.asarray(a) for a in (
        flat, j_item["Ks"], j_item["RT"], j_item["msks"]))))
    assert 0 < got.sum() < len(got)
    np.testing.assert_array_equal(got, want)


def blob_volume(shape=(23, 19, 27), seed=0):
    """Three gaussian blobs, two of them joined, one apart: a volume
    with two components at level 0.5."""
    rng = np.random.RandomState(seed)
    g = np.stack(np.meshgrid(*(np.arange(n, dtype=np.float64) for n in shape),
                             indexing="ij"), -1)
    vol = np.zeros(shape)
    for c, s in (((6, 6, 8), 3.0), ((9, 8, 11), 2.5), ((17, 13, 21), 2.0)):
        vol += np.exp(-((g - c) ** 2).sum(-1) / (2 * s * s))
    return (vol + 0.01 * rng.rand(*shape)).astype(np.float32)


@pytest.mark.parametrize("level", [0.5, 0.25])
def test_marching_cubes_and_largest_component_match_jax(level):
    """The native marching tetrahedra (the port's copy of the C++, built
    by its shim) and the largest component: the same vertices and faces
    as JAX's native path."""
    vol = np.pad(blob_volume(), 2)
    got = t_mesh.marching_cubes(vol, level)
    want = j_mesh.marching_cubes(vol, level)
    assert len(got[1]) > 100
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    big = t_mesh.largest_component(*got)
    big_j = j_mesh.largest_component(*want)
    if level == 0.5:  # the far blob is its own component
        assert len(big[0]) < len(got[0])
    for g, w in zip(big, big_j):
        np.testing.assert_array_equal(g, w)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: a source g++ cannot build raises, where JAX's loader
    returns None and takes its numpy twin."""
    bad = tmp_path / "mesh_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "libmesh_native.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.marching_tets(blob_volume(), 0.5)


def test_sweep_forces_the_argmin_per_padded_tile():
    """A grid of more than 65,536 points at the default tile: the last
    tile is zero-padded and the filter's argmin is forced in each tile,
    as in JAX's lax.map; a field that keeps nothing under its threshold
    keeps exactly one point a tile."""
    rng = np.random.RandomState(3)
    pts = rng.uniform(-1, 1, (70000, 3)).astype(np.float32)
    center = np.array([0.3, -0.2, 0.5], np.float32)

    def t_field(p):
        d = torch.linalg.norm(p - torch.as_tensor(center), dim=-1)
        return torch.where(keep_mask_with_argmin(d, 1e-3), 1.0 - d, 0.0)

    def j_field(p):
        d = jnp.linalg.norm(p - center, axis=-1)
        return jnp.where(j_keep(d, 1e-3), 1.0 - d, 0.0)

    got = t_mesh.density_grid_sweep(t_field, torch.as_tensor(pts)).numpy()
    want = np.asarray(jax.jit(lambda p: j_mesh.density_grid_sweep(j_field, p))(pts))
    assert np.count_nonzero(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got != 0, want != 0)


# ------------------------------------------------------------- families
def near_threshold(t_eng, t_item, flat):
    """Grid nodes whose KNN filter distance lies within FLIP_BAND of its
    0.1 threshold (the nodes that may flip between the two packages'
    distances): the canonical grid against the canonical vertices for the
    SDF families, the posed grid against the posed vertices for the other
    KNN families; none for AniNeRF, whose filter reads the same trilinear
    lookup in both packages."""
    frame = t_eng._mesh_frame(t_item)
    pts = torch.as_tensor(flat)
    if "weights" not in frame:
        return np.zeros(len(flat), bool)
    if isinstance(t_eng.model, (t_engine.SDFPDF, t_engine.NeuSPDF)):
        ref = frame["tvertices"]
    else:
        ref = frame["pvertices"]
        pts = world_points_to_pose_points(pts, frame["R"], frame["Th"])
    _, d = sample_blend_closest_points(pts, ref, frame["weights"])
    return (torch.abs(d[:, 0] - 0.1) < FLIP_BAND).numpy()


def test_field_grid_matches_jax(fam):
    """The swept grid (`Engine.sweep_field`) against JAX's
    `_density_sweep` (AniNeRF, NeRF-PDF, AlignedLBWPDF) or `_sdf_sweep`
    (SDF-PDF), node by node."""
    t_eng, t_item, j_eng = fam["t_eng"], fam["t_item"], fam["j_eng"]
    got, flat = (t.numpy() for t in fam["t_grid"])
    assert len(flat) > TILE
    sweep = (j_eng._sdf_sweep_jit if fam["family"] == "sdf_pdf"
             else j_eng._density_sweep_jit)
    want = np.asarray(sweep(fam["j_params"], j_eng._device_frame(fam["j_item"]),
                            jnp.asarray(flat)))
    differ = ~np.isclose(got, want, **FIELD_TOL)
    if differ.any():
        near = near_threshold(t_eng, t_item, flat)
        assert (differ & ~near).sum() == 0, np.flatnonzero(differ & ~near)[:10]
        assert differ.sum() <= MAX_FLIPS
    assert np.isfinite(got).all() and (got != 0).any()


def test_extract_mesh_matches_jax(fam):
    """`Engine.extract_mesh` against JAX's on the same frame: equal
    vertex and face counts, the same faces, the canonical and posed
    vertices within VERT_TOL (SDF-PDF's posed ones: REPOSE_TOL)."""
    jm, tm = fam["j_mesh"], fam["t_mesh"]
    assert len(tm["triangle"]) > 50
    assert len(tm["vertex"]) == len(jm["vertex"])
    np.testing.assert_array_equal(tm["triangle"], jm["triangle"])
    np.testing.assert_allclose(tm["vertex"], jm["vertex"], rtol=0, atol=VERT_TOL)
    posed = np.abs(tm["posed_vertex"] - jm["posed_vertex"]).max(-1)
    tol = REPOSE_TOL if fam["family"] == "sdf_pdf" else VERT_TOL
    assert (posed > tol).sum() <= (MAX_REPOSE_OUTLIERS
                                   if fam["family"] == "sdf_pdf" else 0)
    stats = fam["t_eng"].mesh_stats
    assert stats["vertices"] == len(tm["vertex"])
    assert stats["tiles"] == -(-stats["points"] // TILE) > 1


@pytest.mark.parametrize("fam", ["sdf_pdf"], indirect=True)
def test_repose_matches_jax_at_the_same_vertices(fam):
    """SDF-PDF's `repose_canonical_mesh` of the port's canonical vertices
    against JAX's of the same vertices (within REPOSE_TOL, at most
    MAX_REPOSE_OUTLIERS apart), equal to the posed mesh of the port's
    `extract_mesh`, and posed away from the canonical vertices."""
    verts = fam["t_mesh"]["vertex"]
    got = fam["t_eng"].repose_canonical_mesh(verts, fam["t_item"])
    assert got.shape == verts.shape
    far = np.abs(got - fam["j_mesh"]["posed_vertex"]).max(-1) > REPOSE_TOL
    assert far.sum() <= MAX_REPOSE_OUTLIERS
    np.testing.assert_array_equal(got, fam["t_mesh"]["posed_vertex"])
    assert np.abs(got - verts).max() > 0.01


def test_mesh_evaluator_matches_jax(tmp_path, monkeypatch):
    """Chamfer and P2S of a mesh against a ground-truth OBJ, the records,
    mesh_metrics.npy and the posed PLY: equal to JAX's, from the same
    RandomState(0) draws."""
    verts, faces = t_mesh.marching_cubes(np.pad(blob_volume(), 2), 0.5)
    gt_v, gt_f = t_mesh.marching_cubes(np.pad(blob_volume(seed=1), 2), 0.45)
    monkeypatch.chdir(tmp_path)
    j_mesh_eval.export_obj("gt/object/000003.obj", gt_v * 0.01, gt_f)
    out = {}
    for name, mod in (("port", t_mesh_eval), ("jax", j_mesh_eval)):
        ev = mod.MeshEvaluator(f"res_{name}", data_root="gt", human="rp_x",
                               exp_name=name)
        rec = ev.evaluate(verts * 0.01, faces, 3)
        assert ev.evaluate(verts * 0.01, faces, 4) is None  # no ground truth
        out[name] = (rec, ev.summarize())
    assert out["port"] == out["jax"]
    assert out["port"][0]["chamfer"] > 0
    got = np.load("res_port/mesh_metrics.npy", allow_pickle=True).item()
    assert got == np.load("res_jax/mesh_metrics.npy", allow_pickle=True).item()
    for f in ("0003.ply", "0004.ply"):
        assert (Path("data/animation/port/posed_mesh", f).read_bytes()
                == Path("data/animation/jax/posed_mesh", f).read_bytes())


# ----------------------------------------------------------- entry points
@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    """A working directory with the repository's configs and data, where
    the runs write data/animation and data/result; every engine sweeps
    in tiles of TILE points."""
    (tmp_path / "data").mkdir()
    for sub in ("synthetic", "trained_model"):
        (tmp_path / "data" / sub).symlink_to(REPO / "data" / sub)
    (tmp_path / "configs").symlink_to(REPO / "configs")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(t_engine, "SWEEP_TILE", TILE)
    return tmp_path


def cli(*args):
    return t_run.main(["--device", "cpu", *args])


def test_run_visualize_writes_jax_layout(workdir):
    """`--type visualize` with vis_posed_mesh and with vis_tpose_mesh on
    AniNeRF, frame 0: the PLY and NPY under posed_mesh/ and tpose_mesh/,
    byte for byte what JAX's writers make of the same mesh, and
    mesh_metrics.npy against the root's ground-truth OBJ."""
    opts = ["voxel_size", f"[{VOXEL}, {VOXEL}, {VOXEL}]",
            "test.num_sampler_ind", "1"]
    (rec,) = cli("--type", "visualize", "--cfg_file", "configs/synthetic.yaml",
                 "vis_posed_mesh", "True", *opts)
    assert rec["chamfer"] > 0 and rec["p2s"] > 0
    metrics = np.load(workdir / "data/result/deform/synthetic/mesh_metrics.npy",
                      allow_pickle=True).item()
    assert metrics == {"p2s": [rec["p2s"]], "chamfer": [rec["chamfer"]]}
    cli("--type", "visualize", "--cfg_file", "configs/synthetic.yaml",
        "vis_tpose_mesh", "True", *opts)
    out = workdir / "data/animation/synthetic"
    for sub in ("posed_mesh", "tpose_mesh"):
        mesh = np.load(out / sub / "0000.npy", allow_pickle=True).item()
        assert len(mesh["triangle"]) > 100
        path = JMeshVisualizer("jax", str(workdir / "jax")).visualize(
            mesh["vertex"], mesh["triangle"], 0, posed=sub == "posed_mesh")
        assert Path(path).read_bytes() == (out / sub / "0000.ply").read_bytes()


def test_run_animation_sdf_shares_one_topology(workdir):
    """`--type animation` on SDF-PDF: the canonical mesh is extracted once
    and re-posed into each frame, so every frame has one vertex count and
    the same faces, at other positions."""
    counts = cli("--type", "animation", "--cfg_file",
                 "configs/synthetic_sdf_pdf.yaml", "vis_posed_mesh", "True",
                 *SDF_DATASET, "voxel_size", f"[{VOXEL}, {VOXEL}, {VOXEL}]",
                 "test.frame_sampler_interval", "1", "test.num_sampler_ind", "3")
    assert len(counts) == 3 and counts[0] > 100 and len(set(counts)) == 1
    out = workdir / "data/animation/synthetic_sdf_pdf/posed_mesh"
    meshes = [np.load(out / f"{i:04d}.npy", allow_pickle=True).item()
              for i in range(3)]
    for m in meshes[1:]:
        np.testing.assert_array_equal(m["triangle"], meshes[0]["triangle"])
        assert np.abs(m["vertex"] - meshes[0]["vertex"]).max() > 0.01
    assert (out / "0002.ply").exists()


def test_run_animation_density_family_extracts_every_frame(workdir):
    """`--type animation` on AniNeRF extracts each frame's own mesh."""
    counts = cli("--type", "animation", "--cfg_file", "configs/synthetic.yaml",
                 "vis_posed_mesh", "True",
                 "voxel_size", f"[{VOXEL}, {VOXEL}, {VOXEL}]")
    assert len(counts) == 2 and min(counts) > 100 and counts[0] != counts[1]
    assert sorted(p.name for p in (
        workdir / "data/animation/synthetic/posed_mesh").iterdir()) == [
        "0000.npy", "0000.ply", "0002.npy", "0002.ply"]


def test_animation_without_a_mesh_dataset_raises(workdir, monkeypatch):
    """`--type animation` without the mesh overlay has no grid to sweep:
    it raises before an engine is made."""
    monkeypatch.setattr(t_engine, "Engine", None)
    with pytest.raises(ValueError, match="mesh dataset"):
        cli("--type", "animation", "--cfg_file", "configs/synthetic.yaml")
