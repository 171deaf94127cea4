"""Rendered visualizations on the CPU (`--type visualize` with
vis_novel_view / vis_pose_sequence, `--type raster`, the evaluator's
comparison images): the port against the JAX package
(animatable_nerf_tpu/visualizers/image.py, data/camera_path.py,
data/novel_view.py, engine.py:547-603 with the visibility carve,
:946-1022, :1075-1130, render/mesh.py `vertex_normals`, native.py
`rasterize_mesh_native`, evaluators/image.py:111-122) on the same inputs
and weights. AniNeRF runs on its tracked checkpoint (the human subject),
SDF-PDF and NeuS-PDF on theirs (the capsule), AlignedLBWPDF on weights
composed in memory from the tracked AniNeRF and NeRF-PDF files. A novel
view renders at ratio 0.5 with N_SAMPLES samples a ray, in eval tiles of
TILE rays in both packages, without the distance grid (knn_grid_res 0:
pass 1 takes every point's nearest-vertex distance, in both packages).

Tolerances:
  * `write_png`, the visualizers' and the evaluator's PNGs (decoded by
    cv2 against what JAX's cv2.imwrite writes from the same float
    images), `gen_path` and `load_cams`, the visualization items' rays,
    masks, cameras and indices, `vertex_normals` and `rasterize_mesh`:
    equal bit for bit (the same numpy float32 and float64 operations;
    both packages build the same C++ with the same flags). The items'
    other arrays (the frame's bone transforms, volumes and vertices):
    FRAME_TOL, 1e-6, as in tests/test_torch_mesh.py.
  * A carved render's rgb, acc and depth maps against JAX's
    `render_item(params, item, visibility=True)`: MAP_TOL (rtol 1e-5,
    atol 5e-5; 8x256 float32 stacks summed in another order, measured
    within 8e-6 of JAX's).
  * The CLI's PNGs are held, bit for bit after decoding, to JAX's
    writers applied to the same float maps (the port's own render,
    which the carved-render test holds to JAX's within MAP_TOL): a
    pixel whose value lies within MAP_TOL of a multiple of 1/255 may
    truncate to another level in the two packages' renders, so the two
    renders' PNGs are not compared with each other.
"""

from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatable_nerf_tpu import engine as j_engine
from animatable_nerf_tpu import native as j_native
from animatable_nerf_tpu.config import load_config as j_load_config
from animatable_nerf_tpu.data import camera_path as j_camera_path
from animatable_nerf_tpu.evaluators.image import ImageEvaluator as JImageEvaluator
from animatable_nerf_tpu.render import mesh as j_mesh
from animatable_nerf_tpu.visualizers import image as j_image

from animatable_nerf_tpu_torch import engine as t_engine
from animatable_nerf_tpu_torch import native
from animatable_nerf_tpu_torch import run as t_run
from animatable_nerf_tpu_torch.compat.compose import compose_aligned
from animatable_nerf_tpu_torch.compat.flax_msgpack import read_checkpoint
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.data import camera_path
from animatable_nerf_tpu_torch.evaluators.image import ImageEvaluator
from animatable_nerf_tpu_torch.models.pdf import NeuSPDF
from animatable_nerf_tpu_torch.render import mesh as t_mesh
from animatable_nerf_tpu_torch.visualizers import image as t_image

REPO = Path(__file__).resolve().parents[1]
MAP_TOL = dict(rtol=1e-5, atol=5e-5)
FRAME_TOL = dict(rtol=1e-6, atol=1e-6)
N_SAMPLES = 8
TILE = 512
SMALL = ["ratio", "0.5", "N_samples", str(N_SAMPLES), "eval_tile", str(TILE),
         "knn_grid_res", "0"]
NOVEL_VIEW = ["vis_novel_view", "True", "render_views", "4"]
POSE_SEQUENCE = ["vis_pose_sequence", "True"]
PDF_NOVEL_VIEW = ["test_dataset_module", "lib.datasets.tpose_pdf_novel_view_dataset"]
PDF_POSE_SEQUENCE = ["test_dataset_module",
                     "lib.datasets.tpose_pdf_pose_sequence_dataset"]
EXACT_ITEM_KEYS = ("ray_o", "ray_d", "near", "far", "mask_at_box", "msks", "Ks",
                   "RT", "H", "W", "frame_index", "view_index", "latent_index",
                   "bw_latent_index")
# family: (config, the opts that select its novel-view dataset, tracked
# checkpoint or None for composed weights)
FAMILIES = {
    "aninerf": ("configs/synthetic.yaml", [],
                "data/trained_model/deform/synthetic/latest.flax"),
    "sdf_pdf": ("configs/synthetic_sdf_pdf.yaml", PDF_NOVEL_VIEW,
                "data/trained_model/deform/synthetic_sdf_pdf/latest.flax"),
    "neus_pdf": ("configs/synthetic_neus_pdf.yaml", PDF_NOVEL_VIEW,
                 "data/trained_model/deform/synthetic_neus_pdf/latest.flax"),
    "aligned_lbw_pdf": ("configs/synthetic_aligned_lbw_pdf.yaml", PDF_NOVEL_VIEW,
                        None),
}
MAPS = ("rgb_map", "acc_map", "depth_map")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread beside the suite's other workers; module scope,
    so that it holds before the module-scoped render fixture (see
    tests/test_torch_mesh.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flax_tree(tree):
    """A checkpoint's param tree as flax applies it ("0", "1", ... keys
    of a msgpack list become the list)."""
    if isinstance(tree, dict):
        if tree and all(k.isdigit() for k in tree):
            return [flax_tree(tree[str(i)]) for i in range(len(tree))]
        return {k: flax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def decoded(path):
    """A PNG as cv2 decodes it, in RGB order."""
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img[..., ::-1]


# ----------------------------------------------------------- PNG writers
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (7, 13), (64, 64),
                                   (31, 128), (100, 1)])
def test_write_png_decodes_to_its_input(shape, tmp_path):
    """`write_png` of a seeded uint8 RGB image: cv2 decodes the file to
    the image, and to what cv2.imwrite's file of the same pixels
    decodes to."""
    rng = np.random.RandomState(shape[0] * 1000 + shape[1])
    img = rng.randint(0, 256, (*shape, 3)).astype(np.uint8)
    path = t_image.write_png(str(tmp_path / "port.png"), img)
    cv2.imwrite(str(tmp_path / "cv2.png"), np.ascontiguousarray(img[..., ::-1]))
    np.testing.assert_array_equal(decoded(path), img)
    np.testing.assert_array_equal(decoded(path), decoded(tmp_path / "cv2.png"))


def float_image(shape, seed):
    """Floats around [0, 1], past both ends, and on and beside the
    levels k / 255, where truncation decides the pixel."""
    rng = np.random.RandomState(seed)
    img = rng.uniform(-0.2, 1.2, shape)
    levels = rng.randint(0, 256, shape) / 255.0
    edge = rng.rand(*shape) < 0.3
    img[edge] = levels[edge] + rng.choice([-1e-7, -1e-9, 0.0, 1e-9, 1e-7],
                                          edge.sum())
    return img


@pytest.mark.parametrize("kind", ["novel_view", "pose_sequence", "image"])
def test_visualizers_write_jax_pixels(kind, tmp_path):
    """The visualizers on the same rays' colours (and for the novel view
    its depth and acc maps): the same file names as JAX's, PNGs that
    decode to JAX's cv2-written pixels, and the same .npy maps."""
    H, W = 23, 31
    rng = np.random.RandomState(7)
    mab = rng.rand(H * W) < 0.6
    n = int(mab.sum())
    rgb = float_image((n, 3), 1).astype(np.float32)
    gt = float_image((n, 3), 2).astype(np.float32)
    depth, acc = rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32)
    out = {}
    for name, mod in (("port", t_image), ("jax", j_image)):
        root = tmp_path / name
        if kind == "novel_view":
            mod.NovelViewVisualizer("exp", str(root)).visualize(
                rgb, mab, H, W, 3, 5, depth=depth, acc=acc)
        elif kind == "pose_sequence":
            mod.PoseSequenceVisualizer("exp", str(root)).visualize(
                rgb, mab, H, W, 3, 5)
        else:
            mod.ImageVisualizer(str(root)).visualize(rgb, gt, mab, H, W, 3, 5)
        out[name] = sorted(p.relative_to(root) for p in root.rglob("*")
                           if p.is_file())
    assert out["port"] == out["jax"] and out["port"]
    for rel in out["port"]:
        a, b = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.suffix == ".png":
            np.testing.assert_array_equal(decoded(a), decoded(b), err_msg=str(rel))
        else:
            np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=str(rel))


def test_evaluator_comparison_pngs_match_jax(tmp_path):
    """The evaluator's comparison/frame<f>_view<v>.png and _gt.png: the
    same metrics and decoded pixels as JAX's. Its conversion,
    np.clip(img * 255, 0, 255) on float64, is not the visualizers'
    (np.clip(img, 0, 1) * 255 on float32): on float64 values just below
    a level k / 255, which float32 rounds up to it, the two differ."""
    H, W = 29, 17
    rng = np.random.RandomState(11)
    mab = rng.rand(H * W) < 0.7
    n = int(mab.sum())
    pred, gt = float_image((n, 3), 3), np.clip(float_image((n, 3), 4), 0, 1)
    got = ImageEvaluator(str(tmp_path / "port")).evaluate(
        pred, gt, mab, H, W, frame_index=2, view_index=3)
    want = JImageEvaluator(str(tmp_path / "jax")).evaluate(
        pred, gt, mab, H, W, frame_index=2, view_index=3)
    assert got == want
    for name in ("frame0002_view0003.png", "frame0002_view0003_gt.png"):
        np.testing.assert_array_equal(decoded(tmp_path / "port/comparison" / name),
                                      decoded(tmp_path / "jax/comparison" / name))
    port = decoded(tmp_path / "port/comparison/frame0002_view0003.png")
    as_visualized = (np.clip(t_image._scatter_image(pred, mab, H, W), 0, 1)
                     * 255).astype(np.uint8)
    assert (as_visualized != port).any()


# ------------------------------------------------------ camera path, items
@pytest.mark.parametrize("ratio, views", [(1.0, 50), (0.5, 7)])
def test_camera_path_matches_jax(ratio, views):
    """`load_cams` and `gen_path` on the human subject's cameras: equal to
    JAX's in float64."""
    ann = str(REPO / "data/synthetic/human/annots.npy")
    Ks, RTs = camera_path.load_cams(ann, ratio)
    jKs, jRTs = j_camera_path.load_cams(ann, ratio)
    for a, b in zip(Ks + RTs, jKs + jRTs):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    path = camera_path.gen_path(RTs, views)
    want = j_camera_path.gen_path(jRTs, views)
    assert len(path) == len(want) == views
    np.testing.assert_array_equal(np.array(path), np.array(want))


@pytest.mark.parametrize("family, kind", [
    ("aninerf", "novel_view"), ("aninerf", "pose_sequence"),
    ("sdf_pdf", "novel_view"), ("sdf_pdf", "pose_sequence")])
def test_vis_items_match_jax(family, kind):
    """Item 1 of the novel-view and pose-sequence datasets, grid
    (AniNeRF, the human subject) and KNN (SDF-PDF, the capsule), against
    JAX's: the rays, box mask, carve masks, cameras, sizes and indices
    bit for bit, with their dtypes; the frame's arrays within
    FRAME_TOL."""
    cfg_file = FAMILIES[family][0]
    opts = (NOVEL_VIEW if kind == "novel_view" else POSE_SEQUENCE) + SMALL
    if family != "aninerf":
        opts += PDF_NOVEL_VIEW if kind == "novel_view" else PDF_POSE_SEQUENCE
    jc = j_load_config(cfg_file, opts, run_type="visualize")
    tc = load_config(cfg_file, opts, run_type="visualize")
    j_ds, t_ds = j_engine.make_dataset(jc, "test"), t_engine.make_dataset(tc, "test")
    assert len(t_ds) == len(j_ds) == 4
    j_item, t_item = j_ds[1], t_ds[1]
    assert set(t_item) <= set(j_item)
    for k, v in t_item.items():
        got, want = np.asarray(v), np.asarray(j_item[k])
        if k in EXACT_ITEM_KEYS:
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, **FRAME_TOL, err_msg=k)
    assert t_item["msks"].shape == (len(tc.training_view), t_item["H"], t_item["W"])
    assert 0 < t_item["msks"].mean() < 1 and t_item["mask_at_box"].sum() > 100


# ------------------------------------------------------- carved renders
def params_of(family):
    path = FAMILIES[family][2]
    if path is None:
        return compose_aligned(family[len("aligned_"):])
    return read_checkpoint(str(REPO / path))["params"]


def novel_view_cfgs(family):
    cfg_file, opts, _ = FAMILIES[family]
    opts = NOVEL_VIEW + SMALL + opts
    return (j_load_config(cfg_file, opts, run_type="visualize"),
            load_config(cfg_file, opts, run_type="visualize"))


@pytest.fixture(scope="module", params=list(FAMILIES))
def carved(request):
    """A family's view 1 of the spiral rendered by the port with and
    without the carve, and by JAX with it."""
    family = request.param
    jc, tc = novel_view_cfgs(family)
    params = params_of(family)
    t_eng = t_engine.Engine(tc, "cpu")
    t_eng.load_params(params)
    t_item = t_engine.make_dataset(tc, "test")[1]
    out, _ = t_eng.render_item(t_item, visibility=True)
    stats = dict(t_eng.stats)
    plain, _ = t_eng.render_item(t_item)
    plain_stats = dict(t_eng.stats)
    j_eng = j_engine.Engine(jc)
    j_params = {"params": flax_tree(params.get("params", params))}
    want, _ = j_eng.render_item(j_params, j_engine.make_dataset(jc, "test")[1],
                                visibility=True)
    return {"family": family, "t_eng": t_eng, "t_item": t_item, "out": out,
            "stats": stats, "plain": plain, "plain_stats": plain_stats,
            "want": {k: np.asarray(want[k]) for k in MAPS}}


def test_carved_render_matches_jax(carved):
    """`render_item(item, visibility=True)` of a novel view against JAX's:
    the maps within MAP_TOL. The carve removed survivors (the exact
    survivors are the uncarved render's, a few thousand of them carved)
    and changed the maps, which an uncarved render would not match."""
    out, stats, plain_stats = carved["out"], carved["stats"], carved["plain_stats"]
    for k in MAPS:
        np.testing.assert_allclose(out[k], carved["want"][k], **MAP_TOL, err_msg=k)
    assert stats["tiles"] == plain_stats["tiles"] > 1
    assert stats["n_candidates"] == plain_stats["n_candidates"]
    assert stats["n_survivors"] == plain_stats["n_survivors"]
    assert plain_stats["n_carved"] == 0
    assert 0 < stats["n_carved"] < stats["n_survivors"]
    assert out["acc_map"].max() > 0.05
    assert not np.allclose(carved["plain"]["acc_map"], carved["want"]["acc_map"],
                           **MAP_TOL)


@pytest.mark.parametrize("carved", ["neus_pdf"], indirect=True)
def test_neus_carve_keeps_the_carved_sdf(carved, monkeypatch):
    """NeuS-PDF's carve zeroes a carved survivor's rgb and alpha but keeps
    its sdf in the ray's (R, S) grid, which its neighbours' opacity
    reads (JAX pdf.py:755-790). Folded into the filter as in the other
    families, the carved view leaves JAX's maps."""
    monkeypatch.setattr(NeuSPDF, "carve_in_head", False)
    out, _ = carved["t_eng"].render_item(carved["t_item"], visibility=True)
    assert carved["t_eng"].stats == carved["stats"]
    assert not np.allclose(out["acc_map"], carved["want"]["acc_map"], **MAP_TOL)
    np.testing.assert_allclose(carved["out"]["acc_map"], carved["want"]["acc_map"],
                               **MAP_TOL)


# ------------------------------------------------------------- raster
def sphere_mesh():
    """A lumpy sphere of radius ~0.3 m by the port's marching tetrahedra."""
    g = np.stack(np.meshgrid(*(np.linspace(-0.4, 0.4, 17),) * 3, indexing="ij"), -1)
    r = np.linalg.norm(g, axis=-1) + 0.03 * np.sin(9 * g[..., 0]) * np.cos(7 * g[..., 1])
    verts, faces = t_mesh.marching_cubes(r.astype(np.float32), 0.3)
    return verts * 0.05 - 0.4 + np.float32([0.1, -0.05, 3.0]), faces


def test_vertex_normals_and_rasterize_match_jax():
    """`vertex_normals` and the native `rasterize_mesh` of one mesh
    against JAX's: equal bit for bit, the normals unit length and the
    mesh covering part of the image."""
    verts, faces = sphere_mesh()
    assert len(faces) > 500
    normals = t_mesh.vertex_normals(verts, faces)
    np.testing.assert_array_equal(normals, j_mesh.vertex_normals(verts, faces))
    np.testing.assert_allclose(np.linalg.norm(normals, axis=-1), 1, rtol=1e-6)
    K = np.float32([[250, 0, 40], [0, 250, 30], [0, 0, 1]])
    R = np.float32(cv2.Rodrigues(np.float64([0.1, -0.2, 0.05]))[0])
    T = np.float32([0.05, 0.1, 0.2])
    attrs = np.concatenate([normals, verts[:, 2:]], 1)
    got = native.rasterize_mesh(verts, faces, attrs, K, R, T, 61, 83)
    want = j_native.rasterize_mesh_native(verts, faces, attrs, K, R, T, 61, 83)
    for k in ("attr", "depth", "mask"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 0.1 < got["mask"].mean() < 0.9


# --------------------------------------------------------- entry points
@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    """A working directory with the repository's configs and data, where
    the runs write data/novel_view, data/perform, data/raster and
    data/result."""
    (tmp_path / "data").mkdir()
    for sub in ("synthetic", "trained_model"):
        (tmp_path / "data" / sub).symlink_to(REPO / "data" / sub)
    (tmp_path / "configs").symlink_to(REPO / "configs")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def cli(*args):
    return t_run.main(["--device", "cpu", *args])


def port_maps(tc, index):
    """The port's carved render of item `index`, as the CLI made it."""
    eng = t_engine.Engine(tc, "cpu")
    eng.load_params()
    item = t_engine.make_dataset(tc, "test")[index]
    return eng.render_item(item, visibility=True)[0], item


@pytest.mark.parametrize("kind", ["novel_view", "pose_sequence"])
def test_cli_visualize_writes_jax_layout(kind, workdir):
    """`--type visualize` with vis_novel_view and vis_depth (4 views of
    the spiral), and with vis_pose_sequence (the 4 training frames from
    view 1), on AniNeRF: JAX's file names, and PNGs (and the novel view's
    depth and acc maps) equal to what JAX's visualizer writes from the
    same render."""
    flag = NOVEL_VIEW + ["vis_depth", "True"] if kind == "novel_view" else POSE_SEQUENCE
    opts = flag + SMALL
    records = cli("--type", "visualize", "--cfg_file", "configs/synthetic.yaml", *opts)
    assert len(records) == 4 and all(r["n_carved"] > 0 for r in records)
    if kind == "novel_view":
        root = workdir / "data/novel_view/synthetic"
        names = [f"frame_0000/{v:04d}{s}" for v in range(4)
                 for s in (".png", "_acc.npy", "_depth.npy")]
    else:
        root = workdir / "data/perform/synthetic"
        names = [f"frame{f:04d}_view0001.png" for f in range(4)]
    assert sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file()) == sorted(names)
    tc = load_config("configs/synthetic.yaml", opts, run_type="visualize")
    out, item = port_maps(tc, 1)
    args = (out["rgb_map"], item["mask_at_box"], item["H"], item["W"],
            item["frame_index"], item["view_index"])
    if kind == "novel_view":
        j_image.NovelViewVisualizer("synthetic", "jax").visualize(
            *args, depth=out["depth_map"], acc=out["acc_map"])
        for name in ("0001.png", "0001_acc.npy", "0001_depth.npy"):
            a, b = root / "frame_0000" / name, workdir / "jax/synthetic/frame_0000" / name
            if name.endswith(".png"):
                np.testing.assert_array_equal(decoded(a), decoded(b))
            else:
                np.testing.assert_array_equal(np.load(a), np.load(b))
    else:
        j_image.PoseSequenceVisualizer("synthetic", "jax").visualize(*args)
        name = "frame0001_view0001.png"
        np.testing.assert_array_equal(decoded(root / name),
                                      decoded(workdir / "jax/synthetic" / name))
    assert decoded(root / names[3]).max() > 100


@pytest.mark.parametrize("mesh", ["extracted", "empty"])
def test_cli_raster_writes_jax_layout(mesh, workdir, monkeypatch):
    """`--type raster` on AniNeRF's frame 0 at voxel 0.1, view 0: JAX's
    file names, and the PNG and depth map JAX's shading, rasterizer and
    writer make of the same posed mesh in the same camera; an empty mesh
    writes a zero image and depth map."""
    calls = []
    real = t_engine.rasterize_mesh

    def recorded(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(t_engine, "rasterize_mesh", recorded)
    if mesh == "empty":
        def empty_frames(eng, ds, cfg, max_items=-1):
            yield ds[0], np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

        monkeypatch.setattr(t_engine, "_posed_mesh_frames", empty_frames)
    frames = cli("--type", "raster", "--cfg_file", "configs/synthetic.yaml",
                 "vis_posed_mesh", "True", "voxel_size", "[0.1, 0.1, 0.1]",
                 "test.num_sampler_ind", "1")
    assert frames == [0]
    root = workdir / "data/raster/synthetic"
    assert sorted(p.name for p in root.iterdir()) == [
        "frame0000_view0000.png", "frame0000_view0000_depth.npy"]
    img, depth = decoded(root / "frame0000_view0000.png"), np.load(
        root / "frame0000_view0000_depth.npy")
    assert img.shape == (128, 128, 3) and depth.shape == (128, 128)
    if mesh == "empty":
        assert not calls and img.max() == 0 and depth.max() == 0
        return
    ((posed, tris, shade, K, R, T, H, W),) = calls
    n_cam = j_mesh.vertex_normals(np.asarray(posed), np.asarray(tris)) @ R.T
    want = j_native.rasterize_mesh_native(
        posed, tris, np.abs(n_cam[:, 2:3]) * np.ones((1, 3), np.float32),
        K, R, T, H, W)
    j_image._write(str(workdir / "jax.png"), want["attr"])
    np.testing.assert_array_equal(img, decoded(workdir / "jax.png"))
    np.testing.assert_array_equal(depth, want["depth"])
    assert 0.05 < (depth > 0).mean() < 0.9 and img.max() > 200


def test_run_evaluate_writes_comparison_pngs(workdir):
    """The port's evaluate writes each scored view's comparison pair
    under result_dir, as JAX's evaluator writes it from the same render
    and ground truth."""
    cfg = load_config("configs/synthetic.yaml", SMALL, run_type="evaluate")
    res = t_engine.run_evaluate(cfg, "cpu", max_items=1)
    (rec,) = res["items"]
    comp = workdir / "data/result/deform/synthetic/comparison"
    names = ["frame0000_view0003.png", "frame0000_view0003_gt.png"]
    assert sorted(p.name for p in comp.iterdir()) == names
    eng = t_engine.Engine(cfg, "cpu")
    eng.load_params()
    item = t_engine.make_dataset(cfg, "test")[0]
    out, _ = eng.render_item(item)
    JImageEvaluator(str(workdir / "jax")).evaluate(
        out["rgb_map"], item["rgb"], item["mask_at_box"], item["H"], item["W"],
        frame_index=0, view_index=3)
    for name in names:
        np.testing.assert_array_equal(decoded(comp / name),
                                      decoded(workdir / "jax/comparison" / name))
    assert rec["psnr"] > 5
