"""Reference `.pth` checkpoints in the port (compat/torch_export.py,
compat/torch_import.py, tools/import_torch_checkpoint.py) against the
JAX package's compat/ and tools/import_torch_checkpoint.py, on the CPU.

  * export: for the eight volumetric families and the three stage-2
    models (AniNeRF, AlignedLBW, AlignedLBWPDF with `novel_pose_bw`),
    the port's `export_state_dict` of a model's state dict equals JAX's
    of the same weights' flax tree in keys, shapes, dtypes and values,
    without and with a template; the files `save_reference_checkpoint`
    writes hold the same;
  * import: a `.pth` that JAX's `save_reference_checkpoint` wrote (the
    eight families, stage 2), and reference-layout NHR and NT state
    dicts (with the batch norms' counters and the downsamples' filters),
    strict-load into the port, equal to compat/jax_params.py's
    conversion of JAX's converters' trees;
  * the CLI: the tracked AniNeRF checkpoint exported by JAX, imported by
    the port's CLI: its latest.flax reads back through JAX's
    `load_checkpoint` to the same tree, and a tile of the evaluate
    renders bit-equal to the original's; a baseline config is refused;
    a `.pth` that lacks a name, or holds a stray one, is refused with
    and without `--no-verify`, and nothing is written.
"""

import os
import sys

import numpy as np
import pytest
import torch
from flax import serialization

from animatable_nerf_tpu.compat import torch_export as jexp
from animatable_nerf_tpu.compat import torch_import as jimp
from animatable_nerf_tpu.train.checkpoints import load_checkpoint as j_load_checkpoint

from animatable_nerf_tpu_torch.compat import torch_export as texp
from animatable_nerf_tpu_torch.compat.jax_params import nhr_state_dict, nt_state_dict
from animatable_nerf_tpu_torch.compat.torch_import import (
    load_reference_state_dict,
    load_torch_state_dict,
)
from animatable_nerf_tpu_torch.config import load_config
from animatable_nerf_tpu_torch.engine import Engine, make_dataset, make_model
from animatable_nerf_tpu_torch.tools import import_torch_checkpoint
from animatable_nerf_tpu_torch.train.checkpoints import param_codec

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_baselines import _tiny  # noqa: E402

# family: (config, opts)
MODELS = {
    "aninerf": ("configs/synthetic.yaml", []),
    "nerf_pdf": ("configs/synthetic_nerf_pdf.yaml", []),
    "sdf_pdf": ("configs/synthetic_sdf_pdf.yaml", []),
    "neus_pdf": ("configs/synthetic_neus_pdf.yaml", []),
    "aligned_lbw": ("configs/synthetic_aligned_lbw.yaml", []),
    "aligned_pbw": ("configs/synthetic_aligned_pbw.yaml", []),
    "aligned_smpl": ("configs/synthetic_aligned_smpl.yaml", []),
    "aligned_lbw_pdf": ("configs/synthetic_aligned_lbw_pdf.yaml", []),
    "aninerf_stage2": ("configs/synthetic_novel_pose.yaml",
                       ["aninerf_animation", "True"]),
    "aligned_lbw_stage2": ("configs/synthetic_aligned_lbw_novel_pose.yaml",
                           ["aninerf_animation", "True"]),
    "aligned_lbw_pdf_stage2": ("configs/synthetic_aligned_lbw_pdf_novel_pose.yaml",
                               ["aninerf_animation", "True"]),
}
JAX_CONVERTERS = {
    "aninerf": jimp.convert_aninerf, "nerf_pdf": jimp.convert_nerf_pdf,
    "sdf_pdf": jimp.convert_sdf_pdf, "neus_pdf": jimp.convert_neus_pdf,
    "aligned_lbw": jimp.convert_aligned_lbw,
    "aligned_pbw": jimp.convert_aligned_pbw,
    "aligned_smpl": jimp.convert_aligned_smpl,
    "aligned_lbw_pdf": jimp.convert_aligned_lbw_pdf,
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(name, seed=0):
    cfg_file, opts = MODELS[name]
    torch.manual_seed(seed)
    model = make_model(load_config(cfg_file, list(opts)))
    with torch.no_grad():  # every parameter drawn, the scalars off their init
        for p in model.parameters():
            p.copy_(torch.randn(p.shape) * 0.1)
    return model


def _listed(tree):
    """A param tree with flax lists as lists (the port writes them as the
    {"0": ..., "1": ...} dicts a msgpack checkpoint holds)."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(k.isdigit() for k in tree):
        return [_listed(tree[str(i)]) for i in range(len(tree))]
    return {k: _listed(v) for k, v in tree.items()}


def _tree(model):
    return _listed(param_codec(model)[1](dict(model.named_parameters())))


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_export_equals_jax(name, tmp_path):
    model = _model(name)
    family = texp.family_of(model)
    tree, sd = _tree(model), model.state_dict()
    want = jexp.export_state_dict(family, tree)
    _same(texp.export_state_dict(family, sd), want)
    if family == "aligned_pbw":
        _same(texp.export_state_dict(family, sd, num_train_frame=7),
              jexp.export_state_dict(family, tree, num_train_frame=7))
    template = {**{k: np.zeros_like(v) for k, v in want.items()},
                "extra_table.weight": np.ones((3, 2), np.float32)}
    _same(texp.export_state_dict(family, sd, template),
          jexp.export_state_dict(family, tree, template))
    texp.save_reference_checkpoint(str(tmp_path / "port.pth"), family, sd, epoch=3)
    jexp.save_reference_checkpoint(str(tmp_path / "jax.pth"), family, tree, epoch=3)
    got, want = (torch.load(str(tmp_path / f), weights_only=False)
                 for f in ("port.pth", "jax.pth"))
    assert got["epoch"] == want["epoch"] == 3
    _same({k: v.numpy() for k, v in got["net"].items()},
          {k: v.numpy() for k, v in want["net"].items()})


@pytest.mark.parametrize("name", sorted(MODELS))
def test_import_of_jax_pth_equals_jax_conversion(name, tmp_path):
    src = _model(name)
    family = texp.family_of(src)
    path = str(tmp_path / "ref.pth")
    jexp.save_reference_checkpoint(path, family, _tree(src), epoch=5)
    state, epoch = load_torch_state_dict(path)
    assert epoch == 5
    model = _model(name, seed=1)
    load_reference_state_dict(model, state)
    want = param_codec(model)[0](JAX_CONVERTERS[family](state))
    _same({k: v.numpy() for k, v in model.state_dict().items()},
          {k: v.numpy() for k, v in want.items()})


def _reference_layout(sd: dict) -> dict:
    """A port baseline's state dict as the reference's module holds it:
    each batch norm's `num_batches_tracked` and each antialiased
    downsample's `filt` beside the port's names."""
    out = {k: v.clone() for k, v in sd.items()}
    for k in sd:
        if k.endswith(".running_var"):
            out[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
        if ".mpconv.2." in k and k.endswith("0.conv2.weight"):
            out[k.split(".mpconv.2.")[0] + ".mpconv.1.filt"] = torch.ones(4, 1, 3, 3)
    return out


@pytest.mark.parametrize("module", ["nhr", "nt"])
def test_import_of_baseline_state_dicts(module, tmp_path):
    _, make, _, to_state, _ = _tiny(module, 16)
    torch.manual_seed(2)
    src = make()
    with torch.no_grad():
        for p in src.parameters():
            p.copy_(torch.randn(p.shape) * 0.1)
    ref = _reference_layout(src.state_dict())
    assert len(ref) > len(src.state_dict())
    path = str(tmp_path / "ref.pth")
    torch.save({"net": ref, "epoch": 2}, path)
    state, _ = load_torch_state_dict(path)
    model = make()
    load_reference_state_dict(model, state)
    jtree = (jimp.convert_nhr(state, feature_dim=8) if module == "nhr"
             else jimp.convert_nt(state))
    want = (nhr_state_dict if module == "nhr" else nt_state_dict)(jtree)
    _same({k: v.numpy() for k, v in model.state_dict().items()},
          {k: v.numpy() for k, v in want.items()})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_reference_state_dict(model, {**state, "stray.weight": np.zeros(2)})


def _flax(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def test_import_cli_round_trip(tmp_path):
    """The tracked AniNeRF checkpoint -> JAX's reference .pth -> the
    port's CLI -> latest.flax and 9.flax, read back by JAX's
    load_checkpoint to the same tree, and a tile of item 0 rendered
    from it bit-equal to the original's."""
    src_dir = "data/trained_model/deform/synthetic"
    params = _flax(os.path.join(src_dir, "latest.flax"))["params"]
    pth = str(tmp_path / "aninerf.pth")
    jexp.save_reference_checkpoint(pth, "aninerf", params, epoch=9)
    opts = ["trained_model_dir", str(tmp_path / "imported")]
    import_torch_checkpoint.main(["--cfg_file", "configs/synthetic.yaml",
                                  "--pth", pth, *opts])
    out = load_config("configs/synthetic.yaml", opts).trained_model_dir
    assert sorted(os.listdir(out)) == ["9.flax", "latest.flax"]
    got = j_load_checkpoint(out, params)
    assert got[2] == 9 and _flax(os.path.join(out, "latest.flax"))["opt_state"] == {}
    flat = lambda t, p="": ({f"{p}{k}": v for kk, vv in t.items()  # noqa: E731
                             for k, v in flat(vv, f"{p}{kk}/").items()}
                            if isinstance(t, dict) else {p[:-1]: t})
    _same({k: np.asarray(v) for k, v in flat(got[0]).items()},
          {k: np.asarray(v) for k, v in flat(params).items()})
    maps = []
    for extra in ([], opts):
        cfg = load_config("configs/synthetic.yaml", ["eval_tile", "1024", *extra],
                          run_type="evaluate")
        cfg.eval = True
        eng = Engine(cfg, "cpu")
        eng.load_params()
        item = dict(make_dataset(cfg, "test")[0])
        for k in ("ray_o", "ray_d", "near", "far"):
            item[k] = np.asarray(item[k])[:1024]
        maps.append(eng.render_item(item)[0])
    for k in maps[0]:
        np.testing.assert_array_equal(maps[1][k], maps[0][k], err_msg=k)
    assert maps[0]["acc_map"].max() > 0
    with pytest.raises(SystemExit, match="no torch converter"):
        import_torch_checkpoint.main(["--cfg_file", "configs/synthetic_nhr.yaml",
                                      "--pth", pth, "--out", str(tmp_path / "x")])


@pytest.mark.parametrize("flags", [[], ["--no-verify"]])
def test_import_cli_refuses_a_partial_pth(flags, tmp_path):
    """`--no-verify` is the JAX tool's flag and the load stays strict: a
    reference state dict without one of AniNeRF's tensors, or with a
    name the model lacks, raises before any file is written."""
    model = _model("aninerf")
    state = texp.export_state_dict("aninerf", model.state_dict())
    out = tmp_path / "imported"
    dropped = min(model.state_dict())
    for name, net in (("missing", {k: v for k, v in state.items()
                                   if k != dropped}),
                      ("stray", {**state, "stray.weight": np.zeros(2)})):
        pth = str(tmp_path / f"{name}.pth")
        torch.save({"net": {k: torch.as_tensor(v) for k, v in net.items()},
                    "epoch": 3}, pth)
        with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
            import_torch_checkpoint.main(["--cfg_file", "configs/synthetic.yaml",
                                          "--pth", pth, "--out", str(out),
                                          *flags])
        assert not out.exists()
