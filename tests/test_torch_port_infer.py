"""The port's inference layer against the JAX package, on the CPU in f32.

One reference-layout ``.pth`` (converted JAX weights, random BN
statistics; depth 18, narrow widths, 64²) of config 5's 3-level hierarchy
(``bench.py:77-81``) goes into both packages:

* ``predict_sliding`` and ``predict_tta`` against the JAX predictor's, and
  the invariants of ``tests/test_sliding.py`` on the port alone;
* ``preprocess_image``, the viz PNG bytes and ``export_masks``'s files;
* the two infer CLIs on the same PNGs of two sizes (batched, and with
  ``--consistent --tta``), and the port CLI's errors;
* checkpoint resolution over the port trainer's directories;
* ``python -m seghiero_torch.train --eval-only``.

Tolerance: masks agree on ≥ 99.9 % of the pixels of each level, and
exactly wherever the JAX side's top-two score gap exceeds 1e-3 (f32
convolutions sum in another order in XLA:CPU and oneDNN; an argmax may
differ only where two scores nearly tie). The JAX side runs its XLA
decode (``argmax_backend: xla``); the port's CLI config takes the fused
decode's plain version (``pallas``), which computes the same function.
"""

import dataclasses
import filecmp
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from test_torch_port_serve import jax_weights_pth, top2_gaps
from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.config import SegHieroConfig as PortConfig
from seghiero_torch.infer import viz as port_viz
from seghiero_torch.infer.__main__ import main as port_infer_main
from seghiero_torch.infer.predictor import Predictor as PortPredictor
from seghiero_torch.infer.predictor import preprocess_image as port_preprocess
from seghiero_torch.models.convert import load_reference_checkpoint
from seghiero_torch.models.segmenter import build_model as port_build_model
from seghiero_torch.train.__main__ import main as port_train_main
from seghiero_torch.train.checkpoint import CheckpointManager
from seghiero_tpu.cli import infer_main as jax_infer_main
from seghiero_tpu.config import SegHieroConfig as JaxConfig
from seghiero_tpu.data.pipeline import normalize_images as jax_normalize
from seghiero_tpu.infer import viz as jax_viz
from seghiero_tpu.infer.predictor import Predictor as JaxPredictor
from seghiero_tpu.infer.predictor import preprocess_image as jax_preprocess
from seghiero_tpu.models.segmenter import build_model as jax_build_model

HW = 64
CLASSES_3L = {
    "super_coarse_to_coarse_map": [[0, 2], [3]],
    "super_coarse_names": {0: "x", 1: "y"},
    "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
    "fine_names": {i: f"f{i}" for i in range(9)},
}
SLICES = {"fine": (0, 9), "coarse": (9, 13), "super": (13, 15)}
SCALES = (0.75, 1.0, 1.25)  # 48², 64² and 80² views: 1.5 and 2.5 times the stride of 32


def _cfg_dict(tmp=None, argmax_backend="xla"):
    d = {
        "classes": CLASSES_3L,
        "model": {"depth": 18, "dtype": "float32", "aspp_channels": 16, "c1_channels": 8,
                  "proj_dim": 8, "depthwise_backend": "pallas",
                  "argmax_backend": argmax_backend},
        "transform": {"resize": [HW, HW]},
    }
    if tmp is not None:
        d["output"] = {"checkpoint_dir": str(tmp / "ckpt"), "project_name": "infer5"}
    return d


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    return jax_weights_pth(str(tmp_path_factory.mktemp("w") / "model.pth"), _cfg_dict())


@pytest.fixture(scope="module")
def predictors(pth):
    """(JAX predictor, port predictor) from the one .pth, both on the XLA /
    library decode."""
    return (JaxPredictor.from_checkpoint(JaxConfig.from_dict(_cfg_dict()), pth),
            PortPredictor.from_checkpoint(PortConfig.from_dict(_cfg_dict()), pth,
                                          device="cpu"))


def _images(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def assert_masks_agree(got, want, scores, consistent=False):
    """≥ 99.9 % per level, and exact where the JAX scores' top-two gap
    exceeds 1e-3 (the fine level's gap for a consistent decode)."""
    gaps = top2_gaps(scores, SLICES)
    assert set(got) == set(want) == set(SLICES)
    for lvl in SLICES:
        g, w = got[lvl], want[lvl]
        assert g.dtype == np.int32 and g.shape == w.shape, (lvl, g.dtype, g.shape, w.shape)
        assert (g == w).mean() >= 0.999, (lvl, (g == w).mean())
        sure = gaps["fine" if consistent else lvl] > 1e-3
        np.testing.assert_array_equal(g[sure], w[sure])


def jax_direct_scores(jp, images, out_hw):
    """The JAX predictor's full-resolution logits ``[B, C, *out_hw]``."""
    return np.asarray(jp._predict(jp.variables, jnp.asarray(images), tuple(out_hw))[1])


def jax_sliding_scores(jp, images, window, stride):
    """The averaged logits the JAX sliding window argmaxes, from its own
    per-window logits."""
    B, H, W = images.shape[:3]
    total = np.zeros((B, 15, H, W), np.float32)
    counts = np.zeros((H, W), np.float32)
    (wh, ww), (sh, sw) = window, stride
    for y0 in range(0, H - wh + 1, sh):
        for x0 in range(0, W - ww + 1, sw):
            tile = images[:, y0:y0 + wh, x0:x0 + ww]
            total[:, :, y0:y0 + wh, x0:x0 + ww] += jax_direct_scores(jp, tile, window)
            counts[y0:y0 + wh, x0:x0 + ww] += 1
    return total / counts


@functools.lru_cache(maxsize=None)
def _jax_tta_program(out_hw):
    """The body of the JAX ``Predictor._tta_program`` at ``SCALES`` with
    flip, returning the summed probabilities it argmaxes."""
    cfg = JaxConfig.from_dict(_cfg_dict())
    model = jax_build_model(cfg)

    @jax.jit
    def run(variables, images_u8):
        B, H, W = images_u8.shape[:3]
        base = jax_normalize(images_u8, cfg.transform.normalize_mean,
                             cfg.transform.normalize_std)
        acc = 0.0
        for s in SCALES:
            hs, ws = max(int(round(H * s)), 32), max(int(round(W * s)), 32)
            view = base if (hs, ws) == (H, W) else jax.image.resize(
                base, (B, hs, ws, 3), "linear", antialias=False)
            for mirrored in (False, True):
                lo = model.apply(variables, view[:, :, ::-1] if mirrored else view,
                                 train=False)["logits"]
                lo = jax.image.resize(jnp.transpose(lo, (0, 3, 1, 2)), (B, 15, *out_hw),
                                      "linear", antialias=False)
                lo = lo[..., ::-1] if mirrored else lo
                acc = acc + jnp.concatenate(
                    [jax.nn.softmax(lo[:, a:b], axis=1) for a, b in SLICES.values()], axis=1)
        return acc

    return run


def jax_tta_scores(jp, images, out_hw):
    return np.asarray(_jax_tta_program(tuple(out_hw))(jp.variables, jnp.asarray(images)))


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("consistent", [False, True], ids=["independent", "consistent"])
def test_predict_sliding_matches_jax(predictors, consistent):
    jp, pp = predictors
    images = _images((2, 64, 96, 3), 3)
    want = jp.predict_sliding(images, window=(64, 64), stride=(32, 32), consistent=consistent)
    got = pp.predict_sliding(images, window=(64, 64), stride=(32, 32), consistent=consistent)
    assert got["fine"].shape == (2, 64, 96)
    assert_masks_agree(got, want, jax_sliding_scores(jp, images, (64, 64), (32, 32)),
                       consistent)


@pytest.mark.parametrize("out_hw", [(64, 64), (48, 80)], ids=["square", "non-square"])
def test_predict_tta_matches_jax(predictors, out_hw):
    jp, pp = predictors
    images = _images((1, HW, HW, 3), 4)  # the CLI's batch of 1: its programs are reused there
    want = jp.predict_tta(images, scales=SCALES, flip=True, out_hw=out_hw)
    got = pp.predict_tta(images, scales=SCALES, flip=True, out_hw=out_hw)
    assert got["super"].shape == (1, *out_hw)
    assert_masks_agree(got, want, jax_tta_scores(jp, images, out_hw))


def test_sliding_and_tta_invariants(predictors):
    """``tests/test_sliding.py``'s invariants on the port: a covering window
    is a direct prediction, an oversized window raises, one scale without
    flip is a direct prediction, and the flip ensemble is mirror
    equivariant."""
    _, pp = predictors
    img = _images((1, HW, HW, 3), 5)
    direct = pp.predict_array(img)
    for got in (pp.predict_sliding(img, window=(HW, HW)),
                pp.predict_tta(img, scales=(1.0,), flip=False)):
        for lvl in SLICES:
            np.testing.assert_array_equal(got[lvl], direct[lvl])
    with pytest.raises(ValueError, match="window"):
        pp.predict_sliding(img[:, :32], window=(HW, HW))
    a = pp.predict_tta(img, scales=(1.0,), flip=True)
    b = pp.predict_tta(img[:, :, ::-1].copy(), scales=(1.0,), flip=True)
    for lvl in SLICES:
        np.testing.assert_array_equal(a[lvl][:, :, ::-1], b[lvl])
    out = pp.predict_sliding(_images((1, 48, 96, 3), 6), window=(32, 32), stride=(16, 16),
                             consistent=True)
    h = pp.cfg.hierarchy
    np.testing.assert_array_equal(out["coarse"], h.fine_to_coarse[out["fine"]])
    np.testing.assert_array_equal(out["super"], h.fine_to_super[out["fine"]])


def test_preprocess_image_matches_jax(tmp_path):
    path = str(tmp_path / "img.png")
    Image.fromarray(_images((50, 70, 3), 7)).save(path)
    for resize in ((HW, HW), None):
        got, got_hw, _ = port_preprocess(path, resize)
        want, want_hw, _ = jax_preprocess(path, resize)
        assert got_hw == want_hw == (50, 70)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_viz_writes_the_same_png_bytes(tmp_path):
    mask = np.random.default_rng(8).integers(-1, 9, (40, 56)).astype(np.int32)
    mask[:10] = 3
    for pkg, viz in (("port", port_viz), ("jax", jax_viz)):
        viz.save_mask(mask.clip(0), str(tmp_path / f"{pkg}_gray.png"))
        color = viz.mask_to_color_image(mask, viz.create_colormap(25))
        viz.draw_class_indices(mask, color).save(str(tmp_path / f"{pkg}_color.png"))
    assert port_viz.create_colormap(25) == jax_viz.create_colormap(25)
    for kind in ("gray", "color"):
        assert filecmp.cmp(tmp_path / f"port_{kind}.png", tmp_path / f"jax_{kind}.png",
                           shallow=False), kind


def test_export_masks_matches_jax(predictors, tmp_path):
    jp, pp = predictors
    preds = {lvl: np.random.default_rng(9).integers(0, b - a, (48, 80)).astype(np.int32)
             for lvl, (a, b) in SLICES.items()}
    want = jp.export_masks(preds, str(tmp_path / "jax"), "img")
    got = pp.export_masks(preds, str(tmp_path / "port"), "img")
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        f"img_{lvl}{sfx}.png" for lvl in SLICES for sfx in ("", "_color")]
    for g, w in zip(got, want):
        assert filecmp.cmp(g, w, shallow=False), g


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cli_setup(pth, tmp_path_factory):
    """PNGs of two sizes, and one YAML per package (the JAX side on its XLA
    decode, the port's on the fused decode's plain version)."""
    root = tmp_path_factory.mktemp("cli")
    images = root / "images"
    images.mkdir()
    for i in range(3):
        Image.fromarray(_images((HW, HW, 3), 10 + i)).save(images / f"a{i}.png")
    for i in range(2):
        Image.fromarray(_images((48, 80, 3), 20 + i)).save(images / f"b{i}.png")
    paths = {}
    for pkg, backend in (("jax", "xla"), ("port", "pallas")):
        paths[pkg] = root / f"{pkg}.yaml"
        paths[pkg].write_text(yaml.safe_dump(_cfg_dict(argmax_backend=backend)))
    return images, paths


@pytest.mark.parametrize("flags", [[], ["--consistent", "--tta"]], ids=["batched", "tta"])
def test_infer_clis_write_the_same_masks(predictors, pth, cli_setup, tmp_path, flags):
    jp, _ = predictors
    images, cfgs = cli_setup
    outs = {}
    for pkg, main in (("jax", jax_infer_main), ("port", port_infer_main)):
        outs[pkg] = tmp_path / pkg
        argv = ["--config", str(cfgs[pkg]), "--image-dir", str(images), "--checkpoint", pth,
                "--batch-size", "2", "--device", "cpu", "--output-dir", str(outs[pkg])]
        assert main(argv + flags) == 0
    names = sorted(os.listdir(images))
    assert sorted(os.listdir(outs["port"])) == sorted(os.listdir(outs["jax"])) == sorted(
        f"{n[:-4]}_{lvl}{sfx}.png" for n in names for lvl in SLICES for sfx in ("", "_color"))
    for n in names:
        arr, orig_hw, _ = jax_preprocess(str(images / n), (HW, HW))
        scores = (jax_tta_scores(jp, arr[None], orig_hw) if flags
                  else jax_direct_scores(jp, arr[None], orig_hw))
        read = {pkg: {lvl: np.asarray(Image.open(out / f"{n[:-4]}_{lvl}.png"), np.int32)[None]
                      for lvl in SLICES} for pkg, out in outs.items()}
        assert_masks_agree(read["port"], read["jax"], scores, consistent=bool(flags))


def test_infer_cli_errors(cli_setup, tmp_path, monkeypatch):
    images, cfgs = cli_setup
    empty = tmp_path / "empty"
    empty.mkdir()
    base = ["--config", str(cfgs["port"]), "--output-dir", str(tmp_path / "out")]
    with pytest.raises(SystemExit):  # as tests/test_cli.py:200
        port_infer_main(base + ["--image-dir", str(empty), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port_infer_main(base + ["--export", str(tmp_path / "art")])
    # no --device: the card, and without one an error, not a CPU run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_infer_main(base + ["--image-dir", str(images)])
    assert not (tmp_path / "out").exists()


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trained_dirs(pth, tmp_path_factory):
    """The .pth saved by the port's ``CheckpointManager`` as its best step
    (beside an older step holding other weights), and an Orbax-like step."""
    tmp = tmp_path_factory.mktemp("dirs")
    cfg = PortConfig.from_dict(_cfg_dict(tmp))
    model = load_reference_checkpoint(port_build_model(cfg),
                                      torch.load(pth, map_location="cpu", weights_only=True))
    other = port_build_model(cfg)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    mgr = CheckpointManager(cfg.output.checkpoint_dir, cfg.output.project_name)
    for step, (m, best) in ((4, (model, True)), (8, (other, False))):
        mgr.save(m, opt, None, step=step, epoch=step // 4, metrics={}, best_val_loss=1.0,
                 config_raw={}, is_best=best)
    (tmp / "orbax" / "step_1" / "state").mkdir(parents=True)
    (tmp / "neither").mkdir()
    return tmp, cfg, mgr


@pytest.mark.parametrize("which", ["pth", "step", "project", "root", "none"])
def test_from_checkpoint_resolves_port_directories(pth, predictors, trained_dirs, which):
    tmp, cfg, mgr = trained_dirs
    checkpoint = {"pth": pth, "step": mgr.step_dir(4), "project": mgr.root,
                  "root": cfg.output.checkpoint_dir, "none": None}[which]
    images = _images((2, HW, HW, 3), 30)
    got = PortPredictor.from_checkpoint(cfg, checkpoint, device="cpu").predict_array(images)
    want = predictors[1].predict_array(images)
    for lvl in SLICES:
        np.testing.assert_array_equal(got[lvl], want[lvl])


def test_from_checkpoint_rejects_orbax_and_unknown_directories(trained_dirs):
    tmp, cfg, _ = trained_dirs
    with pytest.raises(ValueError, match="Orbax"):
        PortPredictor.from_checkpoint(cfg, str(tmp / "orbax" / "step_1"), device="cpu")
    for missing in (str(tmp / "neither"), str(tmp / "missing.pth")):
        with pytest.raises(FileNotFoundError):
            PortPredictor.from_checkpoint(cfg, missing, device="cpu")
    empty = dataclasses.replace(cfg, output=dataclasses.replace(
        cfg.output, checkpoint_dir=str(tmp / "nothing")))
    with pytest.raises(FileNotFoundError, match="No checkpoint found"):
        PortPredictor.from_checkpoint(empty, None, device="cpu")


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("after_fit", [False, True], ids=["fresh", "restored"])
def test_train_eval_only_prints_the_iou_table(tmp_path, capsys, after_fit):
    """``--eval-only`` on the tiny 3-level config of
    ``tests/test_torch_port_train3.py``: the summary and the per-class IoU
    table at every level, from the fresh init or the latest checkpoint
    (whose eval loss it reproduces)."""
    from test_torch_port_train3 import _cfg_dict as train3_cfg

    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(train3_cfg(tmp_path)))
    argv = ["--config", str(path), "--device", "cpu"]
    if after_fit:
        assert port_train_main(argv) == 0
        capsys.readouterr()
    assert port_train_main(argv + ["--eval-only"]) == 0
    out = capsys.readouterr().out
    assert ("No checkpoint found" in out) != after_fit
    assert "Val Loss" in out and "Evaluation complete." in out
    for row in ("| fine ", "| coarse ", "| super ", "| x "):
        assert row in out, row
    if after_fit:  # the restored model reproduces the saved epoch's val loss
        steps = sorted((tmp_path / "port3").glob("step_*"))
        meta = json.loads((steps[-1] / "meta.json").read_text())
        assert f"{meta['metrics']['val_loss']:.4f}" in out
