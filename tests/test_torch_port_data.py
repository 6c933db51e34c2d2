"""The port's file-backed data path against the JAX package, on the CPU.

PNGs written to ``tmp_path`` (the ``tests/test_cache.py`` pattern) go
through both packages from one config; every comparison is bit for bit:

* ``HieroDataset`` samples (pil and native backends) on the train split
  with scale, jitter and flip on, over two epochs, and on the val split;
* the native transform core, built here with ``g++`` into
  ``seghiero_torch/build``, against the JAX package's native module and
  the port's plain NumPy versions; a failed build raises (no fallback);
* ``RawCacheDataset`` ``__getitem__`` / ``get_batch`` against the
  uncached dataset and JAX's ``get_batch`` (uint8 and int32 storage, a
  pickle round trip), ``prune_stale`` and the cache CLI;
* ``BatchLoader`` batches, order and tail padding, against JAX's.
"""

import os
import pickle
import time

import numpy as np
import pytest
import yaml
from PIL import Image

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.config import SegHieroConfig as PortConfig
from seghiero_torch.data import native as port_native
from seghiero_torch.data.cache import RawCacheDataset as PortCache
from seghiero_torch.data.cache import main as port_cache_main
from seghiero_torch.data.cache import prune_stale as port_prune_stale
from seghiero_torch.data.dataset import HieroDataset as PortDataset
from seghiero_torch.data.dataset import build_dataset as port_build_dataset
from seghiero_torch.data.pipeline import BatchLoader as PortLoader
from seghiero_torch.data.transforms import JointTransform as PortTransform
from seghiero_tpu.config import SegHieroConfig as JaxConfig
from seghiero_tpu.data import native as jax_native
from seghiero_tpu.data.cache import RawCacheDataset as JaxCache
from seghiero_tpu.data.dataset import HieroDataset as JaxDataset
from seghiero_tpu.data.dataset import build_dataset as jax_build_dataset
from seghiero_tpu.data.pipeline import BatchLoader as JaxLoader

CLASSES = {
    "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
    "fine_names": {i: f"f{i}" for i in range(9)},
}
CLASSES_3LEVEL = {**CLASSES, "super_coarse_to_coarse_map": [[0, 2], [3]],
                  "super_coarse_names": {0: "p", 1: "q"}}


def _write_files(root, n=6, hw=(24, 32), n_classes=9, mode=None):
    rng = np.random.default_rng(3)
    for split in ("train", "val"):
        (root / split / "img").mkdir(parents=True)
        (root / split / "msk").mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 255, (*hw, 3), dtype=np.uint8)
            mask = rng.integers(0, n_classes, hw)
            mask[:2, :2] = 255
            Image.fromarray(img).save(root / split / "img" / f"s{i}.png")
            Image.fromarray(mask.astype(np.int32 if mode else np.uint8), mode=mode).save(
                root / split / "msk" / f"s{i}.png")


def _cfg_dict(tmp_path, classes=CLASSES, cache="none", **transform):
    return {
        "dataset": {
            "root": str(tmp_path / "data"),
            "train": {"image_subdir": "train/img", "mask_subdir": "train/msk"},
            "val": {"image_subdir": "val/img", "mask_subdir": "val/msk"},
            "cache": cache,
            "cache_dir": str(tmp_path / "cache"),
        },
        "classes": classes,
        "transform": {"resize": [16, 20], "hflip_prob": 0.5, "scale_range": [0.5, 2.0],
                      "color_jitter": 0.2, **transform},
        "output": {"checkpoint_dir": str(tmp_path), "project_name": "t"},
    }


def _both(d):
    return JaxConfig.from_dict(d), PortConfig.from_dict(d)


def _equal(a, b, what=""):
    assert set(a) == set(b), what
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, f"{what} {k}"
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{what} {k}")


@pytest.mark.parametrize("backend", ["pil", "native"])
def test_hiero_dataset_samples_match_jax(tmp_path, backend):
    _write_files(tmp_path / "data")
    jcfg, pcfg = _both(_cfg_dict(tmp_path, CLASSES_3LEVEL, backend=backend))
    for split in ("train", "val"):
        jds, pds = JaxDataset(jcfg, split, seed=5), PortDataset(pcfg, split, seed=5)
        assert pds.transform.hflip_prob == (0.5 if split == "train" else 0.0)
        for epoch in (0, 1):
            jds.set_epoch(epoch)
            pds.set_epoch(epoch)
            for i in (0, 3, 5):
                _equal(jds[i], pds[i], f"{split} epoch {epoch} sample {i}")


def test_device_hflip_turns_the_host_flip_off(tmp_path):
    _write_files(tmp_path / "data", n=1)
    _, pcfg = _both(_cfg_dict(tmp_path, device_hflip=True))
    assert port_build_dataset(pcfg, "train").transform.hflip_prob == 0.0
    assert port_build_dataset(pcfg, "val").transform.hflip_prob == 0.0


@pytest.mark.parametrize("src_hw,dst_hw", [((24, 31), (48, 62)), ((97, 130), (33, 41)),
                                           ((16, 16), (16, 16)), ((7, 5), (3, 11))])
def test_native_core_matches_jax_and_plain(src_hw, dst_hw):
    rng = np.random.default_rng(sum(src_hw + dst_hw))
    img = rng.integers(0, 256, (*src_hw, 3), dtype=np.uint8)
    mask = rng.integers(-2, 300, src_hw).astype(np.int32)
    lut = rng.integers(0, 9, 280).astype(np.int32)
    cases = {
        "resize_bilinear_u8": (img, dst_hw),
        "resize_nearest_i32": (mask, dst_hw),
        "hflip_u8": (img,),
        "hflip_i32": (mask,),
        "lut_remap_i32": (mask, lut),
    }
    for name, args in cases.items():
        ours = getattr(port_native, name)(*args)
        plain = getattr(port_native, name + "_plain")(*args)
        theirs = getattr(jax_native, name)(*args)
        for other, what in ((plain, "plain"), (theirs, "jax")):
            assert ours.dtype == other.dtype and ours.shape == other.shape, (name, what)
            np.testing.assert_array_equal(ours, other, err_msg=f"{name} vs {what}")
    assert port_native.library_path().parent.name == "build"


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(port_native, "CXX_FLAGS", port_native.CXX_FLAGS + ["-no-such-flag"])
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*no-such-flag"):
        port_native.hflip_u8(np.zeros((2, 2, 3), np.uint8))
    tf = PortTransform(resize=(4, 4), backend="native")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tf(Image.new("RGB", (8, 8)), np.zeros((8, 8), np.int64), None)
    assert not list((tmp_path / "build").glob("*.so"))


def test_raw_cache_matches_uncached_and_jax(tmp_path):
    _write_files(tmp_path / "data")
    jcfg, pcfg = _both(_cfg_dict(tmp_path, CLASSES_3LEVEL, cache="raw"))
    pcfg_dir, jcache = str(tmp_path / "pcache"), str(tmp_path / "jcache")
    for split in ("train", "val"):
        plain = PortDataset(pcfg, split, seed=2)
        cached = PortCache(PortDataset(pcfg, split, seed=2), cache_dir=pcfg_dir, verbose=False)
        theirs = JaxCache(JaxDataset(jcfg, split, seed=2), cache_dir=jcache, verbose=False)
        assert cached.fine.dtype == np.uint8 and cached.build_seconds is not None
        for epoch in (0, 1):
            for ds in (plain, cached, theirs):
                ds.set_epoch(epoch)
            for i in range(len(plain)):
                _equal(plain[i], cached[i], f"{split} epoch {epoch} item {i}")
            idx = [3, 0, 5]
            batch = cached.get_batch(idx)
            _equal(batch, theirs.get_batch(idx), f"{split} get_batch vs jax")
            assert batch["fine"].dtype == np.uint8
            for j, i in enumerate(idx):
                for k, v in plain[i].items():
                    np.testing.assert_array_equal(batch[k][j].astype(np.int32), v)
        again = PortCache(PortDataset(pcfg, split, seed=2), cache_dir=pcfg_dir, verbose=False)
        assert again.build_seconds is None and again.cache_path == cached.cache_path
        blob = pickle.dumps(cached)
        assert len(blob) < 20_000  # the memmaps reopen from the path
        _equal(pickle.loads(blob).get_batch([1, 2]), cached.get_batch([1, 2]), "pickled")
    # the uncached samples differ once a mask file changes: a new fingerprint
    p = tmp_path / "data" / "train" / "msk" / "s0.png"
    arr = np.asarray(Image.open(p)).copy()
    arr[5:9, 5:9] = 1
    Image.fromarray(arr).save(p)
    rebuilt = PortCache(PortDataset(pcfg, "train", seed=2), cache_dir=pcfg_dir, verbose=False)
    assert rebuilt.cache_path != cached.cache_path and rebuilt.build_seconds is not None


def test_wide_hierarchy_takes_int32_storage_like_jax(tmp_path):
    n_fine = 300
    _write_files(tmp_path / "data", n=3, n_classes=n_fine, mode="I")
    classes = {"coarse_to_fine_map": [[i * 30, i * 30 + 29] for i in range(10)],
               "coarse_names": {i: f"c{i}" for i in range(10)},
               "fine_names": {i: f"f{i}" for i in range(n_fine)}}
    jcfg, pcfg = _both(_cfg_dict(tmp_path, classes, cache="raw"))
    ours = port_build_dataset(pcfg, "train", verbose=False)
    theirs = jax_build_dataset(jcfg, "train", verbose=False)
    assert isinstance(ours, PortCache) and ours.fine.dtype == np.int32
    batch = ours.get_batch([0, 2])
    _equal(batch, theirs.get_batch([0, 2]), "int32 storage vs jax")
    np.testing.assert_array_equal(batch["coarse"],
                                  pcfg.hierarchy.map_fine_labels(batch["fine"], "coarse"))
    _equal(pickle.loads(pickle.dumps(ours)).get_batch([1]), ours.get_batch([1]), "pickled")


def test_prune_stale_sweeps_tmp_dirs_and_stale_caches(tmp_path):
    root = tmp_path / "cacheroot"
    for d in ("raw_train_old", "raw_train_new", "raw_val_x.tmp.999", "raw_val_y.tmp.998",
              "other"):
        (root / d).mkdir(parents=True)
    (root / "raw_train_old" / "meta.json").write_text("{}")
    (root / "raw_train_new" / "meta.json").write_text("{}")
    old = time.time() - 40 * 86400
    os.utime(root / "raw_train_old" / "meta.json", (old, old))
    os.utime(root / "raw_val_x.tmp.999", (old, old))
    os.utime(root / "other", (old, old))
    assert port_prune_stale(str(root)) == 2
    assert sorted(os.listdir(root)) == ["other", "raw_train_new", "raw_val_y.tmp.998"]
    assert port_prune_stale(str(root), older_than_days=0, tmp_older_than_hours=0) == 2
    assert sorted(os.listdir(root)) == ["other"]
    assert port_prune_stale(str(tmp_path / "missing")) == 0


def test_cache_cli_prebuilds_both_splits_and_prunes(tmp_path, capsys):
    _write_files(tmp_path / "data", n=4)
    d = _cfg_dict(tmp_path)  # cache: none in the file; the CLI forces it on
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(d))
    stale = tmp_path / "cache" / "raw_train_gone.tmp.1"
    stale.mkdir(parents=True)
    old = time.time() - 3 * 86400
    os.utime(stale, (old, old))
    assert port_cache_main(["--config", str(path), "--prune-days", "30"]) == 0
    out = capsys.readouterr().out
    assert "train: 4 samples cached" in out and "val: 4 samples cached" in out
    dirs = sorted(os.listdir(tmp_path / "cache"))
    assert [d[:6] for d in dirs] == ["raw_tr", "raw_va"] and not stale.exists()
    for name in dirs:  # the built files are the ones a dataset opens
        assert {"images.u8", "fine.raw", "meta.json"} <= set(os.listdir(tmp_path / "cache" / name))
    cfg = PortConfig.from_dict({**d, "dataset": {**d["dataset"], "cache": "raw"}})
    assert port_build_dataset(cfg, "val", verbose=False).build_seconds is None


def test_batch_loader_matches_jax(tmp_path):
    _write_files(tmp_path / "data", n=5)
    jcfg, pcfg = _both(_cfg_dict(tmp_path, cache="raw"))
    for split, shuffle, drop_last in (("train", True, True), ("val", False, False)):
        jds = jax_build_dataset(jcfg, split, seed=4, include_levels=split == "val",
                                verbose=False)
        pds = port_build_dataset(pcfg, split, seed=4, include_levels=split == "val",
                                 verbose=False)
        for workers in (0, 2):  # get_batch, or a thread pool over __getitem__
            jl = JaxLoader(jds, 2, shuffle=shuffle, drop_last=drop_last, seed=4,
                           num_workers=workers)
            pl = PortLoader(pds, 2, shuffle=shuffle, drop_last=drop_last, seed=4,
                            num_workers=workers)
            for epoch in (0, 1):
                jl.set_epoch(epoch)
                pl.set_epoch(epoch)
                jb, pb = list(jl), list(pl)
                assert len(jb) == len(pb) == len(pl) == (2 if drop_last else 3)
                for a, b in zip(jb, pb):
                    _equal(a, {k: v.numpy() for k, v in b.items()},
                           f"{split} workers {workers} epoch {epoch}")
                if not drop_last:  # the tail pads with sample 0, labels 255
                    assert (pb[-1]["fine"][1:] == 255).all()
                    assert (pb[-1]["coarse"][1:] == 255).all()
