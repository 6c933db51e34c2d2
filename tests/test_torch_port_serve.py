"""The port's predictor and HTTP server against the JAX package.

One reference-layout ``.pth`` (converted JAX weights, random BN
statistics) per hierarchy — 2 levels, and the 3 levels of config 5
(``bench.py:77-81``) — is loaded through both packages'
``Predictor.from_checkpoint``; their masks must agree. Then the port's
``ServingModel`` + ``make_server`` answer over a real socket on an
ephemeral port.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.config import SegHieroConfig as PortConfig
from seghiero_torch.data.transforms import resize_mask_nearest
from seghiero_torch.infer.predictor import Predictor as PortPredictor
from seghiero_torch.models.convert import export_reference_checkpoint
from seghiero_torch.serve import MicroBatcher, ServingModel, make_server
from seghiero_tpu.config import SegHieroConfig as JaxConfig
from seghiero_tpu.infer.predictor import Predictor as JaxPredictor
from seghiero_tpu.models.segmenter import build_model as jax_build_model

HW = 64
CFG = {
    "classes": {
        "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
        "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
        "fine_names": {i: f"f{i}" for i in range(9)},
    },
    "model": {"depth": 18, "dtype": "float32", "aspp_channels": 16,
              "c1_channels": 8, "proj_dim": 8},
    "transform": {"resize": [HW, HW]},
}
SLICES = {"fine": (0, 9), "coarse": (9, 13)}
# config 5's hierarchy: 9 fine, 4 coarse and 2 super classes
CFG3 = dict(CFG, classes=dict(CFG["classes"], super_coarse_to_coarse_map=[[0, 2], [3]],
                              super_coarse_names={0: "x", 1: "y"}))
SLICES3 = dict(SLICES, super=(13, 15))


def _cfg(cls, argmax_backend, base=CFG):
    d = dict(base, model=dict(base["model"], depthwise_backend=argmax_backend,
                              argmax_backend=argmax_backend))
    return cls.from_dict(d)


def jax_weights_pth(path, cfg_dict, hw=HW, seed=5):
    """Converted JAX weights (random BN statistics) of ``cfg_dict``'s model
    (depth 18), saved as a reference .pth at ``path``."""
    model = jax_build_model(JaxConfig.from_dict(cfg_dict))
    # jitted: an eager init dispatches every layer's ops one by one
    init = jax.jit(lambda key, x: model.init(key, x, train=False))
    variables = jax.device_get(init(jax.random.key(seed), jnp.zeros((1, hw, hw, 3))))
    rng = np.random.default_rng(seed)

    def randomize(path, leaf):
        name = str(path[-1].key)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, np.shape(leaf)).astype(np.float32)
        if name in ("bias", "mean"):
            return (rng.standard_normal(np.shape(leaf)) * 0.1).astype(np.float32)
        return np.asarray(leaf)

    variables = jax.tree_util.tree_map_with_path(randomize, variables)
    torch.save(export_reference_checkpoint(variables, 18), path)
    return path


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    return jax_weights_pth(str(tmp_path_factory.mktemp("ckpt") / "model.pth"), CFG)


@pytest.fixture(scope="module")
def pth3(tmp_path_factory):
    return jax_weights_pth(str(tmp_path_factory.mktemp("ckpt3") / "model.pth"), CFG3)


@pytest.mark.parametrize("backend,levels", [("xla", 2), ("pallas", 2), ("xla", 3), ("pallas", 3)],
                         ids=["xla", "pallas", "xla-3level", "pallas-3level"])
def test_predict_array_matches_jax_from_one_pth(request, backend, levels):
    base, slices = (CFG, SLICES) if levels == 2 else (CFG3, SLICES3)
    pth = request.getfixturevalue("pth" if levels == 2 else "pth3")
    jp = JaxPredictor.from_checkpoint(_cfg(JaxConfig, backend, base), pth)
    pp = PortPredictor.from_checkpoint(_cfg(PortConfig, backend, base), pth, device="cpu")
    images = np.random.default_rng(2).integers(0, 256, (3, HW, HW, 3)).astype(np.uint8)
    # the top-2 logit gap of every pixel, from the JAX full-res logits
    _, logits = jp._predict(jp.variables, jnp.asarray(images), (HW, HW))
    gaps = top2_gaps(np.asarray(logits), slices)
    for consistent in (False, True):
        want = jp.predict_array(images, consistent=consistent)
        got = pp.predict_array(images, consistent=consistent)
        assert set(got) == set(want) == set(slices)
        for lvl in slices:
            g, w = got[lvl], want[lvl]
            assert g.dtype == np.int32 and g.shape == w.shape == (3, HW, HW)
            # f32 convolutions sum in another order in XLA:CPU and oneDNN:
            # argmax may differ only where the top two logits nearly tie
            assert (g == w).mean() >= 0.999, (lvl, consistent, (g == w).mean())
            sure = gaps["fine" if consistent else lvl] > 1e-3
            np.testing.assert_array_equal(g[sure], w[sure])


def top2_gaps(logits, slices):
    """Per level, the gap between the top two scores of every pixel of
    C-major ``logits`` [B, C, H, W]."""
    gaps = {}
    for lvl, (a, b) in slices.items():
        top2 = np.sort(logits[:, a:b], axis=1)[:, -2:]
        gaps[lvl] = top2[:, 1] - top2[:, 0]
    return gaps


def _serve(pred):
    """(base url, port predictor) of a running port server, shut down after."""
    server = make_server(ServingModel(pred), host="127.0.0.1", port=0,
                         max_batch=4, batch_timeout_ms=30.0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", pred
    server.shutdown()
    server.batcher.stop()
    server.server_close()
    t.join(timeout=30)


@pytest.fixture(scope="module")
def served(pth):
    yield from _serve(PortPredictor.from_checkpoint(_cfg(PortConfig, "pallas"), pth,
                                                    device="cpu"))


@pytest.fixture(scope="module")
def served3(pth3):
    yield from _serve(PortPredictor.from_checkpoint(_cfg(PortConfig, "pallas", CFG3), pth3,
                                                    device="cpu"))


def _post(url, body, ctype="application/octet-stream"):
    req = urllib.request.Request(url, data=body, method="POST")
    req.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _check_healthz_and_meta(url, slices, levels):
    assert _get(url + "/healthz") == {"status": "ok", "platform": "cpu", "device": "cpu"}
    meta = _get(url + "/meta")
    assert meta["input"] == {"shape": ["b", HW, HW, 3], "dtype": "uint8", "layout": "NHWC (RGB)"}
    assert meta["outputs"] == {lvl: {"shape": ["b", HW, HW], "dtype": "uint8"} for lvl in slices}
    assert meta["levels"] == levels
    assert meta["class_names"]["coarse"] == ["a", "b", "c", "d"]
    assert meta["consistent_decode"] is False and meta["input_sizes"] == [[HW, HW]]


def test_healthz_and_meta(served):
    _check_healthz_and_meta(served[0], SLICES, {"fine": 9, "coarse": 4})


def test_healthz_and_meta_three_levels(served3):
    """Config 5's hierarchy: ``/meta`` lists the super level and its names."""
    url, _ = served3
    _check_healthz_and_meta(url, SLICES3, {"fine": 9, "coarse": 4, "super": 2})
    assert _get(url + "/meta")["class_names"]["super"] == ["x", "y"]


def test_predict_json_npz_png(served):
    from PIL import Image

    url, pred = served
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (HW, HW, 3)).astype(np.uint8)
    want = pred.predict_array(img[None])

    status, body, ctype = _post(url + "/predict", _npy(img))
    assert status == 200 and ctype == "application/json"
    got = json.loads(body)
    for lvl in SLICES:
        np.testing.assert_array_equal(np.asarray(got[lvl]), want[lvl][0])

    status, body, ctype = _post(url + "/predict?format=npz", _npy(img))
    assert status == 200 and ctype == "application/octet-stream"
    with np.load(io.BytesIO(body)) as z:
        for lvl in SLICES:
            assert z[lvl].dtype == np.uint8
            np.testing.assert_array_equal(z[lvl], want[lvl][0])

    # a larger PNG: resized to the model's size, the mask comes back at 96²
    big = rng.integers(0, 256, (96, 96, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(big).save(buf, format="PNG")
    status, body, ctype = _post(url + "/predict?format=png&level=coarse",
                                buf.getvalue(), "image/png")
    assert status == 200 and ctype == "image/png"
    mask = np.asarray(Image.open(io.BytesIO(body)))
    resized = np.asarray(Image.fromarray(big).resize((HW, HW), Image.BILINEAR), np.uint8)
    np.testing.assert_array_equal(
        mask, resize_mask_nearest(pred.predict_array(resized[None])["coarse"][0], (96, 96))
    )


def test_concurrent_requests_are_microbatched(served):
    url, pred = served
    imgs = np.random.default_rng(3).integers(0, 256, (8, HW, HW, 3)).astype(np.uint8)
    want = pred.predict_array(imgs)
    results = [None] * 8
    before = _get(url + "/stats")

    def call(i):
        status, body, _ = _post(url + "/predict?format=npz", _npy(imgs[i]))
        if status == 200:
            with np.load(io.BytesIO(body)) as z:
                results[i] = {k: z[k] for k in z.files}

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i in range(8):
        assert results[i] is not None, i
        for lvl in SLICES:
            np.testing.assert_array_equal(results[i][lvl], want[lvl][i])
    after = _get(url + "/stats")
    n_requests = after["requests"] - before["requests"]
    n_batches = after["batches"] - before["batches"]
    assert n_requests == 8
    assert n_batches < 8  # coalesced (max_batch 4 → at least 2 batches)
    assert max(int(k) for k in after["batch_sizes"]) > 1


def test_bad_body_gives_400_and_server_survives(served):
    url, _ = served
    status, body, _ = _post(url + "/predict", _npy(np.zeros((4, 4), np.uint8)))
    assert status == 400 and "npy must be" in json.loads(body)["error"]
    status, _, _ = _post(url + "/predict", b"not an image", "image/png")
    assert status == 400
    status, _, _ = _post(url + "/nowhere", b"")
    assert status == 404
    assert _get(url + "/healthz")["status"] == "ok"


def test_dispatcher_warms_up_on_the_thread_that_serves():
    """cuDNN keeps its execution plans per thread: the warm-up must run on
    the dispatcher, before the constructor returns; a failed warm-up
    raises there."""

    class Recorder:
        def __init__(self, fail=False):
            self.fail, self.threads = fail, []

        def warmup(self, max_batch):
            self.threads.append(("warmup", max_batch, threading.current_thread()))
            if self.fail:
                raise ValueError("no card")

        def predict(self, images):
            self.threads.append(("predict", len(images), threading.current_thread()))
            return {"fine": images[..., 0]}

    model = Recorder()
    batcher = MicroBatcher(model, max_batch=3, batch_timeout_s=0.01)
    try:
        assert model.threads == [("warmup", 3, batcher.thread)]
        out = batcher.submit(np.full((2, 2, 3), 7, np.uint8), timeout_s=30)
        np.testing.assert_array_equal(out["fine"], np.full((2, 2), 7, np.uint8))
        assert model.threads[1] == ("predict", 1, batcher.thread)
    finally:
        batcher.stop()
    assert not batcher.thread.is_alive()
    with pytest.raises(RuntimeError, match="warm-up") as info:
        MicroBatcher(Recorder(fail=True), max_batch=2)
    assert isinstance(info.value.__cause__, ValueError)
