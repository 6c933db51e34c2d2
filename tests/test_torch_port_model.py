"""The port's model and config against the JAX package.

Same weights, same inputs: a JAX ``HieroSegmenter`` is initialized, its
BatchNorm statistics and affine parameters are replaced by random values
(so eval-mode BN is exercised), its variables are carried across by
``seghiero_torch.models.convert`` and loaded into the port with
``strict=True``; both forward the same f32 images on the CPU.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from seghiero_torch.config import SegHieroConfig as PortConfig
from seghiero_torch.config import load_config as port_load_config
from seghiero_torch.infer.predictor import Predictor, resolve_device
from seghiero_torch.models import heads as port_heads
from seghiero_torch.models.convert import (
    export_reference_checkpoint,
    load_reference_checkpoint,
)
from seghiero_torch.models.segmenter import build_model as port_build_model
from seghiero_tpu.config import SegHieroConfig as JaxConfig
from seghiero_tpu.config import load_config as jax_load_config
from seghiero_tpu.models.segmenter import build_model as jax_build_model
from seghiero_tpu.models.torch_convert import (
    export_reference_checkpoint as jax_export_reference_checkpoint,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 64
CLASSES = {
    "coarse_to_fine_map": [[0, 3], [4, 6], [7], [8]],
    "coarse_names": {0: "a", 1: "b", 2: "c", 3: "d"},
    "fine_names": {i: f"f{i}" for i in range(9)},
}


def _cfg_dict(depth, output_stride, dilations, dw_backend="xla"):
    return {
        "classes": CLASSES,
        "model": {
            "depth": depth, "output_stride": output_stride, "dtype": "float32",
            "aspp_channels": 32, "c1_channels": 8, "proj_dim": 16,
            "dilations": list(dilations), "depthwise_backend": dw_backend,
        },
        "transform": {"resize": [HW, HW]},
    }


def jax_variables(cfg_dict, seed):
    """JAX init with random BN statistics/affine → numpy variables tree."""
    model = jax_build_model(JaxConfig.from_dict(cfg_dict))
    # jitted: an eager init dispatches every layer's ops one by one
    init = jax.jit(lambda key, x: model.init(key, x, train=False))
    variables = init(jax.random.key(seed), jnp.zeros((1, HW, HW, 3)))
    rng = np.random.default_rng(seed)

    def randomize(path, leaf):
        name = str(path[-1].key)
        leaf = np.asarray(leaf)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        return leaf

    return model, jax.tree_util.tree_map_with_path(randomize, jax.device_get(variables))


@pytest.mark.parametrize(
    "depth,output_stride,dilations",
    [(18, 16, (1, 1, 2, 3)), (50, 32, (1, 12, 24, 36))],
)
def test_eval_forward_matches_jax(depth, output_stride, dilations):
    cfg_dict = _cfg_dict(depth, output_stride, dilations)
    jax_model, variables = jax_variables(cfg_dict, seed=depth)
    # depth 50 at 33²: every stride-2 stage gets an odd input (33 → 17 → 9
    # → 5 → 3 → 2, as 769 → 385 → … → 25 in config 4) and the head
    # resizes 2² → 9² at a non-integer ratio
    hw = 33 if depth == 50 else HW
    images = np.random.default_rng(1).standard_normal((2, hw, hw, 3)).astype(np.float32)
    ref = jax.device_get(jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(
        variables, jnp.asarray(images)))

    ckpt = export_reference_checkpoint(variables, depth)
    outs = {}
    for backend in ("xla", "pallas"):
        model = port_build_model(PortConfig.from_dict(_cfg_dict(depth, output_stride,
                                                                dilations, backend)))
        load_reference_checkpoint(model, ckpt).eval()
        with torch.inference_mode():
            out = model(torch.from_numpy(images).permute(0, 3, 1, 2))
        outs[backend] = {k: v.permute(0, 2, 3, 1).numpy() for k, v in out.items()}
        assert set(outs[backend]) == {"logits", "embedding", "aux_logits"}
        for key, want in ref.items():
            got = outs[backend][key]
            assert got.shape == want.shape and got.dtype == np.float32, key
            # f32 convolutions sum in another order in XLA:CPU and oneDNN
            tol = 1e-4 * (1 + np.abs(want).max())
            assert np.abs(got - want).max() <= tol, (backend, key, np.abs(got - want).max())
    # the depthwise kernel's plain version and F.conv2d are the same function
    for key in ref:
        tol = 1e-4 * (1 + np.abs(ref[key]).max())
        assert np.abs(outs["xla"][key] - outs["pallas"][key]).max() <= tol


def test_dilated_depthwise_routes_by_whether_a_backward_is_needed(monkeypatch):
    """With ``depthwise_backend: pallas`` the ASPP's dilated depthwise
    convolutions take the dilated forward (here its plain version) where
    autograd needs no backward from them, and ``F.conv2d`` where it does;
    both give the same values, and the backward still reaches the weight."""
    model = port_build_model(PortConfig.from_dict(_cfg_dict(18, 32, (1, 12, 24, 36), "pallas")))
    dilated = [m for m in model.modules()
               if isinstance(m, port_heads.DepthwiseConv) and m.dilation[0] > 1]
    assert [m.dilation[0] for m in dilated] == [12, 24, 36] and all(m.use_kernel
                                                                   for m in dilated)
    conv = dilated[0]
    routes = []
    kernel, library = port_heads.depthwise3x3_dilated_forward, port_heads.F.conv2d
    monkeypatch.setattr(port_heads, "depthwise3x3_dilated_forward",
                        lambda *a: routes.append("kernel") or kernel(*a))
    monkeypatch.setattr(port_heads.F, "conv2d",
                        lambda *a, **k: routes.append("conv2d") or library(*a, **k))
    x = torch.randn(2, conv.in_channels, 13, 11)

    def route(fn):
        routes.clear()
        out = fn()
        return out, routes[:]

    with torch.inference_mode():
        y_inf, r = route(lambda: conv(x))
    assert r == ["kernel"]
    with torch.no_grad():
        assert route(lambda: conv(x))[1] == ["kernel"]
    xg = x.clone().requires_grad_()
    y_grad, r = route(lambda: conv(xg))
    assert r == ["conv2d"]
    torch.testing.assert_close(y_inf, y_grad.detach(), rtol=1e-5, atol=1e-6)
    y_grad.square().sum().backward()
    assert conv.weight.grad is not None and conv.weight.grad.abs().sum() > 0
    assert xg.grad is not None
    # grad on, but neither the input nor the weight asks for one
    conv.weight.requires_grad_(False)
    assert route(lambda: conv(x))[1] == ["kernel"]


def test_outputs_argument_skips_unused_heads():
    cfg = PortConfig.from_dict(_cfg_dict(18, 32, (1, 12, 24, 36)))
    model = port_build_model(cfg).eval()
    x = torch.zeros(1, 3, HW, HW)
    with torch.inference_mode():
        assert set(model(x, outputs=("logits",))) == {"logits"}
        assert set(model(x, outputs=("embedding", "aux_logits"))) == {"embedding", "aux_logits"}
    with pytest.raises(ValueError, match="unknown outputs"):
        model(x, outputs=("masks",))


def test_convert_equals_jax_export():
    """The port's own copy of the weight conversion writes exactly what the
    JAX package's exporter writes."""
    cfg_dict = _cfg_dict(18, 32, (1, 12, 24, 36))
    _, variables = jax_variables(cfg_dict, seed=3)
    ours = export_reference_checkpoint(variables, 18)
    theirs = jax_export_reference_checkpoint(variables, 18)
    for part in ("backbone_state_dict", "aspp_head_state_dict", "aux_head_state_dict"):
        assert set(ours[part]) == set(theirs[part]), part
        for k, v in ours[part].items():
            assert torch.equal(v, theirs[part][k]), (part, k)
    # and it loads strictly into the port's model (every key lines up)
    model = port_build_model(PortConfig.from_dict(cfg_dict))
    load_reference_checkpoint(model, theirs)


@pytest.mark.parametrize(
    "path",
    sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
    + [os.path.join(ROOT, "example-config.yaml")],
    ids=os.path.basename,
)
def test_configs_parse_to_equal_values(path):
    jc, pc = jax_load_config(path), port_load_config(path)
    for section in ("dataset", "model", "training", "transform", "output"):
        assert dataclasses.asdict(getattr(jc, section)) == dataclasses.asdict(
            getattr(pc, section)
        ), section
    jh, ph = jc.hierarchy, pc.hierarchy
    assert (jh.n_fine, jh.n_coarse, jh.n_super) == (ph.n_fine, ph.n_coarse, ph.n_super)
    assert jh.level_slices == ph.level_slices
    np.testing.assert_array_equal(jh.fine_to_coarse, ph.fine_to_coarse)
    if jh.has_super:
        np.testing.assert_array_equal(jh.fine_to_super, ph.fine_to_super)


def test_hopper_serving_config_selects_both_kernels():
    cfg = port_load_config(os.path.join(ROOT, "configs", "example-serving-hopper.yaml"))
    assert (cfg.model.depthwise_backend, cfg.model.argmax_backend) == ("pallas", "pallas")
    assert (cfg.model.depth, cfg.model.aspp_channels, cfg.transform.resize) == (50, 512, (512, 512))


@pytest.mark.parametrize(
    "section,key,value",
    [("model", "stem", "s2d"),
     ("training", "compiler_options", {"xla_tpu_scoped_vmem_limit_kib": "65536"}),
     ("training", "steps_per_dispatch", 4)],
)
def test_tpu_only_options_raise(section, key, value):
    d = {"classes": CLASSES, section: {key: value}}
    JaxConfig.from_dict(d)  # valid for the JAX package
    with pytest.raises(ValueError, match="TPU|XLA"):
        PortConfig.from_dict(d)


def test_unported_families_raise_not_implemented():
    for model in ({"backbone": "convnext"}, {"head": "aspp"}):
        cfg = PortConfig.from_dict({"classes": CLASSES, "model": model})
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            port_build_model(cfg)


def test_entry_points_raise_without_a_card(monkeypatch):
    """No silent CPU run: without a card the default device raises, and the
    CPU is used only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PortConfig.from_dict(_cfg_dict(18, 32, (1, 12, 24, 36)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, device="cuda")
    assert Predictor(cfg, device="cpu").device.type == "cpu"


def test_orbax_checkpoint_directory_raises(tmp_path):
    """An Orbax step directory (it holds ``state/``) raises with the way to
    convert it; a missing file, and a config whose project holds no
    checkpoint (``None``), raise ``FileNotFoundError``."""
    cfg = PortConfig.from_dict(dict(_cfg_dict(18, 32, (1, 12, 24, 36)), output={
        "checkpoint_dir": str(tmp_path / "ckpt"), "project_name": "p"}))
    (tmp_path / "step_1" / "state").mkdir(parents=True)
    with pytest.raises(ValueError, match="Orbax"):
        Predictor.from_checkpoint(cfg, str(tmp_path / "step_1"), device="cpu")
    for ckpt in (str(tmp_path / "missing.pth"), None):
        with pytest.raises(FileNotFoundError):
            Predictor.from_checkpoint(cfg, ckpt, device="cpu")
