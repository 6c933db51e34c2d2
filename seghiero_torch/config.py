"""Validated configuration — the port's own copy of ``seghiero_tpu/config.py``.

One YAML file drives both packages: the sections (``dataset``,
``classes``, ``model``, ``training``, ``transform``, ``output``), the
fields, their defaults and their checks are the JAX package's, so a
config parses to equal values in both (tests/test_torch_port_model.py
holds them together on the shipped configs). Field documentation lives
in the JAX package's module; this copy notes only where the port reads a
field differently:

* ``model.depthwise_backend`` / ``model.argmax_backend``: ``xla`` means
  the PyTorch library op (``F.conv2d(groups=C)``, ``F.interpolate`` +
  ``argmax``), ``pallas`` means the port's hand-written CUDA kernel
  (``seghiero_torch/csrc``).
* Options that exist only for the TPU raise ``ValueError`` here:
  ``model.stem: s2d``, ``training.compiler_options`` and
  ``training.steps_per_dispatch`` other than 1.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import yaml

from seghiero_torch.hierarchy import Hierarchy

_KNOWN_SECTIONS = {"dataset", "classes", "model", "training", "transform", "output"}


def _as_tuple2(v, name) -> Optional[Tuple[int, int]]:
    if v is None:
        return None
    if not (isinstance(v, (list, tuple)) and len(v) == 2):
        raise ValueError(f"{name} must be a [H, W] pair, got {v!r}")
    return (int(v[0]), int(v[1]))


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    root: str = ""
    train_image_subdir: str = ""
    train_mask_subdir: str = ""
    val_image_subdir: str = ""
    val_mask_subdir: str = ""
    kind: str = "files"  # "files" | "synthetic"
    synthetic_size: int = 64
    cache: str = "none"  # "none" | "raw"
    cache_dir: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "DatasetConfig":
        cache = str(d.get("cache", "none"))
        if cache not in ("none", "raw"):
            raise ValueError(f"dataset.cache must be none|raw, got {cache!r}")
        cache_dir = d.get("cache_dir")
        if d.get("kind", "files") == "synthetic":
            return cls(kind="synthetic", synthetic_size=int(d.get("synthetic_size", 64)))

        def sub(split, key):
            return str(d.get(split, {}).get(key, "")).lstrip("/\\")

        return cls(
            root=str(d.get("root", "")),
            train_image_subdir=sub("train", "image_subdir"),
            train_mask_subdir=sub("train", "mask_subdir"),
            val_image_subdir=sub("val", "image_subdir"),
            val_mask_subdir=sub("val", "mask_subdir"),
            cache=cache,
            cache_dir=str(cache_dir) if cache_dir else None,
        )

    def image_dir(self, split: str) -> str:
        sub = self.train_image_subdir if split == "train" else self.val_image_subdir
        return os.path.join(self.root, sub)

    def mask_dir(self, split: str) -> str:
        sub = self.train_mask_subdir if split == "train" else self.val_mask_subdir
        return os.path.join(self.root, sub)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    pretrained_model: str = "resnet-101"
    depth: int = 101
    pretrained: Any = False
    head: str = "sep_aspp_contrast"
    backbone: str = "resnet"
    backbone_options: Any = None
    head_options: Any = None
    output_stride: int = 32
    stem: str = "conv7"  # the port implements conv7 only
    in_channels: int = 2048
    c1_in_channels: int = 256
    c1_channels: int = 48
    aspp_channels: int = 512
    dilations: Tuple[int, ...] = (1, 12, 24, 36)
    proj_dim: int = 256
    proj_type: str = "convmlp"
    dtype: str = "bfloat16"
    remat: bool = False
    # "xla" = F.conv2d(groups=C); "pallas" = csrc/depthwise3x3.cu for the
    # 3×3 / stride-1 / dilation-1 case (dilated convs always take F.conv2d)
    depthwise_backend: str = "xla"
    # "xla" = F.interpolate + argmax; "pallas" = csrc/upsample_argmax.cu
    # for an exact 4× output (other sizes always take F.interpolate)
    argmax_backend: str = "xla"

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        d = dict(d or {})
        depth = d.get("depth")
        name = str(d.get("pretrained_model", "resnet-101"))
        if depth is None:
            tail = name.rsplit("-", 1)[-1].replace("resnet", "")
            depth = int(tail) if tail.isdigit() else 101
        depth = int(depth)
        backbone = str(d.get("backbone", "resnet"))
        if backbone == "resnet" and depth not in (18, 34, 50, 101, 152):
            raise ValueError(f"model.depth must be one of 18/34/50/101/152, got {depth}")
        c4 = 512 if depth in (18, 34) else 2048
        c1 = 64 if depth in (18, 34) else 256
        head = str(d.get("head", "sep_aspp_contrast"))
        output_stride = int(d.get("output_stride", 32))
        if output_stride not in (8, 16, 32):
            raise ValueError(f"model.output_stride must be 8|16|32, got {output_stride}")
        stem = str(d.get("stem", "conv7"))
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"model.stem must be conv7|s2d, got {stem}")
        if stem == "s2d":
            raise ValueError(
                "model.stem: s2d is a TPU-only rewrite of the 7×7 stem; the "
                "PyTorch port runs the plain conv7 stem (same weights) — "
                "remove the key or set stem: conv7"
            )
        dw_backend = str(d.get("depthwise_backend", "xla"))
        if dw_backend not in ("xla", "pallas"):
            raise ValueError(
                f"model.depthwise_backend must be xla|pallas, got {dw_backend}"
            )
        am_backend = str(d.get("argmax_backend", "xla"))
        if am_backend not in ("xla", "pallas"):
            raise ValueError(
                f"model.argmax_backend must be xla|pallas, got {am_backend}"
            )
        return cls(
            pretrained_model=name,
            depth=depth,
            pretrained=d.get("pretrained", False),
            head=head,
            backbone=backbone,
            backbone_options=dict(d.get("backbone_options") or {}),
            head_options=dict(d.get("head_options") or {}),
            output_stride=output_stride,
            stem=stem,
            in_channels=int(d.get("in_channels", c4)),
            c1_in_channels=int(d.get("c1_in_channels", c1)),
            c1_channels=int(d.get("c1_channels", 48)),
            aspp_channels=int(d.get("aspp_channels", 512)),
            dilations=tuple(d.get("dilations", (1, 12, 24, 36))),
            proj_dim=int(d.get("proj_dim", 256)),
            proj_type=str(d.get("proj_type", "convmlp")),
            dtype=str(d.get("dtype", "bfloat16")),
            remat=bool(d.get("remat", False)),
            depthwise_backend=dw_backend,
            argmax_backend=am_backend,
        )


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    epochs: int = 1
    batch_size: int = 8
    lr: float = 1e-3
    fine_weight: float = 1.0
    num_workers: int = 4
    loader: str = "thread"
    momentum: float = 0.9
    weight_decay: float = 1e-4
    optimizer: str = "sgd"
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    grad_accum_steps: int = 1
    grad_clip_norm: Optional[float] = None
    wd_skip_norm_bias: bool = False
    backbone_lr_scale: float = 1.0
    early_stop_patience: Optional[int] = None
    aux_weight: float = 0.4
    rmi_radius: int = 3
    rmi_pool_way: int = 0
    rmi_pool_size: int = 3
    rmi_pool_stride: int = 3
    rmi_streaming: str = "auto"
    rmi_backend: str = "auto"
    rmi_precision: str = "parity"
    hiera_precision: str = "fast"
    triplet_schedule_unit: str = "step"
    triplet_upper_ids: Optional[Sequence[int]] = None
    triplet_lower_ids: Optional[Sequence[int]] = None
    triplet_selection: str = "auto"
    ohem_thresh: Optional[float] = None
    ohem_min_kept: int = 100_000
    hiera_variant: str = "bce"
    focal_gamma: float = 2.0
    seed: int = 0
    log_every: int = 50
    mesh: Dict[str, int] = dataclasses.field(default_factory=lambda: {"data": -1})
    parallel_mode: str = "pjit"
    param_sharding: str = "replicated"
    tensor_shards: int = 1
    sync_bn: bool = False
    lr_schedule: Optional[Dict[str, Any]] = None
    donate_state: bool = True
    compiler_options: Optional[Dict[str, Any]] = None  # TPU only: rejected
    steps_per_dispatch: int = 1  # TPU only: values other than 1 rejected
    ema_decay: float = 0.0
    spatial_shards: int = 1
    fast_losses: bool = True
    extra_losses: Sequence[Dict[str, Any]] = ()
    debug_nans: bool = False
    pallas_fused_loss: bool = False
    device: Optional[str] = None
    gpus: Optional[Sequence[int]] = None

    @classmethod
    def from_dict(cls, d: dict) -> "TrainingConfig":
        d = dict(d or {})
        if "learning_rate" in d:
            d.setdefault("lr", d.pop("learning_rate"))
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        hiera_precision_explicit = "hiera_precision" in kwargs
        out = cls(**kwargs)
        if (
            not hiera_precision_explicit
            and out.hiera_precision == "fast"
            and (not out.fast_losses or out.pallas_fused_loss)
        ):
            out = dataclasses.replace(out, hiera_precision="parity")
        if out.rmi_pool_size != out.rmi_pool_stride:
            raise ValueError("rmi_pool_size must equal rmi_pool_stride")
        if out.triplet_schedule_unit not in ("step", "epoch"):
            raise ValueError("triplet_schedule_unit must be 'step' or 'epoch'")
        if out.triplet_selection not in ("auto", "mask", "sorted"):
            raise ValueError(
                "triplet_selection must be 'auto', 'mask' or 'sorted'"
            )
        if (out.triplet_upper_ids is None) != (out.triplet_lower_ids is None):
            raise ValueError(
                "triplet_upper_ids and triplet_lower_ids must be set "
                "together (both or neither)"
            )
        if out.triplet_upper_ids is not None:
            out = dataclasses.replace(
                out,
                triplet_upper_ids=tuple(int(i) for i in out.triplet_upper_ids),
                triplet_lower_ids=tuple(int(i) for i in out.triplet_lower_ids),
            )
        if out.ohem_thresh is not None and not (0.0 < out.ohem_thresh <= 1.0):
            raise ValueError("ohem_thresh must be in (0, 1]")
        if out.ohem_min_kept < 0:
            raise ValueError("ohem_min_kept must be >= 0")
        if out.parallel_mode not in ("pjit", "ddp"):
            raise ValueError("parallel_mode must be 'pjit' or 'ddp'")
        if out.param_sharding not in ("replicated", "fsdp"):
            raise ValueError("param_sharding must be 'replicated' or 'fsdp'")
        if out.param_sharding == "fsdp" and out.parallel_mode != "pjit":
            raise ValueError("param_sharding: fsdp requires parallel_mode: pjit")
        if out.rmi_streaming not in ("auto", "on", "off"):
            raise ValueError("rmi_streaming must be 'auto', 'on' or 'off'")
        if out.rmi_backend not in ("auto", "pallas", "xla"):
            raise ValueError("rmi_backend must be 'auto', 'pallas' or 'xla'")
        if out.rmi_precision not in ("parity", "fast"):
            raise ValueError("rmi_precision must be 'parity' or 'fast'")
        if out.hiera_precision not in ("parity", "fast"):
            raise ValueError("hiera_precision must be 'parity' or 'fast'")
        if out.hiera_precision == "fast" and not out.fast_losses:
            raise ValueError("hiera_precision: fast requires fast_losses: true")
        if out.hiera_precision == "fast" and out.pallas_fused_loss:
            raise ValueError(
                "hiera_precision: fast and pallas_fused_loss are mutually exclusive"
            )
        if out.loader not in ("thread", "grain"):
            raise ValueError("loader must be 'thread' or 'grain'")
        if out.hiera_variant not in ("bce", "focal"):
            raise ValueError("hiera_variant must be 'bce' or 'focal'")
        if out.optimizer not in ("sgd", "adamw"):
            raise ValueError("optimizer must be 'sgd' or 'adamw'")
        if out.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        if out.backbone_lr_scale < 0:
            raise ValueError("backbone_lr_scale must be >= 0")
        if out.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if out.steps_per_dispatch != 1:
            raise ValueError(
                "training.steps_per_dispatch folds steps into one TPU "
                "dispatch; the PyTorch port runs one step per call — remove "
                "the key or set it to 1"
            )
        if out.spatial_shards < 1:
            raise ValueError("spatial_shards must be >= 1")
        if not (0.0 <= out.ema_decay < 1.0):
            raise ValueError("ema_decay must be in [0, 1)")
        if out.tensor_shards < 1:
            raise ValueError("tensor_shards must be >= 1")
        if out.compiler_options is not None:
            raise ValueError(
                "training.compiler_options are XLA TPU compiler flags; the "
                "PyTorch port has no XLA compiler to pass them to — remove "
                "the key"
            )
        if out.tensor_shards > 1 and out.parallel_mode != "pjit":
            raise ValueError("tensor_shards > 1 requires parallel_mode: pjit")
        if out.tensor_shards > 1 and out.spatial_shards > 1:
            raise ValueError("enable at most one of tensor_shards and spatial_shards")
        if out.spatial_shards > 1 and out.parallel_mode != "pjit":
            raise ValueError("spatial_shards > 1 requires parallel_mode: pjit")
        norm_extras = []
        for spec in out.extra_losses or ():
            spec = dict(spec)
            if spec.get("type") not in ("dice", "lovasz"):
                raise ValueError(
                    "extra_losses[].type must be 'dice' or 'lovasz', got "
                    f"{spec.get('type')!r}"
                )
            if spec.get("level", "fine") not in ("fine", "coarse", "super"):
                raise ValueError(
                    "extra_losses[].level must be 'fine', 'coarse' or "
                    f"'super', got {spec.get('level')!r}"
                )
            spec.setdefault("level", "fine")
            spec["weight"] = float(spec.get("weight", 1.0))
            if spec["weight"] <= 0:
                raise ValueError("extra_losses[].weight must be > 0")
            norm_extras.append(spec)
        object.__setattr__(out, "extra_losses", tuple(norm_extras))
        return out


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    resize: Optional[Tuple[int, int]] = None  # (H, W)
    hflip_prob: float = 0.5
    normalize_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    normalize_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    backend: str = "pil"
    scale_range: Optional[Tuple[float, float]] = None
    color_jitter: float = 0.0
    device_hflip: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "TransformConfig":
        d = dict(d or {})
        backend = str(d.get("backend", "pil"))
        if backend not in ("pil", "native"):
            raise ValueError(f"transform.backend must be pil|native, got {backend}")
        scale_range = d.get("scale_range")
        if scale_range is not None:
            scale_range = tuple(float(x) for x in scale_range)
            if len(scale_range) != 2 or not (0 < scale_range[0] <= scale_range[1]):
                raise ValueError(
                    "transform.scale_range must be [lo, hi] with 0 < lo <= hi"
                )
        color_jitter = float(d.get("color_jitter", 0.0))
        if not (0.0 <= color_jitter < 1.0):
            raise ValueError("transform.color_jitter must be in [0, 1)")
        return cls(
            resize=_as_tuple2(d.get("resize"), "transform.resize"),
            hflip_prob=float(d.get("hflip_prob", 0.5)),
            normalize_mean=tuple(d.get("normalize_mean", (0.485, 0.456, 0.406))),
            normalize_std=tuple(d.get("normalize_std", (0.229, 0.224, 0.225))),
            backend=backend,
            scale_range=scale_range,
            color_jitter=color_jitter,
            device_hflip=bool(d.get("device_hflip", False)),
        )


@dataclasses.dataclass(frozen=True)
class OutputConfig:
    checkpoint_dir: str = "./"
    project_name: str = "seghiero"
    metrics_jsonl: Optional[str] = None
    profile_dir: Optional[str] = None
    tensorboard_dir: Optional[str] = None
    sample_images: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "OutputConfig":
        d = dict(d or {})
        out = cls(
            checkpoint_dir=str(d.get("checkpoint_dir", "./")),
            project_name=str(d.get("project_name", "seghiero")),
            metrics_jsonl=d.get("metrics_jsonl"),
            profile_dir=d.get("profile_dir"),
            tensorboard_dir=d.get("tensorboard_dir"),
            sample_images=int(d.get("sample_images", 0)),
        )
        if out.sample_images < 0:
            raise ValueError("output.sample_images must be >= 0")
        return out


@dataclasses.dataclass(frozen=True)
class SegHieroConfig:
    dataset: DatasetConfig
    hierarchy: Hierarchy
    model: ModelConfig
    training: TrainingConfig
    transform: TransformConfig
    output: OutputConfig
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_dict(cls, cfg: dict) -> "SegHieroConfig":
        unknown = set(cfg) - _KNOWN_SECTIONS
        if unknown:
            import warnings

            warnings.warn(f"Ignoring unknown config sections: {sorted(unknown)}")
        if "classes" not in cfg:
            raise ValueError("config must have a 'classes' section")
        out = cls(
            dataset=DatasetConfig.from_dict(cfg.get("dataset", {})),
            hierarchy=Hierarchy.from_class_config(cfg["classes"]),
            model=ModelConfig.from_dict(cfg.get("model", {})),
            training=TrainingConfig.from_dict(cfg.get("training", {})),
            transform=TransformConfig.from_dict(cfg.get("transform", {})),
            output=OutputConfig.from_dict(cfg.get("output", {})),
            raw=cfg,
        )
        upper = out.training.triplet_upper_ids
        lower = out.training.triplet_lower_ids
        if upper is not None:
            if not out.hierarchy.has_super:
                raise ValueError(
                    "training.triplet_upper_ids/lower_ids configure the "
                    "3-level group triplet; 2-level configs derive groups "
                    "from the hierarchy itself"
                )
            n_fine = out.hierarchy.n_fine
            bad = [i for i in (*upper, *lower) if not 0 <= i < n_fine]
            if bad:
                raise ValueError(
                    f"triplet group ids out of range [0, {n_fine}): "
                    f"{sorted(set(bad))}"
                )
            overlap = set(upper) & set(lower)
            if overlap:
                raise ValueError(
                    "triplet_upper_ids and triplet_lower_ids must be "
                    f"disjoint; both contain {sorted(overlap)}"
                )
        return out

    @property
    def fine_names(self) -> Dict[int, str]:
        return {int(k): v for k, v in self.raw["classes"]["fine_names"].items()}

    @property
    def coarse_names(self) -> Dict[int, str]:
        return {int(k): v for k, v in self.raw["classes"]["coarse_names"].items()}

    @property
    def super_names(self) -> Dict[int, str]:
        return {
            int(k): v
            for k, v in self.raw["classes"].get("super_coarse_names", {}).items()
        }


def load_config(path: str) -> SegHieroConfig:
    """Load and validate a SegHiero YAML config file."""
    with open(path, "r") as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"{path} is not a YAML mapping (got {type(cfg).__name__})")
    return SegHieroConfig.from_dict(cfg)
