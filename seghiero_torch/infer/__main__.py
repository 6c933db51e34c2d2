"""``python -m seghiero_torch.infer --config <yaml> --image-dir DIR --output-dir OUT``:
predict per-level masks of image files and write them as PNGs (the port
of the JAX package's ``infer.py``, ``seghiero_tpu/cli.py`` ``infer_main``,
with the same flags).

Images are resized to ``transform.resize``, grouped by their original size
and predicted ``--batch-size`` at a time; the masks come back at each
image's original size as ``{name}_{level}.png`` and
``{name}_{level}_color.png`` for every level of the hierarchy. ``--tta``
runs the multi-scale + flip ensemble per image. The run is on ``cuda``
unless ``--device`` names another device or the config says
``training.device: cpu``; without a card it raises. With
``output.profile_dir`` set, batches 2–5 (with ``--tta``, images 2–5) run
under ``torch.profiler``, which writes ``trace.json`` and ``spans.json``
there.
"""

from __future__ import annotations

import argparse
import os
import sys

PROFILED_BATCHES = (2, 5)  # output.profile_dir: the batches (TTA: images), from 1
IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Run inference on image(s) using a trained model and YAML config"
    )
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--image", type=str, action="append",
                   help="input image path (repeatable for batched inference)")
    p.add_argument("--image-dir", type=str, default=None,
                   help="run on every image in a directory (sorted; combined with "
                   "any --image flags)")
    p.add_argument("--batch-size", type=int, default=8,
                   help="device batch size: images with the same original size are "
                   "stacked and predicted together (the tail batch runs at its own "
                   "size: eager PyTorch compiles nothing per shape)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="reference .pth/.pt file, or a checkpoint directory of the "
                   "port's trainer (step, project or checkpoint_dir root); defaults "
                   "to the project's best")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda, or cpu when the config says "
                   "training.device: cpu)")
    p.add_argument("--output-dir", type=str, default=".")
    p.add_argument("--consistent", action="store_true",
                   help="derive coarse/super masks from the fine argmax through the "
                   "hierarchy (tree-consistent labels)")
    p.add_argument("--tta", action="store_true",
                   help="multi-scale + horizontal-flip test-time augmentation "
                   "(softmax-averaged)")
    p.add_argument("--tta-scales", type=str, default="0.75,1.0,1.25",
                   help="comma-separated scales for --tta")
    p.add_argument("--export", type=str, default=None, metavar="DIR",
                   help="serialize a serving artifact (not yet ported)")
    p.add_argument("--export-sizes", type=str, default=None, metavar="HxW,...",
                   help="extra input shape buckets for --export (not yet ported)")
    args = p.parse_args(argv)
    if args.export or args.export_sizes:
        raise NotImplementedError(
            "--export / --export-sizes are not yet ported to seghiero_torch: the "
            "kernels must first become torch.library custom ops so that torch.export "
            "can trace them (ROADMAP.md, queue 1 item 5)"
        )
    if args.image_dir:
        found = sorted(
            os.path.join(args.image_dir, f)
            for f in os.listdir(args.image_dir)
            if os.path.splitext(f)[1].lower() in IMAGE_EXTS
        )
        if not found:
            p.error(f"--image-dir {args.image_dir} contains no images")
        args.image = (args.image or []) + found
    if not args.image:
        p.error("one of --image/--image-dir is required")
    if args.batch_size < 1:
        p.error("--batch-size must be >= 1")

    import numpy as np

    from seghiero_torch import trace
    from seghiero_torch.config import load_config
    from seghiero_torch.infer.predictor import Predictor, preprocess_image

    cfg = load_config(args.config)
    device = args.device or ("cpu" if cfg.training.device == "cpu" else None)
    predictor = Predictor.from_checkpoint(cfg, args.checkpoint, device=device)

    def save(preds, image_path):
        base = os.path.splitext(os.path.basename(image_path))[0]
        for path in predictor.export_masks(preds, args.output_dir, base):
            print(f"→ Saved {path}")

    prof = trace.StepProfiler(cfg.output.profile_dir, *PROFILED_BATCHES)
    if args.tta:  # per image: each one runs a multi-scale ensemble
        scales = tuple(float(s) for s in args.tta_scales.split(","))
        for image_path in args.image:
            prof.step()
            arr, orig_hw, _ = preprocess_image(image_path, cfg.transform.resize)
            preds = predictor.predict_tta(arr[None], scales=scales, out_hw=orig_hw,
                                          consistent=args.consistent)
            save({k: v[0] for k, v in preds.items()}, image_path)
    else:
        groups: dict = {}
        for image_path in args.image:
            arr, orig_hw, _ = preprocess_image(image_path, cfg.transform.resize)
            groups.setdefault(orig_hw, []).append((image_path, arr))
        for orig_hw, items in groups.items():
            for i in range(0, len(items), args.batch_size):
                chunk = items[i:i + args.batch_size]
                prof.step()
                preds = predictor.predict_array(np.stack([a for _, a in chunk]),
                                                out_hw=orig_hw, consistent=args.consistent)
                for j, (image_path, _) in enumerate(chunk):
                    save({k: v[j] for k, v in preds.items()}, image_path)
    prof.close()
    print("Inference complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
