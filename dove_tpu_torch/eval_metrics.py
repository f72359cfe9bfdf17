"""Full-reference quality metrics of SR outputs against ground truth: the
counterpart of ``scripts/eval_metrics.py``.

    python -m dove_tpu_torch.eval_metrics --pred_dir results/UDM10 \
        --gt_dir datasets/UDM10/GT --metrics psnr,ssim,lpips,dists \
        --output results/UDM10_metrics.json

Predictions and ground truth are matched by name: a frame folder by its
name, a video file by its stem. Both are cropped to their common size
(top-left or centered), optionally less a border, and scored per sample;
the JSON holds ``per_sample``, ``average``, ``count`` and
``per_sample_names``. Frame folders are read through PIL, video files
through OpenCV, so on a machine without OpenCV the samples are frame
folders. SSIM, LPIPS and DISTS run on the card unless ``--device cpu``;
LPIPS and DISTS read exported weights from ``DOVE_LPIPS_WEIGHTS`` and
``DOVE_DISTS_WEIGHTS``. The no-reference metrics are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def collect_samples(root: Path) -> dict[str, Path]:
    """Map name -> frame folder, or stem -> video file."""
    from dove_tpu_torch.io.video import VIDEO_EXTS

    out: dict[str, Path] = {}
    for p in sorted(root.iterdir()):
        if p.is_dir():
            out[p.name] = p
        elif p.suffix.lower() in VIDEO_EXTS:
            out[p.stem] = p
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pred_dir", required=True)
    ap.add_argument("--gt_dir", default=None)
    ap.add_argument("--metrics", default="psnr,ssim")
    ap.add_argument("--match_mode", default="top-left",
                    choices=["top-left", "center"])
    ap.add_argument("--crop_border", type=int, default=0)
    ap.add_argument("--test_y_channel", action="store_true",
                    help="PSNR on the Y channel instead of RGB")
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where SSIM, LPIPS and DISTS run: cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from dove_tpu_torch.eval.metrics import (
        MetricAccumulator,
        match_resolution,
        psnr_y,
    )
    from dove_tpu_torch.io.video import load_sequence

    names = [m.strip() for m in args.metrics.split(",") if m.strip()]
    acc = MetricAccumulator(names, device=args.device)
    if args.test_y_channel and "psnr" in acc.names:
        acc._fns["psnr"] = psnr_y

    preds = collect_samples(Path(args.pred_dir))
    gts = collect_samples(Path(args.gt_dir)) if args.gt_dir else {}
    for stem, pred_path in preds.items():
        gt_path = gts.get(stem)
        if gt_path is None:
            print(f"skip {stem}: no GT match", file=sys.stderr)
            continue
        pred, gt = match_resolution(load_sequence(pred_path),
                                    load_sequence(gt_path), args.match_mode)
        if args.crop_border:
            b = args.crop_border
            pred = pred[:, b:-b, b:-b]
            gt = gt[:, b:-b, b:-b]
        vals = acc.add(stem, pred, gt)
        print(stem, {k: round(v, 4) for k, v in vals.items()})

    summary = acc.summary()
    summary["per_sample_names"] = acc.sample_names
    print(json.dumps(summary["average"], indent=2))
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
