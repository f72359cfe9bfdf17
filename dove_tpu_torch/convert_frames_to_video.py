"""Convert folders of frames into videos and a manifest: the counterpart
of ``scripts/convert_frames_to_video.py``.

    python -m dove_tpu_torch.convert_frames_to_video --input_dir frames_root \
        --output_dir videos --fps 16 [--manifest videos.txt]

Each subfolder of ``--input_dir`` (frames read through PIL, in numeric
order where every name is a number) becomes ``<name>.mp4`` through
``io/video.py``'s writer (OpenCV), and the manifest lists the written files
relative to the output folder's parent.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input_dir", required=True,
                    help="root containing one subfolder of frames per clip")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--fps", type=int, default=16)
    ap.add_argument("--manifest", default=None)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from dove_tpu_torch.io.video import read_image_folder, save_video

    in_root, out_root = Path(args.input_dir), Path(args.output_dir)
    out_root.mkdir(parents=True, exist_ok=True)
    written = []
    for sub in sorted(p for p in in_root.iterdir() if p.is_dir()):
        frames = read_image_folder(sub)
        out_path = out_root / f"{sub.name}.mp4"
        save_video(frames, out_path, fps=args.fps)
        written.append(out_path)
        print(f"{sub.name}: {frames.shape[0]} frames -> {out_path}")
    if args.manifest:
        Path(args.manifest).write_text(
            "".join(f"{p.relative_to(out_root.parent)}\n" for p in written))


if __name__ == "__main__":
    main()
