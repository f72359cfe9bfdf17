"""Manifest generator: walk a directory and write its media files' paths, one
per line, relative to a base (the counterpart of
``scripts/prepare_dataset.py``, after the reference's
finetune/scripts/prepare_dataset.py):

    python -m dove_tpu_torch.prepare_dataset --data_dir data/HQ-VSR \\
        --output data/HQ-VSR.txt [--exts .mp4 .mkv] [--relative_to data]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--exts", nargs="*",
                    default=[".mp4", ".avi", ".mov", ".mkv", ".png", ".jpg"])
    ap.add_argument("--relative_to", default=None,
                    help="base for relative paths (default: data_dir's parent)")
    args = ap.parse_args(argv)

    data_dir = Path(args.data_dir)
    base = Path(args.relative_to) if args.relative_to else data_dir.parent
    exts = {e.lower() for e in args.exts}
    files = sorted(
        p.relative_to(base)
        for p in data_dir.rglob("*")
        if p.is_file() and p.suffix.lower() in exts
    )
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(f"{p}\n" for p in files))
    print(f"wrote {len(files)} entries to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
