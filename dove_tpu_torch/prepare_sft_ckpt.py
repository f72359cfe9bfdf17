"""Package a training run into a deployable diffusers-layout model folder:
the counterpart of ``scripts/prepare_sft_ckpt.py``.

    python -m dove_tpu_torch.prepare_sft_ckpt \
        --run_dir train_results/s1 --step 10000 \
        --base_model pretrained_models/CogVideoX1.5-5B \
        --output_dir pretrained_models/DOVE-s1 --training_type lora

The checkpoint (``checkpoint-N/state.pt``, the newest without ``--step``)
holds the whole trainable state whatever the layout it was trained under.
LoRA is written as peft's ``pytorch_lora_weights.safetensors``; SFT as the
diffusers ``transformer/`` (sharded past 5 GiB, the base's ``config.json``
beside it), and then the base folder's ``vae``, ``scheduler``,
``tokenizer``, ``text_encoder`` and ``model_index.json`` are copied in.
The port's state already carries the diffusers names and shapes, so
the JAX script's ``--base_preset`` and ``--rank`` have nothing to choose
here; they are still accepted (and hidden from ``--help``) so that that
script's command lines run unchanged.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--step", type=int, default=None, help="checkpoint step (default: newest)")
    ap.add_argument("--base_model", default=None,
                    help="base CogVideoX folder to graft onto (SFT)")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--training_type", choices=["lora", "sft"], default="sft")
    # the JAX script's command lines parse unchanged; neither flag is read
    ap.add_argument("--base_preset", default="cogvideox1.5-5b", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=128, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from dove_tpu_torch.train import checkpointing as ckpt

    run_dir = Path(args.run_dir)
    if args.step is not None:
        step, path = args.step, run_dir / f"{ckpt.CHECKPOINT_PREFIX}{args.step}"
    else:
        latest = ckpt.latest_checkpoint(run_dir)
        if latest is None:
            sys.exit(f"no checkpoints under {run_dir}")
        step, path = latest
    print(f"restoring step {step} from {path}")
    trainable = ckpt.load_state(path)["trainable"]

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.training_type == "lora":
        ckpt.export_lora_safetensors(trainable, out_dir / "pytorch_lora_weights.safetensors")
        print(f"wrote {out_dir / 'pytorch_lora_weights.safetensors'}")
        return

    base_cfg = Path(args.base_model) / "transformer" / "config.json" if args.base_model else None
    ckpt.export_dit_safetensors(
        trainable, out_dir / "transformer",
        base_config=base_cfg if base_cfg and base_cfg.exists() else None)
    print(f"wrote {out_dir / 'transformer'}")
    if args.base_model:
        base = Path(args.base_model)
        for sub in ("vae", "scheduler", "tokenizer", "text_encoder"):
            src, dst = base / sub, out_dir / sub
            if src.exists() and not dst.exists():
                shutil.copytree(src, dst)
                print(f"copied {sub}/ from base model")
        if (base / "model_index.json").exists():
            shutil.copy(base / "model_index.json", out_dir / "model_index.json")


if __name__ == "__main__":
    main()
