"""Build the prompt-embedding cache (T5) that training and inference read:
the counterpart of ``scripts/encode_prompts.py``.

    python -m dove_tpu_torch.encode_prompts --model_path <ckpt with text_encoder/> \
        --output_dir data/cache/prompt_embeddings [--prompts_file prompts.txt]

The empty prompt first, then each line of ``--prompts_file``, duplicates
dropped in order; each embedding ([max_length, d_model] float32) is written
as ``{"prompt_embedding": ...}`` to ``<sha256(prompt)>.safetensors``, the
reference's cache layout. T5 runs in bf16 on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import hashlib
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_path", required=True,
                    help="checkpoint dir containing text_encoder/ + tokenizer/")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--prompts_file", default=None, help="txt file, one prompt per line")
    ap.add_argument("--max_length", type=int, default=226)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from dove_tpu_torch import safetensors_io
    from dove_tpu_torch.models.t5 import PromptEncoder

    encoder = PromptEncoder(args.model_path, max_length=args.max_length, device=args.device)
    prompts = [""]
    if args.prompts_file:
        prompts += [ln.strip() for ln in Path(args.prompts_file).read_text().splitlines()]
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for prompt in dict.fromkeys(prompts):  # dedupe, keep order
        digest = hashlib.sha256(prompt.encode()).hexdigest()
        emb = encoder(prompt)
        safetensors_io.save_file({"prompt_embedding": np.ascontiguousarray(emb)},
                                 out_dir / f"{digest}.safetensors")
        print(f"{digest[:12]}...  {prompt[:60]!r}  -> {emb.shape}")


if __name__ == "__main__":
    main()
