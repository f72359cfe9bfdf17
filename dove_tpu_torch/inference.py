"""Inference CLI of the PyTorch port: one-step 4x video super-resolution.

    python -m dove_tpu_torch.inference --input_dir clips/ --output_path out/ --is_vae_st

The subset of ``scripts/inference.py``'s flags that the port supports: the
staged path (``--is_vae_st``, required) in bf16 or fp32, unquantized or in
one of the five int8 serving modes (``--quantize``; the ones that quantize
the VAE also take ``--vae_calib`` and ``--vae_exclude``), with clips of more
than 33 frames streamed or cut into overlapping chunks (``--streaming``),
and ``--hand_conv`` for the hand-written bf16 conv in a float VAE. Without
``--model_path`` the weights are seeded random ones and the prompt embedding
is zeros of shape (max_text_seq_length, text_embed_dim) unless the cached
empty-prompt embedding is found under ``pretrained_models/``.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import torch

EMPTY_PROMPT = Path(
    "pretrained_models/prompt_embeddings/"
    "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855.safetensors"
)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input_dir", type=str, required=True)
    p.add_argument("--output_path", type=str, default="./results")
    p.add_argument("--model_path", type=str, default=None,
                   help="diffusers-layout checkpoint directory")
    p.add_argument("--preset", type=str, default="cogvideox1.5-5b",
                   choices=["cogvideox1.5-5b", "tiny"])
    p.add_argument("--dtype", type=str, default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--is_vae_st", action="store_true", required=True,
                   help="staged path with internal VAE tiling (the only "
                        "path the port has)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--quantize", type=str, default=None,
                   choices=["int8", "int8-dit", "int8-vae", "int8w", "int8-dit-dec"],
                   help="int8 serving modes: 'int8' quantizes DiT and VAE; "
                        "'int8-dit' runs W8A8 DiT linears and, on the card, "
                        "int8 Q K^T attention (K2); 'int8-vae' runs the VAE's "
                        "hot convs in int8 (K4 on the card); 'int8w' stores "
                        "int8 DiT weights and computes in --dtype; "
                        "'int8-dit-dec' is int8-dit with an int8 VAE decoder")
    p.add_argument("--vae_calib", type=str, default=None,
                   help="npz of per-conv calibration stats (models.vae."
                        "calibrate): folds a per-channel equalization, and "
                        "with #tapcorr entries GPTQ tap-space rounding, into "
                        "the quantized VAE convs (int8, int8-vae, int8-dit-dec)")
    p.add_argument("--vae_exclude", type=str, default="",
                   help="comma list of VAE conv names kept in --dtype inside "
                        "a quantized VAE, or the literal 'lowres' for every "
                        "decoder conv below the two full-resolution levels")
    p.add_argument("--hand_conv", action="store_true",
                   help="run the float VAE's eligible 3x3x3 convs through the "
                        "hand-written bf16 conv kernel (K5) instead of cuDNN")
    p.add_argument("--streaming", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="clips over 33 frames: stream contiguous segments "
                        "with the VAE's causal caches carried across them "
                        "(on), or run overlapping 33-frame chunks (off); "
                        "auto streams with an int8 DiT")
    return p


def load_pipeline(args):
    from dove_tpu_torch import config as cfg_mod
    from dove_tpu_torch import weights
    from dove_tpu_torch.models.dit import init_dit_params
    from dove_tpu_torch.models.vae import init_vae_params
    from dove_tpu_torch.pipeline import DovePipeline, resolve_device

    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    if args.model_path:
        cfg = cfg_mod.pipeline_config_from_pretrained(args.model_path)
        dit = weights.load_dit(args.model_path, cfg.dit, dtype, device)
        vae = weights.load_vae(args.model_path, cfg.vae, dtype, device)
    else:
        cfg = cfg_mod.tiny_test() if args.preset == "tiny" else cfg_mod.cogvideox1_5_5b()
        logging.warning("no --model_path: seeded random weights, %s preset",
                        args.preset)
        dit = init_dit_params(cfg.dit, args.seed, device, dtype)
        vae = init_vae_params(cfg.vae, args.seed + 1, device, dtype)

    prompt_embedding = None
    if EMPTY_PROMPT.exists():
        emb = weights.load_prompt_embedding(EMPTY_PROMPT, dtype)
        if emb.shape[-1] == cfg.dit.text_embed_dim:
            prompt_embedding = emb[: cfg.dit.max_text_seq_length]
            logging.info("loaded empty-prompt embedding from %s", EMPTY_PROMPT)
    if prompt_embedding is None:
        prompt_embedding = torch.zeros(
            (cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim), dtype=dtype
        )
    return DovePipeline(
        config=cfg, dit=dit, vae=vae, prompt_embedding=prompt_embedding,
        dtype=dtype, device=device, vae_tiling=args.is_vae_st,
        output_uint8=True,
        # as scripts/inference.py: a plain mp4 takes planar I420 from the
        # device (the H.264 encoder consumes yuv420); the reference keeps RGB
        # for PNG, lossless and metrics outputs, which the port does not write yet
        output_i420=args.is_vae_st,
        quantize=args.quantize, streaming=args.streaming,
        vae_exclude=tuple(n.strip() for n in args.vae_exclude.split(",") if n.strip()),
        vae_calib=({k: torch.from_numpy(v) for k, v in np.load(args.vae_calib).items()}
                   if args.vae_calib else None),
        hand_conv=args.hand_conv,
    )


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from dove_tpu_torch.io import video as video_io

    videos = video_io.list_videos(args.input_dir)
    if not videos:
        raise SystemExit(f"No video files found in {args.input_dir}")
    out_dir = Path(args.output_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    pipe = load_pipeline(args)
    for vpath in videos:
        t0 = time.perf_counter()
        out = pipe.process_video_file(vpath, seed=args.seed)
        dt = time.perf_counter() - t0
        logging.info("%s: %s in %.2fs (%.2f frames/s) stages %s", vpath.name,
                     out.shape, dt, out.shape[0] / dt, pipe.stage_times)
        # explicit: the pipeline falls back to RGB on odd dims
        video_io.save_video(out, out_dir / (vpath.stem + ".mp4"),
                            pixel_format="i420" if (pipe.output_i420 and out.ndim == 3)
                            else "rgb")
    print("All videos processed.")


if __name__ == "__main__":
    main()
