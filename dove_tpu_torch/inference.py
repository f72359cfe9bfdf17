"""Inference CLI of the PyTorch port: one-step 4x video super-resolution.

    python -m dove_tpu_torch.inference --input_dir clips/ --output_path out/ \
        --tile_size_hw 384 384 --chunk_len 16

The flags of ``scripts/inference.py``, served on the card (``--device cpu``
asks for the CPU). Without ``--is_vae_st`` the fused outer-tile path runs
(``--tile_size_hw``, ``--overlap_hw``, ``--chunk_len``, ``--overlap_t``,
``--tile_batch``, ``--upscale_mode``); with it, the staged path, with clips
of more than 33 frames streamed or cut into overlapping chunks
(``--streaming``). Both take bf16, fp16 or fp32, the CogVideoX1.5-5B or
the CogVideoX-2B family (``--preset``), unquantized or in one of the five
int8 serving modes (``--quantize``; the ones that quantize the VAE also take
``--vae_calib`` and ``--vae_exclude``), ``--lora_path`` (fused into the DiT),
``--noise_step`` / ``--sr_noise_step`` / ``--upscale``, and inline scoring
against ``--gt_dir`` (``--eval_metrics psnr,ssim,lpips,dists``). The port's
own flags: ``--device``, ``--hand_conv`` (the hand-written bf16 conv in a
float VAE) and ``--prompt_embedding`` (Wan2.1's umT5 context).

Wan2.1 (``--model_path`` a Wan2.1 release folder: a root ``config.json`` of
``WanModel``, its safetensors shards and ``Wan2.1_VAE.pth``; or ``--preset
wan2.1-t2v-14b`` / ``tiny-wan`` with seeded weights) serves the staged path
in the chosen dtype, with ``--prompt_embedding``, a umT5 embedding of
[<= 512, 4096] (safetensors under ``prompt_embedding``, or .npy) padded
with zero rows to 512; without one the context is all zeros.

Without ``--model_path`` the weights are seeded random ones and the prompt
embedding is zeros of shape (max_text_seq_length, text_embed_dim) unless the
cached empty-prompt embedding is found under ``pretrained_models/``. Input
clips are video files, read through OpenCV.

Several devices: one process per device, every one with the same flags
(``parallel/``)::

    torchrun --nproc-per-node 4 -m dove_tpu_torch.inference --is_vae_st \
        --data_parallel 2 --tensor_parallel 2 --input_dir clips/ ...

``--data_parallel`` spreads chunks, spatial windows or tile batches over the
"data" ranks; ``--tensor_parallel`` splits the DiT over "model" and serves
the staged path only (``--is_vae_st``), as in the JAX package; rank 0 writes
the outputs and the metrics.

Prompts: ``--input_json`` maps a clip's name (or stem) to a prompt. Where
one is non-empty and ``--model_path`` has a ``text_encoder/``, the clip is
served with that prompt's T5 embedding (``models/t5.py``, bf16, cast to the
pipeline's dtype; every rank of a mesh encodes it) and the default
embedding comes back for the next clip; without a text encoder the prompt
is ignored with a warning, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

EMPTY_PROMPT = Path(
    "pretrained_models/prompt_embeddings/"
    "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855.safetensors"
)
DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
          "float32": torch.float32}


def _preset(name: str):
    from dove_tpu_torch import config as cfg_mod

    return {"tiny": cfg_mod.tiny_test, "cogvideox-2b": cfg_mod.cogvideox_2b,
            "cogvideox1.5-5b": cfg_mod.cogvideox1_5_5b,
            "wan2.1-t2v-14b": cfg_mod.wan2_1_t2v_14b, "tiny-wan": cfg_mod.tiny_wan}[name]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input_dir", type=str, required=True)
    p.add_argument("--input_json", type=str, default=None,
                   help="JSON {video_name: prompt}; non-empty prompts need a "
                        "T5 text encoder, which the port lacks")
    p.add_argument("--gt_dir", type=str, default=None)
    p.add_argument("--eval_metrics", type=str, default="",
                   help="comma list, e.g. psnr,ssim,lpips,dists")
    p.add_argument("--model_path", type=str, default=None,
                   help="diffusers-layout checkpoint directory")
    p.add_argument("--lora_path", type=str, default=None,
                   help="pytorch_lora_weights.safetensors, or its directory")
    p.add_argument("--preset", type=str, default="cogvideox1.5-5b",
                   choices=["cogvideox1.5-5b", "cogvideox-2b", "tiny", "wan2.1-t2v-14b",
                            "tiny-wan"])
    p.add_argument("--prompt_embedding", type=str, default=None,
                   help="Wan2.1: a umT5 embedding [<= 512, 4096] (safetensors "
                        "'prompt_embedding' or .npy), padded with zeros to 512")
    p.add_argument("--output_path", type=str, default="./results")
    p.add_argument("--fps", type=int, default=16)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float16", "bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--upscale_mode", type=str, default="bilinear",
                   help="bilinear runs on the device; bicubic, nearest, area "
                        "and lanczos through OpenCV on the host")
    p.add_argument("--upscale", type=int, default=4)
    p.add_argument("--noise_step", type=int, default=0)
    p.add_argument("--sr_noise_step", type=int, default=399)
    p.add_argument("--is_cpu_offload", action="store_true",
                   help="accepted for parity; it has no effect")
    p.add_argument("--is_vae_st", action="store_true",
                   help="the staged path: a full-frame DiT with feathered "
                        "VAE windows (the reference's default mode); without "
                        "it, the fused outer-tile path")
    p.add_argument("--png_save", action="store_true")
    p.add_argument("--save_format", type=str, default="yuv444p",
                   choices=["yuv444p", "yuv420p", "lossless"],
                   help="yuv444p/yuv420p: the best mp4 encoder OpenCV has "
                        "(staged clips leave the device as I420); lossless: "
                        "FFV1/mkv, bit-exact")
    p.add_argument("--tile_size_hw", type=int, nargs=2, default=(0, 0))
    p.add_argument("--overlap_hw", type=int, nargs=2, default=(32, 32))
    p.add_argument("--chunk_len", type=int, default=0)
    p.add_argument("--overlap_t", type=int, default=8)
    p.add_argument("--tile_batch", type=int, default=1,
                   help="same-shaped tiles run together through one call")
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
    p.add_argument("--data_parallel", type=int, default=0,
                   help="ranks on the mesh's 'data' axis: they share tile "
                        "batches (fused path) or temporal chunks and spatial "
                        "windows (staged path); 0: the ranks --tensor_parallel "
                        "leaves")
    p.add_argument("--tensor_parallel", type=int, default=0,
                   help="Megatron-style tensor parallelism for the DiT over "
                        "the mesh's 'model' axis (staged --is_vae_st path "
                        "only); must divide the DiT's heads and widths")
    p.add_argument("--streaming", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="clips over 33 frames on the staged path: stream "
                        "contiguous segments with the VAE's causal caches "
                        "carried across them (on), or run overlapping "
                        "33-frame chunks (off); auto streams with an int8 DiT")
    p.add_argument("--dec_window_cap", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="cap the staged decode window (latents)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--hand_conv", action="store_true",
                   help="run the float VAE's eligible 3x3x3 convs through the "
                        "hand-written bf16 conv kernel (K5) instead of cuDNN")
    return p


def serving_mesh(args):
    """The ("data", "model") mesh of ``--data_parallel`` /
    ``--tensor_parallel`` over the process group (joined here from
    torchrun's or the DOVE_* variables), or None for one process. TP needs
    the staged path and a degree that divides the DiT (the JAX CLI's
    checks)."""
    from dove_tpu_torch.parallel.distributed import init_distributed
    from dove_tpu_torch.parallel.mesh import make_mesh
    from dove_tpu_torch.parallel.tp import validate_tp

    from dove_tpu_torch import config as cfg_mod

    tp = max(args.tensor_parallel, 1)
    if tp > 1:
        if not args.is_vae_st:
            raise SystemExit("--tensor_parallel serves the staged path; add --is_vae_st")
        validate_tp((cfg_mod.pipeline_config_from_pretrained(args.model_path)
                     if args.model_path else _preset(args.preset)()).dit, tp)
    _, world = init_distributed(device=args.device)
    if world == 1 and tp == 1 and args.data_parallel <= 1:
        return None
    return make_mesh(data=args.data_parallel or None, model=tp, device=args.device)


def load_pipeline(args):
    from dove_tpu_torch import config as cfg_mod
    from dove_tpu_torch import safetensors_io, weights
    from dove_tpu_torch.models.dit import init_dit_params
    from dove_tpu_torch.models.vae import init_vae_params
    from dove_tpu_torch.pipeline import DovePipeline, resolve_device

    from dove_tpu_torch.parallel.distributed import local_device, world

    device = local_device(args.device) if world()[1] > 1 else resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    if args.model_path:
        cfg = cfg_mod.pipeline_config_from_pretrained(args.model_path)
    else:
        cfg = _preset(args.preset)()
    cfg = dataclasses.replace(
        cfg, sr_noise_step=args.sr_noise_step, noise_step=args.noise_step,
        upscale=args.upscale,
    )
    if cfg.family == "wan":
        return _wan_pipeline(args, cfg, dtype, device)
    if args.model_path:
        dit = weights.load_dit(args.model_path, cfg.dit, dtype, device)
        if args.lora_path:
            lora_file = Path(args.lora_path)
            if lora_file.is_dir():
                lora_file = lora_file / "pytorch_lora_weights.safetensors"
            weights.fuse_lora_into_dit(dit, safetensors_io.load_file(lora_file))
            logging.info("fused LoRA weights from %s", lora_file)
        vae = weights.load_vae(args.model_path, cfg.vae, dtype, device)
    else:
        logging.warning("no --model_path: seeded random weights, %s preset",
                        args.preset)
        if args.lora_path:
            logging.warning("--lora_path ignored without --model_path")
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
        # writers take uint8; keep float when metrics need [0, 1]
        output_uint8=args.is_vae_st and not args.eval_metrics,
        # a plain mp4 takes planar I420 from the device (the H.264 encoder
        # consumes yuv420); RGB stays for PNG, lossless and metrics outputs
        output_i420=(args.is_vae_st and not args.eval_metrics
                     and not args.png_save and args.save_format != "lossless"),
        quantize=args.quantize, streaming=args.streaming,
        vae_exclude=tuple(n.strip() for n in args.vae_exclude.split(",") if n.strip()),
        vae_calib=({k: torch.from_numpy(v) for k, v in np.load(args.vae_calib).items()}
                   if args.vae_calib else None),
        dec_window_cap=tuple(args.dec_window_cap) if args.dec_window_cap else None,
        hand_conv=args.hand_conv,
    )


def _wan_pipeline(args, cfg, dtype, device):
    """The staged Wan2.1 pipeline of a release folder, or seeded weights."""
    from dove_tpu_torch import weights
    from dove_tpu_torch.models.wan_dit import WanModel, init_wan_params
    from dove_tpu_torch.models.wan_vae import WanVAE_
    from dove_tpu_torch.pipeline import DovePipeline

    if args.lora_path or args.quantize:
        raise SystemExit("Wan2.1 serves without --lora_path and --quantize")
    if not args.is_vae_st:
        logging.info("Wan2.1 serves the staged path: --is_vae_st implied")
        args.is_vae_st = True
    if args.model_path:
        dit = weights.load_wan_dit(args.model_path, cfg.dit, dtype, device)
        vae = weights.load_wan_vae(args.model_path, cfg.vae, dtype, device)
    else:
        logging.warning("no --model_path: seeded random weights, %s preset", args.preset)
        dit = init_wan_params(WanModel(cfg.dit), args.seed).to(device, dtype)
        vae = init_wan_params(WanVAE_(cfg.vae), args.seed + 1).to(device, dtype)
    if args.prompt_embedding:
        prompt = weights.load_wan_prompt(args.prompt_embedding, cfg.dit.text_len,
                                         cfg.dit.text_dim, dtype)
    else:
        logging.warning("no --prompt_embedding: an all-zero umT5 context")
        prompt = torch.zeros((cfg.dit.text_len, cfg.dit.text_dim), dtype=dtype)
    return DovePipeline(
        config=cfg, dit=dit, vae=vae, prompt_embedding=prompt, dtype=dtype, device=device,
        vae_tiling=True, output_uint8=not args.eval_metrics,
        output_i420=(not args.eval_metrics and not args.png_save
                     and args.save_format != "lossless"))


def clip_log(times: dict) -> str:
    """A clip's ``DovePipeline.stage_times`` for its log line: each span in
    milliseconds, then the VAE's windows and the share of their latent
    positions that overlap (computed twice)."""
    spans = " ".join(f"{k} {v * 1e3:.0f}ms" for k, v in times.items()
                      if not k.endswith(("_n", "_px")))
    windows = [f"{stage} {times[f'{stage}.windows_n']} "
               f"({100 * (1 - times[f'{stage}.frame_px'] / times[f'{stage}.window_px']):.1f}%"
               " overlap)"
               for stage in ("enc", "dec") if times.get(f"{stage}.windows_n")]
    return f"spans {spans}" + (f"; windows {', '.join(windows)}" if windows else "")


def process_kwargs(args) -> dict:
    """The flags that go to ``DovePipeline.process_frames``."""
    return dict(
        upscale=args.upscale,
        chunk_len=args.chunk_len,
        tile_size_hw=tuple(args.tile_size_hw),
        overlap_t=args.overlap_t,
        overlap_hw=tuple(args.overlap_hw),
        seed=args.seed,
        tile_batch=args.tile_batch,
        upscale_mode=args.upscale_mode,
    )


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    mesh = serving_mesh(args)
    lead = mesh is None or mesh.rank == 0

    from dove_tpu_torch.eval.metrics import MetricAccumulator
    from dove_tpu_torch.io import video as video_io

    videos = video_io.list_videos(args.input_dir)
    if not videos:
        raise SystemExit(f"No video files found in {args.input_dir}")
    out_dir = Path(args.output_path)
    out_dir.mkdir(parents=True, exist_ok=True)

    pipe = load_pipeline(args)
    prompt_map = {}
    prompt_encoder = None
    if args.input_json:
        prompt_map = json.loads(Path(args.input_json).read_text())
        if any(prompt_map.values()) and args.model_path and (
                Path(args.model_path) / "text_encoder").exists():
            from dove_tpu_torch.models.t5 import PromptEncoder

            # every rank of a mesh encodes the same prompt itself
            prompt_encoder = PromptEncoder(
                args.model_path, max_length=pipe.config.dit.max_text_seq_length,
                device=pipe.device)
    if mesh is not None and mesh.shape["model"] > 1:
        from dove_tpu_torch.parallel.tp import shard_dit_tp

        shard_dit_tp(pipe.dit, mesh.axis_group("model"))  # heads / tp a rank
    if args.gt_dir and not args.png_save and args.save_format != "lossless":
        logging.warning(
            "--gt_dir with --save_format %s: the written mp4 is lossy, so "
            "re-scoring the files under-reports quality; the inline "
            "--eval_metrics use the exact frames, and --save_format lossless "
            "or --png_save write exact files.", args.save_format)
    metric_names = [m.strip() for m in args.eval_metrics.split(",") if m.strip()]
    accumulator = (MetricAccumulator(metric_names, device=pipe.device)
                   if metric_names else None)

    save_pool = ThreadPoolExecutor(max_workers=1)
    save_futures = []
    default_prompt_embedding = pipe.prompt_embedding
    for vpath in videos:
        prompt = prompt_map.get(vpath.name, prompt_map.get(vpath.stem, ""))
        if prompt and prompt_encoder is not None:
            # T5 runs in bf16; the embedding takes the pipeline's dtype after
            pipe.prompt_embedding = torch.from_numpy(prompt_encoder(prompt)).to(
                pipe.device, pipe.dtype)
        else:
            if prompt:
                logging.warning("prompt for %s ignored (no text_encoder in "
                                "--model_path)", vpath.name)
            pipe.prompt_embedding = default_prompt_embedding
        t0 = time.perf_counter()
        out = pipe.process_video_file(vpath, mesh=mesh, **process_kwargs(args))
        if not lead:  # rank 0 has the clip; it writes and scores
            continue
        dt = time.perf_counter() - t0
        logging.info("%s: %s in %.2fs (%.2f frames/s) %s", vpath.name,
                     out.shape, dt, out.shape[0] / dt, clip_log(pipe.stage_times))
        if accumulator is not None:
            gt = None
            if args.gt_dir:
                gt = video_io.load_sequence(Path(args.gt_dir) / vpath.name)
            accumulator.add(vpath.name, out, gt)
        # the host's encode and write of this clip overlap the next clip's
        # device work
        if args.png_save:
            save_futures.append(save_pool.submit(
                video_io.save_frames_as_png, out, out_dir / vpath.stem))
        elif args.save_format == "lossless":
            save_futures.append(save_pool.submit(
                video_io.save_video_lossless, out,
                out_dir / (vpath.stem + ".mkv"), args.fps))
        else:
            save_futures.append(save_pool.submit(
                video_io.save_video, out, out_dir / (vpath.stem + ".mp4"),
                args.fps,
                # explicit: the pipeline falls back to RGB on odd dims
                "i420" if (pipe.output_i420 and out.ndim == 3) else "rgb"))

    if accumulator is not None and lead:
        summary = accumulator.summary()
        print("\n=== Overall Average Metrics ===")
        for name, val in summary["average"].items():
            print(f"{name.upper()}: {val:.4f}")
        out_name = "metrics_" + "_".join(metric_names) + ".json"
        (out_dir / out_name).write_text(json.dumps(summary, indent=2))

    save_pool.shutdown(wait=True)
    # surface write failures: shutdown() alone swallows them
    for fut in save_futures:
        fut.result()
    print("All videos processed.")


if __name__ == "__main__":
    main()
