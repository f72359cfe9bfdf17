"""DOVE training in PyTorch: stage 1 and stage 2, LoRA or SFT.

Counterpart of ``dove_tpu/train/trainer.py``. Stage 1 (``dove-s1``,
``DOVES1Trainer``) is the latent MSE after one DiT pass at t = 399
(reference lora_one_s1_trainer.py:116-209). Stage 2 (``dove-s2``,
``DOVES2Trainer``) encodes every LQ frame as a clip of its own, decodes
x-hat_0 frame by frame with gradients and takes the pixel MSE, one
perceptual term (DISTS or LPIPS, optionally on Sobel edges) and the
frame-difference L1 (reference lora_one_s2_trainer.py:124-297); a batch
that carries ``hq_image`` / ``lq_image`` trains on the image pair instead of
the clip with probability ``image_ratio``, by a coin keyed on (seed, step).
The API is the JAX trainer's::

    trainer = DOVES1Trainer(args, device="cuda")   # the card unless "cpu"
    trainer.load_components()
    trainer.prepare_optimizer(total_steps)
    trainer.maybe_resume()
    loss, aux, grad_norm = trainer.train_step(trainer.device_batch(batch))
    trainer.save(step); trainer.export(out_dir)

``train_step`` is the function the JAX package jits in ``build_train_step``:
the loss, its backward, the global norm of the gradients (logged before
clipping), the clip and the optimizer step with its schedule. The VAE encode
runs under ``no_grad``; its posterior noise comes from a generator seeded
from (seed, step), so a resumed run draws the same noise (JAX folds the step
into its key). The base DiT and the VAE stay frozen; only the LoRA tree
trains, or the whole DiT under ``sft``. ``train`` loops over ``self.loader``
with JSONL logging, checkpoints every ``checkpointing_steps`` and on SIGTERM.

Under a mesh (``data_parallel``, ``fsdp``, ``tensor_parallel``; one process
per device, ``parallel/``), each "data" row loads its slice of every batch
and the gradients are averaged over "data" (DDP); the logged loss is the
global mean, the same on every rank. "model" carries FSDP (FSDP2's
``fully_shard`` on the DiT) or tensor parallelism (``shard_dit_tp``), and the
optimizer steps on each rank's shards with one device's result: moments that
mirror a parameter keep its shard, and the statistics that span a whole
tensor (CAME's factored ones and RMS clip, Prodigy's sums, the 8- and 4-bit
blocks) are taken over the whole tensor (``train/optim.py``). A checkpoint
holds the whole state, gathered and written by rank 0, so it restores under
any layout; rank 0 writes the logs and the exports.

``fit`` is the whole run: the components, the dataset and loader
(``prepare_dataset``: ``data/``, the JAX package's datasets and
degradations, in DataLoader worker processes), the optimizer, a resume
from the newest checkpoint, and ``train``, which validates every
``validation_steps`` when ``do_validation`` is on. ``validate`` serves the
live DiT, its LoRA merged inside the forward, through the port's
``DovePipeline`` on the held-out clips and scores them with
``eval.metrics``. ``python -m dove_tpu_torch.train`` is the entry point.

Every optimizer of the JAX package runs (``train/optim.py``), and with
``gradient_accumulation_steps`` k > 1 the optimizer is ``optim.MultiSteps``,
optax's ``MultiSteps``: ``global_step`` counts micro-steps, the clip and the
update take the mean of k micro-gradients, and a checkpoint carries the
accumulator. Beside ``train_log.jsonl``, ``report_to`` ``tensorboard``
writes tfevents under ``tb/<tracker_name>`` (where
``torch.utils.tensorboard`` imports; else it warns and keeps the JSONL) and
``wandb`` an offline wandb run (``train/tracking.py``); ``all`` both.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from dove_tpu_torch import config as cfg_mod
from dove_tpu_torch import weights
from dove_tpu_torch.data.datasets import EMPTY_PROMPT_SHA
from dove_tpu_torch.models.dit import init_dit_params, temporal_pad
from dove_tpu_torch.models.vae import draw_part, encode_moments, init_vae_params, sample_latent
from dove_tpu_torch.ops.scheduler import Schedule
from dove_tpu_torch.parallel import distributed as dist_mod
from dove_tpu_torch.parallel.mesh import make_mesh, shard_params
from dove_tpu_torch.parallel.tp import Group, Split, shard_dit_tp, tp_dim, validate_tp
from dove_tpu_torch.pipeline import resolve_device
from dove_tpu_torch.train import checkpointing as ckpt_mod
from dove_tpu_torch.train import components as components_mod
from dove_tpu_torch.train import losses
from dove_tpu_torch.train.args import Args
from dove_tpu_torch.train.lora import TARGETS, init_lora_params
from dove_tpu_torch.train.optim import MultiSteps, make_lr_schedule, make_optimizer

logger = logging.getLogger(__name__)

DTYPES = {"no": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}
PRESETS = {
    "cogvideox1.5-5b": cfg_mod.cogvideox1_5_5b,
    "cogvideox-2b": cfg_mod.cogvideox_2b,
    "tiny": cfg_mod.tiny_test,
}
BATCH_KEYS = ("hq_video", "lq_video", "hq_image", "lq_image", "hq_latent", "lq_latent")


# ---------------------------------------------------------------------------
# Model registry (reference: finetune/models/utils.py SUPPORTED_MODELS)
# ---------------------------------------------------------------------------

SUPPORTED_MODELS: dict[str, dict[str, type]] = {}


def register(model_name: str, training_type: str, cls: type) -> None:
    SUPPORTED_MODELS.setdefault(model_name, {})[training_type] = cls


def get_model_cls(model_name: str, training_type: str) -> type:
    try:
        return SUPPORTED_MODELS[model_name][training_type]
    except KeyError:
        raise ValueError(
            f"no trainer registered for ({model_name}, {training_type}); "
            f"available: { {k: list(v) for k, v in SUPPORTED_MODELS.items()} }"
        ) from None


def _seed(*words: int) -> int:
    return int(np.random.SeedSequence(list(words)).generate_state(1)[0])


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of an FSDP2 DTensor (a view of its storage), or
    ``t`` itself."""
    return t.to_local() if hasattr(t, "to_local") else t


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

class Trainer:
    """Generic train loop; stages override ``compute_loss``."""

    stage: int = 1

    def __init__(self, args: Args, pipeline_config=None, device=None):
        self.args = args
        rank, world = dist_mod.world()
        self.device = dist_mod.local_device(device) if world > 1 else resolve_device(device)
        self.dtype = DTYPES[args.mixed_precision]
        if pipeline_config is not None:
            self.config = pipeline_config
        elif (Path(args.model_path) / "transformer" / "config.json").exists():
            self.config = cfg_mod.pipeline_config_from_pretrained(args.model_path)
        else:  # presets for tests and runs on random weights
            self.config = PRESETS[args.base_preset]()
        self.config = dataclasses.replace(
            self.config, sr_noise_step=args.sr_noise_step, noise_step=args.noise_step)
        self.schedule = Schedule.create(self.config.scheduler)
        # the ("data", "model") mesh: "model" is fsdp or tensor_parallel
        # (exclusive, Args), "data" the rest of the ranks unless given
        model = args.fsdp
        if args.tensor_parallel > 1:
            validate_tp(self.config.dit, args.tensor_parallel)
            model = args.tensor_parallel
        data = args.data_parallel or max(world // model, 1)
        if args.batch_size % data:
            raise ValueError(
                f"batch_size {args.batch_size} not divisible by the data axis "
                f"({data}): each data rank loads an equal slice of the batch")
        self.mesh = make_mesh(data, model, device=self.device)
        self.is_main = rank == 0
        self.global_step = 0
        # ops/attention.py's automatic rule takes the kernels from 2048 tokens,
        # the JAX package's TPU threshold, and the naive path below it; a
        # stage-2 pass has 1026. On the card the trainer takes the kernels
        # (K1 with the logsumexp, K3a, K3b) at every length: O(S) memory,
        # and faster than the naive path at 1026 (PERF.md, phase 9).
        self.attention_backend: str | None = "flash" if self.device.type == "cuda" else None
        self.loader = None
        # seconds train() waited for each batch of the loader
        self.data_wait_s: list[float] = []
        self.step_times: dict[str, float] = {}
        self._lap_t = 0.0
        self._log_file = None
        self._tb = None  # a tensorboard SummaryWriter when report_to asks for it
        self._wandb = None  # a WandbOfflineRun when report_to is wandb or all

    # ------------------------------------------------------------------
    # Components
    # ------------------------------------------------------------------

    def load_components(self) -> None:
        args, cfg = self.args, self.config
        # the frozen bidirectional RAFT of --use_optical_flow (reference
        # trainer.py:433-434: built, consumed by nothing in the released
        # recipe; the flow toolkit is models/flow_fusion.py), checked before
        # the DiT is built
        self.raft = None
        if args.use_optical_flow:
            if not args.raft_weights or not Path(args.raft_weights).exists():
                raise FileNotFoundError(
                    "--use_optical_flow needs --raft_weights pointing at "
                    "raft-things.pth (the reference hardcodes "
                    "utils/RAFT/raft-things.pth and fails the same way)")
            from dove_tpu_torch.models.raft import load_raft

            self.raft = load_raft(args.raft_weights, self.device)
        model_dir = Path(args.model_path)
        if (model_dir / "transformer").exists():
            self.dit = weights.load_dit(model_dir, cfg.dit, self.dtype, self.device)
            self.vae = weights.load_vae(model_dir, cfg.vae, self.dtype, self.device)
        else:
            logger.warning("model_path %s has no checkpoint; using random init",
                           model_dir)
            self.dit = init_dit_params(cfg.dit, seed=0, device=self.device,
                                       dtype=self.dtype)
            self.vae = init_vae_params(cfg.vae, seed=1, device=self.device,
                                       dtype=self.dtype)
        emb_path = (Path(args.data_root) / "cache" / args.prompt_cache
                    / f"{EMPTY_PROMPT_SHA}.safetensors")
        if args.empty_prompt and emb_path.exists():
            emb = weights.load_prompt_embedding(emb_path, torch.float32)
        else:
            emb = torch.zeros((cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim))
        self.empty_prompt = emb.to(self.device)
        if args.training_type == "lora":
            self.lora_params = init_lora_params(
                cfg.dit, rank=args.rank, seed=2, device=self.device)
            self.lora_scale = args.lora_alpha / args.rank
        else:
            self.dit.requires_grad_(True)
        g = self._model_group()
        if args.tensor_parallel > 1:
            shard_dit_tp(self.dit, g)
        elif g is not None:
            shard_params(self.dit, self.mesh)

    def _model_group(self) -> Group | None:
        return self.mesh.axis_group("model")

    def _split(self, name: str, t: torch.Tensor) -> Split | None:
        """How the DiT tensor ``name`` is cut over "model" (FSDP's DTensor
        placement, or its TP split), None where every rank holds it whole."""
        g = self._model_group()
        if g is None:
            return None
        if hasattr(t, "placements"):
            return Split(t.placements[0].dim, tuple(t.shape), g)
        dim = tp_dim(name) if self.dit.tp is not None else None
        if dim is None:
            return None
        shape = list(t.shape)
        shape[dim] *= g.size
        return Split(dim, tuple(shape), g)

    def trainable_splits(self) -> list[Split | None]:
        """``_split`` of each trainable tensor (LoRA's stay whole)."""
        if self.args.training_type == "lora":
            return [None] * len(self.trainable_tensors())
        return [self._split(n, p) for n, p in self.dit.named_parameters()]

    @property
    def components(self) -> components_mod.Components:
        from dove_tpu_torch.pipeline import DovePipeline

        return components_mod.Components(
            pipeline_cls=DovePipeline,
            vae=getattr(self, "vae", None),
            transformer=getattr(self, "dit", None),
            scheduler=self.schedule,
        )

    @property
    def state(self) -> components_mod.State:
        f, h, w = self.args.train_resolution
        n_trainable = (sum(t.numel() for t in self.trainable_tensors())
                       if hasattr(self, "dit") else 0)
        return components_mod.State(
            train_frames=f, train_height=h, train_width=w,
            transformer_config=dataclasses.asdict(self.config.dit),
            weight_dtype=self.dtype,
            num_trainable_parameters=n_trainable,
            generator=torch.Generator(device=self.device).manual_seed(
                self.args.seed or 0),
        )

    def trainable_tensors(self) -> list[torch.Tensor]:
        """The LoRA tree's eight tensors, or the DiT's parameters under sft."""
        if self.args.training_type == "lora":
            return [self.lora_params[t][ab] for t in TARGETS for ab in ("A", "B")]
        return list(self.dit.parameters())

    def _trainable_state(self) -> dict[str, Any]:
        """The LoRA tree, or the DiT's whole state dict (gathered from the
        ranks' shards: a collective under FSDP or TP). FSDP's shards are
        gathered as TP's are, through ``Split.gather``: DTensor's
        ``full_tensor`` takes functional collectives, which crash over gloo
        on CUDA tensors (torch 2.11; chip_smoke.py phase 34)."""
        if self.args.training_type == "lora":
            return {t: {ab: x.detach() for ab, x in d.items()}
                    for t, d in self.lora_params.items()}
        out = {}
        for k, v in self.dit.state_dict().items():
            sp = self._split(k, v)
            out[k] = v if sp is None else sp.gather(_local(v))
        return out

    def prepare_dataset(self) -> None:
        """The dataset of ``model_type`` and its loader, as the JAX trainer
        builds them. With ``is_latent`` the missing latents are encoded and
        cached here, in this process, before any worker starts."""
        from dove_tpu_torch.data.datasets import RealSRDataset, RealSRImageVideoDataset
        from dove_tpu_torch.data.loader import Loader

        args = self.args
        F, H, W = args.train_resolution
        common = dict(
            data_root=args.data_root,
            video_manifest=args.video_column,
            max_num_frames=F,
            height=H,
            width=W,
            degradation_config=args.degradation_config,
            caption_manifest=args.caption_column,
            empty_ratio=args.empty_ratio,
            # is_prompt_latent (reference trainer.py:279) forces the prompt
            # cache even when is_cache is off
            cache_prompts=args.is_cache or args.is_prompt_latent,
            prompt_cache=args.prompt_cache,
            seed=args.seed or 0,
        )
        if args.is_latent:
            common.update(is_latent=True, encode_video=self._encode_np,
                          model_name=args.model_name)
        if args.model_type == "real-sr":
            self.dataset = RealSRDataset(**common)
        else:
            self.dataset = RealSRImageVideoDataset(
                image_data_root=args.image_data_root,
                image_manifest=args.image_column, **common)
        if args.is_latent:
            # rank 0 encodes and writes the cache; the others then find it
            if not self.is_main:
                dist_mod.barrier()
            n = self.dataset.fill_latent_cache()
            if self.is_main:
                dist_mod.barrier()
            logger.info("latent cache: encoded %d of %d items", n, len(self.dataset))
            self.dataset.encode_video = None  # workers read the cache only
        # every rank builds the same batch order and keeps its data row's
        # slice (the JAX package's process_shard)
        self.loader = Loader(self.dataset, batch_size=args.batch_size,
                             num_workers=args.num_workers, drop_last=True,
                             seed=args.seed or 0,
                             process_shard=(self.mesh.coord("data"), self.mesh.shape["data"]))

    def _encode_np(self, frames: np.ndarray) -> np.ndarray:
        """The latent cache's encode: [F, H, W, 3] in [-1, 1] -> the scaled
        posterior mean [F', h, w, C], fp32 on the host."""
        video = torch.from_numpy(np.ascontiguousarray(frames))[None]
        lat = self._encode(video.to(self.device, torch.float32), None)
        return lat[0].float().cpu().numpy()

    # ------------------------------------------------------------------
    # Optimizer and the train step
    # ------------------------------------------------------------------

    def prepare_optimizer(self, total_steps: int) -> None:
        args = self.args
        lr = make_lr_schedule(
            args.learning_rate, warmup_steps=args.lr_warmup_steps,
            total_steps=total_steps, kind=args.lr_scheduler,
            num_cycles=args.lr_num_cycles, power=args.lr_power,
        )
        self.optimizer = make_optimizer(
            args.optimizer, lr, betas=(args.beta1, args.beta2), beta3=args.beta3,
            eps=args.epsilon, weight_decay=args.weight_decay,
            max_grad_norm=args.max_grad_norm,
        )
        if args.gradient_accumulation_steps > 1:
            self.optimizer = MultiSteps(self.optimizer, args.gradient_accumulation_steps)
        with torch.no_grad():
            # under FSDP or TP the optimizer takes each split tensor's
            # statistics over the whole tensor (train/optim.py)
            self.optimizer.init([_local(p) for p in self.trainable_tensors()],
                                self.trainable_splits())

    def dit_kwargs(self) -> dict[str, Any]:
        """The DiT's training forward: LoRA merged in, checkpointed blocks."""
        kw: dict[str, Any] = dict(
            attention_backend=self.attention_backend,
            gradient_checkpointing=self.args.gradient_checkpointing,
        )
        if self.args.training_type == "lora":
            kw.update(lora=self.lora_params, lora_scale=self.lora_scale)
        return kw

    def compute_loss(self, batch: dict[str, torch.Tensor], step: int):
        raise NotImplementedError

    def generator(self, step: int, stream: int) -> torch.Generator:
        """A generator for one random stream of one step, seeded from
        (seed, step, stream)."""
        return torch.Generator(device=self.device).manual_seed(
            _seed(self.args.seed or 0, step, stream))

    def _part(self) -> tuple[int, int] | None:
        """This rank's share of the batch's noise draws (its data row)."""
        d = self.mesh.shape["data"]
        return (self.mesh.coord("data"), d) if d > 1 else None

    def _encode(self, video: torch.Tensor, generator: torch.Generator | None,
                per_frame: bool = False) -> torch.Tensor:
        """Pixels [B, F, H, W, 3] in [-1, 1] -> scaled latent [B, F', h, w, C],
        sampled from the posterior (its mean when generator is None); a data
        rank takes its slice of the whole batch's noise.

        per_frame encodes each frame as a 1-frame clip of its own (stage 2:
        reference lora_one_s2_trainer.py:141-145), so F' == F."""
        B, F = video.shape[:2]
        if per_frame:
            video = video.reshape((B * F, 1) + video.shape[2:])
        with torch.no_grad():
            moments = encode_moments(self.config.vae, self.vae, video.to(self.dtype))
            part = self._part()
            sf = self.config.vae.scaling_factor
            lat = (sample_latent(moments, generator, sf) if part is None
                   else sample_latent(moments, generator, sf, part))
        return lat.reshape((B, F) + lat.shape[2:]) if per_frame else lat

    def _noise(self, lq_lat: torch.Tensor, step: int) -> torch.Tensor | None:
        """The noise added at ``noise_step`` ([B, F' + pad, C, h, w], the DiT's
        layout), or None when noise_step is 0."""
        if self.config.noise_step == 0:
            return None
        B, F, h, w, C = lq_lat.shape
        return draw_part((B, F + temporal_pad(self.config.dit, F), C, h, w),
                         self.generator(step, 2), self.device, self._part())

    def _barrier(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _lap(self, name: str) -> None:
        """Record the time since the last lap under ``name`` in step_times."""
        self._barrier()
        now = time.perf_counter()
        self.step_times[name] = self.step_times.get(name, 0.0) + now - self._lap_t
        self._lap_t = now

    def loss_and_grads(self, batch: dict[str, torch.Tensor]):
        """The loss of this step's batch and the gradients of the trainable
        tensors -> (loss, aux, grads); the tensors' ``.grad`` are left
        empty."""
        params = self.trainable_tensors()
        for p in params:
            p.grad = None
        loss, aux = self.compute_loss(batch, self.global_step)
        loss.backward()
        grads = [_local(torch.zeros_like(p) if p.grad is None else p.grad) for p in params]
        for p in params:
            p.grad = None
        # clones: an aux term may be the loss itself, reduced once each
        loss, aux = loss.detach().clone(), {k: v.detach().clone() for k, v in aux.items()}
        d = self.mesh.shape["data"]
        if d > 1:  # DDP: the mean over the data rows' equal slices
            group = self.mesh.group("data")
            for t in grads + [loss] + list(aux.values()):
                torch.distributed.all_reduce(t, group=group)
                t.div_(d)
        self._lap("dit_fwd_bwd")
        return loss, aux, grads

    def train_step(self, batch: dict[str, torch.Tensor]):
        """One update -> (loss, aux, grad_norm), all device scalars. Times
        the encode, the DiT's forward and backward, and the optimizer into
        ``step_times``. The encode, the DiT's forward and the optimizer are
        also named ranges ("dove.train.encode", "dove.train.dit_fwd",
        "dove.train.optimizer") in a torch.profiler trace; the backward runs
        on autograd's own thread, outside them."""
        self.step_times = {}
        self._barrier()
        self._lap_t = time.perf_counter()
        loss, aux, grads = self.loss_and_grads(batch)
        with record_function("dove.train.optimizer"), torch.no_grad():
            gnorm = self.optimizer.step([_local(p) for p in self.trainable_tensors()], grads)
        self._lap("optimizer")
        return loss, aux, gnorm

    def device_batch(self, batch: dict[str, Any]) -> dict[str, torch.Tensor]:
        """A batch of NumPy arrays or tensors -> fp32 tensors on the device,
        with the empty-prompt embedding where the batch has none."""
        arrays = (np.ndarray, torch.Tensor)
        B = next(v.shape[0] for v in batch.values() if isinstance(v, arrays))
        embs = batch.get("prompt_embedding")
        if embs is None or (isinstance(embs, list) and any(e is None for e in embs)):
            emb = self.empty_prompt[None].expand(B, -1, -1)
        else:
            emb = torch.as_tensor(np.stack(embs) if isinstance(embs, list) else embs)
        out = {"prompt_embeds": emb.to(self.device, torch.float32)}
        for k in BATCH_KEYS:
            if isinstance(batch.get(k), arrays):
                out[k] = torch.as_tensor(batch[k]).to(self.device, torch.float32)
        return out

    # ------------------------------------------------------------------
    # fit / train
    # ------------------------------------------------------------------

    def fit(self) -> None:
        args = self.args
        args.output_dir.mkdir(parents=True, exist_ok=True)
        if self.is_main:  # rank 0 writes the logs
            args.dump_yaml(args.output_dir / "args.yaml")
            self._log_file = open(args.output_dir / "train_log.jsonl", "a")
            # which video-compression backend synthesizes the MPEG artifacts
            # (the reference's PyAV, or a fallback), as the JAX trainer records
            from dove_tpu_torch.data.degradation import compression_backend

            backend_rec = {"video_compression_backend": compression_backend()}
            logger.info("%s", backend_rec)
            self._log_file.write(json.dumps(backend_rec) + "\n")
            self._log_file.flush()
            self._open_trackers()
        self.load_components()
        self.prepare_dataset()
        steps_per_epoch = max(len(self.loader), 1)
        total_steps = args.train_steps or steps_per_epoch * args.train_epochs
        self.prepare_optimizer(total_steps)
        self.maybe_resume()
        self.train(total_steps, steps_per_epoch)

    def _open_trackers(self) -> None:
        """The trackers ``report_to`` asks for, as the JAX trainer opens them."""
        args = self.args
        if args.report_to in ("tensorboard", "all"):
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(args.output_dir / "tb" / args.tracker_name))
            except Exception as e:  # no tensorboard backend: an optional tracker
                logger.warning("tensorboard writer unavailable (%s); "
                               "falling back to jsonl only", e)
        if args.report_to in ("wandb", "all"):
            from dove_tpu_torch.train.tracking import WandbOfflineRun

            self._wandb = WandbOfflineRun(
                args.output_dir, project=args.tracker_name,
                config={k: (str(v) if isinstance(v, Path) else v)
                        for k, v in args.model_dump().items()})

    def _close_trackers(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None

    def maybe_resume(self) -> None:
        args = self.args
        if args.resume_from_checkpoint:
            resume = (int(str(args.resume_from_checkpoint).rsplit("-", 1)[-1]),
                      args.resume_from_checkpoint)
        else:
            resume = ckpt_mod.latest_checkpoint(args.output_dir)
        if resume is None:
            return
        step, path = resume
        # the checkpoint holds the whole state: every rank reads it and cuts
        # its shards where "model" splits a tensor (Split.take), then each
        # tensor is held to the live one's shape and copied into it
        raw = ckpt_mod.load_state(path)
        if args.training_type == "lora":
            live = {t: {ab: x.detach() for ab, x in d.items()}
                    for t, d in self.lora_params.items()}
        else:
            state = self.dit.state_dict()
            live = {k: _local(v) for k, v in state.items()}
            cut = {k: self._split(k, v) for k, v in state.items()}
            raw["trainable"] = {k: x if cut.get(k) is None else cut[k].take(x)
                                for k, x in raw["trainable"].items()}
        raw["opt_state"] = self.optimizer.map_shards(raw["opt_state"],
                                                     lambda sp, t: sp.take(t))
        restored = ckpt_mod.restore_state(
            raw, {"trainable": live, "opt_state": self.optimizer.state_dict()})
        with torch.no_grad():
            for t, x in live.items():
                if isinstance(x, dict):  # a LoRA target's A and B
                    for ab, y in x.items():
                        y.copy_(restored["trainable"][t][ab])
                else:
                    x.copy_(restored["trainable"][t])
        self.optimizer.load_state_dict(restored["opt_state"])
        self.global_step = step
        logger.info("resumed from %s at step %d", path, step)

    def train(self, total_steps: int, steps_per_epoch: int) -> None:
        args = self.args
        t_start = time.time()
        epoch = self.global_step // max(steps_per_epoch, 1)

        # SIGTERM/SIGINT: checkpoint at the next step boundary and stop
        stop_requested = {"flag": False}

        def _request_stop(signum, frame):
            logger.warning("signal %s: will checkpoint and stop", signum)
            stop_requested["flag"] = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _request_stop)
            except ValueError:  # not the main thread
                pass

        while self.global_step < total_steps and not stop_requested["flag"]:
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(epoch)
            batches = iter(self.loader)
            while self.global_step < total_steps and not stop_requested["flag"]:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                self.data_wait_s.append(time.perf_counter() - t0)
                loss, aux, gnorm = self.train_step(self.device_batch(batch))
                self.global_step += 1
                self.log_step(loss, aux, gnorm, t_start)
                if args.stastic_frequency and (
                        self.global_step % args.stastic_frequency == 0):
                    self.log_memory()
                if self.global_step % args.checkpointing_steps == 0:
                    self.save(self.global_step)
                if (args.do_validation and args.validation_steps
                        and self.global_step % args.validation_steps == 0):
                    self.validate(self.global_step)
            del batches  # ends this epoch's loader workers
            epoch += 1

        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
        self.save(self.global_step)
        if self._log_file:
            self._log_file.close()
            self._log_file = None
        self._close_trackers()

    # ------------------------------------------------------------------
    # Logging / checkpoint / export
    # ------------------------------------------------------------------

    def log_step(self, loss, aux, gnorm, t_start) -> None:
        rec = {
            "step": self.global_step,
            "loss": float(loss),
            "grad_norm": float(gnorm),
            "elapsed_s": round(time.time() - t_start, 1),
        }
        rec.update({k: float(v) for k, v in aux.items()})
        logger.info("%s", rec)
        if self._log_file:
            self._log_file.write(json.dumps(rec) + "\n")
            self._log_file.flush()
        scalars = {k: v for k, v in rec.items()
                   if isinstance(v, (int, float)) and k != "step"}
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"train/{k}", v, self.global_step)
        if self._wandb is not None:
            self._wandb.log({f"train/{k}": v for k, v in scalars.items()},
                            self.global_step)

    def log_memory(self) -> None:
        if self.device.type != "cuda":
            return
        rec = {
            "step": self.global_step,
            "bytes_in_use": torch.cuda.memory_allocated(self.device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(self.device),
        }
        logger.info("memory %s", rec)
        if self._log_file:
            self._log_file.write(json.dumps({"memory": rec}) + "\n")

    def save(self, step: int) -> Path:
        """The whole state (gathered from the shards under a mesh), written
        by rank 0; every rank returns when the file is there."""
        opt_state = self.optimizer.map_shards(self.optimizer.state_dict(),
                                              lambda sp, t: sp.gather(t))
        state = {"trainable": self._trainable_state(), "opt_state": opt_state}
        path = self.args.output_dir / f"{ckpt_mod.CHECKPOINT_PREFIX}{step}"
        if self.is_main:
            path = ckpt_mod.save_checkpoint(self.args.output_dir, step, state,
                                            limit=self.args.checkpointing_limit)
            logger.info("saved checkpoint %s", path)
        dist_mod.barrier()
        return path

    def export(self, out_dir: str | Path) -> None:
        """The deployable export: peft LoRA weights, or the DiT in diffusers
        layout under sft."""
        if self.args.training_type == "lora":
            if self.is_main:
                ckpt_mod.export_lora_safetensors(
                    self.lora_params, Path(out_dir) / "pytorch_lora_weights.safetensors")
        else:
            state = self._trainable_state()  # gathered: every rank takes part
            base = Path(self.args.model_path) / "transformer" / "config.json"
            if self.is_main:
                ckpt_mod.export_dit_safetensors(
                    state, Path(out_dir) / "transformer",
                    base_config=base if base.exists() else None)
        dist_mod.barrier()

    def validate(self, step: int) -> dict[str, float]:
        """One-step SR on the held-out clips of ``validation_dir`` (video
        files or frame folders) and the metrics of ``eval_metric_list``
        (reference trainer.py:642-871; the JAX trainer's ``validate``).

        The live DiT serves, its LoRA merged inside each layer's forward, so
        no second copy of the weights is made; the staged path with
        ``enable_tiling``, the fused one otherwise. A metric whose weights
        are missing warns and is skipped; an unknown name raises.
        Under a mesh every rank serves every clip: under TP over the mesh on
        the staged path (the JAX package's rule), under DDP over the "data"
        ranks, under FSDP each rank alone (its DiT gathers its shards); rank
        0 writes and scores, and every rank returns its summary.
        Full-reference metrics take the clip of the same name under
        ``validation_ref_videos``, cropped to the common shape. Each clip's
        SR is written as ``<stem>.mp4`` where OpenCV imports, else as the
        PNG frame folder ``<stem>/`` (the card, ROADMAP C.2); the record in
        train_log.jsonl says which. Grad mode, the modules' train/eval
        modes, the global generators and the hand-conv switch are restored
        afterwards."""
        args = self.args
        if not args.validation_dir:
            return {}
        from dove_tpu_torch.eval.metrics import FULL_REFERENCE, get_metric
        from dove_tpu_torch.io import video as video_io
        from dove_tpu_torch.models import vae as vae_mod
        from dove_tpu_torch.pipeline import DovePipeline

        metric_names = [m.strip() for m in (args.eval_metric_list or "psnr,ssim").split(",")
                        if m.strip()]
        metric_fns = {}
        for name in metric_names:
            try:
                metric_fns[name] = get_metric(name, self.device)
            except NotImplementedError as e:  # weights-gated: keep training
                logger.warning("validation metric %s unavailable: %s", name, e)
        try:
            import cv2  # noqa: F401

            artifact_kind = "mp4"
        except ImportError:
            artifact_kind = "png"
        out_dir = Path(args.output_dir) / "validation_res" / f"Step-{step}"
        out_dir.mkdir(parents=True, exist_ok=True)
        ref_dir = Path(args.validation_ref_videos) if args.validation_ref_videos else None
        clips = sorted(p for p in Path(args.validation_dir).iterdir()
                       if p.suffix.lower() in video_io.VIDEO_EXTS or p.is_dir())
        results: dict[str, list[float]] = {k: [] for k in metric_fns}

        modes = [(m, m.training) for m in (self.dit, self.vae)]
        prior_conv = vae_mod._HAND_BF16_CONV
        cpu_rng = torch.get_rng_state()
        cuda_rng = (torch.cuda.get_rng_state(self.device)
                    if self.device.type == "cuda" else None)
        lora = self.lora_params if self.args.training_type == "lora" else None
        tp = args.tensor_parallel > 1
        serve_mesh = (self.mesh if self.mesh.size > 1
                      and (tp or self.mesh.shape["model"] == 1) else None)
        try:
            with torch.no_grad():
                pipe = DovePipeline(
                    config=self.config, dit=self.dit, vae=self.vae,
                    prompt_embedding=self.empty_prompt, dtype=self.dtype,
                    device=self.device, vae_tiling=args.enable_tiling or tp,
                    lora=lora, lora_scale=getattr(self, "lora_scale", 1.0),
                    inference_mode=False)
                for clip in clips:
                    frames = video_io.load_sequence(clip)
                    sr = pipe.process_frames(frames, mesh=serve_mesh)
                    if not self.is_main:
                        continue
                    if artifact_kind == "mp4":
                        video_io.save_video(sr, out_dir / f"{clip.stem}.mp4",
                                            fps=args.gen_fps)
                        if self._wandb is not None:  # wandb.Video's record
                            self._wandb.log_video(f"validation/{clip.stem}",
                                                  out_dir / f"{clip.stem}.mp4", step)
                    else:
                        video_io.save_frames_as_png(sr, out_dir / clip.stem)
                    ref = None
                    if ref_dir is not None and (ref_dir / clip.name).exists():
                        ref = video_io.load_sequence(ref_dir / clip.name)
                    for name, fn in metric_fns.items():
                        if name in FULL_REFERENCE:
                            if ref is None:
                                continue
                            n = min(len(ref), len(sr))
                            h = min(ref.shape[1], sr.shape[1])
                            w = min(ref.shape[2], sr.shape[2])
                            val = fn(sr[:n, :h, :w], ref[:n, :h, :w])
                        else:  # no-reference metrics score the SR clip alone
                            val = fn(sr)
                        results[name].append(float(val))
        finally:
            for m, training in modes:
                m.train(training)
            vae_mod.set_pallas_conv(prior_conv)
            torch.set_rng_state(cpu_rng)
            if cuda_rng is not None:
                torch.cuda.set_rng_state(cuda_rng, self.device)
        summary = dist_mod.broadcast_object(
            {n: float(np.sum(results[n]) / len(results[n]))
             for n in sorted(results) if results[n]})
        rec = {"step": step, "validation": summary, "artifact": artifact_kind}
        logger.info("%s", rec)
        if self._log_file:
            self._log_file.write(json.dumps(rec) + "\n")
            self._log_file.flush()
        if self._tb is not None:
            for k, v in summary.items():
                self._tb.add_scalar(f"validation/{k}", v, step)
        if self._wandb is not None:
            self._wandb.log({f"validation/{k}": v for k, v in summary.items()}, step)
        return summary


# ---------------------------------------------------------------------------
# Stage trainers
# ---------------------------------------------------------------------------

class DOVES1Trainer(Trainer):
    """Stage 1: latent-space MSE (reference lora_one_s1_trainer.py:116-209)."""

    stage = 1

    def compute_loss(self, batch: dict[str, torch.Tensor], step: int):
        if "lq_latent" in batch:  # precomputed latents
            lq_lat, hq_lat = batch["lq_latent"], batch["hq_latent"]
        else:
            with record_function("dove.train.encode"):
                lq_lat = self._encode(batch["lq_video"], self.generator(step, 0))
                hq_lat = self._encode(batch["hq_video"], self.generator(step, 1))
        self._lap("encode")
        lq_lat = lq_lat.to(self.dtype)
        loss_batch = {"lq_latent": lq_lat, "hq_latent": hq_lat,
                      "prompt_embeds": batch["prompt_embeds"]}
        with record_function("dove.train.dit_fwd"):
            return losses.stage1_loss(self.config, self.schedule, self.dit, loss_batch,
                                      self._noise(lq_lat, step), **self.dit_kwargs())


class DOVES2Trainer(Trainer):
    """Stage 2: the pixel-space composite loss (reference
    lora_one_s2_trainer.py)."""

    stage = 2

    def load_components(self) -> None:
        super().load_components()
        a = self.args
        self.perceptual_fn = None
        weights_on = any(w > 0 for w in (a.dists_weight, a.ea_dists_weight,
                                          a.lpips_weight, a.ea_lpips_weight))
        if a.use_perceptual_loss and not weights_on:
            logger.warning(
                "use_perceptual_loss=True but every perceptual weight is 0 "
                "— the term contributes nothing (set e.g. --dists_weight)")
        if not (a.use_perceptual_loss or weights_on):
            return
        if a.ea_dists_weight > 0 or a.dists_weight > 0:
            kind, edge = "dists", a.ea_dists_weight > 0
            wpath = os.environ.get("DOVE_DISTS_WEIGHTS")
        else:
            kind, edge = "lpips", a.ea_lpips_weight > 0
            wpath = os.environ.get("DOVE_LPIPS_WEIGHTS")
        if not wpath and not a.allow_random_perceptual:
            raise RuntimeError(
                f"stage-2 perceptual loss requested but no pretrained "
                f"{kind} weights found (set DOVE_{kind.upper()}_WEIGHTS). "
                "A run that silently optimizes random-VGG feature "
                "distance is almost never what you want; pass "
                "--allow_random_perceptual true to opt in explicitly.")
        if not wpath:
            logger.warning(
                "allow_random_perceptual: using RANDOM %s/VGG features "
                "(set DOVE_%s_WEIGHTS for the published recipe)", kind, kind.upper())
        self.perceptual_fn = losses.make_perceptual_fn(
            kind, edge_aware=edge, weights_path=wpath or None, device=self.device)

    def image_step(self, step: int) -> bool:
        """The image-vs-video coin of ``step`` (reference
        lora_one_s2_trainer.py:125), keyed on (seed, step) as in the JAX
        package, so a resumed run makes the same decisions."""
        seed = self.args.seed or 0
        return bool(np.random.default_rng((seed, step)).uniform() < self.args.image_ratio)

    def train_step(self, batch: dict[str, torch.Tensor]):
        """One update on the batch's image pair when it has one and this
        step's coin says so, else on its clip."""
        if "hq_image" in batch and self.image_step(self.global_step):
            batch = {**batch, "hq_video": batch["hq_image"],
                     "lq_video": batch["lq_image"]}
        batch = {k: v for k, v in batch.items()
                 if k in ("hq_video", "lq_video", "prompt_embeds")}
        return super().train_step(batch)

    def compute_loss(self, batch: dict[str, torch.Tensor], step: int):
        with record_function("dove.train.encode"):
            lq_lat = self._encode(batch["lq_video"], self.generator(step, 0),
                                  per_frame=True)
        self._lap("encode")
        lq_lat = lq_lat.to(self.dtype)
        loss_batch = {"lq_latent": lq_lat, "hq_video": batch["hq_video"],
                      "prompt_embeds": batch["prompt_embeds"]}
        a = self.args
        # the reference takes exactly ONE perceptual term, by elif precedence
        # (lora_one_s2_trainer.py:245-277: ea_dists > dists > ea_lpips > lpips)
        perceptual_weight = next(
            (w for w in (a.ea_dists_weight, a.dists_weight, a.ea_lpips_weight,
                         a.lpips_weight) if w > 0), 0.0)
        return losses.stage2_loss(
            self.config, self.schedule, self.dit, self.vae, loss_batch,
            self._noise(lq_lat, step), pixel_weight=1.0,
            perceptual_weight=perceptual_weight,
            frame_diff_weight=a.frame_diff_weight, perceptual_fn=self.perceptual_fn,
            **self.dit_kwargs())


for _name, _cls in (("dove-s1", DOVES1Trainer), ("dove-s2", DOVES2Trainer)):
    register(_name, "lora", _cls)
    register(_name, "sft", _cls)  # SFT: the same math, the whole DiT trains
