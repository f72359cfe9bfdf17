"""Training configuration: the JAX package's ``Args`` as a dataclass.

Counterpart of ``dove_tpu/train/args.py`` (a pydantic model there; the
machine with the card has no pydantic). The fields, their names and defaults
and the validators are the JAX package's: the FxHxW parse, H and W multiples
of 16, the (F - 1) % 4 frame rule of stage 1's clip-level encode, the
timestep range, the validation requirements. ``parse_args`` is the argparse
bridge and ``dump_yaml`` writes ``args.yaml`` without PyYAML.

The mesh options (``data_parallel``, ``fsdp``, ``tensor_parallel``,
``multihost``) are the trainer's (``parallel/``), with every optimizer;
``use_optical_flow`` loads the frozen RAFT from ``raft_weights``, as in the
JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import typing
from pathlib import Path
from typing import Any, Optional

MODEL_TYPES = ("real-sr", "real-sr-image-video")
TRAINING_TYPES = ("lora", "sft")
REPORT_TO = ("tensorboard", "jsonl", "wandb", "all")
MIXED_PRECISION = ("no", "fp16", "bf16")

_DEFAULT_OUTPUT_DIR = Path(
    "train_results/{:%Y-%m-%d-%H-%M-%S}".format(datetime.datetime.now())
)


@dataclasses.dataclass
class Args:
    """All knobs for DOVE stage-1/stage-2 training."""

    ########## Model ##########
    model_path: Path
    model_name: str = "dove-s1"  # registry key: dove-s1 | dove-s2
    model_type: str = "real-sr"  # one of MODEL_TYPES
    training_type: str = "lora"  # one of TRAINING_TYPES
    # architecture preset used when model_path has no transformer/config.json
    base_preset: str = "cogvideox1.5-5b"

    ########## Output ##########
    output_dir: Path = _DEFAULT_OUTPUT_DIR
    report_to: Optional[str] = "jsonl"  # one of REPORT_TO
    tracker_name: str = "VSR"

    ########## Data ##########
    data_root: Path = Path(".")
    image_data_root: Optional[Path] = None
    caption_column: Optional[Path] = None
    image_column: Optional[Path] = None
    video_column: Path = Path("videos.txt")

    ########## Training ##########
    resume_from_checkpoint: Optional[Path] = None
    seed: Optional[int] = 42
    train_epochs: int = 1
    train_steps: Optional[int] = None
    checkpointing_steps: int = 200
    checkpointing_limit: int = 10
    batch_size: int = 1
    gradient_accumulation_steps: int = 1
    train_resolution: tuple[int, int, int] = (25, 320, 640)  # (F, H, W)
    crop_mode: str = "random_crop"  # the only mode the reference implements
    mixed_precision: str = "bf16"  # one of MIXED_PRECISION

    learning_rate: float = 2e-5
    optimizer: str = "adamw"
    beta1: float = 0.9
    beta2: float = 0.95
    beta3: float = 0.9999
    epsilon: float = 1e-8
    weight_decay: float = 1e-4
    max_grad_norm: float = 1.0

    lr_scheduler: str = "constant_with_warmup"
    lr_warmup_steps: int = 100
    lr_num_cycles: int = 1
    lr_power: float = 1.0

    num_workers: int = 8
    gradient_checkpointing: bool = True
    enable_slicing: bool = True
    enable_tiling: bool = False
    stastic_frequency: int = 100  # (sic) reference spelling, kept for parity

    ########## Parallelism (parallel/: one process per device) ##########
    data_parallel: int = 0  # 0 = the ranks left over by the "model" axis
    fsdp: int = 1  # the "model" axis as FSDP (parameter sharding)
    # Megatron-style tensor parallelism for the DiT over the "model" axis;
    # exclusive with fsdp > 1 (both own the "model" axis)
    tensor_parallel: int = 1
    multihost: bool = False  # join the process group (torchrun / DOVE_*)

    ########## LoRA ##########
    rank: int = 128
    lora_alpha: int = 64
    target_modules: list[str] = dataclasses.field(
        default_factory=lambda: ["to_q", "to_k", "to_v", "to_out.0"])

    ########## Validation ##########
    do_validation: bool = False
    validation_steps: Optional[int] = None
    validation_dir: Optional[Path] = None
    validation_videos: Optional[str] = None
    validation_ref_videos: Optional[str] = None
    gen_fps: int = 16
    num_inference_steps: int = 1
    eval_metric_list: str = ""

    ########## SR specifics ##########
    is_latent: bool = False
    is_prompt_latent: bool = False
    is_cache: bool = True
    prompt_cache: str = "prompt_embeddings"
    empty_prompt: bool = True
    empty_ratio: float = 1.0
    sr_noise_step: int = 399
    noise_step: int = 0
    degradation_config: str = "configs/degradation.yaml"
    image_ratio: float = 0.0
    use_optical_flow: bool = False
    is_learnable_fuse: bool = False
    raft_weights: Optional[Path] = None

    ########## Stage-2 losses ##########
    use_perceptual_loss: bool = False
    allow_random_perceptual: bool = False
    ea_dists_weight: float = 0.0
    dists_weight: float = 0.0
    ea_lpips_weight: float = 0.0
    lpips_weight: float = 0.0
    frame_diff_weight: float = 0.0

    def __post_init__(self) -> None:
        hints = typing.get_type_hints(type(self))
        for f in dataclasses.fields(self):
            setattr(self, f.name, _coerce(hints[f.name], getattr(self, f.name), f.name))
        for name, allowed in (("model_type", MODEL_TYPES),
                              ("training_type", TRAINING_TYPES),
                              ("mixed_precision", MIXED_PRECISION),
                              ("crop_mode", ("random_crop",))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{getattr(self, name)!r}")
        if self.report_to is not None and self.report_to not in REPORT_TO:
            raise ValueError(f"report_to must be one of {REPORT_TO} or None")
        self._check_resolution()
        self._check_frame_rule()
        self._check_validation()

    def _check_resolution(self) -> None:
        f, h, w = self.train_resolution
        if h % 16 or w % 16:
            raise ValueError(f"H and W must be multiples of 16, got {h}x{w}")

    def _check_frame_rule(self) -> None:
        # Stage 2 encodes per frame, so any F >= 1 is legal there; stage 1's
        # clip-level encode needs the causal-VAE frame rule.
        f = self.train_resolution[0]
        if not self.model_name.endswith("s2") and (f - 1) % 4 != 0:
            raise ValueError(
                f"frames must satisfy (F-1)%4==0 for clip-level VAE encode, "
                f"got {f} (stage-2 trainers encode per frame and accept any F)"
            )

    def _check_validation(self) -> None:
        if self.do_validation and not self.validation_dir:
            raise ValueError("do_validation requires validation_dir")
        if self.model_type == "real-sr-image-video" and self.image_column is None:
            raise ValueError("real-sr-image-video needs image_column")
        for name in ("sr_noise_step", "noise_step"):
            t = getattr(self, name)
            if not 0 <= t < 1000:  # CogVideoX scheduler table length
                raise ValueError(f"{name}={t} outside [0, 1000)")
        if self.tensor_parallel > 1 and self.fsdp > 1:
            raise ValueError(
                "tensor_parallel and fsdp both shard over the 'model' mesh axis")

    @classmethod
    def parse_args(cls, argv: list[str] | None = None) -> "Args":
        return cls.from_namespace(cls.parser().parse_args(argv))

    @classmethod
    def from_namespace(cls, ns: argparse.Namespace) -> "Args":
        """The Args of a namespace from ``parser()`` (keys that are not
        fields, which a caller's own flags add, are ignored)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(ns).items() if k in names and v is not None})

    @classmethod
    def parser(cls) -> argparse.ArgumentParser:
        """One ``--<field>`` flag per field, as the JAX package's CLI has."""
        parser = argparse.ArgumentParser(description="DOVE training (PyTorch port)")
        hints = typing.get_type_hints(cls)
        for f in dataclasses.fields(cls):
            arg = f"--{f.name}"
            if hints[f.name] is bool:
                parser.add_argument(
                    arg, type=lambda s: s.lower() in ("1", "true", "yes"),
                    default=None)
            elif typing.get_origin(hints[f.name]) is list:
                parser.add_argument(arg, nargs="*", default=None)
            else:
                parser.add_argument(arg, type=str, default=None)
        return parser

    def model_dump(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def dump_yaml(self, path: str | Path) -> None:
        """``key: value`` per field; strings, lists and tuples in JSON's
        notation, which YAML reads as the same values."""
        lines = []
        for k, v in self.model_dump().items():
            if isinstance(v, Path):
                v = str(v)
            if isinstance(v, tuple):
                v = list(v)
            lines.append(f"{k}: {json.dumps(v)}")
        Path(path).write_text("\n".join(lines) + "\n")


def _coerce(tp: Any, value: Any, name: str) -> Any:
    """A value as the field's type (argparse hands in strings, as pydantic's
    coercion takes them in the JAX package)."""
    if value is None:
        if type(None) in typing.get_args(tp):
            return None
        raise ValueError(f"{name} must not be None")
    if typing.get_origin(tp) is typing.Union:
        tp = next(t for t in typing.get_args(tp) if t is not type(None))
    if tp is Path:
        return Path(value)
    if tp is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
        return bool(value)
    if tp in (int, float, str):
        try:
            return tp(value)
        except (TypeError, ValueError) as e:
            raise ValueError(f"{name}: cannot read {value!r} as {tp.__name__}") from e
    if typing.get_origin(tp) is tuple:  # train_resolution: FxHxW or 3 ints
        if isinstance(value, str):
            parts = value.split("x")
            if len(parts) != 3:
                raise ValueError("train_resolution must be FxHxW, e.g. 25x320x640")
            value = parts
        return tuple(int(p) for p in value)
    if typing.get_origin(tp) is list:
        return [str(x) for x in value]
    return value
