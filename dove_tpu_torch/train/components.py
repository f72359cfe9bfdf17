"""Typed Components / State views of a trainer.

Counterpart of ``dove_tpu/train/components.py`` (after the reference's
``finetune/schemas/components.py:6-28`` and ``schemas/state.py:9-30``).
Read-only views that ``Trainer.components`` and ``Trainer.state`` assemble
from the live trainer on access; field names follow the reference one for
one. In the port the model pieces are ``nn.Module``s again (the DiT, the
VAE), the weight dtype a ``torch.dtype`` and the generator a
``torch.Generator``; ``using_fsdp`` stays False until the parallel slice.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

__all__ = ["Components", "State"]


@dataclasses.dataclass(frozen=True)
class Components:
    pipeline_cls: type | None = None      # DovePipeline
    tokenizer: Any = None
    tokenizer_2: Any = None
    tokenizer_3: Any = None
    text_encoder: Any = None              # none: the empty-prompt embedding
    text_encoder_2: Any = None
    text_encoder_3: Any = None
    vae: Any = None                       # AutoencoderKLCogVideoX
    transformer: Any = None               # the base CogVideoXTransformer3D
    unet: Any = None
    scheduler: Any = None                 # ops.scheduler.Schedule


@dataclasses.dataclass(frozen=True)
class State:
    train_frames: int = 0
    train_height: int = 0
    train_width: int = 0
    transformer_config: dict[str, Any] | None = None
    weight_dtype: Any = None
    num_trainable_parameters: int = 0
    overwrote_max_train_steps: bool = False
    num_update_steps_per_epoch: int = 0
    total_batch_size_count: int = 0
    generator: Any = None
    validation_videos: list[str] = dataclasses.field(default_factory=list)
    validation_ref_videos: list[Path | None] = dataclasses.field(default_factory=list)
    validation_prompts: list[Path | None] = dataclasses.field(default_factory=list)
    validation_images: list[Path | None] = dataclasses.field(default_factory=list)
    using_fsdp: bool = False

    @property
    def using_deepspeed(self) -> bool:  # reference-name alias
        return self.using_fsdp
