"""Stage-1 LoRA fine-tuning (``scripts/train_s1.sh``) through ``DOVES1Trainer``.

One unit of work is one ``train_step`` on a fresh batch made on the device
from the seed (HQ clips of smooth random fields in [-1, 1], their LQ 4x
area-down and bilinear back up, the dataset's layout); the data loader is
left out. The rate is samples per second.

Set-up builds the trainer once, with the benchmark's seeded DiT, VAE,
empty-prompt embedding and LoRA factors, and drives it through ``FIRST``
steps through the same feed and ``train_step`` the window then continues
with. It keeps what the optimizer saw and did there: each step's loss, each
leaf's first gradient (from AdamW's first moment after one step) and each
leaf's change after the last. The check frees the trainer and runs the plain
float32 reference over the same batches from the same start.
"""

from __future__ import annotations

import gc
import statistics

import torch
import torch.nn.functional as F

from benchmark import weights
from benchmark.program import build_models, pipeline_config
from benchmark.reference.models import fp8_linear
from benchmark.reference.train import lora_steps

RATE = "train_samples_per_s"
FIRST = 3  # steps the reference follows
VARIANTS = ("fp8",)  # the control: the reference in float8 in the program's place
MIXED = {"bfloat16": "bf16", "float16": "fp16", "float32": "no"}


def batch(seed: int, step: int, size: int, frames: int, h: int, w: int, device):
    """HQ clips [size, frames, h, w, 3] in [-1, 1] and their LQ, on the device."""
    gen = torch.Generator(device=device).manual_seed(weights.derive(seed, weights.BATCH, step))
    coarse = torch.rand((size, 3, frames // 4 + 1, h // 32, w // 32), generator=gen,
                        device=device)
    hq = F.interpolate(coarse, size=(frames, h, w), mode="trilinear",
                       align_corners=False) * 2 - 1
    flat = hq.permute(0, 2, 1, 3, 4).reshape(-1, 3, h, w)
    lq = F.interpolate(F.avg_pool2d(flat, 4), scale_factor=4, mode="bilinear",
                       align_corners=False).reshape(size, frames, 3, h, w)
    return {"hq_video": hq.permute(0, 2, 3, 4, 1).contiguous(),
            "lq_video": lq.permute(0, 1, 3, 4, 2).contiguous()}


def hyper(mix: dict, seed: int) -> dict:
    return dict(seed=weights.derive(seed, weights.BATCH), lr=mix["learning_rate"],
                warmup=mix["lr_warmup_steps"], beta1=mix["beta1"], beta2=mix["beta2"],
                eps=mix["epsilon"], weight_decay=mix["weight_decay"],
                max_grad_norm=mix["max_grad_norm"],
                lora_scale=mix["lora_alpha"] / mix["rank"])


class Job:
    def __init__(self, cell):
        from dove_tpu_torch.train.args import Args
        from dove_tpu_torch.train.lora import TARGETS
        from dove_tpu_torch.train.trainer import DOVES1Trainer

        self.cell = cell
        mix, cfg = cell.mix, pipeline_config(cell.config)
        if cell.variant is not None and cell.variant not in VARIANTS:
            raise ValueError(f"unknown variant {cell.variant!r}")
        self.hp = hyper(mix, cell.seed)
        self.shape = (mix["batch_size"], *mix["resolution"])
        args = Args(
            model_path="no-checkpoint", model_name="dove-s1", training_type="lora",
            rank=mix["rank"], lora_alpha=mix["lora_alpha"],
            train_resolution=tuple(mix["resolution"]), batch_size=mix["batch_size"],
            train_steps=mix["train_steps"], learning_rate=mix["learning_rate"],
            lr_scheduler=mix["lr_scheduler"], lr_warmup_steps=mix["lr_warmup_steps"],
            beta1=mix["beta1"], beta2=mix["beta2"], epsilon=mix["epsilon"],
            weight_decay=mix["weight_decay"], max_grad_norm=mix["max_grad_norm"],
            mixed_precision=MIXED[cell.config["dtype"]], gradient_checkpointing=True,
            sr_noise_step=cell.config["sr_noise_step"],
            noise_step=cell.config["noise_step"], num_workers=0, seed=self.hp["seed"])
        tr = DOVES1Trainer(args, pipeline_config=cfg, device=cell.device)
        # load_components' LoRA case, with the benchmark's tensors
        tr.raft = None
        tr.dit, tr.vae = build_models(tr.config, cell.seed, tr.dtype, cell.device)
        tr.empty_prompt = weights.prompt_embedding(
            cell.seed, cfg.dit.max_text_seq_length, cfg.dit.text_embed_dim,
            tr.dtype, cell.device).float()
        tr.lora_params = self.lora0(TARGETS, cfg)
        for ab in tr.lora_params.values():
            for t in ab.values():
                t.requires_grad_()
        tr.lora_scale = args.lora_alpha / args.rank
        tr.prepare_optimizer(args.train_steps)
        self.tr, self.targets = tr, TARGETS
        _plant(tr, cell.fault)
        start = {f"{t}.{ab}": x.detach().clone() for t, d in tr.lora_params.items()
                 for ab, x in d.items()}
        self.readings = {"loss": [], "grad": {}, "change": {}}
        for s in range(FIRST):
            loss, _, _ = self._step(s)
            self.readings["loss"].append(float(loss))
            if s == 0:
                b1 = self.hp["beta1"]
                self.readings["grad"] = {
                    name: float(m.norm()) / (1 - b1)
                    for name, m in zip(start, tr.optimizer.mu)}
        self.readings["change"] = {
            name: float((x.detach() - start[name]).norm())
            for name, x in zip(start, tr.trainable_tensors())}
        del start

    def lora0(self, targets, cfg) -> dict:
        return weights.lora(self.cell.seed, cfg.dit.num_layers, cfg.dit.hidden_dim,
                            self.cell.mix["rank"], targets, self.cell.device)

    def _step(self, s: int):
        tr = self.tr
        b = tr.device_batch(batch(self.cell.seed, s, *self.shape, self.cell.device))
        out = tr.train_step(b)
        tr.global_step += 1
        return out

    def step(self, i: int) -> dict:
        self._step(FIRST + i)
        return dict(self.tr.step_times, units=self.shape[0])

    def check(self) -> dict:
        cell, targets = self.cell, self.targets
        cfg = self.tr.config
        got = self.readings
        del self.tr
        gc.collect()
        if cell.device.type == "cuda":
            torch.cuda.empty_cache()
        c = cell.config
        dit_w, vae_w, prompt = weights.for_reference(c, cell.seed, cell.dtype, cell.device)
        batches = [batch(cell.seed, s, *self.shape, cell.device) for s in range(FIRST)]
        lora0 = self.lora0(targets, cfg)
        want = lora_steps(dit_w, vae_w, c, lora0, batches, prompt, self.hp)
        if cell.variant == "fp8":
            got = lora_steps(dit_w, vae_w, c, lora0, batches, prompt, self.hp,
                             linear=fp8_linear)
        return gaps(got, want)


def gaps(got: dict, want: dict) -> dict:
    """The worst relative gap of the steps' losses, and by leaf of the first
    gradient's and the change's norms, each leaf against the larger of its
    own and the median leaf's reference norm. Leaves whose reference
    gradient is under a thousandth of the median leaf's (a LoRA A while B
    is still zero) are left out of both."""
    loss = max(abs(g - w) / abs(w) for g, w in zip(got["loss"], want["loss"]))
    med = statistics.median(want["grad"].values())
    kept = [k for k, v in want["grad"].items() if v >= 1e-3 * med]

    def worst(key):
        m = statistics.median(want[key][k] for k in kept)
        return max(abs(got[key][k] - want[key][k]) / max(want[key][k], m) for k in kept)

    return {"loss_rel": loss, "grad_rel": worst("grad"), "change_rel": worst("change")}


def _plant(tr, fault: str | None) -> None:
    """Faults for the harness's own tests, planted under the timed path."""
    if fault is None:
        return
    if fault == "state_unchanged":  # the optimizer leaves the state as it was
        tr.optimizer.step = lambda params, grads: tr.optimizer.norm_fn(grads)
    elif fault == "half_batch":  # half the rows left out, the mean over the rest
        orig = tr.compute_loss

        def half(b, step):
            return orig({k: v[: max(1, v.shape[0] // 2)] for k, v in b.items()}, step)
        tr.compute_loss = half
    else:
        raise ValueError(f"unknown fault {fault!r}")
