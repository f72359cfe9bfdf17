"""Rank bodies of the multi-process CPU tests of ``dove_tpu_torch/parallel``
(tests/test_torch_parallel.py, tests/test_torch_parallel_train.py).

This module imports torch, numpy and ``dove_tpu_torch`` only, never JAX:
the ranks are spawned processes that import it. Each rank joins a gloo
group through a file rendezvous (no TCP port: pytest-xdist runs several
files at once), runs one thread, and reads its inputs from a pickle the test
wrote; rank 0 writes what the test compares.
"""

from __future__ import annotations

import dataclasses
import pickle
import tempfile
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(body, world: int, workdir: Path, *args) -> None:
    """Run ``body(rank, world, *args)`` in ``world`` gloo ranks; raise if any
    rank fails."""
    init = Path(tempfile.mkdtemp(dir=workdir)) / "rendezvous"
    mp.spawn(_entry, args=(body, world, str(init), args), nprocs=world, join=True)


def _entry(rank: int, body, world: int, init: str, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        body(rank, world, *args)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def load(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f)


def dump(obj, path: Path) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _models(inputs, quantize: str | None = None):
    from dove_tpu_torch import config as tcfg
    from dove_tpu_torch import weights as tweights
    from dove_tpu_torch.ops.quant import quantize_dit

    cfg = tcfg.tiny_test()
    dit, vae = tweights.from_jax_params(cfg, inputs["dit"], inputs["vae"])
    if quantize:
        quantize_dit(dit)
    return cfg, dit, vae


def _pipe(inputs, **flags):
    from dove_tpu_torch.pipeline import DovePipeline

    cfg, dit, vae = _models(inputs)
    cfg = dataclasses.replace(cfg, noise_step=flags.pop("noise_step", 0))
    return DovePipeline(
        config=cfg, dit=dit, vae=vae,
        prompt_embedding=torch.from_numpy(inputs["prompt"]), dtype=torch.float32,
        device="cpu", **{"sample_posterior": False, "vae_tiling": True,
                         "output_uint8": True, **flags})


def serve(rank: int, world: int, inputs_path: str, out_path: str) -> None:
    """Every serving case of one world size; rank 0 writes {case: result}."""
    from dove_tpu_torch.parallel.mesh import make_mesh
    from dove_tpu_torch.parallel.tp import make_tp_dit, shard_dit_tp
    from dove_tpu_torch.pipeline import DovePipeline

    inputs = load(Path(inputs_path))
    res = {}
    z, text, t = (torch.from_numpy(inputs[k]) for k in ("z", "text", "t"))

    def dit_out(mesh_shape, batch, quantize=None):
        _, dit, _ = _models(inputs, quantize)
        fn = make_tp_dit(make_mesh(*mesh_shape, device="cpu"), dit)
        with torch.no_grad():
            return fn(z[:batch], text[:batch], t[:batch]).numpy()

    for name, (mesh_shape, batch, quantize) in inputs["dit_cases"][world].items():
        res[name] = dit_out(mesh_shape, batch, quantize)

    frames, long = inputs["frames"], inputs["long_frames"]
    for name, case in inputs["clip_cases"][world].items():
        flags = dict(case.get("flags", {}))
        kw = dict(case.get("kw", {}))
        clip = long if case.get("long") else frames
        budget = case.get("budget")
        plan = DovePipeline._window_budget
        if budget is not None:
            DovePipeline._window_budget = lambda self, b=budget: b
        mesh = make_mesh(*case["mesh"], device="cpu")
        pipe = _pipe(inputs, **flags)
        if mesh.shape["model"] > 1:  # the caller splits the DiT
            shard_dit_tp(pipe.dit, mesh.axis_group("model"))
        out = pipe.process_frames(clip, mesh=mesh, **kw)
        ref = None
        if rank == 0 and case.get("ws1", True):
            pipe = _pipe(inputs, **flags)
            ref = pipe.process_frames(clip, **kw)
        DovePipeline._window_budget = plan
        if rank == 0:
            res[name] = (out, ref)
        else:
            assert out is None, name
    if rank == 0:
        dump(res, Path(out_path))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _trainer(args_kw: dict):
    from dove_tpu_torch.train.args import Args
    from dove_tpu_torch.train.trainer import DOVES1Trainer

    return DOVES1Trainer(Args(**args_kw), device="cpu")


def _local_batch(batch: dict, trainer) -> dict:
    d, n = trainer.mesh.coord("data"), trainer.mesh.shape["data"]
    k = next(iter(batch.values())).shape[0] // n
    return trainer.device_batch({key: v[d * k:(d + 1) * k] for key, v in batch.items()})


def train_step(rank: int, world: int, inputs_path: str, out_path: str) -> None:
    """One optimizer step (sft and lora) on the given latent batch under each
    mesh of ``inputs["steps"]``; rank 0 writes the loss, the gradient norm
    and the whole trainable state after the step."""
    inputs = load(Path(inputs_path))
    res = {}
    for name, (mesh_kw, args_kw) in inputs["steps"][world].items():
        tr = _trainer({**inputs["args"], **args_kw, **mesh_kw})
        tr.load_components()
        tr.prepare_optimizer(1)
        loss, _, gnorm = tr.train_step(_local_batch(inputs["batch"], tr))
        state = tr._trainable_state()
        if rank == 0:
            res[name] = (float(loss), float(gnorm),
                         {k: _np(v) for k, v in _flat(state).items()})
    if rank == 0:
        dump(res, Path(out_path))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _flat(state: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def sp_grads(rank: int, world: int, inputs_path: str, out_path: str) -> None:
    """Stage-1 gradients of the whole DiT with TP over "model" and, at B = 1,
    sequence parallelism over "data"; rank 0 writes them whole."""
    from dove_tpu_torch.parallel.mesh import make_mesh
    from dove_tpu_torch.parallel.tp import shard_dit_tp, tp_dim
    from dove_tpu_torch.ops.scheduler import Schedule
    from dove_tpu_torch.train import losses

    inputs = load(Path(inputs_path))
    cfg, dit, _ = _models(inputs)
    dit.requires_grad_(True)
    mesh = make_mesh(*inputs["sp_mesh"], device="cpu")
    model = mesh.axis_group("model")
    shard_dit_tp(dit, model)
    sp = mesh.axis_group("data")
    batch = {k: torch.from_numpy(v[:1]) for k, v in inputs["batch"].items()}
    batch["prompt_embeds"] = batch.pop("prompt_embedding")
    loss, _ = losses.stage1_loss(cfg, Schedule.create(cfg.scheduler), dit, batch, None,
                                 gradient_checkpointing=True, sp=sp)
    loss.backward()
    from dove_tpu_torch.parallel.tp import gather_split

    grads = {}
    for name, p in dit.named_parameters():
        g = p.grad
        dim = tp_dim(name)
        if dim is not None:
            g = gather_split(g, dim, model, g.shape[dim] * model.size)
        grads[name] = _np(g)
    if rank == 0:
        dump({"loss": float(loss), "grads": grads}, Path(out_path))


def fsdp_layouts(rank: int, world: int, inputs_path: str, out_path: str) -> None:
    """The stage-1 loss and gradient norm through the trainer's FSDP under
    each (data, model) layout of ``inputs["fsdp"][world]``."""
    inputs = load(Path(inputs_path))
    res = {}
    for data, model in inputs["fsdp"][world]:
        tr = _trainer({**inputs["args"], "training_type": "sft", "fsdp": model,
                       "data_parallel": data})
        tr.load_components()
        tr.prepare_optimizer(1)
        loss, _, grads = tr.loss_and_grads(_local_batch(inputs["fsdp_batch"], tr))
        gnorm = tr.optimizer.norm_fn(grads)
        res[(data, model)] = (float(loss), float(gnorm))
    if rank == 0:
        dump(res, Path(out_path))


def fit_then_resume(rank: int, world: int, inputs_path: str, out_path: str) -> None:
    """``fit`` for one step under FSDP with a checkpoint, then a run under
    TP that resumes from it and takes a second step; rank 0 writes what the
    resumed trainer holds right after the restore and its step count."""
    from dove_tpu_torch.train.checkpointing import load_state

    inputs = load(Path(inputs_path))
    first = _trainer({**inputs["fit_args"], "fsdp": world, "train_steps": 1,
                      "checkpointing_steps": 1})
    first.fit()
    fsdp_summaries = [None] * world  # validation under FSDP: each rank serves alone
    dist.all_gather_object(fsdp_summaries, first.validate(1))
    second = _trainer({**inputs["fit_args"], "tensor_parallel": world, "train_steps": 2,
                       "checkpointing_steps": 5})
    second.load_components()
    second.prepare_dataset()
    second.prepare_optimizer(2)
    second.maybe_resume()
    restored = second._trainable_state()
    saved = load_state(Path(inputs["fit_args"]["output_dir"]) / "checkpoint-1")
    worst = max(float((restored[k].float() - v.float()).abs().max())
                for k, v in saved["trainable"].items())
    second.train(2, len(second.loader))
    # validation under TP: every rank serves the clip over the mesh (staged),
    # rank 0 writes and scores, every rank returns the summary
    summaries = [None] * world
    dist.all_gather_object(summaries, second.validate(2))
    if rank == 0:
        dump({"restored_err": worst, "step": second.global_step,
              "tp": second.dit.tp.size, "validation": summaries,
              "fsdp_validation": fsdp_summaries}, Path(out_path))


def resume_optimizers(rank: int, world: int, inputs_path: str, out_path: str) -> None:
    """LoRA under tensor_parallel=world with each optimizer of
    ``inputs["resume_opts"]``: two steps in one run (a checkpoint after the
    first), and a second run resumed from that checkpoint taking step 2,
    whose update reads the restored optimizer state; rank 0 writes both
    runs' final trainable and optimizer state."""
    inputs = load(Path(inputs_path))
    res = {}
    for opt in inputs["resume_opts"]:
        out_dir = Path(inputs["args"]["output_dir"]) / f"resume_{opt}"
        kw = {**inputs["args"], "training_type": "lora", "tensor_parallel": world,
              "optimizer": opt, "output_dir": str(out_dir)}
        finals = []
        for resumed in (False, True):
            tr = _trainer(dict(kw, resume_from_checkpoint=str(out_dir / "checkpoint-1"))
                          if resumed else kw)
            tr.load_components()
            tr.prepare_optimizer(2)
            if resumed:
                tr.maybe_resume()
            assert tr.global_step == (1 if resumed else 0)
            while tr.global_step < 2:
                tr.train_step(_local_batch(inputs["batch"], tr))
                tr.global_step += 1
                if tr.global_step == 1:
                    tr.save(1)
            finals.append({k: _np(v) for k, v in _flat(
                {"trainable": tr._trainable_state(),
                 "opt": _tensors(tr.optimizer.state_dict())}).items()})
        res[opt] = finals
    if rank == 0:
        dump(res, Path(out_path))


def _tensors(state) -> dict:
    """The tensors of an optimizer's state dict, keyed by their path."""
    if isinstance(state, dict):
        return {str(k): _tensors(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return {str(i): _tensors(v) for i, v in enumerate(state)}
    return torch.as_tensor(state)
