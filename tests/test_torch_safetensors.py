"""The port's own safetensors reader and writer against the ``safetensors``
package, and the port's loaders and exports with the package blocked, as
on a machine that lacks it.

The reader must give the package's names, dtypes, shapes and bytes (the
committed golden checkpoints, a file of every dtype, a sharded directory
with an index); the package must read what the writer writes, bit for bit.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file as package_save

from dove_tpu_torch import config as tcfg
from dove_tpu_torch import safetensors_io
from dove_tpu_torch import weights as tweights
from dove_tpu_torch.train import checkpointing as tckpt
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "golden"
DTYPE_CASES = [torch.bfloat16, torch.float16, torch.float32, torch.float64,
               torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
               torch.bool, torch.float8_e4m3fn]


def _package_load(path) -> dict[str, torch.Tensor]:
    with safe_open(str(path), framework="pt") as f:
        return {k: f.get_tensor(k) for k in f.keys()}


def _assert_same(ours: dict, ref: dict) -> None:
    """Same names, dtypes, shapes and bytes."""
    assert sorted(ours) == sorted(ref)
    for k, want in ref.items():
        got = ours[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8)), k


def _sample(dtype: torch.dtype, shape, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=gen, dtype=torch.float64) * 3).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=gen, dtype=torch.int64).to(dtype)


def _block_package(monkeypatch) -> None:
    """Importing safetensors fails until monkeypatch is undone."""
    for name in ("safetensors", "safetensors.torch", "safetensors.numpy"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import safetensors  # noqa: F401


@pytest.fixture
def no_package(monkeypatch):
    _block_package(monkeypatch)


@pytest.mark.parametrize("path", sorted(GOLDEN.glob("*/*.safetensors")),
                         ids=lambda p: f"{p.parent.name}-{p.stem}")
def test_reader_matches_package_on_golden_checkpoints(path):
    _assert_same(safetensors_io.load_file(path), _package_load(path))


@pytest.mark.parametrize("dtype", DTYPE_CASES, ids=str)
def test_reader_matches_package_per_dtype(tmp_path, dtype):
    tensors = {"a": _sample(dtype, (3, 5, 7), 1), "scalar": _sample(dtype, (), 2),
               "empty": _sample(dtype, (0, 4), 3), "row": _sample(dtype, (33,), 4)}
    package_save(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    ours = safetensors_io.load_file(tmp_path / "x.safetensors")
    _assert_same(ours, tensors)
    _assert_same(ours, _package_load(tmp_path / "x.safetensors"))
    header, start = safetensors_io.read_header(tmp_path / "x.safetensors")
    assert header["__metadata__"] == {"format": "pt"} and start % 8 == 0


@pytest.mark.parametrize("dtype", DTYPE_CASES, ids=str)
def test_package_reads_what_the_writer_writes(tmp_path, dtype):
    tensors = {"w": _sample(dtype, (4, 9), 5), "scalar": _sample(dtype, (), 6),
               "empty": _sample(dtype, (2, 0), 7), "b": _sample(dtype, (17,), 8)}
    safetensors_io.save_file(tensors, tmp_path / "y.safetensors", metadata={"k": "v"})
    with safe_open(str(tmp_path / "y.safetensors"), framework="pt") as f:
        assert f.metadata() == {"k": "v"}
    _assert_same(_package_load(tmp_path / "y.safetensors"), tensors)
    # the header is padded with spaces to 8 bytes, as the package pads it
    header_len = int.from_bytes((tmp_path / "y.safetensors").read_bytes()[:8], "little")
    assert header_len % 8 == 0


def test_writer_takes_numpy_arrays(tmp_path):
    arrays = {"f": np.arange(12, dtype=np.float32).reshape(3, 4),
              "i": np.arange(5, dtype=np.int64)[::2]}  # not contiguous
    safetensors_io.save_file(arrays, tmp_path / "n.safetensors")
    got = _package_load(tmp_path / "n.safetensors")
    np.testing.assert_array_equal(got["f"].numpy(), arrays["f"])
    np.testing.assert_array_equal(got["i"].numpy(), arrays["i"])


def test_reader_rejects_a_truncated_file(tmp_path):
    package_save({"a": torch.ones(64)}, str(tmp_path / "t.safetensors"))
    blob = (tmp_path / "t.safetensors").read_bytes()
    (tmp_path / "t.safetensors").write_bytes(blob[:-4])
    with pytest.raises(ValueError, match="past the end"):
        safetensors_io.load_file(tmp_path / "t.safetensors")


def _sharded_dir(root: Path) -> tuple[Path, dict[str, torch.Tensor]]:
    """A diffusers-style directory: two bf16 shards written by the package
    and their index."""
    sub = root / "transformer"
    sub.mkdir(parents=True)
    shards = [{"a.weight": _sample(torch.bfloat16, (8, 16), 9),
               "a.bias": _sample(torch.bfloat16, (8,), 10)},
              {"b.weight": _sample(torch.bfloat16, (3, 8), 11),
               "b.scale": _sample(torch.float32, (3,), 12)}]
    weight_map = {}
    for i, shard in enumerate(shards):
        name = f"diffusion_pytorch_model-{i + 1:05d}-of-00002.safetensors"
        package_save(shard, str(sub / name))
        weight_map.update(dict.fromkeys(shard, name))
    (sub / "diffusion_pytorch_model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))
    return sub, {k: v for s in shards for k, v in s.items()}


def test_sharded_directory_loads_without_the_package(tmp_path, no_package):
    sub, tensors = _sharded_dir(tmp_path)
    _assert_same(tweights.load_safetensors_dir(sub), tensors)


def test_load_dit_and_vae_without_the_package(tmp_path, monkeypatch):
    """load_dit and load_vae on the committed 1.5 golden checkpoint with the
    package blocked give the modules that the package's tensors give."""
    cfg = tcfg.tiny_test()
    ref_dit = tweights.convert_dit(_package_load(GOLDEN / "15" / "transformer.safetensors"),
                                   cfg.dit, torch.float32)
    ref_vae = tweights.convert_vae(_package_load(GOLDEN / "15" / "vae.safetensors"),
                                   cfg.vae, torch.float32)
    for sub in ("transformer", "vae"):
        (tmp_path / sub).mkdir()
        shutil.copy(GOLDEN / "15" / f"{sub}.safetensors",
                    tmp_path / sub / "diffusion_pytorch_model.safetensors")
    _block_package(monkeypatch)
    dit = tweights.load_dit(tmp_path, cfg.dit, torch.float32)
    vae = tweights.load_vae(tmp_path, cfg.vae, torch.float32)
    for got, want in ((dit, ref_dit), (vae, ref_vae)):
        _assert_same(got.state_dict(), want.state_dict())


def test_prompt_embedding_without_the_package(tmp_path, no_package):
    emb = _sample(torch.bfloat16, (226, 32), 13)
    safetensors_io.save_file({"prompt_embedding": emb}, tmp_path / "e.safetensors")
    got = tweights.load_prompt_embedding(tmp_path / "e.safetensors", torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, emb.float())


def test_lora_export_round_trip_without_the_package(tmp_path, monkeypatch):
    """The LoRA route: export the trained tree, read it back through the
    port's reader, fuse it into the DiT; the package reads the same file."""
    cfg = tcfg.tiny_test()
    rng = np.random.default_rng(0)
    L, d, r = cfg.dit.num_layers, cfg.dit.hidden_dim, 4
    lora = {t: {"A": torch.from_numpy(rng.standard_normal((L, d, r)).astype(np.float32)),
                "B": torch.from_numpy(rng.standard_normal((L, r, d)).astype(np.float32))}
            for t in ("to_q", "to_k", "to_v", "to_out")}
    path = tmp_path / "lora" / "pytorch_lora_weights.safetensors"
    _block_package(monkeypatch)
    tckpt.export_lora_safetensors(lora, path)
    read = safetensors_io.load_file(path)
    state = tckpt.lora_state_dict(lora)
    _assert_same(read, {k: torch.from_numpy(v) for k, v in state.items()})
    fused, want = (tweights.fuse_lora_into_dit(tweights.convert_dit(
        safetensors_io.load_file(GOLDEN / "15" / "transformer.safetensors"),
        cfg.dit, torch.float32), peft, scale=0.5).state_dict() for peft in (read, state))
    _assert_same(fused, want)
    monkeypatch.undo()
    _assert_same(_package_load(path), read)


def test_dit_export_sharded_without_the_package(tmp_path, monkeypatch):
    """export_dit_safetensors with a small shard size writes shards and an
    index that the port's loader and the package both read back."""
    cfg = tcfg.tiny_test()
    dit = tweights.convert_dit(safetensors_io.load_file(GOLDEN / "15" / "transformer.safetensors"),
                               cfg.dit, torch.float32)
    _block_package(monkeypatch)
    tckpt.export_dit_safetensors(dit, tmp_path / "transformer", max_shard_bytes=64 * 1024)
    shards = sorted((tmp_path / "transformer").glob("*.safetensors"))
    assert len(shards) > 1
    assert (tmp_path / "transformer" /
            "diffusion_pytorch_model.safetensors.index.json").exists()
    state = {k: v.contiguous() for k, v in dit.state_dict().items()}
    _assert_same(tweights.load_safetensors_dir(tmp_path / "transformer"), state)
    monkeypatch.undo()
    from_package = {}
    for f in shards:
        from_package.update(_package_load(f))
    _assert_same(from_package, state)
