"""Wan2.1 in the PyTorch port (models/wan_dit.py, models/wan_vae.py, the
pipeline's Wan route, the CLI), held on the CPU at tiny sizes and seeded
weights to the benchmark's plain float32 reference (benchmark/reference/
wan.py, which shares nothing with the port), and the preset to the
published numbers."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark.reference import wan as ref
from dove_tpu_torch import config as cfg_mod
from dove_tpu_torch.models import wan_vae
from dove_tpu_torch.models.wan_dit import WanModel, init_wan_params
from dove_tpu_torch.models.wan_vae import WanVAE_
from dove_tpu_torch.ops.rope import apply_rotary, wan_rope_3d
from dove_tpu_torch.ops.scheduler import flow_x0
from dove_tpu_torch.pipeline import DovePipeline

TOL = 2e-5  # float32 on both sides, summed in other orders


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg = cfg_mod.tiny_wan()
    dit = init_wan_params(WanModel(cfg.dit), 1).eval()
    vae = init_wan_params(WanVAE_(cfg.vae), 2).eval()
    return cfg, dit, vae, dataclasses.asdict(cfg)


def _close(a: torch.Tensor, b: torch.Tensor, tol: float = TOL) -> None:
    scale = max(1.0, float(b.abs().max()))
    assert float((a - b).abs().max()) <= tol * scale


def test_preset_holds_the_published_numbers():
    """config.json of Wan-AI/Wan2.1-T2V-14B and wan/configs/wan_t2v_14B.py."""
    c = cfg_mod.wan2_1_t2v_14b()
    d = c.dit
    assert (d.dim, d.ffn_dim, d.freq_dim, d.num_heads, d.num_layers) == (5120, 13824, 256, 40, 40)
    assert (d.in_dim, d.out_dim, d.text_len, d.text_dim, d.eps) == (16, 16, 512, 4096, 1e-6)
    assert d.patch_size == (1, 2, 2) and d.window_size == (-1, -1)
    assert d.qk_norm and d.cross_attn_norm and d.head_dim == 128
    v = c.vae
    assert (v.base_dim, v.z_dim, v.dim_mult, v.num_res_blocks) == (96, 16, (1, 2, 4, 4), 2)
    assert v.attn_scales == () and v.temperal_downsample == (False, True, True)
    assert (v.spatial_scale, v.temporal_compression_ratio, v.latent_frames(33)) == (8, 4, 9)
    assert len(v.latents_mean) == len(v.latents_std) == 16
    assert c.family == "wan" and cfg_mod.cogvideox1_5_5b().family == "cogvideox"
    with torch.device("meta"):
        n = sum(p.numel() for p in WanModel(d).parameters())
    assert 14.2e9 < n < 14.4e9  # 14.3 B


def test_parameter_names_follow_the_release(tiny):
    """The port's state dicts hold the reference's names and shapes, which
    are the release's checkpoint layout."""
    _, dit, vae, c = tiny
    for model, spec in ((dit, ref.dit_spec(c["dit"])), (vae, ref.vae_spec(c["vae"]))):
        assert {k: tuple(t.shape) for k, t in model.state_dict().items()} == dict(spec)
    keys = set(dit.state_dict())
    for name in ("patch_embedding.weight", "text_embedding.0.weight", "text_embedding.2.bias",
                 "time_embedding.0.weight", "time_embedding.2.weight", "time_projection.1.weight",
                 "blocks.0.self_attn.norm_q.weight", "blocks.1.cross_attn.o.bias",
                 "blocks.0.norm3.weight", "blocks.0.ffn.2.weight", "blocks.1.modulation",
                 "head.head.weight", "head.modulation"):
        assert name in keys
    assert "decoder.upsamples.3.time_conv.weight" in vae.state_dict()
    assert "encoder.downsamples.5.time_conv.weight" in vae.state_dict()


def test_a_state_dict_written_to_a_file_loads_by_name(tiny, tmp_path):
    _, dit, vae, _ = tiny
    torch.save(vae.state_dict(), tmp_path / "vae.pth")
    fresh = WanVAE_(cfg_mod.tiny_wan().vae)
    fresh.load_state_dict(torch.load(tmp_path / "vae.pth", weights_only=True), strict=True)
    for k, t in vae.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t)
    with pytest.raises(RuntimeError):
        WanModel(cfg_mod.tiny_wan().dit).load_state_dict(
            {k: t for k, t in dit.state_dict().items() if k != "head.modulation"})


def test_rope_table_splits_22_21_21_at_head_dim_128():
    cos, sin = wan_rope_3d(128, 2, 3, 4)
    assert cos.shape == (24, 128)
    # token (f=1, h=0, w=0): only the frame band turns; pairs interleaved
    row = 12
    assert torch.all(sin[row, :44] > 0) and torch.all(sin[row, 44:] == 0)
    assert torch.allclose(cos[row, 0::2], cos[row, 1::2])
    j = torch.arange(22, dtype=torch.float64)
    assert torch.allclose(cos[row, 0:44:2].double(), torch.cos(10000.0 ** (-2 * j / 44)), atol=1e-6)
    # token (0, 1, 0): the row band, 21 pairs at 10000^(-2j/42); (0, 0, 1) the column's
    jj = torch.arange(21, dtype=torch.float64)
    assert torch.allclose(cos[4, 44:86:2].double(), torch.cos(10000.0 ** (-2 * jj / 42)), atol=1e-6)
    assert torch.allclose(sin[1, 86::2].double(), torch.sin(10000.0 ** (-2 * jj / 42)), atol=1e-6)
    # the rotation is the reference's complex product
    x = torch.randn(24, 3, 128)
    want = ref.rope_apply(x, ref.rope_freqs({"dim": 384, "num_heads": 3}, 2, 3, 4, "cpu"))
    got = apply_rotary(x.transpose(0, 1), cos, sin).transpose(0, 1)
    _close(got, want, 1e-5)


def test_flow_step():
    z, u = torch.randn(2, 3), torch.randn(2, 3)
    assert torch.allclose(flow_x0(z, u, 0.399), z - 0.399 * u)


def test_dit_forward_matches_the_reference(tiny):
    cfg, dit, _, c = tiny
    z = torch.randn(1, 16, 3, 4, 6)
    text = torch.randn(5, 64)
    with torch.no_grad():
        got = dit(z, text[None], torch.tensor([399]))
    want = ref.DiT(dit.state_dict(), c["dit"])(z[0], text, 399)
    assert got.shape == z.shape and got.dtype == torch.float32
    _close(got[0], want)


def test_dit_refuses_a_prompt_longer_than_its_context(tiny):
    _, dit, _, _ = tiny
    with pytest.raises(ValueError, match="exceeds"):
        dit(torch.randn(1, 16, 1, 4, 4), torch.randn(1, 17, 64), torch.tensor([399]))


@pytest.mark.parametrize("frames", [1, 5, 9])
def test_vae_encode_over_chunks_matches_the_reference(tiny, frames):
    """9 frames are 3 chunks (1, 4, 4): the cache and the temporal
    downsamplers' first-chunk rule."""
    _, _, vae, c = tiny
    x = torch.rand(1, 3, frames, 16, 24) * 2 - 1
    with torch.no_grad():
        got = vae.encode(x)
    want = ref.VAE(vae.state_dict(), c["vae"]).encode(x)
    assert got.shape == (1, 16, 1 + (frames - 1) // 4, 2, 3)
    _close(got, want)


@pytest.mark.parametrize("latents", [1, 2, 3])
def test_vae_decode_over_chunks_matches_the_reference(tiny, latents):
    """One latent frame a chunk: the first keeps its frame, the second runs
    the temporal upsamplers zero-padded, the third with the cache."""
    _, _, vae, c = tiny
    z = torch.randn(1, 16, latents, 2, 3)
    with torch.no_grad():
        got = vae.decode(z)
    want = ref.VAE(vae.state_dict(), c["vae"]).decode(z)
    assert got.shape == (1, 3, 1 + 4 * (latents - 1), 16, 24)
    _close(got, want)


@torch.no_grad()
def test_the_second_chunk_runs_the_temporal_upsampler_without_cache():
    torch.manual_seed(0)
    up = wan_vae.Resample(4, "upsample3d")
    cache = wan_vae._Cache()
    frames = [torch.randn(1, 4, 1, 2, 2) for _ in range(3)]
    outs = []
    with torch.no_grad():
        for f in frames:
            cache.i = 0
            outs.append(up(f, cache))
        w, b = up.time_conv.weight, up.time_conv.bias
        x = torch.cat(frames, 2)

        def tconv(window):  # the time conv over three frames -> 2C channels
            return torch.nn.functional.conv3d(window, w, b)

        zero = torch.zeros_like(frames[0])
        second = tconv(torch.cat([zero, zero, frames[1]], 2))
        third = tconv(torch.cat([zero, frames[1], frames[2]], 2))
    assert outs[0].shape[2] == 1 and outs[1].shape[2] == 2 and outs[2].shape[2] == 2
    conv = up.resample[1]

    def spatial(t):  # nearest 2x and the 3x3 conv on each frame
        t = t.repeat_interleave(2, 3).repeat_interleave(2, 4)
        return torch.nn.functional.conv3d(t, conv.weight[:, :, None], conv.bias, padding=(0, 1, 1))

    for got, tc in ((outs[1], second), (outs[2], third)):
        pair = torch.stack((tc[:, :4], tc[:, 4:]), 3).reshape(1, 4, 2, 2, 2)
        _close(got, spatial(pair), 1e-5)
    _close(outs[0], spatial(x[:, :, :1]), 1e-5)


def _pipe(cfg, dit, vae, prompt, **kw):
    return DovePipeline(config=cfg, dit=dit, vae=vae, prompt_embedding=prompt,
                        dtype=torch.float32, device="cpu", vae_tiling=True,
                        output_uint8=True, **kw)


def test_process_frames_matches_the_reference(tiny):
    """A 9-frame clip (3 encode chunks, 3 latent frames) through the staged
    entry point, against the reference's whole clip, as uint8."""
    cfg, dit, vae, c = tiny
    rng = np.random.default_rng(0)
    frames = rng.random((9, 8, 12, 3), dtype=np.float32)
    prompt = torch.cat([torch.randn(1, 64), torch.zeros(15, 64)])
    pipe = _pipe(cfg, dit, vae, prompt)
    got = pipe.process_frames(frames)
    want = ref.wan_clip(dit.state_dict(), vae.state_dict(), c, frames, prompt)
    assert got.shape == want.shape == (9, 32, 48, 3) and got.dtype == np.uint8
    d = got.astype(np.float64) - want
    assert np.abs(d).max() <= 1 and np.sqrt((d * d).mean()) < 0.1
    t = pipe.stage_times
    assert t["vae.chunk_n"] == 3 + 3
    assert t["dit.attn_n"] == 2 * cfg.dit.num_layers and t["dit.attn_kernel_n"] == 0
    for span in ("prep", "enc", "enc.chunks", "dit", "dit.cross_attn", "dec", "dec.chunks",
                 "finish"):
        assert t[span] > 0


def test_process_frames_pads_and_trims_a_ragged_clip(tiny):
    cfg, dit, vae, c = tiny
    frames = np.random.default_rng(1).random((6, 10, 13, 3), dtype=np.float32)
    prompt = torch.zeros(16, 64)
    got = _pipe(cfg, dit, vae, prompt).process_frames(frames)
    want = ref.wan_clip(dit.state_dict(), vae.state_dict(), c, frames, prompt)
    assert got.shape == want.shape == (6, 40, 52, 3)
    assert np.abs(got.astype(np.int16) - want).max() <= 1


def test_wan_pipeline_refuses_what_it_does_not_serve(tiny):
    cfg, dit, vae, _ = tiny
    prompt = torch.zeros(16, 64)
    with pytest.raises(ValueError, match="quantize"):
        _pipe(cfg, dit, vae, prompt, quantize="int8-dit")
    pipe = _pipe(cfg, dit, vae, prompt)
    with pytest.raises(ValueError, match="staged path"):
        pipe.process_frames(np.zeros((5, 8, 8, 3), np.float32), tile_size_hw=(8, 8))


def test_config_from_a_wan_release_folder(tmp_path):
    raw = {"_class_name": "WanModel", "dim": 256, "ffn_dim": 512, "freq_dim": 32,
           "num_heads": 2, "num_layers": 2, "in_dim": 16, "out_dim": 16,
           "text_len": 16, "text_dim": 64, "patch_size": [1, 2, 2], "eps": 1e-6,
           "model_type": "t2v", "window_size": [-1, -1]}
    (tmp_path / "config.json").write_text(json.dumps(raw))
    assert cfg_mod.is_wan_folder(tmp_path)
    c = cfg_mod.pipeline_config_from_pretrained(tmp_path)
    assert c.family == "wan" and c.dit == cfg_mod.tiny_wan().dit
    assert c.vae == cfg_mod.WanVAEConfig()


def test_the_cli_serves_a_wan_release_folder(tiny, tmp_path):
    """``python -m dove_tpu_torch.inference`` on a tiny Wan2.1 folder this test
    writes (root config.json, two safetensors shards with their index,
    Wan2.1_VAE.pth) and a [3, 64] prompt file: the PNG frames are the
    in-process pipeline's on the same weights and zero-padded prompt."""
    import cv2

    from dove_tpu_torch import inference, safetensors_io
    from dove_tpu_torch.io import video as tvideo

    cfg, dit, vae, c = tiny
    model = tmp_path / "wan"
    model.mkdir()
    raw = dict(c["dit"], _class_name="WanModel", model_type="t2v")
    (model / "config.json").write_text(json.dumps(raw))
    sd = {k: t.contiguous() for k, t in dit.state_dict().items()}
    names = sorted(sd)
    shards = {"diffusion_pytorch_model-00001-of-00002.safetensors": names[:len(names) // 2],
              "diffusion_pytorch_model-00002-of-00002.safetensors": names[len(names) // 2:]}
    weight_map = {}
    for fname, keys in shards.items():
        safetensors_io.save_file({k: sd[k] for k in keys}, model / fname)
        weight_map.update(dict.fromkeys(keys, fname))
    (model / "diffusion_pytorch_model.safetensors.index.json").write_text(
        json.dumps({"weight_map": weight_map}))
    torch.save(vae.state_dict(), model / cfg_mod.WAN_VAE_FILE)
    prompt = np.random.default_rng(3).standard_normal((3, 64)).astype(np.float32)
    np.save(tmp_path / "prompt.npy", prompt)
    clips = tmp_path / "in"
    clips.mkdir()
    frames = (np.random.default_rng(4).random((5, 8, 12, 3)) * 255).astype(np.uint8)
    tvideo.save_video_lossless(frames, clips / "a.mkv", 8)
    out = tmp_path / "out"
    inference.main(["--input_dir", str(clips), "--output_path", str(out), "--model_path",
                    str(model), "--prompt_embedding", str(tmp_path / "prompt.npy"),
                    "--dtype", "float32", "--device", "cpu", "--png_save"])
    pngs = sorted((out / "a").glob("*.png"))
    assert len(pngs) == 5
    got = np.stack([cv2.cvtColor(cv2.imread(str(p)), cv2.COLOR_BGR2RGB) for p in pngs])
    lq = tvideo.read_video_frames(clips / "a.mkv")
    text = torch.cat([torch.from_numpy(prompt), torch.zeros(13, 64)])
    want = _pipe(cfg, dit, vae, text).process_frames(lq)
    assert got.shape == want.shape == (5, 32, 48, 3)
    assert np.array_equal(got, want)
