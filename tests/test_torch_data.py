"""The port's training data pipeline (dove_tpu_torch/data) against dove_tpu's.

The same frames, files and seeds go through the JAX package's NumPy/OpenCV
data code and the port's torch/Pillow code. Every random draw is a NumPy
draw in both, so after each op the generators' states must be equal; the
pixels of the float ops (blur, resize, noise) agree within FLOAT_TOL, and the
8-bit round trips (JPEG, the MJPEG fallback, OpenCV's mpeg4) bit for bit,
Pillow's JPEG bytes being OpenCV's. Then the two-stage pipelines on a
9x64x64 clip, dataset items over 3 indices x 2 epochs, the latent cache's
files, the loader's batch order against ``PrefetchLoader``, the YAML reader
against PyYAML, the manifest generator against scripts/prepare_dataset.py,
and what ``import dove_tpu_torch.data`` loads.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from dove_tpu.data import blur_kernels as jbk
from dove_tpu.data import datasets as jds
from dove_tpu.data import degradation as jdeg
from dove_tpu.data import loader as jloader
from dove_tpu_torch.data import blur_kernels as tbk
from dove_tpu_torch.data import datasets as tds
from dove_tpu_torch.data import degradation as tdeg
from dove_tpu_torch.data import loader as tloader
from dove_tpu_torch.data import yaml_lite
from test_trainer import TINY_DEGRADATION, _write_clip

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "configs"
# float ops against OpenCV's: the blur is a float64 FFT product against
# OpenCV's float32 direct sum (up to 10x10) or DFT (measured 3.6e-7 at most),
# the resizes sum their taps in another order (5.4e-7)
FLOAT_TOL = 2e-6
KERNEL_TYPES = ("iso", "aniso", "generalized_iso", "generalized_aniso",
                "plateau_iso", "plateau_aniso", "sinc")


def _frames(seed: int, shape=(5, 40, 56, 3)) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _run_op(j_op, t_op, frames: np.ndarray, seed: int = 5):
    """One op of each package on the same frames from equal generators ->
    (JAX's output, the port's output); the generators' states must agree."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    ref = j_op(frames, rj)
    ours = t_op(torch.from_numpy(frames), rt)
    assert rj.bit_generator.state == rt.bit_generator.state
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == np.float32
    return ref, ours


# ---------------------------------------------------------------------------
# Kernels and the YAML reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KERNEL_TYPES)
def test_blur_kernel_families_match_jax(kind):
    for size, seed in ((7, 0), (21, 1), (13, 2)):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        ref = jbk.random_mixed_kernel(rj, [kind], [1.0], size)
        ours = tbk.random_mixed_kernel(rt, [kind], [1.0], size)
        assert rj.bit_generator.state == rt.bit_generator.state
        assert ours.shape == (size, size) and np.array_equal(ours, ref)
    assert np.array_equal(tbk.circular_lowpass_kernel(1.3, 7, pad_to=21),
                          jbk.circular_lowpass_kernel(1.3, 7, pad_to=21))


YAML_EXTRA = """# every construct of the subset
a: 1
b: [1e4, 1.0e+4, .5, -.inf, .NaN, 'x''y', '#', ~, null, yes, Off, 0, -3, 1_000, [], [a, [b]]]
c:
  - 1
  -
    - 2
    - 3
  -
    k: v
    m: [ ]
d:
  - x   # trailing comment
  -
    y:
      - !!float 7
e: '# not a comment'
f:
g: a b c
'h': 'quoted key'
"""


def _same(a, b) -> bool:
    """Equal values of equal types (NaN equal to NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (a != a and b != b)
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("name", ["degradation.yaml", "degradation_image_video.yaml",
                                  "tiny", "extra"])
def test_yaml_reader_matches_pyyaml(name):
    text = {"tiny": TINY_DEGRADATION, "extra": YAML_EXTRA}.get(name)
    if text is None:
        text = (CONFIGS / name).read_text()
    ref = yaml.safe_load(text)
    assert _same(yaml_lite.safe_load(text), ref)
    if name.startswith("degradation"):  # the !!float bitrates
        bitrate = ref["degradation_1"]["random_mpeg"]["params"]["bitrate"]
        assert bitrate == [1e4, 1e5] and all(isinstance(x, float) for x in bitrate)


@pytest.mark.parametrize("text,line", [
    ("a: &x 1", 1), ("a: *x", 1), ("a: |\n  text", 1), ("a: {b: 1}", 1),
    ("a: 0x10", 1), ("a: 010", 1), ("a: 1:20", 1), ("a: 2001-12-14", 1),
    ("---\na: 1", 1), ("a: 1\n---\nb: 2", 2), ("a: !!int 3", 1),
    ("a: b\n  c", 2), ("a:\n\t- 1", 2), ("a: [1, 2", 1), ("a: 1\n  - 2", 2),
    ('a: "q"', 1), ("a:\n  - k: v", 2), ("a:\n  - - 1", 2), ("a:\n- 1", 2),
    ("- 1", 1), ("a: [1,, 2]", 1), ("x", 1),
])
def test_yaml_reader_raises_outside_its_subset(text, line):
    with pytest.raises(yaml_lite.YAMLSubsetError, match=f"line {line}:"):
        yaml_lite.safe_load(text)


# ---------------------------------------------------------------------------
# Each op against JAX's
# ---------------------------------------------------------------------------

def _blur_params(kind: str, size: int, drift: float) -> dict:
    return dict(kernel_size=[size], kernel_list=[kind], kernel_prob=[1],
                sigma_x=[0.2, 3], sigma_y=[0.2, 3], rotate_angle=[-3.1416, 3.1416],
                beta_gaussian=[0.5, 4], beta_plateau=[1, 2], omega=[1.0472, 3.1416],
                **{f"{k}_step": drift for k in ("sigma_x", "sigma_y", "rotate_angle",
                                                "beta_gaussian", "beta_plateau",
                                                "omega")})


@pytest.mark.parametrize("drift", [0.0, 0.1])
@pytest.mark.parametrize("kind", KERNEL_TYPES)
def test_blur_matches_jax(kind, drift):
    frames = _frames(0)
    for size in (7, 21):
        p = _blur_params(kind, size, drift)
        ref, ours = _run_op(jdeg.RandomBlur(p), tdeg.RandomBlur(p), frames)
        assert np.abs(ours - ref).max() <= FLOAT_TOL
        assert np.abs(ours - frames).max() > 1e-3  # the blur did something
    # a frame smaller than the kernel's reach: reflect-101 wraps again
    small = _frames(1, (2, 5, 7, 3))
    p = _blur_params(kind, 21, drift)
    ref, ours = _run_op(jdeg.RandomBlur(p), tdeg.RandomBlur(p), small)
    assert np.abs(ours - ref).max() <= FLOAT_TOL


@pytest.mark.parametrize("opt", ["bilinear", "area", "bicubic", "lanczos"])
@pytest.mark.parametrize("mode", ["up", "down", "keep", "target"])
def test_resize_matches_jax(mode, opt):
    frames = _frames(2)
    p = dict(resize_mode_prob=[float(mode == m) for m in ("up", "down", "keep")],
             resize_scale=[0.3, 1.5], resize_opt=[opt], resize_prob=[1],
             is_size_even=True)
    j_op, t_op = jdeg.RandomResize(p), tdeg.RandomResize(p)
    if mode == "target":
        j_op.set_target_size((13, 17))
        t_op.set_target_size((13, 17))
    ref, ours = _run_op(j_op, t_op, frames)
    assert (ours.shape == frames.shape) == (mode == "keep")
    assert np.abs(ours - ref).max() <= FLOAT_TOL


@pytest.mark.parametrize("gray", [0.0, 1.0])
@pytest.mark.parametrize("kind", ["gaussian", "poisson"])
def test_noise_matches_jax(kind, gray):
    p = dict(noise_type=[kind], noise_prob=[1], gaussian_sigma=[1, 30],
             gaussian_gray_noise_prob=gray, poisson_scale=[0.05, 3],
             poisson_gray_noise_prob=gray, gaussian_sigma_step=2,
             poisson_scale_step=0.1)
    frames = _frames(3)
    ref, ours = _run_op(jdeg.RandomNoise(p), tdeg.RandomNoise(p), frames)
    assert np.abs(ours - ref).max() <= FLOAT_TOL
    # the gray conversion that feeds the Poisson rates is OpenCV's, bit for
    # bit at a width of whole vectors (56 pixels)
    gray_ref = cv2.cvtColor(frames[0], cv2.COLOR_RGB2GRAY)
    assert np.array_equal(tdeg.rgb_to_gray(torch.from_numpy(frames[0])).numpy(), gray_ref)


def test_jpeg_matches_jax():
    p = dict(quality=[30, 95], quality_step=3)
    frames = _frames(4)
    ref, ours = _run_op(jdeg.RandomJPEGCompression(p), tdeg.RandomJPEGCompression(p),
                        frames)
    assert np.array_equal(ours, ref)
    assert np.abs(ours - frames).max() > 1 / 255


@pytest.mark.parametrize("codec", ["libx264", "h264", "mpeg4"])
def test_video_compression_matches_jax(codec):
    """libx264 and h264 take the bitrate-targeted MJPEG round trip here (no
    PyAV), mpeg4 OpenCV's writer; both packages pick the same, and the same
    binary search over Pillow's (equal) JPEG sizes."""
    p = dict(codec=[codec], codec_prob=[1], bitrate=[1e4, 1e5])
    frames = _frames(5, (9, 64, 64, 3))
    ref, ours = _run_op(jdeg.RandomVideoCompression(p), tdeg.RandomVideoCompression(p),
                        frames)
    assert np.array_equal(ours, ref)
    assert tdeg.compression_backend() == jdeg.compression_backend()
    if codec != "mpeg4":
        t = tdeg.RandomVideoCompression(p)._mjpeg_roundtrip(
            torch.from_numpy(frames), 40000, return_bytes=True)[1]
        j = jdeg.RandomVideoCompression(p)._mjpeg_roundtrip(frames, 40000,
                                                           return_bytes=True)[1]
        assert t == j


def test_mpeg4_without_opencv_raises_naming_c2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert tdeg.compression_backend() == "rate-mjpeg-fallback, mpeg4 raises (C.2)"
    p = dict(codec=["mpeg4"], codec_prob=[1], bitrate=[1e4, 1e5])
    with pytest.raises(RuntimeError, match="C.2"):
        tdeg.RandomVideoCompression(p)(torch.from_numpy(_frames(6)), np.random.default_rng(0))
    # the MJPEG codecs need no OpenCV
    p = dict(codec=["h264"], codec_prob=[1], bitrate=[1e4, 1e5])
    out = tdeg.RandomVideoCompression(p)(torch.from_numpy(_frames(6)),
                                         np.random.default_rng(0))
    assert out.shape == (5, 40, 56, 3)


# ---------------------------------------------------------------------------
# The two-stage pipelines
# ---------------------------------------------------------------------------

def _stages(path: Path):
    return jdeg.load_degradation_config(str(path)), tdeg.load_degradation_config(path)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_stage_pipeline_matches_jax(seed):
    """configs/degradation.yaml on a 9x64x64 clip: stage 1, then stage 2 with
    its shuffled group's resize pointed at 16x16, as RealSRDataset does."""
    js, ts = _stages(CONFIGS / "degradation.yaml")
    frames = _frames(10 + seed, (9, 64, 64, 3))
    for st in (js, ts):
        assert st["degradation_2"].set_shuffle_target_size((16, 16))

    def run(st, f, rng):
        return st["degradation_2"](st["degradation_1"](f, rng), rng)

    ref, ours = _run_op(lambda f, r: run(js, f, r), lambda f, r: run(ts, f, r),
                        frames, seed=seed)
    assert ours.shape == (9, 16, 16, 3)
    assert np.abs(ours - ref).max() <= FLOAT_TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_image_branch_matches_jax(seed):
    """degradation_image_video.yaml's image branch: stage 1 without MPEG,
    stage 2 without the shuffled group, then degradation_3 with its resize
    pointed at 16x16."""
    js, ts = _stages(CONFIGS / "degradation_image_video.yaml")
    for st in (js, ts):
        st["degradation_3"].find_resize().set_target_size((16, 16))

    def run(st, f, rng):
        f = st["degradation_1"](f, rng, skip=("random_mpeg",))
        f = st["degradation_2"](f, rng, skip=("degradation_with_shuffle",))
        return st["degradation_3"](f, rng)

    ref, ours = _run_op(lambda f, r: run(js, f, r), lambda f, r: run(ts, f, r),
                        _frames(20 + seed, (1, 64, 64, 3)), seed=seed)
    assert ours.shape == (1, 16, 16, 3)
    assert np.abs(ours - ref).max() <= FLOAT_TOL


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    (root / "videos").mkdir()
    for i in range(3):
        _write_clip(root / "videos" / f"clip{i}.mp4")
    (root / "videos.txt").write_text("".join(f"videos/clip{i}.mp4\n" for i in range(3)))
    (root / "images").mkdir()
    for i in range(2):
        img = np.random.default_rng(i).integers(0, 255, (64, 64, 3), np.uint8)
        cv2.imwrite(str(root / "images" / f"img{i}.png"), img)
    (root / "images.txt").write_text("images/img0.png\nimages/img1.png\n")
    (root / "degradation.yaml").write_text(TINY_DEGRADATION)
    return root


def _datasets(data_dir, kind: str, config: Path, **kw):
    args = (data_dir, data_dir / "videos.txt", 5, 32, 32, config)
    kw = dict(seed=3, **kw)
    if kind == "image-video":
        kw["image_manifest"] = data_dir / "images.txt"
        return (jds.RealSRImageVideoDataset(*args, **kw),
                tds.RealSRImageVideoDataset(*args, **kw))
    return jds.RealSRDataset(*args, **kw), tds.RealSRDataset(*args, **kw)


def _assert_items_equal(ours: dict, ref: dict) -> None:
    assert list(ours) == list(ref)
    for key, want in ref.items():
        got = ours[key]
        if isinstance(want, np.ndarray):
            assert got.shape == want.shape and got.dtype == want.dtype, key
            assert np.abs(got - want).max() <= FLOAT_TOL, key
        else:
            assert got == want, key


@pytest.mark.parametrize("kind,config", [
    ("video", "tiny"), ("video", "degradation.yaml"),
    ("image-video", "tiny"), ("image-video", "degradation_image_video.yaml"),
])
def test_dataset_items_match_jax(data_dir, kind, config):
    path = data_dir / "degradation.yaml" if config == "tiny" else CONFIGS / config
    jd, td = _datasets(data_dir, kind, path)
    assert len(td) == len(jd) == 3
    for epoch in (0, 1):
        jd.set_epoch(epoch)
        td.set_epoch(epoch)
        for index in range(3):
            _assert_items_equal(td[index], jd[index])
    assert td[0]["hq_video"].shape == (5, 32, 32, 3)


def test_latent_cache_route_matches_jax(data_dir, tmp_path):
    """is_latent: the first pass encodes and writes
    cache/video_latent/{hq,lq}/<model>/<FxHxW>/<stem>.safetensors, the same
    files and keys as JAX's (written by the port's safetensors_io, read by
    the safetensors package); a second pass reads them and does not encode."""
    from safetensors.numpy import load_file

    def encode(frames):  # a deterministic stand-in for the VAE encode
        return frames[::2, ::8, ::8].mean(-1, keepdims=True).astype(np.float32)

    calls = []
    roots = {}
    for name in ("jax", "port"):
        root = tmp_path / name
        root.mkdir()
        for f in ("videos", "videos.txt", "degradation.yaml"):
            (root / f).symlink_to(data_dir / f)
        roots[name] = root
    kw = dict(is_latent=True, model_name="dove-s1", seed=3)
    jd = jds.RealSRDataset(roots["jax"], roots["jax"] / "videos.txt", 5, 32, 32,
                           roots["jax"] / "degradation.yaml", encode_video=encode, **kw)
    td = tds.RealSRDataset(roots["port"], roots["port"] / "videos.txt", 5, 32, 32,
                           roots["port"] / "degradation.yaml",
                           encode_video=lambda f: calls.append(1) or encode(f), **kw)
    refs = [jd[i] for i in range(3)]
    assert td.fill_latent_cache() == 3 and len(calls) == 6
    files = {name: sorted(str(p.relative_to(root)) for p in root.rglob("*.safetensors"))
             for name, root in roots.items()}
    assert files["port"] == files["jax"] and len(files["port"]) == 6
    assert files["port"][0] == "cache/video_latent/hq/dove-s1/5x32x32/clip0.safetensors"
    for rel in files["port"]:
        ours, ref = load_file(roots["port"] / rel), load_file(roots["jax"] / rel)
        assert list(ours) == list(ref) == ["latent"]
        assert np.abs(ours["latent"] - ref["latent"]).max() <= FLOAT_TOL
    assert td.fill_latent_cache() == 0 and len(calls) == 6  # the second pass reads
    td.encode_video = None
    for i in range(3):
        _assert_items_equal(td[i], refs[i])
    assert len(calls) == 6


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------

class _Indices:
    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        return {"i": np.full((2,), i), "name": f"item{i}", "meta": {"i": np.int64(i)}}


@pytest.mark.parametrize("case", [
    dict(batch_size=3), dict(batch_size=3, shuffle=False),
    dict(batch_size=3, drop_last=False), dict(batch_size=4, seed=7),
    dict(batch_size=4, process_shard=(1, 2)), dict(batch_size=2, bucket=True),
    dict(batch_size=2, bucket=True, drop_last=True),
])
def test_loader_batches_match_prefetch_loader(case):
    case = dict(case)
    n = 11
    if case.pop("bucket", False):
        shapes = [(5, 32, 32) if i % 3 else (1, 32, 32) for i in range(n)]
        case["sampler"] = (jds.BucketSampler(shapes, case["batch_size"],
                                             drop_last=case.get("drop_last", False)),
                           tds.BucketSampler(shapes, case["batch_size"],
                                             drop_last=case.get("drop_last", False)))
    samplers = case.pop("sampler", (None, None))
    ref = jloader.PrefetchLoader(_Indices(n), num_workers=0, sampler=samplers[0], **case)
    ours = tloader.Loader(_Indices(n), num_workers=0, sampler=samplers[1], **case)
    for epoch in (0, 1, 2):
        ref.set_epoch(epoch)
        ours.set_epoch(epoch)
        want, got = list(ref), list(ours)
        assert len(ours) == len(ref) == len(want) == len(got) > 0
        for g, w in zip(got, want):
            assert np.array_equal(g["i"], w["i"]) and g["name"] == w["name"]
            assert np.array_equal(g["meta"]["i"], w["meta"]["i"])
    assert len({tuple(b["i"][:, 0]) for b in ours}) == len(ours)


def test_loader_workers_give_the_in_process_batches(data_dir):
    """Two worker processes (spawned) and two epochs: the same batches as
    loading in this process, each epoch's own degradations; an error in a
    worker reaches the caller."""
    ds = tds.RealSRDataset(data_dir, data_dir / "videos.txt", 5, 32, 32,
                           data_dir / "degradation.yaml", seed=1)
    inline = tloader.Loader(ds, batch_size=1, num_workers=0, seed=2)
    workers = tloader.Loader(ds, batch_size=1, num_workers=2, seed=2)
    seen = []
    for epoch in (0, 1):
        for loader in (inline, workers):
            loader.set_epoch(epoch)
        want, got = list(inline), list(workers)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            assert np.array_equal(g["lq_video"], w["lq_video"])
            assert np.array_equal(g["hq_video"], w["hq_video"])
        seen.append(got[0]["lq_video"])
    assert not np.array_equal(seen[0], seen[1])  # a new epoch, new draws

    bad = data_dir / "broken"
    bad.mkdir(exist_ok=True)
    (bad / "x.png").write_bytes(b"not an image")
    (bad / "list.txt").write_text("x.png\n")
    broken = tds.RealSRDataset(bad, bad / "list.txt", 5, 32, 32,
                               data_dir / "degradation.yaml")
    with pytest.raises(ValueError, match="unreadable image"):
        list(tloader.Loader(broken, batch_size=1, num_workers=1))


# ---------------------------------------------------------------------------
# Imports and the manifest generator
# ---------------------------------------------------------------------------

def test_data_package_imports_nothing_the_card_lacks():
    banned = ("cv2", "yaml", "safetensors", "av", "jax", "dove_tpu")
    mods = ["dove_tpu_torch.data"] + [
        f"dove_tpu_torch.data.{p.stem}"
        for p in sorted((REPO / "dove_tpu_torch" / "data").glob("*.py"))
        if p.stem != "__init__"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {banned!r}]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_prepare_dataset_writes_the_scripts_manifest(tmp_path):
    from dove_tpu_torch import prepare_dataset

    data = tmp_path / "set"
    for rel in ("a/1.mp4", "a/2.PNG", "b/3.mkv", "b/c/4.jpg", "skip.txt", "5.avi"):
        (data / rel).parent.mkdir(parents=True, exist_ok=True)
        (data / rel).write_bytes(b"")
    for extra in ([], ["--exts", ".mp4", ".png"], ["--relative_to", str(data)]):
        ref_out, our_out = tmp_path / "ref.txt", tmp_path / "ours.txt"
        subprocess.run([sys.executable, str(REPO / "scripts" / "prepare_dataset.py"),
                        "--data_dir", str(data), "--output", str(ref_out), *extra],
                       check=True, capture_output=True, timeout=60)
        assert prepare_dataset.main(["--data_dir", str(data), "--output", str(our_out),
                                     *extra]) == 0
        assert our_out.read_text() == ref_out.read_text() != ""
