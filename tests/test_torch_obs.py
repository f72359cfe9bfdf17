"""The port's spans and counters (``dove_tpu_torch/obs.py``) on the CPU.

The span API: nesting and parents, the host clock off the card, the unit's
scope taken off the names, counters, a span outside a unit (or on another
thread) that only opens its profiler range, and a unit that resolves once,
from events it takes from a pool and hands back (the card's events are
stood in for by a fake here; ``tests/test_torch_cuda.py`` times real ones).
Then the program: the spans and window counters a clip of the staged,
streamed and fused paths carries, the int8 modes' quantizer spans, and a
training step's spans.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dove_tpu_torch import config as tcfg
from dove_tpu_torch import obs
from dove_tpu_torch.inference import clip_log
from dove_tpu_torch.models.dit import init_dit_params
from dove_tpu_torch.models.vae import init_vae_params
from dove_tpu_torch.pipeline import DovePipeline, plan_axis
from dove_tpu_torch.train import args as targs
from dove_tpu_torch.train import trainer as ttrainer
from torch_threads import two_torch_threads  # noqa: F401 (autouse)

COUNTERS = {f"{s}.{c}" for s in ("enc", "dec") for c in ("windows_n", "window_px", "frame_px")}
SERVE_SPANS = {"prep", "enc", "enc.upload", "enc.upscale", "enc.windows", "enc.assemble",
               "dit", "dec", "dec.windows", "dec.assemble", "dec.download", "finish"}


def test_spans_nest_with_their_parents_on_the_host_clock():
    with obs.unit("cpu") as u:
        with obs.span("outer"):
            with obs.span("outer.inner"):
                time.sleep(0.02)
                assert [(s.name, s.parent) for s in obs.current().spans] == [
                    ("outer", None), ("outer.inner", "outer")]
            with obs.span("outer.inner"):
                time.sleep(0.01)
        with obs.span("host", host=True):
            pass
    assert set(u.times) == {"outer", "outer.inner", "host"}
    assert u.times["outer"] >= u.times["outer.inner"] >= 0.03
    assert u.spans == [] and obs.current() is None


def test_scope_comes_off_the_names_and_counters_add():
    with obs.unit("cpu", "train") as u:
        for _ in range(2):
            with obs.span("train.encode"):
                obs.count("train.windows_n", 3)
            obs.count("other_px", 5)
    assert set(u.times) == {"encode", "windows_n", "other_px"}
    assert u.times["windows_n"] == 6 and u.times["other_px"] == 10


def test_a_span_outside_a_unit_only_opens_its_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("lonely"):
            obs.count("lonely_n", 1)
            torch.ones(4).sum()
    assert obs.current() is None
    assert "dove.lonely" in {e.name for e in prof.events()}
    with profile(activities=[ProfilerActivity.CPU]) as prof, obs.unit("cpu") as u:
        with obs.span("kept"):
            torch.ones(4).sum()
    assert "dove.kept" in {e.name for e in prof.events()} and set(u.times) == {"kept"}


def test_spans_on_another_thread_only_open_their_range():
    seen = []

    def other():
        with obs.span("elsewhere"):
            seen.append(obs.current())

    with obs.unit("cpu") as u:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen == [None] and u.times == {}


def test_units_nest_and_each_keeps_its_own_spans():
    with obs.unit("cpu") as outer:
        with obs.span("a"):
            with obs.unit("cpu") as inner:
                with obs.span("b"):
                    pass
    assert set(outer.times) == {"a"} and set(inner.times) == {"b"}


class _FakeEvent:
    """A CUDA event's timing calls, on a clock that advances per record."""

    made = 0
    clock = 0.0
    waits: list = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        _FakeEvent.clock += 1.0
        self.t = _FakeEvent.clock

    def synchronize(self):
        _FakeEvent.waits.append(self)

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3  # ms: one second per record


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index=None: None)
    monkeypatch.setattr(obs, "_free_events", {})
    _FakeEvent.made, _FakeEvent.clock, _FakeEvent.waits = 0, 0.0, []
    yield


def test_device_spans_resolve_once_from_pooled_events(fake_card):
    for unit_no in range(3):
        with obs.unit("cuda:0") as u:
            with obs.span("a"):  # events 1 and 4
                with obs.span("a.b"):  # 2 and 3
                    pass
            with obs.span("h", host=True):
                pass
            with obs.span("a"):  # 5 and 6
                pass
            last = obs.current()._last
            assert len(_FakeEvent.waits) == unit_no  # no span waited
        # one wait a unit, for the last event it recorded
        assert len(_FakeEvent.waits) == unit_no + 1 and _FakeEvent.waits[-1] is last
        assert u.times["a"] == pytest.approx(3.0 + 1.0)
        assert u.times["a.b"] == pytest.approx(1.0)
        assert u.times["h"] >= 0.0 and set(u.times) == {"a", "a.b", "h"}
        # six events made for the first unit, reused by the next ones
        assert _FakeEvent.made == 6 and len(obs._free_events[0]) == 6


def test_a_unit_that_raises_resolves_nothing_and_hands_its_events_back(fake_card):
    with pytest.raises(RuntimeError):
        with obs.unit("cuda:0") as u:
            with obs.span("a"):
                raise RuntimeError("stop")
    assert u.times == {} and _FakeEvent.waits == [] and obs.current() is None
    assert len(obs._free_events[0]) == 2


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------

@pytest.fixture
def tiny():
    """Fresh tiny models: a pipeline in an int8 mode quantizes its own."""
    cfg = tcfg.tiny_test()
    prompt = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (7, cfg.dit.text_embed_dim)).astype(np.float32))
    return cfg, init_dit_params(cfg.dit, 0), init_vae_params(cfg.vae, 1), prompt


def _pipe(tiny, **kw) -> DovePipeline:
    cfg, dit, vae, prompt = tiny
    return DovePipeline(config=cfg, dit=dit, vae=vae, prompt_embedding=prompt,
                        dtype=torch.float32, device="cpu", output_uint8=True, **kw)


def _clip(frames: int, h: int, w: int) -> np.ndarray:
    return np.random.default_rng(frames).uniform(0, 1, (frames, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("mode,frames,quant_spans", [
    (None, 5, set()),
    ("int8-dit", 5, {"dit.quantize", "dit.dequantize"}),
    ("int8-dit", 37, {"dit.quantize", "dit.dequantize"}),  # streamed
    ("int8w", 37, {"dit.dequantize"}),  # streamed
])
def test_a_clip_carries_its_spans_and_window_counts(tiny, mode, frames, quant_spans):
    """A 16x144 clip is 8x72 latents: the bf16 plan's 1x3 encode and decode
    windows, the int8 DiT's 1x2 encode and 1x3 decode windows; each
    counted once a clip, whatever the number of streamed segments."""
    pipe = _pipe(tiny, vae_tiling=True, quantize=mode)
    out = pipe.process_frames(_clip(frames, 16, 144), seed=0)
    assert out.shape == (frames, 64, 576, 3)
    times = pipe.stage_times
    assert set(times) == SERVE_SPANS | COUNTERS | quant_spans
    blend, enc_max, dec_max = pipe._window_budget()
    for stage, most in (("enc", enc_max), ("dec", dec_max)):
        (th, _, nr), (tw, _, nc) = plan_axis(8, blend, most[0]), plan_axis(72, blend, most[1])
        assert (times[f"{stage}.windows_n"], times[f"{stage}.window_px"],
                times[f"{stage}.frame_px"]) == (nr * nc, nr * nc * th * tw, 8 * 72)
    assert times["enc.windows_n"] == (3 if mode is None else 2)
    for parent in ("enc", "dit", "dec"):
        children = sum(v for k, v in times.items()
                       if k.startswith(parent + ".") and not k.endswith(("_n", "_px")))
        assert children <= times[parent]
        assert children > 0 or (parent == "dit" and not quant_spans)
    log = clip_log(times)
    assert f"windows enc {times['enc.windows_n']} (" in log and "dit " in log


def test_the_fused_path_is_one_span(tiny):
    pipe = _pipe(tiny, vae_tiling=False)
    pipe.output_uint8 = False
    pipe.process_frames(_clip(5, 16, 16), seed=0)
    assert set(pipe.stage_times) == {"fused"} and pipe.stage_times["fused"] > 0


def test_a_training_step_carries_its_spans(tmp_path):
    args = targs.Args(
        model_path=tmp_path / "none", model_name="dove-s1", base_preset="tiny",
        training_type="lora", rank=4, lora_alpha=2, output_dir=tmp_path / "out",
        data_root=tmp_path, train_resolution=(5, 32, 32), batch_size=1, train_steps=1,
        mixed_precision="no", num_workers=0, lr_scheduler="constant")
    tr = ttrainer.DOVES1Trainer(args, device="cpu")
    tr.load_components()
    tr.prepare_optimizer(1)
    rng = np.random.default_rng(0)
    batch = {k: rng.uniform(-1, 1, (1, 5, 32, 32, 3)).astype(np.float32)
             for k in ("hq_video", "lq_video")}
    tr.train_step(tr.device_batch(batch))
    times = tr.step_times
    assert set(times) == {"encode", "dit_fwd_bwd", "dit_fwd", "backward", "optimizer"}
    assert times["dit_fwd_bwd"] >= times["backward"] + times["dit_fwd"] > 0
