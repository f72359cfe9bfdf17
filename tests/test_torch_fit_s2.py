"""``Trainer.fit`` of ``dove-s2`` SFT on ``real-sr-image-video`` against the
JAX trainer's, on tiny_test(): the stage-2 case of tests/test_torch_fit.py,
in a file of its own so that the two run on different workers; the
fixtures, helpers and bars are that file's.
"""

from __future__ import annotations

import numpy as np

from test_torch_fit import (  # noqa: F401 (fixtures)
    _assert_logs_match,
    _fit_both,
    checkpoint,
    same_start,
)
from torch_threads import two_torch_threads  # noqa: F401 (autouse)


def test_fit_stage2_image_video_matches_jax(checkpoint, tmp_path, same_start):
    """dove-s2 SFT on real-sr-image-video: a video step, then an image step
    (seed 1's coins at image_ratio 0.5)."""
    coins = [np.random.default_rng((1, s)).uniform() < 0.5 for s in range(2)]
    assert coins == [False, True]
    ref, ours, _ = _fit_both(
        checkpoint, tmp_path, model_name="dove-s2", model_type="real-sr-image-video",
        training_type="sft", image_column=lambda data: data / "images.txt",
        train_resolution="2x32x32", seed=1, image_ratio=0.5, frame_diff_weight=1.0,
        learning_rate=1e-4)
    _assert_logs_match(ours, ref)
    assert {"loss_pixel", "loss_frame_diff"} <= set(ours[1])
