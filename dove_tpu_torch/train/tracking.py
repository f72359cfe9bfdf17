"""W&B-compatible offline experiment tracking (no network, no wandb package).

A copy of ``dove_tpu/train/tracking.py`` for the port, which may not import
the JAX package; it needs neither PyYAML (``config.yaml`` is written line by
line in wandb's config-file schema) nor the wandb package, and writes the
tfevents only where ``torch.utils.tensorboard`` imports.

The reference logs steps and validation media to Weights & Biases through
``accelerator.init_trackers`` (its ``finetune/trainer.py:485-493``) and
``wandb.Video``/``wandb.Image`` media records (:803-843). Without the wandb
package or a network, ``report_to=wandb`` writes a wandb-layout offline run
directory instead:

    <output_dir>/wandb/offline-run-<YYYYMMDD_HHMMSS>-<id>/files/
        wandb-metadata.json      host/program/args provenance
        config.yaml              run config, wandb config-file schema
        wandb-summary.json       latest value of every logged key
        wandb-history.jsonl      one record per log(): {"_step", "_runtime",
                                 "_timestamp", **metrics} (wandb history
                                 export schema)
        output.log               mirrored log lines
        media/videos/<key>/      validation clips (step-stamped filenames)
        events.out.tfevents.*    scalars as tensorboard events

Import path on a wandb-equipped machine: ``wandb sync --sync-tensorboard
<run_dir>/files`` ingests the tfevents scalars into a real W&B run, and the
history/summary/media files carry everything else in documented formats.
(The binary .wandb transaction log is NOT written — producing it requires
wandb's own protobuf schema; the tfevents + history pair is the documented
no-wandb-at-train-time import route.)
"""

from __future__ import annotations

import json
import logging
import platform
import shutil
import sys
import time
from pathlib import Path
from typing import Any, Mapping

logger = logging.getLogger(__name__)


def _yaml_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    if s == "" or any(c in s for c in ":#{}[]'\"\n"):
        return json.dumps(s)
    return s


class WandbOfflineRun:
    """Minimal W&B-offline-shaped run writer (scalars, media, summary)."""

    def __init__(self, output_dir: Path, project: str, config: Mapping[str, Any],
                 run_id: str | None = None):
        stamp = time.strftime("%Y%m%d_%H%M%S")
        rid = run_id or f"{abs(hash((stamp, str(output_dir)))) % 16**8:08x}"
        self.run_dir = Path(output_dir) / "wandb" / f"offline-run-{stamp}-{rid}"
        self.files = self.run_dir / "files"
        (self.files / "media").mkdir(parents=True, exist_ok=True)
        self._t0 = time.time()
        self._summary: dict[str, Any] = {}
        self._history = open(self.files / "wandb-history.jsonl", "a")
        self._output = open(self.files / "output.log", "a")

        (self.files / "wandb-metadata.json").write_text(json.dumps({
            "os": platform.platform(),
            "python": platform.python_version(),
            "program": sys.argv[0],
            "args": sys.argv[1:],
            "startedAt": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "project": project,
        }, indent=2))

        lines = ["wandb_version: 1", ""]
        for k in sorted(config):
            lines += [f"{k}:", "  desc: null",
                      f"  value: {_yaml_scalar(config[k])}"]
        (self.files / "config.yaml").write_text("\n".join(lines) + "\n")

        # tfevents scalars: the `wandb sync --sync-tensorboard` import route
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=str(self.files))
        except Exception as e:  # pragma: no cover - no tensorboard backend
            logger.warning("wandb-offline: tfevents writer unavailable (%s); "
                           "history/summary/media still written", e)

    # ------------------------------------------------------------------

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        now = time.time()
        rec = {"_step": int(step), "_runtime": round(now - self._t0, 3),
               "_timestamp": round(now, 3)}
        for k, v in metrics.items():
            rec[k] = float(v) if isinstance(v, (int, float)) else v
        self._history.write(json.dumps(rec) + "\n")
        self._history.flush()
        self._summary.update(rec)
        (self.files / "wandb-summary.json").write_text(
            json.dumps(self._summary))
        self._output.write(json.dumps(rec) + "\n")
        self._output.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def log_video(self, key: str, path: Path, step: int) -> None:
        """Register a validation clip as a wandb video-file media record."""
        path = Path(path)
        media_dir = self.files / "media" / "videos" / key.replace("/", "_")
        media_dir.mkdir(parents=True, exist_ok=True)
        dest = media_dir / f"{path.stem}_step{step}{path.suffix}"
        shutil.copy2(path, dest)
        rel = dest.relative_to(self.files).as_posix()
        self.log({key: {"_type": "video-file", "path": rel,
                        "size": dest.stat().st_size}}, step)

    def finish(self) -> None:
        self._history.close()
        self._output.close()
        if self._tb is not None:
            self._tb.close()
        (self.run_dir / "run-finished").write_text(
            time.strftime("%Y-%m-%dT%H:%M:%S") + "\n")
