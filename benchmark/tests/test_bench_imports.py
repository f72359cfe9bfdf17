"""What the benchmark loads, checked in fresh processes by whole top-level
module names: no JAX and no JAX package anywhere; nothing of the program in
the reference. And the command refuses to run without a card, printing no
result."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.tests.fixtures_bench import REPO

PROBE = """
import json, sys
sys.path.insert(0, {repo!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", PROBE.format(repo=str(REPO), body=body)],
                         capture_output=True, text=True, check=True, cwd=REPO)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    body = """
from benchmark import harness
for kind in ("serve_clip", "train_s1"):
    harness.load_module((harness.ROOT,), "drivers", kind)
for m in json.load(open(harness.REPO / "BENCHMARK.json"))["per_layer"]:
    harness.load_module((harness.ROOT,), "metrics", m["name"])
import dove_tpu_torch.pipeline, dove_tpu_torch.train.trainer
"""
    names = loaded(body)
    assert "dove_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "dove_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = loaded("import benchmark.reference.serve, benchmark.reference.train, "
                   "benchmark.weights")
    assert not names & {"jax", "jaxlib", "flax", "dove_tpu", "dove_tpu_torch"}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "5b_bf16_clip32",
         "--seed", str(2**31 + 3), "--seconds", "10", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO, env={"CUDA_VISIBLE_DEVICES": "",
                                                       "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
