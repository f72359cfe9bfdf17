"""The training entry point: the counterpart of ``scripts/train.py``.

    python -m dove_tpu_torch.train --model_path <dir> --model_name dove-s1 \\
        --data_root data --video_column data/HQ-VSR.txt ... [--device cpu]

Parses ``Args`` (every flag of ``scripts/train_s1.sh`` and
``scripts/train_s2.sh``), resolves the registered trainer and runs ``fit``.
``--device`` is the port's own, as in its inference CLI: the card unless it
says ``cpu`` (and without a card the run raises). ``--multihost true`` joins
the process group first (``parallel/distributed.py``: torchrun's variables
or ``DOVE_COORDINATOR`` / ``DOVE_NUM_PROCESSES`` / ``DOVE_PROCESS_ID``), one
process per device: NCCL on the card, gloo on the CPU::

    torchrun --nproc-per-node 4 -m dove_tpu_torch.train --multihost true \
        --data_parallel 2 --tensor_parallel 2 ...
"""

from __future__ import annotations

import logging
import sys

from dove_tpu_torch.parallel.distributed import init_distributed
from dove_tpu_torch.train.args import Args
from dove_tpu_torch.train.trainer import get_model_cls


def main(argv: list[str] | None = None):
    """Train as ``argv`` says; returns the trainer after ``fit``."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    parser = Args.parser()
    parser.add_argument(
        "--device", default=None,
        help="cuda (the default; raises without a card) or cpu")
    ns = parser.parse_args(argv)
    args = Args.from_namespace(ns)
    if args.multihost:
        rank, world = init_distributed(device=ns.device)
        logging.info("multihost: rank %d of %d", rank, world)
    trainer = get_model_cls(args.model_name, args.training_type)(args, device=ns.device)
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
