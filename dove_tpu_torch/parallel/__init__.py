"""Multi-device serving and training on ``torch.distributed``: the counterpart
of ``dove_tpu/parallel/`` (``distributed.py``: the process group; ``mesh.py``:
the ("data", "model") mesh and FSDP; ``tp.py``: the tensor- and
sequence-parallel DiT)."""
