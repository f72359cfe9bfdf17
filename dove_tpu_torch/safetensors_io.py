"""Read and write the safetensors format without the ``safetensors`` package.

A file is an 8-byte little-endian header length N, then N bytes of JSON, then
the tensors' raw little-endian bytes. The JSON maps each tensor's name to its
``dtype`` (``"BF16"``, ``"F32"``, ...), ``shape`` and ``data_offsets`` (begin
and end, relative to the end of the header); an optional ``__metadata__``
maps strings to strings. The package pads the header with spaces to a
multiple of 8 bytes and lays the buffers out back to back; :func:`save_file`
does the same, so the package reads what it writes.

The port reads checkpoints (``weights.load_safetensors_dir``,
``load_prompt_embedding``) and writes its exports
(``train/checkpointing.py``) through this module, so it runs where the
package is not installed.
"""

from __future__ import annotations

import json
import struct
import sys
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

DTYPES: dict[str, torch.dtype] = {
    "BOOL": torch.bool,
    "U8": torch.uint8,
    "I8": torch.int8,
    "I16": torch.int16,
    "I32": torch.int32,
    "I64": torch.int64,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F32": torch.float32,
    "F64": torch.float64,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
NAMES: dict[torch.dtype, str] = {v: k for k, v in DTYPES.items()}
_HEADER_LIMIT = 100 * 1024 * 1024  # the package's own bound on the header

if sys.byteorder != "little":  # the format's buffers are little-endian
    raise ImportError("safetensors_io reads and writes on little-endian hosts only")


def read_header(path: str | Path) -> tuple[dict[str, Any], int]:
    """The JSON header of a file and the byte offset where its data begins."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: too short for a safetensors file")
        (n,) = struct.unpack("<Q", head)
        if n > _HEADER_LIMIT:
            raise ValueError(f"{path}: header of {n} bytes")
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a file, each in its own CPU buffer, in the stored
    dtype and shape (``__metadata__`` is skipped)."""
    header, start = read_header(path)
    entries = sorted(((k, v) for k, v in header.items() if k != "__metadata__"),
                     key=lambda kv: kv[1]["data_offsets"][0])
    out: dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        for name, info in entries:
            dtype = DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
            shape = tuple(info["shape"])
            begin, end = info["data_offsets"]
            nbytes = end - begin
            count = int(np.prod(shape, dtype=np.int64))
            if nbytes != count * torch.empty((), dtype=dtype).element_size():
                raise ValueError(f"{path}: {name} spans {nbytes} bytes for {shape} "
                                 f"{info['dtype']}")
            if count == 0:
                out[name] = torch.empty(shape, dtype=dtype)
                continue
            buf = bytearray(nbytes)
            f.seek(start + begin)
            if f.readinto(buf) != nbytes:
                raise ValueError(f"{path}: {name} runs past the end of the file")
            out[name] = torch.frombuffer(buf, dtype=dtype).reshape(shape)
    return out


def _as_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
    return value.detach().cpu().contiguous()


def save_file(tensors: Mapping[str, Any], path: str | Path,
              metadata: Mapping[str, str] | None = None) -> None:
    """Write torch tensors or NumPy arrays to ``path`` in the package's
    layout: the header padded with spaces to 8 bytes, the buffers in the
    order of ``tensors``, back to back."""
    items = [(name, _as_tensor(v)) for name, v in tensors.items()]
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in items:
        if t.dtype not in NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t in items:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())
