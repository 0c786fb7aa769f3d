"""The safetensors format, read and written by the port itself.

A file is a little-endian u64 header length N, then N bytes of JSON (for
each tensor name its ``dtype``, ``shape`` and ``data_offsets`` [begin, end)
into the data that follows, and an optional ``__metadata__`` of strings),
padded with spaces to a multiple of 8, then the tensors' raw little-endian
bytes. Files written here load with ``safetensors.torch.load_file`` and
files written by ``safetensors.torch.save_file`` load here; the
``safetensors`` package itself is never imported.

Reading maps the file (copy-on-write) and wraps each tensor's bytes with
``torch.frombuffer``: nothing is copied until the caller moves or converts
a tensor, and each tensor keeps the mapping alive.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from typing import Dict, Optional

import torch

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
          "F32": torch.float32, "F64": torch.float64, "I8": torch.int8,
          "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32,
          "I64": torch.int64, "BOOL": torch.bool}
NAMES = {v: k for k, v in DTYPES.items()}


def read_header(path: str) -> tuple:
    """(header dict without ``__metadata__``, metadata or None, offset of
    the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None)
    return header, meta, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one file, as CPU tensors over the mapped file."""
    header, _, base = read_header(path)
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) \
            if size > base else None
    out = {}
    for name, info in header.items():
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = info["shape"]
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin,
                               offset=base + begin)
        if (base + begin) % dtype.itemsize:
            raw = raw.clone()  # an unaligned tensor gets aligned storage
        out[name] = raw.view(dtype).reshape(shape)
    return out


def load_dir(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of every ``*.safetensors`` file in a directory, the
    files taken in sorted order (a name in two shards: the later wins)."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors under {path}")
    sd = {}
    for f in files:
        sd.update(load_file(f))
    return sd


def _bytes(t: torch.Tensor) -> memoryview:
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return memoryview(t.view(torch.uint8).numpy())


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device) as one file, in name order."""
    header, offset = {}, 0
    if metadata is not None:
        header["__metadata__"] = dict(metadata)
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in names:
            if tensors[name].numel():
                f.write(_bytes(tensors[name]))
