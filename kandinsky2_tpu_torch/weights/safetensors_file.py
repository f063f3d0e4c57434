"""A numpy reader and writer of the safetensors file format, for the files
the JAX package writes with ``safetensors.numpy`` (the card's machine has
no ``safetensors`` package).

The format: an unsigned 64-bit little-endian header length N, N bytes of
JSON ({name: {"dtype", "shape", "data_offsets": [begin, end]}}, and an
optional "__metadata__" of strings), then the tensors' raw little-endian
bytes, each at its offsets from the end of the header.  The writer pads
the header with spaces to a multiple of 8 bytes, as the reference writer
does, and lays the tensors out in name order (the reference orders them by
dtype first, so a file of one dtype comes out the same byte for byte).
"""

from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np

# the LPIPS weights file holds fp32 tensors only
_DTYPES = {"F32": np.float32}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def save_file(tensors: Dict[str, np.ndarray], path: str) -> None:
    """Write ``tensors`` ({name: numpy array}) to ``path``."""
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        if arr.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {arr.dtype} is not one this codec writes")
        data = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _NAMES[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(data)]}
        chunks.append(data)
        offset += len(data)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for data in chunks:
            f.write(data)


def load_file(path: str) -> Dict[str, np.ndarray]:
    """{name: numpy array} of the safetensors file at ``path``."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header length {n} runs past the file")
    header = json.loads(raw[8:8 + n])
    body = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise TypeError(f"{path}: {name} is {info['dtype']}; only "
                            f"{sorted(_DTYPES)} are read")
        dtype = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if not 0 <= begin <= end <= len(body) or \
                end - begin != int(np.prod(shape)) * dtype.itemsize:
            raise ValueError(f"{path}: {name} has bad data_offsets {begin, end}")
        out[name] = np.frombuffer(body[begin:end], dtype=dtype).reshape(shape) \
            .astype(dtype.newbyteorder("="))
    return out
