"""A reader and writer of the safetensors file format, for the files the
JAX package writes with ``safetensors.numpy`` and the diffusers and HF
snapshots (the card's machine has no ``safetensors`` package).

The format: an unsigned 64-bit little-endian header length N, N bytes of
JSON ({name: {"dtype", "shape", "data_offsets": [begin, end]}}, and an
optional "__metadata__" of strings), then the tensors' raw little-endian
bytes, each at its offsets from the end of the header.  The writer pads
the header with spaces to a multiple of 8 bytes, as the reference writer
does, and lays the tensors out in name order (the reference orders them by
dtype first, so a file of one dtype comes out the same byte for byte).

F32, F16 and BF16 are read and written.  numpy has no bfloat16, so
:func:`load_file` widens BF16 to float32 bit-exactly (the bf16 bits are the
high half of the float32's), and :func:`load_torch` hands back torch
tensors in the stored dtype; :func:`save_file` takes numpy arrays or torch
tensors, and writes a bfloat16 tensor as BF16.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict

import numpy as np
import torch

# stored dtype -> (numpy dtype of its bits, torch dtype)
_DTYPES = {
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.int16, torch.bfloat16),
}
_NUMPY_NAMES = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16"}
_TORCH_NAMES = {t: name for name, (_, t) in _DTYPES.items()}


def _bits(name: str, value):
    """(stored dtype, the little-endian bytes) of a numpy array or a torch
    tensor."""
    if isinstance(value, torch.Tensor):
        if value.dtype not in _TORCH_NAMES:
            raise TypeError(f"{name}: dtype {value.dtype} is not one this codec writes")
        kind = _TORCH_NAMES[value.dtype]
        arr = value.detach().cpu().contiguous().view(
            torch.int16 if kind == "BF16" else value.dtype).numpy()
    else:
        arr = np.ascontiguousarray(value)
        if arr.dtype not in _NUMPY_NAMES:
            raise TypeError(f"{name}: dtype {arr.dtype} is not one this codec writes")
        kind = _NUMPY_NAMES[arr.dtype]
    return kind, arr.astype(arr.dtype.newbyteorder("<"), copy=False)


def save_file(tensors: Dict[str, object], path: str) -> None:
    """Write ``tensors`` ({name: numpy array or torch tensor}) to ``path``."""
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        kind, arr = _bits(name, tensors[name])
        header[name] = {"dtype": kind, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        chunks.append(arr)
        offset += arr.nbytes
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for arr in chunks:
            f.write(memoryview(arr.reshape(-1).view(np.uint8)))


def _read(path: str) -> Dict[str, tuple]:
    """{name: (stored dtype, a numpy array of its bits)}, copied out of the
    file."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size < 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as raw:
            (n,) = struct.unpack("<Q", raw[:8])
            if 8 + n > size:
                raise ValueError(f"{path}: header length {n} runs past the file")
            header = json.loads(raw[8:8 + n])
            body_len = size - 8 - n
            out = {}
            for name, info in header.items():
                if name == "__metadata__":
                    continue
                if info["dtype"] not in _DTYPES:
                    raise TypeError(f"{path}: {name} is {info['dtype']}; only "
                                    f"{sorted(_DTYPES)} are read")
                dtype = np.dtype(_DTYPES[info["dtype"]][0]).newbyteorder("<")
                begin, end = info["data_offsets"]
                shape = tuple(info["shape"])
                if not 0 <= begin <= end <= body_len or \
                        end - begin != int(np.prod(shape)) * dtype.itemsize:
                    raise ValueError(f"{path}: {name} has bad data_offsets {begin, end}")
                arr = np.frombuffer(raw, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                    offset=8 + n + begin)
                out[name] = (info["dtype"],
                             arr.reshape(shape).astype(dtype.newbyteorder("=")))
                del arr  # the map closes only once no array views it
    return out


def load_file(path: str) -> Dict[str, np.ndarray]:
    """{name: numpy array} of the safetensors file at ``path``; BF16 comes
    back as float32 of the same value."""
    out = {}
    for name, (kind, arr) in _read(path).items():
        if kind == "BF16":
            arr = (arr.astype(np.uint16).astype(np.uint32) << 16).view(np.float32)
        out[name] = arr
    return out


def load_torch(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU torch tensor} of the safetensors file at ``path``, each in
    its stored dtype."""
    return {name: (torch.from_numpy(arr).view(torch.bfloat16) if kind == "BF16"
                   else torch.from_numpy(arr))
            for name, (kind, arr) in _read(path).items()}
