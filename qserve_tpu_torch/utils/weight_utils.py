"""Checkpoint weight files (qserve_tpu/utils/weight_utils.py).

The safetensors format is read and written here with the standard library,
numpy and torch only: an 8-byte little-endian header length N, a JSON
header of N bytes ({name: {"dtype", "shape", "data_offsets"}} and an
optional "__metadata__" of strings), then the tensors' raw bytes, with no
gap and no overlap. The reader memory-maps the file, so a tensor's pages
are read when it is first touched.

`hf_model_weights_iterator` yields (name, CPU tensor) pairs from a local
Hugging Face model directory: safetensors shards first, then torch .bin or
.pt files (upcast to f32, as the JAX package does). Nothing is downloaded.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
import sys
from typing import Dict, Iterator, Optional, Tuple

import torch

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_HEADER_LIMIT = 100 << 20  # the format's own bound on the JSON header


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _parse_header(header: dict, data_len: int, path: str):
    """Validated [(name, dtype, shape, begin, end)] sorted by offset."""
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the safetensors header is not a JSON object")
    metadata = header.pop("__metadata__", None)
    if metadata is not None and not (
        isinstance(metadata, dict)
        and all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items())
    ):
        raise ValueError(f"{path}: __metadata__ must map strings to strings")
    entries = []
    for name, info in header.items():
        try:
            dtype = DTYPES[info["dtype"]]
            shape = [int(s) for s in info["shape"]]
            begin, end = (int(o) for o in info["data_offsets"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: malformed header entry {name!r}: {info!r}") from e
        if any(s < 0 for s in shape):
            raise ValueError(f"{path}: {name!r} has a negative dimension {shape}")
        numel = 1
        for s in shape:
            numel *= s
        if end - begin != numel * _itemsize(dtype):
            raise ValueError(
                f"{path}: {name!r} spans bytes [{begin}, {end}) but its "
                f"{info['dtype']} {shape} needs {numel * _itemsize(dtype)}"
            )
        entries.append((name, dtype, shape, begin, end))
    entries.sort(key=lambda e: (e[3], e[4]))
    pos = 0
    for name, _, _, begin, end in entries:
        if begin != pos:
            what = "overlaps the tensor before it" if begin < pos else "leaves a gap"
            raise ValueError(f"{path}: {name!r} at byte {begin} {what} (expected {pos})")
        pos = end
    if pos != data_len:
        raise ValueError(
            f"{path}: the header indexes {pos} bytes of data but the file holds "
            f"{data_len} (truncated or padded)"
        )
    return entries


def _open(path: str):
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 8:
            raise ValueError(f"{path}: {size} bytes is shorter than the 8-byte header length")
        (n,) = struct.unpack("<Q", f.read(8))
        if n > min(size - 8, _HEADER_LIMIT):
            raise ValueError(f"{path}: header length {n} does not fit a {size}-byte file")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: the safetensors header is not JSON") from e
        entries = _parse_header(header, size - 8 - n, path)
        # a private copy-on-write map: writable for torch.frombuffer, and the
        # pages are read from the file only when touched
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    return mm, [(name, dt, shape, 8 + n + b, 8 + n + e) for name, dt, shape, b, e in entries]


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file, memory-mapped (the tensors
    keep the map alive). Raises ValueError on a malformed header, offsets
    that overlap or leave gaps, or a file shorter than its header says."""
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors data is little-endian")
    mm, entries = _open(path)
    out = {}
    for name, dtype, shape, begin, end in entries:
        isz = _itemsize(dtype)
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
        elif begin % isz:  # unaligned (the writer below never does this)
            raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin, offset=begin)
            out[name] = raw.clone().view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(
                mm, dtype=dtype, count=(end - begin) // isz, offset=begin
            ).reshape(shape)
    return out


def write_safetensors(
    tensors: Dict[str, torch.Tensor], path: str,
    metadata: Optional[Dict[str, str]] = None,
) -> int:
    """Write {name: tensor} (any device; copied to the host one at a time)
    as a safetensors file. Tensors go in order of decreasing element size,
    then name, as the safetensors library orders them, so every tensor is
    aligned to its element size; the header is padded with spaces to a
    multiple of 8 bytes. Returns the file's size in bytes."""
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    pos = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name!r}: dtype {t.dtype} has no safetensors name here")
        nbytes = t.numel() * t.element_size()
        header[name] = dict(dtype=_NAMES[t.dtype], shape=list(t.shape),
                            data_offsets=[pos, pos + nbytes])
        pos += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                t = t.reshape(-1).contiguous().cpu()
                f.write(t.view(torch.uint8).numpy().data)
    return 8 + len(blob) + pos


def hf_weight_files(model_dir: str) -> Tuple[list, str]:
    st = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if st:
        return st, "safetensors"
    bins = sorted(glob.glob(os.path.join(model_dir, "*.bin")))
    if bins:
        return bins, "pt"
    pts = sorted(glob.glob(os.path.join(model_dir, "*.pt")))
    if pts:
        return pts, "pt"
    raise FileNotFoundError(f"no weight files (*.safetensors|*.bin|*.pt) in {model_dir}")


def hf_model_weights_iterator(model_dir: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor): safetensors tensors in their stored dtype, .bin /
    .pt tensors upcast to f32."""
    files, fmt = hf_weight_files(model_dir)
    if fmt == "safetensors":
        for f in files:
            yield from read_safetensors(f).items()
    else:
        for f in files:
            state = torch.load(f, map_location="cpu", weights_only=True)
            for name, t in state.items():
                yield name, t.float()
