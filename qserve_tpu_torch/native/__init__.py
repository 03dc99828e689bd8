"""Per-step batch marshalling on the host (qserve_tpu/native/__init__.py).

`pack_decode` and `pack_prefill` run marshal.cpp, built with
`g++ -O2 -shared -fPIC` at first use into native/build/ (named by the
source's hash, so a stale library never loads) and called through ctypes.
Concurrent first uses (test workers, ranks) each compile to a name of
their own and `os.replace` it into place, so no process loads a
half-written library.

There is no quiet fallback: a failed build raises with the compiler's
message. The numpy versions (`pack_decode_plain`, `pack_prefill_plain`)
are the plain versions the library is held against; they serve a call
only when QSERVE_TPU_NO_NATIVE=1 is set (the JAX package's switch), which
is logged once.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from qserve_tpu_torch.logger import init_logger

logger = init_logger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "marshal.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
SWITCH = "QSERVE_TPU_NO_NATIVE"
_lock = threading.Lock()
_lib = None
_switch_logged = False

_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def library_path() -> str:
    """The library's path in BUILD_DIR, keyed on the source's hash (git
    checkouts do not keep mtimes)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"marshal-{digest}.so")


def build() -> str:
    """Compile marshal.cpp unless its library exists; returns its path.
    Raises RuntimeError with g++'s message when the build fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native marshal: {' '.join(cmd)} did not run: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(
            f"native marshal: {' '.join(cmd)} failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)
    return so


def get_lib():
    """The loaded library, or None while QSERVE_TPU_NO_NATIVE=1."""
    global _lib, _switch_logged
    if _lib is not None:
        return _lib
    if os.environ.get(SWITCH, "0") == "1":
        if not _switch_logged:
            _switch_logged = True
            logger.warning("%s=1: batches are packed by the numpy path", SWITCH)
        return None
    with _lock:
        if _lib is None:
            so = build()
            lib = ctypes.CDLL(so)
            lib.qs_pack_decode.argtypes = [
                ctypes.c_int32, _I32P, _I32P, _I32P, _I32P,
                ctypes.c_int32, ctypes.c_int32, _I32P, _I32P, _I32P,
            ]
            lib.qs_pack_decode.restype = None
            lib.qs_pack_prefill.argtypes = [
                ctypes.c_int32, _I32P, _I32P, _I32P, _I32P, _I32P,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                _I32P, _I32P, _I32P, _I32P, _I32P, _I32P, _I32P,
            ]
            lib.qs_pack_prefill.restype = ctypes.c_int32
            _lib = lib
            logger.info("native marshal loaded from %s", so)
    return _lib


def _flatten(lists: Sequence[Sequence[int]]) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenated int32 values and the [n + 1] offsets of their lists."""
    offsets = np.zeros(len(lists) + 1, np.int32)
    np.cumsum(np.fromiter(map(len, lists), np.int32, count=len(lists)), out=offsets[1:])
    flat = np.fromiter(itertools.chain.from_iterable(lists), np.int32, count=int(offsets[-1]))
    return flat, offsets


def _decode_rows(last_tokens, ctx_lens, tables, B_pad) -> int:
    """The batch's row count, once its lists agree and fit B_pad (the C
    side reads and writes that many rows)."""
    n = len(last_tokens)
    if not n == len(ctx_lens) == len(tables) or n > B_pad:
        raise ValueError(f"pack_decode: {n} tokens, {len(ctx_lens)} lengths and "
                         f"{len(tables)} page tables for B_pad={B_pad}")
    return n


def pack_decode(
    last_tokens: Sequence[int],
    ctx_lens: Sequence[int],
    tables: Sequence[Sequence[int]],
    B_pad: int,
    maxP: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (tokens [B_pad], ctx [B_pad], block_table [B_pad, maxP])."""
    lib = get_lib()
    if lib is None:
        return pack_decode_plain(last_tokens, ctx_lens, tables, B_pad, maxP)
    n = _decode_rows(last_tokens, ctx_lens, tables, B_pad)
    out_tok = np.empty(B_pad, np.int32)
    out_ctx = np.empty(B_pad, np.int32)
    out_bt = np.empty((B_pad, maxP), np.int32)
    flat, offs = _flatten(tables)
    lib.qs_pack_decode(
        n, np.ascontiguousarray(last_tokens, np.int32),
        np.ascontiguousarray(ctx_lens, np.int32), flat, offs,
        B_pad, maxP, out_tok, out_ctx, out_bt.reshape(-1),
    )
    return out_tok, out_ctx, out_bt


def pack_decode_plain(
    last_tokens: Sequence[int],
    ctx_lens: Sequence[int],
    tables: Sequence[Sequence[int]],
    B_pad: int,
    maxP: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """numpy version of pack_decode."""
    n = _decode_rows(last_tokens, ctx_lens, tables, B_pad)
    out_tok = np.zeros(B_pad, np.int32)
    out_ctx = np.zeros(B_pad, np.int32)
    out_bt = np.zeros((B_pad, maxP), np.int32)
    out_tok[:n] = last_tokens
    out_ctx[:n] = ctx_lens
    for i, t in enumerate(tables):
        out_bt[i, : min(len(t), maxP)] = t[:maxP]
    return out_tok, out_ctx, out_bt


def _starts(starts, n) -> np.ndarray:
    return np.ascontiguousarray(
        starts if starts is not None else np.zeros(n, np.int32), dtype=np.int32
    )


def _image_token(image_token) -> np.int32:
    return np.int32(image_token) if image_token is not None else np.int32(-(2**31))


def pack_prefill(
    prompts: Sequence[Sequence[int]],
    tables: Sequence[Sequence[int]],
    block_size: int,
    T_pad: int,
    B_pad: int,
    image_token: Optional[int] = None,
    starts: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, ...]:
    """-> (tokens, positions, segids, pages, slots, img_idx [T_pad],
           last_idx [B_pad], total_tokens).

    starts: absolute start position per prompt (chunked prefill — `prompts`
    then holds only the chunk's tokens); None = all prompts start at 0."""
    lib = get_lib()
    if lib is None:
        return pack_prefill_plain(prompts, tables, block_size, T_pad, B_pad,
                                  image_token, starts)
    n = len(prompts)
    st = _starts(starts, n)
    if len(tables) != n or len(st) != n:  # the C side reads n of each
        raise ValueError(f"pack_prefill: {n} prompts, {len(tables)} page tables, "
                         f"{len(st)} starts")
    outs = [np.empty(T_pad, np.int32) for _ in range(6)]
    last_idx = np.empty(B_pad, np.int32)
    pflat, poffs = _flatten(prompts)
    tflat, toffs = _flatten(tables)
    total = lib.qs_pack_prefill(
        n, pflat, poffs, tflat, toffs, st, block_size,
        _image_token(image_token), T_pad, B_pad, *outs, last_idx,
    )
    if total < 0:
        raise ValueError(
            f"pack_prefill overflow: {n} prompts ({int(poffs[-1])} tokens) "
            f"do not fit T_pad={T_pad} / B_pad={B_pad} or a page table is "
            "too short"
        )
    return (*outs, last_idx, int(total))


def pack_prefill_plain(
    prompts: Sequence[Sequence[int]],
    tables: Sequence[Sequence[int]],
    block_size: int,
    T_pad: int,
    B_pad: int,
    image_token: Optional[int] = None,
    starts: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, ...]:
    """numpy version of pack_prefill."""
    n = len(prompts)
    itok = _image_token(image_token)
    st = _starts(starts, n)
    total = sum(len(p) for p in prompts)
    if n > B_pad or total > T_pad or any(
        p and (int(st[i]) + len(p) - 1) // block_size >= len(tables[i])
        for i, p in enumerate(prompts)
    ):
        raise ValueError(
            f"pack_prefill overflow: {n} prompts ({total} tokens) do not fit "
            f"T_pad={T_pad} / B_pad={B_pad} or a page table is too short"
        )
    tokens, positions, segids, slots, img_idx = (np.zeros(T_pad, np.int32) for _ in range(5))
    pages = np.full(T_pad, -1, np.int32)
    last_idx = np.zeros(B_pad, np.int32)
    t = 0
    n_img = 0
    for i, prompt in enumerate(prompts):
        table = tables[i]
        s0 = int(st[i])
        for p, tok in enumerate(prompt):
            tokens[t] = tok
            positions[t] = s0 + p
            segids[t] = i + 1
            pages[t] = table[(s0 + p) // block_size]
            slots[t] = (s0 + p) % block_size
            if tok == itok:
                img_idx[t] = n_img
                n_img += 1
            t += 1
        last_idx[i] = t - 1
    return (tokens, positions, segids, pages, slots, img_idx, last_idx, t)
