"""Minimal webdataset-style tar shard reader, no external deps (a copy of
qserve_tpu/utils/webdataset.py).

A plain tarfile iterator that groups members by key (basename without
extension) and yields dicts {'__key__', 'jpg'/'png': bytes, 'json'/'txt': ...},
plus a shard-list helper for DP sharding by index (the reference shards tar
files across GPUs/nodes by `8 * job_id + gpu`, run_cap_*_8gpus.sh:15-31).
"""

from __future__ import annotations

import glob
import json
import os
import tarfile
from typing import Dict, Iterator, List, Optional, Sequence

IMAGE_EXTS = ("jpg", "jpeg", "png", "webp", "bmp")


def list_shards(pattern: str) -> List[str]:
    """Expand a glob or brace-range pattern into a sorted shard list."""
    if "{" in pattern and ".." in pattern:  # e.g. shard-{00000..00099}.tar
        pre, rest = pattern.split("{", 1)
        rng, post = rest.split("}", 1)
        lo, hi = rng.split("..")
        width = len(lo)
        return [f"{pre}{i:0{width}d}{post}" for i in range(int(lo), int(hi) + 1)]
    return sorted(glob.glob(pattern))


def shard_for_worker(
    shards: Sequence[str], worker_id: int, num_workers: int
) -> List[str]:
    """Strided split of the shard list (DP over processes/hosts)."""
    return list(shards[worker_id::num_workers])


def iter_samples(tar_path: str) -> Iterator[Dict]:
    """Yield grouped samples from one tar shard."""
    with tarfile.open(tar_path, "r") as tf:
        current_key: Optional[str] = None
        sample: Dict = {}
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            base, dot, ext = name.rpartition(".")
            if not dot:
                base, ext = name, ""
            ext = ext.lower()
            if current_key is not None and base != current_key and sample:
                yield sample
                sample = {}
            current_key = base
            sample["__key__"] = base
            data = tf.extractfile(member).read()
            if ext == "json":
                sample[ext] = json.loads(data)
            elif ext in ("txt", "text", "caption"):
                sample[ext] = data.decode("utf-8", errors="replace")
            else:
                sample[ext] = data
        if sample:
            yield sample


def first_image(sample: Dict) -> Optional[bytes]:
    for ext in IMAGE_EXTS:
        if ext in sample:
            return sample[ext]
    return None
