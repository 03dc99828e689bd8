#!/usr/bin/env python
"""Generate webdataset shard metadata with the PyTorch port's shard reader
(scripts/generate_wds_meta.py's counterpart; reference:
data_prepare/generate_cc_wds_meta.py).

Writes a JSON shardlist {"shardlist": [{"url", "nsamples"}...]} for a glob or
brace pattern of tar shards, counting image-bearing samples per shard.

  python scripts/generate_wds_meta_torch.py 'shards/cc-{00000..00099}.tar' meta.json
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from qserve_tpu_torch.utils import webdataset as wds


def main(argv=None):
    pattern, out_path = (sys.argv[1:] if argv is None else argv)[:2]
    entries = []
    for path in wds.list_shards(pattern):
        n = sum(1 for s in wds.iter_samples(path) if wds.first_image(s))
        entries.append({"url": path, "nsamples": n})
        print(f"{path}: {n} samples")
    with open(out_path, "w") as f:
        json.dump({"shardlist": entries}, f, indent=1)


if __name__ == "__main__":
    main()
