#!/usr/bin/env python3
"""How far the full-width VLM towers on the card stray from their CPU run,
and how far a broken tower strays, on one H100.

    python3 scripts/tower_noise.py [--seeds 4] [--controls 2]

For CLIP-L/14-336 and SigLIP-so400m-384, each with an mlp_downsample
projector into Llama-3-8B's width, builds random weights and 2 images from
each of --seeds seeds, runs the tower and projector at bf16 on the CPU and
on the card (the same code, the same weights), and prints for the features
and the embeddings the two statistics of chip_smoke.py's towers phase: the
floor `hold` would need (the worst element's excess over one bf16 step, over
the largest |output|) and the relative RMS error. For the first --controls
seeds it also prints chip_smoke.py's broken towers (one layer skipped, the
wrong activation, bf16 attention). chip_smoke.py's TOWER_FLOOR and TOWER_RMS
are set between the sound and the broken readings. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as cs
    from qserve_tpu_torch.models import clip, mm_projector

    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, default=4)
    p.add_argument("--controls", type=int, default=2)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("tower_noise: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for name, cfg in (("CLIP-L/14-336", cs.CLIP_L_336),
                      ("SigLIP-so400m-384", cs.SIGLIP_SO400M_384)):
        vargs = clip.VisionArgs.from_hf_config(cfg)
        pargs = mm_projector.ProjectorArgs("mlp_downsample", vargs.hidden_size,
                                           cs.LLAMA3_8B["hidden_size"], grid=vargs.grid)
        S = vargs.image_size
        for seed in range(a.seeds):
            gen = torch.Generator().manual_seed(seed)
            vp = clip.random_params(gen, vargs, "cpu")
            pp = mm_projector.random_params(gen, pargs, "cpu")
            img = torch.from_numpy(np.random.default_rng(seed + 2).standard_normal(
                (2, 3, S, S)).astype(np.float32))
            feats = clip.forward_features(vp, img, vargs)
            emb = mm_projector.apply_projector(pp, feats, pargs)
            vg, pg, ig = cs._to(vp, "cuda"), cs._to(pp, "cuda"), img.to("cuda")
            gf = clip.forward_features(vg, ig, vargs).cpu()
            ge = mm_projector.apply_projector(pg, gf.to("cuda"), pargs).cpu()
            row = dict(tower=name, seed=seed,
                       features=(cs._need(gf, feats), cs._rel_rms(gf, feats)),
                       embeddings=(cs._need(ge, emb), cs._rel_rms(ge, emb)))
            print(f"{name} seed {seed}: features need {row['features'][0]:.4g}, RMS "
                  f"{row['features'][1]:.4g}; embeddings need {row['embeddings'][0]:.4g}, "
                  f"RMS {row['embeddings'][1]:.4g}", flush=True)
            if seed < a.controls:
                row["controls"] = cs._tower_controls(name, vg, ig, vargs, feats)
            rows.append(row)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
