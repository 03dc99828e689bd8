"""VLM model runner: vision encode + image-spliced prefill
(qserve_tpu/worker/vlm_runner.py).

Prompts arrive expanded (tokens_per_image markers an image, models/vila.py),
so this runner only (a) encodes the step's images through the tower and
projector and (b) hands the flat image embeddings and each position's row
in them to `vila.vlm_prefill` / `vila.vlm_prefill_chunk`. Decode, and any
batch without images, is the dense runner's: image tokens live in the KV
cache like any others. The JAX package pads the image batch to a power of
two to fix its jit shapes; the port encodes the images it has.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from qserve_tpu_torch import native
from qserve_tpu_torch.models import vila
from qserve_tpu_torch.sequence import SequenceGroupMetadata
from qserve_tpu_torch.utils.constants import IMAGE_TOKEN_INDEX
from qserve_tpu_torch.utils.utils import bucket, to_device
from qserve_tpu_torch.worker.model_runner import ModelRunner


def _pixels(md: SequenceGroupMetadata):
    mm = md.multi_modal_data
    return mm.get("pixel_values") if mm else None


class VLMModelRunner(ModelRunner):
    """ModelRunner whose prefill splices vision-tower embeddings."""

    # n>1 / best_of>1 image prompts: extra candidates host-sampled from the
    # spliced prefill's last-token logits, as in the dense runner
    supports_multi_sample = True

    def __init__(self, vila_params: vila.VilaParams, vila_args: vila.VilaArgs,
                 *args, **kw):
        super().__init__(vila_params.llm, vila_args.llm, *args, **kw)
        self.vila_params = vila_params
        self.vila_args = vila_args
        # seq_id -> the prompt's encoded image embeddings, reused by a
        # chunked prompt's continuation steps (the tower runs once a prompt)
        self._chunk_embeds: Dict[int, torch.Tensor] = {}

    @classmethod
    def from_random_vlm(cls, vila_args: vila.VilaArgs, max_model_len: int,
                        block_size: int, seed: int = 0, device="cuda", **kw):
        params = vila.random_params(seed, vila_args, device=device)
        return cls(params, vila_args, max_model_len, block_size,
                   rng_seed=seed, device=device, **kw)

    # ------------------------------------------------------------------
    def _encode_prompt_images(self, pixel_values: List) -> torch.Tensor:
        """Host pixel values, a list of [n_i, 3, S, S] -> flat embeds
        [sum(n_i) * tokens_per_image, E]."""
        images = np.concatenate([np.asarray(p, np.float32) for p in pixel_values])
        images = to_device(torch.from_numpy(images), self.device)
        return vila.encode_images(self.vila_params, images, self.vila_args)

    def execute_prefill(
        self,
        metadata: List[SequenceGroupMetadata],
        cache_engine,
    ) -> List[Tuple[int, int]]:
        if any(md.chunk is not None and md.chunk[0] > 0 for md in metadata):
            # prefix-continuation chunk: alone in its step
            assert len(metadata) == 1
            if _pixels(metadata[0]) is not None:
                return self._execute_prefill_chunk_vlm(metadata[0], cache_engine)
            return super().execute_prefill(metadata, cache_engine)

        pixel_list = [_pixels(md) for md in metadata if _pixels(md) is not None]
        if not pixel_list:  # a text-only batch: the dense runner's step
            return super().execute_prefill(metadata, cache_engine)
        embeds = self._encode_prompt_images(pixel_list)
        n_img = sum(len(p) for p in pixel_list)

        prompts: List[List[int]] = []
        tables: List[List[int]] = []
        seq_order: List[int] = []
        sp_list = []
        completes: List[bool] = []  # this step finishes the prompt
        chunked = False
        for md in metadata:
            for seq_id, data in md.seq_data.items():
                ids = data.get_token_ids()
                if md.chunk is not None:  # first chunk of a long prompt
                    ids = ids[md.chunk[0] : md.chunk[1]]
                    chunked = True
                    # its continuation chunks reuse these embeddings (a
                    # chunked first chunk runs alone: they are its own)
                    self._chunk_embeds[seq_id] = embeds
                completes.append(md.chunk is None or md.chunk[1] >= data.get_len())
                prompts.append(ids)
                tables.append(md.block_tables[seq_id])
                seq_order.append(seq_id)
                sp_list.append(md.sampling_params)

        total = sum(len(p) for p in prompts)
        T = bucket(total, 16, self.max_num_batched_tokens * 2)
        B = bucket(len(seq_order), 1, self.max_num_seqs)
        tok, pos, sg, pg, sl, ii, li, _ = native.pack_prefill(
            prompts, tables, self.block_size, T, B, image_token=IMAGE_TOKEN_INDEX,
        )
        tpi = self.vila_args.tokens_per_image
        n_img_tok = sum(p.count(IMAGE_TOKEN_INDEX) for p in prompts)
        if chunked:  # an image's marker run may extend past the chunk
            assert n_img_tok <= n_img * tpi
        else:
            assert n_img_tok == n_img * tpi, (
                f"image token count {n_img_tok} != {n_img} images x {tpi}"
            )
        dev = self._dev
        logits, cache_engine.cache = vila.vlm_prefill(
            self.params, cache_engine.cache, dev(tok), embeds, dev(ii),
            *map(dev, (pos, sg, pg, sl, li)), self.model_args,
        )
        toks = self._sample(logits, sp_list, B)
        self.last_extra_samples = {}
        for i, (sid, sp) in enumerate(zip(seq_order, sp_list)):
            if sp.best_of > 1 and completes[i]:
                self.last_extra_samples[sid] = self._extra_samples(logits[i], sp)
        out = toks.cpu().numpy()
        return [(sid, int(out[i])) for i, sid in enumerate(seq_order)]

    # ------------------------------------------------------------------
    def _execute_prefill_chunk_vlm(
        self, md: SequenceGroupMetadata, cache_engine
    ) -> List[Tuple[int, int]]:
        """Continuation chunk of an image-spliced prompt: its marker
        positions take the prompt's (cached) flat image embeddings at their
        global rows."""
        (seq_id, data), = md.seq_data.items()
        start, end = md.chunk
        full_ids = data.get_token_ids()
        ids = full_ids[start:end]
        table = md.block_tables[seq_id]

        embeds = self._chunk_embeds.get(seq_id)
        if embeds is None:  # e.g. recompute-preempted, or a prefix skip: re-encode
            embeds = self._encode_prompt_images([_pixels(md)])
            self._chunk_embeds[seq_id] = embeds
        img_before = sum(1 for t in full_ids[:start] if t == IMAGE_TOKEN_INDEX)

        T = bucket(len(ids), 16, self.max_num_batched_tokens * 2)
        tok, pos, sg, pg, sl, ii, li, _ = native.pack_prefill(
            [ids], [table], self.block_size, T, 1, starts=[start],
            image_token=IMAGE_TOKEN_INDEX,
        )
        # this chunk's marker rows shifted to their global embed rows
        ii = np.where(tok == IMAGE_TOKEN_INDEX, ii + img_before, 0).astype(np.int32)
        bt = np.zeros((1, self.max_pages_per_seq), np.int32)
        bt[0, : len(table)] = table
        dev = self._dev
        logits, cache_engine.cache = vila.vlm_prefill_chunk(
            self.params, cache_engine.cache, dev(tok), embeds, dev(ii),
            *map(dev, (pos, sg, pg, sl, li)), dev(bt), start, self.model_args,
        )
        sp = md.sampling_params
        toks = self._sample(logits, [sp], 1)
        self.last_extra_samples = {}
        if end == len(full_ids):
            if sp.best_of > 1:  # final chunk of an n>1 prompt: the extras
                self.last_extra_samples[seq_id] = self._extra_samples(logits[0], sp)
            self._chunk_embeds.pop(seq_id, None)  # final chunk: release
        return [(seq_id, int(toks.cpu().numpy()[0]))]
