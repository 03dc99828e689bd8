"""VILA/LLaVA-style VLM: vision tower + mm_projector + quantized Llama LLM
(qserve_tpu/models/vila.py).

Prompts are expanded on the host when a request is added (each image tag
becomes tokens_per_image placeholder ids, IMAGE_TOKEN_INDEX), so every
page and context-length computation of the scheduler is exact, and the
device step only selects token embedding or image embedding per position
before the LLM's own prefill (`llama.prefill_from_hidden`,
`llama.prefill_chunk_from_hidden`): the LLM runs the port's kernels.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import torch

from qserve_tpu_torch.kernels import kv_cache as kvc
from qserve_tpu_torch.models import clip, llama, mm_projector
from qserve_tpu_torch.utils.constants import IMAGE_TOKEN_INDEX
from qserve_tpu_torch.utils.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class VilaArgs:
    llm: llama.LlamaArgs
    vision: clip.VisionArgs
    projector: mm_projector.ProjectorArgs

    @property
    def tokens_per_image(self) -> int:
        return self.projector.tokens_per_image


class VilaParams(NamedTuple):
    vision: clip.VisionParams
    projector: mm_projector.ProjectorParams
    llm: llama.LlamaParams


def random_params(seed: int, args: VilaArgs, device="cuda", scale: float = 0.02) -> VilaParams:
    """Tower and projector from one seeded torch.Generator; the LLM is
    `llama.random_quantized_params(seed, ...)` (quantized layer by layer,
    never the whole float model), so it equals a text engine's of the same
    seed."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return VilaParams(
        vision=clip.random_params(gen, args.vision, device, scale),
        projector=mm_projector.random_params(gen, args.projector, device, scale),
        llm=llama.random_quantized_params(seed, args.llm, device, scale),
    )


# ---------------------------------------------------------------------------
# Host-side prompt expansion
# ---------------------------------------------------------------------------


def expand_multimodal_prompt(
    token_ids: Sequence[int], tokens_per_image: int
) -> List[int]:
    """Each IMAGE_TOKEN_INDEX becomes tokens_per_image placeholder ids."""
    out: List[int] = []
    for t in token_ids:
        if t == IMAGE_TOKEN_INDEX:
            out.extend([IMAGE_TOKEN_INDEX] * tokens_per_image)
        else:
            out.append(int(t))
    return out


def tokenizer_image_token(
    prompt: str, tokenizer, image_token: str = "<image>"
) -> List[int]:
    """Tokenize a prompt with <image> tags -> ids with IMAGE_TOKEN_INDEX
    markers; the BOS that encode() prepends to later chunks is dropped."""
    chunks = [tokenizer.encode(c) for c in prompt.split(image_token)]
    ids: List[int] = list(chunks[0])
    bos = getattr(tokenizer, "bos_token_id", None)
    for c in chunks[1:]:
        ids.append(IMAGE_TOKEN_INDEX)
        ids.extend(c[1:] if (bos is not None and c and c[0] == bos) else c)
    return ids


# ---------------------------------------------------------------------------
# Device steps
# ---------------------------------------------------------------------------


def encode_images(
    params: VilaParams, images: torch.Tensor, args: VilaArgs
) -> torch.Tensor:
    """[n, C, H, W] -> flat image embeddings [n * tokens_per_image, E_llm]
    (vision tower features -> mm_projector)."""
    feats = clip.forward_features(params.vision, images, args.vision)
    emb = mm_projector.apply_projector(params.projector, feats, args.projector)
    return emb.reshape(-1, args.llm.hidden_size)


def splice(embed: torch.Tensor, token_ids: torch.Tensor, image_embeds: torch.Tensor,
           image_idx: torch.Tensor) -> torch.Tensor:
    """bf16 [T, E]: the token embedding of each position, or at a marker
    (IMAGE_TOKEN_INDEX) the image embedding row image_idx names."""
    is_img = token_ids == IMAGE_TOKEN_INDEX
    safe_tok = torch.where(is_img, 0, token_ids).long()
    tok_embed = embed[safe_tok].to(torch.bfloat16)
    img_embed = image_embeds[image_idx.long()].to(torch.bfloat16)
    return torch.where(is_img[:, None], img_embed, tok_embed)


def vlm_prefill(
    llm_params: llama.LlamaParams,
    kv: kvc.KVCache,
    token_ids: torch.Tensor,  # [T] int32 (IMAGE_TOKEN_INDEX at image positions)
    image_embeds: torch.Tensor,  # [n_img_tokens, E] flat image embeddings
    image_idx: torch.Tensor,  # [T] int32 index into image_embeds (0 if not image)
    positions: torch.Tensor,
    segment_ids: torch.Tensor,
    page_ids: torch.Tensor,
    slots: torch.Tensor,
    last_token_idx: torch.Tensor,
    args: llama.LlamaArgs,
) -> Tuple[torch.Tensor, kvc.KVCache]:
    """Packed prefill with image embeddings spliced at marker positions."""
    h = splice(llm_params.embed, token_ids, image_embeds, image_idx)
    return llama.prefill_from_hidden(
        llm_params, kv, h, positions, segment_ids, page_ids, slots,
        last_token_idx, args,
    )


def vlm_prefill_chunk(
    llm_params: llama.LlamaParams,
    kv: kvc.KVCache,
    token_ids: torch.Tensor,  # [T] int32 chunk tokens (IMAGE_TOKEN_INDEX markers)
    image_embeds: torch.Tensor,  # [n_img_tokens, E] the prompt's flat image embeddings
    image_idx: torch.Tensor,  # [T] int32 global row into image_embeds (0 if not image)
    positions: torch.Tensor,
    segment_ids: torch.Tensor,
    page_ids: torch.Tensor,
    slots: torch.Tensor,
    last_token_idx: torch.Tensor,
    block_tables: torch.Tensor,  # [1, maxP] the chunk's cached prefix
    prefix_len: int,  # host int
    args: llama.LlamaArgs,
) -> Tuple[torch.Tensor, kvc.KVCache]:
    """One chunk of an image-spliced prompt whose prefix KV is cached; an
    image's marker run may straddle the chunk boundary (image_idx carries
    the global flat-embed rows)."""
    h = splice(llm_params.embed, token_ids, image_embeds, image_idx)
    return llama.prefill_chunk_from_hidden(
        llm_params, kv, h, positions, segment_ids, page_ids, slots,
        last_token_idx, block_tables, prefix_len, args,
    )
