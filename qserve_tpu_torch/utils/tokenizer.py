"""Tokenizer loading (qserve_tpu/utils/tokenizer.py).

`transformers` is imported only when a tokenizer is loaded, so the port
imports without it. Tokenizers load from local directories only: nothing
is downloaded.
"""

from __future__ import annotations

import os

from qserve_tpu_torch.logger import init_logger

logger = init_logger(__name__)


def get_tokenizer(
    tokenizer_name: str,
    tokenizer_mode: str = "auto",
    trust_remote_code: bool = True,
    **kwargs,
):
    if not os.path.isdir(tokenizer_name):
        raise FileNotFoundError(f"no tokenizer directory {tokenizer_name!r}")
    from transformers import AutoTokenizer

    kwargs["local_files_only"] = True
    if tokenizer_mode == "slow":
        kwargs["use_fast"] = False
    try:
        tok = AutoTokenizer.from_pretrained(
            tokenizer_name, trust_remote_code=trust_remote_code, **kwargs
        )
    except Exception as e:  # the JAX package's retry, slow tokenizer
        logger.warning("Failed to load fast tokenizer (%s); retrying slow", e)
        tok = AutoTokenizer.from_pretrained(
            tokenizer_name, use_fast=False, trust_remote_code=trust_remote_code,
            local_files_only=True,
        )
    return tok


def detokenize_incrementally(tokenizer, all_token_ids, prev_text_len: int):
    """Cheap incremental detokenization: decode all, return the new suffix."""
    text = tokenizer.decode(all_token_ids, skip_special_tokens=True)
    return text, text[prev_text_len:]
