"""Image loading + preprocessing for the VLM pipeline (a copy of
qserve_tpu/utils/image_processing.py).

PIL is imported inside the functions that need it, never at module level,
so the port imports without it. Resize with PIL bicubic, normalize with the
tower's mean/std, output [N, 3, H, W] float32 numpy (the vision tower's
`pixel_values`); the engine skips this when the caller passes them.
"""

from __future__ import annotations

import base64
import io
from typing import List, Optional, Sequence, Tuple

import numpy as np

# OpenAI CLIP defaults; SigLIP uses 0.5/0.5
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


def load_image(source) -> "PIL.Image.Image":
    """Path / bytes / base64 string / PIL image -> RGB PIL image."""
    from PIL import Image

    if hasattr(source, "convert"):
        return source.convert("RGB")
    if isinstance(source, bytes):
        return Image.open(io.BytesIO(source)).convert("RGB")
    if isinstance(source, str):
        if source.startswith("data:") or len(source) > 4096:
            payload = source.split(",", 1)[-1]
            return Image.open(io.BytesIO(base64.b64decode(payload))).convert("RGB")
        return Image.open(source).convert("RGB")
    raise TypeError(f"unsupported image source {type(source)}")


def load_images(sources: Sequence) -> List:
    return [load_image(s) for s in sources]


def expand2square(img, background: Tuple[int, int, int]):
    """Pad to square with the given background color (reference
    llava_image_processing.py expand2square)."""
    from PIL import Image

    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    canvas = Image.new("RGB", (side, side), background)
    canvas.paste(img, ((side - w) // 2, (side - h) // 2))
    return canvas


def preprocess_images(
    images: Sequence,
    image_size: int,
    mean: Tuple[float, float, float] = CLIP_MEAN,
    std: Tuple[float, float, float] = CLIP_STD,
    pad_to_square: bool = True,
) -> np.ndarray:
    """PIL images -> [N, 3, S, S] float32 normalized (CLIP-processor
    semantics: 'pad' aspect mode + resize + per-channel normalize)."""
    from PIL import Image

    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    bg = tuple(int(round(255 * m)) for m in mean)
    out = np.empty((len(images), 3, image_size, image_size), np.float32)
    for i, img in enumerate(images):
        img = load_image(img)
        if pad_to_square:
            img = expand2square(img, bg)
        img = img.resize((image_size, image_size), Image.BICUBIC)
        x = np.asarray(img, np.float32) / 255.0  # [S, S, 3]
        x = (x - mean_a) / std_a
        out[i] = x.transpose(2, 0, 1)
    return out
