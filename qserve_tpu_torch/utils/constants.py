"""Global constants (a copy of qserve_tpu/utils/constants.py)."""

MAX_SEQ_LEN = 8192
LLAMA_MULTIPLE_OF = 256

# VLM (VILA/LLaVA) conventions
IMAGE_TOKEN_INDEX = -200  # placeholder id spliced where '<image>' appears
LLAVA_TOKENS_PER_IMAGE = 196  # vision-tower tokens inserted per image
DEFAULT_IMAGE_TOKEN = "<image>"
