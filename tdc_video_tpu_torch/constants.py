"""Model-wide constants (copy of tdc_video_tpu/constants.py)."""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"

# End-of-text ids used to locate the text span when budgeting visual tokens.
QWEN_PAD_ID = 151643
LLAMA_PAD_ID = 128002

# Audio framing: BEATs emits ~50 tokens per second of 16 kHz audio.
AUDIO_SAMPLE_RATE = 16000
AUDIO_TOKENS_PER_SECOND = 50
AUDIO_WINDOW_SECONDS = 10
