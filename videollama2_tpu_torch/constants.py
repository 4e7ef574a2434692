"""Token-index constants of the PyTorch port.

The port's own copy of the JAX package's `constants.py` (itself byte-equal
to the reference videollama2/constants.py), so prompts, labels and datasets
mean the same in both packages; tests/test_torch_config.py holds the two
equal.
"""

IGNORE_INDEX = -100

IMAGE_TOKEN_INDEX = -200
VIDEO_TOKEN_INDEX = -201
AUDIO_TOKEN_INDEX = -202

MODAL_INDEX_MAP = {
    "<image>": IMAGE_TOKEN_INDEX,
    "<video>": VIDEO_TOKEN_INDEX,
    "<audio>": AUDIO_TOKEN_INDEX,
}
