"""Token-index constants of the PyTorch port.

The port's own copy of the JAX package's `constants.py` (itself byte-equal
to the reference videollama2/constants.py), so prompts, labels and datasets
mean the same in both packages; tests/test_torch_config.py holds the two
equal.
"""

IGNORE_INDEX = -100

IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"

VIDEO_TOKEN_INDEX = -201
DEFAULT_VIDEO_TOKEN = "<video>"

AUDIO_TOKEN_INDEX = -202
DEFAULT_AUDIO_TOKEN = "<audio>"

MODAL_INDEX_MAP = {
    "<image>": IMAGE_TOKEN_INDEX,
    "<video>": VIDEO_TOKEN_INDEX,
    "<audio>": AUDIO_TOKEN_INDEX,
}

# serving plane (serve/controller.py, serve/model_worker.py): seconds
CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15
# directory of the serving logs and the web server's conversation log
LOGDIR = "."

# frame sampling (media/sampler.py, media/preprocess.py)
NUM_FRAMES = 8
MAX_FRAMES = 32
NUM_FRAMES_PER_SECOND = 1
