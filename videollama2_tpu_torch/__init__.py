"""videollama2_tpu_torch — PyTorch/CUDA port of videollama2_tpu.

Runs the VideoLLaMA2 video-QA path and the stage-1 (projector-only)
training path on an NVIDIA H100 (sm_90a): plain PyTorch for tensor code,
hand-written CUDA kernels (csrc/) where the JAX package has Pallas kernels.
The JAX package stays the reference; this package imports nothing of it
and keeps its own copies of the host modules it needs (core.config,
constants, media.wire, multimodal.tokenizer, inference.speculative). Entry points: the public API
`model_init(model_path, tokenizer=...) -> (model, processor, tokenizer)`,
`mm_infer` and `mm_infer_batch` (inference.api, on a released checkpoint
directory through checkpoint.convert_hf), the prefix-cached chat entries
`ChatSession` and `mm_infer_session` (inference.api),
inference.engine.Engine (with speculative decoding and
`generate_continue`) and train.trainer.Trainer.
"""

__version__ = "0.1.0"


def model_init(*args, **kwargs):
    from .inference.api import model_init as _mi
    return _mi(*args, **kwargs)


def mm_infer(*args, **kwargs):
    from .inference.api import mm_infer as _mm
    return _mm(*args, **kwargs)
