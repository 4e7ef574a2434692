"""videollama2_tpu_torch — PyTorch/CUDA port of videollama2_tpu.

Runs the VideoLLaMA2 video-QA path and the stage-1 (projector-only)
training path on an NVIDIA H100 (sm_90a): plain PyTorch for tensor code,
hand-written CUDA kernels (csrc/) where the JAX package has Pallas kernels.
The JAX package stays the reference; this package imports nothing of it
and keeps its own copies of the host modules it needs (core.config,
constants, media.wire). Entry points: inference.engine.Engine and
train.trainer.Trainer.
"""

__version__ = "0.1.0"
