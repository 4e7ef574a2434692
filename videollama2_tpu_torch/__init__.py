"""videollama2_tpu_torch — PyTorch/CUDA port of videollama2_tpu.

Runs the VideoLLaMA2 video-QA path on an NVIDIA H100 (sm_90a): plain
PyTorch for tensor code, hand-written CUDA kernels (csrc/) where the JAX
package has Pallas kernels. The JAX package stays the reference; this
package imports none of jax, reusing only its numpy-only host modules
(core.config, constants, media.wire). Entry point: inference.engine.Engine.
"""

__version__ = "0.1.0"
