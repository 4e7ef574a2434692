"""The CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked `cuda` and skipped where there is no GPU (the kernels have no CPU
mode). This file imports no jax, so it runs where only PyTorch and the CUDA
toolkit are installed; the repository's tests/conftest.py imports jax, so
run it on the GPU host with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are bf16; the reference is the plain version in fp32 on the same
values. Tolerance 2e-2 absolute: the kernels round P to bf16 for the PV
product and round the output to bf16 (outputs here have |o| < ~3).
"""

import pytest
import torch

from videollama2_tpu_torch.ops import encoder_attention as k1
from videollama2_tpu_torch.ops import flash_attention as k2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16_qkv(gen, B, S, Hq, Hkv, D, device):
    def r(*shape):
        return torch.randn(shape, generator=gen, device=device).bfloat16()
    return r(B, S, Hq, D), r(B, S, Hkv, D), r(B, S, Hkv, D)


@pytest.mark.cuda
@pytest.mark.parametrize("S,D", [(577, 64), (729, 72), (130, 64)])
def test_encoder_attention_cuda_matches_plain(cuda_device, S, D):
    gen = torch.Generator(device=cuda_device).manual_seed(S)
    q, k, v = _bf16_qkv(gen, 3, S, 4, 4, D, cuda_device)
    valid = torch.tensor([S, S - 100, 1], dtype=torch.int32,
                         device=cuda_device)
    got = k1.encoder_attention(q, k, v, valid).float()
    ref = k1.encoder_attention_plain(q.float(), k.float(), v.float(), valid)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_cuda_matches_plain(cuda_device, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = _bf16_qkv(gen, 3, 300, 8, 2, 128, cuda_device)
    valid = torch.tensor([300, 157, 0], dtype=torch.int32, device=cuda_device)
    got = k2.flash_attention(q, k, v, valid, causal=causal).float()
    ref = k2.flash_attention_plain(q.float(), k.float(), v.float(), valid,
                                   causal=causal)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-2)
