"""Seeded random weights at full width, made directly on the device.

Released checkpoints are not needed to run or time the model: this builds
every parameter of `models/videollama2.param_shapes(cfg)` from one seeded
torch.Generator, with the JAX package's init scales (normal(0, 0.02)
kernels and embeddings, ones for norm scales and BEATs's gate constants,
zeros for biases, He-normal connector convs, 1/sqrt(fan_in) for the
connector's MLPs (the readout, and the fc* of the linear and mlp{N}x_gelu
projectors) and the audio projector). Random values, unlike constant
fills, give every attention row a different softmax, so a kernel bug shows
up in the output. The quantized variants (int8 or folded int4 LLM layers,
an int8 head and tower) quantize that same tree on the device with
ops/quant, one layer at a time. The bf16 tree is also the training
slice's: the stage-1 step trains its connector in bf16 (fp32 gradient
sums and Adam moments beside it, as the JAX step trains a bf16 tree) and
leaves the rest frozen.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..constants import IGNORE_INDEX, VIDEO_TOKEN_INDEX
from ..models import connector
from ..models import llm as llm_lib
from ..models import videollama2 as vl2
from ..models import vit
from ..multimodal.splice import plan_batch
from ..ops import quant
from ..train.data import Batch


def _init(path, shape, dtype, device, generator) -> torch.Tensor:
    name = path[-1]
    if name in ("scale", "grep_a"):
        return torch.ones(shape, dtype=dtype, device=device)
    if name == "bias":
        return torch.zeros(shape, dtype=dtype, device=device)
    std = 0.02
    if path[0] == "connector":
        fan_in = math.prod(shape[:-1])
        mlp = path[1] == "readout" or path[1].startswith("fc")
        std = math.sqrt((1.0 if mlp else 2.0) / fan_in)
    elif path[:2] == ("audio", "projector"):
        std = math.sqrt(1.0 / shape[0])
    w = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return w.mul_(std)


def _build(spec: dict, path, dtype, device, generator) -> dict:
    out = {}
    for k, v in spec.items():
        if isinstance(v, dict):
            out[k] = _build(v, path + (k,), dtype, device, generator)
        else:
            out[k] = _init(path + (k,), v, dtype, device, generator)
    return out


def synthetic_params(cfg, dtype=torch.bfloat16, device="cuda",
                     seed: int = 0, llm_bits: Optional[int] = None,
                     quantize_embed: bool = False,
                     quantize_vision: Optional[bool] = None) -> dict:
    """Full parameter tree for `cfg` on `device` in `dtype`. With llm_bits
    8 or 4 (bench.py's BENCH_BITS), the LLM's projections become int8 or
    folded int4 packs, its head and the tower's linears int8 packs (the
    layout of ops/quant.quantize_llm_params(bits) and
    quantize_vision_params, the JAX package's quantized serving tree),
    quantized from the seeded floating weights. With quantize_embed, the
    embedding becomes an int8 pack with per-row scales (include_embed:
    bench.py quantizes it for BENCH_MODEL=qwen2, whose 152k-row table is
    1.1 GB in bf16). quantize_vision (JAX `synthetic_model_params`'s
    switch) packs the tower's linears; None, the default, packs them
    whenever llm_bits is set (bench.py's serving tree), and False keeps
    them floating under packed LLM layers (the tree of the JAX speculative
    and session benchmarks). The audio-visual model's audio branch stays
    floating, as the JAX package's quantizers leave it. An MoE config
    takes no llm_bits (models/llm.check_supported)."""
    llm_lib.check_supported(cfg.llm, llm_bits)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    params = _build(vl2.param_shapes(cfg), (), dtype, torch.device(device),
                    generator)
    llm = params["llm"]
    if llm_bits is not None:
        quant.quantize_in_place(llm["layers"], quant.LLM_PROJECTIONS,
                                llm_bits)
        quant.quantize_in_place(llm, ("lm_head",), 8)
    if quantize_vision or (quantize_vision is None
                           and llm_bits is not None):
        quant.quantize_in_place(params["vision"]["layers"],
                                quant.VISION_PROJECTIONS, 8)
    if quantize_embed:
        llm["embed"] = quant.quantize_embed(llm["embed"])
    return params


def synthetic_vision_params(vision_cfg, dtype=torch.bfloat16,
                            device="cuda", seed: int = 0) -> dict:
    """The tower's parameter tree alone (models/vit.param_shapes), seeded
    and initialised as in synthetic_params, for runs of the tower without
    the LLM."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return _build(vit.param_shapes(vision_cfg), ("vision",), dtype,
                  torch.device(device), generator)


def synthetic_connector_params(connector_cfg, dtype=torch.float32,
                               device="cpu", seed: int = 0) -> dict:
    """The connector's parameter tree alone (models/connector.param_shapes),
    seeded and initialised as in synthetic_params (the projector of a LoRA
    directory saved without its non-LoRA trainables)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return _build(connector.param_shapes(connector_cfg), ("connector",),
                  dtype, torch.device(device), generator)


def synthetic_audio_params(cfg, dtype=torch.bfloat16, device="cuda",
                           seed: int = 0) -> dict:
    """The audio branch alone (BEATs and its projector), seeded and
    initialised as in synthetic_params, to add to a tree built without it
    (an audio-visual model over a video model's weights)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    shapes = vl2.param_shapes(cfg)["audio"]
    return _build(shapes, ("audio",), dtype, torch.device(device), generator)


def synthetic_train_batch(cfg, rng: np.random.Generator, n: int,
                          seq_len: int, min_valid: int) -> Batch:
    """A training Batch of n videos of random uint8 RGB frames: prompts
    [1, VIDEO_TOKEN_INDEX] + random text whose lengths spread the spliced
    valid_len evenly over [min_valid, seq_len] (rows in a random order),
    labels IGNORE_INDEX on the first two positions and the text
    supervised."""
    tpv, H = cfg.tokens_per_video, cfg.vision.image_size
    ids, labels = [], []
    for v in rng.permutation(np.linspace(min_valid, seq_len, n).round()
                             .astype(int)):
        text = [int(x) for x in rng.integers(10, cfg.llm.vocab_size,
                                             v - 1 - tpv)]
        ids.append([1, VIDEO_TOKEN_INDEX] + text)
        labels.append([IGNORE_INDEX, IGNORE_INDEX] + text)
    plan = plan_batch(ids, tpv, seq_len, batch_labels=labels)
    frames = rng.integers(0, 256, (n, cfg.num_frames, H, H, 3),
                          dtype=np.uint8)
    return Batch(frames, plan.text_ids, plan.is_visual, plan.vis_index,
                 plan.positions, plan.valid_len, plan.labels)
