"""Multimodal assembly, video path (port of
videollama2_tpu/models/videollama2.py): frames -> CLIP or SigLIP tower ->
STC connector -> splice -> LLM prefill (serving) or LLM forward, head and
shifted cross-entropy (training, `forward_train`).

Params tree: {"llm": ..., "vision": ..., "connector": ...}.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..constants import IGNORE_INDEX
from ..core.config import ModelConfig
from ..media import wire
from ..multimodal import splice as splice_lib
from . import connector as connector_lib
from . import llm as llm_lib
from . import vit as vit_lib

VIT_ENCODE_CHUNK = 128  # frames per tower pass (bounds tower activations)


def param_shapes(cfg: ModelConfig, llm_bits: Optional[int] = None,
                 int8_vision: bool = False,
                 int8_embed: bool = False) -> dict:
    """Shapes of the whole tree; llm_bits (8 or 4) / int8_vision /
    int8_embed give the layouts of ops/quant.quantize_llm_params(bits)
    (int8 head included; include_embed) and quantize_vision_params."""
    if cfg.audio is not None:
        raise NotImplementedError("the audio branch is not ported yet")
    return {"llm": llm_lib.param_shapes(cfg.llm, bits=llm_bits,
                                        int8_embed=int8_embed),
            "vision": vit_lib.param_shapes(cfg.vision, int8=int8_vision),
            "connector": connector_lib.param_shapes(cfg.connector)}


def _i420_to_rgb(buf: torch.Tensor) -> torch.Tensor:
    """I420 uint8 [B, T, H*3/2, W] -> float32 RGB [B, T, H, W, 3] in
    [0, 255]: BT.601 full-range inverse with nearest 2x chroma upsampling,
    equal to media/wire.i420_to_rgb."""
    B, T = buf.shape[0], buf.shape[1]
    H = buf.shape[2] * 2 // 3
    W = buf.shape[3]
    f = buf.float()
    y = f[:, :, :H]
    cb = f[:, :, H:H + H // 4].reshape(B, T, H // 2, W // 2) - 128.0
    cr = f[:, :, H + H // 4:].reshape(B, T, H // 2, W // 2) - 128.0
    cb = cb.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    cr = cr.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    r = y + wire.INV_R_CR * cr
    g = y - wire.INV_G_CB * cb - wire.INV_G_CR * cr
    b = y + wire.INV_B_CB * cb
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def encode_frames(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                  broadcast_image: bool = False,
                  w8a8: bool = False) -> torch.Tensor:
    """Frames -> visual tokens [B, tokens_per_video, hidden].

    frames: uint8 RGB [B, T, H, W, 3], uint8 I420 [B, T, H*3/2, W], or
    already normalized floats [B, T, H, W, 3]. uint8 input is normalized
    here and cast to bf16, as in the JAX package. With broadcast_image,
    frames is [B, 1, ...] and the features are broadcast to num_frames.
    w8a8 selects the serving branch of the tower's int8 packs.
    """
    feats = frame_features(params, cfg, frames, broadcast_image, w8a8)
    return temporal_aggregator(params, cfg, feats)


def frame_features(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                   broadcast_image: bool = False,
                   w8a8: bool = False) -> torch.Tensor:
    """The tower half of encode_frames: frames -> per-frame features
    [B, T (or num_frames), patches, D_vision]."""
    B, T = frames.shape[0], frames.shape[1]
    raw255 = None
    if frames.dim() == 4:
        if frames.dtype != torch.uint8:
            raise ValueError("planar I420 frames must be uint8")
        raw255 = _i420_to_rgb(frames)
    elif frames.dtype == torch.uint8:
        raw255 = frames.float()
    if raw255 is not None:
        mean = torch.tensor(cfg.vision.image_mean, dtype=torch.float32,
                            device=frames.device)
        std = torch.tensor(cfg.vision.image_std, dtype=torch.float32,
                           device=frames.device)
        frames = ((raw255 / 255.0 - mean) / std).to(torch.bfloat16)
    flat = frames.reshape((B * T,) + tuple(frames.shape[2:]))
    feats = _tower_features(params, cfg, flat, w8a8)
    feats = feats.reshape(B, T, feats.shape[1], feats.shape[2])
    if broadcast_image:
        feats = feats.expand((B, cfg.num_frames) + tuple(feats.shape[2:]))
    return feats


def _tower_features(params: dict, cfg: ModelConfig, flat: torch.Tensor,
                    w8a8: bool) -> torch.Tensor:
    """Tower over [N, H, W, 3] frames in chunks of VIT_ENCODE_CHUNK (halved
    until it divides N), so only one chunk's activations are live."""
    N = flat.shape[0]
    chunk = VIT_ENCODE_CHUNK
    while chunk > 1 and N % chunk:
        chunk //= 2
    if N <= chunk:
        return vit_lib.features(params["vision"], cfg.vision, flat, w8a8)
    return torch.cat([vit_lib.features(params["vision"], cfg.vision,
                                       flat[i:i + chunk], w8a8)
                      for i in range(0, N, chunk)])


def temporal_aggregator(params: dict, cfg: ModelConfig,
                        frame_feats: torch.Tensor) -> torch.Tensor:
    """[B, T, N, D_vision] -> [B, tokens, D_llm] through the connector;
    the linear and mlp* projectors take the mean over T first."""
    pt = cfg.connector.projector_type
    if pt in ("mlp2x_gelu", "linear") or pt.startswith("mlp"):
        frame_feats = frame_feats.mean(dim=1)
    return connector_lib.apply(params["connector"], cfg.connector,
                               frame_feats)


def prefill_multimodal(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                       text_ids: torch.Tensor, is_visual: torch.Tensor,
                       vis_index: torch.Tensor, positions: torch.Tensor,
                       valid_len: torch.Tensor, cache: llm_lib.KVCache,
                       broadcast_image: bool = False, w8a8: bool = False
                       ) -> Tuple[torch.Tensor, llm_lib.KVCache]:
    """Inference prefill with the visual splice -> (last_hidden, cache)."""
    vis_tokens = encode_frames(params, cfg, frames,
                               broadcast_image=broadcast_image, w8a8=w8a8)
    text_emb = llm_lib.embed_tokens(params["llm"], text_ids,
                                    dtype=vis_tokens.dtype)
    embeds = splice_lib.compose_embeds(text_emb, vis_tokens, is_visual,
                                       vis_index)
    return llm_lib.prefill(params["llm"], cfg.llm, embeds, positions,
                           valid_len, cache, w8a8=w8a8)


def forward_train(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                  text_ids: torch.Tensor, is_visual: torch.Tensor,
                  vis_index: torch.Tensor, positions: torch.Tensor,
                  valid_len: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, dict]:
    """Training forward (JAX `forward_train`): (mean masked CE loss,
    metrics {"loss", "num_tokens", "accuracy"}).

    The tower runs under torch.no_grad (frozen, as JAX's stop_gradient on
    its features); the connector, splice, LLM (each layer checkpointed, as
    JAX's remat=True) and fp32 head carry gradients. Labels use
    IGNORE_INDEX for unsupervised positions; the loss is next-token CE over
    the supervised ones (HF causal-LM shift)."""
    with torch.no_grad():
        feats = frame_features(params, cfg, frames)
    vis_tokens = temporal_aggregator(params, cfg, feats)
    text_emb = llm_lib.embed_tokens(params["llm"], text_ids,
                                    dtype=vis_tokens.dtype)
    embeds = splice_lib.compose_embeds(text_emb, vis_tokens, is_visual,
                                       vis_index)
    hidden = llm_lib.forward(params["llm"], cfg.llm, embeds, positions,
                             valid_len, remat=True)
    logits = llm_lib.lm_logits(params["llm"], cfg.llm, hidden)  # fp32
    shift_logits = logits[:, :-1]
    shift_labels = labels[:, 1:].long()
    mask = shift_labels != IGNORE_INDEX
    safe_labels = torch.where(mask, shift_labels, 0)
    logp = F.log_softmax(shift_logits, dim=-1)
    token_ll = torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    num_tokens = mask.sum()
    denom = torch.clamp(num_tokens, min=1)
    loss = -torch.where(mask, token_ll, 0.0).sum() / denom
    correct = ((shift_logits.argmax(-1) == safe_labels) & mask).sum()
    metrics = {"loss": loss.detach(), "num_tokens": num_tokens,
               "accuracy": correct / denom}
    return loss, metrics
