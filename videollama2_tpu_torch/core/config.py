"""Typed configuration tree of the PyTorch port.

The port's own copy of the model configuration (the JAX package's
`core/config.py`): the frozen dataclasses of the vision tower, the
connector, the LLM and the audio encoder, the derived token counts, the
released-checkpoint presets and the tiny test configs. The port imports
nothing of the JAX package, so it keeps this copy; tests/test_torch_config.py
holds it equal to the original field by field. Field names follow the HF
checkpoint config.json keys.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class VisionConfig:
    """CLIP ViT-L/14-336 or SigLIP-SO400M/14-384 vision tower.

    Parity: reference videollama2/model/encoder.py:12-164 (thin wrappers over
    HF CLIPVisionModel / SiglipVisionModel; frozen, features taken from hidden
    state `select_layer`, CLS dropped for CLIP 'patch' mode).
    """

    variant: str = "clip"  # "clip" | "siglip"
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"  # clip: quick_gelu; siglip: gelu_pytorch_tanh
    select_layer: int = -2
    select_feature: str = "patch"
    # Preprocessing stats (HF image processor values)
    image_mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)

    @property
    def use_cls_token(self) -> bool:
        return self.variant == "clip"

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.patches_per_side ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_cls_token else 0)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class ConnectorConfig:
    """Spatial-temporal connector (projector) config.

    Parity: reference videollama2/model/projector.py:95-250. `projector_type`
    values keep the reference's registry names.
    """

    projector_type: str = "stc_connector_v35"
    mm_hidden_size: int = 1024   # vision tower hidden size
    hidden_size: int = 4096      # LLM hidden size
    depth: int = 4               # RegNet stage depth (0 => identity stages)
    mlp_depth: int = 2
    downsample: Tuple[int, int, int] = (2, 2, 2)  # (t, h, w)

    @property
    def conv_padding(self) -> int:
        # stc_connector uses padding=1 (projector.py:170); v35 uses 0 (:235)
        return 0 if self.projector_type == "stc_connector_v35" else 1


@dataclass(frozen=True)
class LLMConfig:
    """Unified dense/MoE decoder config covering Mistral / Qwen2 / Llama / Mixtral.

    The four reference wrapper files (videollama2/model/videollama2_{mistral,
    qwen2,llama,mixtral}.py) differ only in backbone family; on TPU one
    functional decoder covers all of them, switched by fields here.
    """

    model_type: str = "mistral"  # "mistral" | "qwen2" | "llama" | "mixtral"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-5
    qkv_bias: bool = False          # True for Qwen2
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 32768
    sliding_window: Optional[int] = None
    # MoE (Mixtral); num_experts == 0 => dense
    num_experts: int = 0
    num_experts_per_tok: int = 2
    router_aux_loss_coef: float = 0.02
    # MoE dispatch: "auto" = capacity-based top-k gather for >=64 tokens
    # (prefill/training), exact every-expert compute below; "dense" = always
    # exact (HF MixtralSparseMoeBlock semantics); "gather" = always gather
    moe_dispatch: str = "auto"
    moe_capacity_factor: float = 2.0
    # Special token ids (from HF generation/tokenizer config)
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class AudioConfig:
    """BEATs audio encoder config (VideoLLaMA2.1-AV).

    The audio branch lives on the reference's `audio_visual` branch
    (README.md:60,130-132); rebuilt here from the BEATs iter3+ architecture.
    """

    fbank_bins: int = 128
    embed_dim: int = 512
    encoder_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_pos: int = 128
    conv_pos_groups: int = 16
    deep_norm: bool = True
    layer_norm_eps: float = 1e-5
    # static audio budget: fbank frames are padded/trimmed to this many
    # 10 ms frames before the 16x16 patch conv (static shapes under jit)
    max_frames: int = 1024

    @property
    def tokens(self) -> int:
        """BEATs tokens for max_frames: (T/16) patches x (128/16) freq bins."""
        return (self.max_frames // 16) * (self.fbank_bins // 16)


@dataclass(frozen=True)
class ModelConfig:
    """Top-level multimodal model config.

    model_type mirrors the reference registry names
    (videollama2/model/__init__.py:31-45).
    """

    model_type: str = "videollama2_mistral"
    llm: LLMConfig = field(default_factory=LLMConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)
    connector: ConnectorConfig = field(default_factory=ConnectorConfig)
    audio: Optional[AudioConfig] = None
    num_frames: int = 8

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def tokens_per_video(self) -> int:
        """Number of visual tokens the connector emits for `num_frames` frames."""
        return connector_output_tokens(self.connector, self.num_frames,
                                       self.vision.patches_per_side)

    @property
    def tokens_per_image(self) -> int:
        # images are expanded to num_frames frames before encoding
        # (videollama2_arch.py:119-120), so same count as a video
        return self.tokens_per_video

    @property
    def tokens_per_audio(self) -> int:
        assert self.audio is not None, "model has no audio branch"
        return self.audio.tokens


def conv3d_out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def connector_output_tokens(conn: ConnectorConfig, t: int, hw: int) -> int:
    """Visual token count after the connector, matching torch conv semantics."""
    pt = conn.projector_type
    if pt in ("linear",) or pt.startswith("mlp"):
        return hw * hw  # mean-pooled over time (videollama2_arch.py:144-146)
    dt, dh, dw = conn.downsample
    if pt in ("stc_connector", "stc_connector_v35", "spatial_conv"):
        p = conn.conv_padding if pt != "spatial_conv" else 1
        if pt == "spatial_conv":
            p = 1
        nt = conv3d_out(t, dt, dt, p)
        nh = conv3d_out(hw, dh, dh, p)
        nw = conv3d_out(hw, dw, dw, p)
        return nt * nh * nw
    if pt in ("stp_connector", "spatial_pool"):
        # AvgPool3d: floor((size - k)/s) + 1, no padding (projector.py:222)
        nt = (t - dt) // dt + 1
        nh = (hw - dh) // dh + 1
        nw = (hw - dw) // dw + 1
        return nt * nh * nw
    if pt == "identity":
        return t * hw * hw
    raise ValueError(f"Unknown projector type: {pt}")


# ---------------------------------------------------------------------------
# Presets (shapes pinned from released checkpoint configs)
# ---------------------------------------------------------------------------

def clip_vit_l_336() -> VisionConfig:
    return VisionConfig()


def siglip_so400m_384() -> VisionConfig:
    return VisionConfig(
        variant="siglip", image_size=384, patch_size=14, hidden_size=1152,
        intermediate_size=4304, num_layers=27, num_heads=16,
        layer_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh",
        image_mean=(0.5, 0.5, 0.5), image_std=(0.5, 0.5, 0.5),
    )


def mistral_7b() -> LLMConfig:
    return LLMConfig(model_type="mistral")


def qwen2_7b() -> LLMConfig:
    return LLMConfig(
        model_type="qwen2", vocab_size=152064, hidden_size=3584,
        intermediate_size=18944, num_layers=28, num_heads=28, num_kv_heads=4,
        head_dim=128, rope_theta=1e6, rms_norm_eps=1e-6, qkv_bias=True,
        bos_token_id=151643, eos_token_id=151645, pad_token_id=151643,
    )


def qwen2_72b() -> LLMConfig:
    return LLMConfig(
        model_type="qwen2", vocab_size=152064, hidden_size=8192,
        intermediate_size=29568, num_layers=80, num_heads=64, num_kv_heads=8,
        head_dim=128, rope_theta=1e6, rms_norm_eps=1e-6, qkv_bias=True,
        bos_token_id=151643, eos_token_id=151645, pad_token_id=151643,
    )


def mixtral_8x7b() -> LLMConfig:
    return LLMConfig(
        model_type="mixtral", num_experts=8, num_experts_per_tok=2,
        rope_theta=1e6,
    )


def llama2_7b() -> LLMConfig:
    return LLMConfig(
        model_type="llama", vocab_size=32000, intermediate_size=11008,
        num_kv_heads=32, rope_theta=1e4, max_position_embeddings=4096,
    )


_PRESETS = {
    "videollama2_mistral": lambda: ModelConfig(
        model_type="videollama2_mistral", llm=mistral_7b(),
        vision=clip_vit_l_336(),
        connector=ConnectorConfig(projector_type="stc_connector",
                                  mm_hidden_size=1024, hidden_size=4096)),
    "videollama2_qwen2": lambda: ModelConfig(
        model_type="videollama2_qwen2", llm=qwen2_7b(),
        vision=siglip_so400m_384(),
        connector=ConnectorConfig(projector_type="stc_connector_v35",
                                  mm_hidden_size=1152, hidden_size=3584)),
    "videollama2_mixtral": lambda: ModelConfig(
        model_type="videollama2_mixtral", llm=mixtral_8x7b(),
        vision=clip_vit_l_336(),
        connector=ConnectorConfig(projector_type="stc_connector",
                                  mm_hidden_size=1024, hidden_size=4096)),
    "videollama2_llama": lambda: ModelConfig(
        model_type="videollama2_llama", llm=llama2_7b(),
        vision=clip_vit_l_336(),
        connector=ConnectorConfig(projector_type="stc_connector",
                                  mm_hidden_size=1024, hidden_size=4096)),
    # VideoLLaMA2.1-AV (upstream audio_visual branch): SigLIP + Qwen2 + BEATs
    "videollama2_qwen2_av": lambda: ModelConfig(
        model_type="videollama2_qwen2", llm=qwen2_7b(),
        vision=siglip_so400m_384(),
        connector=ConnectorConfig(projector_type="stc_connector_v35",
                                  mm_hidden_size=1152, hidden_size=3584),
        audio=AudioConfig()),
}


def preset(model_type: str) -> ModelConfig:
    return _PRESETS[model_type]()


def tiny_llm(model_type: str = "mistral", vocab_size: int = 512) -> LLMConfig:
    """Small config for unit tests (shape-compatible with HF tiny models)."""
    return LLMConfig(
        model_type=model_type, vocab_size=vocab_size, hidden_size=64,
        intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=16, rope_theta=1e4, qkv_bias=(model_type == "qwen2"),
        num_experts=(4 if model_type == "mixtral" else 0),
    )


def tiny_vision(variant: str = "clip") -> VisionConfig:
    return VisionConfig(
        variant=variant, image_size=56, patch_size=14, hidden_size=32,
        intermediate_size=64, num_layers=3, num_heads=4,
        hidden_act="quick_gelu" if variant == "clip" else "gelu_pytorch_tanh",
        layer_norm_eps=1e-5 if variant == "clip" else 1e-6,
        image_mean=(0.5, 0.5, 0.5) if variant == "siglip" else
                   (0.48145466, 0.4578275, 0.40821073),
        image_std=(0.5, 0.5, 0.5) if variant == "siglip" else
                  (0.26862954, 0.26130258, 0.27577711),
    )


def tiny_model(model_type: str = "videollama2_mistral",
               projector_type: str = "stc_connector_v35") -> ModelConfig:
    llm_type = model_type.split("_", 1)[1]
    llm = tiny_llm(llm_type)
    vis = tiny_vision("clip" if llm_type != "qwen2" else "siglip")
    return ModelConfig(
        model_type=model_type, llm=llm, vision=vis,
        connector=ConnectorConfig(
            projector_type=projector_type, mm_hidden_size=vis.hidden_size,
            hidden_size=llm.hidden_size, depth=2),
        num_frames=4,
    )
