"""HF checkpoint -> param tree (port of
videollama2_tpu/checkpoint/convert_hf.py).

Reads a released VideoLLaMA2 checkpoint directory (config.json plus
`*.safetensors` shards or `pytorch_model*.bin` files) into the JAX
package's param layout: layers stacked on a leading L axis, kernels
[in, out] (the transpose of a torch Linear weight), conv kernels
[*k, I, O]. Leaves are torch tensors in their stored dtype (a released
checkpoint's bf16 stays bf16; numpy has no bf16), so a 7B load never widens
to fp32 on the host. checkpoint/from_jax.params_from_jax then fuses q/k/v
into the port's layout.

Safetensors shards go through this module's own reader (read_safetensors):
each tensor is a view over a copy-on-write mmap of its file, so a shard is
never copied whole; stacking the layers makes the first host copy. The
paths of the JAX loader are (c)/(d), the full checkpoint, and (b), the
pretrain directory (`mm_projector.bin` beside a `model_base`), both with
the audio-visual model's audio branch (BEATs under `model.audio_tower.`
and its projector `model.mm_projector_a.`); (a), the LoRA directory,
raises NotImplementedError until its port.
"""

from __future__ import annotations

import dataclasses
import json
import math
import mmap
import os
import re
import warnings
from typing import Dict, Iterable, Mapping

import torch

from ..core import config as cfglib
from ..core.config import (AudioConfig, ConnectorConfig, LLMConfig,
                           ModelConfig, VisionConfig)

# safetensors dtype names -> torch dtypes
ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
             "F32": torch.float32, "I8": torch.int8, "I32": torch.int32,
             "I64": torch.int64, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file (an 8-byte little-endian header
    length, a JSON header of {name: {dtype, shape, data_offsets}}, then the
    raw little-endian bytes) as a view over a copy-on-write mmap of the
    file, in its stored dtype. A view keeps the mapping alive."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        dtype = ST_DTYPES[info["dtype"]]
        shape = list(info["shape"])
        start, end = info["data_offsets"]
        count = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != count * itemsize:
            raise ValueError(f"{path}: {key} holds {end - start} bytes, "
                             f"{info['dtype']} {shape} needs "
                             f"{count * itemsize}")
        if count == 0:
            out[key] = torch.empty(shape, dtype=dtype)
            continue
        out[key] = torch.frombuffer(buf, dtype=dtype, count=count,
                                    offset=base + start).reshape(shape)
    return out


def _t(sd: Mapping, key: str) -> torch.Tensor:
    return sd[key].T


def _a(sd: Mapping, key: str) -> torch.Tensor:
    return sd[key]


def _stack(items: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.stack(list(items), dim=0)


# ---------------------------------------------------------------------------
# LLM (Mistral / Qwen2 / Llama dense; Mixtral MoE)
# ---------------------------------------------------------------------------

def llm_params_from_state_dict(sd: Mapping, cfg: LLMConfig,
                               prefix: str = "model.") -> dict:
    """Convert an HF *ForCausalLM state_dict to the stacked-layer param tree.

    Key layout: HF MistralForCausalLM / Qwen2ForCausalLM / LlamaForCausalLM
    / MixtralForCausalLM.
    """
    L = cfg.num_layers

    def lkey(l, sub):
        return f"{prefix}layers.{l}.{sub}"

    layers: dict = {
        "attn_norm": {"scale": _stack(
            _a(sd, lkey(l, "input_layernorm.weight")) for l in range(L))},
        "mlp_norm": {"scale": _stack(
            _a(sd, lkey(l, "post_attention_layernorm.weight"))
            for l in range(L))},
        "q": {"kernel": _stack(
            _t(sd, lkey(l, "self_attn.q_proj.weight")) for l in range(L))},
        "k": {"kernel": _stack(
            _t(sd, lkey(l, "self_attn.k_proj.weight")) for l in range(L))},
        "v": {"kernel": _stack(
            _t(sd, lkey(l, "self_attn.v_proj.weight")) for l in range(L))},
        "o": {"kernel": _stack(
            _t(sd, lkey(l, "self_attn.o_proj.weight")) for l in range(L))},
    }
    if cfg.qkv_bias:
        for name in ("q", "k", "v"):
            layers[name]["bias"] = _stack(
                _a(sd, lkey(l, f"self_attn.{name}_proj.bias"))
                for l in range(L))
    if cfg.is_moe:
        E = cfg.num_experts
        layers["router"] = {"kernel": _stack(
            _t(sd, lkey(l, "block_sparse_moe.gate.weight"))
            for l in range(L))}
        layers["gate"] = {"kernel": _stack(
            _stack(_t(sd, lkey(l, f"block_sparse_moe.experts.{e}.w1.weight"))
                   for e in range(E)) for l in range(L))}
        layers["down"] = {"kernel": _stack(
            _stack(_t(sd, lkey(l, f"block_sparse_moe.experts.{e}.w2.weight"))
                   for e in range(E)) for l in range(L))}
        layers["up"] = {"kernel": _stack(
            _stack(_t(sd, lkey(l, f"block_sparse_moe.experts.{e}.w3.weight"))
                   for e in range(E)) for l in range(L))}
    else:
        layers["gate"] = {"kernel": _stack(
            _t(sd, lkey(l, "mlp.gate_proj.weight")) for l in range(L))}
        layers["up"] = {"kernel": _stack(
            _t(sd, lkey(l, "mlp.up_proj.weight")) for l in range(L))}
        layers["down"] = {"kernel": _stack(
            _t(sd, lkey(l, "mlp.down_proj.weight")) for l in range(L))}

    params = {
        "embed": {"weight": _a(sd, f"{prefix}embed_tokens.weight")},
        "layers": layers,
        "final_norm": {"scale": _a(sd, f"{prefix}norm.weight")},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": _t(sd, "lm_head.weight")}
    return params


# ---------------------------------------------------------------------------
# Vision tower (CLIP / SigLIP)
# ---------------------------------------------------------------------------

def vision_params_from_state_dict(sd: Mapping, cfg: VisionConfig,
                                  prefix: str = "vision_model.") -> dict:
    """Convert an HF CLIPVisionModel / SiglipVisionModel state_dict.

    HF layout (both families share encoder-layer naming):
      {prefix}embeddings.{patch,position}_embedding...
      {prefix}encoder.layers.{l}.{self_attn.{q,k,v,out}_proj,
                               layer_norm{1,2}, mlp.fc{1,2}}
      CLIP extras: embeddings.class_embedding, pre_layrnorm, post_layernorm
      SigLIP extras: post_layernorm (no CLS, no pre-LN)
    """
    L = cfg.num_layers

    def lkey(l, sub):
        return f"{prefix}encoder.layers.{l}.{sub}"

    layers = {
        "ln1": {"scale": _stack(_a(sd, lkey(l, "layer_norm1.weight"))
                                for l in range(L)),
                "bias": _stack(_a(sd, lkey(l, "layer_norm1.bias"))
                               for l in range(L))},
        "ln2": {"scale": _stack(_a(sd, lkey(l, "layer_norm2.weight"))
                                for l in range(L)),
                "bias": _stack(_a(sd, lkey(l, "layer_norm2.bias"))
                               for l in range(L))},
        "fc1": {"kernel": _stack(_t(sd, lkey(l, "mlp.fc1.weight"))
                                 for l in range(L)),
                "bias": _stack(_a(sd, lkey(l, "mlp.fc1.bias"))
                               for l in range(L))},
        "fc2": {"kernel": _stack(_t(sd, lkey(l, "mlp.fc2.weight"))
                                 for l in range(L)),
                "bias": _stack(_a(sd, lkey(l, "mlp.fc2.bias"))
                               for l in range(L))},
    }
    for name, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("o", "out_proj")):
        layers[name] = {
            "kernel": _stack(_t(sd, lkey(l, f"self_attn.{hf}.weight"))
                             for l in range(L)),
            "bias": _stack(_a(sd, lkey(l, f"self_attn.{hf}.bias"))
                           for l in range(L)),
        }

    # torch Conv2d [O, I, kh, kw] -> [kh, kw, I, O]
    patch_w = _a(sd, f"{prefix}embeddings.patch_embedding.weight")
    patch = {"kernel": patch_w.permute(2, 3, 1, 0)}
    if f"{prefix}embeddings.patch_embedding.bias" in sd:
        patch["bias"] = _a(sd, f"{prefix}embeddings.patch_embedding.bias")

    params = {
        "patch_embed": patch,
        "pos_embed": {"weight": _a(
            sd, f"{prefix}embeddings.position_embedding.weight")},
        "layers": layers,
        "post_ln": {"scale": _a(sd, f"{prefix}post_layernorm.weight"),
                    "bias": _a(sd, f"{prefix}post_layernorm.bias")},
    }
    if cfg.variant == "clip":
        params["cls_token"] = {"weight": _a(
            sd, f"{prefix}embeddings.class_embedding")}
        params["pre_ln"] = {"scale": _a(sd, f"{prefix}pre_layrnorm.weight"),
                            "bias": _a(sd, f"{prefix}pre_layrnorm.bias")}
    return params


# ---------------------------------------------------------------------------
# Connector (STC / STP / mlp / linear)
# ---------------------------------------------------------------------------

def _convnormact(sd: Mapping, prefix: str, ndim: int = 2) -> dict:
    """timm ConvNormAct: {prefix}.conv.weight + {prefix}.bn.{weight,bias}
    (norm is LayerNorm2d here, stored under 'bn')."""
    w = _a(sd, f"{prefix}.conv.weight")
    if ndim == 2:
        kernel = w.permute(2, 3, 1, 0)
    else:
        kernel = w.permute(2, 3, 4, 1, 0)
    p = {"conv": {"kernel": kernel}}
    if f"{prefix}.conv.bias" in sd:
        p["conv"]["bias"] = _a(sd, f"{prefix}.conv.bias")
    if f"{prefix}.bn.weight" in sd:
        p["norm"] = {"scale": _a(sd, f"{prefix}.bn.weight"),
                     "bias": _a(sd, f"{prefix}.bn.bias")}
    return p


def _regstage(sd: Mapping, prefix: str, depth: int) -> dict:
    """timm RegStage of `depth` Bottleneck blocks b1..bN
    (timm.models.regnet; reference projector.py:153-186)."""
    blocks = []
    for i in range(1, depth + 1):
        bp = f"{prefix}.b{i}"
        block = {
            "conv1": _convnormact(sd, f"{bp}.conv1"),
            "conv2": _convnormact(sd, f"{bp}.conv2"),
            "conv3": _convnormact(sd, f"{bp}.conv3"),
            "se": {
                "fc1": {"kernel": _a(sd, f"{bp}.se.fc1.weight").permute(
                    2, 3, 1, 0),
                        "bias": _a(sd, f"{bp}.se.fc1.bias")},
                "fc2": {"kernel": _a(sd, f"{bp}.se.fc2.weight").permute(
                    2, 3, 1, 0),
                        "bias": _a(sd, f"{bp}.se.fc2.bias")},
            },
        }
        if f"{bp}.downsample.conv.weight" in sd:
            block["downsample"] = _convnormact(sd, f"{bp}.downsample")
        blocks.append(block)
    return {f"b{i+1}": b for i, b in enumerate(blocks)}


def _mlp_seq(sd: Mapping, prefix: str, depth: int) -> dict:
    """nn.Sequential of Linear(+GELU) pairs: indices 0, 2, 4...
    (projector.py:125-130)."""
    base = prefix + "." if prefix else ""
    out = {}
    for d in range(depth):
        idx = 2 * d
        out[f"fc{d+1}"] = {"kernel": _t(sd, f"{base}{idx}.weight"),
                           "bias": _a(sd, f"{base}{idx}.bias")}
    return out


def connector_params_from_state_dict(sd: Mapping, cfg: ConnectorConfig,
                                     prefix: str = "") -> dict:
    pt = cfg.projector_type
    if pt == "linear":
        return {"fc1": {"kernel": _t(sd, f"{prefix}weight"),
                        "bias": _a(sd, f"{prefix}bias")}}
    m = re.match(r"^mlp(\d+)x_gelu$", pt)
    if m:
        return _mlp_seq(sd, prefix.rstrip("."), int(m.group(1)))
    if pt in ("stc_connector", "stc_connector_v35", "stp_connector",
              "spatial_conv", "spatial_pool"):
        params: dict = {}
        if cfg.depth != 0:
            params["s1"] = _regstage(sd, f"{prefix}s1", cfg.depth)
            params["s2"] = _regstage(sd, f"{prefix}s2", cfg.depth)
        if pt in ("stc_connector", "stc_connector_v35", "spatial_conv"):
            # sampler = Sequential(Conv3d, SiLU) -> index 0
            w = _a(sd, f"{prefix}sampler.0.weight")  # [O, I, kt, kh, kw]
            params["sampler"] = {
                "kernel": w.permute(2, 3, 4, 1, 0),
                "bias": _a(sd, f"{prefix}sampler.0.bias")}
        params["readout"] = _mlp_seq(sd, f"{prefix}readout", cfg.mlp_depth)
        return params
    if pt == "identity":
        return {}
    raise ValueError(f"Unknown projector type {pt}")


# ---------------------------------------------------------------------------
# Audio tower (BEATs, VideoLLaMA2.1-AV)
# ---------------------------------------------------------------------------

# the audio tower's two key prefixes in released AV checkpoints
AUDIO_PREFIXES = ("model.audio_tower.audio_tower.", "model.audio_tower.")


def audio_params_from_state_dict(sd: Mapping, cfg: AudioConfig,
                                 prefix: str) -> dict:
    """Convert a BEATs state_dict (microsoft/unilm layout): patch_embedding
    (Conv2d, no bias), layer_norm, post_extract_proj, encoder.pos_conv.0
    (a weight-normed grouped Conv1d: weight_g, weight_v), encoder.layer_norm
    (the post-norm backbone's input LN), encoder.layers.{l}: self_attn.
    {q,k,v,out}_proj (k_proj without bias), grep_linear and
    gru_rel_pos_const, self_attn_layer_norm, final_layer_norm, fc1, fc2.
    Only layer 0's relative_attention_bias is read: BEATs computes the
    position bias once, from layer 0's table, and shares it with every
    layer, so the tables of layers 1-11 are never read."""
    L = cfg.num_layers

    def lk(l, s):
        return f"{prefix}encoder.layers.{l}.{s}"

    def linear(name, bias=True):
        out = {"kernel": _stack(_t(sd, lk(l, f"{name}.weight"))
                                for l in range(L))}
        if bias:
            out["bias"] = _stack(_a(sd, lk(l, f"{name}.bias"))
                                 for l in range(L))
        return out

    def ln(name):
        return {"scale": _stack(_a(sd, lk(l, f"{name}.weight"))
                                for l in range(L)),
                "bias": _stack(_a(sd, lk(l, f"{name}.bias"))
                               for l in range(L))}

    # weight norm (fairseq: weight_norm(conv, dim=2), weight_g [1, 1, K]):
    # the norm runs over the axes where g has size 1, in fp32; the kernel
    # [D, D/g, K] becomes [K, D/g, D]
    wg = _a(sd, f"{prefix}encoder.pos_conv.0.weight_g")
    wv = _a(sd, f"{prefix}encoder.pos_conv.0.weight_v")
    axes = tuple(i for i, n in enumerate(wg.shape) if n == 1)
    v32 = wv.float()
    norm = torch.sqrt((v32 ** 2).sum(dim=axes, keepdim=True))
    w = wg.float() * v32 / torch.clamp(norm, min=1e-8)
    layers = {
        "q": linear("self_attn.q_proj"),
        "k": linear("self_attn.k_proj", bias=False),
        "v": linear("self_attn.v_proj"),
        "o": linear("self_attn.out_proj"),
        "grep": linear("self_attn.grep_linear"),
        "grep_a": _stack(_a(sd, lk(l, "self_attn.gru_rel_pos_const"))[0]
                         for l in range(L)),
        "ln1": ln("self_attn_layer_norm"),
        "ln2": ln("final_layer_norm"),
        "fc1": linear("fc1"),
        "fc2": linear("fc2"),
    }
    return {
        "patch_embed": {"kernel": _a(sd, f"{prefix}patch_embedding.weight")
                        .permute(2, 3, 1, 0)},       # [E, 1, 16, 16] -> HWIO
        "pre_ln": {"scale": _a(sd, f"{prefix}layer_norm.weight"),
                   "bias": _a(sd, f"{prefix}layer_norm.bias")},
        "post_extract_proj": {
            "kernel": _t(sd, f"{prefix}post_extract_proj.weight"),
            "bias": _a(sd, f"{prefix}post_extract_proj.bias")},
        "pos_conv": {"kernel": w.permute(2, 1, 0).to(wv.dtype),
                     "bias": _a(sd, f"{prefix}encoder.pos_conv.0.bias")},
        "enc_ln": {"scale": _a(sd, f"{prefix}encoder.layer_norm.weight"),
                   "bias": _a(sd, f"{prefix}encoder.layer_norm.bias")},
        # nn.Embedding(num_buckets, num_heads): [320, H] as it is
        "rel_embed": _a(sd, lk(0, "self_attn.relative_attention_bias."
                               "weight")),
        "layers": layers,
    }


def _audio_branch(sd: Mapping, cfg: ModelConfig) -> dict:
    """The AV model's audio branch from a state dict: BEATs under either
    prefix and the projector `model.mm_projector_a.{0,2}`; without an audio
    tower, the port's seeded init (fp32) with a warning, as for a missing
    vision tower (its values differ from the JAX package's PRNGKey(0)
    init)."""
    for prefix in AUDIO_PREFIXES:
        if f"{prefix}patch_embedding.weight" in sd:
            return {"encoder": audio_params_from_state_dict(sd, cfg.audio,
                                                            prefix),
                    "projector": _mlp_seq(sd, "model.mm_projector_a", 2)}
    from ..utils.synthetic import synthetic_audio_params
    warnings.warn("AV config but no audio tower weights found; audio "
                  "branch randomly initialized")
    return synthetic_audio_params(cfg, dtype=torch.float32, device="cpu",
                                  seed=0)


# ---------------------------------------------------------------------------
# Whole-model assembly from a checkpoint directory
# ---------------------------------------------------------------------------

def load_state_dict_from_dir(path: str) -> Dict[str, torch.Tensor]:
    """Read all safetensors/bin shards in an HF checkpoint directory (a
    `*.safetensors.index.json` beside the shards is not needed)."""
    sd: Dict[str, torch.Tensor] = {}
    fns = sorted(os.listdir(path))
    st_files = [f for f in fns if f.endswith(".safetensors")]
    if st_files:
        for fn in st_files:
            sd.update(read_safetensors(os.path.join(path, fn)))
        return sd
    bins = [f for f in fns if f.startswith("pytorch_model")
            and f.endswith(".bin")]
    if bins:
        for fn in bins:
            sd.update(torch.load(os.path.join(path, fn), map_location="cpu",
                                 weights_only=True))
        return sd
    raise FileNotFoundError(f"No model weights found in {path}")


def model_config_from_hf(cfg_json: dict) -> ModelConfig:
    """Build a ModelConfig from a videollama2 checkpoint's config.json."""
    mt = cfg_json.get("model_type", "videollama2_mistral")
    if not mt.startswith("videollama2"):
        mt = "videollama2_" + {"mistral": "mistral", "qwen2": "qwen2",
                               "mixtral": "mixtral", "llama": "llama"}[mt]
    if mt == "videollama2":  # v1 checkpoints use bare 'videollama2' (mistral)
        mt = "videollama2_mistral"
    base = cfglib.preset(mt)
    llm = base.llm
    llm_fields = dict(
        vocab_size=cfg_json.get("vocab_size", llm.vocab_size),
        hidden_size=cfg_json.get("hidden_size", llm.hidden_size),
        intermediate_size=cfg_json.get("intermediate_size",
                                       llm.intermediate_size),
        num_layers=cfg_json.get("num_hidden_layers", llm.num_layers),
        num_heads=cfg_json.get("num_attention_heads", llm.num_heads),
        num_kv_heads=cfg_json.get("num_key_value_heads", llm.num_kv_heads),
        rope_theta=cfg_json.get("rope_theta", llm.rope_theta),
        rms_norm_eps=cfg_json.get("rms_norm_eps", llm.rms_norm_eps),
        max_position_embeddings=cfg_json.get("max_position_embeddings",
                                             llm.max_position_embeddings),
        sliding_window=cfg_json.get("sliding_window", llm.sliding_window),
        tie_word_embeddings=cfg_json.get("tie_word_embeddings", False),
        bos_token_id=cfg_json.get("bos_token_id", llm.bos_token_id),
        eos_token_id=_first(cfg_json.get("eos_token_id", llm.eos_token_id)),
        pad_token_id=cfg_json.get("pad_token_id") or llm.pad_token_id,
    )
    llm_fields["head_dim"] = cfg_json.get(
        "head_dim", llm_fields["hidden_size"] // llm_fields["num_heads"])
    if cfg_json.get("num_local_experts"):
        llm_fields["num_experts"] = cfg_json["num_local_experts"]
        llm_fields["num_experts_per_tok"] = cfg_json.get(
            "num_experts_per_tok", 2)
    llm = dataclasses.replace(llm, **llm_fields)

    tower = cfg_json.get("mm_vision_tower", "")
    vision = (cfglib.siglip_so400m_384() if "siglip" in tower
              else cfglib.clip_vit_l_336())
    if "tiny_test_vision" in cfg_json:  # test fixtures carry explicit dims
        tv = cfg_json["tiny_test_vision"]
        vision = dataclasses.replace(
            vision, image_size=tv["image_size"], patch_size=tv["patch_size"],
            hidden_size=tv["hidden_size"],
            intermediate_size=tv["intermediate_size"],
            num_layers=tv["num_layers"], num_heads=tv["num_heads"])
    if "mm_vision_select_layer" in cfg_json:
        vision = dataclasses.replace(
            vision, select_layer=cfg_json["mm_vision_select_layer"])
    conn = ConnectorConfig(
        projector_type=cfg_json.get("mm_projector_type", "stc_connector"),
        mm_hidden_size=cfg_json.get("mm_hidden_size", vision.hidden_size),
        hidden_size=llm.hidden_size,
        # reference STC depth is fixed at 4 (projector.py:135); test fixtures
        # may override
        depth=cfg_json.get("mm_connector_depth", 4))
    audio = None
    if any(k in cfg_json for k in ("mm_audio_tower", "audio_tower")) or \
            "av" in cfg_json.get("model_type", ""):
        audio = cfglib.AudioConfig()
    return ModelConfig(model_type=mt, llm=llm, vision=vision, connector=conn,
                       audio=audio,
                       num_frames=cfg_json.get("num_frames", 8))


def _first(x):
    return x[0] if isinstance(x, (list, tuple)) else x


def model_config_to_hf(cfg: ModelConfig) -> dict:
    """Inverse of model_config_from_hf: a config.json dict in the
    reference's HF layout (videollama2_arch.py:49,64-68 mm_* stamping), so
    checkpoints written by either package load in both."""
    llm = cfg.llm
    arch = {"videollama2_mistral": "Videollama2MistralForCausalLM",
            "videollama2_qwen2": "Videollama2Qwen2ForCausalLM",
            "videollama2_mixtral": "Videollama2MixtralForCausalLM",
            "videollama2_llama": "Videollama2LlamaForCausalLM",
            }.get(cfg.model_type, "Videollama2MistralForCausalLM")
    out = {
        "model_type": cfg.model_type,
        "architectures": [arch],
        "vocab_size": llm.vocab_size,
        "hidden_size": llm.hidden_size,
        "intermediate_size": llm.intermediate_size,
        "num_hidden_layers": llm.num_layers,
        "num_attention_heads": llm.num_heads,
        "num_key_value_heads": llm.num_kv_heads,
        "head_dim": llm.head_dim,
        "rope_theta": llm.rope_theta,
        "rms_norm_eps": llm.rms_norm_eps,
        "max_position_embeddings": llm.max_position_embeddings,
        "sliding_window": llm.sliding_window,
        "tie_word_embeddings": llm.tie_word_embeddings,
        "bos_token_id": llm.bos_token_id,
        "eos_token_id": llm.eos_token_id,
        "pad_token_id": llm.pad_token_id,
        "mm_projector_type": cfg.connector.projector_type,
        "mm_hidden_size": cfg.connector.mm_hidden_size,
        "mm_vision_tower": ("siglip-so400m-patch14-384"
                            if cfg.vision.variant == "siglip"
                            else "clip-vit-large-patch14-336"),
        "mm_vision_select_layer": cfg.vision.select_layer,
        "mm_vision_select_feature": "patch",
        "num_frames": cfg.num_frames,
    }
    if llm.is_moe:
        out["num_local_experts"] = llm.num_experts
        out["num_experts_per_tok"] = llm.num_experts_per_tok
    if cfg.connector.depth != 4:
        out["mm_connector_depth"] = cfg.connector.depth
    # tiny test-fixture towers carry explicit dims for round-tripping
    if cfg.vision.image_size not in (336, 384):
        v = cfg.vision
        out["tiny_test_vision"] = {
            "image_size": v.image_size, "patch_size": v.patch_size,
            "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_layers": v.num_layers, "num_heads": v.num_heads}
    return out


def videollama2_params_from_state_dict(sd: Mapping, cfg: ModelConfig) -> dict:
    """Full checkpoint: model.* (LLM), model.vision_tower.vision_tower.* ,
    model.mm_projector.* (reference save layout); AV checkpoints add
    model.audio_tower.* and model.mm_projector_a.*."""
    params = {
        "llm": llm_params_from_state_dict(sd, cfg.llm, prefix="model."),
        "vision": vision_params_from_state_dict(
            sd, cfg.vision,
            prefix="model.vision_tower.vision_tower.vision_model."),
        "connector": connector_params_from_state_dict(
            sd, cfg.connector, prefix="model.mm_projector."),
    }
    if cfg.audio is not None:
        params["audio"] = _audio_branch(sd, cfg)
    return params


def load_videollama2(path: str, model_base: str = None,
                     vision_tower_path: str = None):
    """Load a VideoLLaMA2 checkpoint directory (reference
    model/__init__.py:48-193):

      (b) pretrain dir (mm_projector.bin) + model_base: base LLM + converted
          projector, vision tower from `vision_tower_path` or seeded random
          (an AV config's audio branch from model_base, else seeded random);
      (c) full SFT checkpoint: everything from the one directory;
      (d) plain LLM checkpoint: falls back to (c) shapes minus mm modules.

    (a), a LoRA dir (adapter_model.*), raises NotImplementedError until the
    port has LoRA. Returns (ModelConfig, params dict in the JAX layout).
    """
    with open(os.path.join(path, "config.json")) as f:
        cfg_json = json.load(f)
    cfg = model_config_from_hf(cfg_json)
    files = set(os.listdir(path))
    if any(f.startswith("adapter_model") for f in files):
        raise NotImplementedError("LoRA checkpoint directories are not "
                                  "ported yet (ROADMAP queue 1 item 9.1)")
    is_pretrain = "mm_projector.bin" in files and not any(
        f.endswith(".safetensors") or f.startswith("pytorch_model")
        for f in files)

    if is_pretrain:
        # (b) model/__init__.py:138-164
        assert model_base, "pretrain-stage checkpoints need model_base"
        base_sd = load_state_dict_from_dir(model_base)
        params = {
            "llm": llm_params_from_state_dict(base_sd, cfg.llm,
                                              prefix="model."),
            "vision": _vision_params(cfg, vision_tower_path),
            "connector": load_pretrain_adapter(path, cfg.connector),
        }
        if cfg.audio is not None:
            params["audio"] = _audio_branch(base_sd, cfg)
        return cfg, params

    # (c)/(d) full checkpoint
    sd = load_state_dict_from_dir(path)
    return cfg, videollama2_params_from_state_dict(sd, cfg)


def _vision_params(cfg: ModelConfig, vision_tower_path) -> dict:
    """The tower from `vision_tower_path`, else the port's seeded init
    (fp32, qkv already fused; its values differ from the JAX package's
    PRNGKey(0) init)."""
    if vision_tower_path:
        vsd = load_state_dict_from_dir(vision_tower_path)
        return vision_params_from_state_dict(vsd, cfg.vision,
                                             prefix="vision_model.")
    from ..utils.synthetic import synthetic_vision_params
    warnings.warn("vision tower weights unavailable offline; "
                  "randomly initialized — pass vision_tower_path")
    return synthetic_vision_params(cfg.vision, dtype=torch.float32,
                                   device="cpu", seed=0)


def load_pretrain_adapter(path: str, cfg: ConnectorConfig) -> dict:
    """Load a pretrain-stage `mm_projector.bin` (model/__init__.py:138-164)."""
    sd = torch.load(os.path.join(path, "mm_projector.bin"),
                    map_location="cpu", weights_only=True)
    return connector_params_from_state_dict(sd, cfg,
                                            prefix="model.mm_projector.")
