"""The training saves (port of save_projector_only, load_projector_only,
export_hf_projector_bin and export_lora_split of
videollama2_tpu/checkpoint/orbax_io.py; its train-state half is
checkpoint/train_state.py).

The pretrain stage's projector-only save: the connector's leaves in
`mm_projector.npz`, keyed by their "/"-joined paths, beside
`mm_projector.json`, the sorted key list. Both packages read each other's
files. bf16 leaves are written as fp32 (numpy has no bf16; the widening is
exact) and cast back to the dtype of `like` on load.

The LoRA split save (reference videollama2_trainer.py:343-361):
`adapter_model.bin` (the peft adapters), `adapter_config.json`,
`non_lora_trainables.bin` (the projector in the reference's key layout)
and `config.json`, which checkpoint/convert_hf.load_videollama2 path (a)
and the JAX package's loader read back.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch

from ..train import lora as lora_lib
from ..train.optimizer import flatten


def save_projector_only(directory: str, connector_params: dict) -> None:
    os.makedirs(directory, exist_ok=True)
    flat = {}
    for path, t in flatten(connector_params).items():
        t = t.detach().cpu()
        flat["/".join(path)] = (t.float() if t.dtype == torch.bfloat16
                                else t).numpy()
    np.savez(os.path.join(directory, "mm_projector.npz"), **flat)
    with open(os.path.join(directory, "mm_projector.json"), "w") as f:
        json.dump(sorted(flat), f)


def load_projector_only(directory: str, like: dict) -> dict:
    """A tree shaped like `like` (a connector tree of tensors) with the
    saved values, in each leaf's dtype and on its device."""
    data = np.load(os.path.join(directory, "mm_projector.npz"))

    def build(tree, prefix):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = build(v, prefix + (k,))
            else:
                arr = data["/".join(prefix + (k,))]
                if tuple(arr.shape) != tuple(v.shape):
                    raise ValueError(f"{'/'.join(prefix + (k,))}: saved "
                                     f"{arr.shape}, expected {tuple(v.shape)}")
                out[k] = torch.from_numpy(np.array(arr)).to(
                    device=v.device, dtype=v.dtype)
        return out
    return build(like, ())


def _projector_state_dict(connector_params: dict, prefix: str,
                          projector_type: Optional[str] = None) -> dict:
    """Connector params -> a torch state dict in the reference's key
    layout (the port's copy of the JAX package's, but for the linear
    projector's keys; the inverse of
    convert_hf.connector_params_from_state_dict): conv kernels [*k, I, O]
    -> [O, I, *k], linear kernels [in, out] -> [out, in], each leaf on the
    CPU in its dtype. projector_type is needed only for a tree of one
    top-level fc1 (linear or mlp1x_gelu)."""
    sd = {}

    def cpu(t):
        return t.detach().cpu().contiguous()

    def conv_t(kernel, ndim):
        perm = (3, 2, 0, 1) if ndim == 2 else (4, 3, 0, 1, 2)
        return cpu(kernel.permute(*perm))

    def put_cna(name, cna):
        sd[prefix + name + ".conv.weight"] = conv_t(cna["conv"]["kernel"], 2)
        if "bias" in cna["conv"]:
            sd[prefix + name + ".conv.bias"] = cpu(cna["conv"]["bias"])
        if "norm" in cna:
            sd[prefix + name + ".bn.weight"] = cpu(cna["norm"]["scale"])
            sd[prefix + name + ".bn.bias"] = cpu(cna["norm"]["bias"])

    p = connector_params
    for stage in ("s1", "s2"):
        for bname, b in p.get(stage, {}).items():
            base = f"{stage}.{bname}"
            for cname in ("conv1", "conv2", "conv3"):
                put_cna(f"{base}.{cname}", b[cname])
            for f_ in ("fc1", "fc2"):
                sd[prefix + f"{base}.se.{f_}.weight"] = conv_t(
                    b["se"][f_]["kernel"], 2)
                sd[prefix + f"{base}.se.{f_}.bias"] = cpu(
                    b["se"][f_]["bias"])
            if "downsample" in b:
                put_cna(f"{base}.downsample", b["downsample"])
    if "sampler" in p:
        sd[prefix + "sampler.0.weight"] = conv_t(p["sampler"]["kernel"], 3)
        sd[prefix + "sampler.0.bias"] = cpu(p["sampler"]["bias"])
    for i, (_, fc) in enumerate(sorted(p.get("readout", {}).items())):
        sd[prefix + f"readout.{2 * i}.weight"] = cpu(fc["kernel"].T)
        sd[prefix + f"readout.{2 * i}.bias"] = cpu(fc["bias"])
    # linear / mlpNx projectors: fc1, fc2... at the top level. An mlpNx
    # projector is an nn.Sequential (Linear at 0, 2, 4...); a linear one is
    # a plain nn.Linear, whose keys have no index (projector.py:116-118).
    # The JAX package writes the linear one at index 0 too, which neither
    # package's load_pretrain_adapter reads back.
    fcs = sorted((int(name[2:]), fc) for name, fc in p.items()
                 if re.match(r"^fc\d+$", name))
    if projector_type is None and len(fcs) == 1:
        raise ValueError("a lone fc1 is a linear or an mlp1x_gelu "
                         "projector, whose keys differ: pass the config")
    if projector_type == "linear":
        fcs = [(None, fc) for _, fc in fcs]
    for d, fc in fcs:
        key = prefix if d is None else prefix + f"{2 * (d - 1)}."
        sd[key + "weight"] = cpu(fc["kernel"].T)
        sd[key + "bias"] = cpu(fc["bias"])
    return sd


def export_hf_projector_bin(path: str, connector_params: dict,
                            cfg=None) -> None:
    """The connector as a torch `mm_projector.bin` in the reference's key
    layout (model.mm_projector.*; projector.py:49-63), which the reference
    and both packages' load_pretrain_adapter read (the JAX package's own
    export of a linear projector excepted). cfg: the ModelConfig or
    ConnectorConfig, which a linear or mlp1x_gelu projector needs."""
    torch.save(_projector_state_dict(connector_params, "model.mm_projector.",
                                     _projector_type(cfg)), path)


def _projector_type(cfg) -> Optional[str]:
    return None if cfg is None else getattr(cfg, "connector",
                                            cfg).projector_type


def export_lora_split(directory: str, llm_params: dict,
                      connector_params: dict, model_cfg) -> None:
    """The LoRA split save of an injected LLM tree (JAX
    `export_lora_split`): adapter_model.bin with the peft keys
    base_model.model.model.layers.{l}.{self_attn.q_proj, ...,
    mlp.down_proj}.lora_{A,B}.weight (A [r, in], B [out, r], fp32; the
    fused qkv adapter split into q, k and v), adapter_config.json (r and
    lora_alpha from the adapters' s, lora_dropout 0.0 as the JAX package
    writes it), non_lora_trainables.bin (the projector under
    base_model.model.model.mm_projector.) and config.json."""
    from .convert_hf import model_config_to_hf

    os.makedirs(directory, exist_ok=True)
    adapters = lora_lib.extract_lora(llm_params)["layers"]
    if not adapters:
        raise ValueError("no injected LoRA adapters found in llm params")
    scales = {}
    for name, entry in llm_params["layers"].items():
        if isinstance(entry, dict) and "lora" in entry:
            s = entry["lora"]["s"]
            for n in (lora_lib.QKV if name == "qkv" else (name,)):
                scales[n] = float(s.reshape(-1)[0])
    sd = {}
    r = alpha = None
    for name, ab in adapters.items():
        a = ab["a"].detach().float().cpu()
        b = ab["b"].detach().float().cpu()
        r = a.shape[-1]
        alpha = int(round(scales[name] * r))
        for layer in range(a.shape[0]):
            base = (f"{lora_lib.PEFT_PREFIX}{layer}."
                    f"{lora_lib.PEFT_NAME[name]}")
            # peft layout: A [r, in], B [out, r] (ours: a [in, r], b [r, out])
            sd[f"{base}.lora_A.weight"] = a[layer].T.contiguous()
            sd[f"{base}.lora_B.weight"] = b[layer].T.contiguous()
    torch.save(sd, os.path.join(directory, "adapter_model.bin"))

    with open(os.path.join(directory, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": r, "lora_alpha": alpha,
                   "lora_dropout": 0.0, "bias": "none",
                   "target_modules": sorted(
                       lora_lib.PEFT_NAME[n].split(".")[-1]
                       for n in adapters)}, f, indent=2)

    torch.save(_projector_state_dict(connector_params,
                                     "base_model.model.model.mm_projector.",
                                     _projector_type(model_cfg)),
               os.path.join(directory, "non_lora_trainables.bin"))
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(model_config_to_hf(model_cfg), f, indent=2)
