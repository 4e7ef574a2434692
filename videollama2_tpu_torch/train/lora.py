"""LoRA: low-rank adapters on the LLM's linear projections (port of
videollama2_tpu/train/lora.py).

As in the JAX package an adapter sits inside its projection's entry of
the stacked layer tree, entry["lora"] = {"a": [L, in, r], "b": [L, r, out],
"s": [L, 1, 1]}, and ops/layers.dense adds (x @ a) @ b * s after the base
product, whatever the base (a floating kernel, an int8 or a folded int4
pack). s = alpha / r is a frozen leaf. The JAX package's `dropout` is never
applied by its dense, and the split save writes 0.0; the port does the
same.

The port keeps q, k and v fused in one "qkv" entry (ops/quant.fuse_qkv),
so their three adapters are held as one:

  qkv["lora"] = {"a": [L, D, rq + rk + rv]      Aq | Ak | Av
                 "b": {"q": [L, rq, H hd], "k": [L, rk, Hkv hd],
                       "v": [L, rv, Hkv hd]},
                 "s": [L, 1, 1]}

One product x @ a serves the three projections, and each b block maps its
own r-slice of that product onto its own column slice of the fused output:
exactly the JAX package's three deltas, each block's gradient that of its
projection's adapter (there are no zero blocks to train). A projection
without an adapter holds a block of rank 0. The three must share s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..ops.layers import lora_b_product

# LLM projections adaptable by LoRA (stacked [L, in, out] kernels)
TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
QKV = ("q", "k", "v")


@dataclass(frozen=True)
class LoraConfig:
    r: int = 128
    alpha: int = 256
    dropout: float = 0.05
    targets: Tuple[str, ...] = TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def _entry_dims(entry: dict) -> Optional[Tuple[torch.Tensor, int, int, int]]:
    """(a weight tensor, L, in, out) of a stacked projection entry: a
    floating kernel, an int8 pack or a folded int4 pack (two input rows a
    byte); None for any other entry. An MoE expert stack [L, E, in, out]
    raises ValueError, as the JAX package's inject_lora does when it
    unpacks the shape into (L, in, out)."""
    if "kernel" in entry:
        w = entry["kernel"]
    elif "kernel_q8" in entry:
        w = entry["kernel_q8"]["q"]
    elif "kernel_q4" in entry:
        w = entry["kernel_q4"]["q4"]
    else:
        return None
    if w.dim() != 3:
        raise ValueError(f"LoRA adapts stacked [L, in, out] kernels; this "
                         f"entry is {list(w.shape)} (an MoE expert stack "
                         f"has no adapter layout)")
    L, d_in, d_out = w.shape
    if "kernel_q4" in entry:
        d_in *= 2
    return w, L, d_in, d_out


def qkv_widths(llm_cfg) -> Dict[str, int]:
    """Output widths of q, k and v inside the fused qkv entry."""
    hd = llm_cfg.head_dim
    return {"q": llm_cfg.num_heads * hd, "k": llm_cfg.num_kv_heads * hd,
            "v": llm_cfg.num_kv_heads * hd}


def fuse_qkv_adapters(adapters: Dict[str, dict],
                      widths: Dict[str, int]) -> Optional[dict]:
    """The fused qkv entry's adapter from {"q"|"k"|"v": {"a", "b", "s"}}
    (the JAX package's per-projection adapters, any of the three); a
    projection without one gets a block of rank 0 (widths: each one's
    output width). None when none of the three has an adapter."""
    present = [n for n in QKV if n in adapters]
    if not present:
        return None
    ref = adapters[present[0]]
    for n in present[1:]:
        if not torch.equal(adapters[n]["s"], ref["s"]):
            raise ValueError("the fused qkv entry takes one scale: q, k and "
                             "v adapters with different alpha / r")
    L, d_in = ref["a"].shape[:2]
    a = torch.cat([adapters[n]["a"] if n in adapters
                   else ref["a"].new_zeros((L, d_in, 0)) for n in QKV],
                  dim=-1)
    b = {n: adapters[n]["b"] if n in adapters
         else ref["b"].new_zeros((L, 0, widths[n])) for n in QKV}
    return {"a": a, "b": b, "s": ref["s"]}


def split_qkv_adapter(lora: dict) -> Dict[str, dict]:
    """The fused qkv adapter back to {"q"|"k"|"v": {"a", "b", "s"}}, the
    blocks of rank 0 left out (the JAX layout)."""
    out, off = {}, 0
    for n, b in lora["b"].items():
        r = b.shape[-2]
        if r:
            out[n] = {"a": lora["a"][..., off:off + r], "b": b,
                      "s": lora["s"]}
        off += r
    return out


def delta(lora: dict) -> torch.Tensor:
    """The full-rank [..., in, out] delta a @ b * s of an adapter, fused or
    not, in fp32."""
    return lora_b_product(lora["a"].float(), lora["b"]) * lora["s"].float()


def inject_lora(generator: torch.Generator, llm_params: dict,
                cfg: LoraConfig, llm_cfg) -> dict:
    """Attach trainable adapters inside the layer entries of the targets
    (JAX `inject_lora`): fp32 masters a ~ N(0, 1/r), b = 0 (the delta
    starts at zero), s = alpha / r over L, made on the weights' device
    from `generator` (a generator on that device). Works over floating kernels and int8 or
    int4 packs (QLoRA: a frozen quantized base). On the fused qkv entry
    the targets among q, k, v get one a block each, drawn in that order
    (llm_cfg gives their widths)."""
    layers = dict(llm_params["layers"])

    def adapter(w, L, d_in, d_out):
        a = torch.randn((L, d_in, cfg.r), generator=generator,
                        dtype=torch.float32, device=w.device) / cfg.r ** 0.5
        return {"a": a,
                "b": torch.zeros((L, cfg.r, d_out), device=w.device),
                "s": torch.full((L, 1, 1), cfg.scaling, device=w.device)}

    for name, entry in llm_params["layers"].items():
        if not isinstance(entry, dict) or (name != "qkv"
                                           and name not in cfg.targets):
            continue
        dims = _entry_dims(entry)
        if dims is None:
            continue
        w, L, d_in, d_out = dims
        if name == "qkv":
            widths = qkv_widths(llm_cfg)
            if sum(widths.values()) != d_out:
                raise ValueError(f"qkv out width {d_out} != {widths}")
            lora = fuse_qkv_adapters(
                {n: adapter(w, L, d_in, widths[n])
                 for n in QKV if n in cfg.targets}, widths)
        else:
            lora = adapter(w, L, d_in, d_out)
        if lora is not None:
            layers[name] = {**entry, "lora": lora}
    return {**llm_params, "layers": layers}


def extract_lora(llm_params: dict) -> dict:
    """The injected adapters in the JAX package's separate-tree form,
    {"layers": {"q": {"a", "b"}, ..., "down": {...}}}, the fused qkv
    adapter split into q, k and v."""
    out: dict = {"layers": {}}
    for name, entry in llm_params["layers"].items():
        if not (isinstance(entry, dict) and "lora" in entry):
            continue
        lo = entry["lora"]
        parts = split_qkv_adapter(lo) if name == "qkv" else {name: lo}
        for n, ab in parts.items():
            out["layers"][n] = {"a": ab["a"], "b": ab["b"]}
    return out


def strip_lora(llm_params: dict) -> dict:
    """The frozen base: every injected adapter removed."""
    layers = {}
    for name, entry in llm_params["layers"].items():
        if isinstance(entry, dict) and "lora" in entry:
            entry = {k: v for k, v in entry.items() if k != "lora"}
        layers[name] = entry
    return {**llm_params, "layers": layers}


def merge_lora_injected(llm_params: dict) -> dict:
    """Fold injected adapters into floating base kernels (JAX
    `merge_lora_injected`): kernel + (a @ b * s in fp32) cast to the
    kernel's dtype. Quantized bases keep their adapters unmerged (dense
    applies them), since merging into a pack would lose the delta to its
    rounding."""
    layers = {}
    for name, entry in llm_params["layers"].items():
        if isinstance(entry, dict) and "lora" in entry and "kernel" in entry:
            d = delta(entry["lora"])
            entry = {k: v for k, v in entry.items() if k != "lora"}
            entry["kernel"] = entry["kernel"] + d.to(entry["kernel"].dtype)
        layers[name] = entry
    return {**llm_params, "layers": layers}


def apply_lora(llm_params: dict, lora: dict, cfg: LoraConfig) -> dict:
    """Params with separate-tree adapters ({"layers": {name: {"a", "b"}}},
    JAX layout: q, k, v apart) folded into the kernels of those entries:
    kernel + (a @ b * alpha / r) cast to the kernel's dtype (JAX
    `apply_lora`)."""
    layers = dict(llm_params["layers"])
    for name, ab in lora["layers"].items():
        base = layers[name]
        d = torch.matmul(ab["a"], ab["b"]) * cfg.scaling
        layers[name] = {**base, "kernel": base["kernel"]
                        + d.to(base["kernel"].dtype)}
    return {**llm_params, "layers": layers}


def merge_lora(params: dict, lora: dict, cfg: LoraConfig) -> dict:
    """A full param tree with the adapters folded in (export path)."""
    return {**params, "llm": apply_lora(params["llm"], lora, cfg)}


# peft module names of the targets (JAX checkpoint/orbax_io._PEFT_NAME)
PEFT_NAME = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "o": "self_attn.o_proj",
             "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
PEFT_PREFIX = "base_model.model.model.layers."


def lora_params_from_peft_state_dict(sd, llm_cfg, cfg: LoraConfig) -> dict:
    """A peft `adapter_model` state dict (keys base_model.model.model.
    layers.{l}.self_attn.q_proj.lora_A.weight, A [r, in], B [out, r]) ->
    {"layers": {name: {"a": [L, in, r], "b": [L, r, out]}}} in fp32 (JAX
    `lora_params_from_peft_state_dict`): a target is taken when all L
    layers hold it."""
    out: dict = {"layers": {}}
    L = llm_cfg.num_layers
    for ours, theirs in PEFT_NAME.items():
        a_list, b_list = [], []
        for layer in range(L):
            base = f"{PEFT_PREFIX}{layer}.{theirs}"
            if f"{base}.lora_A.weight" not in sd:
                break
            a_list.append(torch.as_tensor(sd[f"{base}.lora_A.weight"]
                                          ).float().T)
            b_list.append(torch.as_tensor(sd[f"{base}.lora_B.weight"]
                                          ).float().T)
        if len(a_list) == L:
            out["layers"][ours] = {"a": torch.stack(a_list),
                                   "b": torch.stack(b_list)}
    return out
