"""Optimizer: AdamW + warmup schedules, per-group clipping, freezing (port
of videollama2_tpu/train/optimizer.py).

The JAX package builds an optax.multi_transform over a label tree: the
vision tower is frozen ("frozen": set_to_zero), the connector trains at
`mm_projector_lr` ("projector") and the LLM at the base rate ("llm", frozen
under tune_mm_mlp_adapter or freeze_backbone); under lora_enable only the
LoRA adapters' a and b are "llm" and the rest of the LLM is frozen. Each
trained group runs clip_by_global_norm(max_grad_norm) then optax.adamw.
torch.optim.AdamW is not that update, so `GroupedAdamW` writes optax's
arithmetic out:

  - the gradient norm is taken over the group's gradients only;
  - mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, with the dtype
    rules of optax (the moments start as zeros in the param dtype and take
    the promoted dtype of the gradient: bf16 for bf16 gradients, fp32 for
    the fp32 sums of gradient accumulation);
  - bias correction 1 - b^count with count incremented first, eps added
    outside the square root;
  - decoupled weight decay (params with ndim > 1) added to the update
    before the learning-rate scale;
  - the learning rate is the schedule at the count BEFORE the increment
    (with warmup > 0 the first step's rate is 0);
  - p = (p + u) cast back to p's dtype. Frozen params are never touched.

The update runs in place on the param tensors (no second copy of the
trainable tree). Mixed precision is opt-in: `init(params, masters)` takes
fp32 masters of trained params held in a narrower dtype (the Trainer's
compute_dtype). Such a param's gradient is widened to fp32, the update
above runs on its master (fp32 moments, so no update is lost below the
narrow dtype's half ulp), and the param is set to the master rounded to
its dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


@dataclass
class OptimizerConfig:
    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = None
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    total_steps: int = 10000
    schedule: str = "cosine"          # "cosine" | "constant" | "linear"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    tune_mm_mlp_adapter: bool = False  # pretrain: projector-only
    freeze_backbone: bool = False
    lora_enable: bool = False          # train adapters only (+ projector)


Path = Tuple[str, ...]


def flatten(tree: dict, prefix: Path = ()) -> Dict[Path, torch.Tensor]:
    """{path: leaf} of a nested dict, in insertion order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule (polynomial, power 1), in fp32."""
    if steps <= 0:
        return lambda count: np.float32(init)

    def schedule(count):
        c = np.float32(min(max(count, 0), steps))
        frac = np.float32(1) - c / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)
    return schedule


def _cosine(init: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule with alpha 0 and exponent 1, in fp32."""
    if decay_steps <= 0:
        raise ValueError("cosine decay needs positive decay_steps")

    def schedule(count):
        c = np.float32(min(count, decay_steps))
        cos = np.float32(np.cos(np.float32(np.pi) * c
                                / np.float32(decay_steps)))
        return np.float32(init) * (np.float32(0.5) * (np.float32(1) + cos))
    return schedule


def _join(schedules, boundaries) -> Callable[[int], float]:
    """optax.join_schedules: schedule i+1 counts from its boundary."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out
    return schedule


def _schedule(base_lr: float, cfg: OptimizerConfig) -> Callable[[int], float]:
    """The learning rate at an optimizer count (JAX `_schedule`)."""
    warmup = max(int(cfg.warmup_ratio * cfg.total_steps), 0)
    if cfg.schedule == "cosine":
        decay = max(cfg.total_steps, warmup + 1)
        return _join([_linear(0.0, base_lr, warmup),
                      _cosine(base_lr, decay - warmup)], [warmup])
    if cfg.schedule == "linear":
        return _join([_linear(0.0, base_lr, warmup),
                      _linear(base_lr, 0.0, cfg.total_steps - warmup)],
                     [warmup])
    return _join([_linear(0.0, base_lr, warmup),
                  lambda count: np.float32(base_lr)], [warmup])


def _decay_mask(params: dict) -> Dict[Path, bool]:
    """Weight decay for params with ndim > 1 only (no norms or biases)."""
    return {p: t.dim() > 1 for p, t in flatten(params).items()}


def _is_adapter(path: Path) -> bool:
    """A LoRA adapter's trained matrix: a, b, or a block of the fused qkv
    adapter's b (train/lora.py); not its scale s."""
    if "lora" not in path:
        return False
    return path[path.index("lora") + 1] in ("a", "b")


def param_labels(params: dict, lora_enable: bool = False
                 ) -> Dict[Path, str]:
    """{path: "frozen" | "projector" | "llm"} (JAX `param_labels`): the
    vision tower and integer (quantized) leaves are frozen and the
    connector is the projector. Under lora_enable only the adapters' a and
    b are "llm" and every other LLM leaf is frozen; without it the LLM is
    "llm" but for the adapters' scales s (alpha / r, a constant)."""

    def label(path, leaf):
        if path[0] == "vision":
            return "frozen"
        if path[0] == "connector":
            return "projector"
        if not leaf.is_floating_point():
            return "frozen"
        if lora_enable:
            return "llm" if _is_adapter(path) else "frozen"
        if "lora" in path and path[-1] == "s":
            return "frozen"
        return "llm"
    return {p: label(p, t) for p, t in flatten(params).items()}


def trainable_mask(params: dict, cfg: OptimizerConfig) -> Dict[Path, bool]:
    """{path: True where gradients are needed}, mirroring the labels."""
    frozen_llm = cfg.tune_mm_mlp_adapter or cfg.freeze_backbone
    return {p: lb == "projector" or (lb == "llm" and not frozen_llm)
            for p, lb in param_labels(params, cfg.lora_enable).items()}


class GroupedAdamW:
    """optax.multi_transform of clip_by_global_norm + adamw per trained
    group, set_to_zero for the frozen ones (see the module docstring)."""

    def __init__(self, params: dict, cfg: OptimizerConfig):
        self.cfg = cfg
        labels = param_labels(params, cfg.lora_enable)
        frozen_llm = cfg.tune_mm_mlp_adapter or cfg.freeze_backbone
        lrs = {"projector": cfg.mm_projector_lr or cfg.learning_rate,
               "llm": None if frozen_llm else cfg.learning_rate}
        self.groups = {
            g: [p for p, lb in labels.items() if lb == g]
            for g, lr in lrs.items() if lr is not None}
        self.schedules = {g: _schedule(lrs[g], cfg) for g in self.groups}
        self.decay = _decay_mask(params)

    def init(self, params: dict,
             masters: Optional[Dict[Path, torch.Tensor]] = None) -> dict:
        """{"count": {group: 0}, "mu"/"nu": {path: zeros in the dtype of
        the path's master, else of p}, "master": {path: fp32 master}}."""
        flat = flatten(params)
        paths = [p for ps in self.groups.values() for p in ps]
        masters = dict(masters or {})
        stray = sorted(set(masters) - set(paths))
        if stray:
            raise ValueError(f"masters for untrained params: {stray[:5]}")
        for p, m in masters.items():
            if m.dtype != torch.float32 or m.shape != flat[p].shape:
                raise ValueError(f"{'/'.join(p)}: a master must be fp32 of "
                                 f"the param's shape, got {m.dtype} "
                                 f"{tuple(m.shape)}")
        ref = {p: masters.get(p, flat[p]) for p in paths}
        return {"count": dict.fromkeys(self.groups, 0),
                "mu": {p: torch.zeros_like(ref[p]) for p in paths},
                "nu": {p: torch.zeros_like(ref[p]) for p in paths},
                "master": masters}

    @torch.no_grad()
    def step(self, params: dict, grads: Dict[Path, torch.Tensor],
             state: dict, layout=None) -> dict:
        """Apply one update to `params` in place from {path: gradient} (the
        trained paths); returns the new state. With a layout
        (parallel/sharding.Layout) params and gradients are this rank's
        shards and the clip takes the global norm: each rank's share of
        the squared norm, summed over the mesh."""
        cfg = self.cfg
        flat = flatten(params)
        masters = state.get("master", {})
        for group, paths in self.groups.items():
            count = state["count"][group]
            if not paths:  # a group without params (the identity connector)
                state["count"][group] = count + 1
                continue
            gs = [grads[p].float() if p in masters else grads[p]
                  for p in paths]
            if layout is None:
                sq = sum(torch.sum(g.float() ** 2) for g in gs)
            else:
                sq = layout.all_reduce_sum(torch.as_tensor(sum(
                    layout.sq_norm("/".join(p), g, entry_of(params, p))
                    for p, g in zip(paths, gs)), dtype=torch.float32,
                    device=gs[0].device if gs else None))
            g_norm = torch.sqrt(sq)
            if not bool(g_norm < cfg.max_grad_norm):
                gs = [(g / g_norm.to(g.dtype)) * cfg.max_grad_norm
                      for g in gs]
            count_inc = count + 1
            bc1 = 1 - np.float32(cfg.b1) ** np.float32(count_inc)
            bc2 = 1 - np.float32(cfg.b2) ** np.float32(count_inc)
            step_size = -self.schedules[group](count)
            for p, g in zip(paths, gs):
                mu = (1 - cfg.b1) * g + cfg.b1 * state["mu"][p]
                nu = (1 - cfg.b2) * (g ** 2) + cfg.b2 * state["nu"][p]
                state["mu"][p], state["nu"][p] = mu, nu
                u = (mu / torch.tensor(bc1, dtype=mu.dtype)) / (
                    torch.sqrt(nu / torch.tensor(bc2, dtype=nu.dtype))
                    + cfg.eps)
                param = masters.get(p, flat[p])
                if self.decay[p] and cfg.weight_decay:
                    u = u + cfg.weight_decay * param
                u = torch.tensor(step_size, dtype=u.dtype) * u
                param.copy_((param + u).to(param.dtype))
                if p in masters:
                    flat[p].copy_(param)
            state["count"][group] = count_inc
        return state


def entry_of(tree: dict, path: Path) -> dict:
    """The dict that holds the leaf at path."""
    for k in path[:-1]:
        tree = tree[k]
    return tree


def set_path(tree: dict, path: Path, value) -> None:
    """tree[path[0]]...[path[-1]] = value, making the dicts on the way."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def build_optimizer(params: dict, cfg: OptimizerConfig) -> GroupedAdamW:
    return GroupedAdamW(params, cfg)
