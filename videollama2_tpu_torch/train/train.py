"""Training entry point (port of videollama2_tpu/train/train.py).

Parity: reference videollama2/train.py:393-574. Every flag of the JAX
entry point is accepted, so the recipes' lines (scripts/vllava/*.sh,
scripts/custom/*.sh) run with the module name changed. Launch:

  python -m videollama2_tpu_torch.train.train \\
    --model_type videollama2_mistral --model_path LLM_DIR \\
    --vision_tower CLIP_DIR \\
    --data_path anno.json --data_folder media/ \\
    --output_dir out/ --tune_mm_mlp_adapter true ...

The checkpoint branches are JAX's: a full VideoLLaMA2 directory loads
through checkpoint/convert_hf.load_videollama2; a plain LLM directory
(the pretrain stage's Mistral or Qwen2) gets a fresh seeded connector.
Then --num_frames, --bits 4/8 (ops/quant packs of the LLM, the QLoRA base),
--lora_enable (train/lora.inject_lora), --pretrain_mm_mlp_adapter (a
directory holding mm_projector.npz, the Trainer's adapter-{step}/, or
mm_projector.bin), the dataset, the optimizer and the Trainer.

Differences from JAX:
  - the tokenizer: --model_path's own tokenizer files, read by the port's
    plain-Python reader (multimodal/hf_tokenizer.py), as JAX's
    AutoTokenizer.from_pretrained(model_path) reads them; an optional
    `--tokenizer module:callable` (inference/api.load_tokenizer, called
    with --model_path) takes their place, as in the serving entry points;
  - the mesh (--mesh_data, --mesh_fsdp, --mesh_tensor, --mesh_seq) spans
    one process a card, as the reference launches under torchrun
    (scripts/vllava/pretrain.sh):

      python -m torch.distributed.run --nproc_per_node 4 \
        -m videollama2_tpu_torch.train.train --mesh_fsdp 4 ...

    joins the process group torchrun describes (parallel/mesh.
    init_distributed: NCCL, or gloo with --device cpu) and trains on a
    mesh over its ranks (train/trainer.py); a plain `python -m ...` is a
    one-rank run with no process group, where a degree above one raises;
  - --device: "cuda" by default; nothing runs on the CPU unless asked;
  - --vision_tower is read: in the plain-LLM branch the tower (and its
    widths, from its config.json) comes from that local directory, and a
    name that is not one (a hub id) raises: nothing is downloaded. JAX
    parses the flag and never reads it, so its pretrain stage trains a
    projector over a random tower; without the flag the port does the
    same, with a warning;
  - in the plain-LLM branch the LLM's widths and depth come from the
    directory's config.json (JAX takes the preset's);
  - --bf16 (the default, and the recipes') runs the model in bf16 on the
    device (the Trainer's compute_dtype): the frozen weights are held in
    bf16, each trained one in bf16 beside an fp32 master with fp32 Adam
    moments, which the saves write; LoRA adapters stay fp32. JAX keeps
    every weight fp32 as loaded and casts only the frames.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import warnings
from typing import Optional, Sequence

import torch

def parse_bool(x: str) -> bool:
    return str(x).lower() in ("1", "true", "yes")


def build_argparser() -> argparse.ArgumentParser:
    from ..inference.api import add_model_flags

    ap = argparse.ArgumentParser()
    # ModelArguments (train.py:70-84)
    ap.add_argument("--model_type", default="videollama2_mistral")
    ap.add_argument("--model_path", required=True,
                    help="HF checkpoint dir (LLM or full videollama2)")
    ap.add_argument("--version", default="v1")
    ap.add_argument("--freeze_backbone", type=parse_bool, default=False)
    ap.add_argument("--mm_projector_type", default="stc_connector")
    ap.add_argument("--tune_mm_mlp_adapter", type=parse_bool, default=False)
    ap.add_argument("--pretrain_mm_mlp_adapter", default=None)
    ap.add_argument("--vision_tower", default=None)
    ap.add_argument("--mm_vision_select_layer", type=int, default=-2)
    ap.add_argument("--mm_vision_select_feature", default="patch")
    # DataArguments (train.py:87-99)
    ap.add_argument("--data_path", nargs="+", required=True)
    ap.add_argument("--data_folder", default=None)
    ap.add_argument("--num_frames", type=int, default=None)
    ap.add_argument("--image_aspect_ratio", default="pad")
    ap.add_argument("--is_pretraining", type=parse_bool, default=None,
                    help="defaults to tune_mm_mlp_adapter")
    # TrainingArguments (train.py:102-134)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--num_train_epochs", type=int, default=1)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--per_device_train_batch_size", type=int, default=4)
    ap.add_argument("--gradient_accumulation_steps", type=int, default=1)
    ap.add_argument("--learning_rate", type=float, default=2e-5)
    ap.add_argument("--mm_projector_lr", type=float, default=None)
    ap.add_argument("--weight_decay", type=float, default=0.0)
    ap.add_argument("--warmup_ratio", type=float, default=0.03)
    ap.add_argument("--lr_scheduler_type", default="cosine")
    ap.add_argument("--model_max_length", type=int, default=2048)
    ap.add_argument("--save_steps", type=int, default=500)
    ap.add_argument("--logging_steps", type=int, default=10)
    ap.add_argument("--group_by_modality_length", type=parse_bool,
                    default=False)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--bf16", type=parse_bool, default=True)
    # LoRA (train.py:125-133)
    ap.add_argument("--lora_enable", type=parse_bool, default=False)
    ap.add_argument("--lora_r", type=int, default=128)
    ap.add_argument("--lora_alpha", type=int, default=256)
    ap.add_argument("--lora_dropout", type=float, default=0.05)
    ap.add_argument("--bits", type=int, default=16)
    # mesh (one process a card under torchrun, see check_mesh)
    ap.add_argument("--mesh_data", type=int, default=1)
    ap.add_argument("--mesh_fsdp", type=int, default=-1)
    ap.add_argument("--mesh_tensor", type=int, default=1)
    ap.add_argument("--mesh_seq", type=int, default=1,
                    help="Ulysses sequence-parallel degree (long context)")
    # the port's own
    add_model_flags(ap)
    return ap


def check_mesh(args) -> bool:
    """Whether the run spans a process group: torchrun's (WORLD_SIZE in
    the environment). Without one every mesh degree must be 1 (-1, JAX's
    "the rest of the devices", is one device here)."""
    if "WORLD_SIZE" in os.environ:
        return True
    over = [f"--{n} {getattr(args, n)}" for n in
            ("mesh_data", "mesh_tensor", "mesh_seq")
            if getattr(args, n) > 1]
    if args.mesh_fsdp not in (1, -1):
        over.append(f"--mesh_fsdp {args.mesh_fsdp}")
    if over:
        raise ValueError(
            f"{', '.join(over)}: a mesh of more than one device runs one "
            "process a card: launch under torchrun (python -m "
            "torch.distributed.run --nproc_per_node N -m "
            "videollama2_tpu_torch.train.train ...)")
    return False


def _tower_config(vision, tower_dir: str):
    """The preset's tower config with the widths of the HF config.json in
    `tower_dir` (a CLIPVisionConfig / SiglipVisionConfig, or a full
    CLIPConfig's vision_config), when there is one."""
    path = os.path.join(tower_dir, "config.json")
    if not os.path.exists(path):
        return vision
    with open(path) as f:
        cj = json.load(f)
    cj = cj.get("vision_config", cj)
    fields = dict(hidden_size="hidden_size",
                  intermediate_size="intermediate_size",
                  num_layers="num_hidden_layers",
                  num_heads="num_attention_heads", image_size="image_size",
                  patch_size="patch_size", hidden_act="hidden_act",
                  layer_norm_eps="layer_norm_eps")
    return dataclasses.replace(vision, **{k: cj[v] for k, v in fields.items()
                                          if v in cj})


def load_model(args):
    """(ModelConfig, params in the JAX layout: torch tensors on the CPU)
    from --model_path, as JAX's branches do (see the module docstring)."""
    from ..checkpoint import convert_hf
    from ..core import config as cfglib
    from ..utils.synthetic import (synthetic_connector_params,
                                   synthetic_vision_params)

    cfg_path = os.path.join(args.model_path, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(args.model_path)
    with open(cfg_path) as f:
        cfg_json = json.load(f)
    if cfg_json.get("model_type", "").startswith("videollama2") or \
            "mm_vision_tower" in cfg_json:
        return convert_hf.load_videollama2(args.model_path)
    # a plain LLM checkpoint + a fresh connector (train.py:425-446 and
    # initialize_vision_modules :496)
    cfg = cfglib.preset(args.model_type)
    llm_cfg = dataclasses.replace(
        convert_hf.model_config_from_hf(cfg_json).llm,
        model_type=cfg.llm.model_type, qkv_bias=cfg.llm.qkv_bias)
    vision = dataclasses.replace(cfg.vision,
                                 select_layer=args.mm_vision_select_layer)
    if args.vision_tower:
        if not os.path.isdir(args.vision_tower):
            raise FileNotFoundError(
                f"--vision_tower {args.vision_tower!r} is not a local "
                "directory: the port downloads nothing; pass the tower's "
                "HF directory (config.json and weights)")
        vision = _tower_config(vision, args.vision_tower)
        tower = convert_hf.vision_params_from_state_dict(
            convert_hf.load_state_dict_from_dir(args.vision_tower), vision,
            prefix="vision_model.")
    else:
        warnings.warn("no --vision_tower: the tower is randomly initialized "
                      "(as the JAX package does); pass the tower's HF "
                      "directory")
        tower = synthetic_vision_params(vision, dtype=torch.float32,
                                        device="cpu", seed=args.seed)
    cfg = dataclasses.replace(
        cfg, llm=llm_cfg, vision=vision,
        connector=dataclasses.replace(
            cfg.connector, projector_type=args.mm_projector_type,
            mm_hidden_size=vision.hidden_size,
            hidden_size=llm_cfg.hidden_size))
    params = {
        "llm": convert_hf.llm_params_from_state_dict(
            convert_hf.load_state_dict_from_dir(args.model_path), llm_cfg),
        "vision": tower,
        "connector": synthetic_connector_params(cfg.connector,
                                                seed=args.seed),
    }
    return cfg, params


def _to_device(tree: dict, device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict)
            else v.to(device) for k, v in tree.items()}


def main(argv: Optional[Sequence[str]] = None):
    """Run the training the flags describe; returns the Trainer."""
    args = build_argparser().parse_args(argv)
    distributed = check_mesh(args)

    from ..checkpoint import convert_hf, projector_io
    from ..checkpoint.from_jax import params_from_jax
    from ..inference.api import _quantize_on_device, load_tokenizer
    from ..inference.engine import check_device
    from . import data as data_lib
    from . import lora as lora_lib
    from . import optimizer as opt_lib
    from .trainer import Trainer, TrainerConfig

    if distributed:
        from ..parallel.mesh import init_distributed
        device = init_distributed(args.device)
    else:
        device = check_device(args.device)
    tokenizer = load_tokenizer(args.tokenizer, args.model_path)
    if getattr(tokenizer, "pad_token", "") is None \
            and getattr(tokenizer, "unk_token", None) is not None:
        tokenizer.pad_token = tokenizer.unk_token

    # 1. model config + params
    cfg, tree = load_model(args)
    if args.num_frames:
        cfg = cfg.replace(num_frames=args.num_frames)
    if args.pretrain_mm_mlp_adapter:
        # the pretrain stage's projector (videollama2_arch.py:77-96)
        if os.path.exists(os.path.join(args.pretrain_mm_mlp_adapter,
                                       "mm_projector.npz")):
            tree["connector"] = projector_io.load_projector_only(
                args.pretrain_mm_mlp_adapter, tree["connector"])
        else:
            tree["connector"] = convert_hf.load_pretrain_adapter(
                args.pretrain_mm_mlp_adapter, cfg.connector)
    # under a mesh the Trainer takes each rank's shards to its card from
    # the host tree, unless the base is quantized or injected there first
    on_card = not distributed or args.bits != 16 or args.lora_enable
    params = params_from_jax(tree, cfg)
    if on_card:
        params = _to_device(params, device)
    del tree
    # QLoRA / quantized-base training (reference train.py:404-423): the LLM
    # base frozen in int8 or folded int4 packs, made from fp32 on the device
    if args.bits in (4, 8):
        _quantize_on_device(params, device, bits=args.bits, vision=False)
    elif args.bits != 16:
        raise ValueError(f"--bits must be 4, 8 or 16, got {args.bits}")
    # LoRA (reference train.py:465-481): adapters in the LLM's projections
    if args.lora_enable:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params["llm"] = lora_lib.inject_lora(
            gen, params["llm"],
            lora_lib.LoraConfig(r=args.lora_r, alpha=args.lora_alpha,
                                dropout=args.lora_dropout), cfg.llm)

    # 2. data
    is_pre = (args.is_pretraining if args.is_pretraining is not None
              else args.tune_mm_mlp_adapter)
    data_args = data_lib.DataArguments(
        data_path=args.data_path, data_folder=args.data_folder,
        is_pretraining=is_pre, num_frames=args.num_frames,
        image_aspect_ratio=args.image_aspect_ratio,
        model_max_length=args.model_max_length)
    dataset = data_lib.SupervisedDataset(args.data_path, tokenizer,
                                         data_args, cfg, seed=args.seed)

    # 3. optimizer + trainer
    opt_cfg = opt_lib.OptimizerConfig(
        learning_rate=args.learning_rate,
        mm_projector_lr=args.mm_projector_lr,
        weight_decay=args.weight_decay, warmup_ratio=args.warmup_ratio,
        schedule=args.lr_scheduler_type,
        tune_mm_mlp_adapter=args.tune_mm_mlp_adapter,
        freeze_backbone=args.freeze_backbone,
        lora_enable=args.lora_enable)
    tcfg = TrainerConfig(
        output_dir=args.output_dir,
        per_device_batch_size=args.per_device_train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        num_epochs=args.num_train_epochs, max_steps=args.max_steps,
        seq_len=args.model_max_length, save_steps=args.save_steps,
        log_steps=args.logging_steps, seed=args.seed,
        group_by_modality_length=args.group_by_modality_length,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        mesh_data=args.mesh_data, mesh_fsdp=args.mesh_fsdp,
        mesh_tensor=args.mesh_tensor, mesh_seq=args.mesh_seq)
    trainer = Trainer(cfg, params, opt_cfg, tcfg, device=device,
                      dataset=dataset)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
