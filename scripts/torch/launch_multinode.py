"""Per-node launcher of the PyTorch/CUDA port, under torchrun.

Run the SAME command on every node (one process a card):

    torchrun --nnodes 2 --nproc_per_node 8 --node_rank $NODE_RANK \\
        --master_addr $MASTER --master_port 16666 \\
        scripts/torch/launch_multinode.py --mesh_fsdp 8 --mesh_tensor 2 \\
        train -- --model_type videollama2_qwen2 --model_path ... --bits 8

    torchrun --nnodes 2 --nproc_per_node 8 ... scripts/torch/launch_multinode.py \\
        eval -- --module videollama2_tpu_torch.eval.inference_video_mcqa_videomme \\
        --model-path ... --answer-file out/16_${RANK}.json ...

Each rank joins the process group torchrun describes (parallel/mesh.
init_distributed: NCCL, its card LOCAL_RANK; gloo with --device cpu),
resolves the mesh against WORLD_SIZE with the rules and messages of
scripts/launch_multihost.py's resolve_mesh, and runs the task's main()
with the argv after `--`:
  - train: the resolved --mesh_* flags, then the task's own;
  - serve_worker: the task's own;
  - eval --module M: M's own, plus --device cuda:$LOCAL_RANK (cpu with
    --device cpu), and --num-chunks $WORLD_SIZE --chunk-idx $RANK where
    the caller gave neither: one chunk a card, as JAX's launcher gives one
    a host (--chunk-idx $SLICE_INDEX).

Port of scripts/launch_multihost.py, which starts jax.distributed (one
process a host) in place of the reference's torchrun multi-node launch
(scripts/vllava/pretrain.sh:36-44); here torchrun is back, and a rank with
no card raises: nothing falls back to the CPU unless --device cpu asks.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

TASKS = {
    "train": "videollama2_tpu_torch.train.train",
    "serve_worker": "videollama2_tpu_torch.serve.model_worker",
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Multi-node launcher: torchrun's group + mesh + task")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, card LOCAL_RANK) or cpu (gloo)")
    ap.add_argument("--mesh_data", type=int, default=1)
    ap.add_argument("--mesh_fsdp", type=int, default=-1)
    ap.add_argument("--mesh_tensor", type=int, default=1)
    ap.add_argument("--mesh_expert", type=int, default=1)
    ap.add_argument("--mesh_seq", type=int, default=1)
    ap.add_argument("task", choices=sorted(TASKS) + ["eval"])
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="-- followed by the task's own args")
    args = ap.parse_args(argv)
    if args.rest and args.rest[0] == "--":
        args.rest = args.rest[1:]
    return args


def resolve_mesh(args, n_devices: int):
    """Fill fsdp=-1 from the world size and validate the product (JAX's
    resolve_mesh, one device a rank)."""
    fixed = args.mesh_data * args.mesh_tensor * args.mesh_expert * \
        args.mesh_seq
    fsdp = args.mesh_fsdp
    if fsdp == -1:
        if n_devices % fixed:
            raise SystemExit(
                f"{n_devices} devices not divisible by "
                f"data*tensor*expert*seq={fixed}")
        fsdp = n_devices // fixed
    if fixed * fsdp != n_devices:
        raise SystemExit(
            f"mesh {args.mesh_data}x{fsdp}x{args.mesh_tensor}"
            f"x{args.mesh_expert}x{args.mesh_seq} != {n_devices} devices")
    return dict(data=args.mesh_data, fsdp=fsdp, tensor=args.mesh_tensor,
                expert=args.mesh_expert, seq=args.mesh_seq)


def task_argv(args, shape, rank: int, world: int, device) -> tuple:
    """(module name, its sys.argv) for the task."""
    if args.task != "eval":
        mesh_flags = [f"--mesh_{k}={v}" for k, v in shape.items()
                      if args.task == "train"]
        return TASKS[args.task], [TASKS[args.task]] + mesh_flags + args.rest
    # eval tasks name their driver module: --module pkg.mod [args...]
    ap = argparse.ArgumentParser()
    ap.add_argument("--module", required=True)
    mod_args, rest = ap.parse_known_args(args.rest)
    given = {a.split("=", 1)[0] for a in rest if a.startswith("--")}
    if "--device" in given:
        raise SystemExit("eval: the launcher gives each rank its card; pass "
                         "--device to the launcher, not to the module")
    extra = ["--device", str(device)]
    if not given & {"--num-chunks", "--chunk-idx"}:
        extra += ["--num-chunks", str(world), "--chunk-idx", str(rank)]
    return mod_args.module, [mod_args.module] + rest + extra


def main(argv=None):
    args = parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        raise SystemExit("launch_multinode.py runs under torchrun (python -m "
                         "torch.distributed.run ... scripts/torch/"
                         "launch_multinode.py ...), which sets RANK, "
                         "WORLD_SIZE, LOCAL_RANK and MASTER_ADDR")

    import torch.distributed as dist

    from videollama2_tpu_torch.parallel.mesh import init_distributed
    device = init_distributed(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    shape = resolve_mesh(args, world)
    print(f"[launch] rank {rank}/{world} (local rank "
          f"{os.environ.get('LOCAL_RANK', rank)}) on {device}, mesh {shape}",
          flush=True)
    name, sys.argv = task_argv(args, shape, rank, world, device)
    try:
        importlib.import_module(name).main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
