"""The ranks of tests/test_torch_parallel.py: one spawned process a rank,
gloo on the CPU, joined through a FileStore. Imports torch and the port
only (no JAX). Each rank runs every case of CASES in order on the inputs
the test wrote (inputs.pt) and writes what it got (rank{r}.pt); the
test compares. A case that raises records its traceback; the others wait
on its collectives until the group's timeout and fail too."""

from __future__ import annotations

import datetime
import os
import traceback

import torch
import torch.distributed as dist

from videollama2_tpu_torch.checkpoint import train_state
from videollama2_tpu_torch.inference.engine import Engine, GenerationConfig
from videollama2_tpu_torch.parallel import mesh as mesh_lib
from videollama2_tpu_torch.parallel import sharding as sh
from videollama2_tpu_torch.train import optimizer as topt
from videollama2_tpu_torch.train import step as tstep

TIMEOUT = datetime.timedelta(seconds=60)


def hf_tokenizer(path):
    """The --tokenizer factory of the torchrun test's ranks (transformers
    is on the test host, not in the port)."""
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(path)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def whole_params(state, layout) -> dict:
    """{path: the whole leaf} of a sharded state (every rank gathers)."""
    return {path: layout.unshard(path, t, entry).detach().clone()
            for path, entry, _, t in sh.walk(state.params)}


def sharded_step(inp, mesh, grad_accum=1, sequence_parallel=False,
                 model="dense"):
    """One sharded train step of the model's params on its batch: the
    metrics and every whole param after it."""
    cfg, params = inp[model]["cfg"], inp[model]["params"]
    ocfg = topt.OptimizerConfig(**inp["opt"])
    tx = topt.build_optimizer(params, ocfg)
    state = tstep.init_sharded_state(mesh, _clone(params), tx, cfg)
    fn = tstep.make_train_step(cfg, tx, topt.trainable_mask(params, ocfg),
                               grad_accum=grad_accum, mesh=mesh,
                               sequence_parallel=sequence_parallel)
    state, metrics = fn(state, sh.shard_batch(inp[model]["batch"], mesh,
                                              grad_accum))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": whole_params(state, sh.Layout(mesh, cfg))}


def engine_tokens(inp, mesh, model="dense"):
    """Greedy, speculative (k 3) and a continued session turn of a
    sharded Engine."""
    cfg, params = inp[model]["cfg"], inp[model]["params"]
    kw = dict(dtype=torch.float32, max_len=96, buckets=(32,),
              decode_chunk=4, device="cpu",
              shard_fn=lambda p: sh.shard_params(mesh, p, cfg))
    prompt = inp["prompt"]
    with mesh:
        eng = Engine(cfg, params, **kw)
    out = {"greedy": eng.generate([prompt], gen=GenerationConfig(
        max_new_tokens=6), eos_token_id=-1)[0],
        "speculative": eng.generate([prompt], gen=GenerationConfig(
            max_new_tokens=6, speculative_k=3), eos_token_id=-1)[0]}
    a1, sess = eng.generate([prompt], gen=GenerationConfig(max_new_tokens=4),
                            eos_token_id=-1, return_session=True)
    a2, _ = eng.generate_continue(sess, inp["turn"], gen=GenerationConfig(
        max_new_tokens=4), eos_token_id=-1)
    out["session"] = (a1[0], a2[0])
    return out


def resume(inp, rank):
    """On a 2-rank mesh (ranks 0 and 1, fsdp 2): resume the 1-rank save
    of step 1 and take step 2; then, fresh, take step 1 and save it."""
    mesh = mesh_lib.make_mesh(fsdp=2, devices=[0, 1])
    if not mesh.member:
        return None
    cfg, params = inp["dense"]["cfg"], inp["dense"]["params"]
    ocfg = topt.OptimizerConfig(**inp["opt"])
    tx = topt.build_optimizer(params, ocfg)
    layout = sh.Layout(mesh, cfg)
    fn = tstep.make_train_step(cfg, tx, topt.trainable_mask(params, ocfg),
                               mesh=mesh)
    state = tstep.init_sharded_state(mesh, _clone(params), tx, cfg)
    train_state.restore_train_state(inp["saved_1rank"], state, 1, layout)
    state, metrics = fn(state, sh.shard_batch(inp["dense"]["batch2"], mesh))
    out = {"step": state.step, "loss": float(metrics["loss"]),
           "params": whole_params(state, layout)}
    state = tstep.init_sharded_state(mesh, _clone(params), tx, cfg)
    state, _ = fn(state, sh.shard_batch(inp["dense"]["batch"], mesh))
    train_state.save_train_state(inp["save_2rank"], state, layout=layout)
    return out


CASES = {
    "step_dp2_fsdp2": lambda inp, r: sharded_step(
        inp, mesh_lib.make_mesh(data=2, fsdp=2)),
    "step_fsdp2_tp2": lambda inp, r: sharded_step(
        inp, mesh_lib.make_mesh(fsdp=2, tensor=2)),
    "step_fsdp2_sp2": lambda inp, r: sharded_step(
        inp, mesh_lib.make_mesh(fsdp=2, seq=2), sequence_parallel=True),
    "step_ga2_fsdp2_tp2": lambda inp, r: sharded_step(
        inp, mesh_lib.make_mesh(fsdp=2, tensor=2), grad_accum=2),
    "engine_tp4": lambda inp, r: engine_tokens(
        inp, mesh_lib.make_mesh(fsdp=1, tensor=4)),
    "engine_fsdp2_tp2": lambda inp, r: engine_tokens(
        inp, mesh_lib.make_mesh(fsdp=2, tensor=2)),
    "moe_step_dp2_ep2": lambda inp, r: sharded_step(
        inp, mesh_lib.make_mesh(data=2, expert=2), model="moe"),
    "moe_engine_ep2_tp2": lambda inp, r: engine_tokens(
        inp, mesh_lib.make_mesh(fsdp=1, tensor=2, expert=2), model="moe"),
    "resume": resume,
}


def run(rank: int, world: int, job_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(job_dir, "store"), world)
    mesh_lib.init_distributed("cpu", store=store, rank=rank,
                              world_size=world, timeout=TIMEOUT)
    inp = torch.load(os.path.join(job_dir, "inputs.pt"), weights_only=False)
    results = {}
    for name, case in CASES.items():
        try:
            results[name] = case(inp, rank)
        except Exception:                       # recorded for the test
            results[name] = {"error": traceback.format_exc()}
    torch.save(results, os.path.join(job_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
