"""The projector types of the port beyond the connector and the Engine
(tests/test_torch_projectors.py) against the JAX package on the CPU in
fp32: model_init of tiny checkpoints in the reference's key layout whose
config.json names mlp2x_gelu and stp_connector; the stage-1 loss (1e-5
relative) and connector gradients (1e-4) of every type, and a stage-1
Trainer step (identity trains nothing); a world-1 sharded step over
mlp2x_gelu, bit-equal to the unsharded one; and train/train.py with
--mm_projector_type over a shared --pretrain_mm_mlp_adapter against JAX's
main()."""

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import videollama2_tpu
import videollama2_tpu_torch
from test_torch_projectors import (NEW_TOKENS, TYPES, _assert_same_tree,
                                   _flat, _params, _videos)
from videollama2_tpu.checkpoint import convert_hf as jconv
from videollama2_tpu.constants import IGNORE_INDEX, VIDEO_TOKEN_INDEX
from videollama2_tpu.core import config as cfglib
from videollama2_tpu.models import connector as jconn
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.train import data as jdata
from videollama2_tpu_torch.checkpoint import convert_hf as tconv
from videollama2_tpu_torch.checkpoint import projector_io
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.train import data as tdata
from videollama2_tpu_torch.train import optimizer as topt
from videollama2_tpu_torch.train import step as tstep
from videollama2_tpu_torch.train.trainer import Trainer, TrainerConfig

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SEQ = 64


# -- model_init of tiny checkpoints ----------------------------------------------

@pytest.fixture(scope="module")
def base_ckpt(tmp_path_factory):
    from make_tiny_checkpoint import build_checkpoint
    return build_checkpoint(str(tmp_path_factory.mktemp("ckpt")))


def _checkpoint_of(base, pt, out):
    """The tiny checkpoint with its projector replaced by a pt projector
    (JAX's init, in the reference's key layout) and config.json naming
    pt."""
    from safetensors.numpy import load_file, save_file
    cfg, jp, tp = _params(pt)
    shutil.copytree(base, out)
    sd = {k: v for k, v in load_file(os.path.join(
        out, "model.safetensors")).items()
        if not k.startswith("model.mm_projector.")}
    sd.update({k: v.numpy() for k, v in projector_io._projector_state_dict(
        tp["connector"], "model.mm_projector.", pt).items()})
    save_file(sd, os.path.join(out, "model.safetensors"))
    with open(os.path.join(out, "config.json")) as f:
        cj = json.load(f)
    cj["mm_projector_type"] = pt
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(cj, f)
    return out


@pytest.mark.parametrize("pt", ["mlp2x_gelu", "stp_connector"])
def test_model_init_of_a_checkpoint_matches_jax(base_ckpt, tmp_path, pt):
    """load_videollama2 gives JAX's tree leaf for leaf, and model_init +
    mm_infer the JAX model_init's tokens."""
    from transformers import AutoTokenizer
    ckpt = _checkpoint_of(base_ckpt, pt, str(tmp_path / pt))
    jcfg, jtree = jconv.load_videollama2(ckpt)
    tcfg, ttree = tconv.load_videollama2(ckpt)
    assert tcfg.connector.projector_type == pt
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    _assert_same_tree(ttree, jtree)
    frames = _videos(tcfg)[0]
    streams = {}
    for name, pkg, kw in (
            ("jax", videollama2_tpu, dict(dtype=jnp.float32,
                                          attn_impl="xla")),
            ("port", videollama2_tpu_torch, dict(
                dtype=torch.float32, device="cpu",
                tokenizer=AutoTokenizer.from_pretrained(ckpt)))):
        model, _, tok = pkg.model_init(ckpt, max_len=256, buckets=(128,),
                                       **kw)
        pkg.mm_infer(frames, "What happens in the video ?", model, tok,
                     modal="video", max_new_tokens=NEW_TOKENS,
                     stream_cb=lambda b, toks, name=name:
                     streams.__setitem__(name, list(toks)))
    assert streams["port"] == streams["jax"] and streams["port"]


# -- training ------------------------------------------------------------------

def _batch(cfg, n=2, seed=1):
    rng = np.random.default_rng(seed)
    H, T = cfg.vision.image_size, cfg.num_frames
    insts = []
    for i in range(n):
        text = [int(x) for x in rng.integers(3, cfg.llm.vocab_size,
                                             10 + 7 * i)]
        insts.append({"input_ids": [1, VIDEO_TOKEN_INDEX] + text,
                      "labels": [IGNORE_INDEX, IGNORE_INDEX] + text,
                      "frames": rng.standard_normal((T, H, H, 3)).astype(
                          np.float32)})
    return tdata.Collator(cfg, SEQ)(insts)


@pytest.mark.parametrize("pt", TYPES)
def test_stage1_loss_and_connector_grads_match_jax(pt, tmp_path):
    """forward_train's loss (1e-5 relative) and the connector's gradients
    (1e-4) against JAX's; identity has no connector params, and a
    stage-1 (tune_mm_mlp_adapter) Trainer step then trains nothing."""
    cfg, jp, tp = _params(pt)
    batch = _batch(cfg)
    jb = jdata.Batch(*(jnp.asarray(a) for a in batch))

    def loss_of(conn):
        return jvl2.forward_train({**jp, "connector": conn}, cfg, jb.frames,
                                  jb.text_ids, jb.is_visual, jb.vis_index,
                                  jb.positions, jb.valid_len, jb.labels)
    (jl, _), jg = jax.value_and_grad(loss_of, has_aux=True)(
        jax.tree.map(jnp.asarray, jp["connector"]))
    jg = dict(_flat(jg))
    conn = topt.flatten(tp["connector"])
    for t in conn.values():
        t.requires_grad_(True)
    loss, _ = tstep.loss_fn(tp, cfg, batch)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    assert sorted(conn) == sorted(jg)
    if conn:
        loss.backward()
    for p, t in conn.items():
        g = np.asarray(jg[p])
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(g).max(),
                                   err_msg="/".join(p))
        t.requires_grad_(False)
        t.grad = None
    params = params_from_jax(jp, cfg)
    before = {p: t.clone() for p, t in topt.flatten(params).items()}
    trainer = Trainer(cfg, params, topt.OptimizerConfig(
        learning_rate=1e-3, warmup_ratio=0.0, tune_mm_mlp_adapter=True),
        TrainerConfig(output_dir=str(tmp_path), max_steps=1, log_steps=1,
                      save_steps=10 ** 9), device="cpu")
    trainer.train(iter([batch]))
    after = topt.flatten(trainer.state.params)
    moved = sorted(p for p, t in after.items()
                   if not torch.equal(t, before[p]))
    assert moved == sorted(("connector",) + p for p in conn)


def test_world1_sharded_stage1_step_over_mlp(tmp_path):
    """A stage-1 Trainer step over mlp2x_gelu on a world-1 mesh (a
    one-rank gloo group): the top-level fc* have no sharding rule in
    either package (replicated, passed through by gather_tree), and the
    step is bit-equal to the unsharded one, whose loss is JAX's."""
    import torch.distributed as dist
    from videollama2_tpu.parallel import sharding as jsh
    from videollama2_tpu_torch.parallel import mesh as mesh_lib
    from videollama2_tpu_torch.parallel import sharding as sh

    cfg, jp, tp = _params("mlp2x_gelu")
    for path, spec in sh.param_specs({"connector": tp["connector"]}).items():
        assert spec == (None, None)[:len(spec)] == tuple(jsh.spec_for(
            path, len(spec), False)) + (None,) * (len(spec) - len(
                jsh.spec_for(path, len(spec), False))), path
    batch = _batch(cfg, seed=2)

    def step(name, **mesh):
        out = str(tmp_path / name)
        trainer = Trainer(cfg, params_from_jax(jp, cfg), topt.OptimizerConfig(
            learning_rate=1e-3, warmup_ratio=0.0, tune_mm_mlp_adapter=True),
            TrainerConfig(output_dir=out, max_steps=1, log_steps=1,
                          save_steps=10 ** 9, **mesh), device="cpu")
        trainer.train(iter([batch]))
        with open(os.path.join(out, "train_log.jsonl")) as f:
            loss = json.loads(f.readline())["loss"]
        return trainer, loss

    plain, plain_loss = step("plain")
    mesh_lib.init_distributed("cpu")
    try:
        sharded, loss = step("mesh", mesh_data=1, mesh_fsdp=1,
                             mesh_tensor=1, mesh_seq=1)
        assert sharded.mesh is not None and sharded.layout is not None
        gathered = sh.gather_tree(sharded.mesh, sharded.state.params[
            "connector"], "connector")
    finally:
        dist.destroy_process_group()
    assert loss == plain_loss
    jb = jdata.Batch(*(jnp.asarray(a) for a in batch))
    jl, _ = jvl2.forward_train(jp, cfg, jb.frames, jb.text_ids, jb.is_visual,
                               jb.vis_index, jb.positions, jb.valid_len,
                               jb.labels)
    np.testing.assert_allclose(loss, float(jl), rtol=LOSS_RTOL)
    want = topt.flatten(plain.state.params)
    for p, t in topt.flatten(sharded.state.params).items():
        assert torch.equal(t, want[p]), p
    for p, t in topt.flatten(gathered).items():
        assert torch.equal(t, want[("connector",) + p]), p
    moved = [p for p, t in topt.flatten(tp["connector"]).items()
             if not torch.equal(t, want[("connector",) + p])]
    assert sorted(moved) == sorted(topt.flatten(tp["connector"]))


# -- train/train.py -------------------------------------------------------------

from test_torch_train_entry import (_flags, _losses, _plain_dirs,  # noqa
                                    _run_jax, _run_port, corpus, one_device)


@pytest.mark.parametrize("pt,stage", [("mlp2x_gelu", 1),
                                      ("stp_connector", 2)])
def test_train_main_over_a_shared_adapter_matches_jax(
        pt, stage, base_ckpt, corpus, tmp_path, monkeypatch, one_device):
    """`train.py --mm_projector_type pt --pretrain_mm_mlp_adapter DIR` on
    a plain LLM directory and a tower directory, DIR holding the port's
    mm_projector.bin, which both packages read: the first step's loss
    equals JAX's main() (whose tower init is pinned to the same tower,
    and its preset cut to the tiny model), and the port's config names
    the type."""
    from videollama2_tpu.checkpoint import convert_hf as jconv_
    from videollama2_tpu.models import vit as jvit
    llm_dir, tower_dir = _plain_dirs(base_ckpt, str(tmp_path))

    def tiny4(name):  # the presets' connector depth, the reference's 4
        cfg = cfglib.tiny_model(name)
        return cfg.replace(connector=dataclasses.replace(
            cfg.connector, projector_type=pt, depth=4))
    cfg = tiny4("videollama2_mistral")
    conn = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                        jconn.init_params(jax.random.PRNGKey(1),
                                          cfg.connector))
    adapter = tmp_path / "adapter"
    adapter.mkdir()
    projector_io.export_hf_projector_bin(str(adapter / "mm_projector.bin"),
                                         conn, cfg)
    extra = ["--mm_projector_type", pt, "--pretrain_mm_mlp_adapter",
             str(adapter)]
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    trainer = _run_port(_flags(llm_dir, corpus, t, stage) + extra
                        + ["--vision_tower", tower_dir])
    assert dataclasses.asdict(trainer.model_cfg.connector) == \
        dataclasses.asdict(cfg.connector)
    tower = jconv_.vision_params_from_state_dict(
        jconv_.load_state_dict_from_dir(tower_dir), cfg.vision,
        prefix="vision_model.")
    monkeypatch.setattr(jvit, "init_params", lambda rng, vcfg: tower)
    monkeypatch.setattr(cfglib, "preset", tiny4)
    _run_jax(monkeypatch, _flags(llm_dir, corpus, j, stage) + extra)
    np.testing.assert_allclose(_losses(t), _losses(j), rtol=LOSS_RTOL)
