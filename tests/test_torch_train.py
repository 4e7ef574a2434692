"""The port's stage-1 training path against the JAX package on the tiny
VideoLLaMA2 (CLIP + STC + Mistral layout) in fp32 on the CPU: forward_train
and its metrics, the connector's gradients, the optimizer's schedules and
masks, the Collator, the Trainer and the projector-only save (whole train
steps: tests/test_torch_train_steps.py).

The same numpy params (JAX's init_params, the port fusing q/k/v) and
batches go through both packages. Tolerances: loss 1e-5 relative and
gradients 1e-4 (fp32, two summation orders).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videollama2_tpu.checkpoint import orbax_io as jorbax
from videollama2_tpu.constants import IGNORE_INDEX, VIDEO_TOKEN_INDEX
from videollama2_tpu.core import config as cfglib
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.train import data as jdata
from videollama2_tpu.train import optimizer as jopt
from videollama2_tpu.train import step as jstep
from videollama2_tpu_torch.checkpoint import projector_io
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.train import data as tdata
from videollama2_tpu_torch.train import optimizer as topt
from videollama2_tpu_torch.train import step as tstep
from videollama2_tpu_torch.train.trainer import Trainer, TrainerConfig

SEQ = 64


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_model()
    jparams = jax.tree.map(np.asarray,
                           jvl2.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, jparams


def _instances(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    H, T = cfg.vision.image_size, cfg.num_frames
    out = []
    for i in range(n):
        text = [int(x) for x in rng.integers(3, cfg.llm.vocab_size,
                                             10 + 7 * i)]
        ids = [1, VIDEO_TOKEN_INDEX] + text
        out.append({"input_ids": ids,
                    "labels": [IGNORE_INDEX, IGNORE_INDEX] + text,
                    "frames": rng.standard_normal((T, H, H, 3)).astype(
                        np.float32)})
    return out


def _tparams(cfg, jparams):
    return params_from_jax(jparams, cfg)


def _to_bf16(tree):
    return {k: _to_bf16(v) if isinstance(v, dict) else v.bfloat16()
            for k, v in tree.items()}


def _jax_view(tparams, jparams):
    """The port's tree as the JAX tree's {path: numpy} (the fused qkv split
    back into q, k, v along the output axis)."""
    flat = {p: t.detach().numpy() for p, t in topt.flatten(tparams).items()}
    out = {}
    for path, leaf in topt.flatten(jparams).items():
        if path in flat:
            out[path] = flat[path]
            continue
        i = next(j for j, n in enumerate(path) if n in ("q", "k", "v"))
        sizes = [_leaf(jparams, path[:i] + (n,) + path[i + 1:]).shape[-1]
                 for n in ("q", "k", "v")]
        start = sum(sizes[:("q", "k", "v").index(path[i])])
        fused = flat[path[:i] + ("qkv",) + path[i + 1:]]
        out[path] = fused[..., start:start + leaf.shape[-1]]
    return out


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jbatch(batch):
    return jdata.Batch(*(jnp.asarray(a) for a in batch))


def test_collator_matches_jax(tiny):
    cfg, _ = tiny
    insts = _instances(cfg)
    got = tdata.Collator(cfg, SEQ)(insts)
    want = jdata.Collator(cfg, SEQ)(insts)
    for name, a, b in zip(tdata.Batch._fields, got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _jax_loss(jparams, cfg, batch):
    b = _jbatch(batch)
    return jvl2.forward_train(jparams, cfg, b.frames, b.text_ids,
                              b.is_visual, b.vis_index, b.positions,
                              b.valid_len, b.labels)


@pytest.fixture(scope="module")
def jax_loss_and_grads(tiny):
    """JAX's loss, metrics and connector gradients on one batch."""
    cfg, jparams = tiny
    batch = tdata.Collator(cfg, SEQ)(_instances(cfg, seed=1))

    def loss_of(conn):
        return _jax_loss({**jparams, "connector": conn}, cfg, batch)
    (loss, metrics), grads = jax.value_and_grad(loss_of, has_aux=True)(
        jparams["connector"])
    return batch, float(loss), metrics, topt.flatten(
        jax.tree.map(np.asarray, grads))


def test_forward_train_matches_jax(tiny, jax_loss_and_grads):
    cfg, jparams = tiny
    batch, jl, jm, _ = jax_loss_and_grads
    with torch.no_grad():
        tl, tm = tstep.loss_fn(_tparams(cfg, jparams), cfg, batch)
    np.testing.assert_allclose(tl.item(), jl, rtol=1e-5)
    assert set(tm) == set(jm) == {"loss", "num_tokens", "accuracy"}
    assert int(tm["num_tokens"]) == int(jm["num_tokens"]) > 0
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)


def test_connector_grads_match_jax(tiny, jax_loss_and_grads):
    cfg, jparams = tiny
    batch, _, _, jgrads = jax_loss_and_grads
    tparams = _tparams(cfg, jparams)
    conn = topt.flatten(tparams["connector"])
    for t in conn.values():
        t.requires_grad_(True)
    loss, _ = tstep.loss_fn(tparams, cfg, batch)
    loss.backward()
    assert set(conn) == set(jgrads)
    for path, t in conn.items():
        np.testing.assert_allclose(t.grad.numpy(), jgrads[path], rtol=1e-4,
                                   atol=1e-4 * np.abs(jgrads[path]).max(),
                                   err_msg="/".join(path))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup_ratio", [0.0, 0.1])
def test_schedules_match_optax(schedule, warmup_ratio):
    kw = dict(schedule=schedule, warmup_ratio=warmup_ratio, total_steps=50)
    jsched = jopt._schedule(1e-3, jopt.OptimizerConfig(**kw))
    tsched = topt._schedule(1e-3, topt.OptimizerConfig(**kw))
    got = [float(tsched(c)) for c in range(55)]
    want = [float(jsched(jnp.asarray(c, jnp.int32))) for c in range(55)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_labels_and_masks_match_jax(tiny):
    cfg, jparams = tiny
    tparams = _tparams(cfg, jparams)
    for kw in (dict(tune_mm_mlp_adapter=True), {}, dict(freeze_backbone=True)):
        jmask = topt.flatten(jopt.trainable_mask(
            jparams, jopt.OptimizerConfig(**kw)))
        tmask = topt.trainable_mask(tparams, topt.OptimizerConfig(**kw))
        for path, flag in tmask.items():
            jpath = tuple("q" if n == "qkv" else n for n in path)
            assert bool(jmask[jpath]) == flag, path


def test_trainer_loss_decreases_and_logs(tiny, tmp_path):
    cfg, jparams = tiny
    batch = tdata.Collator(cfg, SEQ)(_instances(cfg, n=2, seed=3))
    ocfg = topt.OptimizerConfig(learning_rate=3e-3, warmup_ratio=0.0,
                                schedule="constant")
    out = str(tmp_path / "run")
    trainer = Trainer(cfg, _tparams(cfg, jparams), ocfg,
                      TrainerConfig(output_dir=out, max_steps=12,
                                    log_steps=1), device="cpu")
    state = trainer.train(iter([batch] * 20))
    assert state.step == 12
    with open(os.path.join(out, "train_log.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    losses = [m["loss"] for m in logs]
    assert [m["step"] for m in logs] == list(range(1, 13))
    assert losses[-1] < losses[0] * 0.7, losses


def test_pretrain_trainer_saves_a_projector_jax_reads(tiny, tmp_path):
    cfg, jparams = tiny
    batch = tdata.Collator(cfg, SEQ)(_instances(cfg, n=2, seed=4))
    out = str(tmp_path / "pre")
    tparams = _tparams(cfg, jparams)
    trainer = Trainer(cfg, tparams,
                      topt.OptimizerConfig(learning_rate=1e-3,
                                           tune_mm_mlp_adapter=True),
                      TrainerConfig(output_dir=out, max_steps=2,
                                    save_steps=1), device="cpu")
    trainer.train([batch, batch])
    assert sorted(os.listdir(out)) == ["adapter-1", "adapter-2",
                                       "checkpoints", "train_log.jsonl"]
    loaded = jorbax.load_projector_only(os.path.join(out, "adapter-2"),
                                        jparams["connector"])
    conn = topt.flatten(tparams["connector"])
    for path, leaf in topt.flatten(jax.tree.map(np.asarray, loaded)).items():
        np.testing.assert_array_equal(leaf, conn[path].detach().numpy())


def test_projector_files_cross_read(tiny, tmp_path):
    """The port reads JAX's save and JAX reads the port's, bf16 leaves
    included (written as fp32)."""
    cfg, jparams = tiny
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jorbax.save_projector_only(jdir, jparams["connector"])
    tconn = _tparams(cfg, jparams)["connector"]
    got = projector_io.load_projector_only(jdir, tconn)
    for path, t in topt.flatten(got).items():
        assert torch.equal(t, topt.flatten(tconn)[path]), path

    half = _to_bf16(tconn)
    flat = topt.flatten(half)
    projector_io.save_projector_only(tdir, half)
    with open(os.path.join(tdir, "mm_projector.json")) as f:
        assert json.load(f) == sorted("/".join(p) for p in flat)
    loaded = jorbax.load_projector_only(tdir, jparams["connector"])
    for path, leaf in topt.flatten(jax.tree.map(np.asarray, loaded)).items():
        np.testing.assert_array_equal(leaf, flat[path].float().numpy())
    back = projector_io.load_projector_only(tdir, half)
    for path, t in topt.flatten(back).items():
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, flat[path]), path


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_moment_dtypes_follow_jax_in_bf16(tiny, grad_accum):
    """With bf16 params optax's moments take the gradient's dtype: bf16
    for grad_accum 1, fp32 for grad_accum 2 (fp32 gradient sums); the
    port's step ends with the same dtypes and params stay bf16."""
    cfg, jparams = tiny
    batch = tdata.Collator(cfg, SEQ)(_instances(cfg, n=2, seed=5))
    kw = dict(learning_rate=1e-3, warmup_ratio=0.0,
              tune_mm_mlp_adapter=True)
    bf16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jparams)
    jcfg = jopt.OptimizerConfig(**kw)
    jtx = jopt.build_optimizer(bf16, jcfg)
    jfn = jstep.make_train_step(cfg, jtx, compute_dtype=jnp.bfloat16,
                                grad_accum=grad_accum, remat=False,
                                trainable=jopt.trainable_mask(bf16, jcfg))
    jstate, _ = jfn(jstep.init_state(bf16, jtx), _jbatch(batch))
    adam = jstate.opt_state.inner_states["projector"].inner_state[1][0]
    jmu = {str(a.dtype) for a in jax.tree.leaves(adam.mu)}
    jnu = {str(a.dtype) for a in jax.tree.leaves(adam.nu)}
    tparams = _to_bf16(_tparams(cfg, jparams))
    tcfg = topt.OptimizerConfig(**kw)
    ttx = topt.build_optimizer(tparams, tcfg)
    tfn = tstep.make_train_step(cfg, ttx, topt.trainable_mask(tparams, tcfg),
                                grad_accum=grad_accum)
    state, _ = tfn(tstep.init_state(tparams, ttx), batch)
    tmu = {str(t.dtype).replace("torch.", "")
           for t in state.opt_state["mu"].values()}
    tnu = {str(t.dtype).replace("torch.", "")
           for t in state.opt_state["nu"].values()}
    want = {"bfloat16"} if grad_accum == 1 else {"float32"}
    assert jmu == jnu == want
    assert tmu == tnu == want
    assert {t.dtype for t in topt.flatten(state.params).values()} \
        == {torch.bfloat16}


def test_trainer_keeps_fp32_masters_of_bf16_params(tiny, tmp_path):
    """A Trainer under compute_dtype bfloat16 over params that arrive in
    bf16 (a bf16 checkpoint), the LLM trained at a rate below half a bf16
    ulp of its norm scales (1.0): every trained leaf gets an fp32 master
    (its value widened) with fp32 moments, the masters of the norm scales
    move while their bf16 copies cannot, each copy is its master rounded,
    and the frozen tower stays bit-unchanged."""
    cfg, jparams = tiny
    params = _to_bf16(_tparams(cfg, jparams))
    before = {p: t.clone() for p, t in topt.flatten(params).items()}
    opt = topt.OptimizerConfig(learning_rate=1e-3, warmup_ratio=0.0)
    trained = [p for p, t in topt.trainable_mask(params, opt).items() if t]
    trainer = Trainer(cfg, params, opt,
                      TrainerConfig(output_dir=str(tmp_path), max_steps=1,
                                    log_steps=1, save_steps=10,
                                    compute_dtype="bfloat16"),
                      device="cpu")
    masters = trainer.state.opt_state["master"]
    assert sorted(masters) == sorted(trained)
    for p, m in masters.items():
        assert m.dtype == torch.float32
        assert torch.equal(m, before[p].float()), p
        assert trainer.state.opt_state["mu"][p].dtype == torch.float32
    batch = tdata.Collator(cfg, SEQ)(_instances(cfg, n=2, seed=5))
    state = trainer.train([batch])
    flat = topt.flatten(state.params)
    norms = [p for p in trained if p[-1] == "scale" and p[0] == "llm"]
    assert norms
    for p in norms:
        assert not torch.equal(masters[p], before[p].float()), p
        assert torch.equal(flat[p], before[p]), p
    for p in trained:
        assert flat[p].dtype == torch.bfloat16
        assert torch.equal(flat[p], masters[p].to(torch.bfloat16)), p
    for p, t in flat.items():
        if p[0] == "vision":
            assert torch.equal(t, before[p]), p
