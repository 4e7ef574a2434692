"""Whole train steps of the port's stage-1 training path against the JAX
package's make_train_step on the tiny VideoLLaMA2 in fp32 on the CPU:
grad_accum 1 (three steps) and 2 (two steps), under the projector-only and
the full-LLM trainable masks; loss, metrics and every param after each
step, frozen leaves bit-identical.

Params after each step are held to 1e-5 of each leaf's largest value plus
2e-3 of the learning rate per step taken. Adam moves every element by
about lr whatever its gradient's size (g / (sqrt(nu) + eps)), so where a
gradient nearly cancels, the two packages' fp32 disagreement on it (up to
~1e-4 relative) becomes that fraction of an lr-sized step, and a
zero-initialized bias has no scale of its own; the test runs Adam with eps
1e-6, so that no element's update hangs on a gradient near eps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_train import (SEQ, _instances, _jax_view, _jbatch,  # noqa: F401
                              _tparams, tiny)
from videollama2_tpu.train import optimizer as jopt
from videollama2_tpu.train import step as jstep
from videollama2_tpu_torch.train import data as tdata
from videollama2_tpu_torch.train import optimizer as topt
from videollama2_tpu_torch.train import step as tstep


def _assert_params_close(tparams, jparams_now, lr, steps, msg):
    view = _jax_view(tparams, jparams_now)
    for path, want in topt.flatten(jparams_now).items():
        want = np.asarray(want)
        got = view[path]
        tol = 1e-5 * np.abs(want).max() + 2e-3 * lr * steps
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=f"{msg}: {'/'.join(path)}")


@pytest.mark.parametrize("mask", ["projector", "full"])
@pytest.mark.parametrize("grad_accum,steps", [(1, 3), (2, 2)])
def test_train_steps_match_jax(tiny, mask, grad_accum, steps):
    cfg, jparams = tiny
    batch = tdata.Collator(cfg, SEQ)(_instances(cfg, seed=2))
    # eps 1e-6: at the default 1e-8 a few elements of the tiny model's
    # grads are near eps, where Adam's update hangs on fp32 rounding of g
    kw = dict(learning_rate=1e-3, mm_projector_lr=2e-3, total_steps=10,
              warmup_ratio=0.0, weight_decay=0.01, eps=1e-6,
              tune_mm_mlp_adapter=(mask == "projector"))
    jcfg = jopt.OptimizerConfig(**kw)
    jtx = jopt.build_optimizer(jparams, jcfg)
    jfn = jstep.make_train_step(cfg, jtx, compute_dtype=jnp.float32,
                                grad_accum=grad_accum,
                                trainable=jopt.trainable_mask(jparams, jcfg),
                                remat=False)
    jstate = jstep.init_state(jax.tree.map(jnp.asarray, jparams), jtx)

    tparams = _tparams(cfg, jparams)
    tcfg = topt.OptimizerConfig(**kw)
    ttx = topt.build_optimizer(tparams, tcfg)
    trainable = topt.trainable_mask(tparams, tcfg)
    tfn = tstep.make_train_step(cfg, ttx, trainable, grad_accum=grad_accum)
    tstate = tstep.init_state(tparams, ttx)
    before = {p: t.detach().clone() for p, t in topt.flatten(tparams).items()}

    jb = _jbatch(batch)
    for s in range(steps):
        jstate, jm = jfn(jstate, jb)
        tstate, tm = tfn(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert int(tm["num_tokens"]) == int(jm["num_tokens"])
        np.testing.assert_allclose(float(tm["accuracy"]),
                                   float(jm["accuracy"]), rtol=1e-6)
        _assert_params_close(tstate.params,
                             jax.tree.map(np.asarray, jstate.params),
                             kw["mm_projector_lr"], s + 1, f"step {s + 1}")
    assert tstate.step == steps
    for p, t in topt.flatten(tstate.params).items():
        # frozen leaves bit-identical; every trained leaf moved
        assert torch.equal(t, before[p]) != trainable[p], p
