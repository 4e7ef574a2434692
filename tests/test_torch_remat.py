"""The LLM's remat policies in the port (models/llm.forward's remat: False,
True or "dots", passed through forward_train and make_train_step) on the
CPU in fp32, on tiny_model (CLIP + STC + Mistral, and the Qwen2 layout with
its qkv biases):

- the loss and every gradient (the LLM's and the connector's) under "dots"
  equal those under True and False bit for bit, as do a make_train_step
  step's params: each policy recomputes the same operations on the same
  inputs;
- JAX's forward_train(remat="dots") loss to 1e-5 relative and its
  gradients to 1e-4 (of each leaf's largest), fp32 in two summation
  orders, as tests/test_torch_train.py holds remat=True;
- "dots" saves the outputs of the products without batch dims (aten.mm:
  the fused qkv, o, gate, up and down projections, 5 a layer) and only
  those;
- an unknown policy string raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videollama2_tpu.constants import IGNORE_INDEX, VIDEO_TOKEN_INDEX
from videollama2_tpu.core import config as cfglib
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.train import data as jdata
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.models import llm as tllm
from videollama2_tpu_torch.models import videollama2 as tvl2
from videollama2_tpu_torch.train import data as tdata
from videollama2_tpu_torch.train import optimizer as topt
from videollama2_tpu_torch.train import step as tstep

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SEQ = 64
MODELS = ("videollama2_mistral", "videollama2_qwen2")
_TINY = {}


def _tiny(model):
    if model not in _TINY:
        cfg = cfglib.tiny_model(model, projector_type="stc_connector")
        jp = jax.tree.map(np.asarray,
                          jvl2.init_params(jax.random.PRNGKey(0), cfg))
        rng = np.random.default_rng(1)
        H, T = cfg.vision.image_size, cfg.num_frames
        insts = []
        for i in range(2):
            text = [int(x) for x in rng.integers(3, cfg.llm.vocab_size,
                                                 10 + 7 * i)]
            insts.append({"input_ids": [1, VIDEO_TOKEN_INDEX] + text,
                          "labels": [IGNORE_INDEX, IGNORE_INDEX] + text,
                          "frames": rng.standard_normal((T, H, H, 3)).astype(
                              np.float32)})
        _TINY[model] = (cfg, jp, tdata.Collator(cfg, SEQ)(insts))
    return _TINY[model]


def _port_loss_and_grads(cfg, jp, batch, remat):
    """forward_train's loss and the gradients of the LLM and the
    connector ({path: tensor}, the port's layout)."""
    params = params_from_jax(jp, cfg)
    flat = topt.flatten(params)
    trained = {p: t for p, t in flat.items() if p[0] in ("llm", "connector")}
    for t in trained.values():
        t.requires_grad_(True)
    loss, _ = tstep.loss_fn(params, cfg, batch, remat=remat)
    loss.backward()
    return loss.detach(), {p: t.grad for p, t in trained.items()}


@pytest.mark.parametrize("model", MODELS)
def test_dots_equals_full_and_no_remat(model):
    cfg, jp, batch = _tiny(model)
    loss, grads = _port_loss_and_grads(cfg, jp, batch, "dots")
    for remat in (True, False):
        other_loss, other = _port_loss_and_grads(cfg, jp, batch, remat)
        assert torch.equal(loss, other_loss), remat
        for p, g in grads.items():
            assert torch.equal(g, other[p]), (remat, p)


def test_make_train_step_takes_remat():
    """Two steps of make_train_step(remat="dots") give the params and
    losses of remat=True's (and False's), bit for bit."""
    cfg, jp, batch = _tiny("videollama2_mistral")
    ocfg = topt.OptimizerConfig(learning_rate=1e-3, warmup_ratio=0.0,
                                total_steps=4)
    out = {}
    for remat in ("dots", True, False):
        params = params_from_jax(jp, cfg)
        tx = topt.build_optimizer(params, ocfg)
        fn = tstep.make_train_step(cfg, tx, topt.trainable_mask(params, ocfg),
                                   remat=remat)
        state = tstep.init_state(params, tx)
        losses = []
        for _ in range(2):
            state, m = fn(state, batch)
            losses.append(float(m["loss"]))
        out[remat] = (losses, topt.flatten(state.params))
    for remat in (True, False):
        assert out[remat][0] == out["dots"][0]
        for p, t in out["dots"][1].items():
            assert torch.equal(t, out[remat][1][p]), (remat, p)


def _as_jax_paths(grads, jgrads):
    """The port's {path: grad} in the JAX tree's paths: the fused qkv
    (kernel and bias) split back into q, k and v."""
    out = {}
    for path, want in jgrads.items():
        if path in grads:
            out[path] = grads[path].numpy()
            continue
        i = next(j for j, n in enumerate(path) if n in ("q", "k", "v"))
        widths = [jgrads[path[:i] + (n,) + path[i + 1:]].shape[-1]
                  for n in ("q", "k", "v")]
        start = sum(widths[:("q", "k", "v").index(path[i])])
        fused = grads[path[:i] + ("qkv",) + path[i + 1:]].numpy()
        out[path] = fused[..., start:start + want.shape[-1]]
    return out


@pytest.mark.parametrize("model", MODELS)
def test_dots_matches_jax_dots(model):
    """JAX's remat="dots" (dots_with_no_batch_dims_saveable) and the
    port's: loss to 1e-5 relative, every LLM and connector gradient to
    1e-4 of its leaf's largest."""
    cfg, jp, batch = _tiny(model)
    jb = jdata.Batch(*(jnp.asarray(a) for a in batch))
    rest = {k: v for k, v in jp.items() if k not in ("llm", "connector")}

    def loss_of(trained):
        return jvl2.forward_train({**rest, **trained}, cfg, jb.frames,
                                  jb.text_ids, jb.is_visual, jb.vis_index,
                                  jb.positions, jb.valid_len, jb.labels,
                                  remat="dots")
    (jl, _), jg = jax.value_and_grad(loss_of, has_aux=True)(
        jax.tree.map(jnp.asarray, {"llm": jp["llm"],
                                   "connector": jp["connector"]}))
    jg = {p: np.asarray(g) for p, g in topt.flatten(jg).items()}
    loss, grads = _port_loss_and_grads(cfg, jp, batch, "dots")
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    got = _as_jax_paths(grads, jg)
    for p, want in jg.items():
        np.testing.assert_allclose(got[p], want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg="/".join(p))


def test_dots_policy_saves_the_weight_products_only(monkeypatch):
    """The policy's decisions in the forward of forward_train(remat=
    "dots"): MUST_SAVE for aten.mm alone, 5 a layer (qkv, o, gate, up,
    down); attention's batched products and every elementwise op are
    left to recompute."""
    from torch.utils.checkpoint import CheckpointPolicy
    cfg, jp, batch = _tiny("videollama2_mistral")
    decisions = []
    policy = tllm.dots_saveable

    def recording(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((op, out))
        return out
    monkeypatch.setattr(tllm, "dots_saveable", recording)
    _port_loss_and_grads(cfg, jp, batch, "dots")
    saved = [op for op, d in decisions if d == CheckpointPolicy.MUST_SAVE]
    recomputed = {str(op) for op, d in decisions
                  if d == CheckpointPolicy.PREFER_RECOMPUTE}
    assert {str(op) for op in saved} == {"aten.mm.default"}
    assert len(saved) == 5 * cfg.llm.num_layers
    assert "aten.bmm.default" in recomputed or \
        "aten._scaled_dot_product_flash_attention_for_cpu.default" in \
        recomputed or any("attention" in op for op in recomputed)
    assert {"aten.mul.Tensor", "aten.rsqrt.default"} <= recomputed


@pytest.mark.parametrize("where", ["forward", "forward_train",
                                   "make_train_step"])
def test_unknown_remat_policy_raises(where):
    cfg, jp, batch = _tiny("videollama2_mistral")
    params = params_from_jax(jp, cfg)
    with pytest.raises(ValueError, match="unknown remat policy 'offload'"):
        if where == "forward":
            D = cfg.llm.hidden_size
            tllm.forward(params["llm"], cfg.llm, torch.zeros(1, 4, D),
                         torch.arange(4)[None], torch.tensor([4]),
                         remat="offload")
        elif where == "forward_train":
            tstep.loss_fn(params, cfg, batch, remat="offload")
        else:
            ocfg = topt.OptimizerConfig()
            tstep.make_train_step(cfg, topt.build_optimizer(params, ocfg),
                                  topt.trainable_mask(params, ocfg),
                                  remat="offload")
    assert tvl2.forward_train.__defaults__[-1] is True
