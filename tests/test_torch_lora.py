"""The port's LoRA / QLoRA against the JAX package on the tiny VideoLLaMA2
(CLIP + STC + Mistral layout) on the CPU: `dense` with an adapter on every
base, the lora utilities, the optimizer's labels, one LoRA step and one
QLoRA step (int8 and int4 bases), the peft split save in both directions,
and the Engine (plain and speculative greedy) over an unmerged adapted
tree.

JAX's random adapters cannot be drawn again from a torch seed, so JAX's
injected adapters are carried across by checkpoint/from_jax (q, k and v's
combined into the port's fused qkv adapter), with b set nonzero so that
every delta shows. Tolerances: fp32 products in two summation orders
within 1e-6 of the output's largest value (dense) and 1e-5 (merged
kernels); the W8A8/W4A8 base term is an exact int32 product, held to
1e-6 as tests/test_torch_quant.py holds it; bf16 outputs within 1e-2 of
the largest value (two bf16 roundings, 2^-8 each, of the base and of the
delta chain); losses 1e-5 relative and gradients 1e-4 relative L2 (fp32,
as tests/test_torch_train.py), the updates of one Adam step 2e-3
(UPDATE_REL_L2).
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videollama2_tpu.checkpoint import convert_hf as jconv
from videollama2_tpu.checkpoint import orbax_io as jorbax
from videollama2_tpu.core import config as cfglib
from videollama2_tpu.inference.engine import Engine as JaxEngine
from videollama2_tpu.inference.engine import \
    GenerationConfig as JaxGenerationConfig
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.ops import layers as jlayers
from videollama2_tpu.ops import quant as jquant
from videollama2_tpu.train import lora as jlora
from videollama2_tpu.train import optimizer as jopt
from videollama2_tpu.train import step as jstep
from videollama2_tpu_torch.checkpoint import convert_hf as tconv
from videollama2_tpu_torch.checkpoint import projector_io
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.inference.engine import Engine, GenerationConfig
from videollama2_tpu_torch.models import llm as tllm
from videollama2_tpu_torch.ops import layers as tlayers
from videollama2_tpu_torch.ops import quant as tquant
from videollama2_tpu_torch.train import data as tdata
from videollama2_tpu_torch.train import lora as tlora
from videollama2_tpu_torch.train import optimizer as topt
from videollama2_tpu_torch.train import step as tstep
from videollama2_tpu_torch.train.trainer import Trainer, TrainerConfig

FP32_REL = 1e-6
BF16_REL = 1e-2
MERGE_REL = 1e-5
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
# Adam divides each gradient by its own root mean square, so an update
# carries its gradient's per-element relative error, which is large where
# a gradient nearly cancels: the two packages' first updates differ by up
# to 8.4e-4 relative L2 on a connector bias whose gradients agree to 1e-4
UPDATE_REL_L2 = 2e-3
SEQ = 64
R = 4


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _close(got, want, rel, msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=msg)


def _rel_l2(got, want):
    got, want = _np(got).ravel(), _np(want).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _with_b(llm, seed, scale=0.05):
    """Injected JAX adapters with b drawn nonzero (b starts at zero)."""
    layers = dict(llm["layers"])
    key = jax.random.PRNGKey(seed)
    for name, entry in llm["layers"].items():
        if isinstance(entry, dict) and "lora" in entry:
            key, sub = jax.random.split(key)
            lo = dict(entry["lora"])
            lo["b"] = scale * jax.random.normal(sub, lo["b"].shape,
                                                lo["b"].dtype)
            layers[name] = {**entry, "lora": lo}
    return {**llm, "layers": layers}


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_model()
    jp = _host(jvl2.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, jp


def _adapted(cfg, jp, bits=None, targets=jlora.TARGETS, seed=1):
    """(JAX tree, port tree): the tiny model with JAX adapters (nonzero b)
    injected over a floating (bits None), int8 or int4 LLM base."""
    llm = jp["llm"]
    if bits is not None:
        llm = jquant.quantize_llm_params(llm, bits=bits)
    lcfg = jlora.LoraConfig(r=R, alpha=2 * R, targets=targets)
    llm = _with_b(jlora.inject_lora(jax.random.PRNGKey(seed), llm, lcfg),
                  seed + 1)
    jtree = _host(dict(jp, llm=llm))
    return jtree, params_from_jax(jtree, cfg)


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

def _dense_case(base, rng):
    """(x, JAX entry, port entry) of one projection with an adapter."""
    x = rng.standard_normal((2, 5, 48), dtype=np.float32)
    w = rng.standard_normal((48, 40), dtype=np.float32) * 0.05
    bias = rng.standard_normal(40, dtype=np.float32) * 0.1
    lo = {"a": rng.standard_normal((48, R), dtype=np.float32) / R ** 0.5,
          "b": rng.standard_normal((R, 40), dtype=np.float32) * 0.05,
          "s": np.full((1, 1), 2.0, np.float32)}
    if base in ("fp32", "bf16"):
        jentry = {"kernel": jnp.asarray(w)}
    elif base.startswith("int8"):
        jentry = {"kernel_q8": jquant.quantize_int8(jnp.asarray(w), axis=-2)}
    else:
        j4 = jquant.quantize_int4(jnp.asarray(w), axis=-2)
        jentry = {"kernel_q4": {"q4": j4["q4"], "scale": j4["scale"]}}
    jentry = dict(jentry, bias=jnp.asarray(bias),
                  lora={k: jnp.asarray(v) for k, v in lo.items()})
    tentry = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jentry)
    if base == "bf16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.from_numpy(x).bfloat16()), jentry, tentry
    return (jnp.asarray(x), torch.from_numpy(x)), jentry, tentry


@pytest.mark.parametrize("base", ["fp32", "bf16", "int8", "int8-w8a8",
                                  "int4", "int4-w4a8"])
def test_dense_with_adapter_matches_jax(base):
    """The delta (x @ a) @ b * s after the base product and before the
    bias, on a float kernel, an int8 pack in both branches and a folded
    int4 pack in both; under W8A8/W4A8 only the base is quantized."""
    (xj, xt), jentry, tentry = _dense_case(base, np.random.default_rng(3))
    w8a8 = base.endswith(("w8a8", "w4a8"))
    if w8a8:
        with jlayers.force_native_quant(), jlayers.w8a8_prefill():
            want = jlayers.dense(xj, jentry)
            want_base = jlayers.dense(xj, {k: v for k, v in jentry.items()
                                           if k != "lora"})
    else:
        want = jlayers.dense(xj, jentry)
        want_base = jlayers.dense(xj, {k: v for k, v in jentry.items()
                                       if k != "lora"})
    got = tlayers.dense(xt, tentry, w8a8=w8a8)
    got_base = tlayers.dense(xt, {k: v for k, v in tentry.items()
                                  if k != "lora"}, w8a8=w8a8)
    assert got.dtype == xt.dtype
    rel = BF16_REL if base == "bf16" else FP32_REL
    _close(got_base, want_base, rel, "base term")
    _close(got, want, rel, "with the adapter")
    # the adapter moved the output by more than the tolerance
    assert np.abs(_np(got) - _np(got_base)).max() > 100 * rel * np.abs(
        _np(want)).max()


def test_dense_fused_qkv_adapter_is_jax_three_deltas(tiny):
    """The fused qkv entry with its combined adapter gives JAX's separate
    q, k and v denses side by side, over an int8 base in both branches."""
    cfg, jp = tiny
    jtree, ttree = _adapted(cfg, jp, bits=8)
    jl = jax.tree.map(lambda a: a[0], jtree["llm"]["layers"])
    tl = tlayers.layer_params(ttree["llm"]["layers"], 0)
    x = np.random.default_rng(4).standard_normal(
        (3, 7, cfg.llm.hidden_size), dtype=np.float32)
    for w8a8 in (False, True):
        with jlayers.force_native_quant(w8a8), jlayers.w8a8_prefill(w8a8):
            want = np.concatenate([np.asarray(jlayers.dense(
                jnp.asarray(x), jl[n])) for n in ("q", "k", "v")], -1)
        got = tlayers.dense(torch.from_numpy(x), tl["qkv"], w8a8=w8a8)
        _close(got, want, FP32_REL, f"w8a8 {w8a8}")


# ---------------------------------------------------------------------------
# the lora utilities
# ---------------------------------------------------------------------------

def _jax_view(tlayers_tree, jlayers_tree):
    """{(entry, key...): numpy} of the port's layer tree in the JAX layout:
    the fused qkv kernel and adapter split back into q, k and v."""
    out = {}
    for path, t in topt.flatten(tlayers_tree).items():
        if path[0] != "qkv":
            out[path] = _np(t)
    widths = tlora.qkv_widths(cfglib.tiny_model().llm)
    qkv = tlayers_tree.get("qkv", {})
    off = 0
    for n in ("q", "k", "v"):
        for key in ("kernel", "bias"):
            if key in qkv:
                out[(n, key)] = _np(qkv[key][..., off:off + widths[n]])
        off += widths[n]
    if "lora" in qkv:
        for n, ab in tlora.split_qkv_adapter(qkv["lora"]).items():
            for k, v in ab.items():
                out[(n, "lora", k)] = _np(v)
    return out


def test_carried_adapters_are_jax_adapters(tiny):
    """params_from_jax puts JAX's adapters into the port's entries (q, k
    and v's combined into the fused qkv adapter) unchanged; extract_lora
    gives JAX's separate tree back exactly, strip_lora JAX's base."""
    cfg, jp = tiny
    jtree, ttree = _adapted(cfg, jp)
    tl = ttree["llm"]["layers"]
    assert set(tl["qkv"]["lora"]["b"]) == {"q", "k", "v"}
    assert tl["qkv"]["lora"]["a"].shape[-1] == 3 * R
    view = _jax_view(tl, jtree["llm"]["layers"])
    for path, want in topt.flatten(jtree["llm"]["layers"]).items():
        np.testing.assert_array_equal(view[path], want, err_msg=str(path))
    got = topt.flatten(tlora.extract_lora(ttree["llm"]))
    want = topt.flatten(_host(jlora.extract_lora(jtree["llm"])))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(_np(got[path]), want[path])
    stripped = tlora.strip_lora(ttree["llm"])
    assert not any("lora" in p for p in topt.flatten(stripped))
    base = params_from_jax(_host(dict(jtree, llm=jlora.strip_lora(
        jtree["llm"]))), cfg)["llm"]
    for path, t in topt.flatten(base).items():
        assert torch.equal(topt.flatten(stripped)[path], t), path


@pytest.mark.parametrize("targets", [jlora.TARGETS, ("q", "v", "down")])
def test_merge_lora_injected_matches_jax(tiny, targets):
    """Folding injected adapters into the float kernels: JAX's merged
    kernels within fp32 rounding, the fused qkv kernel included (a target
    subset leaves k without an adapter: a block of rank 0)."""
    cfg, jp = tiny
    jtree, ttree = _adapted(cfg, jp, targets=targets)
    if "k" not in targets:
        assert ttree["llm"]["layers"]["qkv"]["lora"]["b"]["k"].shape[-2] == 0
    got = _jax_view(tlora.merge_lora_injected(ttree["llm"])["layers"], None)
    want = topt.flatten(_host(jlora.merge_lora_injected(jtree["llm"])
                              )["layers"])
    assert set(got) == set(want)
    for path, w in want.items():
        _close(got[path], w, MERGE_REL, str(path))
    moved = [n for n in targets
             if not np.array_equal(want[(n, "kernel")],
                                   jp["llm"]["layers"][n]["kernel"])]
    assert moved == list(targets)


def _peft_sd(cfg, seed=5):
    """A peft adapter_model state dict over the tiny LLM (q and v only,
    the reference's older default targets), A [r, in], B [out, r]."""
    rng = np.random.default_rng(seed)
    llm = cfg.llm
    dims = {"q_proj": (llm.hidden_size, llm.num_heads * llm.head_dim),
            "v_proj": (llm.hidden_size, llm.num_kv_heads * llm.head_dim)}
    sd = {}
    for layer in range(llm.num_layers):
        for name, (d_in, d_out) in dims.items():
            base = f"base_model.model.model.layers.{layer}.self_attn.{name}"
            sd[f"{base}.lora_A.weight"] = torch.from_numpy(
                rng.standard_normal((R, d_in), dtype=np.float32) * 0.1)
            sd[f"{base}.lora_B.weight"] = torch.from_numpy(
                rng.standard_normal((d_out, R), dtype=np.float32) * 0.1)
    return sd


def test_peft_import_and_apply_lora_match_jax(tiny):
    """lora_params_from_peft_state_dict gives JAX's adapters exactly and
    apply_lora / merge_lora JAX's merged kernels within fp32 rounding."""
    cfg, jp = tiny
    sd = _peft_sd(cfg)
    lcfg_j = jlora.LoraConfig(r=R, alpha=3 * R)
    lcfg_t = tlora.LoraConfig(r=R, alpha=3 * R)
    want = jlora.lora_params_from_peft_state_dict(sd, cfg.llm, lcfg_j)
    got = tlora.lora_params_from_peft_state_dict(sd, cfg.llm, lcfg_t)
    assert set(got["layers"]) == set(want["layers"]) == {"q", "v"}
    for path, w in topt.flatten(want).items():
        np.testing.assert_array_equal(_np(topt.flatten(got)[path]), w)
    jmerged = _host(jlora.merge_lora(jp, want, lcfg_j))
    tbase = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    tmerged = tlora.merge_lora(tbase, got, lcfg_t)
    for n in ("q", "k", "v", "o"):
        _close(tmerged["llm"]["layers"][n]["kernel"],
                jmerged["llm"]["layers"][n]["kernel"], MERGE_REL, n)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_inject_lora_over_every_base(tiny, bits):
    """inject_lora on the port's tree (fused qkv) over a float, int8 or
    int4 base: a ~ N(0, 1/r) in fp32, b = 0, s = alpha / r over L, the
    fused qkv adapter's blocks at q, k and v's widths; with b = 0 the
    forward is the base's."""
    cfg, jp = tiny
    tp = params_from_jax(jp, cfg)
    llm = tp["llm"]
    if bits is not None:
        llm = tquant.quantize_llm_params(llm, bits=bits)
    lcfg = tlora.LoraConfig(r=8, alpha=16)
    gen = torch.Generator().manual_seed(0)
    adapted = tlora.inject_lora(gen, llm, lcfg, cfg.llm)
    L, D = cfg.llm.num_layers, cfg.llm.hidden_size
    layers = adapted["layers"]
    widths = tlora.qkv_widths(cfg.llm)
    qkv = layers["qkv"]["lora"]
    assert qkv["a"].shape == (L, D, 3 * 8)
    assert {n: tuple(b.shape) for n, b in qkv["b"].items()} == {
        n: (L, 8, w) for n, w in widths.items()}
    all_a = torch.cat([layers[n]["lora"]["a"].flatten()
                       for n in ("qkv", "o", "gate", "up", "down")])
    assert all_a.dtype == torch.float32
    assert abs(all_a.std().item() - 8 ** -0.5) < 0.02
    for n in ("qkv", "o", "gate", "up", "down"):
        lo = layers[n]["lora"]
        assert lo["s"].shape == (L, 1, 1) and torch.all(lo["s"] == 2.0)
        bs = lo["b"].values() if isinstance(lo["b"], dict) else [lo["b"]]
        assert all(torch.count_nonzero(b) == 0 for b in bs)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 9, D), dtype=np.float32))
    pos = torch.arange(9).expand(2, 9)
    valid = torch.tensor([9, 6], dtype=torch.int32)
    with torch.no_grad():
        np.testing.assert_array_equal(
            tllm.forward(adapted, cfg.llm, x, pos, valid).numpy(),
            tllm.forward(llm, cfg.llm, x, pos, valid).numpy())


def test_fuse_qkv_takes_an_injected_tree(tiny):
    """The port's fuse_qkv fuses split q/k/v packs that carry adapters
    (JAX's leaves them apart): the same tree as params_from_jax's."""
    cfg, jp = tiny
    jtree, ttree = _adapted(cfg, jp, bits=8)
    split = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                         jtree["llm"])
    fused = tquant.fuse_qkv(split)
    assert "q" not in fused["layers"]
    want = topt.flatten(ttree["llm"])
    got = topt.flatten(fused)
    assert set(got) == set(want)
    for path, t in want.items():
        assert torch.equal(got[path], t), path


# ---------------------------------------------------------------------------
# the optimizer's labels and one LoRA / QLoRA step
# ---------------------------------------------------------------------------

def _port_path(jpath):
    """The port's path of a JAX leaf: the LLM's and the tower's q/k/v
    leaves live in the fused qkv entry, an adapter's b of theirs as the
    qkv adapter's block of that name."""
    if len(jpath) < 3 or jpath[1] != "layers" \
            or jpath[2] not in ("q", "k", "v"):
        return jpath
    if "lora" in jpath and jpath[-1] == "b":
        return jpath[:2] + ("qkv", "lora", "b", jpath[2])
    return jpath[:2] + ("qkv",) + jpath[3:]


@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("lora_enable", [True, False])
def test_labels_and_masks_match_jax(tiny, bits, lora_enable):
    """param_labels / trainable_mask label by label as JAX's, on an
    injected tree over a float or int8 base (a, b train under lora_enable;
    s, integer leaves and the tower never)."""
    cfg, jp = tiny
    jtree, ttree = _adapted(cfg, jp, bits=bits)
    jlabels = topt.flatten(jopt.param_labels(jtree, lora_enable))
    tlabels = topt.param_labels(ttree, lora_enable)
    assert {_port_path(p) for p in jlabels} == set(tlabels)
    for path, lb in jlabels.items():
        assert tlabels[_port_path(path)] == lb, path
    for kw in (dict(tune_mm_mlp_adapter=True), {}):
        jcfg = jopt.OptimizerConfig(lora_enable=lora_enable, **kw)
        tcfg = topt.OptimizerConfig(lora_enable=lora_enable, **kw)
        jmask = topt.flatten(jopt.trainable_mask(jtree, jcfg))
        tmask = topt.trainable_mask(ttree, tcfg)
        for path, flag in jmask.items():
            assert tmask[_port_path(path)] == bool(flag), path
    trained = {p for p, lb in tlabels.items() if lb == "llm"}
    if lora_enable:
        assert trained and all("lora" in p and "s" != p[-1]
                               for p in trained)


def _split_grad(path, g, cfg):
    """The port's gradient of a fused qkv adapter's a as JAX's q, k and v
    ones ({jax path: numpy}); any other leaf as it is."""
    if path[2:5] != ("qkv", "lora", "a"):
        return {path: g}
    return {path[:2] + (n, "lora", "a"): g[..., i * R:(i + 1) * R]
            for i, n in enumerate(("q", "k", "v"))}


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_lora_step_matches_jax(tiny, bits):
    """LoRA (float base) and QLoRA (int8, folded int4 base) in fp32: the
    loss and the adapters' and connector's gradients against JAX's
    (gradients flow through the frozen quantized base on its dequantize
    branch), then one step of both make_train_steps under lora_enable:
    the loss, each moved leaf's update (UPDATE_REL_L2) and that only the
    adapters' a and b and the connector changed."""
    from test_torch_train import _instances, _jax_loss
    cfg, jp = tiny
    jtree, ttree = _adapted(cfg, jp, bits=bits)
    batch = tdata.Collator(cfg, SEQ)(_instances(cfg, n=2, seed=7))
    kw = dict(learning_rate=1e-3, mm_projector_lr=2e-3, total_steps=10,
              warmup_ratio=0.0, eps=1e-6, lora_enable=True)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)

    jparams = jax.tree.map(jnp.asarray, jtree)
    leaves, treedef = jax.tree.flatten(jparams)
    paths = [tuple(str(getattr(k, "key", k)) for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    flags = jax.tree.leaves(jopt.trainable_mask(jparams, jcfg))

    def loss_of(trained):
        it = iter(trained)
        full = [next(it) if f else l for l, f in zip(leaves, flags)]
        return _jax_loss(jax.tree.unflatten(treedef, full), cfg, batch)
    (jloss, _), jgrads = jax.value_and_grad(loss_of, has_aux=True)(
        [l for l, f in zip(leaves, flags) if f])
    jgrads = dict(zip([p for p, f in zip(paths, flags) if f],
                      map(np.asarray, jgrads)))

    tmask = topt.trainable_mask(ttree, tcfg)
    flat = topt.flatten(ttree)
    for p, t in flat.items():
        t.requires_grad_(tmask[p])
    tloss, _ = tstep.loss_fn(ttree, cfg, batch)
    tloss.backward()
    tgrads = {}
    for p, t in flat.items():
        if tmask[p]:
            tgrads.update(_split_grad(p, _np(t.grad), cfg))
            t.grad = None
        t.requires_grad_(False)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=LOSS_RTOL)
    assert {_port_path(p) for p in jgrads} == {
        _port_path(p) for p in tgrads}
    for path, g in jgrads.items():
        got = tgrads[path] if path in tgrads else tgrads[_port_path(path)]
        assert np.abs(g).max() > 0, path
        assert _rel_l2(got, g) < GRAD_REL_L2, path

    jtx = jopt.build_optimizer(jparams, jcfg)
    jfn = jstep.make_train_step(cfg, jtx, compute_dtype=jnp.float32,
                                trainable=jopt.trainable_mask(jparams, jcfg),
                                remat=False)
    jstate, jm = jfn(jstep.init_state(jparams, jtx), jstep.Batch(
        *(jnp.asarray(a) for a in batch)))
    ttx = topt.build_optimizer(ttree, tcfg)
    tfn = tstep.make_train_step(cfg, ttx, tmask)
    before = {p: t.clone() for p, t in flat.items()}
    tstate, tm = tfn(tstep.init_state(ttree, ttx), batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    after = topt.flatten(tstate.params)
    view = {}
    for p, t in after.items():
        view.update(_split_grad(p, _np(t), cfg))
    jbefore = topt.flatten(jtree)
    worst = {}
    for path, want in topt.flatten(_host(jstate.params)).items():
        got = view[path] if path in view else view[_port_path(path)]
        if not np.array_equal(want, jbefore[path]):
            worst[path] = _rel_l2(got - jbefore[path], want - jbefore[path])
    assert worst and max(worst.values()) < UPDATE_REL_L2, worst
    changed = {p for p, t in after.items() if not torch.equal(t, before[p])}
    adapters = {p for p in after if "lora" in p and p[-1] != "s"}
    conn = {p for p in after if p[0] == "connector"}
    assert changed == adapters | conn


# ---------------------------------------------------------------------------
# the peft split save and load path (a)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def base_ckpt(tmp_path_factory):
    """scripts/make_tiny_checkpoint.py's directory, the model_base, and its
    JAX-loaded (config, tree)."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    from make_tiny_checkpoint import build_checkpoint
    path = build_checkpoint(str(tmp_path_factory.mktemp("base")))
    cfg, tree = jconv.load_videollama2(path)
    return path, cfg, _host(tree)


def _adapted_base(base_ckpt, seed=1):
    """(JAX tree, port tree) of the loaded base with adapters (nonzero b)
    on every target."""
    _, cfg, jp = base_ckpt
    lcfg = jlora.LoraConfig(r=R, alpha=2 * R)
    llm = _with_b(jlora.inject_lora(jax.random.PRNGKey(seed), jp["llm"],
                                    lcfg), seed + 1)
    jtree = _host(dict(jp, llm=llm))
    return jtree, params_from_jax(jtree, cfg)


def _llm_kernels(tree):
    return {n: _np(e["kernel"]) for n, e in tree["llm"]["layers"].items()
            if "kernel" in e}


def test_port_split_save_loads_through_jax_path_a(base_ckpt, tmp_path):
    """The port's export_lora_split writes JAX's files (the same peft
    state dict, adapter_config.json and projector state dict), and JAX's
    load_videollama2 path (a) merges them into JAX's merged kernels."""
    path, cfg, jp = base_ckpt
    jtree, ttree = _adapted_base(base_ckpt)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    projector_io.export_lora_split(port_dir, ttree["llm"],
                                   ttree["connector"], cfg)
    jorbax.export_lora_split(jax_dir, jtree["llm"], jtree["connector"], cfg)
    for name in ("adapter_model.bin", "non_lora_trainables.bin"):
        got = torch.load(os.path.join(port_dir, name), weights_only=True)
        want = torch.load(os.path.join(jax_dir, name), weights_only=True)
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
    for name in ("adapter_config.json", "config.json"):
        with open(os.path.join(port_dir, name)) as f, \
                open(os.path.join(jax_dir, name)) as g:
            assert json.load(f) == json.load(g), name
    _, loaded = jconv.load_videollama2(port_dir, model_base=path)
    merged = _host(jlora.merge_lora_injected(jtree["llm"]))
    for n, k in _llm_kernels(_host(loaded)).items():
        _close(k, merged["layers"][n]["kernel"], MERGE_REL, n)


def test_jax_split_save_loads_through_port_path_a(base_ckpt, tmp_path):
    """JAX's export_lora_split read by the port's path (a): the adapters
    exactly as JAX's peft importer gives them, then the tree of JAX's own
    path (a) (kernels within fp32 rounding, the rest equal)."""
    path, cfg, _ = base_ckpt
    jtree, _ = _adapted_base(base_ckpt, seed=3)
    out = str(tmp_path / "jax")
    jorbax.export_lora_split(out, jtree["llm"], jtree["connector"], cfg)
    adapters, lcfg = tconv.load_lora_adapters(out, cfg.llm)
    assert (lcfg.r, lcfg.alpha) == (R, 2 * R)
    want = topt.flatten(_host(jlora.extract_lora(jtree["llm"])))
    got = topt.flatten(adapters)
    assert set(got) == set(want)
    for p, w in want.items():
        np.testing.assert_array_equal(_np(got[p]), w)
    tcfg, ttree = tconv.load_videollama2(out, model_base=path)
    jcfg, jtree2 = jconv.load_videollama2(out, model_base=path)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    # the tower is seeded in each package (no vision_tower_path), as in
    # path (b), and the port's comes in its fused layout
    jflat = {p: t for p, t in topt.flatten(_host(jtree2)).items()
             if p[0] != "vision"}
    tflat = {p: t for p, t in topt.flatten(ttree).items()
             if p[0] != "vision"}
    assert set(tflat) == set(jflat)
    for p, w in jflat.items():
        if "kernel" in p and p[0] == "llm":
            _close(tflat[p], w, MERGE_REL, str(p))
        else:
            np.testing.assert_array_equal(_np(tflat[p]), w, err_msg=str(p))


def test_lora_trainer_saves_the_split_and_reads_it_back(base_ckpt,
                                                        tmp_path):
    """Trainer under lora_enable (device "cpu") saves lora-{step}/ every
    save_steps; the port's path-(a) reader gives the trained fp32 adapters
    back bit for bit, and the projector file holds the trained connector."""
    from test_torch_train import _instances
    _, cfg, jp = base_ckpt
    tp = params_from_jax(jp, cfg)
    tp["llm"] = tlora.inject_lora(torch.Generator().manual_seed(0),
                                  tp["llm"], tlora.LoraConfig(r=R, alpha=8),
                                  cfg.llm)
    batch = tdata.Collator(cfg, SEQ)(_instances(cfg, n=2, seed=8))
    out = str(tmp_path / "run")
    trainer = Trainer(cfg, tp, topt.OptimizerConfig(
        learning_rate=1e-3, warmup_ratio=0.0, lora_enable=True),
        TrainerConfig(output_dir=out, max_steps=2, save_steps=1),
        device="cpu")
    state = trainer.train([batch, batch])
    assert sorted(os.listdir(out)) == ["checkpoints", "lora-1", "lora-2",
                                       "train_log.jsonl"]
    assert sorted(os.listdir(os.path.join(out, "lora-2"))) == [
        "adapter_config.json", "adapter_model.bin", "config.json",
        "non_lora_trainables.bin"]
    adapters, lcfg = tconv.load_lora_adapters(os.path.join(out, "lora-2"),
                                              cfg.llm)
    assert (lcfg.r, lcfg.alpha) == (R, 8)
    want = topt.flatten(tlora.extract_lora(state.params["llm"]))
    got = topt.flatten(adapters)
    assert set(got) == set(want) and len(want) == 14
    for p, w in want.items():
        assert torch.equal(got[p], w), p
    b = state.params["llm"]["layers"]["qkv"]["lora"]["b"]["q"]
    assert torch.count_nonzero(b) > 0
    conn = tconv._non_lora_connector(os.path.join(out, "lora-2"),
                                     cfg.connector)
    for p, t in topt.flatten(state.params["connector"]).items():
        assert torch.equal(topt.flatten(conn)[p], t), p


def test_trainer_refuses_params_off_its_device(tiny, monkeypatch):
    """The Trainer runs on "cuda" unless asked for the CPU: without a GPU
    it raises, and with one, params left on the CPU raise too."""
    cfg, jp = tiny
    tp = params_from_jax(jp, cfg)
    ocfg, tcfg = topt.OptimizerConfig(), TrainerConfig()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, tp, ocfg, tcfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="params on \\['cpu'\\]"):
        Trainer(cfg, tp, ocfg, tcfg)
    Trainer(cfg, tp, ocfg, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# serving an unmerged adapted tree
# ---------------------------------------------------------------------------

PROMPTS = [[1, 5, 9, -201, 17, 4], [1, 33, -201, 8, 2, 6, 200, 7]]
NEW_TOKENS = 8


def _frames(cfg, seed=7):
    rng = np.random.default_rng(seed)
    H, T = cfg.vision.image_size, cfg.num_frames
    rgb = rng.integers(0, 256, (2, T, H, H, 3), dtype=np.uint8)
    mean = np.asarray(cfg.vision.image_mean, np.float32)
    std = np.asarray(cfg.vision.image_std, np.float32)
    return ((rgb / np.float32(255.0) - mean) / std).astype(np.float32)


@pytest.mark.parametrize("bits", [None, 8])
def test_engine_over_an_adapted_tree_matches_jax(tiny, bits):
    """Engine.generate over an unmerged adapted tree (a float base, and an
    int8 base whose packed dense takes W8A8 with the delta in fp32; JAX
    under force_native_quant) gives the JAX Engine's greedy tokens, which
    the adapters change."""
    from videollama2_tpu.constants import VIDEO_TOKEN_INDEX
    assert VIDEO_TOKEN_INDEX == -201
    cfg, jp = tiny
    jtree, ttree = _adapted(cfg, jp, bits=bits)
    frames = _frames(cfg)
    kw = dict(max_len=128, buckets=(64,))
    with jlayers.force_native_quant(bits is not None):
        want = JaxEngine(cfg, jtree, dtype=jnp.float32, **kw).generate(
            PROMPTS, frames=frames,
            gen=JaxGenerationConfig(max_new_tokens=NEW_TOKENS),
            eos_token_id=-1)
    eng = Engine(cfg, ttree, dtype=torch.float32, device="cpu", **kw)
    got = eng.generate(PROMPTS, frames=frames,
                       gen=GenerationConfig(max_new_tokens=NEW_TOKENS),
                       eos_token_id=-1)
    assert got == want
    base = Engine(cfg, dict(ttree, llm=tlora.strip_lora(ttree["llm"])),
                  dtype=torch.float32, device="cpu", **kw)
    assert base.generate(PROMPTS, frames=frames,
                         gen=GenerationConfig(max_new_tokens=NEW_TOKENS),
                         eos_token_id=-1) != got


def _boom(*args, **kwargs):
    raise AssertionError("a packed decode kernel was reached")


@pytest.mark.parametrize("bits", [8, 4])
def test_packed_decode_stands_aside_for_adapters(tiny, bits, monkeypatch):
    """With adapters on the packs, decode takes the generic dense path (the
    JAX package's routing): the plain versions of K3-K7 are never reached,
    while the same tree without its adapters reaches them."""
    cfg, jp = tiny
    _, ttree = _adapted(cfg, jp, bits=bits)
    for mod, name in ((tllm.dk, "matmul_q8_layered"),
                      (tllm.dk, "ffn_q8_layered"),
                      (tllm.dk, "matmul_q4_layered"),
                      (tllm.dk, "ffn_q4_layered"),
                      (tllm.dk_attn, "decode_attention_layered")):
        monkeypatch.setattr(mod, name, _boom)
    gen = GenerationConfig(max_new_tokens=4)
    eng = Engine(cfg, ttree, dtype=torch.float32, max_len=128,
                 buckets=(64,), device="cpu", kv_bits=8)
    assert tllm._packed_decode(eng.params["llm"]["layers"]) is None
    out = eng.generate([[1, 5, 9, 17, 4]], gen=gen, eos_token_id=-1)
    assert len(out[0]) == 4
    stripped = Engine(cfg, dict(ttree, llm=tlora.strip_lora(ttree["llm"])),
                      dtype=torch.float32, max_len=128, buckets=(64,),
                      device="cpu", kv_bits=8)
    assert tllm._packed_decode(stripped.params["llm"]["layers"]) == bits
    with pytest.raises(AssertionError, match="packed decode kernel"):
        stripped.generate([[1, 5, 9, 17, 4]], gen=gen, eos_token_id=-1)


def test_speculation_with_adapters_matches_jax(tiny):
    """Greedy prompt-lookup speculation over unmerged adapters on q, k, v
    and o of an int8 base (JAX tests/test_speculative.py's configuration):
    the port's speculative tokens equal its plain greedy tokens and the JAX
    Engine's speculative tokens (JAX under force_native_quant)."""
    cfg, jp = tiny
    jtree, ttree = _adapted(cfg, jp, bits=8, targets=("q", "k", "v", "o"))
    assert "lora" in ttree["llm"]["layers"]["qkv"]
    assert "lora" not in ttree["llm"]["layers"]["gate"]
    prompt = [3, 4, 5, 6, 3, 4, 5]
    kw = dict(max_len=64, buckets=(32,), decode_chunk=4)
    spec = dict(max_new_tokens=10, speculative_k=3)
    with jlayers.force_native_quant():
        want = JaxEngine(cfg, jtree, dtype=jnp.float32, **kw).generate(
            [prompt], gen=JaxGenerationConfig(**spec), eos_token_id=-1)[0]
    eng = Engine(cfg, ttree, dtype=torch.float32, device="cpu", **kw)
    plain = eng.generate([prompt], gen=GenerationConfig(max_new_tokens=10),
                         eos_token_id=-1)[0]
    got = eng.generate([prompt], gen=GenerationConfig(**spec),
                       eos_token_id=-1)[0]
    assert got == plain == want


def test_lora_directory_needs_its_base(base_ckpt, tmp_path):
    """A LoRA directory holds no base weights: without model_base the
    loader raises (a ValueError, not an assert)."""
    path, cfg, _ = base_ckpt
    jtree, ttree = _adapted_base(base_ckpt)
    out = str(tmp_path / "lora")
    projector_io.export_lora_split(out, ttree["llm"], ttree["connector"],
                                   cfg)
    with pytest.raises(ValueError, match="model_base"):
        tconv.load_videollama2(out)


def test_safetensors_adapters_read_as_the_bin(base_ckpt, tmp_path):
    """An adapter_model.safetensors (peft's newer format) goes through the
    port's own mmap reader and gives the adapters of the same state dict
    saved as adapter_model.bin."""
    from safetensors.torch import save_file
    path, cfg, _ = base_ckpt
    jtree, _ = _adapted_base(base_ckpt, seed=5)
    bin_dir = str(tmp_path / "bin")
    jorbax.export_lora_split(bin_dir, jtree["llm"], jtree["connector"], cfg)
    st_dir = tmp_path / "st"
    st_dir.mkdir()
    sd = torch.load(os.path.join(bin_dir, "adapter_model.bin"),
                    weights_only=True)
    save_file({k: v.contiguous() for k, v in sd.items()},
              str(st_dir / "adapter_model.safetensors"))
    shutil.copy(os.path.join(bin_dir, "adapter_config.json"), st_dir)
    want, wcfg = tconv.load_lora_adapters(bin_dir, cfg.llm)
    got, gcfg = tconv.load_lora_adapters(str(st_dir), cfg.llm)
    assert gcfg == wcfg
    assert topt.flatten(got).keys() == topt.flatten(want).keys()
    for p, w in topt.flatten(want).items():
        assert torch.equal(topt.flatten(got)[p], w), p
