"""The eight projector types of the port (models/connector.py) against the
JAX package on the CPU in fp32, on tiny_model(projector_type=...) (CLIP +
Mistral layout, connector depth 2, 4 frames of 4 x 4 patches):
`connector.apply` and `temporal_aggregator` to 1e-5, the visual token
counts, the Engine's greedy tokens (identical) and first-token logits (to
1e-4), the identity projector (equal widths run; unequal widths raise in
both packages), and the `mm_projector.bin` export and LoRA split read back
by both packages' loaders (and the JAX package's own linear export, which
its loader cannot read). tests/test_torch_projectors_train.py holds
model_init of checkpoints of these types, training and train.py.

The mlp family is held at two depths (mlp2x_gelu and mlp3x_gelu). The
same numpy params (JAX's init_params, carried across by params_from_jax)
and inputs go through both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videollama2_tpu.checkpoint import convert_hf as jconv
from videollama2_tpu.checkpoint import orbax_io as jorbax
from videollama2_tpu.constants import VIDEO_TOKEN_INDEX
from videollama2_tpu.core import config as cfglib
from videollama2_tpu.inference.engine import Engine as JaxEngine
from videollama2_tpu.inference.engine import \
    GenerationConfig as JaxGenerationConfig
from videollama2_tpu.models import connector as jconn
from videollama2_tpu.models import llm as jllm
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.multimodal import splice as jsplice
from videollama2_tpu_torch.checkpoint import convert_hf as tconv
from videollama2_tpu_torch.checkpoint import projector_io
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.core import config as tcfglib
from videollama2_tpu_torch.inference.engine import Engine, GenerationConfig
from videollama2_tpu_torch.models import connector as tconn
from videollama2_tpu_torch.models import llm as tllm
from videollama2_tpu_torch.models import videollama2 as tvl2
from videollama2_tpu_torch.utils import synthetic

CONNECTOR_ATOL = 1e-5
FP32_LOGIT_ATOL = 1e-4
NEW_TOKENS = 6
TYPES = ("linear", "mlp2x_gelu", "mlp3x_gelu", "identity", "stc_connector",
         "stc_connector_v35", "stp_connector", "spatial_pool",
         "spatial_conv")
PROMPTS = [[1, 5, 9, VIDEO_TOKEN_INDEX, 17, 4],
           [1, 33, VIDEO_TOKEN_INDEX, 8, 2, 6, 200, 7]]


def _cfg(pt, equal_widths=False):
    """tiny_model(projector_type=pt); equal_widths (and always for
    identity, which runs only there) widens the tower to the LLM's 64."""
    cfg = cfglib.tiny_model(projector_type=pt)
    if equal_widths or pt == "identity":
        D = cfg.llm.hidden_size
        cfg = cfg.replace(
            vision=dataclasses.replace(cfg.vision, hidden_size=D),
            connector=dataclasses.replace(cfg.connector, mm_hidden_size=D))
    return cfg


_PARAMS = {}


def _params(pt):
    """(cfg, JAX params as numpy, the port's params) of _cfg(pt), made
    once a type."""
    if pt not in _PARAMS:
        cfg = _cfg(pt)
        jp = jax.tree.map(np.asarray,
                          jvl2.init_params(jax.random.PRNGKey(0), cfg))
        _PARAMS[pt] = (cfg, jp, params_from_jax(jp, cfg))
    return _PARAMS[pt]


def _feats(cfg, seed=0, b=2):
    n = (cfg.vision.image_size // cfg.vision.patch_size) ** 2
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_frames, n, cfg.vision.hidden_size)).astype(np.float32)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def _assert_same_tree(port_tree, jax_tree):
    got, want = dict(_flat(port_tree)), dict(_flat(jax_tree))
    assert sorted(got) == sorted(want)
    for p, w in want.items():
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(w),
                                      err_msg="/".join(p))


# -- the connector ------------------------------------------------------------

@pytest.mark.parametrize("pt", TYPES)
def test_connector_apply_matches_jax(pt):
    """param_shapes (and synthetic_connector_params) give JAX's tree;
    apply on the same params and features agrees to 1e-5."""
    cfg, jp, tp = _params(pt)
    shapes = dict(_flat(tconn.param_shapes(cfg.connector)))
    assert shapes == {p: tuple(np.shape(v))
                      for p, v in _flat(jp["connector"])}
    made = synthetic.synthetic_connector_params(cfg.connector)
    assert {p: tuple(v.shape) for p, v in _flat(made)} == shapes
    x = _feats(cfg)
    if tconn.kind(pt) in ("linear", "mlp"):
        x = x.mean(axis=1)
    want = np.asarray(jconn.apply(jp["connector"], cfg.connector,
                                  jnp.asarray(x)))
    with torch.no_grad():
        got = tconn.apply(tp["connector"], cfg.connector,
                          torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=CONNECTOR_ATOL)


@pytest.mark.parametrize("pt", TYPES)
def test_tokens_per_video_and_temporal_aggregator_match_jax(pt):
    """The port's config counts the tokens JAX's counts and the
    aggregator makes; temporal_aggregator (the mean over time of linear
    and mlp*) agrees to 1e-5."""
    cfg, jp, tp = _params(pt)
    tcfg = tcfglib.tiny_model(projector_type=pt)
    if pt == "identity":
        tcfg = tcfg.replace(vision=dataclasses.replace(
            tcfg.vision, hidden_size=cfg.vision.hidden_size),
            connector=dataclasses.replace(
                tcfg.connector, mm_hidden_size=cfg.vision.hidden_size))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert tcfg.tokens_per_video == cfg.tokens_per_video
    x = _feats(cfg, seed=1)
    want = np.asarray(jvl2.temporal_aggregator(jp, cfg, jnp.asarray(x)))
    with torch.no_grad():
        got = tvl2.temporal_aggregator(tp, tcfg, torch.from_numpy(x)).numpy()
        each = tvl2.aggregate_each(tp, tcfg, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, cfg.tokens_per_video,
                                       cfg.llm.hidden_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=CONNECTOR_ATOL)
    np.testing.assert_allclose(each, got, rtol=0, atol=CONNECTOR_ATOL)


@pytest.mark.parametrize("pt", ["qformer", "mlp2x_relu"])
def test_unknown_projector_type_raises(pt):
    """A name outside the registry raises a ValueError, as JAX's config
    does where it counts the tokens (which takes any mlp* name there)."""
    cfg = tcfglib.tiny_model(projector_type=pt)
    calls = [lambda: tconn.param_shapes(cfg.connector),
             lambda: tconn.apply({}, cfg.connector, torch.zeros(1, 1, 1)),
             lambda: synthetic.synthetic_connector_params(cfg.connector)]
    if pt == "qformer":
        calls += [lambda: cfg.tokens_per_video, lambda: cfglib.tiny_model(
            projector_type=pt).tokens_per_video]
    for fn in calls:
        with pytest.raises(ValueError, match="Unknown projector type"):
            fn()


# -- the Engine -----------------------------------------------------------------

def _videos(cfg, seed=11):
    rng = np.random.default_rng(seed)
    H, T = cfg.vision.image_size, cfg.num_frames
    rgb = rng.integers(0, 256, (2, T, H, H, 3), dtype=np.uint8)
    mean = np.asarray(cfg.vision.image_mean, np.float32)
    std = np.asarray(cfg.vision.image_std, np.float32)
    return ((rgb / np.float32(255.0) - mean) / std).astype(np.float32)


def _first_logits(cfg, jp, tp, frames, bucket):
    plan = jsplice.plan_batch(PROMPTS, cfg.tokens_per_video, bucket)
    pos = np.broadcast_to(np.arange(bucket, dtype=np.int32), (2, bucket))
    jcache = jllm.init_cache(cfg.llm, 2, 2 * bucket, jnp.float32)
    jlast, _ = jvl2.prefill_multimodal(
        jp, cfg, jnp.asarray(frames), jnp.asarray(plan.text_ids),
        jnp.asarray(plan.is_visual), jnp.asarray(plan.vis_index),
        jnp.asarray(pos), jnp.asarray(plan.valid_len), jcache)
    ref = np.asarray(jllm.lm_logits(jp["llm"], cfg.llm, jlast))
    tcache = tllm.init_cache(cfg.llm, 2, 2 * bucket, torch.float32)
    with torch.inference_mode():
        tlast, _ = tvl2.prefill_multimodal(
            tp, cfg, torch.from_numpy(frames),
            torch.from_numpy(plan.text_ids).long(),
            torch.from_numpy(plan.is_visual),
            torch.from_numpy(plan.vis_index), torch.from_numpy(pos.copy()),
            torch.from_numpy(plan.valid_len), tcache)
        got = tllm.lm_logits(tp["llm"], cfg.llm, tlast).numpy()
    return got, ref


def _bucket(cfg):
    return -(-(max(map(len, PROMPTS)) + cfg.tokens_per_video) // 32) * 32


@pytest.mark.parametrize("pt", TYPES)
def test_engine_matches_jax_engine(pt):
    """Greedy tokens identical to the JAX Engine's, first-token logits to
    1e-4 (identity at equal widths)."""
    cfg, jp, tp = _params(pt)
    frames = _videos(cfg)
    bucket = _bucket(cfg)
    kw = dict(max_len=2 * bucket, buckets=(bucket,))
    jeng = JaxEngine(cfg, jp, dtype=jnp.float32, **kw)
    want = jeng.generate(PROMPTS, frames=frames, gen=JaxGenerationConfig(
        max_new_tokens=NEW_TOKENS), eos_token_id=-1)
    eng = Engine(cfg, tp, dtype=torch.float32, device="cpu", **kw)
    got = eng.generate(PROMPTS, frames=frames, gen=GenerationConfig(
        max_new_tokens=NEW_TOKENS), eos_token_id=-1)
    assert got == want and all(len(o) == NEW_TOKENS for o in got)
    port, ref = _first_logits(cfg, jp, tp, frames, bucket)
    np.testing.assert_allclose(port, ref, rtol=0, atol=FP32_LOGIT_ATOL)
    assert [o[0] for o in got] == list(ref.argmax(-1))


def test_identity_at_unequal_widths_raises_in_both_packages():
    """The tower's 32 wide features cannot be spliced into a 64 wide LLM:
    JAX fails to broadcast in the splice, the port names both widths
    before it."""
    cfg = cfglib.tiny_model(projector_type="identity")
    assert cfg.connector.mm_hidden_size != cfg.llm.hidden_size
    jp = jvl2.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    frames = _videos(cfg)
    bucket = _bucket(cfg)
    with pytest.raises(ValueError, match="[Ii]ncompatible shapes"):
        JaxEngine(cfg, jp, dtype=jnp.float32, max_len=2 * bucket,
                  buckets=(bucket,)).generate(
            PROMPTS, frames=frames, gen=JaxGenerationConfig(
                max_new_tokens=2), eos_token_id=-1)
    eng = Engine(cfg, tp, dtype=torch.float32, max_len=2 * bucket,
                 buckets=(bucket,), device="cpu")
    with pytest.raises(ValueError, match="mm_hidden_size 32 .* hidden_size"
                                         " 64"):
        eng.generate(PROMPTS, frames=frames,
                     gen=GenerationConfig(max_new_tokens=2), eos_token_id=-1)


# -- mm_projector.bin -------------------------------------------------------------

@pytest.mark.parametrize("pt", TYPES)
def test_projector_bin_round_trips_through_both_loaders(pt, tmp_path):
    """The port's export reads back bit-equal through the port's and the
    JAX package's load_pretrain_adapter; but for linear, its keys are
    JAX's export's."""
    cfg, jp, tp = _params(pt)
    projector_io.export_hf_projector_bin(
        str(tmp_path / "mm_projector.bin"), tp["connector"], cfg)
    back = tconv.load_pretrain_adapter(str(tmp_path), cfg.connector)
    _assert_same_tree(back, jp["connector"])
    jback = jconv.load_pretrain_adapter(str(tmp_path), cfg.connector)
    _assert_same_tree(_unflat(jback), jp["connector"])
    got = torch.load(str(tmp_path / "mm_projector.bin"), weights_only=True)
    if pt == "linear":
        assert sorted(got) == ["model.mm_projector.bias",
                               "model.mm_projector.weight"]
        return
    jorbax.export_hf_projector_bin(str(tmp_path / "j.bin"), jp["connector"],
                                   cfg)
    want = torch.load(str(tmp_path / "j.bin"), weights_only=True)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("pt", TYPES)
def test_lora_split_projector_round_trips(pt, tmp_path):
    """export_lora_split's non_lora_trainables.bin (the projector under
    base_model.model.model.mm_projector.) read back by the port's path (a)
    and by the JAX package's key map, bit-equal."""
    from videollama2_tpu_torch.train import lora as tlora
    cfg, jp, tp = _params(pt)
    llm = tlora.inject_lora(torch.Generator().manual_seed(0), tp["llm"],
                            tlora.LoraConfig(r=2, alpha=4), cfg.llm)
    projector_io.export_lora_split(str(tmp_path), llm, tp["connector"], cfg)
    _assert_same_tree(tconv._non_lora_connector(str(tmp_path),
                                                cfg.connector),
                      jp["connector"])
    nl = torch.load(str(tmp_path / "non_lora_trainables.bin"),
                    weights_only=True)
    nl = {k[len("base_model.model."):]: v for k, v in nl.items()}
    _assert_same_tree(_unflat(jconv.connector_params_from_state_dict(
        nl, cfg.connector, prefix="model.mm_projector.")), jp["connector"])


def _unflat(tree):
    return {k: _unflat(v) if isinstance(v, dict)
            else torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def test_jax_linear_export_does_not_load_back(tmp_path):
    """The JAX package writes a linear projector's fc1 at index 0
    (model.mm_projector.0.weight), where its own loader and the
    reference's nn.Linear read model.mm_projector.weight: its round trip
    raises, the port's does not (above)."""
    cfg, jp, tp = _params("linear")
    jorbax.export_hf_projector_bin(str(tmp_path / "mm_projector.bin"),
                                   jp["connector"], cfg)
    keys = sorted(torch.load(str(tmp_path / "mm_projector.bin"),
                             weights_only=True))
    assert keys == ["model.mm_projector.0.bias", "model.mm_projector.0.weight"]
    with pytest.raises(KeyError, match="model.mm_projector.weight"):
        jconv.load_pretrain_adapter(str(tmp_path), cfg.connector)
    with pytest.raises(ValueError, match="lone fc1"):
        projector_io.export_hf_projector_bin(str(tmp_path / "x.bin"),
                                             tp["connector"])
