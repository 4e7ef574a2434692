"""The port's timing drivers of the serving path
(scripts/bench_session_torch.py, bench_speculative_torch.py,
profile_torch_components.py, profile_torch_kernels.py) against the JAX
package, on the tiny config on the CPU, and the synthetic tree they build
(utils/synthetic quantize_vision).

On weights carried from the JAX package (vl2.init_params(PRNGKey(0)) in
fp32, checkpoint/from_jax), the session's turn-1 and turn-2 tokens equal
the JAX Engine's, and every speculative run (lookup, oracle and
verify-oracle, k 4 and 8, and B 8 batched) equals JAX's plain greedy
exactly; the oracles accept every draft. Each stage of
profile_torch_components returns its output beside its time: on the JAX
script's constant fills the tower, the connector, the prefill (W8A8 off
and on) and the decode chunk equal JAX's vit.features, connector.apply,
llm.forward and decode_step (its jitted 32-step scan, Pallas in
interpret mode) within 1e-5 of the JAX output's largest magnitude, in
fp32 (the tower within 1e-4: TOWER_REL_TOL). The bench scripts print
their JAX originals' JSON keys, and no script runs on the CPU without
PLATFORM=cpu.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from videollama2_tpu.core import config as cfglib
from videollama2_tpu.inference.engine import Engine as JaxEngine
from videollama2_tpu.inference.engine import \
    GenerationConfig as JaxGenerationConfig
from videollama2_tpu.models import connector as jconn
from videollama2_tpu.models import llm as jllm
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.models import vit as jvit
from videollama2_tpu.ops import layers as jlayers
from videollama2_tpu.ops import quant as jquant
from videollama2_tpu.utils import synthetic as jsynthetic
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.ops import layers as tlayers
from videollama2_tpu_torch.ops import quant as tquant
from videollama2_tpu_torch.utils.synthetic import synthetic_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# last: scripts/ holds directories (torch/, eval/) that must not shadow
# packages
sys.path.append(os.path.join(ROOT, "scripts"))

import bench_session_torch as bst  # noqa: E402
import bench_speculative_torch as bsp  # noqa: E402
import profile_torch_components as comp  # noqa: E402
import profile_torch_kernels as kern  # noqa: E402

SPEC_TOKENS = 24
# of the JAX output's largest magnitude, in fp32
STAGE_REL_TOL = 1e-5
# the tower's: under constant fills every token of the patch projection is
# constant across channels, so a LayerNorm's x - mean is rounding residue
# divided by sqrt(eps = 1e-5). JAX's layer_norm takes its statistics in
# fp32 and keeps up to 5.6e-5 of the output's magnitude of that residue
# (0.01000377 where the exact value is 0.01, also under jax.enable_x64);
# the port's F.layer_norm gives the exact value to 5e-8 (fp32 against
# fp64)
TOWER_REL_TOL = 1e-4
# ROADMAP §3: parity inputs of W8A8 stay this far from a .5 boundary
W8A8_MARGIN = 5.7e-6


@pytest.fixture(scope="module")
def tiny():
    cfg = cfglib.tiny_model()
    jp = jvl2.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def test_session_tokens_equal_jax(tiny):
    cfg, jp, tp = tiny
    frames, prompt1, turn2, bucket = bst.inputs(cfg, on_gpu=False)
    res = bst.run(bst.engine(cfg, tp, torch.float32, "cpu", bucket),
                  frames, prompt1, turn2, iters=1)
    jeng = JaxEngine(cfg, jp, dtype=jnp.float32, buckets=(bucket,),
                     max_len=128, attn_impl="xla",
                     decode_chunk=bst.NEW_TOKENS)
    gen = JaxGenerationConfig(max_new_tokens=bst.NEW_TOKENS)
    ans1, sess = jeng.generate([prompt1], frames=frames, gen=gen,
                               eos_token_id=-1, return_session=True)
    ans2, _ = jeng.generate_continue(sess, turn2, gen=gen, eos_token_id=-1)
    assert res["turn1_tokens"] == ans1[0]
    assert res["turn2_tokens"] == ans2[0]
    assert len(ans2[0]) == bst.NEW_TOKENS


def test_speculative_tokens_equal_jax_greedy(tiny):
    cfg, jp, tp = tiny
    B = 8
    out = bsp.run(bsp.engine(cfg, tp, torch.float32, "cpu", SPEC_TOKENS),
                  cfg, SPEC_TOKENS, B, iters=1)
    jeng = JaxEngine(cfg, jp, dtype=jnp.float32,
                     max_len=bsp.BUCKET + SPEC_TOKENS + 16,
                     buckets=(bsp.BUCKET,), attn_impl="xla", decode_chunk=32)
    gen = JaxGenerationConfig(max_new_tokens=SPEC_TOKENS)
    one = jeng.generate(bsp.prompts(1), gen=gen, eos_token_id=-1)
    rows = jeng.generate(bsp.prompts(B), gen=gen, eos_token_id=-1)
    runs = out["runs"]
    for k in bsp.KS:
        for label in ("plain", f"lookup k={k}", f"oracle k={k}",
                      f"verify-oracle k={k}"):
            assert runs[label]["tokens"] == one, label
        for label in (f"oracle k={k}", f"verify-oracle k={k}"):
            assert runs[label]["accepted_per_pass"] == k - 1
    assert runs[f"plain B={B}"]["tokens"] == rows
    assert runs[f"lookup B={B} k=8"]["tokens"] == rows
    assert len(rows) == B and {len(r) for r in rows} == {SPEC_TOKENS}


def _jax_fills(tree):
    return jax.tree.map(lambda a: jnp.full(a.shape, 0.01, a.dtype),
                        jax.eval_shape(tree))


def _jax_llm_fills(cfg):
    """profile_components.py's build_llm_params in fp32 (FUSEQKV=1)."""
    lp = _jax_fills(lambda: jllm.init_params(jax.random.PRNGKey(0), cfg.llm,
                                             jnp.float32))
    layers = dict(lp["layers"])
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        e = dict(layers[name])
        w = e.pop("kernel")
        e["kernel_q8"] = {"q": jnp.ones(w.shape, jnp.int8),
                          "scale": jnp.full(w.shape[:-2] + (1, w.shape[-1]),
                                            1e-4, jnp.float32)}
        layers[name] = e
    lp["layers"] = layers
    return jquant.fuse_qkv(lp)


def _close(got, want, rel=STAGE_REL_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    assert err <= rel * scale, (err, scale)


@pytest.fixture(scope="module")
def stages():
    return comp.setup("cpu")


def test_tower_and_connector_stages_equal_jax(stages):
    cfg, B = stages["cfg"], stages["B"]
    T, H = cfg.num_frames, cfg.vision.image_size
    dev = torch.device("cpu")
    rng = np.random.default_rng(0)
    pixels = (rng.integers(0, 255, (B * T, H, H, 3), dtype=np.uint8)
              .astype(np.float32) / 255.0)
    t, feats = comp.run_vit(cfg, comp.vit_params(cfg, torch.float32, dev),
                            torch.from_numpy(pixels), False, iters=1)
    assert t > 0
    jfeats = jvit.features(
        _jax_fills(lambda: jvit.init_params(jax.random.PRNGKey(0),
                                            cfg.vision)),
        cfg.vision, jnp.asarray(pixels), attn_impl="xla")
    _close(feats, jfeats, TOWER_REL_TOL)
    n = (H // cfg.vision.patch_size) ** 2
    x = np.full((B, T, n, cfg.vision.hidden_size), 0.1, np.float32)
    t, tokens = comp.run_conn(
        cfg, comp.connector_params(cfg, torch.float32, dev),
        torch.from_numpy(x), iters=1)
    assert t > 0
    _close(tokens, jconn.apply(
        _jax_fills(lambda: jconn.init_params(jax.random.PRNGKey(0),
                                             cfg.connector)),
        cfg.connector, jnp.asarray(x)))


@pytest.mark.parametrize("w8a8", [False, True])
def test_prefill_stage_equals_jax(stages, w8a8, monkeypatch):
    cfg, B, S = stages["cfg"], stages["B"], stages["S"]
    dev = torch.device("cpu")
    args = comp.prefill_inputs(cfg, B, S, torch.float32, dev)
    fed = []
    real = tlayers.dense_w8a8

    def recording(x, pack):
        fed.append(x.clone())
        return real(x, pack)
    monkeypatch.setattr(tlayers, "dense_w8a8", recording)
    t, hidden = comp.run_prefill(cfg, comp.llm_params(cfg, torch.float32,
                                                      dev),
                                 *args, w8a8, iters=1)
    assert t > 0
    with jlayers.force_native_quant(w8a8), jlayers.quant_inference(True), \
            jlayers.w8a8_prefill(w8a8):
        want = jllm.forward(_jax_llm_fills(cfg), cfg.llm,
                            *(jnp.asarray(a.numpy()) for a in args),
                            attn_impl="xla")[0]
    _close(hidden, want)
    assert bool(fed) == w8a8
    for x in fed:
        xf = x.float()
        r = (xf / (xf.abs().amax(-1, keepdim=True).clamp(min=1e-8) / 127.0))
        frac = r.abs() - r.abs().floor()
        assert (frac - 0.5).abs().min().item() >= W8A8_MARGIN


def test_decode_chunk_equals_jax(stages):
    cfg, B, bucket = stages["cfg"], stages["B"], stages["bucket"]
    d = comp.run_decode(cfg, comp.llm_params(cfg, torch.float32,
                                             torch.device("cpu")),
                        B, bucket, torch.float32, iters=1)
    assert d["host_s"] > 0 and d["device_ms"] is None
    jp = _jax_llm_fills(cfg)

    def chunk(tok, cache):
        def step(carry, xs):
            tok, cache = carry
            te = jllm.embed_tokens(jp, tok[:, None], dtype=jnp.float32)
            logits, cache = jllm.decode_step(jp, cfg.llm, te, cache, valid,
                                             bucket, xs)
            return (jnp.argmax(logits, -1).astype(jnp.int32), cache), logits

        with jlayers.quant_inference(True):
            (tok, cache), logits = jax.lax.scan(
                step, (tok, cache), jnp.arange(comp.STEPS, dtype=jnp.int32))
        return tok, cache, logits[-1]

    valid = jnp.full((B,), bucket - 100, jnp.int32)
    fn = jax.jit(chunk)
    tok = jnp.zeros((B,), jnp.int32)
    cache = jllm.init_cache(cfg.llm, B, bucket + 32, jnp.float32)
    for _ in range(2):          # the warm-up chunk and one timed chunk
        tok, cache, logits = fn(tok, cache)
    assert d["tokens"].tolist() == np.asarray(tok).tolist()
    _close(d["logits"], logits)
    for got, want in ((d["cache"].k, cache.k), (d["cache"].v, cache.v)):
        _close(got, np.asarray(want).reshape(got.shape))


def _last_json(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_bench_scripts_print_their_jax_keys(monkeypatch, capsys):
    monkeypatch.setenv("PLATFORM", "cpu")
    bst.main()
    assert set(_last_json(capsys)) == {
        "size", "bucket", "turn1_fresh_s", "turn2_cached_s",
        "turn2_speedup_vs_fresh"}
    bsp.main()
    assert set(_last_json(capsys)) == (
        {"plain_ms_per_tok"}
        | {f"{kind}_k{k}_ms_per_tok" for kind in ("lookup", "oracle")
           for k in (4, 8)}
        | {f"oracle_k{k}_speedup" for k in (4, 8)}
        | {"batch8_plain_ms_per_tok", "batch8_lookup_k8_ms_per_tok",
           "batch8_lookup_k8_speedup"})


def test_profile_scripts_print_their_jax_lines(monkeypatch, capsys):
    monkeypatch.setenv("PLATFORM", "cpu")
    kern.main()
    out = capsys.readouterr().out
    for line in ("null dispatch:", "one layer all matmuls:",
                 "scan 2 layers matmuls only:"):
        assert line in out
    assert "CUDA events" not in out
    comp.main()
    out = capsys.readouterr().out
    for line in ("ViT encode 8f:", "STC connector:",
                 "prefill B=2 S=128 (plain):", "decode chunk 32 (B=2):"):
        assert line in out
    monkeypatch.setenv("FUSEQKV", "0")
    with pytest.raises(ValueError, match="fused qkv"):
        comp.main()


@pytest.mark.parametrize("script", [bst, bsp, comp, kern],
                         ids=lambda m: m.__name__)
def test_no_silent_cpu(script, monkeypatch):
    monkeypatch.delenv("PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        script.main()


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def test_synthetic_quantize_vision():
    """The default (tower packed whenever llm_bits is set) is the tree of
    quantizing a floating one in place, as before the switch; with False
    the LLM is the same and the tower keeps the floating layout of JAX's
    quantized_abstract(quantize_vision=False)."""
    cfg = cfglib.tiny_model()
    kw = dict(dtype=torch.float32, device="cpu", seed=0)
    floating = synthetic_params(cfg, **kw)
    before = synthetic_params(cfg, **kw)
    tquant.quantize_in_place(before["llm"]["layers"],
                             tquant.LLM_PROJECTIONS, 8)
    tquant.quantize_in_place(before["llm"], ("lm_head",), 8)
    tquant.quantize_in_place(before["vision"]["layers"],
                             tquant.VISION_PROJECTIONS, 8)
    default = synthetic_params(cfg, llm_bits=8, **kw)
    tower_float = synthetic_params(cfg, llm_bits=8, quantize_vision=False,
                                   **kw)
    assert [p for p, _ in _leaves(default)] == [p for p, _ in
                                                 _leaves(before)]
    for (p, a), (_, b) in zip(_leaves(default), _leaves(before)):
        assert torch.equal(a, b), p
    for (p, a), (_, b) in zip(_leaves(tower_float["llm"]),
                              _leaves(default["llm"])):
        assert torch.equal(a, b), p
    for (p, a), (q, b) in zip(_leaves(tower_float["vision"]),
                              _leaves(floating["vision"]), strict=True):
        assert p == q and torch.equal(a, b), p
    jtower = jsynthetic.quantized_abstract(
        jax.eval_shape(lambda: jvl2.init_params(jax.random.PRNGKey(0), cfg)),
        quantize_llm=True, quantize_vision=False)["vision"]["layers"]
    layers = tower_float["vision"]["layers"]
    for name in ("o", "fc1", "fc2"):
        assert set(layers[name]) == set(jtower[name]) == {"kernel", "bias"}
        assert tuple(layers[name]["kernel"].shape) == \
            jtower[name]["kernel"].shape
    assert set(jtower["q"]) == {"kernel", "bias"}
    assert tuple(layers["qkv"]["kernel"].shape) == jtower["q"]["kernel"].shape[
        :-1] + (sum(jtower[n]["kernel"].shape[-1] for n in "qkv"),)
    assert "kernel_q8" in default["vision"]["layers"]["qkv"]
