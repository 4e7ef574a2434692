"""The port's parallel layer (videollama2_tpu_torch/parallel/) against the
JAX package's, on the CPU.

Multi-rank cases run in 4 spawned gloo processes (tests/
torch_parallel_worker.py), started once for the module, rendezvousing
through a FileStore under the test's tmp directory, every collective
timing out after 60 s: the sharded train step at data 2 x fsdp 2, fsdp 2 x
tensor 2 and fsdp 2 x seq 2 (Ulysses), grad accumulation under fsdp 2 x
tensor 2, the sharded Engine at tensor 4 (the tiny config's 2 kv heads
replicated onto 2 ranks each) and fsdp 2 x tensor 2, the tiny Mixtral at
expert 2, and train states moved between a 1-rank and a 2-rank mesh. JAX
runs in this process on conftest's virtual devices: its unsharded step
(which tests/test_sharding.py holds equal to its sharded ones) and Engine
are the references, on the same params (JAX's init, carried by
checkpoint/from_jax.params_from_jax) and batch, in fp32.

Tolerances: loss rtol 1e-4 and the updated q/k/v kernels rtol 1e-4 /
atol 1e-5 against JAX (tests/test_sharding.py's); every other leaf
against the port's unsharded step at 1e-5 of the leaf's largest value
plus 2e-3 of the learning rate (tests/test_torch_train_steps.py's rule:
Adam moves an element by about lr whatever its gradient, so a gradient
that nearly cancels carries the fp32 disagreement into an lr-sized step;
Adam's eps is 1e-6 for the same reason); the frozen tower bit-equal;
Engine tokens equal.

The rule table is checked without processes: every leaf of the tiny,
Mistral-7B, Qwen2-7B, Mixtral-8x7B and Qwen2-72B trees takes JAX's spec,
the fused qkv shard is q_r | k_r | v_r, and tests/test_72b_sharding.py's
two checks hold for the port's table at tensor 4 on an 80 GB H100.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

import torch_parallel_worker as worker
from test_torch_train import SEQ, _instances, _jax_view, tiny  # noqa: F401
from test_torch_train_entry import _flags, ckpt, corpus  # noqa: F401
from videollama2_tpu.core import config as jcfglib
from videollama2_tpu.inference.engine import Engine as JEngine
from videollama2_tpu.inference.engine import \
    GenerationConfig as JGenerationConfig
from videollama2_tpu.models import llm as jllm
from videollama2_tpu.models import videollama2 as jvl2
from videollama2_tpu.parallel import sharding as jsh
from videollama2_tpu.train import data as jdata
from videollama2_tpu.train import optimizer as jopt
from videollama2_tpu.train import step as jstep
from videollama2_tpu_torch.checkpoint import train_state
from videollama2_tpu_torch.checkpoint.from_jax import params_from_jax
from videollama2_tpu_torch.core import config as cfglib
from videollama2_tpu_torch.inference.engine import Engine, GenerationConfig
from videollama2_tpu_torch.models import llm as tllm
from videollama2_tpu_torch.models import videollama2 as tvl2
from videollama2_tpu_torch.parallel import mesh as mesh_lib
from videollama2_tpu_torch.parallel import sharding as sh
from videollama2_tpu_torch.train import data as tdata
from videollama2_tpu_torch.train import optimizer as topt
from videollama2_tpu_torch.train import step as tstep

WORLD = 4
OPT = dict(learning_rate=1e-3, total_steps=10, eps=1e-6)
PROMPT, TURN = [3, 4, 5], [7, 8]


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _model(model_type, seed=0):
    cfg = cfglib.tiny_model(model_type)
    jparams = jax.tree.map(np.asarray,
                           jvl2.init_params(jax.random.PRNGKey(0), cfg))
    batch = tdata.Collator(cfg, SEQ)(_instances(cfg, seed=seed))
    return cfg, jparams, batch


def _jax_step(cfg, jparams, batches, grad_accum=1):
    """JAX's unsharded step(s): (metrics of the last, params numpy)."""
    jtx = jopt.build_optimizer(jparams, jopt.OptimizerConfig(**OPT))
    fn = jstep.make_train_step(cfg, jtx, compute_dtype=jnp.float32,
                               attn_impl="xla", grad_accum=grad_accum)
    st = jstep.init_state(jax.tree.map(jnp.asarray, jparams), jtx)
    for b in batches:
        st, m = fn(st, jdata.Batch(*(jnp.asarray(a) for a in b)))
    return ({k: float(v) for k, v in m.items()},
            jax.tree.map(np.asarray, st.params))


def _port_steps(cfg, params, batches, grad_accum=1, save_dir=None):
    """The port's unsharded step(s): (metrics of the last, state); with
    save_dir, the state after the first step is saved there."""
    ocfg = topt.OptimizerConfig(**OPT)
    tx = topt.build_optimizer(params, ocfg)
    fn = tstep.make_train_step(cfg, tx, topt.trainable_mask(params, ocfg),
                               grad_accum=grad_accum)
    st = tstep.init_state(_clone(params), tx)
    for i, b in enumerate(batches):
        st, m = fn(st, b)
        if save_dir is not None and i == 0:
            train_state.save_train_state(save_dir, st)
    return {k: float(v) for k, v in m.items()}, st


def _port_tokens(cfg, params):
    eng = Engine(cfg, params, dtype=torch.float32, max_len=96,
                 buckets=(32,), decode_chunk=4, device="cpu")
    out = {"greedy": eng.generate([PROMPT], gen=GenerationConfig(
        max_new_tokens=6), eos_token_id=-1)[0],
        "speculative": eng.generate([PROMPT], gen=GenerationConfig(
            max_new_tokens=6, speculative_k=3), eos_token_id=-1)[0]}
    a1, sess = eng.generate([PROMPT], gen=GenerationConfig(max_new_tokens=4),
                            eos_token_id=-1, return_session=True)
    a2, _ = eng.generate_continue(sess, TURN, gen=GenerationConfig(
        max_new_tokens=4), eos_token_id=-1)
    out["session"] = (a1[0], a2[0])
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Inputs, the JAX and unsharded-port references, and every rank's
    results."""
    job = tmp_path_factory.mktemp("parallel")
    cfg, jparams, batch = _model("videollama2_mistral")
    batch2 = tdata.Collator(cfg, SEQ)(_instances(cfg, seed=1))
    mcfg, mjparams, mbatch = _model("videollama2_mixtral")
    params = params_from_jax(jparams, cfg)
    mparams = params_from_jax(mjparams, mcfg)
    inputs = {
        "opt": OPT, "prompt": PROMPT, "turn": TURN,
        "dense": {"cfg": cfg, "params": params, "batch": batch,
                  "batch2": batch2},
        "moe": {"cfg": mcfg, "params": mparams, "batch": mbatch},
        "saved_1rank": str(job / "saved_1rank"),
        "save_2rank": str(job / "saved_2rank"),
    }
    ref = {"port": {}, "jax": {}}
    ref["port"]["step"], ref["port"]["state"] = _port_steps(
        cfg, params, [batch])
    ref["port"]["ga2"], ref["port"]["ga2_state"] = _port_steps(
        cfg, params, [batch], grad_accum=2)
    ref["port"]["two"], ref["port"]["two_state"] = _port_steps(
        cfg, params, [batch, batch2], save_dir=inputs["saved_1rank"])
    ref["port"]["moe"], _ = _port_steps(mcfg, mparams, [mbatch])
    ref["port"]["tokens"] = _port_tokens(cfg, params)
    ref["port"]["moe_tokens"] = _port_tokens(mcfg, mparams)
    torch.save(inputs, job / "inputs.pt")

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, WORLD, str(job)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    # JAX's references while the ranks run
    ref["jax"]["step"], ref["jax"]["params"] = _jax_step(cfg, jparams,
                                                         [batch])
    ref["jax"]["ga2"], ref["jax"]["ga2_params"] = _jax_step(
        cfg, jparams, [batch], grad_accum=2)
    ref["jax"]["moe"], _ = _jax_step(mcfg, mjparams, [mbatch])
    jeng = JEngine(cfg, jparams, dtype=jnp.float32, max_len=96,
                   buckets=(32,), attn_impl="xla", decode_chunk=4)
    ref["jax"]["greedy"] = jeng.generate(
        [PROMPT], gen=JGenerationConfig(max_new_tokens=6),
        eos_token_id=-1)[0]
    for p in procs:
        p.join(timeout=240)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive, "ranks did not finish in 240 s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    ranks = [torch.load(job / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"inputs": inputs, "ref": ref, "ranks": ranks, "job": job,
            "cfg": cfg, "jparams": jparams}


def _ok(res):
    assert not (isinstance(res, dict) and "error" in res), res.get("error")
    return res


def _assert_params(got: dict, want_state, jparams_now=None, steps=1,
                   lr=OPT["learning_rate"], msg=""):
    """got {path: whole leaf} against the port's unsharded state, and q/k/v
    against JAX's params (JAX's sharding test's tolerance)."""
    want = {"/".join(p): t.detach() for p, t in
            topt.flatten(want_state.params).items()}
    assert set(got) == set(want)
    for k, w in want.items():
        tol = 1e-5 * float(w.abs().max()) + 2e-3 * lr * steps
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=tol, err_msg=f"{msg}: {k}")
    if jparams_now is not None:
        view = _jax_view(_unflatten(got), jparams_now)
        for n in ("q", "k", "v"):
            np.testing.assert_allclose(
                view[("llm", "layers", n, "kernel")],
                jparams_now["llm"]["layers"][n]["kernel"],
                rtol=1e-4, atol=1e-5, err_msg=f"{msg}: {n}")


def _unflatten(flat: dict) -> dict:
    tree = {}
    for k, v in flat.items():
        topt.set_path(tree, tuple(k.split("/")), v)
    return tree


@pytest.mark.parametrize("case", ["step_dp2_fsdp2", "step_fsdp2_tp2",
                                  "step_fsdp2_sp2"])
def test_sharded_step_matches_jax(setup, case):
    """Loss and updated q/k/v kernels against JAX's step (its sharded
    tests' setup), every leaf against the port's unsharded step, the
    frozen tower unchanged; every rank holds the same whole params."""
    ref, res = setup["ref"], _ok(setup["ranks"][0][case])
    np.testing.assert_allclose(res["metrics"]["loss"],
                               ref["jax"]["step"]["loss"], rtol=1e-4)
    assert res["metrics"]["num_tokens"] == ref["jax"]["step"]["num_tokens"]
    np.testing.assert_allclose(res["metrics"]["accuracy"],
                               ref["jax"]["step"]["accuracy"], rtol=1e-4)
    _assert_params(res["params"], ref["port"]["state"], ref["jax"]["params"],
                   msg=case)
    vision = setup["inputs"]["dense"]["params"]["vision"]
    for path, t in topt.flatten(vision).items():
        assert torch.equal(res["params"]["vision/" + "/".join(path)], t)
    for r in range(1, WORLD):
        other = _ok(setup["ranks"][r][case])
        assert other["metrics"] == res["metrics"]
        for k, t in res["params"].items():
            assert torch.equal(other["params"][k], t), (r, k)


def test_grad_accum_under_fsdp(setup):
    """grad_accum 2 at fsdp 2 x tensor 2 against JAX's grad_accum 2 step
    (each microbatch's loss is its global mean) and the port's."""
    ref, res = setup["ref"], _ok(setup["ranks"][0]["step_ga2_fsdp2_tp2"])
    np.testing.assert_allclose(res["metrics"]["loss"],
                               ref["jax"]["ga2"]["loss"], rtol=1e-4)
    assert res["metrics"]["num_tokens"] == ref["jax"]["ga2"]["num_tokens"]
    _assert_params(res["params"], ref["port"]["ga2_state"],
                   ref["jax"]["ga2_params"], msg="ga2")


@pytest.mark.parametrize("case", ["engine_tp4", "engine_fsdp2_tp2"])
def test_sharded_engine_tokens(setup, case):
    """Greedy, speculative (k 3) and continued-session tokens of the
    sharded Engine equal the unsharded port's, on every rank; greedy
    equals JAX's."""
    ref = setup["ref"]
    for r in range(WORLD):
        assert _ok(setup["ranks"][r][case]) == ref["port"]["tokens"], r
    assert ref["port"]["tokens"]["greedy"] == ref["jax"]["greedy"]
    assert ref["port"]["tokens"]["speculative"] == ref["jax"]["greedy"]


def test_expert_parallel_mixtral(setup):
    """The tiny Mixtral at data 2 x expert 2 (the gather dispatch on the
    rank's 2 of 4 experts): loss against JAX's; its Engine at tensor 2 x
    expert 2 (the dense dispatch): tokens equal the unsharded port's."""
    ref = setup["ref"]
    res = _ok(setup["ranks"][0]["moe_step_dp2_ep2"])
    np.testing.assert_allclose(res["metrics"]["loss"],
                               ref["jax"]["moe"]["loss"], rtol=1e-4)
    np.testing.assert_allclose(res["metrics"]["loss"],
                               ref["port"]["moe"]["loss"], rtol=1e-5)
    for r in range(WORLD):
        assert _ok(setup["ranks"][r]["moe_engine_ep2_tp2"]) == \
            ref["port"]["moe_tokens"], r


def test_state_resumes_across_meshes(setup):
    """A 1-rank save of step 1, resumed on a 2-rank fsdp mesh for step 2,
    and a 2-rank save of step 1, resumed by a 1-rank run for step 2, both
    equal the uninterrupted 1-rank run."""
    ref, inputs = setup["ref"], setup["inputs"]
    res = _ok(setup["ranks"][0]["resume"])
    assert res["step"] == 2
    np.testing.assert_allclose(res["loss"], ref["port"]["two"]["loss"],
                               rtol=1e-5)
    _assert_params(res["params"], ref["port"]["two_state"], steps=2,
                   msg="2-rank resume")
    assert setup["ranks"][2]["resume"] is None       # outside that mesh

    cfg, params = inputs["dense"]["cfg"], inputs["dense"]["params"]
    ocfg = topt.OptimizerConfig(**OPT)
    tx = topt.build_optimizer(params, ocfg)
    st = tstep.init_state(_clone(params), tx)
    train_state.restore_train_state(inputs["save_2rank"], st, 1)
    fn = tstep.make_train_step(cfg, tx, topt.trainable_mask(params, ocfg))
    st, m = fn(st, inputs["dense"]["batch2"])
    np.testing.assert_allclose(float(m["loss"]), ref["port"]["two"]["loss"],
                               rtol=1e-5)
    _assert_params({"/".join(p): t.detach() for p, t in
                    topt.flatten(st.params).items()},
                   ref["port"]["two_state"], steps=2, msg="1-rank resume")


def test_single_device_mesh_is_the_unsharded_step(tiny):
    """A one-rank mesh without a process group runs every collective as
    the identity: the sharded step gives the unsharded step's bits."""
    cfg, jparams = tiny
    params = params_from_jax(jparams, cfg)
    batch = tdata.Collator(cfg, SEQ)(_instances(cfg))
    m0, st0 = _port_steps(cfg, params, [batch])
    mesh = mesh_lib.single_device_mesh()
    ocfg = topt.OptimizerConfig(**OPT)
    tx = topt.build_optimizer(params, ocfg)
    st = tstep.init_sharded_state(mesh, _clone(params), tx, cfg)
    fn = tstep.make_train_step(cfg, tx, topt.trainable_mask(params, ocfg),
                               mesh=mesh)
    st, m = fn(st, batch)
    assert {k: float(v) for k, v in m.items()} == m0
    for p, t in topt.flatten(st.params).items():
        assert torch.equal(t, topt.flatten(st0.params)[p]), p


# ---------------------------------------------------------------------------
# train.py under torch.distributed.run
# ---------------------------------------------------------------------------

def test_train_entry_under_torchrun(ckpt, corpus, tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 2 -m
    videollama2_tpu_torch.train.train --mesh_fsdp 2 ...` (gloo) trains
    pretrain.sh's stage for 2 steps and saves; a 1-rank run over the same
    output_dir resumes at step 2 and takes step 3: the losses and the
    params equal those of an uninterrupted 1-rank run (a constant learning
    rate, so the runs' different max_steps set the same schedule)."""
    import json

    from videollama2_tpu_torch.train import train as ttrain

    def flags(out, per_device, steps):
        return _flags(ckpt, corpus, str(out), 1) + [
            "--tokenizer", "torch_parallel_worker:hf_tokenizer",
            "--device", "cpu", "--num_train_epochs", "2",
            "--lr_scheduler_type", "constant", "--warmup_ratio", "0",
            "--save_steps", "2", "--per_device_train_batch_size",
            str(per_device), "--max_steps", str(steps)]

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [here, os.path.dirname(here), os.environ.get("PYTHONPATH", "")]))
    dist_dir = tmp_path / "dist"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "videollama2_tpu_torch.train.train",
         *flags(dist_dir, 1, 2), "--mesh_fsdp", "2"],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert (dist_dir / "checkpoints" / "2").is_dir()
    one = ttrain.main(flags(tmp_path / "one", 2, 3))
    resumed = ttrain.main(flags(dist_dir, 2, 3))
    assert resumed.start_step == 2

    def losses(d):
        with open(d / "train_log.jsonl") as f:
            return [json.loads(line)["loss"] for line in f]
    np.testing.assert_allclose(losses(dist_dir), losses(tmp_path / "one"),
                               rtol=1e-5)
    got = topt.flatten(resumed.state.params)
    for p, t in topt.flatten(one.state.params).items():
        t = t.detach()
        np.testing.assert_allclose(
            got[p].detach().numpy(), t.numpy(), rtol=0,
            atol=1e-5 * float(t.abs().max()) + 2e-3 * 1e-3 * 3,
            err_msg="/".join(p))


# ---------------------------------------------------------------------------
# The rule table, without processes
# ---------------------------------------------------------------------------

def _meta_tree(shapes):
    return {k: _meta_tree(v) if isinstance(v, dict)
            else torch.empty(v, device="meta") for k, v in shapes.items()}


SHAPE_TREES = {
    "tiny": lambda: cfglib.tiny_model(),
    "mistral_7b": lambda: cfglib.preset("videollama2_mistral"),
    "qwen2_7b": lambda: cfglib.preset("videollama2_qwen2"),
    "mixtral_8x7b": lambda: cfglib.preset("videollama2_mixtral"),
    "qwen2_72b": lambda: cfglib.ModelConfig(
        model_type="videollama2_qwen2", llm=cfglib.qwen2_72b(),
        vision=cfglib.preset("videollama2_qwen2").vision,
        connector=cfglib.preset("videollama2_qwen2").connector),
}


@pytest.mark.parametrize("name", sorted(SHAPE_TREES))
def test_rule_table_matches_jax(name):
    """Every leaf's spec is JAX's spec_for of its path (the fused qkv's
    that of q, k and v, which agree)."""
    cfg = SHAPE_TREES[name]()
    tree = _meta_tree(tvl2.param_shapes(cfg))
    specs = sh.param_specs(tree, cfg.llm.is_moe)
    assert len(specs) == len(topt.flatten(tree))
    for path, spec in specs.items():
        ndim = len(spec)
        jpaths = ([path.replace("qkv/", f"{n}/") for n in "qkv"]
                  if "/qkv/" in path else [path])
        for jp in jpaths:
            want = tuple(jsh.spec_for(jp, ndim, cfg.llm.is_moe))
            assert spec == want + (None,) * (ndim - len(want)), (path, jp)


@pytest.mark.parametrize("H,K,t", [(4, 2, 2), (4, 2, 4), (32, 8, 4),
                                   (28, 4, 4), (64, 8, 8), (16, 16, 4)])
def test_qkv_shard_is_the_ranks_heads(H, K, t):
    """A tensor rank's qkv shard is its H / t query heads' columns, then
    the k and v columns of the kv heads they read (one replicated kv head
    a rank when t > K); the ranks' shards cover the fused columns."""
    hd = 2
    layout = sh.Layout(mesh_lib.single_device_mesh())
    full = torch.arange((H + 2 * K) * hd)
    seen = set()
    for r in range(t):
        cols = sh.qkv_columns(H, K, hd, t, r).tolist()
        Hl = H // t
        Kl = sh.local_kv_heads(H, K, t)
        q, kv = cols[:Hl * hd], cols[Hl * hd:]
        assert q == list(range(r * Hl * hd, (r + 1) * Hl * hd))
        heads = {c // hd for c in q}
        want_kv = sorted({h // (H // K) for h in heads})
        assert len(want_kv) == Kl
        k0 = want_kv[0]
        assert kv == (list(range(H * hd + k0 * hd, H * hd + (k0 + Kl) * hd))
                      + list(range((H + K) * hd + k0 * hd,
                                   (H + K) * hd + (k0 + Kl) * hd)))
        seen.update(cols)
        assert torch.equal(full[cols], torch.tensor(cols))
    assert seen == set(range((H + 2 * K) * hd))
    assert layout.shard("llm/layers/qkv/kernel", full[None]).shape == \
        (1, (H + 2 * K) * hd)                       # one rank: whole


TENSOR = 4          # one 4-card H100 node
BIG = 1_000_000     # replicating anything bigger than this is a bug


def _qwen2_72b_specs():
    cfg = cfglib.qwen2_72b()
    tree = {"llm": _meta_tree(tllm.param_shapes(cfg))}
    return cfg, topt.flatten(tree), sh.param_specs(tree)


def test_qwen2_72b_every_param_sharded_at_shape():
    """tests/test_72b_sharding.py's check on the port's table: no big leaf
    replicated, every sharded dim divides by its axes (tensor 4, fsdp 16
    as there)."""
    sizes = {"tensor": TENSOR, "fsdp": 16, "data": 1, "expert": 1}
    cfg, flat, specs = _qwen2_72b_specs()
    big_replicated = []
    for path, leaf in flat.items():
        spec = specs["/".join(path)]
        if leaf.numel() >= BIG and all(a is None for a in spec):
            big_replicated.append(path)
        for dim, entry in zip(leaf.shape, spec):
            n = int(np.prod([sizes[a] for a in sh._axes(entry)]))
            assert dim % n == 0, (path, leaf.shape, spec)
    assert not big_replicated, big_replicated
    # and the fused qkv at tensor 4: 64 / 4 query heads, 8 / 4 kv heads
    assert sh.local_kv_heads(cfg.num_heads, cfg.num_kv_heads, TENSOR) == 2


def test_qwen2_72b_tp4_per_device_bytes_fit():
    """At tensor 4 (no fsdp) a rank's bf16 weights are 144 GB / 4, about
    36 GB: they fit an 80 GB H100 with over half of it left for the KV
    cache and activations."""
    _, flat, specs = _qwen2_72b_specs()
    per_device = 0
    for path, leaf in flat.items():
        shard = 1
        for entry in specs["/".join(path)]:
            shard *= TENSOR if "tensor" in sh._axes(entry) else 1
        per_device += leaf.numel() * 2 // shard
    assert 35e9 < per_device < 40e9, per_device
