"""The port's launch layer (scripts/torch/) against the JAX package's
(scripts/{vllava,custom,eval}/*.sh, scripts/launch_multihost.py), on the
CPU:
  - every port script passes `bash -n`;
  - each port script and its JAX counterpart run with stub `torchrun` and
    `python` executables on PATH that record their argv (and answer the
    device-count probes); the recorded flags parse with the port's and
    JAX's train/train.build_argparser() and with each eval driver's,
    scorer's and judge's own parser, and the namespaces are equal except
    for the named deviations (--vision_tower, stage 2's adapter-{step},
    the custom scripts' optional adapter flag, --device), each asserted;
    the merge steps' Python is JAX's with the package renamed;
  - the torchrun plumbing (the reference's env and positional fallbacks),
    stages 1 and 2's gradient accumulation and its refusals (a quotient of
    0, a product that does not divide the global batch; JAX's scripts
    floor silently), the custom scripts' fixed 4 x 4;
  - the chunk-to-card assignment for 1, 2 and 4 cards, every card when
    CUDA_VISIBLE_DEVICES is unset, CHUNKS above the card count, and a
    failed chunk failing the script (JAX's run every chunk on one device);
  - launch_multinode.resolve_mesh against JAX's resolve_mesh over a grid
    of meshes and world sizes, messages included, the dispatch's argv, and
    a world-2 gloo run under torchrun of the eval dispatch: ranks 0 and 1
    get chunks 0 and 1 of 2.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import itertools
import json
import os
import shlex
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

PORT_SCRIPTS = os.path.join(ROOT, "scripts", "torch")
TRAIN_SCRIPTS = ["vllava/pretrain.sh", "vllava/finetune.sh",
                 "custom/finetune.sh", "custom/finetune_lora.sh",
                 "custom/finetune_qlora.sh"]
EVAL_SCRIPTS = sorted(
    f"eval/{n}" for n in os.listdir(os.path.join(ROOT, "scripts", "eval")))
TOWER = "/data/clip-vit-large-patch14-336"


def test_every_jax_script_has_a_port():
    jax = sorted(os.path.relpath(os.path.join(d, n), os.path.join(
        ROOT, "scripts")) for d in [os.path.join(ROOT, "scripts", s)
                                    for s in ("vllava", "custom", "eval")]
        for n in os.listdir(d) if n.endswith(".sh"))
    assert len(jax) == 17
    for rel in jax:
        assert os.path.exists(os.path.join(PORT_SCRIPTS, rel)), rel
    assert sorted(TRAIN_SCRIPTS + EVAL_SCRIPTS) == jax


@pytest.mark.parametrize("rel", TRAIN_SCRIPTS + EVAL_SCRIPTS
                         + ["lib/torchrun.sh", "lib/chunks.sh"])
def test_port_script_parses(rel):
    out = subprocess.run(["bash", "-n", os.path.join(PORT_SCRIPTS, rel)],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


# -- stubs ---------------------------------------------------------------------

STUB = r"""#!{python}
import json, os, sys
prog = os.path.basename(sys.argv[0])
argv = sys.argv[1:]
if prog == "python" and argv[:1] == ["-c"]:
    code = argv[1]
    if "jax.devices" in code:
        print(os.environ.get("STUB_JAX_DEVICES", "1"))
    elif "torch.cuda.device_count" in code:
        print(os.environ.get("STUB_CARDS", "1"))
    else:
        sys.exit("unexpected python -c: " + code)
    sys.exit(0)
rec = {{"prog": prog, "argv": argv,
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}}
if argv[:1] == ["-"]:
    rec["stdin"] = sys.stdin.read()
fd = os.open(os.environ["STUB_LOG"], os.O_WRONLY | os.O_APPEND | os.O_CREAT)
os.write(fd, (json.dumps(rec) + "\n").encode())
os.close(fd)
fail = os.environ.get("STUB_FAIL_CHUNK")
if fail is not None and "--chunk-idx" in argv \
        and argv[argv.index("--chunk-idx") + 1] == fail:
    sys.exit(3)
"""


@pytest.fixture()
def stubs(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for prog in ("python", "torchrun"):
        path = bindir / prog
        path.write_text(STUB.format(python=sys.executable))
        path.chmod(0o755)
    return bindir


def run_script(stubs, tmp_path, script, env=None, args=(), check=True):
    """Run a script under the stubs from a work directory in tmp_path;
    returns (completed process, the recorded calls in order)."""
    log = tmp_path / f"calls{len(list(tmp_path.glob('calls*')))}.jsonl"
    work = tmp_path / "work"
    work.mkdir(exist_ok=True)
    full = dict(os.environ)
    for k in ("WORLD_SIZE", "NPROC_PER_NODE", "MASTER_ADDR", "MASTER_PORT",
              "RANK", "CUDA_VISIBLE_DEVICES", "CHUNKS", "ADAPTER_PATH",
              "VISION_TOWER", "GLOBAL_BATCH_SIZE", "LOCAL_BATCH_SIZE"):
        full.pop(k, None)
    full.update(PATH=f"{stubs}{os.pathsep}{os.environ['PATH']}",
                STUB_LOG=str(log), **(env or {}))
    proc = subprocess.run(["bash", script, *args], cwd=work, env=full,
                          capture_output=True, text=True, timeout=60)
    if check:
        assert proc.returncode == 0, proc.stdout + proc.stderr
    calls = ([json.loads(line) for line in log.read_text().splitlines()]
             if log.exists() else [])
    return proc, calls


def jax_script(rel):
    return os.path.join(ROOT, "scripts", rel)


def port_script(rel):
    return os.path.join(PORT_SCRIPTS, rel)


# -- the training scripts -------------------------------------------------------

def torchrun_split(argv):
    """(torchrun's own options as a dict, module, the module's flags)."""
    i = argv.index("-m")
    opts = dict(zip(argv[:i:2], argv[1:i:2]))
    return opts, argv[i + 1], argv[i + 2:]


def train_namespaces(jax_flags, port_flags):
    from videollama2_tpu.train import train as jtrain
    from videollama2_tpu_torch.train import train as ttrain
    return (vars(jtrain.build_argparser().parse_args(jax_flags)),
            vars(ttrain.build_argparser().parse_args(port_flags)))


TRAIN_ENV = {"VISION_TOWER": TOWER, "ADAPTER_PATH": "/data/adapter"}


@pytest.mark.parametrize("rel", TRAIN_SCRIPTS)
def test_train_script_flags_equal_jax(stubs, tmp_path, rel):
    work = tmp_path / "work"
    for step in (3, 12, 7):   # stage 2 takes the newest (numerically)
        (work / "work_dirs" / "vllava_pretrain" / "pretrain"
         / f"adapter-{step}").mkdir(parents=True)
    _, jcalls = run_script(stubs, tmp_path, jax_script(rel), TRAIN_ENV)
    _, tcalls = run_script(stubs, tmp_path, port_script(rel), TRAIN_ENV)
    assert [c["prog"] for c in jcalls] == ["python"]
    assert [c["prog"] for c in tcalls] == ["torchrun"]
    jflags = jcalls[0]["argv"]
    assert jflags[:2] == ["-m", "videollama2_tpu.train.train"]
    opts, module, tflags = torchrun_split(tcalls[0]["argv"])
    assert module == "videollama2_tpu_torch.train.train"
    assert opts == {"--nnodes": "1", "--nproc_per_node": "1",
                    "--master_addr": "127.0.0.1", "--master_port": "16666",
                    "--node_rank": "0"}
    want, got = train_namespaces(jflags[2:], tflags)
    assert set(got) - set(want) == {"tokenizer", "device"}
    assert got.pop("tokenizer") is None and got.pop("device") == "cuda"
    # the deviations, by name
    if rel.startswith("vllava/"):
        assert want["vision_tower"] == "openai/clip-vit-large-patch14-336"
        assert got.pop("vision_tower") == TOWER
        want.pop("vision_tower")
    if rel == "vllava/finetune.sh":
        assert want.pop("pretrain_mm_mlp_adapter") == \
            "work_dirs/vllava_pretrain/pretrain/adapter-latest"
        assert got.pop("pretrain_mm_mlp_adapter") == \
            "work_dirs/vllava_pretrain/pretrain/adapter-12"
    assert got == want


def test_custom_finetune_without_adapter_path(stubs, tmp_path):
    """JAX's custom/finetune.sh gives --pretrain_mm_mlp_adapter no value
    when ADAPTER_PATH is unset (its parser then refuses the line); the
    port's passes the flag only when it is set."""
    from videollama2_tpu.train import train as jtrain
    _, jcalls = run_script(stubs, tmp_path, jax_script("custom/finetune.sh"))
    flags = jcalls[0]["argv"][2:]
    i = flags.index("--pretrain_mm_mlp_adapter")
    assert flags[i + 1] == "--data_path"
    with pytest.raises(SystemExit):
        jtrain.build_argparser().parse_args(flags)
    _, tcalls = run_script(stubs, tmp_path,
                           port_script("custom/finetune.sh"))
    _, _, tflags = torchrun_split(tcalls[0]["argv"])
    assert "--pretrain_mm_mlp_adapter" not in tflags
    from videollama2_tpu_torch.train import train as ttrain
    got = vars(ttrain.build_argparser().parse_args(tflags))
    assert got["pretrain_mm_mlp_adapter"] is None


def test_stage2_refuses_without_a_stage1_adapter(stubs, tmp_path):
    """adapter-latest is written by nothing: the port's finetune.sh reads
    stage 1's newest adapter-{step}/ and refuses without one."""
    proc, calls = run_script(stubs, tmp_path, port_script(
        "vllava/finetune.sh"), TRAIN_ENV, check=False)
    assert proc.returncode != 0 and not calls
    assert "no adapter-{step}/" in proc.stderr


def _accum(calls):
    _, _, flags = torchrun_split(calls[0]["argv"])
    return int(flags[flags.index("--gradient_accumulation_steps") + 1])


@pytest.mark.parametrize("env,args,want", [
    # (environment, positional NNODES NPROC_PER_NODE, torchrun options +
    # accumulation)
    ({"STUB_CARDS": "4"}, (), ("1", "4", 8)),
    ({}, ("2", "4"), ("2", "4", 4)),
    ({"ARG_WORLD_SIZE": "4", "ARG_NPROC_PER_NODE": "8"}, (), ("4", "8", 1)),
    ({"WORLD_SIZE": "2", "NPROC_PER_NODE": "2", "MASTER_ADDR": "10.0.0.1",
      "MASTER_PORT": "29500", "RANK": "1"}, (), ("2", "2", 8)),
])
def test_torchrun_plumbing(stubs, tmp_path, env, args, want):
    """The platform's WORLD_SIZE (nodes) / NPROC_PER_NODE / MASTER_* / RANK
    win where set; else the positional arguments, ARG_*, and every card."""
    _, calls = run_script(stubs, tmp_path, port_script("vllava/pretrain.sh"),
                          dict(TRAIN_ENV, **env), args)
    opts, _, _ = torchrun_split(calls[0]["argv"])
    assert (opts["--nnodes"], opts["--nproc_per_node"], _accum(calls)) == want
    if "MASTER_ADDR" in env:
        assert (opts["--master_addr"], opts["--master_port"],
                opts["--node_rank"]) == ("10.0.0.1", "29500", "1")
    else:
        assert (opts["--master_addr"], opts["--master_port"],
                opts["--node_rank"]) == ("127.0.0.1", "16666", "0")


@pytest.mark.parametrize("rel,env,message", [
    ("vllava/pretrain.sh", {"GLOBAL_BATCH_SIZE": "4"}, "would be 0"),
    ("vllava/pretrain.sh", {"GLOBAL_BATCH_SIZE": "100"}, "not a multiple"),
    ("vllava/pretrain.sh", {"STUB_CARDS": "3"}, "not a multiple"),
    ("vllava/finetune.sh", {"STUB_CARDS": "64"}, "would be 0"),
    ("vllava/finetune.sh", {"GLOBAL_BATCH_SIZE": "130"}, "not a multiple"),
    ("vllava/pretrain.sh", {"STUB_CARDS": "0"}, "no CUDA card"),
])
def test_grad_accum_refusals(stubs, tmp_path, rel, env, message):
    work = tmp_path / "work"
    (work / "work_dirs" / "vllava_pretrain" / "pretrain"
     / "adapter-1").mkdir(parents=True)
    proc, calls = run_script(stubs, tmp_path, port_script(rel),
                             dict(TRAIN_ENV, **env), check=False)
    assert proc.returncode != 0 and not calls, proc.stdout
    assert message in proc.stderr


def test_jax_scripts_floor_the_accumulation_silently(stubs, tmp_path):
    """Pinned: on 3 devices JAX's pretrain.sh trains 256 / (8 x 3) = 10
    accumulation steps (a global batch of 240), where the port refuses."""
    _, calls = run_script(stubs, tmp_path, jax_script("vllava/pretrain.sh"),
                          {"STUB_JAX_DEVICES": "3"})
    flags = calls[0]["argv"]
    assert flags[flags.index("--gradient_accumulation_steps") + 1] == "10"


def test_custom_scripts_keep_four_accumulation_steps(stubs, tmp_path):
    """JAX's custom recipes fix 4 x 4 a device; the port's fix the same on
    any number of cards, whatever batch knobs stages 1 and 2 read."""
    for rel, cards in itertools.product(
            ("custom/finetune.sh", "custom/finetune_lora.sh",
             "custom/finetune_qlora.sh"), ("1", "8")):
        _, calls = run_script(stubs, tmp_path, port_script(rel), {
            "STUB_CARDS": cards, "GLOBAL_BATCH_SIZE": "6",
            "LOCAL_BATCH_SIZE": "3"})
        _, _, flags = torchrun_split(calls[0]["argv"])
        assert _accum(calls) == 4
        assert flags[flags.index("--per_device_train_batch_size") + 1] == "4"


# -- the eval scripts -------------------------------------------------------------

class _Parsed(Exception):
    pass


def parsed_namespace(module, flags, monkeypatch):
    """The namespace `module`.main() parses from `flags` (its own
    parser, stopped right after parsing)."""
    mod = importlib.import_module(module)
    orig = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise _Parsed(orig(self, args, namespace))
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        m.setattr(sys, "argv", [module] + list(flags))
        with pytest.raises(_Parsed) as e:
            mod.main()
    return vars(e.value.args[0])


def _rename(text):
    return text.replace("videollama2_tpu.", "videollama2_tpu_torch.")


@pytest.mark.parametrize("rel", EVAL_SCRIPTS)
def test_eval_script_flags_equal_jax(stubs, tmp_path, monkeypatch, rel):
    """With CHUNKS=2 on two cards: the same commands in the same order (the
    chunks in either order), each parsed by its module's parser equal to
    JAX's but for --device, the merge's Python renamed."""
    env = {"CHUNKS": "2", "CUDA_VISIBLE_DEVICES": "0,1"}
    _, jcalls = run_script(stubs, tmp_path, jax_script(rel), env)
    _, tcalls = run_script(stubs, tmp_path, port_script(rel), env)
    assert len(jcalls) == len(tcalls) >= 3

    def key(c):  # chunks run at once: order them by their index
        a = c["argv"]
        return a[a.index("--chunk-idx") + 1]
    jcalls[:2] = sorted(jcalls[:2], key=key)
    tcalls[:2] = sorted(tcalls[:2], key=key)
    for j, t in zip(jcalls, tcalls):
        assert t["prog"] == j["prog"] == "python"
        if j["argv"] == ["-"]:
            assert t["argv"] == ["-"]
            assert t["stdin"] == _rename(j["stdin"])
            continue
        assert j["argv"][0] == t["argv"][0] == "-m"
        assert t["argv"][1] == _rename(j["argv"][1])
        want = parsed_namespace(j["argv"][1], j["argv"][2:], monkeypatch)
        got = parsed_namespace(t["argv"][1], t["argv"][2:], monkeypatch)
        if "--chunk-idx" in j["argv"]:   # an inference driver
            assert set(got) - set(want) == {"tokenizer", "device"}
            assert got.pop("device") == "cuda"
            assert got.pop("tokenizer") is None
        assert got == want


def _chunk_cards(calls):
    """{chunk index: CUDA_VISIBLE_DEVICES} of the inference commands."""
    out = {}
    for c in calls:
        a = c["argv"]
        if "--chunk-idx" in a:
            assert a[a.index("--num-chunks") + 1] == str(
                sum("--chunk-idx" in d["argv"] for d in calls))
            out[int(a[a.index("--chunk-idx") + 1])] = \
                c["cuda_visible_devices"]
    return out


@pytest.mark.parametrize("env,want", [
    ({"CUDA_VISIBLE_DEVICES": "3"}, {0: "3"}),
    ({"CUDA_VISIBLE_DEVICES": "0,1"}, {0: "0", 1: "1"}),
    ({"CUDA_VISIBLE_DEVICES": "4,5,6,7"}, {0: "4", 1: "5", 2: "6", 3: "7"}),
    ({"CUDA_VISIBLE_DEVICES": "0,1", "CHUNKS": "5"},
     {0: "0", 1: "1", 2: "0", 3: "1", 4: "0"}),
    ({"CUDA_VISIBLE_DEVICES": "2", "CHUNKS": "2"}, {0: "2", 1: "2"}),
    ({"STUB_CARDS": "3"}, {0: "0", 1: "1", 2: "2"}),
])
def test_chunks_go_to_cards(stubs, tmp_path, env, want):
    """CHUNKS defaults to the cards; chunk IDX runs on card IDX % cards."""
    _, calls = run_script(stubs, tmp_path, port_script(
        "eval/eval_video_mcqa_mvbench.sh"), env)
    assert _chunk_cards(calls) == want


def test_no_card_refuses(stubs, tmp_path):
    proc, calls = run_script(stubs, tmp_path, port_script(
        "eval/eval_video_mcqa_mvbench.sh"), {"STUB_CARDS": "0"}, check=False)
    assert proc.returncode != 0 and not calls
    assert "no CUDA card" in proc.stderr


def test_a_failed_chunk_fails_the_script(stubs, tmp_path):
    """JAX's scripts `wait` and go on; the port's stop before the merge."""
    env = {"CUDA_VISIBLE_DEVICES": "0,1", "STUB_FAIL_CHUNK": "1"}
    proc, calls = run_script(stubs, tmp_path, port_script(
        "eval/eval_video_mcqa_mvbench.sh"), env, check=False)
    assert proc.returncode != 0 and "chunk failed" in proc.stderr
    assert len(calls) == 2               # the two chunks, no merge
    _, jcalls = run_script(stubs, tmp_path, jax_script(
        "eval/eval_video_mcqa_mvbench.sh"), dict(env, CHUNKS="2"))
    assert len(jcalls) == 4              # chunks, merge and scorer


def test_jax_eval_chunks_share_one_device(stubs, tmp_path):
    """Pinned: JAX's eval scripts start every chunk with the caller's
    environment: all share one device."""
    _, calls = run_script(stubs, tmp_path, jax_script(
        "eval/eval_video_mcqa_mvbench.sh"), {"CHUNKS": "3"})
    assert _chunk_cards(calls) == {0: None, 1: None, 2: None}


# -- launch_multinode ------------------------------------------------------------

def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def launchers():
    return (_load(os.path.join(ROOT, "scripts", "launch_multihost.py"),
                  "launch_multihost"),
            _load(os.path.join(PORT_SCRIPTS, "launch_multinode.py"),
                  "launch_multinode"))


MESHES = list(itertools.product((1, 2), (-1, 1, 2, 4, 3), (1, 2, 4), (1, 2),
                                (1, 2)))


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8, 16])
def test_resolve_mesh_equals_jax(launchers, world):
    jax_l, port_l = launchers
    for data, fsdp, tensor, expert, seq in MESHES:
        argv = [f"--mesh_data={data}", f"--mesh_fsdp={fsdp}",
                f"--mesh_tensor={tensor}", f"--mesh_expert={expert}",
                f"--mesh_seq={seq}", "train"]
        outs = []
        for mod in (jax_l, port_l):
            try:
                outs.append(("ok", mod.resolve_mesh(mod.parse_args(argv),
                                                    world)))
            except SystemExit as e:
                outs.append(("exit", str(e)))
        assert outs[1] == outs[0], (argv, world)


def test_dispatch_argv(launchers):
    _, port_l = launchers
    args = port_l.parse_args(["--mesh_tensor", "2", "train", "--", "--bits",
                              "8"])
    shape = port_l.resolve_mesh(args, 8)
    name, argv = port_l.task_argv(args, shape, 3, 8, "cuda:3")
    assert name == "videollama2_tpu_torch.train.train"
    assert argv == [name, "--mesh_data=1", "--mesh_fsdp=4",
                    "--mesh_tensor=2", "--mesh_expert=1", "--mesh_seq=1",
                    "--bits", "8"]
    args = port_l.parse_args(["serve_worker", "--", "--port", "1"])
    assert port_l.task_argv(args, shape, 0, 8, "cuda:0")[1] == [
        "videollama2_tpu_torch.serve.model_worker", "--port", "1"]
    mod = "videollama2_tpu_torch.eval.inference_video_mcqa_mvbench"
    args = port_l.parse_args(["eval", "--", "--module", mod, "--x", "1"])
    assert port_l.task_argv(args, shape, 5, 8, "cuda:1") == (mod, [
        mod, "--x", "1", "--device", "cuda:1", "--num-chunks", "8",
        "--chunk-idx", "5"])
    args = port_l.parse_args(["eval", "--", "--module", mod,
                              "--num-chunks", "4", "--chunk-idx", "2"])
    assert port_l.task_argv(args, shape, 5, 8, "cuda:1")[1][-2:] == [
        "--device", "cuda:1"]
    args = port_l.parse_args(["eval", "--", "--module", mod, "--device",
                              "cpu"])
    with pytest.raises(SystemExit, match="pass --device to the launcher"):
        port_l.task_argv(args, shape, 0, 1, "cuda:0")


def test_launcher_needs_torchrun(launchers, monkeypatch):
    _, port_l = launchers
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="runs under torchrun"):
        port_l.main(["train"])


def test_launcher_rank_without_a_card_raises(tmp_path):
    """Under torchrun with the default --device cuda and no card, the rank
    raises (no CPU fallback)."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1",
         os.path.join(PORT_SCRIPTS, "launch_multinode.py"), "eval", "--",
         "--module", "torch_launch_probe", "--out", str(tmp_path)],
        env=dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
                 PYTHONPATH=os.pathsep.join([HERE, ROOT])),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stdout + proc.stderr
    assert not list(tmp_path.glob("rank*.json"))


def test_world2_eval_dispatch_gives_each_rank_its_chunk(tmp_path):
    """Two gloo ranks under torchrun: rank r runs the eval module with
    --device cpu --num-chunks 2 --chunk-idx r in a group of 2."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2",
         os.path.join(PORT_SCRIPTS, "launch_multinode.py"), "--device",
         "cpu", "eval", "--", "--module", "torch_launch_probe", "--out",
         str(tmp_path)],
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 PYTHONPATH=os.pathsep.join([HERE, ROOT])),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    for rank in (0, 1):
        with open(tmp_path / f"rank{rank}.json") as f:
            got = json.load(f)
        assert got["world"] == 2 and got["backend"] == "gloo"
        assert got["argv"] == ["torch_launch_probe", "--out", str(tmp_path),
                               "--device", "cpu", "--num-chunks", "2",
                               "--chunk-idx", str(rank)], shlex.join(
                                   got["argv"])
    assert "mesh {'data': 1, 'fsdp': 2" in proc.stdout
