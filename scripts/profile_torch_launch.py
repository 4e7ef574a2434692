#!/usr/bin/env python3
"""The port's launch scripts (scripts/torch/) each alone on one NVIDIA GPU,
in turn: vllava/pretrain.sh, vllava/finetune.sh over its newest adapter,
custom/finetune_lora.sh and custom/finetune_qlora.sh (their 4 x 4), then
eval/eval_video_mcqa_mvbench.sh at CHUNKS 2 and 1 and
eval/eval_video_mcqa_videomme.sh over the committed parquet fixture. They
run on chip_smoke.py's seeded checkpoint (VideoLLaMA2-7B-16F at full
width, the LLM cut to 8 layers), corpus and media, with chip_smoke's
checks: exact kernel launches, every trained tensor moved, merged records
equal. chip_smoke.py runs some of these scripts beside other processes to
keep within its time; here each has the card and the host to itself.
Prints the card's name and power limit, each script's `[launch]` lines
and a JSON summary. Usage, from the repository root:

    python3 scripts/profile_torch_launch.py
"""

import gc
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def train_scripts(api, root, counters) -> dict:
    """The four training scripts in turn, checked as chip_smoke checks
    them; each one's wall seconds, start to first step, steps and peak."""
    corpus = os.path.join(root, "corpus")
    cs.write_train_corpus(corpus)
    mcfg = cs.api_config().replace(num_frames=8)
    llm, tower = cs.write_plain_dirs(os.path.join(root, "mistral"), mcfg,
                                     api)
    launcher = cs.Launcher(root)
    outputs = os.path.join(root, "outputs")
    env = dict(DATA_DIR=corpus, OUTP_DIR=outputs, ARG_NPROC_PER_NODE=1)
    stage = dict(env, MODEL_PATH=llm, VISION_TOWER=tower)
    runs = [
        ("vllava/pretrain.sh", dict(
            stage, GLOBAL_BATCH_SIZE=cs.TE_MB * cs.TE_ACCUM,
            LOCAL_BATCH_SIZE=cs.TE_MB),
         (cs.TE_STEPS, cs.TE_ACCUM, cs.TE_MB), "vllava_pretrain/pretrain"),
        ("vllava/finetune.sh", dict(
            stage, GLOBAL_BATCH_SIZE=cs.TE_FT_MB * cs.TE_FT_ACCUM,
            LOCAL_BATCH_SIZE=cs.TE_FT_MB),
         (cs.TE_SFT_MEDIA // (cs.TE_FT_MB * cs.TE_FT_ACCUM), cs.TE_FT_ACCUM,
          cs.TE_FT_MB), "vllava_finetune/finetune"),
        ("custom/finetune_lora.sh", dict(env, MODEL_PATH=api),
         (1, cs.CUSTOM_ACCUM, cs.CUSTOM_MB), "custom_lora"),
        ("custom/finetune_qlora.sh", dict(env, MODEL_PATH=api),
         (1, cs.CUSTOM_ACCUM, cs.CUSTOM_MB), "custom_qlora")]
    out = {}
    for rel, script_env, (steps, accum, mb), out_dir in runs:
        label = os.path.basename(rel)
        want = cs.entry_launches(counters, mcfg, steps, accum, mb)
        res, _ = cs.launch_train(
            label, launcher.run(label, rel, **script_env), want,
            os.path.join(outputs, out_dir),
            may_stay=("lora/a",) if rel.startswith("custom/") else ())
        out[label] = {"script_s": res["script_s"],
                      "start_to_first_step_s": res["start_to_first_step_s"],
                      "step_s": [st["s"] for st in res["steps"]],
                      "peak_gb": res["peak_gb"],
                      "launches": res["launches"]}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_launch: no CUDA device")
    from videollama2_tpu_torch.ops import _build
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip())
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_all = time.perf_counter()
    _build.library()
    counters = cs.kernel_counters()
    summary = {}
    with tempfile.TemporaryDirectory() as api, \
            tempfile.TemporaryDirectory() as root:
        cs.write_api_checkpoint(api)
        gc.collect()
        torch.cuda.empty_cache()
        summary["train"] = train_scripts(api, os.path.join(root, "train"),
                                         counters)
        eval_root = os.path.join(root, "eval")
        os.makedirs(eval_root)
        media = cs.write_eval_media(eval_root)
        want_b1 = cs.phase_launches(counters, cs.api_config(), 1, True, 0,
                                    False)
        launch, _ = cs.run_launch_eval(api, media, eval_root, counters, {},
                                       want_b1, together=False)
        summary["eval"] = {k: v for k, v in launch.items()
                           if k != "fixture"}
    summary["total_s"] = time.perf_counter() - t_all
    print(json.dumps({"profile_torch_launch": summary}), flush=True)


if __name__ == "__main__":
    main()
