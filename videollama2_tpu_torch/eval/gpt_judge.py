"""GPT-judge scoring for open-ended QA / captioning benchmarks.

Parity: the reference's eight Azure-OpenAI judge scripts
(eval_video_oqa_activitynet.py, eval_video_oqa_vcgpt_{1..5}_*.py,
eval_video_cap_msvc_{correctness,detailedness}.py) share one structure:
thread-pool fan-out, per-sample JSON result files, idempotent
retry-until-complete, then accuracy = yes/(yes+no) and average 0-5 score
(eval_video_oqa_activitynet.py:123-192). The per-dimension judge prompts are
the standard Video-ChatGPT quantitative-evaluation prompts the reference
uses (citations per entry below).

One generic driver replaces all eight scripts:
  python -m videollama2_tpu.eval.gpt_judge --dimension correctness \
      --pred-file preds.jsonl --output-dir out/ [--api-key ... | --api none]

`--api none` runs a deterministic offline stub (exact-match heuristic) so the
pipeline is testable without network.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

# dimension -> (system prompt, asks_for_score, ref file:line)
JUDGES: Dict[str, dict] = {
    # eval_video_oqa_activitynet.py:~54 (accuracy + 0-5 score)
    "activitynet": dict(
        system=(
            "You are an intelligent chatbot designed for evaluating the "
            "correctness of generative outputs for question-answer pairs. "
            "Your task is to compare the predicted answer with the correct "
            "answer and determine if they match meaningfully. Consider "
            "synonyms and paraphrases as valid matches. Evaluate the "
            "correctness of the prediction."),
        user=("Please evaluate the following video-based question-answer "
              "pair:\n\nQuestion: {question}\nCorrect Answer: {answer}\n"
              "Predicted Answer: {pred}\n\nProvide your evaluation only as "
              "a yes/no and score where the score is an integer value "
              "between 0 and 5, with 5 indicating the highest meaningful "
              "match. Please generate the response in the form of a Python "
              "dictionary string with keys 'pred' and 'score', where value "
              "of 'pred' is a string of 'yes' or 'no' and value of 'score' "
              "is in INTEGER, not STRING. DO NOT PROVIDE ANY OTHER OUTPUT "
              "TEXT OR EXPLANATION. For example, your response should look "
              "like this: {{'pred': 'yes', 'score': 4.8}}."),
        yes_no=True),
    # eval_video_oqa_vcgpt_1_correctness.py:54
    "correctness": dict(
        system=(
            "You are an intelligent chatbot designed for evaluating the "
            "factual accuracy of generative outputs for video-based "
            "question-answer pairs. Your task is to compare the predicted "
            "answer with the correct answer and determine if they are "
            "factually consistent, without hallucinations or "
            "contradictions."),
        user=("Please evaluate the following video-based question-answer "
              "pair:\n\nQuestion: {question}\nCorrect Answer: {answer}\n"
              "Predicted Answer: {pred}\n\nProvide your evaluation only as "
              "a factual accuracy score where the score is an integer value "
              "between 0 and 5. Return the response as a Python dictionary "
              "string with key 'score'. DO NOT PROVIDE ANY OTHER OUTPUT "
              "TEXT OR EXPLANATION."),
        yes_no=False),
    # eval_video_oqa_vcgpt_2_detailed_orientation.py:53
    "detailed_orientation": dict(
        system=(
            "You are an intelligent chatbot designed for evaluating the "
            "detail orientation of generative outputs for video-based "
            "question-answer pairs. Your task is to determine whether the "
            "predicted answer covers all major points and includes specific "
            "details rather than generic statements."),
        user=("Please evaluate the following video-based question-answer "
              "pair:\n\nQuestion: {question}\nCorrect Answer: {answer}\n"
              "Predicted Answer: {pred}\n\nProvide your evaluation only as "
              "a detail-orientation score (integer 0-5) as a Python "
              "dictionary string with key 'score'. DO NOT PROVIDE ANY "
              "OTHER OUTPUT TEXT OR EXPLANATION."),
        yes_no=False),
    # eval_video_oqa_vcgpt_3_context.py:55
    "context": dict(
        system=(
            "You are an intelligent chatbot designed for evaluating the "
            "contextual understanding of generative outputs for video-based "
            "question-answer pairs. Your task is to determine whether the "
            "predicted answer aligns with the overall context of the video "
            "content."),
        user=("Please evaluate the following video-based question-answer "
              "pair:\n\nQuestion: {question}\nCorrect Answer: {answer}\n"
              "Predicted Answer: {pred}\n\nProvide your evaluation only as "
              "a contextual-understanding score (integer 0-5) as a Python "
              "dictionary string with key 'score'. DO NOT PROVIDE ANY "
              "OTHER OUTPUT TEXT OR EXPLANATION."),
        yes_no=False),
    # eval_video_oqa_vcgpt_4_temporal.py:50
    "temporal": dict(
        system=(
            "You are an intelligent chatbot designed for evaluating the "
            "temporal understanding of generative outputs for video-based "
            "question-answer pairs. Your task is to determine whether the "
            "predicted answer correctly reflects the order and timing of "
            "events in the video."),
        user=("Please evaluate the following video-based question-answer "
              "pair:\n\nQuestion: {question}\nCorrect Answer: {answer}\n"
              "Predicted Answer: {pred}\n\nProvide your evaluation only as "
              "a temporal-understanding score (integer 0-5) as a Python "
              "dictionary string with key 'score'. DO NOT PROVIDE ANY "
              "OTHER OUTPUT TEXT OR EXPLANATION."),
        yes_no=False),
    # eval_video_oqa_vcgpt_5_consistency.py:56 (two questions, one answer)
    "consistency": dict(
        system=(
            "You are an intelligent chatbot designed for evaluating the "
            "consistency of generative outputs for similar video-based "
            "question-answer pairs. Your task is to determine whether the "
            "two predicted answers to differently-phrased versions of the "
            "same question are consistent with each other and the correct "
            "answer."),
        user=("Please evaluate the following video-based question-answer "
              "pairs:\n\nQuestion 1: {question}\nQuestion 2: {question2}\n"
              "Correct Answer: {answer}\nPredicted Answer 1: {pred}\n"
              "Predicted Answer 2: {pred2}\n\nProvide your evaluation only "
              "as a consistency score (integer 0-5) as a Python dictionary "
              "string with key 'score'. DO NOT PROVIDE ANY OTHER OUTPUT "
              "TEXT OR EXPLANATION."),
        yes_no=False),
    # eval_video_cap_msvc_correctness.py:56
    "msvc_correctness": dict(
        system=(
            "You are an intelligent chatbot designed for evaluating the "
            "factual accuracy of video captions. Your task is to compare "
            "the predicted caption against a set of human-annotated "
            "captions of the same video and determine factual consistency."),
        user=("Please evaluate the following video caption:\n\n"
              "Human Captions: {answer}\nPredicted Caption: {pred}\n\n"
              "Provide your evaluation only as a factual accuracy score "
              "(integer 0-5) as a Python dictionary string with key "
              "'score'. DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR "
              "EXPLANATION."),
        yes_no=False),
    # eval_video_cap_msvc_detailedness.py:55
    "msvc_detailedness": dict(
        system=(
            "You are an intelligent chatbot designed for evaluating the "
            "detailedness of video captions. Your task is to compare the "
            "predicted caption against human-annotated captions and "
            "determine how comprehensive and specific it is."),
        user=("Please evaluate the following video caption:\n\n"
              "Human Captions: {answer}\nPredicted Caption: {pred}\n\n"
              "Provide your evaluation only as a detailedness score "
              "(integer 0-5) as a Python dictionary string with key "
              "'score'. DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR "
              "EXPLANATION."),
        yes_no=False),
}


def make_client(api: str, api_key: Optional[str], endpoint: Optional[str],
                model: str):
    """Returns judge_fn(system, user) -> text."""
    if api == "none":
        def stub(system: str, user: str) -> str:
            # deterministic offline heuristic: token-overlap pseudo-judge
            import re
            m = re.search(r"Correct Answer: (.*?)\n", user)
            p = re.search(r"Predicted Answer(?: 1)?: (.*?)(\n|$)", user)
            a = set((m.group(1).lower().split() if m else []))
            b = set((p.group(1).lower().split() if p else []))
            overlap = len(a & b) / max(len(a | b), 1)
            yes = "yes" if overlap > 0.3 else "no"
            return str({"pred": yes, "score": round(overlap * 5)})
        return stub
    if api == "azure":
        from openai import AzureOpenAI  # optional dep, gated
        client = AzureOpenAI(api_key=api_key, azure_endpoint=endpoint,
                             api_version="2024-02-01")
    else:
        from openai import OpenAI
        client = OpenAI(api_key=api_key, base_url=endpoint)

    def call(system: str, user: str) -> str:
        resp = client.chat.completions.create(
            model=model,
            messages=[{"role": "system", "content": system},
                      {"role": "user", "content": user}])
        return resp.choices[0].message.content

    return call


def parse_judgment(text: str) -> dict:
    try:
        d = ast.literal_eval(text.strip())
        if isinstance(d, dict):
            return d
    except Exception:
        pass
    import re
    out = {}
    m = re.search(r"'?pred'?\s*[:=]\s*'?(yes|no)", text, re.IGNORECASE)
    if m:
        out["pred"] = m.group(1).lower()
    m = re.search(r"'?score'?\s*[:=]\s*([0-9.]+)", text)
    if m:
        out["score"] = float(m.group(1))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dimension", required=True, choices=sorted(JUDGES))
    ap.add_argument("--pred-file", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--output-json", default=None)
    ap.add_argument("--api", default="azure",
                    choices=["azure", "openai", "none"])
    ap.add_argument("--api-key", default=os.environ.get("AZURE_OPENAI_KEY"))
    ap.add_argument("--api-endpoint",
                    default=os.environ.get("AZURE_OPENAI_ENDPOINT"))
    ap.add_argument("--model", default="gpt-3.5-turbo")
    ap.add_argument("--num-tasks", type=int, default=4)
    ap.add_argument("--max-rounds", type=int, default=10)
    args = ap.parse_args()

    judge = JUDGES[args.dimension]
    call = make_client(args.api, args.api_key, args.api_endpoint, args.model)
    os.makedirs(args.output_dir, exist_ok=True)

    with open(args.pred_file) as f:
        text = f.read().strip()
    preds = (json.loads(text) if text.startswith("[")
             else [json.loads(l) for l in text.splitlines()])
    by_id = {str(p.get("question_id", p.get("id", i))): p
             for i, p in enumerate(preds)}

    def annotate(qid: str):
        p = by_id[qid]
        # accept both this repo's generic keys and the reference drivers'
        # record shapes: activitynet {'id','question','answer','pred'},
        # vcgpt general {'Q','A','P'}, consistency {'Q1','Q2','A','P1','P2'},
        # msvc {'question','answer','pred'}
        user = judge["user"].format(
            question=p.get("question", p.get("Q", p.get("Q1", ""))),
            answer=p.get("answer", p.get("A", "")),
            pred=p.get("pred", p.get("P", p.get("P1", ""))),
            question2=p.get("question2", p.get("Q2", "")),
            pred2=p.get("pred2", p.get("P2", "")))
        result = parse_judgment(call(judge["system"], user))
        with open(os.path.join(args.output_dir, f"{qid}.json"), "w") as f:
            json.dump({"id": qid, **result}, f)

    # retry-until-complete (eval_video_oqa_activitynet.py:123-149)
    for _ in range(args.max_rounds):
        todo = [qid for qid in by_id
                if not os.path.exists(
                    os.path.join(args.output_dir, f"{qid}.json"))]
        if not todo:
            break
        print(f"{len(todo)} samples remaining")
        with ThreadPoolExecutor(max_workers=args.num_tasks) as ex:
            list(ex.map(lambda q: _safe(annotate, q), todo))

    # aggregate
    yes = no = 0
    scores = []
    for qid in by_id:
        path = os.path.join(args.output_dir, f"{qid}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            r = json.load(f)
        if "score" in r:
            scores.append(float(r["score"]))
        if judge["yes_no"] and "pred" in r:
            if r["pred"] == "yes":
                yes += 1
            else:
                no += 1
    report = {"dimension": args.dimension,
              "average_score": sum(scores) / max(len(scores), 1),
              "n": len(scores)}
    if judge["yes_no"]:
        report["accuracy"] = yes / max(yes + no, 1)
    print(json.dumps(report, indent=2))
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(report, f, indent=2)


def _safe(fn, *a):
    try:
        fn(*a)
    except Exception as e:
        print("judge error:", e)
        time.sleep(1)


if __name__ == "__main__":
    main()
