"""Write Hugging Face tokenizer directories without transformers.

`write_mistral(dir)` writes the files of a Mistral / Llama-2 style
tokenizer (SentencePiece-style BPE over "▁" pieces with `<0xNN>` byte
fallback, `LlamaTokenizer` class, Mistral-Instruct's chat template) at the
full 32,000 entries: `<unk>`, `<s>`, `</s>`, 256 byte tokens and 31,741
pieces; `legacy=True` gives the older serialization (a Prepend + Replace
normalizer, no pre-tokenizer, merges as "a b" strings), `legacy=False` the
newer one (a Metaspace pre-tokenizer with prepend_scheme "first", merges as
pairs). `write_qwen2(dir)` writes Qwen2's (byte-level BPE behind Qwen2's
Split regex, NFC, ChatML template) at 151,643 BPE entries plus
`<|endoftext|>`, `<|im_start|>` and `<|im_end|>`. Both take a smaller
`vocab_size` for quick tests.

The merges are learned by a plain-Python BPE trainer on the repository's
reference documents (SURVEY.md, PAPER.md, which the repository keeps as
they are) until no pair is left, then filled to the size with seeded
merges of existing pieces, so the same call writes the same files on every
host. chip_smoke.py writes its checkpoints' tokenizers with it; the GPU
host has no tokenizer library.
"""

from __future__ import annotations

import functools
import heapq
import json
import os
import random
import sys
import unicodedata
from collections import Counter
from typing import Dict, List, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = ("SURVEY.md", "PAPER.md")
MISTRAL_VOCAB = 32000
QWEN2_VOCAB = 151643  # BPE entries; the three added tokens follow
QWEN2_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
               r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
MAX_PIECE = 16

# Mistral-7B-Instruct's template with its optional leading system message
MISTRAL_CHAT_TEMPLATE = (
    "{%- if messages[0]['role'] == 'system' %}\n"
    "    {%- set system_message = messages[0]['content'] %}\n"
    "    {%- set loop_messages = messages[1:] %}\n"
    "{%- else %}\n"
    "    {%- set loop_messages = messages %}\n"
    "{%- endif %}\n\n"
    "{{- bos_token }}\n"
    "{%- for message in loop_messages %}\n"
    "    {%- if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}\n"
    "        {{- raise_exception('After the optional system message, "
    "conversation roles must alternate user/assistant/user/assistant/...') }}\n"
    "    {%- endif %}\n"
    "    {%- if message['role'] == 'user' %}\n"
    "        {%- if loop.first and system_message is defined %}\n"
    "            {{- ' [INST] ' + system_message + '\\n\\n' + "
    "message['content'] + ' [/INST]' }}\n"
    "        {%- else %}\n"
    "            {{- ' [INST] ' + message['content'] + ' [/INST]' }}\n"
    "        {%- endif %}\n"
    "    {%- elif message['role'] == 'assistant' %}\n"
    "        {{- ' ' + message['content'] + eos_token}}\n"
    "    {%- else %}\n"
    "        {{- raise_exception('Only user and assistant roles are "
    "supported, with the exception of an initial optional system "
    "message!') }}\n"
    "    {%- endif %}\n"
    "{%- endfor %}\n")

# Qwen2-7B-Instruct's ChatML template
QWEN2_CHAT_TEMPLATE = (
    "{% for message in messages %}{% if loop.first and messages[0]['role'] "
    "!= 'system' %}{{ '<|im_start|>system\nYou are a helpful assistant."
    "<|im_end|>\n' }}{% endif %}{{'<|im_start|>' + message['role'] + '\n' "
    "+ message['content'] + '<|im_end|>' + '\n'}}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|im_start|>assistant\n' }}"
    "{% endif %}")


def corpus_text() -> str:
    return "\n".join(open(os.path.join(ROOT, name), encoding="utf-8").read()
                     for name in CORPUS)


def train_merges(words: Counter, limit: int) -> List[Tuple[str, str]]:
    """BPE merges of `words` (a Counter of symbol tuples), most frequent
    pair first (ties: the smaller pair), until no pair is left or `limit`
    merges."""
    items = [(list(w), c) for w, c in words.items() if len(w) > 1]
    counts: Dict[Tuple[str, str], int] = Counter()
    where: Dict[Tuple[str, str], set] = {}
    for i, (w, c) in enumerate(items):
        for p in zip(w, w[1:]):
            counts[p] += c
            where.setdefault(p, set()).add(i)
    heap = [(-c, p) for p, c in counts.items()]
    heapq.heapify(heap)
    merges = []
    while heap and len(merges) < limit:
        neg, pair = heapq.heappop(heap)
        if counts.get(pair, 0) != -neg or neg == 0:
            continue
        merges.append(pair)
        a, b = pair
        new = a + b
        changed = set()
        for i in sorted(where.pop(pair, ())):
            w, c = items[i]
            old = Counter(zip(w, w[1:]))
            out = []
            j = 0
            while j < len(w):
                if j + 1 < len(w) and w[j] == a and w[j + 1] == b:
                    out.append(new)
                    j += 2
                else:
                    out.append(w[j])
                    j += 1
            items[i] = (out, c)
            fresh = Counter(zip(out, out[1:]))
            for p, n in old.items():
                counts[p] -= n * c
                changed.add(p)
                if p not in fresh and p in where:
                    where[p].discard(i)
            for p, n in fresh.items():
                counts[p] += n * c
                changed.add(p)
                where.setdefault(p, set()).add(i)
        counts.pop(pair, None)
        for p in sorted(changed):
            if counts.get(p, 0) > 0 and p != pair:
                heapq.heappush(heap, (-counts[p], p))
    return merges


def _fill(vocab: Dict[str, int], merges: List[Tuple[str, str]], size: int,
          seed: int, allow) -> None:
    """Seeded merges of two existing pieces of at most MAX_PIECE / 2
    characters each until the vocabulary has `size` entries."""
    rng = random.Random(seed)
    short = [p for p in vocab if len(p) <= MAX_PIECE // 2]
    while len(vocab) < size:
        a = short[int(rng.random() * len(short))]
        b = short[int(rng.random() * len(short))]
        new = a + b
        if new in vocab or not allow(a, b):
            continue
        vocab[new] = len(vocab)
        if len(new) <= MAX_PIECE // 2:
            short.append(new)
        merges.append((a, b))


def _learn(vocab: Dict[str, int], words: Counter, size: int,
           seed: int, allow) -> List[Tuple[str, str]]:
    """Trained merges, then seeded ones, up to `size` vocabulary entries."""
    merges = []
    for a, b in train_merges(words, size):
        if len(vocab) >= size:
            break
        if a + b not in vocab:
            vocab[a + b] = len(vocab)
        merges.append((a, b))
    _fill(vocab, merges, size, seed, allow)
    return merges


def _added(content: str, tid: int) -> dict:
    return {"id": tid, "content": content, "single_word": False,
            "lstrip": False, "rstrip": False, "normalized": False,
            "special": True}


def _decoder_entry(t: dict) -> dict:
    return {k: t[k] for k in ("content", "lstrip", "normalized", "rstrip",
                              "single_word", "special")}


def _write(path: str, tokenizer: dict, config: dict, special: dict) -> str:
    os.makedirs(path, exist_ok=True)
    for name, obj in (("tokenizer.json", tokenizer),
                      ("tokenizer_config.json", config),
                      ("special_tokens_map.json", special)):
        with open(os.path.join(path, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False, indent=1)
    return path


def mistral_words(text: str, alphabet) -> Counter:
    """SentencePiece-style training words: "▁"-led runs of alphabet
    characters (other characters take the byte fallback)."""
    words = Counter()
    cur = []
    for ch in "▁" + text.replace(" ", "▁"):
        if ch not in alphabet or (ch == "▁" and cur and cur[-1] != "▁"):
            if cur:
                words[tuple(cur)] += 1
            cur = [] if ch not in alphabet else [ch]
        else:
            cur.append(ch)
    if cur:
        words[tuple(cur)] += 1
    return words


@functools.lru_cache(maxsize=4)
def mistral_model(vocab_size: int = MISTRAL_VOCAB, seed: int = 0):
    """The Mistral family's (vocab, merges), shared by both
    serializations."""
    text = corpus_text()
    alphabet = sorted({chr(c) for c in range(0x21, 0x7F)} | {"▁"} | {
        ch for ch in text if ch.isprintable() and ch != " "})
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for ch in alphabet:
        vocab[ch] = len(vocab)
    merges = _learn(vocab, mistral_words(text, set(alphabet)), vocab_size,
                    seed, lambda a, b: not b.startswith("▁") and
                    not a.startswith("<0x"))
    return vocab, merges


def write_mistral(path: str, vocab_size: int = MISTRAL_VOCAB,
                  legacy: bool = True, seed: int = 0) -> str:
    """A Mistral / Llama-2 style tokenizer directory (module docstring)."""
    vocab, merges = mistral_model(vocab_size, seed)
    added = [_added("<unk>", 0), _added("<s>", 1), _added("</s>", 2)]
    model = {"type": "BPE", "dropout": None, "unk_token": "<unk>",
             "continuing_subword_prefix": None, "end_of_word_suffix": None,
             "fuse_unk": True, "byte_fallback": True,
             "ignore_merges": False, "vocab": vocab,
             "merges": ([f"{a} {b}" for a, b in merges] if legacy
                        else [[a, b] for a, b in merges])}
    template = {"type": "TemplateProcessing",
                "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                           {"Sequence": {"id": "A", "type_id": 0}}],
                "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                         {"Sequence": {"id": "A", "type_id": 0}},
                         {"SpecialToken": {"id": "<s>", "type_id": 1}},
                         {"Sequence": {"id": "B", "type_id": 1}}],
                "special_tokens": {"<s>": {"id": "<s>", "ids": [1],
                                           "tokens": ["<s>"]}}}
    if legacy:
        normalizer = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "},
             "content": "▁"}]}
        pre_tokenizer = None
        decoder = {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
    else:
        normalizer = None
        pre_tokenizer = {"type": "Metaspace", "replacement": "▁",
                         "prepend_scheme": "first", "split": False}
        decoder = {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
    tokenizer = {"version": "1.0", "truncation": None, "padding": None,
                 "added_tokens": added, "normalizer": normalizer,
                 "pre_tokenizer": pre_tokenizer, "post_processor": template,
                 "decoder": decoder, "model": model}
    config = {"add_bos_token": True, "add_eos_token": False,
              "added_tokens_decoder": {str(t["id"]): _decoder_entry(t)
                                       for t in added},
              "additional_special_tokens": [], "bos_token": "<s>",
              "chat_template": MISTRAL_CHAT_TEMPLATE,
              "clean_up_tokenization_spaces": False, "eos_token": "</s>",
              "legacy": legacy, "model_max_length": 1000000000000000019884624838656,
              "pad_token": None, "sp_model_kwargs": {},
              "spaces_between_special_tokens": False,
              "tokenizer_class": "LlamaTokenizer", "unk_token": "<unk>",
              "use_default_system_prompt": False}
    special = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>"}
    return _write(path, tokenizer, config, special)


def _byte_chars() -> Tuple[List[str], Dict[int, str]]:
    """GPT-2's 256 byte characters in its id order."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return [chr(c) for c in cs], dict(zip(bs, (chr(c) for c in cs)))


def qwen2_words(text: str) -> Counter:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from videollama2_tpu_torch.multimodal.hf_tokenizer import translate_regex
    _, to_char = _byte_chars()
    words = Counter()
    for piece in translate_regex(QWEN2_SPLIT).findall(
            unicodedata.normalize("NFC", text)):
        words[tuple(to_char[b] for b in piece.encode("utf-8"))] += 1
    return words


def write_qwen2(path: str, vocab_size: int = QWEN2_VOCAB,
               seed: int = 0) -> str:
    """A Qwen2 tokenizer directory (module docstring)."""
    chars, _ = _byte_chars()
    vocab = {c: i for i, c in enumerate(chars)}
    merges = _learn(vocab, qwen2_words(corpus_text()), vocab_size, seed,
                    lambda a, b: True)
    added = [_added("<|endoftext|>", vocab_size),
             _added("<|im_start|>", vocab_size + 1),
             _added("<|im_end|>", vocab_size + 2)]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False,
                  "trim_offsets": False, "use_regex": False}
    tokenizer = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_SPLIT},
             "behavior": "Isolated", "invert": False}, byte_level]},
        "post_processor": byte_level, "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": vocab,
                  "merges": [f"{a} {b}" for a, b in merges]}}
    config = {"add_prefix_space": False,
              "added_tokens_decoder": {str(t["id"]): _decoder_entry(t)
                                       for t in added},
              "additional_special_tokens": ["<|im_start|>", "<|im_end|>"],
              "bos_token": None, "chat_template": QWEN2_CHAT_TEMPLATE,
              "clean_up_tokenization_spaces": False,
              "eos_token": "<|im_end|>", "errors": "replace",
              "model_max_length": 32768, "pad_token": "<|endoftext|>",
              "split_special_tokens": False,
              "tokenizer_class": "Qwen2Tokenizer", "unk_token": None}
    special = {"additional_special_tokens": ["<|im_start|>", "<|im_end|>"],
               "eos_token": "<|im_end|>", "pad_token": "<|endoftext|>"}
    return _write(path, tokenizer, config, special)
