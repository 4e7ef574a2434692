"""The port's tokenizer reader (multimodal/hf_tokenizer.py) against
`transformers.AutoTokenizer.from_pretrained(dir, use_fast=True)`, the JAX
package's call, with tolerance zero.

Directories, for each family: the files tests/tokenizer_writer.py writes
(Mistral in both serializations, Qwen2) at reduced vocabulary; a BPE that
the `tokenizers` library trained and transformers saved, in each
serialization; and scripts/make_tiny_checkpoint.py's WordLevel tokenizer.
Compared: ids with and without special tokens, the multimodal prompt ids of
chat-templated video, image, audio-visual and text prompts (the JAX
package's build_prompt_ids), chat-template strings, decode with and without
skip_special_tokens, the special tokens and ids, len() and
model_max_length, and a hypothesis property over random text. The committed
golden ids (tests/fixtures/tokenizer_golden.json, which chip_smoke.py holds
the reader to on the GPU host) must equal what `tokenizers` gives now on
the full-vocabulary files.

The reader's Unicode classes come from Python's unicodedata, the Rust
engines' from their own tables, of a later Unicode version:
test_unicode_classes_match_the_rust_engines finds, over every code point,
where they differ, and pins that each such code point is one Python's
tables leave unassigned. The hypothesis property draws from assigned code
points for that reason.
"""

import hashlib
import json
import logging
import os
import sys
import unicodedata

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "scripts"), os.path.join(ROOT, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import tokenizer_writer as writer  # noqa: E402
from videollama2_tpu.core import config as jcfglib  # noqa: E402
from videollama2_tpu.inference import api as japi  # noqa: E402
from videollama2_tpu_torch.core import config as tcfglib  # noqa: E402
from videollama2_tpu_torch.inference import api as tapi  # noqa: E402
from videollama2_tpu_torch.multimodal import chat_template  # noqa: E402
from videollama2_tpu_torch.multimodal import hf_tokenizer as hf  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "fixtures", "tokenizer_golden.json")
QWEN2_BPE = 5000
MISTRAL_BPE = 3000
# the family of each directory: its model type for build_prompt_ids
FAMILY = {"writer_mistral_legacy": "videollama2_mistral",
          "writer_mistral_metaspace": "videollama2_mistral",
          "writer_qwen2": "videollama2_qwen2",
          "hf_mistral_legacy": "videollama2_mistral",
          "hf_mistral_metaspace": "videollama2_mistral",
          "hf_qwen2": "videollama2_qwen2",
          "wordlevel": "videollama2_mistral"}
DIRS = sorted(FAMILY)
TEXTS = [
    "What is happening in this video?",
    "  Two  spaces,\ttabs\tand\nnew lines\r\n end ",
    "Ünïcödé: naïve café, 日本語のテキスト, Ελληνικά, русский, عربى, 🎉🚀!",
    "<s>[INST] Describe the scene. [/INST] A cat.</s>",
    "<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n",
    "It's, we're, they've, I'm, he'll, she'd; DON'T 'S 'Ll",
    "numbers 1234567 3.14159 1e-9 ٣٤ ½ Ⅻ",
    "a<s>b</s>c<unk>d", "", " ", "\n\n", "▁leading meta", "x" * 300,
    "<video>\nWhat happens? <image> <audio>",
]


def _quiet():
    logging.getLogger("transformers").setLevel(logging.ERROR)


def _bytes_first(tokenizer_json: str, specials) -> str:
    """A trained SentencePiece-style BPE with the 256 <0xNN> tokens put
    right after the special tokens (as Llama's vocabulary holds them)."""
    spec = json.loads(tokenizer_json)
    old = spec["model"]["vocab"]
    vocab = {s: i for i, s in enumerate(specials)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for s, _ in sorted(old.items(), key=lambda kv: kv[1]):
        vocab.setdefault(s, len(vocab))
    spec["model"]["vocab"] = vocab
    for t in spec["added_tokens"]:
        t["id"] = vocab[t["content"]]
    return json.dumps(spec)


def _hf_mistral(path, legacy):
    """A Mistral-style BPE trained by `tokenizers`, saved by transformers'
    LlamaTokenizerFast."""
    from tokenizers import (Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, trainers)
    from transformers import LlamaTokenizerFast
    specials = ["<unk>", "<s>", "</s>"]
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True,
                               fuse_unk=True))
    if legacy:
        tok.normalizer = normalizers.Sequence([
            normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    else:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement="▁", prepend_scheme="first", split=False)
    tok.decoder = decoders.Sequence([
        decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
        decoders.Strip(" ", 1, 0)])
    tok.train_from_iterator(
        writer.corpus_text()[:20000].split("\n"),
        trainers.BpeTrainer(vocab_size=1500, special_tokens=specials,
                            show_progress=False))
    tok = Tokenizer.from_str(_bytes_first(tok.to_str(), specials))
    fast = LlamaTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                              bos_token="<s>", eos_token="</s>",
                              add_bos_token=True, add_eos_token=False,
                              legacy=legacy)
    fast.chat_template = writer.MISTRAL_CHAT_TEMPLATE
    fast.save_pretrained(path)
    return path


def _hf_qwen2(path):
    """A byte-level BPE behind Qwen2's regex trained by `tokenizers`,
    saved by transformers' Qwen2TokenizerFast."""
    from tokenizers import (Regex, Tokenizer, decoders, models, normalizers,
                            pre_tokenizers, processors, trainers)
    from transformers import Qwen2TokenizerFast
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(writer.QWEN2_SPLIT), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    tok.train_from_iterator(
        writer.corpus_text()[:20000].split("\n"),
        trainers.BpeTrainer(
            vocab_size=1500, show_progress=False,
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
            special_tokens=["<|endoftext|>", "<|im_start|>", "<|im_end|>"]))
    fast = Qwen2TokenizerFast(tokenizer_object=tok, eos_token="<|im_end|>",
                              pad_token="<|endoftext|>", unk_token=None,
                              additional_special_tokens=["<|im_start|>",
                                                         "<|im_end|>"])
    fast.chat_template = writer.QWEN2_CHAT_TEMPLATE
    fast.save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory):
    _quiet()
    from make_tiny_checkpoint import build_tokenizer
    base = tmp_path_factory.mktemp("tok")
    out = {
        "writer_mistral_legacy": writer.write_mistral(
            str(base / "wml"), MISTRAL_BPE, legacy=True),
        "writer_mistral_metaspace": writer.write_mistral(
            str(base / "wmm"), MISTRAL_BPE, legacy=False),
        "writer_qwen2": writer.write_qwen2(str(base / "wq"), QWEN2_BPE),
        "hf_mistral_legacy": _hf_mistral(str(base / "hml"), True),
        "hf_mistral_metaspace": _hf_mistral(str(base / "hmm"), False),
        "hf_qwen2": _hf_qwen2(str(base / "hq")),
    }
    build_tokenizer(str(base / "wl"), 256)
    out["wordlevel"] = str(base / "wl")
    return out


@pytest.fixture(scope="module")
def pairs(tok_dirs):
    """name -> (reader, AutoTokenizer) on the same directory."""
    from transformers import AutoTokenizer
    return {n: (hf.load(d), AutoTokenizer.from_pretrained(d, use_fast=True))
            for n, d in tok_dirs.items()}


def _assert_serialization(path, legacy):
    spec = json.load(open(os.path.join(path, "tokenizer.json")))
    if legacy:
        assert spec["normalizer"]["type"] == "Sequence"
        assert spec["pre_tokenizer"] is None
    else:
        assert spec["normalizer"] is None
        assert spec["pre_tokenizer"]["prepend_scheme"] == "first"


@pytest.mark.parametrize("name", DIRS)
def test_ids_match_transformers(pairs, tok_dirs, name):
    mine, ref = pairs[name]
    if "mistral" in name:
        _assert_serialization(tok_dirs[name], "legacy" in name)
    corpus = TEXTS + writer.corpus_text().split("\n\n")[:120]
    for text in corpus:
        for special in (True, False):
            assert mine(text, add_special_tokens=special).input_ids == \
                ref(text, add_special_tokens=special).input_ids, (text,
                                                                   special)
    assert mine.encode(corpus[0]) == ref.encode(corpus[0])
    assert mine(corpus[0])["input_ids"] == ref(corpus[0])["input_ids"]


@pytest.mark.parametrize("name", DIRS)
def test_decode_matches_transformers(pairs, name):
    mine, ref = pairs[name]
    import random
    rnd = random.Random(0)
    seqs = [ref(t).input_ids for t in TEXTS]
    # random ids: invalid byte runs, special tokens, unknown ids
    seqs += [[rnd.randrange(len(ref) + 3) for _ in range(40)]
             for _ in range(30)]
    seqs.append([3 + b for b in (0xE2, 0x82, 0x41, 0xF0, 0x9F, 0x8E, 0x89)])
    for ids in seqs:
        for skip in (False, True):
            assert mine.decode(ids, skip_special_tokens=skip) == \
                ref.decode(ids, skip_special_tokens=skip), (ids, skip)
        for clean in (False, True):
            assert mine.decode(ids, clean_up_tokenization_spaces=clean) == \
                ref.decode(ids, clean_up_tokenization_spaces=clean)


@pytest.mark.parametrize("name", DIRS)
def test_special_tokens_and_sizes_match(pairs, name):
    mine, ref = pairs[name]
    for attr in ("bos_token", "eos_token", "unk_token", "pad_token",
                 "bos_token_id", "eos_token_id", "unk_token_id",
                 "pad_token_id", "model_max_length", "vocab_size",
                 "all_special_tokens", "all_special_ids",
                 "special_tokens_map"):
        assert getattr(mine, attr) == getattr(ref, attr), attr
    assert len(mine) == len(ref)
    assert mine.get_vocab() == ref.get_vocab()
    tokens = ref.convert_ids_to_tokens(ref("a cat <s> hi").input_ids)
    assert mine.convert_tokens_to_ids(tokens) == ref.convert_tokens_to_ids(
        tokens)
    # model_init's pad -> unk fallback (JAX inference/api.py)
    for t in (mine, ref):
        if t.pad_token is None and t.unk_token is not None:
            t.pad_token = t.unk_token
    assert (mine.pad_token, mine.pad_token_id) == (ref.pad_token,
                                                   ref.pad_token_id)


MESSAGES = [
    # system + user (JAX inference/api.py build_prompt_ids)
    [{"role": "system", "content": japi.MISTRAL_SYSTEM},
     {"role": "user", "content": "<video>\nWhat happens in the video?"}],
    [{"role": "user", "content": "<image>\nDescribe the image."}],
    # multi-turn training conversations (JAX train/data.py preprocess)
    [{"role": "user", "content": "<video>\nWhat is the man doing?"},
     {"role": "assistant", "content": "He is riding a bike."},
     {"role": "user", "content": "Where?"},
     {"role": "assistant", "content": "On a road, near the sea."}],
    [{"role": "system", "content": "Be brief."},
     {"role": "user", "content": "<video><audio>\nWhat sound is heard?"},
     {"role": "assistant", "content": "A dog barks."}],
]


@pytest.mark.parametrize("name", DIRS)
def test_chat_template_matches_transformers(pairs, name):
    import jinja2
    mine, ref = pairs[name]
    for messages in MESSAGES:
        for gen in (False, True):
            assert mine.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=gen) == \
                ref.apply_chat_template(messages, tokenize=False,
                                        add_generation_prompt=gen)
        assert mine.apply_chat_template(messages, tokenize=True) == \
            ref.apply_chat_template(messages, tokenize=True)
    assert mine.apply_chat_template(MESSAGES[0], bos_token="[B]") == \
        ref.apply_chat_template(MESSAGES[0], bos_token="[B]")
    bad = [{"role": "user", "content": "a"}, {"role": "user", "content": "b"}]
    if FAMILY[name] == "videollama2_mistral" and "wordlevel" not in name:
        # Mistral's template refuses roles that do not alternate
        for t in (mine, ref):
            with pytest.raises(jinja2.exceptions.TemplateError,
                               match="alternate"):
                t.apply_chat_template(bad)
    else:
        assert mine.apply_chat_template(bad) == ref.apply_chat_template(bad)


@pytest.mark.parametrize("name", DIRS)
def test_prompt_ids_match_jax(pairs, name):
    """The port's build_prompt_ids on the reader against the JAX
    package's on AutoTokenizer: chat template + multimodal tokenization."""
    mine, ref = pairs[name]
    model_type = FAMILY[name]
    jcfg = jcfglib.tiny_model(model_type)
    tcfg = tcfglib.tiny_model(model_type)
    for instruct in ("What is happening in this video?",
                     [{"role": "user", "content": "describe the scene"},
                      {"role": "assistant", "content": "a cat"},
                      {"role": "user", "content": "why ?"}]):
        for modal in ("video", "image", "av", "text", "audio"):
            want = japi.build_prompt_ids(instruct, jcfg, ref, modal)
            assert tapi.build_prompt_ids(instruct, tcfg, mine, modal) == want


TEXT_ALPHABET = st.characters(exclude_categories=("Cs", "Cn"))


@pytest.mark.parametrize("name", DIRS)
def test_random_text_matches_transformers(pairs, name):
    mine, ref = pairs[name]
    specials = ["<s>", "</s>", "<unk>", "<|im_start|>", "<|im_end|>",
                "<video>", " ", "\n", "▁"]

    @settings(max_examples=60, derandomize=True, deadline=None,
              suppress_health_check=list(HealthCheck))
    @given(st.lists(st.one_of(st.text(TEXT_ALPHABET, max_size=12),
                              st.sampled_from(specials)), max_size=8))
    def prop(parts):
        text = "".join(parts)
        for special in (True, False):
            ids = ref(text, add_special_tokens=special).input_ids
            assert mine(text, add_special_tokens=special).input_ids == ids
            assert mine.decode(ids) == ref.decode(ids)
            assert mine.decode(ids, skip_special_tokens=True) == \
                ref.decode(ids, skip_special_tokens=True)
    prop()


def _cut(engine, s):
    return [x for x, _ in engine.pre_tokenize_str(s)]


def _differing(cps, layout, probes, rust, mine):
    """The code points of `cps` that the Rust engine classes otherwise than
    the reader: their `layout` string is cut differently, halved down to
    64 code points, each of which is put in the `probes` (contexts that
    show its class) which must be cut alike."""
    s = layout(cps)
    if _cut(rust, s) == [x for x, _ in mine([(s, True)])]:
        return []
    if len(cps) > 64:
        half = len(cps) // 2
        found = (_differing(cps[:half], layout, probes, rust, mine)
                 + _differing(cps[half:], layout, probes, rust, mine))
        if found:
            return found
    out = []
    for c in cps:
        for probe in probes:
            p = probe([c])
            if _cut(rust, p) != [x for x, _ in mine([(p, True)])]:
                out.append(c)
                break
    return out


def test_unicode_classes_match_the_rust_engines():
    """\\p{L}, \\p{N} and \\s of the Split / ByteLevel regexes (Oniguruma)
    and \\w and \\s of Whitespace (Rust's regex) against the engines in
    `tokenizers`, over every code point: the members of each of the
    reader's classes in one string, which the engine must cut as the
    reader does. They agree on every code point Python's unicodedata
    assigns; where they differ, the code point is one of a later Unicode
    version than Python's tables (the count is printed, and recorded in
    ROADMAP.md)."""
    import re
    from tokenizers import Regex, pre_tokenizers as pt
    every = "".join(chr(c) for c in range(0x110000)
                    if not 0xD800 <= c <= 0xDFFF and c not in (10, 13))

    def members(cls):
        return [ord(ch) for m in re.finditer(f"[{cls}]+", every)
                for ch in m.group()]

    space = members(hf.WHITE_SPACE)
    letter = members(hf._ranges("L"))
    number = members(hf._ranges("N"))
    word = members(hf._ranges("w"))
    classed = set(space) | set(letter) | set(number)
    other = [ord(ch) for ch in every if ord(ch) not in classed]
    unworded = set(word) | set(space)
    punct = [ord(ch) for ch in every if ord(ch) not in unworded]
    split = (pt.Split(Regex(writer.QWEN2_SPLIT), behavior="isolated"),
             hf.build_pre_tokenizer({"type": "Split", "behavior": "Isolated",
                                     "pattern": {"Regex": writer.QWEN2_SPLIT}}))
    whitespace = (pt.Whitespace(),
                  hf.build_pre_tokenizer({"type": "Whitespace"}))

    def after(sep):  # each code point after `sep`: its class shows alone
        return lambda cs: "".join(sep + chr(c) for c in cs) + sep

    split_probes = (after("!"), after("a"))
    ws_probes = (after("a"), after("!"))
    found = []
    for cps, layout, probes, engines in (
            (letter, after("a"), split_probes, split),
            (number, after("a"), split_probes, split),
            (space, after("a"), split_probes, split),
            (other, after("!"), split_probes, split),
            (word, after("a"), ws_probes, whitespace),
            (punct, after("!"), ws_probes, whitespace),
            (space, after("a"), ws_probes, whitespace)):
        for lo in range(0, len(cps), 1 << 16):
            found += _differing(cps[lo:lo + (1 << 16)], layout, probes,
                                *engines)
    differing = sorted(set(found))
    assigned = [c for c in differing if unicodedata.category(chr(c)) != "Cn"]
    assert not assigned, [f"U+{c:04X}" for c in assigned[:50]]
    assert differing, "no difference: drop the Cn exclusion of the property"
    print(f"[unicode] {len(differing)} code points differ, all unassigned "
          f"in Python's Unicode {unicodedata.unidata_version}: "
          + " ".join(f"U+{a:04X}-U+{b:04X}" for a, b in _runs(differing)))


def _runs(cps):
    out = []
    for c in cps:
        if out and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return out


def _golden_build():
    """The golden ids: `tokenizers` (through AutoTokenizer) on the writer's
    full-vocabulary files."""
    import tempfile
    from transformers import AutoTokenizer
    from videollama2_tpu.multimodal.tokenizer import tokenizer_multimodal_token
    _quiet()
    # decode(encode(t)) == t holds on these (a leading space is cut by the
    # decoders' Strip, a "▁" read as a space)
    texts = [t for t in TEXTS if t.strip() and not t.startswith(" ")
             and "<" not in t and "▁" not in t]
    # prose paragraphs of the corpus (no paths or citations)
    texts += [p for p in writer.corpus_text().split("\n\n")
              if 40 < len(p) < 400 and "/" not in p and "`" not in p][:6]
    out = {"corpus_sha256": hashlib.sha256(
        writer.corpus_text().encode()).hexdigest(), "families": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for fam, write, model_type in (
                ("mistral_legacy", lambda p: writer.write_mistral(p),
                 "videollama2_mistral"),
                ("mistral_metaspace",
                 lambda p: writer.write_mistral(p, legacy=False),
                 "videollama2_mistral"),
                ("qwen2", writer.write_qwen2, "videollama2_qwen2")):
            path = write(os.path.join(tmp, fam))
            ref = AutoTokenizer.from_pretrained(path, use_fast=True)
            cfg = jcfglib.tiny_model(model_type)
            prompts = []
            for modal in ("video", "av", "text"):
                instruct = "What is happening in this video?"
                prompts.append({"modal": modal, "instruct": instruct,
                                "ids": japi.build_prompt_ids(
                                    instruct, cfg, ref, modal)})
            for t in texts:
                assert ref.decode(ref(t, add_special_tokens=False)
                                  .input_ids) == t, (fam, t)
            out["families"][fam] = {
                "model_type": model_type, "len": len(ref),
                "texts": texts,
                "ids": [ref(t).input_ids for t in texts],
                "ids_plain": [ref(t, add_special_tokens=False).input_ids
                              for t in texts],
                "chunks": [tokenizer_multimodal_token(
                    t, ref, "<video>") for t in ("<video>\nhi there",)],
                "prompts": prompts}
    return out


def test_golden_ids_are_what_tokenizers_gives():
    with open(GOLDEN, encoding="utf-8") as f:
        want = json.load(f)
    assert _golden_build() == want


def test_sentencepiece_only_directory_raises(tmp_path):
    (tmp_path / "tokenizer.model").write_bytes(b"\x0a\x00")
    (tmp_path / "tokenizer_config.json").write_text("{}")
    with pytest.raises(hf.SentencePieceOnlyError, match="tokenizer.model"):
        hf.load(str(tmp_path))
    assert issubclass(hf.SentencePieceOnlyError, FileNotFoundError)
    with pytest.raises(hf.SentencePieceOnlyError):
        tapi.load_tokenizer(None, str(tmp_path))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        hf.load(str(empty))


@pytest.mark.parametrize("part,spec", [
    ("normalizer", {"type": "Lowercase"}),
    ("pre_tokenizer", {"type": "Digits", "individual_digits": True}),
    ("model", {"type": "Unigram", "vocab": [["a", 0.0]], "unk_id": 0}),
    ("post_processor", {"type": "BertProcessing", "sep": ["</s>", 2],
                        "cls": ["<s>", 1]}),
    ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True}),
])
def test_unsupported_component_raises_naming_it(tok_dirs, tmp_path, part,
                                                spec):
    # Qwen2's class keeps the file's post-processor (the Llama class
    # rebuilds its own from add_bos_token / add_eos_token)
    src = tok_dirs["writer_qwen2"]
    data = json.load(open(os.path.join(src, "tokenizer.json")))
    data[part] = spec
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        with open(os.path.join(src, name)) as f:
            (tmp_path / name).write_text(f.read())
    (tmp_path / "tokenizer.json").write_text(json.dumps(data))
    with pytest.raises(ValueError, match=spec["type"]):
        hf.load(str(tmp_path))


def test_bpe_dropout_and_unknown_class_raise(tok_dirs, tmp_path):
    src = tok_dirs["writer_qwen2"]
    data = json.load(open(os.path.join(src, "tokenizer.json")))
    data["model"]["dropout"] = 0.1
    with pytest.raises(ValueError, match="dropout"):
        hf.HFTokenizer(data, {})
    with pytest.raises(ValueError, match="BertTokenizer"):
        hf.HFTokenizer(json.load(open(os.path.join(src, "tokenizer.json"))),
                       {"tokenizer_class": "BertTokenizer"})
    with pytest.raises(ValueError, match=r"\\w"):
        hf.translate_regex(r"\w+")


def test_missing_jinja2_raises(pairs, monkeypatch):
    mine, _ = pairs["writer_qwen2"]
    chat_template.compile_template.cache_clear()
    monkeypatch.setitem(sys.modules, "jinja2", None)
    with pytest.raises(ImportError, match="jinja2"):
        mine.apply_chat_template(MESSAGES[1])
    chat_template.compile_template.cache_clear()


def test_chat_template_files_take_priority(tok_dirs, tmp_path):
    """chat_template.jinja wins over the config's template (transformers'
    order); chat_template.json is read where neither holds one."""
    from transformers import AutoTokenizer
    src = tok_dirs["writer_qwen2"]
    for name in os.listdir(src):
        with open(os.path.join(src, name), "rb") as f:
            (tmp_path / name).write_bytes(f.read())
    (tmp_path / "chat_template.jinja").write_text(
        "{% for m in messages %}[{{ m['role'] }}]{{ m['content'] }}"
        "{% endfor %}{% if add_generation_prompt %}[a]{% endif %}")
    mine = hf.load(str(tmp_path))
    ref = AutoTokenizer.from_pretrained(str(tmp_path), use_fast=True)
    for gen in (False, True):
        assert mine.apply_chat_template(MESSAGES[0],
                                        add_generation_prompt=gen) == \
            ref.apply_chat_template(MESSAGES[0], add_generation_prompt=gen)
    os.remove(tmp_path / "chat_template.jinja")
    cfg = json.load(open(tmp_path / "tokenizer_config.json"))
    template = cfg.pop("chat_template")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
    (tmp_path / "chat_template.json").write_text(
        json.dumps({"chat_template": template}))
    assert hf.load(str(tmp_path)).chat_template == template


if __name__ == "__main__":
    # rewrite the golden file: python tests/test_torch_tokenizer.py
    import re
    text = json.dumps(_golden_build(), ensure_ascii=False, indent=1)
    # each list of ids on one line
    text = re.sub(r"\[\s+([-\d,\s]+?)\s+\]",
                  lambda m: "[" + re.sub(r"\s+", "", m.group(1)) + "]", text)
    with open(GOLDEN, "w", encoding="utf-8") as f:
        f.write(text + "\n")
