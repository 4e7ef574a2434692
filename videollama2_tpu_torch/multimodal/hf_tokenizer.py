"""A plain-Python reader of Hugging Face tokenizer directories.

`load(path)` reads a checkpoint directory's `tokenizer.json`,
`tokenizer_config.json`, `special_tokens_map.json` and chat template
(`chat_template.jinja`, the config's `chat_template`, `chat_template.json`)
and returns an `HFTokenizer`: the object the port duck-types
(multimodal/tokenizer.py), giving the ids, strings and chat prompts that
`transformers.AutoTokenizer.from_pretrained(path, use_fast=True)` gives on
the same files (tests/test_torch_tokenizer.py holds them equal). It needs
only the standard library, and jinja2 for chat templates.

The pipeline is that of the `tokenizers` library: added tokens are split
out of the raw text (leftmost, longest first; lstrip, rstrip and
single_word honoured), each other segment is normalized and searched for
normalized added tokens, pre-tokenized, and cut by the model; the
post-processor adds the special tokens. It implements what the Mistral /
Llama-2 (SentencePiece-style BPE with byte fallback, both serializations),
Qwen2 (byte-level BPE behind a Split regex) and word-level files use:

* normalizers: Sequence, Prepend, Replace, NFC;
* pre-tokenizers: Metaspace, ByteLevel, Split, Whitespace, Sequence;
* models: BPE (dropout null), WordLevel;
* post-processors: TemplateProcessing, ByteLevel, null;
* decoders: Sequence, Replace, ByteFallback, Fuse, Strip, Metaspace,
  ByteLevel, null.

Any other component type raises ValueError naming it. The regexes of the
files are Oniguruma's (Split, ByteLevel) or Rust's (Whitespace); their
Unicode classes (\\p{L}, \\p{N}, \\s, \\w) are built here from unicodedata,
whose tables may be of another Unicode version than the library's.
"""

from __future__ import annotations

import functools
import heapq
import json
import os
import re
import unicodedata
from typing import Callable, Dict, List, Optional, Tuple

# transformers' VERY_LARGE_INTEGER, the model_max_length of a config
# without one
VERY_LARGE_INTEGER = int(1e30)
SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                "pad_token", "cls_token", "mask_token")
# the class defaults of the tokenizer classes transformers picks for these
# files (AutoTokenizer maps the slow names to the fast classes); a key the
# config holds, null included, wins over its default
CLASS_DEFAULTS = {
    "PreTrainedTokenizerFast": {},
    "LlamaTokenizer": {"unk_token": "<unk>", "bos_token": "<s>",
                       "eos_token": "</s>", "add_bos_token": True,
                       "add_eos_token": False},
    "Qwen2Tokenizer": {"unk_token": "<|endoftext|>", "bos_token": None,
                       "eos_token": "<|endoftext|>",
                       "pad_token": "<|endoftext|>"},
}
# Unicode White_Space: what \s means to Oniguruma and Rust's regex, and
# char::is_whitespace (Python's str.isspace adds U+001C-U+001F)
WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029"
               "\u202f\u205f\u3000")
# Other_Alphabetic code points outside the letter and mark categories:
# the circled and squared Latin letters (Rust's \w is Alphabetic, marks,
# Nd, Pc and Join_Control)
OTHER_ALPHABETIC_SYMBOLS = ((0x24B6, 0x24E9), (0x1F130, 0x1F149),
                            (0x1F150, 0x1F169), (0x1F170, 0x1F189))


class SentencePieceOnlyError(FileNotFoundError):
    """A directory with `tokenizer.model` (a SentencePiece protobuf) but no
    `tokenizer.json`: transformers converts it with `use_fast=True`, this
    reader does not."""


# -- Unicode classes ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ranges(category: str) -> str:
    """A character-class body (ranges, escaped) of the code points whose
    general category starts with `category` ("L", "Lu", ...); "w" is
    Rust's \\w."""
    if category == "w":
        def keep(c, cat):
            return (cat[0] in "LM" or cat in ("Nd", "Nl", "Pc")
                    or c in (0x200C, 0x200D)
                    or (cat == "So" and any(
                        a <= c <= b for a, b in OTHER_ALPHABETIC_SYMBOLS)))
    else:
        def keep(c, cat):
            return cat.startswith(category)
    out = []
    start = prev = None
    category_of = unicodedata.category
    for c in range(0x110000):
        if keep(c, category_of(chr(c))):
            if start is None:
                start = c
            prev = c
        elif start is not None:
            out.append(_span(start, prev))
            start = None
    if start is not None:
        out.append(_span(start, prev))
    return "".join(out)


def _span(a: int, b: int) -> str:
    return f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"


# the general categories \p{..} may name
_PROPERTIES = frozenset(("L", "N", "M", "P", "S", "Z", "Lu", "Ll", "Lt", "Lm",
                         "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No"))


@functools.lru_cache(maxsize=None)
def translate_regex(pattern: str) -> "re.Pattern":
    """An Oniguruma pattern of a tokenizer file as a compiled Python regex:
    \\p{..} general categories, \\s and \\S become explicit classes (Python's
    `re` has no \\p and a wider \\s); escapes whose Unicode meaning differs
    between the engines (\\w, \\d, \\b, ...) raise."""
    out = []
    i = 0
    in_class = False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            if i + 1 >= len(pattern):
                raise ValueError(f"regex {pattern!r} ends with a backslash")
            nxt = pattern[i + 1]
            if nxt in "pP":
                m = re.match(r"\{(\^?)(\w+)\}|(\w)", pattern[i + 2:])
                if m is None:
                    raise ValueError(f"regex {pattern!r}: bad \\{nxt}")
                name = m.group(2) or m.group(3)
                if name not in _PROPERTIES:
                    raise ValueError(f"regex {pattern!r}: unicode property "
                                     f"{name!r} is not supported")
                negated = (nxt == "P") != bool(m.group(1))
                body = _ranges(name)
                if in_class:
                    if negated:
                        raise ValueError(f"regex {pattern!r}: a negated "
                                         "property inside a class")
                    out.append(body)
                else:
                    out.append(f"[{'^' if negated else ''}{body}]")
                i += 2 + m.end()
                continue
            if nxt == "s":
                out.append(WHITE_SPACE if in_class else f"[{WHITE_SPACE}]")
            elif nxt == "S":
                if in_class:
                    raise ValueError(f"regex {pattern!r}: \\S inside a class")
                out.append(f"[^{WHITE_SPACE}]")
            elif nxt.isalpha() and nxt not in "rntfvxu":
                raise ValueError(f"regex {pattern!r}: \\{nxt} is not "
                                 "supported")
            else:
                out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and in_class:
            raise ValueError(f"regex {pattern!r}: nested classes are not "
                             "supported")
        if c == "[":
            in_class = True
            out.append(c)
            i += 1
            if pattern[i:i + 1] == "^":
                out.append("^")
                i += 1
            if pattern[i:i + 1] == "]":
                out.append("\\]")
                i += 1
            continue
        if c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return re.compile("".join(out))


@functools.lru_cache(maxsize=None)
def _whitespace_regex() -> "re.Pattern":
    """The Whitespace pre-tokenizer's `\\w+|[^\\w\\s]+` in Rust's classes."""
    w = _ranges("w")
    return re.compile(f"[{w}]+|[^{w}{WHITE_SPACE}]+")


_SPACE = re.compile(f"[{WHITE_SPACE}]")


@functools.lru_cache(maxsize=None)
def _byte_table() -> Tuple[Dict[int, str], Dict[str, int]]:
    """GPT-2's byte <-> printable character tables (ByteLevel)."""
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
    to_char = {b: chr(c) for b, c in zip(bs, cs)}
    return to_char, {v: k for k, v in to_char.items()}


# -- splitting ----------------------------------------------------------------

def _find_matches(text: str, pattern) -> List[Tuple[int, int, bool]]:
    """(start, end, is_match) spans covering `text` (tokenizers' Pattern)."""
    if not text:
        return [(0, 0, False)]
    spans = []
    prev = 0
    for m in pattern.finditer(text):
        if prev != m.start():
            spans.append((prev, m.start(), False))
        spans.append((m.start(), m.end(), True))
        prev = m.end()
    if prev != len(text):
        spans.append((prev, len(text), False))
    return spans


def _split(text: str, pattern, behavior: str,
           invert: bool = False) -> List[Tuple[int, int]]:
    """tokenizers' NormalizedString::split: the kept (start, end) pieces."""
    spans = [(a, b, m != invert) for a, b, m in _find_matches(text, pattern)]
    if behavior == "Isolated":
        out = [(a, b, False) for a, b, _ in spans]
    elif behavior == "Removed":
        out = spans
    elif behavior in ("Contiguous", "MergedWithPrevious"):
        out = []
        previous = False
        for a, b, m in spans:
            merge = (m == previous) if behavior == "Contiguous" \
                else (m and not previous)
            if merge and out:
                out[-1] = (out[-1][0], b, False)
            else:
                out.append((a, b, False))
            previous = m
    elif behavior == "MergedWithNext":
        out = []
        previous = False
        for a, b, m in reversed(spans):
            if m and not previous and out:
                out[-1] = (a, out[-1][1], False)
            else:
                out.append((a, b, False))
            previous = m
        out.reverse()
    else:
        raise ValueError(f"split behavior {behavior!r} is not supported")
    return [(a, b) for a, b, removed in out if not removed and a != b]


def _pattern(spec: dict):
    """A Split / Replace `pattern` ({"Regex": ...} or {"String": ...})."""
    if "Regex" in spec:
        return translate_regex(spec["Regex"])
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    raise ValueError(f"pattern {spec!r} is not supported")


# -- components ---------------------------------------------------------------

def _component_type(spec: dict, kind: str) -> str:
    t = spec.get("type")
    if t is None:
        raise ValueError(f"{kind} {spec!r} has no type")
    return t


def build_normalizer(spec: Optional[dict]) -> Optional[Callable[[str], str]]:
    if spec is None:
        return None
    t = _component_type(spec, "normalizer")
    if t == "Sequence":
        parts = [build_normalizer(s) for s in spec["normalizers"]]

        def seq(s):
            for p in parts:
                s = p(s)
            return s
        return seq
    if t == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if t == "Replace":
        pat = _pattern(spec["pattern"])
        content = spec["content"]
        return lambda s: pat.sub(lambda _: content, s)
    if t == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    raise ValueError(f"normalizer type {t!r} is not supported")


Piece = Tuple[str, bool]  # (text, begins at the input's first character)


def build_pre_tokenizer(spec: Optional[dict]
                        ) -> Optional[Callable[[List[Piece]], List[Piece]]]:
    if spec is None:
        return None
    t = _component_type(spec, "pre-tokenizer")
    if t == "Sequence":
        parts = [build_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(pieces):
            for p in parts:
                pieces = p(pieces)
            return pieces
        return seq

    def each(fn):
        def run(pieces):
            out = []
            for text, first in pieces:
                out.extend(fn(text, first))
            return [(s, f) for s, f in out if s]
        return run

    if t == "Metaspace":
        repl = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = ("always" if spec.get("add_prefix_space", True)
                      else "never")
        split = spec.get("split", True)
        if scheme not in ("always", "first", "never"):
            raise ValueError(f"Metaspace prepend_scheme {scheme!r} is not "
                             "supported")
        sep = re.compile(re.escape(repl))

        def metaspace(text, first):
            text = text.replace(" ", repl)
            if not text.startswith(repl) and (
                    scheme == "always" or (scheme == "first" and first)):
                text = repl + text
            if not split:
                return [(text, first)]
            return [(text[a:b], first and a == 0)
                    for a, b in _split(text, sep, "MergedWithNext")]
        return each(metaspace)
    if t == "ByteLevel":
        to_char = _byte_table()[0]
        prefix = spec.get("add_prefix_space", True)
        use_regex = spec.get("use_regex", True)
        gpt2 = translate_regex(
            r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
            r"|\s+(?!\S)|\s+") if use_regex else None

        def byte_level(text, first):
            if prefix and not text.startswith(" "):
                text = " " + text
            spans = (_split(text, gpt2, "Isolated") if use_regex
                     else [(0, len(text))])
            return [("".join(to_char[b] for b in text[a:b].encode("utf-8")),
                     first and a == 0) for a, b in spans]
        return each(byte_level)
    if t == "Split":
        pat = _pattern(spec["pattern"])
        behavior = spec["behavior"]
        invert = spec.get("invert", False)

        def split(text, first):
            return [(text[a:b], first and a == 0)
                    for a, b in _split(text, pat, behavior, invert)]
        return each(split)
    if t == "Whitespace":
        ws = _whitespace_regex()

        def whitespace(text, first):
            return [(text[a:b], first and a == 0)
                    for a, b in _split(text, ws, "Removed", invert=True)]
        return each(whitespace)
    raise ValueError(f"pre-tokenizer type {t!r} is not supported")


class BPE:
    """tokenizers' BPE model: merges applied lowest rank first (leftmost on
    ties) with a per-word cache, byte fallback, unk fusing, subword
    prefix / suffix and ignore_merges."""

    CACHE_SIZE = 10000

    def __init__(self, spec: dict):
        if spec.get("dropout") not in (None, 0.0):
            raise ValueError("BPE dropout is not supported (it must be "
                             f"null), got {spec['dropout']!r}")
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = spec.get("fuse_unk", False)
        self.byte_fallback = spec.get("byte_fallback", False)
        self.prefix = spec.get("continuing_subword_prefix") or None
        self.suffix = spec.get("end_of_word_suffix") or None
        self.ignore_merges = spec.get("ignore_merges", False)
        vocab = self.vocab
        cut = len(self.prefix) if self.prefix else 0
        merges = {}
        for rank, m in enumerate(spec.get("merges", ())):
            if isinstance(m, str):
                parts = m.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"BPE merge {m!r} is not 'a b'")
                a, b = parts
            else:
                a, b = m
            try:
                merges[vocab[a], vocab[b]] = (rank, vocab[a + b[cut:]])
            except KeyError as e:
                raise ValueError(f"BPE merge {a!r} {b!r}: {e.args[0]!r} is "
                                 "not in the vocabulary") from None
        self.merges = merges
        self._bytes = ([vocab.get(f"<0x{b:02X}>") for b in range(256)]
                       if self.byte_fallback else None)
        self._cache: Dict[str, List[int]] = {}

    def _unk_id(self) -> int:
        if self.unk_token not in self.vocab:
            raise ValueError(f"BPE unk_token {self.unk_token!r} is not in "
                             "the vocabulary")
        return self.vocab[self.unk_token]

    def _symbols(self, w: str) -> List[int]:
        vocab = self.vocab
        out: List[int] = []
        unk = None  # a pending [unk id] not yet added (fuse_unk)
        last = len(w) - 1
        for i, ch in enumerate(w):
            s = ch
            if i and self.prefix:
                s = self.prefix + s
            if i == last and self.suffix:
                s = s + self.suffix
            tid = vocab.get(s)
            if tid is not None:
                if unk is not None:
                    out.append(unk)
                    unk = None
                out.append(tid)
                continue
            if self._bytes is not None:
                ids = [self._bytes[b] for b in s.encode("utf-8")]
                if None not in ids:
                    out.extend(ids)
                    continue
            if self.unk_token is not None:
                if unk is not None and not self.fuse_unk:
                    out.append(unk)
                unk = self._unk_id()
        if unk is not None:
            out.append(unk)
        return out

    def _merge(self, syms: List[int]) -> List[int]:
        n = len(syms)
        if n < 2:
            return syms
        merges = self.merges
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        prv = list(range(-1, n - 1))
        dead = [False] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((syms[i], syms[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if dead[pos]:
                continue
            j = nxt[pos]
            if j == -1:
                continue
            m = merges.get((syms[pos], syms[j]))
            if m is None or m[1] != new_id:
                continue
            syms[pos] = new_id
            dead[j] = True
            k = nxt[j]
            nxt[pos] = k
            if k != -1:
                prv[k] = pos
            p = prv[pos]
            if p != -1:
                m = merges.get((syms[p], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            if k != -1:
                m = merges.get((new_id, syms[k]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [s for s, d in zip(syms, dead) if not d]

    def tokenize(self, w: str) -> List[int]:
        if not w:
            return []
        if self.ignore_merges and w in self.vocab:
            return [self.vocab[w]]
        hit = self._cache.get(w)
        if hit is None:
            hit = self._merge(self._symbols(w))
            if len(self._cache) >= self.CACHE_SIZE:
                self._cache.clear()
            self._cache[w] = hit
        return list(hit)


class WordLevel:
    def __init__(self, spec: dict):
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk_token = spec.get("unk_token")

    def tokenize(self, w: str) -> List[int]:
        tid = self.vocab.get(w)
        if tid is None:
            tid = self.vocab.get(self.unk_token)
            if tid is None:
                raise ValueError(f"WordLevel: {w!r} is not in the vocabulary "
                                 "and there is no unk token")
        return [tid]


def build_model(spec: dict):
    t = _component_type(spec, "model")
    if t == "BPE":
        return BPE(spec)
    if t == "WordLevel":
        return WordLevel(spec)
    raise ValueError(f"model type {t!r} is not supported")


def build_post_processor(spec: Optional[dict]
                         ) -> Callable[[List[int]], List[int]]:
    """ids -> ids with the special tokens (applied with
    add_special_tokens=True, single sequences)."""
    if spec is None:
        return lambda ids: ids
    t = _component_type(spec, "post-processor")
    if t == "ByteLevel":
        return lambda ids: ids
    if t == "TemplateProcessing":
        specials = spec.get("special_tokens", {})
        parts = []
        for item in spec["single"]:
            if "SpecialToken" in item:
                parts.append(list(specials[item["SpecialToken"]["id"]]["ids"]))
            elif "Sequence" in item:
                if item["Sequence"]["id"] != "A":
                    raise ValueError("a single-sequence template names "
                                     f"sequence {item['Sequence']['id']!r}")
                parts.append(None)
            else:
                raise ValueError(f"template piece {item!r} is not supported")

        def template(ids):
            out = []
            for p in parts:
                out.extend(ids if p is None else p)
            return out
        return template
    raise ValueError(f"post-processor type {t!r} is not supported")


def template_processing(bos: Optional[Tuple[str, int]],
                        eos: Optional[Tuple[str, int]]) -> dict:
    """The TemplateProcessing transformers' LlamaTokenizerFast builds from
    add_bos_token / add_eos_token (update_post_processor)."""
    single = []
    specials = {}
    if bos is not None:
        single.append({"SpecialToken": {"id": bos[0], "type_id": 0}})
        specials[bos[0]] = {"id": bos[0], "ids": [bos[1]]}
    single.append({"Sequence": {"id": "A", "type_id": 0}})
    if eos is not None:
        single.append({"SpecialToken": {"id": eos[0], "type_id": 0}})
        specials[eos[0]] = {"id": eos[0], "ids": [eos[1]]}
    return {"type": "TemplateProcessing", "single": single,
            "special_tokens": specials}


_BYTE_TOKEN = re.compile(r"<0x(\+[0-9a-fA-F]|[0-9a-fA-F]{2})>")


def build_decoder(spec: Optional[dict]
                  ) -> Optional[Callable[[List[str]], List[str]]]:
    """A decoder as tokenizers' decode_chain: tokens -> strings (joined by
    the caller)."""
    if spec is None:
        return None
    t = _component_type(spec, "decoder")
    if t == "Sequence":
        parts = [build_decoder(s) for s in spec["decoders"]]

        def seq(tokens):
            for p in parts:
                tokens = p(tokens)
            return tokens
        return seq
    if t == "Replace":
        pat = _pattern(spec["pattern"])
        content = spec["content"]
        return lambda tokens: [pat.sub(lambda _: content, s) for s in tokens]
    if t == "ByteFallback":
        def byte_fallback(tokens):
            out, run = [], []

            def flush():
                try:
                    out.append(bytes(run).decode("utf-8"))
                except UnicodeDecodeError:
                    out.extend("�" for _ in run)
                run.clear()
            for s in tokens:
                m = (_BYTE_TOKEN.fullmatch(s)
                     if len(s.encode("utf-8")) == 6 else None)
                if m is not None:
                    run.append(int(m.group(1), 16))
                    continue
                if run:
                    flush()
                out.append(s)
            if run:
                flush()
            return out
        return byte_fallback
    if t == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if t == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]

        def strip(tokens):
            out = []
            for s in tokens:
                a = 0
                while a < min(start, len(s)) and s[a] == content:
                    a += 1
                b = len(s)
                while len(s) - b < stop and b > a and s[b - 1] == content:
                    b -= 1
                out.append(s[a:b])
            return out
        return strip
    if t == "Metaspace":
        repl = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = ("always" if spec.get("add_prefix_space", True)
                      else "never")

        def metaspace(tokens):
            return [s.replace(repl, "" if i == 0 and scheme != "never"
                              else " ") for i, s in enumerate(tokens)]
        return metaspace
    if t == "ByteLevel":
        to_byte = _byte_table()[1]

        def byte_level(tokens):
            raw = bytearray()
            for s in tokens:
                try:
                    raw.extend(to_byte[c] for c in s)
                except KeyError:
                    raw.extend(s.encode("utf-8"))
            return [raw.decode("utf-8", errors="replace")]
        return byte_level
    raise ValueError(f"decoder type {t!r} is not supported")


# -- the added vocabulary -----------------------------------------------------

class AddedToken:
    __slots__ = ("content", "id", "special", "lstrip", "rstrip",
                 "normalized", "single_word")

    def __init__(self, content: str, id: int, special: bool = False,
                 lstrip: bool = False, rstrip: bool = False,
                 normalized: Optional[bool] = None,
                 single_word: bool = False):
        self.content = content
        self.id = id
        self.special = special
        self.lstrip = lstrip
        self.rstrip = rstrip
        self.normalized = (not special) if normalized is None else normalized
        self.single_word = single_word


def _is_word_char(ch: str) -> bool:
    return ch.isalnum() or ch == "_"


class _Matcher:
    """Leftmost-longest matching of a set of added tokens (the
    aho-corasick automaton of tokenizers' AddedVocabulary)."""

    def __init__(self, tokens: Dict[str, AddedToken]):
        self.tokens = tokens
        self.regex = (re.compile("|".join(
            re.escape(p) for p in sorted(tokens, key=len, reverse=True)))
            if tokens else None)

    def split(self, text: str) -> List[Tuple[int, int, Optional[int]]]:
        """(start, end, id or None) spans covering `text` (find_matches)."""
        if self.regex is None:
            return [(0, len(text), None)]
        spans = []
        start_offset = 0
        for m in self.regex.finditer(text):
            tok = self.tokens[m.group()]
            start, stop = m.start(), m.end()
            if tok.single_word:
                if (start and _is_word_char(text[start - 1])) or (
                        stop < len(text) and _is_word_char(text[stop])):
                    continue
            if tok.lstrip:
                s = start
                while s > 0 and _SPACE.match(text[s - 1]):
                    s -= 1
                start = max(s, start_offset)
            if tok.rstrip:
                while stop < len(text) and _SPACE.match(text[stop]):
                    stop += 1
            if start_offset < start:
                spans.append((start_offset, start, None))
            spans.append((start, stop, tok.id))
            start_offset = stop
        if start_offset != len(text):
            spans.append((start_offset, len(text), None))
        return spans


# -- the tokenizer ------------------------------------------------------------

class Encoding(dict):
    """transformers' BatchEncoding as far as the port reads it."""

    @property
    def input_ids(self) -> List[int]:
        return self["input_ids"]


def _token_str(value) -> Optional[str]:
    if isinstance(value, dict):
        return value["content"]
    return value


class HFTokenizer:
    """A tokenizer directory read without transformers or tokenizers; see
    the module docstring. `__call__`, `encode`, `decode`, `batch_decode`,
    `apply_chat_template`, the special tokens and their ids, `len()` and
    `model_max_length` are transformers' fast tokenizer's."""

    def __init__(self, spec: dict, config: dict, chat_template=None,
                 name_or_path: str = ""):
        self.name_or_path = name_or_path
        cls = config.get("tokenizer_class") or "PreTrainedTokenizerFast"
        key = cls[:-4] if cls.endswith("Fast") and cls != \
            "PreTrainedTokenizerFast" else cls
        if key not in CLASS_DEFAULTS:
            raise ValueError(f"tokenizer_class {cls!r} is not supported "
                             f"(supported: {sorted(CLASS_DEFAULTS)})")
        self.tokenizer_class = key
        settings = dict(CLASS_DEFAULTS[key])
        settings.update(config)
        self.model = build_model(spec["model"])
        self.normalizer = build_normalizer(spec.get("normalizer"))
        pre = spec.get("pre_tokenizer")
        prefix = config.get("add_prefix_space", False)
        if (isinstance(pre, dict) and "add_prefix_space" in pre
                and isinstance(prefix, bool)
                and pre["add_prefix_space"] != prefix):
            # PreTrainedTokenizerFast.__init__ sets the top-level
            # pre-tokenizer's add_prefix_space to the config's (False by
            # default)
            pre = dict(pre, add_prefix_space=prefix)
        self.pre_tokenizer = build_pre_tokenizer(pre)
        self.decoder = build_decoder(spec.get("decoder"))
        for k in ("truncation", "padding"):
            if spec.get(k) is not None:
                raise ValueError(f"tokenizer.json {k} is not supported")

        self.added: Dict[str, AddedToken] = {}
        for t in spec.get("added_tokens", ()):
            self._add(AddedToken(t["content"], t["id"], t.get("special", False),
                                 t.get("lstrip", False), t.get("rstrip", False),
                                 t.get("normalized"),
                                 t.get("single_word", False)))
        for idx, t in sorted(((int(i), t) for i, t in
                              config.get("added_tokens_decoder", {}).items()),
                             key=lambda x: x[0]):
            if t["content"] not in self.added:
                self._add(AddedToken(t["content"], idx, t.get("special", False),
                                     t.get("lstrip", False),
                                     t.get("rstrip", False),
                                     t.get("normalized"),
                                     t.get("single_word", False)))

        self._special: Dict[str, Optional[str]] = {
            k: _token_str(settings.get(k)) for k in SPECIAL_KEYS}
        self.additional_special_tokens = [
            _token_str(t) for t in settings.get("additional_special_tokens")
            or ()]
        for s in [v for v in self._special.values() if v is not None] \
                + self.additional_special_tokens:
            if s not in self.added:
                tid = self.model.vocab.get(s)
                if tid is None:
                    tid = self._next_id()
                self._add(AddedToken(s, tid, special=True, normalized=False))
            elif not self.added[s].special:
                self.added[s].special = True

        self.split_special_tokens = settings.get("split_special_tokens", False)
        self._refresh()
        if key == "LlamaTokenizer":
            self.add_bos_token = settings.get("add_bos_token", True)
            self.add_eos_token = settings.get("add_eos_token", False)
            bos = ((self.bos_token, self.bos_token_id)
                   if self.add_bos_token else None)
            eos = ((self.eos_token, self.eos_token_id)
                   if self.add_eos_token else None)
            if (self.add_bos_token and self.bos_token is None) or (
                    self.add_eos_token and self.eos_token is None):
                raise ValueError("add_bos_token / add_eos_token without the "
                                 "token")
            self.post_processor = build_post_processor(
                template_processing(bos, eos))
        else:
            self.post_processor = build_post_processor(
                spec.get("post_processor"))
        self.clean_up_tokenization_spaces = settings.get(
            "clean_up_tokenization_spaces", False)
        self.model_max_length = settings.get("model_max_length",
                                             VERY_LARGE_INTEGER)
        self.chat_template = chat_template if chat_template is not None \
            else settings.get("chat_template")
        if not isinstance(self.chat_template, (str, type(None))):
            raise ValueError("named chat templates are not supported")

    def _next_id(self) -> int:
        top = max((t.id for t in self.added.values()), default=-1)
        return max(len(self.model.vocab), top + 1)

    def _add(self, tok: AddedToken) -> None:
        self.added[tok.content] = tok

    def _refresh(self) -> None:
        """The id tables and the two matchers (raw and normalized)."""
        self._id_to_added = {t.id: t for t in self.added.values()}
        self._id_to_token = {i: s for s, i in self.model.vocab.items()}
        raw, norm = {}, {}
        for t in self.added.values():
            if self.split_special_tokens and t.special:
                continue
            if t.normalized and self.normalizer is not None:
                norm[self.normalizer(t.content)] = t
            elif t.normalized:
                norm[t.content] = t
            else:
                raw[t.content] = t
        self._raw = _Matcher(raw)
        self._norm = _Matcher(norm)

    # -- special tokens (transformers' SpecialTokensMixin) --

    def _get(self, key):
        return self._special[key]

    def _set(self, key, value):
        self._special[key] = _token_str(value)

    bos_token = property(lambda self: self._get("bos_token"),
                         lambda self, v: self._set("bos_token", v))
    eos_token = property(lambda self: self._get("eos_token"),
                         lambda self, v: self._set("eos_token", v))
    unk_token = property(lambda self: self._get("unk_token"),
                         lambda self, v: self._set("unk_token", v))
    pad_token = property(lambda self: self._get("pad_token"),
                         lambda self, v: self._set("pad_token", v))
    sep_token = property(lambda self: self._get("sep_token"),
                         lambda self, v: self._set("sep_token", v))
    cls_token = property(lambda self: self._get("cls_token"),
                         lambda self, v: self._set("cls_token", v))
    mask_token = property(lambda self: self._get("mask_token"),
                          lambda self, v: self._set("mask_token", v))

    def token_to_id(self, token: str) -> Optional[int]:
        t = self.added.get(token)
        return t.id if t is not None else self.model.vocab.get(token)

    def convert_tokens_to_ids(self, tokens):
        if tokens is None:
            return None
        if isinstance(tokens, str):
            tid = self.token_to_id(tokens)
            return self.unk_token_id if tid is None else tid
        return [self.convert_tokens_to_ids(t) for t in tokens]

    def _id(self, key):
        tok = self._special[key]
        return None if tok is None else self.convert_tokens_to_ids(tok)

    bos_token_id = property(lambda self: self._id("bos_token"))
    eos_token_id = property(lambda self: self._id("eos_token"))
    unk_token_id = property(lambda self: self._id("unk_token"))
    pad_token_id = property(lambda self: self._id("pad_token"))

    @property
    def special_tokens_map(self) -> dict:
        out = {k: v for k, v in self._special.items() if v is not None}
        if self.additional_special_tokens:
            out["additional_special_tokens"] = list(
                self.additional_special_tokens)
        return out

    @property
    def all_special_tokens(self) -> List[str]:
        seen = []
        for k, v in self.special_tokens_map.items():
            for s in (v if isinstance(v, list) else [v]):
                if s not in seen:
                    seen.append(s)
        return seen

    @property
    def all_special_ids(self) -> List[int]:
        return self.convert_tokens_to_ids(self.all_special_tokens)

    @property
    def vocab_size(self) -> int:
        return len(self.model.vocab)

    def get_vocab(self) -> Dict[str, int]:
        vocab = dict(self.model.vocab)
        vocab.update({t.content: t.id for t in self.added.values()})
        return vocab

    def __len__(self) -> int:
        return len(self.get_vocab())

    # -- encode / decode --

    def _pieces(self, text: str) -> List[int]:
        ids: List[int] = []
        for a, b, tid in self._raw.split(text):
            if tid is not None:
                ids.append(tid)
                continue
            seg = text[a:b]
            if not seg:
                continue
            first = a == 0
            if self.normalizer is not None:
                seg = self.normalizer(seg)
            for c, d, tid2 in self._norm.split(seg):
                if tid2 is not None:
                    ids.append(tid2)
                    continue
                sub = seg[c:d]
                if not sub:
                    continue
                pieces = [(sub, first and c == 0)]
                if self.pre_tokenizer is not None:
                    pieces = self.pre_tokenizer(pieces)
                for w, _ in pieces:
                    ids.extend(self.model.tokenize(w))
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self._pieces(text)
        return self.post_processor(ids) if add_special_tokens else ids

    def __call__(self, text: str, add_special_tokens: bool = True
                 ) -> Encoding:
        ids = self.encode(text, add_special_tokens)
        return Encoding(input_ids=ids, attention_mask=[1] * len(ids))

    def decode(self, ids, skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None) -> str:
        if hasattr(ids, "tolist"):
            ids = ids.tolist()
        if isinstance(ids, int):
            ids = [ids]
        tokens = []
        for i in ids:
            i = int(i)
            t = self._id_to_added.get(i)
            if t is not None:
                if not (skip_special_tokens and t.special):
                    tokens.append(t.content)
                continue
            s = self._id_to_token.get(i)
            if s is not None:
                tokens.append(s)
        text = ("".join(self.decoder(tokens)) if self.decoder is not None
                else " ".join(tokens))
        clean = (self.clean_up_tokenization_spaces
                 if clean_up_tokenization_spaces is None
                 else clean_up_tokenization_spaces)
        if clean:
            text = clean_up_tokenization(text)
        return text

    def apply_chat_template(self, conversation, tokenize: bool = True,
                            add_generation_prompt: bool = False, **kwargs):
        """transformers' apply_chat_template on one conversation
        (tokenize=True gives ids without added special tokens); further
        keywords become template variables."""
        from .chat_template import render
        if self.chat_template is None:
            raise ValueError(f"{self.name_or_path or 'the tokenizer'} has no "
                             "chat template")
        out = render(self.chat_template, conversation,
                     add_generation_prompt=add_generation_prompt,
                     **{**self.special_tokens_map, **kwargs})
        return self.encode(out, add_special_tokens=False) if tokenize else out


def clean_up_tokenization(text: str) -> str:
    """transformers' clean_up_tokenization."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


def _read_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load(path: str) -> HFTokenizer:
    """Read the tokenizer files of directory `path` (see the module
    docstring); raises SentencePieceOnlyError for a directory that holds
    tokenizer.model without tokenizer.json, FileNotFoundError for one with
    neither, and ValueError for a component the reader lacks."""
    tj = os.path.join(path, "tokenizer.json")
    if not os.path.isfile(tj):
        if os.path.isfile(os.path.join(path, "tokenizer.model")):
            raise SentencePieceOnlyError(
                f"{path} holds tokenizer.model (a SentencePiece model) but no "
                "tokenizer.json: the port reads tokenizer.json only; write "
                "one with transformers' AutoTokenizer.from_pretrained(path)"
                ".save_pretrained(path)")
        raise FileNotFoundError(f"{path} holds no tokenizer.json")
    spec = _read_json(tj)
    cfg_path = os.path.join(path, "tokenizer_config.json")
    config = _read_json(cfg_path) if os.path.isfile(cfg_path) else {}
    special_map = os.path.join(path, "special_tokens_map.json")
    if "added_tokens_decoder" not in config and os.path.isfile(special_map):
        # transformers reads special_tokens_map.json only for configs
        # without added_tokens_decoder (its legacy path), and then over
        # the config's entries
        config = dict(config)
        for k, v in _read_json(special_map).items():
            if k == "additional_special_tokens":
                have = [_token_str(t) for t in
                        config.get("additional_special_tokens") or ()]
                config[k] = have + [_token_str(t) for t in v
                                    if _token_str(t) not in have]
            else:
                config[k] = v
    return HFTokenizer(spec, config, _chat_template(path, config),
                       name_or_path=path)


def _chat_template(path: str, config: dict) -> Optional[str]:
    """chat_template.jinja, which wins over the config's template (as in
    transformers), else the config's (None here), else
    chat_template.json's."""
    jinja = os.path.join(path, "chat_template.jinja")
    if os.path.isfile(jinja):
        with open(jinja, encoding="utf-8") as f:
            return f.read()
    legacy = os.path.join(path, "chat_template.json")
    if "chat_template" not in config and os.path.isfile(legacy):
        return _read_json(legacy)["chat_template"]
    return None
