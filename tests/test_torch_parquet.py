"""The port's plain-Python Parquet reader (videollama2_tpu_torch/eval/
parquet.py) against pandas.read_parquet, on files pyarrow writes here: the
codecs none / snappy / gzip, data pages v1 and v2, dictionaries on and off,
several row groups and pages, nulls, empty lists and null list elements,
non-ASCII strings and every supported physical type; the legacy 2-level
list and a bare repeated leaf from a writer in this file; the Video-MME
driver's load_parquet against the JAX package's (pandas) record for
record; each refusal by name; and the committed Video-MME-shaped fixture
(tests/fixtures/videomme/test-00000-of-00001.parquet, ~2,700 rows as the
published file has) against its golden digest of pandas' rows, which
chip_smoke.py checks on the GPU host.

    python tests/test_torch_parquet.py   # rewrites the fixture and digest
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import struct
import sys

import numpy as np
import pytest

for _p in (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),):
    if _p not in sys.path:
        sys.path.insert(0, _p)

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")
pd = pytest.importorskip("pandas")

from videollama2_tpu_torch.eval import parquet  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, "fixtures", "videomme")
FIXTURE = os.path.join(FIXTURE_DIR, "test-00000-of-00001.parquet")
GOLDEN = os.path.join(FIXTURE_DIR, "test-00000-of-00001.golden.json")


# -- pandas' values, as the reader gives them -------------------------------

def _plain(v):
    """A pandas cell as a Python value: numpy scalars unwrapped, arrays as
    lists, a missing value (None, NaN, pd.NA) as None."""
    if isinstance(v, np.ndarray):
        return [_plain(x) for x in v.tolist()]
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if v is None or v is pd.NA:
        return None
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and math.isnan(v):
        return None
    return v


def pandas_columns(path) -> dict:
    """pd.read_parquet's columns; its nullable dtypes keep an int64 column
    with nulls exact (the default widens it to float64)."""
    df = pd.read_parquet(path, dtype_backend="numpy_nullable")
    return {c: [_plain(v) for v in df[c].tolist()] for c in df.columns}


def rows_digest(columns: dict) -> str:
    """SHA-256 of the rows as canonical JSON (chip_smoke.py computes the
    same over the reader's rows on the GPU host)."""
    names = list(columns)
    rows = [dict(zip(names, vals)) for vals in zip(*columns.values())]
    return hashlib.sha256(json.dumps(
        rows, ensure_ascii=False, separators=(",", ":")).encode()).hexdigest()


# -- the matrix ---------------------------------------------------------------

WORDS = ["cat", "dog", "river", "café", "naïve", "東京", "Ärger", "smörgås",
         "🎬", "", "x" * 40]


def matrix_table(rows=700, seed=0):
    """Every supported physical type, optional and required, with nulls,
    and string lists with empty lists, null lists and null elements."""
    rng = np.random.default_rng(seed)

    def maybe(vals, p=0.15):
        return [None if rng.random() < p else v for v in vals]

    def word():
        return WORDS[int(rng.integers(len(WORDS)))]

    ints = rng.integers(-2**31, 2**31, rows)
    lists = []
    for _ in range(rows):
        r = rng.random()
        if r < 0.1:
            lists.append(None)
        elif r < 0.2:
            lists.append([])
        else:
            lists.append([None if rng.random() < 0.1 else word()
                          for _ in range(int(rng.integers(1, 6)))])
    fields = [
        ("bool", pa.bool_(), maybe([bool(b) for b in rng.random(rows) < .5])),
        ("int32", pa.int32(), maybe([int(v) for v in ints])),
        ("int32_req", pa.int32(), [int(v) % 1000 for v in ints]),
        ("int64", pa.int64(), maybe([int(v) for v in
                                     rng.integers(-2**62, 2**62, rows)])),
        ("float", pa.float32(), maybe([float(np.float32(v)) for v in
                                       rng.normal(size=rows)])),
        ("double", pa.float64(), maybe([float(v) for v in
                                        rng.normal(size=rows) * 1e6])),
        ("string", pa.string(), maybe([word() for _ in range(rows)])),
        ("string_req", pa.string(), [f"{i:05d}-{word()}"
                                     for i in range(rows)]),
        ("binary", pa.binary(), maybe([bytes(rng.integers(0, 256, int(
            rng.integers(0, 9))).astype(np.uint8)) for _ in range(rows)])),
        ("options", pa.list_(pa.string()), lists),
        ("ints", pa.list_(pa.int64()), [None if v is None else
                                        [len(w or "") for w in v]
                                        for v in lists]),
        ("uint32", pa.uint32(), maybe([int(v) for v in
                                       rng.integers(0, 2**32, rows)])),
        ("uint64", pa.uint64(), maybe([int(v) for v in rng.integers(
            0, 2**64, rows, dtype=np.uint64)])),
        ("int8", pa.int8(), maybe([int(v) for v in
                                   rng.integers(-128, 128, rows)])),
    ]
    schema = pa.schema([pa.field(n, t, nullable=not n.endswith("_req"))
                        for n, t, _ in fields])
    return pa.table({n: pa.array(v, t) for n, t, v in fields}, schema=schema)


MATRIX = [(codec, version, dictionary)
          for codec in ("none", "snappy", "gzip")
          for version in ("1.0", "2.0")
          for dictionary in (True, False)]


@pytest.mark.parametrize("codec,version,dictionary", MATRIX)
def test_reader_equals_pandas(tmp_path, codec, version, dictionary):
    """Three row groups of several pages each (small data pages and write
    batches), every value as pandas reads it."""
    path = tmp_path / "t.parquet"
    pq.write_table(matrix_table(), path, compression=codec,
                   data_page_version=version, use_dictionary=dictionary,
                   row_group_size=300, data_page_size=512,
                   write_batch_size=64)
    meta = pq.ParquetFile(path).metadata
    assert meta.num_row_groups == 3
    want = pandas_columns(path)
    got = parquet.read_columns(str(path))
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    rows = list(parquet.read_rows(str(path)))
    assert len(rows) == 700 and rows[5].string_req == want["string_req"][5]
    # several pages a column chunk
    with open(path, "rb") as f:
        buf = f.read()
    chunk = parquet.read_metadata(buf)[4][0][1][7][3]
    pages, pos, seen = 0, chunk[9], 0
    while seen < chunk[5]:
        t = parquet._Thrift(buf, pos)
        head = t.struct()
        pos = t.pos + head[3]
        if head[1] != parquet.DICTIONARY_PAGE:
            pages += 1
            seen += (head.get(5) or head.get(8))[1]
    assert pages > 1


def test_encodings_are_those_named(tmp_path):
    """The matrix reaches what it names: v2 pages, dictionary pages and
    RLE_DICTIONARY, PLAIN, RLE booleans (v2) and each codec."""
    seen = set()
    for codec, version, dictionary in MATRIX:
        path = tmp_path / f"{codec}{version}{dictionary}.parquet"
        pq.write_table(matrix_table(rows=200), path, compression=codec,
                       data_page_version=version, use_dictionary=dictionary)
        md = pq.ParquetFile(path).metadata
        for i in range(md.num_columns):
            col = md.row_group(0).column(i)
            seen.add(col.compression)
            seen.update(col.encodings)
    assert {"UNCOMPRESSED", "SNAPPY", "GZIP", "PLAIN", "RLE",
            "RLE_DICTIONARY"} <= seen, seen


def test_one_column_many_shapes(tmp_path):
    """Edge cases a column at a time: all null, all empty lists, a single
    row, long strings (the hybrid's long runs and a snappy literal past 60
    bytes), and a list column whose elements are never null."""
    long = "ab" * 5000
    cases = {
        "all_null": pa.array([None] * 50, pa.string()),
        "empty_lists": pa.array([[]] * 50, pa.list_(pa.string())),
        "long": pa.array([long, long[::-1], None] * 10, pa.string()),
        "one": pa.array([7], pa.int64()),
        "dense_lists": pa.array([["a", "b", "c"]] * 40, pa.list_(
            pa.field("element", pa.string(), nullable=False))),
    }
    for name, arr in cases.items():
        for codec in ("snappy", "gzip"):
            path = tmp_path / f"{name}_{codec}.parquet"
            pq.write_table(pa.table({name: arr}), path, compression=codec)
            assert parquet.read_columns(str(path)) == pandas_columns(path), \
                (name, codec)


# -- the legacy forms, from a writer in this file -----------------------------

def _varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _zz(n):
    return _varint((n << 1) ^ (n >> 63))


def _tstruct(fields):
    """Thrift compact struct from [(id, kind, value)], kind 'i32', 'i64',
    'bin', 'struct' or 'list:<elem kind>'."""
    out, last = bytearray(), 0
    codes = {"i32": 5, "i64": 6, "bin": 8, "struct": 12}
    for fid, kind, val in fields:
        code = 9 if kind.startswith("list") else codes[kind]
        out.append(((fid - last) << 4) | code if 0 < fid - last < 16
                   else code)
        if not 0 < fid - last < 16:
            out += _zz(fid)
        last = fid
        out += _tvalue(kind, val)
    out.append(0)
    return bytes(out)


def _tvalue(kind, val):
    if kind in ("i32", "i64"):
        return _zz(val)
    if kind == "bin":
        return _varint(len(val)) + val
    if kind == "struct":
        return _tstruct(val)
    elem = kind.split(":", 1)[1]
    code = {"i32": 5, "i64": 6, "bin": 8, "struct": 12}[elem]
    head = (bytes([(len(val) << 4) | code]) if len(val) < 15
            else bytes([0xF0 | code]) + _varint(len(val)))
    return head + b"".join(_tvalue(elem, v) for v in val)


def _rle_levels(levels, width):
    """Levels as RLE runs (one run a value change), with v1's length."""
    body = bytearray()
    i = 0
    while i < len(levels):
        j = i
        while j < len(levels) and levels[j] == levels[i]:
            j += 1
        body += _varint((j - i) << 1) + levels[i].to_bytes(
            (width + 7) // 8, "little")
        i = j
    return struct.pack("<i", len(body)) + bytes(body)


def write_list_file(path, schema, rows, max_def, d_list, d_elem):
    """One uncompressed PLAIN v1 page of a string-list column given as a
    flat schema [(name, repetition, num_children, converted type)]; rows
    are lists, None for a null list."""
    reps, defs, vals = [], [], []
    for row in rows:
        if row is None or not row:
            reps.append(0)
            defs.append(d_list - 1 if row is None else d_elem - 1)
            continue
        for k, v in enumerate(row):
            reps.append(int(k > 0))
            defs.append(max_def)
            vals.append(v.encode())
    page = (_rle_levels(reps, 1) + _rle_levels(defs, max_def.bit_length())
            + b"".join(struct.pack("<i", len(v)) + v for v in vals))
    header = _tstruct([(1, "i32", 0), (2, "i32", len(page)),
                       (3, "i32", len(page)),
                       (5, "struct", [(1, "i32", len(reps)), (2, "i32", 0),
                                      (3, "i32", 3), (4, "i32", 3)])])
    data_off = 4
    leaf_path = [n.encode() for n, *_ in schema[1:]]
    elems = []
    for name, rep, kids, conv in schema:
        f = []
        if not kids and name != "schema":
            f.append((1, "i32", 6))
        if rep is not None:
            f.append((3, "i32", rep))
        f.append((4, "bin", name.encode()))
        if kids:
            f.append((5, "i32", kids))
        if conv is not None:
            f.append((6, "i32", conv))
        elems.append(f)
    col_meta = [(1, "i32", 6), (2, "list:i32", [0, 3]),
                (3, "list:bin", leaf_path), (4, "i32", 0),
                (5, "i64", len(reps)),
                (6, "i64", len(header) + len(page)),
                (7, "i64", len(header) + len(page)),
                (9, "i64", data_off)]
    meta = _tstruct([
        (1, "i32", 1), (2, "list:struct", elems), (3, "i64", len(rows)),
        (4, "list:struct", [[(1, "list:struct", [[(2, "i64", data_off),
                                                  (3, "struct", col_meta)]]),
                             (2, "i64", len(header) + len(page)),
                             (3, "i64", len(rows))]])])
    with open(path, "wb") as f:
        f.write(b"PAR1" + header + page + meta + struct.pack("<i", len(meta))
                + b"PAR1")


LEGACY_ROWS = [["a", "b"], [], None, ["ü"], ["x", "y", "z"]]


@pytest.mark.parametrize("form", ["two_level", "three_level", "bare"])
def test_list_forms_equal_pandas(tmp_path, form):
    """The legacy 2-level LIST (a repeated leaf under the LIST group), the
    3-level form, and a bare repeated leaf (no LIST group: never null)."""
    path = tmp_path / f"{form}.parquet"
    if form == "two_level":
        schema = [("schema", None, 1, None), ("options", 1, 1, 3),
                  ("item", 2, 0, 0)]
        write_list_file(path, schema, LEGACY_ROWS, 2, 1, 2)
        rows = LEGACY_ROWS
    elif form == "three_level":
        schema = [("schema", None, 1, None), ("options", 1, 1, 3),
                  ("list", 2, 1, None), ("element", 0, 0, 0)]
        write_list_file(path, schema, LEGACY_ROWS, 2, 1, 2)
        rows = LEGACY_ROWS
    else:
        schema = [("schema", None, 1, None), ("options", 2, 0, 0)]
        rows = [r if r is not None else [] for r in LEGACY_ROWS]
        write_list_file(path, schema, rows, 1, 1, 1)
    got = parquet.read_columns(str(path))
    assert got == {"options": rows}
    assert got == pandas_columns(path)


# -- snappy -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "repetitive", "runs", "empty",
                                  "long_literal"])
def test_snappy_equals_pyarrow(kind):
    """snappy_decompress inverts pyarrow's raw snappy: literals of every
    length class and overlapping copies."""
    rng = np.random.default_rng(1)
    data = {
        "random": rng.integers(0, 256, 70000).astype(np.uint8).tobytes(),
        "repetitive": b"abcabcabd" * 9000 + b"tail",
        "runs": b"".join(bytes([i % 7]) * int(n) for i, n in
                         enumerate(rng.integers(1, 300, 400))),
        "empty": b"",
        "long_literal": bytes(range(256)) * 300,
    }[kind]
    comp = pa.compress(data, codec="snappy", asbytes=True)
    assert parquet.snappy_decompress(comp) == data


# -- refusals -----------------------------------------------------------------

def _refused_table(kind):
    if kind == "struct":
        return pa.table({"s": pa.array([{"a": 1, "b": "x"}])}), {}
    if kind == "map":
        return pa.table({"m": pa.array([[("k", 1)]], pa.map_(pa.string(),
                                                             pa.int64()))}), {}
    if kind == "list_of_lists":
        return pa.table({"ll": pa.array([[["a"]]], pa.list_(pa.list_(
            pa.string())))}), {}
    if kind == "list_of_structs":
        return pa.table({"ls": pa.array([[{"a": 1}]])}), {}
    if kind == "timestamp":
        return pa.table({"t": pa.array([1], pa.timestamp("ms"))}), {}
    if kind == "date":
        return pa.table({"d": pa.array([1], pa.date32())}), {}
    if kind == "decimal":
        return pa.table({"d": pa.array([1], pa.decimal128(5, 2))}), {}
    if kind == "fixed":
        return pa.table({"f": pa.array([b"ab"], pa.binary(2))}), {}
    if kind == "int96":
        return (pa.table({"t": pa.array([1], pa.timestamp("ns"))}),
                {"use_deprecated_int96_timestamps": True})
    ints = pa.table({"i": pa.array(list(range(100)), pa.int64()),
                     "s": pa.array([f"s{i}" for i in range(100)])})
    if kind in ("zstd", "brotli", "lz4"):
        return ints, {"compression": kind}
    if kind == "byte_stream_split":
        return (pa.table({"f": pa.array([1.5] * 10, pa.float32())}),
                {"use_dictionary": False, "use_byte_stream_split": True})
    return ints, {"use_dictionary": False, "column_encoding": {
        "i": "DELTA_BINARY_PACKED", "s": kind}}


REFUSALS = {
    "zstd": "ZSTD", "brotli": "BROTLI", "lz4": "LZ4",
    "DELTA_LENGTH_BYTE_ARRAY": "DELTA_BINARY_PACKED",
    "DELTA_BYTE_ARRAY": "DELTA_BINARY_PACKED",
    "byte_stream_split": "BYTE_STREAM_SPLIT", "struct": "nested structs",
    "map": "maps", "list_of_lists": "lists of lists",
    "list_of_structs": "lists of structs", "timestamp": "TIMESTAMP",
    "date": "DATE", "decimal": "DECIMAL", "fixed": "FIXED_LEN_BYTE_ARRAY",
    "int96": "INT96",
}


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_refusals_name_what_they_met(tmp_path, kind):
    table, kw = _refused_table(kind)
    path = tmp_path / f"{kind}.parquet"
    pq.write_table(table, path, **kw)
    with pytest.raises(NotImplementedError, match=REFUSALS[kind]):
        parquet.read_columns(str(path))


def test_delta_string_encodings_are_named(tmp_path):
    """DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY on a string column
    alone name themselves."""
    for enc in ("DELTA_LENGTH_BYTE_ARRAY", "DELTA_BYTE_ARRAY"):
        path = tmp_path / f"{enc}.parquet"
        pq.write_table(pa.table({"s": [f"s{i}" for i in range(50)]}), path,
                       use_dictionary=False, column_encoding={"s": enc})
        with pytest.raises(NotImplementedError, match=enc):
            parquet.read_columns(str(path))


@pytest.mark.parametrize("damage", ["magic", "footer_length", "truncated"])
def test_malformed_files_raise_value_error(tmp_path, damage):
    path = tmp_path / "t.parquet"
    pq.write_table(matrix_table(rows=50), path, compression="snappy")
    data = bytearray(path.read_bytes())
    if damage == "magic":
        data[:4] = b"PAR0"
    elif damage == "footer_length":
        data[-8:-4] = struct.pack("<i", len(data))
    else:
        data = data[:len(data) // 2] + data[-8:]
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        parquet.read_columns(str(path))


# -- Video-MME -----------------------------------------------------------------

def test_load_parquet_equals_jax(tmp_path):
    """The port's load_parquet (the reader) against the JAX package's
    (pandas) on the committed fixture and on the small eval fixture."""
    from videollama2_tpu.eval.inference_video_mcqa_videomme import \
        load_parquet as jax_load
    from videollama2_tpu_torch.eval.inference_video_mcqa_videomme import \
        load_parquet as port_load
    for path in (FIXTURE, os.path.join(FIXTURE_DIR, "questions.parquet")):
        want = jax_load(path)
        got = port_load(path)
        assert len(got) == len(want)
        assert json.dumps(got) == json.dumps(want)
    assert len(got) == 3


def test_fixture_matches_its_golden_digest():
    """The committed fixture's rows through pandas and through the reader
    both give the golden digest chip_smoke.py holds the GPU host to."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    want = pandas_columns(FIXTURE)
    got = parquet.read_columns(FIXTURE)
    assert rows_digest(want) == golden["rows_sha256"]
    assert rows_digest(got) == golden["rows_sha256"]
    assert len(got["question_id"]) == golden["rows"] == 2700
    assert os.path.getsize(FIXTURE) <= 400_000
    md = pq.ParquetFile(FIXTURE).metadata
    assert md.num_row_groups == golden["row_groups"] > 1


def test_fixture_is_what_the_generator_writes(tmp_path):
    """The generator, run again, writes the same rows."""
    path = tmp_path / "f.parquet"
    write_fixture(str(path))
    assert rows_digest(pandas_columns(path)) == rows_digest(
        pandas_columns(FIXTURE))


def test_chip_smoke_digest_agrees():
    """chip_smoke.py's digest of the reader's rows is this file's."""
    sys.path.insert(0, os.path.dirname(HERE))
    import chip_smoke
    cols = parquet.read_columns(FIXTURE)
    assert chip_smoke.parquet_rows_digest(cols) == rows_digest(cols)


def test_reader_and_launcher_import_no_pandas_pyarrow_or_jax():
    """The port's whole import closure, the launcher's and chip_smoke.py's
    (tests/test_torch_imports.py's scan) reach no pandas, pyarrow or JAX."""
    import test_torch_imports as ti
    from pathlib import Path
    root = Path(ti.ROOT)
    launcher = root / "scripts" / "torch" / "launch_multinode.py"
    closure = ti._closure()
    todo, seen = [launcher], {}
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen[path] = []
        for module, level, names in ti._imports(path):
            for dotted in ti._resolve(path, module, level, names):
                seen[path].append(dotted)
                parts = dotted.split(".")
                for i in range(1, len(parts) + 1):
                    f = ti._module_file(".".join(parts[:i]))
                    if f is not None and f not in seen:
                        todo.append(f)
    closure.update(seen)
    port = root / "videollama2_tpu_torch"
    assert port / "eval" / "parquet.py" in closure
    assert port / "parallel" / "mesh.py" in seen
    bad = sorted(f"{p.relative_to(root)} imports {m}"
                 for p, mods in closure.items() for m in mods
                 if m.split(".")[0] in ("pandas", "pyarrow", "jax", "jaxlib")
                 and ti.REFERENCE not in p.parents)
    assert not bad, bad


# -- the fixture's generator ---------------------------------------------------

DOMAINS = {
    "Knowledge": ["Humanity & History", "Literature & Art", "Biology & "
                  "Medicine", "Finance & Commerce", "Astronomy"],
    "Film & Television": ["Movie & TV Show", "Animation", "Documentary"],
    "Sports Competition": ["Football", "Basketball", "Athletics", "Esports"],
    "Artistic Performance": ["Stage Play", "Magic Show", "Acrobatics"],
    "Life Record": ["Daily Life", "Travel", "Pet & Animal", "Exercise"],
    "Multilingual": ["Multilingual"],
}
TASKS = ["Temporal Perception", "Spatial Perception", "Attribute Perception",
         "Action Recognition", "Object Recognition", "OCR Problems",
         "Counting Problem", "Temporal Reasoning", "Spatial Reasoning",
         "Action Reasoning", "Object Reasoning", "Information Synopsis"]
TEXT = ("the a man woman child dog car ball video shows opens holds runs "
        "after before while during first last second red blue green small "
        "large near behind beside kitchen street stage field audience "
        "camera scene moves turns picks throws café Zürich naïve 東京 "
        "señora").split()
YT = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_"


def fixture_table(videos=900, per_video=3, seed=23):
    """Video-MME's columns and shapes: 900 videos x 3 questions, string
    columns and `options` a list<string> of four "X. ..." choices."""
    rng = np.random.default_rng(seed)

    def text(lo, hi):
        return " ".join(TEXT[i] for i in rng.integers(
            0, len(TEXT), int(rng.integers(lo, hi))))

    cols = {k: [] for k in ("video_id", "duration", "domain", "sub_category",
                            "url", "videoID", "question_id", "task_type",
                            "question", "options", "answer")}
    domains = sorted(DOMAINS)
    for v in range(videos):
        ytid = "".join(YT[i] for i in rng.integers(0, len(YT), 11))
        domain = domains[int(rng.integers(len(domains)))]
        sub = DOMAINS[domain][int(rng.integers(len(DOMAINS[domain])))]
        for q in range(per_video):
            cols["video_id"].append(f"{v + 1:03d}")
            cols["duration"].append(("short", "medium", "long")[
                v * 3 // videos])
            cols["domain"].append(domain)
            cols["sub_category"].append(sub)
            cols["url"].append(f"https://www.youtube.com/watch?v={ytid}")
            cols["videoID"].append(ytid)
            cols["question_id"].append(f"{v + 1:03d}-{q + 1}")
            cols["task_type"].append(TASKS[int(rng.integers(len(TASKS)))])
            cols["question"].append(text(6, 16).capitalize() + "?")
            cols["options"].append([f"{c}. {text(2, 7).capitalize()}."
                                    for c in "ABCD"])
            cols["answer"].append("ABCD"[int(rng.integers(4))])
    return pa.table(cols)


def write_fixture(path):
    """As HF `datasets` writes (snappy, dictionaries, data page v1), in
    three row groups of small pages."""
    pq.write_table(fixture_table(), path, compression="snappy",
                   row_group_size=1000, data_page_size=16384)


if __name__ == "__main__":
    write_fixture(FIXTURE)
    cols = pandas_columns(FIXTURE)
    with open(GOLDEN, "w") as f:
        json.dump({"rows": len(cols["question_id"]),
                   "row_groups": pq.ParquetFile(FIXTURE).metadata
                   .num_row_groups,
                   "rows_sha256": rows_digest(cols)}, f, indent=1)
        f.write("\n")
    print(FIXTURE, os.path.getsize(FIXTURE), "bytes")
