"""A plain-Python Parquet reader: numpy and the standard library only.

Reads the files pyarrow (and so HF `datasets`) writes for a flat table
such as Video-MME's question file, to the values `pandas.read_parquet`
gives:
  - the footer (`PAR1`, FileMetaData, RowGroup, ColumnChunk, the schema)
    and every PageHeader, decoded from the Thrift compact protocol;
  - any number of row groups, and of pages a column chunk;
  - DICTIONARY_PAGE, DATA_PAGE (v1: levels behind a 4-byte length) and
    DATA_PAGE_V2 (levels stored uncompressed, values compressed or not
    as `is_compressed` says);
  - the encodings PLAIN, PLAIN_DICTIONARY / RLE_DICTIONARY (a bit-width
    byte, then the RLE / bit-packed hybrid) and RLE (levels, booleans);
  - the codecs UNCOMPRESSED, SNAPPY (raw snappy, decompressed here) and
    GZIP (zlib);
  - BOOLEAN, INT32, INT64 (signed or unsigned), FLOAT, DOUBLE and
    BYTE_ARRAY (UTF8 / STRING annotated: `str`, else `bytes`) leaves,
    required or optional (a null is None), at the top level or as the
    elements of one level of LIST in its 3-level or legacy 2-level form
    (a null list is None, an empty one []); a bare repeated leaf reads as
    a list too.

Anything else raises NotImplementedError naming it: the ZSTD, BROTLI, LZ4
and LZO codecs, the DELTA_* and BYTE_STREAM_SPLIT encodings, BIT_PACKED
levels, INT96 and FIXED_LEN_BYTE_ARRAY, date, time, timestamp and decimal
annotations, structs, maps, lists of lists and lists of structs. A
malformed file raises ValueError.

    cols = read_columns(path)          # {name: [value of each row]}
    for row in read_rows(path): ...    # namedtuples, in row order
"""

from __future__ import annotations

import collections
import struct
import zlib
from typing import Dict, Iterator, List

import numpy as np

MAGIC = b"PAR1"

# parquet.thrift's enums
TYPES = {0: "BOOLEAN", 1: "INT32", 2: "INT64", 3: "INT96", 4: "FLOAT",
         5: "DOUBLE", 6: "BYTE_ARRAY", 7: "FIXED_LEN_BYTE_ARRAY"}
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI",
          5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
             7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY",
             9: "BYTE_STREAM_SPLIT"}
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 1, 2, 3
# ConvertedType: UTF8, MAP, MAP_KEY_VALUE, LIST; the integer annotations
# (UINT_8 .. UINT_64, then INT_8 .. INT_64) read as integers
CONV_UTF8, CONV_MAP, CONV_MAP_KV, CONV_LIST, CONV_ENUM = 0, 1, 2, 3, 4
CONV_INTS, CONV_UINTS = range(11, 19), range(11, 15)
CONV_NAMES = {5: "DECIMAL", 6: "DATE", 7: "TIME_MILLIS", 8: "TIME_MICROS",
              9: "TIMESTAMP_MILLIS", 10: "TIMESTAMP_MICROS", 19: "JSON",
              20: "BSON", 21: "INTERVAL"}
# LogicalType union members
LOGICAL_NAMES = {1: "STRING", 2: "MAP", 3: "LIST", 4: "ENUM", 5: "DECIMAL",
                 6: "DATE", 7: "TIME", 8: "TIMESTAMP", 10: "INTEGER",
                 11: "UNKNOWN", 12: "JSON", 13: "BSON", 14: "UUID",
                 15: "FLOAT16"}


# -- Thrift compact protocol --------------------------------------------------

class _Thrift:
    """A cursor over Thrift compact-protocol bytes. A struct reads as
    {field id: value}, a list as a Python list."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def byte(self) -> int:
        if self.pos >= len(self.buf):
            raise ValueError("parquet: truncated Thrift data")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def binary(self) -> bytes:
        n = self.varint()
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("parquet: truncated Thrift binary")
        out = bytes(self.buf[self.pos:end])
        self.pos = end
        return out

    def value(self, kind: int):
        if kind in (1, 2):            # a bool inside a list: one byte
            return self.byte() == 1
        if kind == 3:
            b = self.byte()
            return b - 256 if b > 127 else b
        if kind in (4, 5, 6):
            return self.zigzag()
        if kind == 7:
            out = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return out
        if kind == 8:
            return self.binary()
        if kind in (9, 10):
            head = self.byte()
            n, elem = head >> 4, head & 0x0F
            if n == 15:
                n = self.varint()
            return [self.value(elem) for _ in range(n)]
        if kind == 11:
            n = self.varint()
            if not n:
                return {}
            kinds = self.byte()
            return {self.value(kinds >> 4): self.value(kinds & 0x0F)
                    for _ in range(n)}
        if kind == 12:
            return self.struct()
        raise ValueError(f"parquet: unknown Thrift type {kind}")

    def struct(self) -> dict:
        out, fid = {}, 0
        while True:
            head = self.byte()
            if head == 0:
                return out
            kind, delta = head & 0x0F, head >> 4
            fid = fid + delta if delta else self.zigzag()
            if kind == 1:
                out[fid] = True
            elif kind == 2:
                out[fid] = False
            else:
                out[fid] = self.value(kind)


# -- codecs -------------------------------------------------------------------

def snappy_decompress(data) -> bytes:
    """Raw snappy (no framing): a varint length, then literal and copy
    elements (tags 00 literal, 01 copy with a 1-byte offset, 10 and 11
    with 2- and 4-byte offsets)."""
    t = _Thrift(data)
    n = t.varint()
    pos, end = t.pos, len(data)
    out = bytearray()
    while pos < end:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                length = int.from_bytes(data[pos:pos + extra], "little")
                pos += extra
            length += 1
            if pos + length > end:
                raise ValueError("parquet: truncated snappy literal")
            out += data[pos:pos + length]
            pos += length
            continue
        if kind == 1:
            length = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("parquet: snappy copy before the start")
        start = len(out) - offset
        if offset >= length:
            out += out[start:start + length]
        else:                       # an overlapping copy repeats its run
            run = bytes(out[start:])
            out += (run * (length // offset + 1))[:length]
    if len(out) != n:
        raise ValueError(f"parquet: snappy gave {len(out)} bytes, not {n}")
    return bytes(out)


def decompress(codec: int, data, size: int) -> bytes:
    if codec == 0:
        out = bytes(data)
    elif codec == 1:
        out = snappy_decompress(data)
    elif codec == 2:
        out = zlib.decompressobj(32 + zlib.MAX_WBITS).decompress(bytes(data))
    else:
        raise NotImplementedError(
            f"parquet codec {CODECS.get(codec, codec)} is not supported "
            "(UNCOMPRESSED, SNAPPY and GZIP are)")
    if len(out) != size:
        raise ValueError(f"parquet: a page decompressed to {len(out)} bytes, "
                         f"its header says {size}")
    return out


# -- encodings ----------------------------------------------------------------

def rle_hybrid(buf, pos: int, end: int, width: int, count: int) -> np.ndarray:
    """`count` values of the RLE / bit-packed hybrid in buf[pos:end]."""
    out = np.zeros(count, dtype=np.int64)
    if width == 0:
        return out
    nbytes = (width + 7) // 8
    t = _Thrift(buf, pos)
    got = 0
    while got < count:
        if t.pos >= end:
            raise ValueError("parquet: RLE data ends early")
        head = t.varint()
        if head & 1:                                   # bit-packed groups
            n = (head >> 1) * 8
            raw = np.frombuffer(buf, dtype=np.uint8, count=(head >> 1) * width,
                                offset=t.pos)
            t.pos += (head >> 1) * width
            bits = np.unpackbits(raw, bitorder="little").reshape(n, width)
            vals = bits.astype(np.int64) @ (1 << np.arange(width,
                                                           dtype=np.int64))
            take = min(n, count - got)
            out[got:got + take] = vals[:take]
        else:                                          # one repeated value
            n = head >> 1
            v = int.from_bytes(buf[t.pos:t.pos + nbytes], "little")
            t.pos += nbytes
            take = min(n, count - got)
            out[got:got + take] = v
        got += take
    return out


_FIXED = {"INT32": "<i4", "INT64": "<i8", "FLOAT": "<f4", "DOUBLE": "<f8"}


def plain(buf, pos: int, ptype: str, count: int) -> list:
    """`count` PLAIN values of a physical type from buf[pos:]."""
    if ptype in _FIXED:
        return np.frombuffer(buf, dtype=_FIXED[ptype], count=count,
                             offset=pos).tolist()
    if ptype == "BOOLEAN":
        raw = np.frombuffer(buf, dtype=np.uint8, count=(count + 7) // 8,
                            offset=pos)
        return np.unpackbits(raw, bitorder="little")[:count].astype(
            bool).tolist()
    if ptype == "BYTE_ARRAY":
        out = []
        for _ in range(count):
            n = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
            if pos + n > len(buf):
                raise ValueError("parquet: truncated BYTE_ARRAY value")
            out.append(bytes(buf[pos:pos + n]))
            pos += n
        return out
    raise NotImplementedError(f"parquet physical type {ptype} is not "
                              "supported")


# -- the schema ---------------------------------------------------------------

def _annotation(el: dict) -> str:
    """The element's logical annotation by name, or "" for none."""
    logical = el.get(10)
    if logical:
        (member,) = logical
        return LOGICAL_NAMES.get(member, f"logical type {member}")
    conv = el.get(6)
    if conv is None or conv in CONV_INTS:
        return "INTEGER" if conv is not None else ""
    return {CONV_UTF8: "STRING", CONV_MAP: "MAP", CONV_MAP_KV: "MAP",
            CONV_LIST: "LIST", CONV_ENUM: "ENUM"}.get(
                conv, CONV_NAMES.get(conv, f"converted type {conv}"))


class _Column:
    """A top-level column: its leaf's physical type, whether it is a list,
    and the definition levels that mark a present list, a first element and
    a present value."""

    def __init__(self, name, leaf, path, is_list, d_list, d_elem, max_def,
                 max_rep):
        self.name, self.path, self.is_list = name, path, is_list
        self.ptype = TYPES.get(leaf.get(1), f"type {leaf.get(1)}")
        ann = _annotation(leaf)
        if ann not in ("", "STRING", "ENUM", "INTEGER", "JSON"):
            raise NotImplementedError(
                f"parquet column {name!r}: the {ann} annotation is not "
                "supported")
        if self.ptype in ("INT96", "FIXED_LEN_BYTE_ARRAY"):
            raise NotImplementedError(
                f"parquet column {name!r}: physical type {self.ptype} is not "
                "supported")
        self.text = ann in ("STRING", "ENUM", "JSON")
        # an unsigned integer is stored in the signed physical type
        logical = leaf.get(10) or {}
        self.unsigned = (leaf.get(6) in CONV_UINTS
                         or logical.get(10, {}).get(2) is False)
        self.d_list, self.d_elem = d_list, d_elem
        self.max_def, self.max_rep = max_def, max_rep


def _tree(schema: List[dict]):
    """The flat schema list as (element, [children]) nodes under the root."""
    pos = 0

    def node():
        nonlocal pos
        el = schema[pos]
        pos += 1
        return el, [node() for _ in range(el.get(5, 0))]
    root = node()
    if pos != len(schema):
        raise ValueError("parquet: schema elements left over")
    return root


def _name(el) -> str:
    return el[4].decode("utf-8")


def _columns(schema: List[dict]) -> List[_Column]:
    cols = []
    for el, kids in _tree(schema)[1]:
        name, rep = _name(el), el.get(3, REQUIRED)
        ann = _annotation(el)
        if not kids:
            if rep == REPEATED:      # a bare repeated leaf: a list, never null
                cols.append(_Column(name, el, [name], True, 0, 1, 1, 1))
            else:
                d = int(rep == OPTIONAL)
                cols.append(_Column(name, el, [name], False, d, d, d, 0))
            continue
        if ann == "MAP":
            raise NotImplementedError(f"parquet column {name!r}: maps are "
                                      "not supported")
        if ann != "LIST":
            raise NotImplementedError(f"parquet column {name!r}: nested "
                                      "structs are not supported")
        if len(kids) != 1 or kids[0][0].get(3) != REPEATED:
            raise ValueError(f"parquet column {name!r}: a LIST whose child "
                             "is not one repeated field")
        d_list = int(rep == OPTIONAL)
        rel, rel_kids = kids[0]
        d_elem = d_list + 1
        if not rel_kids:             # 2-level: the repeated leaf is the item
            cols.append(_Column(name, rel, [name, _name(rel)], True, d_list,
                                d_elem, d_elem, 1))
            continue
        rname = _name(rel)
        if len(rel_kids) != 1 or rname == "array" \
                or rname == f"{name}_tuple":
            raise NotImplementedError(f"parquet column {name!r}: lists of "
                                      "structs are not supported")
        item, item_kids = rel_kids[0]
        if item_kids or item.get(3) == REPEATED:
            what = ("lists of lists" if _annotation(item) == "LIST"
                    else "maps" if _annotation(item) == "MAP"
                    else "lists of structs")
            raise NotImplementedError(f"parquet column {name!r}: {what} are "
                                      "not supported")
        max_def = d_elem + int(item.get(3, REQUIRED) == OPTIONAL)
        cols.append(_Column(name, item, [name, rname, _name(item)], True,
                            d_list, d_elem, max_def, 1))
    return cols


# -- pages --------------------------------------------------------------------

def _levels_v1(page, pos: int, encoding: int, max_level: int, count: int):
    if max_level == 0:
        return np.zeros(count, dtype=np.int64), pos
    if encoding != RLE:
        raise NotImplementedError(
            f"parquet levels in {ENCODINGS.get(encoding, encoding)} encoding "
            "are not supported (RLE is)")
    n = int.from_bytes(page[pos:pos + 4], "little")
    pos += 4
    return rle_hybrid(page, pos, pos + n, max_level.bit_length(),
                      count), pos + n


def _values(col: _Column, page, pos: int, encoding: int, count: int,
            dictionary):
    if encoding in (PLAIN_DICTIONARY, RLE_DICTIONARY):
        if dictionary is None:
            raise ValueError(f"parquet column {col.name!r}: dictionary-"
                             "encoded page without a dictionary page")
        width = page[pos]
        idx = rle_hybrid(page, pos + 1, len(page), width, count)
        if count and int(idx.max()) >= len(dictionary):
            raise ValueError(f"parquet column {col.name!r}: dictionary index "
                             "out of range")
        return [dictionary[i] for i in idx.tolist()]
    if encoding == PLAIN:
        return plain(page, pos, col.ptype, count)
    if encoding == RLE and col.ptype == "BOOLEAN":
        n = int.from_bytes(page[pos:pos + 4], "little")
        return rle_hybrid(page, pos + 4, pos + 4 + n, 1, count).astype(
            bool).tolist()
    raise NotImplementedError(
        f"parquet column {col.name!r}: the "
        f"{ENCODINGS.get(encoding, f'encoding {encoding}')} encoding is not "
        "supported")


def _read_chunk(col: _Column, buf, meta: dict):
    """(repetition levels, definition levels, defined values) of a column
    chunk, over all its pages."""
    codec = meta.get(4, 0)
    if codec not in (0, 1, 2):
        raise NotImplementedError(
            f"parquet column {col.name!r}: codec "
            f"{CODECS.get(codec, codec)} is not supported (UNCOMPRESSED, "
            "SNAPPY and GZIP are)")
    total = meta[5]
    # the dictionary page, where there is one, comes first (a writer may
    # leave dictionary_page_offset 0 for none)
    pos = meta[9]
    if meta.get(11) and meta[11] < pos:
        pos = meta[11]
    reps, defs, values = [], [], []
    dictionary = None
    seen = 0
    while seen < total:
        t = _Thrift(buf, pos)
        head = t.struct()
        start = t.pos
        kind, size, csize = head[1], head[2], head[3]
        pos = start + csize
        if pos > len(buf):
            raise ValueError("parquet: a page runs past the end of the file")
        raw = memoryview(buf)[start:pos]
        if kind == DICTIONARY_PAGE:
            dh = head[7]
            if dh.get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
                raise NotImplementedError(
                    f"parquet column {col.name!r}: a dictionary page in "
                    f"{ENCODINGS.get(dh.get(2), dh.get(2))} encoding")
            page = decompress(codec, raw, size)
            dictionary = _convert(col, plain(page, 0, col.ptype, dh[1]))
            continue
        if kind == DATA_PAGE:
            dh = head[5]
            n = dh[1]
            page = decompress(codec, raw, size)
            rl, p = _levels_v1(page, 0, dh.get(4, RLE), col.max_rep, n)
            dl, p = _levels_v1(page, p, dh.get(3, RLE), col.max_def, n)
            encoding = dh[2]
        elif kind == DATA_PAGE_V2:
            dh = head[8]
            n, rl_len, dl_len = dh[1], dh[6], dh[5]
            rl = (rle_hybrid(raw, 0, rl_len, col.max_rep.bit_length(), n)
                  if col.max_rep else np.zeros(n, dtype=np.int64))
            dl = (rle_hybrid(raw, rl_len, rl_len + dl_len,
                             col.max_def.bit_length(), n)
                  if col.max_def else np.zeros(n, dtype=np.int64))
            body = raw[rl_len + dl_len:]
            if dh.get(7, True):
                page = decompress(codec, body, size - rl_len - dl_len)
            else:
                page = bytes(body)
            p = 0
            encoding = dh[4]
        elif kind == INDEX_PAGE:
            continue
        else:
            raise ValueError(f"parquet: unknown page type {kind}")
        defined = int((dl == col.max_def).sum())
        vals = _values(col, page, p, encoding, defined, dictionary)
        if encoding == PLAIN:
            vals = _convert(col, vals)
        reps.append(rl)
        defs.append(dl)
        values.extend(vals)
        seen += n
    return (np.concatenate(reps) if reps else np.zeros(0, np.int64),
            np.concatenate(defs) if defs else np.zeros(0, np.int64), values)


def _convert(col: _Column, vals: list) -> list:
    if col.ptype == "BYTE_ARRAY" and col.text:
        return [v.decode("utf-8") for v in vals]
    if col.unsigned:
        mask = (1 << (32 if col.ptype == "INT32" else 64)) - 1
        return [v & mask for v in vals]
    return vals


def _assemble(col: _Column, reps, defs, values) -> list:
    """The column's rows from its levels and defined values."""
    out = []
    it = iter(values)
    if not col.is_list:
        if col.max_def == 0:
            return list(values)
        return [next(it) if d == col.max_def else None
                for d in defs.tolist()]
    for r, d in zip(reps.tolist(), defs.tolist()):
        if r == 0:
            if d < col.d_list:
                out.append(None)
                continue
            out.append([])
            if d < col.d_elem:
                continue
        elif out[-1] is None:
            raise ValueError(f"parquet column {col.name!r}: an element of a "
                             "null list")
        out[-1].append(next(it) if d == col.max_def else None)
    return out


# -- the file -----------------------------------------------------------------

def read_metadata(buf) -> dict:
    """The footer's FileMetaData as {field id: value}."""
    if len(buf) < 12 or buf[:4] != MAGIC or buf[-4:] != MAGIC:
        raise ValueError("not a Parquet file (no PAR1 magic)")
    n = int.from_bytes(buf[-8:-4], "little")
    if n + 12 > len(buf):
        raise ValueError("parquet: footer length past the start of the file")
    return _Thrift(buf, len(buf) - 8 - n).struct()


def read_columns(path: str) -> Dict[str, list]:
    """{column name: its values in row order} of every top-level column."""
    with open(path, "rb") as f:
        buf = f.read()
    try:
        return _read_columns(buf)
    except (KeyError, IndexError, TypeError, struct.error, zlib.error,
            UnicodeDecodeError) as e:
        raise ValueError(f"parquet: malformed file {path}: {e!r}") from e


def _read_columns(buf) -> Dict[str, list]:
    meta = read_metadata(buf)
    cols = _columns(meta[2])
    out = {c.name: [] for c in cols}
    for rg in meta.get(4, []):
        by_path = {}
        for chunk in rg[1]:
            if chunk.get(1):
                raise NotImplementedError("parquet column chunks in another "
                                          "file are not supported")
            cm = chunk[3]
            by_path[tuple(p.decode("utf-8") for p in cm[3])] = cm
        for c in cols:
            cm = by_path.get(tuple(c.path))
            if cm is None:
                raise ValueError(f"parquet: row group without column "
                                 f"{c.name!r}")
            rows = _assemble(c, *_read_chunk(c, buf, cm))
            if len(rows) != rg[3]:
                raise ValueError(f"parquet column {c.name!r}: {len(rows)} "
                                 f"rows in a row group of {rg[3]}")
            out[c.name].extend(rows)
    return out


def read_rows(path: str) -> Iterator[tuple]:
    """The rows as namedtuples of the columns (pandas' itertuples without
    the index), in row order."""
    cols = read_columns(path)
    Row = collections.namedtuple("Row", list(cols), rename=True)
    return (Row(*vals) for vals in zip(*cols.values()))
