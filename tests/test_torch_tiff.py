"""The port's TIFF reader (videollama2_tpu_torch/media/tiff.py and
csrc/tiff_lzw.cc) held bit for bit to PIL's `Image.open(f).convert("RGB")`,
which the JAX package reads with (PIL's own raw decoder for uncompressed
data, libtiff for the rest, then the Orientation tag):

  - tests/tiff_writer.py's files over every pixel format the reader takes
    (gray and min-is-white at 1, 2, 4, 8 and 16 bits, gray + alpha,
    palette at 1, 4 and 8 bits and with alpha, RGB at 8 and 16 bits with
    unspecified, associated and unassociated extra samples, CMYK at 8 and
    16 bits) x byte order x compression (none, LZW, Deflate, PackBits) x
    predictor 1 and 2 x strips and tiles x chunky and planar; where PIL
    refuses a cell, the port raises too, and the cells where PIL misreads
    planar data are refused by name;
  - every Orientation value, fill order 2, a multi-page file (its first
    page), LZW strips long enough to reset the code table;
  - the files PIL writes: every mode it saves as TIFF under every
    compression it writes with a predictor;
  - malformed files, which raise ValueError as PIL raises.
"""

import io
import itertools
import os
import sys
import warnings

import numpy as np
import pytest
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from videollama2_tpu_torch.media import image_io  # noqa: E402
from tiff_writer import encode_tiff  # noqa: E402


def _pil_rgb(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _pil_tiff(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _matches_pil(data: bytes) -> np.ndarray:
    want = _pil_rgb(data)
    got = image_io.read_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _same_as_pil(data: bytes) -> str:
    """Equal pixels where PIL reads the file; where it refuses, the port
    raises ValueError or NotImplementedError too. Returns which."""
    try:
        want = _pil_rgb(data)
    except Exception:  # noqa: BLE001 - PIL's own refusal, of any type
        with pytest.raises((ValueError, NotImplementedError)):
            image_io.read_image(data)
        return "refused"
    try:
        got = image_io.read_image(data)
    except NotImplementedError as e:
        return f"not implemented: {e}"
    np.testing.assert_array_equal(got, want)
    return "equal"


# name -> (photometric, bits, samples, extra samples)
KINDS = {
    "bilevel": (1, 1, 1, ()), "bilevel min-is-white": (0, 1, 1, ()),
    "gray 2-bit": (1, 2, 1, ()), "gray 4-bit": (1, 4, 1, ()),
    "gray 4-bit min-is-white": (0, 4, 1, ()), "gray 8-bit": (1, 8, 1, ()),
    "gray 8-bit min-is-white": (0, 8, 1, ()), "gray 16-bit": (1, 16, 1, ()),
    "gray 16-bit min-is-white": (0, 16, 1, ()),
    "gray + alpha": (1, 8, 2, (2,)), "palette 1-bit": (3, 1, 1, ()),
    "palette 4-bit": (3, 4, 1, ()), "palette 8-bit": (3, 8, 1, ()),
    "palette + alpha": (3, 8, 2, (2,)), "RGB": (2, 8, 3, ()),
    "RGBA without ExtraSamples": (2, 8, 4, ()),
    "RGB + unspecified": (2, 8, 4, (0,)),
    "RGB + associated alpha": (2, 8, 4, (1,)),
    "RGB + unassociated alpha": (2, 8, 4, (2,)),
    "RGB + associated alpha + 2 unspecified": (2, 8, 6, (1, 0, 0)),
    "RGB 16-bit": (2, 16, 3, ()),
    "RGB 16-bit + associated alpha": (2, 16, 4, (1,)),
    "RGB 16-bit + unassociated alpha": (2, 16, 4, (2,)),
    "CMYK": (5, 8, 4, ()), "CMYK 16-bit": (5, 16, 4, ()),
}
# where PIL's planar reading is wrong, the port refuses by name
PLANAR_REFUSED = ("uncompressed planar TIFF at 16 bits",
                  "uncompressed planar RGBA TIFF in tiles")


def _samples(rng, photo, bits, spp, extra, hw=(19, 37)):
    px = rng.integers(0, 1 << bits, hw + (spp,))
    if 1 in extra:   # associated alpha: color no larger than alpha
        px[..., 3] = rng.integers(0, 1 << bits, hw)
        px[..., :3] = (px[..., :3] * px[..., 3:4]) >> bits
    cmap = (rng.integers(0, 65536, (1 << bits, 3)) if photo == 3 else None)
    return px, cmap


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("byteorder", ["<", ">"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_writer_cells_match_pil(kind, byteorder, compression):
    """Each kind, byte order and compression, over predictor 1 and 2,
    strips of 7 rows and 16x16 tiles, chunky and planar."""
    photo, bits, spp, extra = KINDS[kind]
    rng = np.random.default_rng(abs(hash((kind, byteorder, compression))) %
                                2**32)
    outcomes = []
    for predictor, tiled, planar in itertools.product(
            (1, 2), (False, True), (False, True) if spp > 1 else (False,)):
        px, cmap = _samples(rng, photo, bits, spp, extra)
        data = encode_tiff(px, photometric=photo, bits=bits,
                           byteorder=byteorder, compression=compression,
                           predictor=predictor, extra=extra, planar=planar,
                           colormap=cmap,
                           rows_per_strip=None if tiled else 7,
                           tile=(16, 16) if tiled else None)
        got = _same_as_pil(data)
        if got.startswith("not implemented"):
            assert planar and compression == 1 and any(
                p in got for p in PLANAR_REFUSED), got
        outcomes.append(got)
    # every chunky cell reads in PIL and the port, but predictor 2 at
    # other than 8 and 16 bits, which libtiff refuses, and big-endian
    # 16-bit min-is-white, which PIL has no mode for
    chunky = outcomes[::2] if spp > 1 else outcomes
    for (predictor, _), got in zip(itertools.product((1, 2), (0, 1)),
                                   chunky):
        refused = (predictor == 2 and bits not in (8, 16)
                   and compression in (5, 8)) or (
            kind == "gray 16-bit min-is-white" and byteorder == ">")
        assert got == ("refused" if refused else "equal"), (predictor, got)


@pytest.mark.parametrize("compression", [1, 5])
@pytest.mark.parametrize("orientation", range(10))
def test_orientation_matches_pil(orientation, compression):
    """PIL turns the image by tag 274 on load (1-8; 0 and 9 leave it);
    5-8 swap the width and height."""
    px = np.random.default_rng(orientation).integers(0, 256, (5, 7, 3))
    got = _matches_pil(encode_tiff(px, photometric=2,
                                   compression=compression,
                                   orientation=orientation))
    assert got.shape[:2] == ((7, 5) if orientation in (5, 6, 7, 8)
                             else (5, 7))


FILL_ORDER_KINDS = ["bilevel", "gray 2-bit", "gray 4-bit",
                    "gray 4-bit min-is-white", "gray 8-bit",
                    "gray 8-bit min-is-white", "gray 16-bit", "RGB",
                    "palette 4-bit", "palette 8-bit"]


@pytest.mark.parametrize("byteorder", ["<", ">"])
@pytest.mark.parametrize("compression", [1, 5, 32773])
@pytest.mark.parametrize("kind", FILL_ORDER_KINDS)
def test_fill_order_2_matches_pil(kind, compression, byteorder):
    """Bits stored least significant first: libtiff reverses a strip's
    bytes before decompressing it, PIL's raw decoder reverses them in its
    ";R" raw modes (which some layouts lack: PIL refuses those)."""
    photo, bits, spp, extra = KINDS[kind]
    px, cmap = _samples(np.random.default_rng(bits), photo, bits, spp,
                        extra, (9, 13))
    assert _same_as_pil(encode_tiff(
        px, photometric=photo, bits=bits, compression=compression,
        fill_order=2, colormap=cmap, byteorder=byteorder)) in (
            "equal", "refused")


def _pil_modes():
    rng = np.random.default_rng(20)
    rgb = rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)
    return {
        "1": Image.fromarray(rgb[..., 0] > 127),
        "L": Image.fromarray(rgb[..., 0]),
        "LA": Image.fromarray(rgb[..., :2].copy(), "LA"),
        "P": Image.fromarray(rgb).quantize(50),
        "PA": Image.fromarray(rgb).quantize(50).convert("PA"),
        "I;16": Image.fromarray(rng.integers(0, 65536, (30, 41)).astype(
            np.uint16)),
        "I;16B": Image.fromarray(rng.integers(0, 600, (30, 41)).astype(
            np.uint16)).convert("I;16B"),
        "RGB": Image.fromarray(rgb),
        "RGBX": Image.fromarray(rgb).convert("RGBX"),
        "RGBA": Image.fromarray(rng.integers(0, 256, (30, 41, 4),
                                             dtype=np.uint8)),
        "CMYK": Image.fromarray(rng.integers(0, 256, (30, 41, 4),
                                             dtype=np.uint8), "CMYK"),
    }


PIL_MODES = _pil_modes()


# libtiff has no predictor for 1-bit samples
PIL_CELLS = [(m, c, p) for m in sorted(PIL_MODES)
             for c in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits",
                       "tiff_deflate")
             for p in (1, 2) if not (m == "1" and p == 2)]


@pytest.mark.parametrize("mode,compression,predictor", PIL_CELLS)
def test_pil_written_files_match_pil(mode, compression, predictor):
    kw = {"tiffinfo": {317: 2}} if predictor == 2 else {}
    _matches_pil(_pil_tiff(PIL_MODES[mode], compression=compression, **kw))


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw"])
def test_multi_page_reads_its_first_page(compression):
    rng = np.random.default_rng(21)
    pages = [Image.fromarray(rng.integers(0, 256, (20 + i, 30, 3),
                                          dtype=np.uint8)) for i in range(3)]
    data = _pil_tiff(pages[0], save_all=True, append_images=pages[1:],
                     compression=compression)
    got = _matches_pil(data)
    np.testing.assert_array_equal(got, np.asarray(pages[0]))


def test_writer_multi_page_of_mixed_formats():
    rng = np.random.default_rng(22)
    first = rng.integers(0, 16, (11, 9))
    data = encode_tiff(first, photometric=1, bits=4, compression=5, pages=[
        (rng.integers(0, 256, (8, 8, 3)), dict(photometric=2)),
        (rng.integers(0, 2, (5, 5)), dict(photometric=0, bits=1))])
    got = _matches_pil(data)
    np.testing.assert_array_equal(got[..., 0], first * 17)


@pytest.mark.parametrize("source", ["PIL", "writer"])
def test_lzw_code_table_resets(source):
    """Random samples fill LZW's 4094-entry table many times a strip."""
    px = np.random.default_rng(23).integers(0, 256, (128, 192, 3),
                                            dtype=np.uint8)
    if source == "PIL":
        data = _pil_tiff(Image.fromarray(px), compression="tiff_lzw",
                         tiffinfo={278: 128})
    else:
        data = encode_tiff(px, photometric=2, compression=5)
    np.testing.assert_array_equal(_matches_pil(data), px)


def _patched(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian file with one inline LONG entry's value changed."""
    entry = tag.to_bytes(2, "little") + b"\x04\x00\x01\x00\x00\x00"
    at = data.index(entry) + 8
    return data[:at] + value.to_bytes(4, "little") + data[at + 4:]


def _malformed():
    px = np.random.default_rng(24).integers(0, 256, (16, 16, 3))
    lzw = encode_tiff(px, photometric=2, compression=5)
    raw = encode_tiff(px, photometric=2, compression=1)
    packbits = encode_tiff(px, photometric=2, compression=32773)
    bad_lzw = bytearray(lzw)
    bad_lzw[9] = bad_lzw[10] = 0xFF   # the first code after the clear: 511
    return {
        "IFD past the end": raw[:4] + b"\xff\xff\x00\x00" + raw[8:],
        "strip past the end": _patched(raw, 273, len(raw) - 100),
        "LZW code past the table": bytes(bad_lzw),
        "LZW strip cut short": _patched(lzw, 279, 40),
        "PackBits strip cut short": _patched(packbits, 279, 30),
        "no strip offsets": raw.replace(b"\x11\x01\x04\x00",
                                        b"\x11\x02\x04\x00"),
    }


MALFORMED = _malformed()


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_files_raise_value_error(name):
    data = MALFORMED[name]
    with pytest.raises(Exception):
        _pil_rgb(data)
    with pytest.raises(ValueError):
        image_io.read_image(data)
