"""The port's still-image reader (videollama2_tpu_torch/media/image_io.py)
on what goes beyond baseline JPEG and plain 8-bit PNG, held bit for bit to
PIL's `Image.open(f).convert("RGB")`, which the JAX package reads with:
progressive JPEG (PIL's own scan script over qualities, samplings,
optimized tables, sizes and restart intervals, and tests/jpeg_writer.py's
scripts PIL never writes), RGB-coded, CMYK and YCCK JPEG, chroma factors
beyond 4:4:4 / 4:2:2 / 4:2:0, PNG in every color type and bit depth, plain
and Adam7 (tests/png_writer.py), and GIF stills. Also: what is still
refused and the malformed progressions libjpeg rejects, a byte-flip sweep,
and the fixtures chip_smoke.py decodes on the GPU host against golden
digests (tests/fixtures/torch_images/). Run as a script, this file
rewrites those fixtures and their digests:

    python tests/test_torch_images.py
"""

import hashlib
import io
import json
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

from videollama2_tpu.core import config as jcfglib  # noqa: E402
from videollama2_tpu.media import preprocess as jprep  # noqa: E402
from videollama2_tpu_torch.core import config as tcfglib  # noqa: E402
from videollama2_tpu_torch.media import image_io  # noqa: E402
from videollama2_tpu_torch.media import preprocess as tprep  # noqa: E402
import jpeg_writer as jw  # noqa: E402
from gif_writer import encode_gif  # noqa: E402
from png_writer import encode_png  # noqa: E402
from tiff_writer import encode_tiff  # noqa: E402

FIXTURES = os.path.join(HERE, "fixtures", "torch_images")
GOLDEN = os.path.join(FIXTURES, "golden.json")


def _pil_rgb(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _pil_bytes(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _smooth(rng, h, w, c):
    """A gradient with noise: every coefficient band and filter is used."""
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 3 + y * 2)[..., None] + np.arange(c) * 40
    return ((base + rng.integers(0, 8, (h, w, c))) % 256).astype(np.uint8)


def _matches_pil(data: bytes) -> np.ndarray:
    want = _pil_rgb(data)
    got = image_io.read_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


# -- progressive JPEG as PIL writes it ----------------------------------------

JPEG_SAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "gray": None}


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("hw", [(1, 1), (17, 13), (481, 641)])
@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("sampling", sorted(JPEG_SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_progressive_jpeg_matches_pil(quality, sampling, optimize, hw,
                                      restart):
    """libjpeg's progressive script (a DC scan at Al 1, spectral bands,
    successive approximation of every band down to Al 0), with and without
    optimized Huffman tables and restart markers every `restart` blocks'
    worth of MCUs, decodes to PIL's pixels."""
    rng = np.random.default_rng(quality + hw[0] + 7 * optimize)
    px = _smooth(rng, hw[0], hw[1], 3)
    sub = JPEG_SAMPLING[sampling]
    kw = dict(quality=quality, progressive=True, optimize=optimize)
    if sub is not None:
        kw["subsampling"] = sub
    if restart:
        kw["restart_marker_blocks"] = restart
    data = _pil_bytes(Image.fromarray(px[..., 0] if sub is None else px),
                      "JPEG", **kw)
    assert b"\xff\xc2" in data and (not restart or b"\xff\xdd" in data)
    _matches_pil(data)


# -- progressive scripts PIL never writes (tests/jpeg_writer.py) -------------

NONINTERLEAVED_DC = (((0,), 0, 0, 0, 0), ((1,), 0, 0, 0, 0),
                     ((2,), 0, 0, 0, 0), ((0,), 1, 63, 0, 0),
                     ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0))
# mozjpeg's habit: luma AC split at 8, successive approximation of each band
MOZJPEG_SPLIT = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 8, 0, 2),
                 ((0,), 9, 63, 0, 2), ((1,), 1, 63, 0, 1),
                 ((2,), 1, 63, 0, 1), ((0,), 1, 8, 2, 1),
                 ((0,), 9, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0),
                 ((0,), 1, 8, 1, 0), ((0,), 9, 63, 1, 0),
                 ((1,), 1, 63, 1, 0), ((2,), 1, 63, 1, 0))


def _dqt(table: int, values) -> bytes:
    return jw.segment(0xDB, bytes([table]) + bytes(
        np.asarray(values, np.uint8).tolist()))


def _script_cases():
    rng = np.random.default_rng(11)
    px = _smooth(rng, 37, 45, 3)
    big = _smooth(rng, 120, 200, 3)
    flat = np.full(64, 40, np.uint8)

    def enc(script, sub="4:2:0", img=px, **kw):
        arr = np.asarray(img, np.float64)
        hs, vs = jw.SAMPLING[sub]
        return jw.encode_planes(jw.ycbcr(arr), [(hs, vs), (1, 1), (1, 1)],
                                80, script=script, **kw)
    cases = {
        "libjpeg script": enc(jw.PROGRESSIVE),
        "non-interleaved DC": enc(NONINTERLEAVED_DC),
        "non-interleaved DC 4:4:4": enc(NONINTERLEAVED_DC, "4:4:4"),
        "non-interleaved DC with refinement": enc(
            (((0,), 0, 0, 0, 2), ((2,), 0, 0, 0, 1), ((1,), 0, 0, 0, 1))
            + NONINTERLEAVED_DC[3:]
            + (((0,), 0, 0, 2, 1), ((0,), 0, 0, 1, 0), ((1,), 0, 0, 1, 0),
               ((2,), 0, 0, 1, 0))),
        "mozjpeg-like split": enc(MOZJPEG_SPLIT),
        "mozjpeg-like split, long EOB runs": enc(MOZJPEG_SPLIT, img=big),
        "4:4:0": enc(jw.PROGRESSIVE, "4:4:0"),
        "4:1:1": enc(jw.PROGRESSIVE, "4:1:1"),
        "gray": jw.encode_jpeg(px[..., 0], 70,
                               script=jw.PROGRESSIVE_GRAY),
        # a DQT after luma's first scan changes nothing: libjpeg dequantizes
        # with the table latched at a component's first scan
        "DQT after a component's first scan": enc(
            NONINTERLEAVED_DC, before_scan={1: _dqt(0, flat)}),
        # chroma's first scan comes after this DQT, so it uses it
        "DQT before a component's first scan": enc(
            NONINTERLEAVED_DC, before_scan={1: _dqt(1, flat)}),
        # out of order: libjpeg warns (JWRN_BOGUS_PROGRESSION) and decodes
        "AC before DC": enc(NONINTERLEAVED_DC[3:] + NONINTERLEAVED_DC[:3]),
        "refinement of bits never sent": enc(
            (((0, 1, 2), 0, 0, 1, 0),) + NONINTERLEAVED_DC[3:]),
        # coefficients 10-63 left at Al 1: block smoothing only looks at 0-9
        "band 10-63 left unrefined": enc(
            (((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 9, 0, 0),
             ((0,), 10, 63, 0, 1), ((1,), 1, 63, 0, 0),
             ((2,), 1, 63, 0, 0))),
        # a component with no scan has no latched table: no smoothing, and
        # its samples decode to zero coefficients (128)
        "a component never scanned": enc(
            (((0, 1), 0, 0, 0, 0), ((0,), 1, 63, 0, 1),
             ((1,), 1, 63, 0, 0))),
    }
    return cases


SCRIPT_CASES = _script_cases()


@pytest.mark.parametrize("name", sorted(SCRIPT_CASES))
def test_progressive_scripts_match_pil(name):
    _matches_pil(SCRIPT_CASES[name])


def test_quantization_tables_latch_at_the_first_scan():
    """The two DQT cases above differ as libjpeg's latching says: a table
    redefined after luma's first scan leaves the image as it was; one
    redefined before chroma's first scan changes it."""
    plain = image_io.read_image(SCRIPT_CASES["non-interleaved DC"])
    np.testing.assert_array_equal(
        image_io.read_image(SCRIPT_CASES["DQT after a component's first "
                                         "scan"]), plain)
    assert not np.array_equal(
        image_io.read_image(SCRIPT_CASES["DQT before a component's first "
                                         "scan"]), plain)


# -- JPEG color variants and chroma factors -----------------------------------

def _variant_cases():
    rng = np.random.default_rng(12)
    px = _smooth(rng, 37, 45, 3)
    img = Image.fromarray(px)
    f = px.astype(np.float64)
    cmyk = np.concatenate([255.0 - f, f[..., :1] / 2], axis=-1)
    ycck = jw.ycbcr(255.0 - cmyk[..., :3]) + [cmyk[..., 3]]
    planes = [cmyk[..., i] for i in range(4)]
    cases = {
        "CMYK (PIL, Adobe transform 0)": _pil_bytes(img.convert("CMYK"),
                                                    "JPEG", quality=85),
        "CMYK progressive (PIL)": _pil_bytes(img.convert("CMYK"), "JPEG",
                                             quality=85, progressive=True),
        "CMYK without an Adobe segment": jw.encode_planes(
            planes, [(1, 1)] * 4, 85, app=b""),
        "YCCK (Adobe transform 2)": jw.encode_planes(
            ycck, [(1, 1)] * 4, 85, app=jw.adobe(2)),
        "YCCK 4:2:0, progressive": jw.encode_planes(
            ycck, [(2, 2), (1, 1), (1, 1), (2, 2)], 85, app=jw.adobe(2),
            script=(((0, 1, 2, 3), 0, 0, 0, 0),) + tuple(
                ((c,), 1, 63, 0, 0) for c in range(4))),
        "RGB-coded (PIL, Adobe transform 0)": _pil_bytes(
            img, "JPEG", quality=85, keep_rgb=True),
        "RGB-coded (component ids R, G, B)": jw.encode_planes(
            [f[..., i] for i in range(3)], [(1, 1)] * 3, 85, app=b"",
            ids=[82, 71, 66]),
        "RGB-coded 4:2:0 (Adobe transform 0)": jw.encode_planes(
            [f[..., i] for i in range(3)], [(2, 2), (1, 1), (1, 1)], 85,
            app=jw.adobe(0)),
        "YCbCr by Adobe transform 1": jw.encode_planes(
            jw.ycbcr(f), [(2, 1), (1, 1), (1, 1)], 85, app=jw.adobe(1)),
        "YCbCr by component ids 1, 2, 3": jw.encode_planes(
            jw.ycbcr(f), [(2, 2), (1, 1), (1, 1)], 85, app=b""),
    }
    return cases


VARIANT_CASES = _variant_cases()


@pytest.mark.parametrize("name", sorted(VARIANT_CASES))
def test_jpeg_color_variants_match_pil(name):
    """libjpeg's color space from the JFIF / Adobe segments and component
    ids; RGB without conversion; CMYK and YCCK (jdcolor.c's
    ycck_cmyk_convert) through PIL's inverted "CMYK;I" raw mode and its
    cmyk2rgb."""
    _matches_pil(VARIANT_CASES[name])


# (h, v) factors a component: fancy h1v2 (4:4:0), int_upsample (4:1:1 and
# 3x1, 4x2), h2v1 under a 2x2 luma, and mixed methods in one image
FACTORS = {
    "4:4:0": [(1, 2), (1, 1), (1, 1)],
    "4:1:1": [(4, 1), (1, 1), (1, 1)],
    "luma 3x1": [(3, 1), (1, 1), (1, 1)],
    "luma 4x2": [(4, 2), (1, 1), (1, 1)],
    "luma 2x2, chroma 1x2": [(2, 2), (1, 2), (1, 2)],
    "luma 2x2, Cb 2x1, Cr 1x1": [(2, 2), (2, 1), (1, 1)],
}


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("hw", [(1, 1), (3, 3), (17, 13), (37, 45)])
@pytest.mark.parametrize("name", sorted(FACTORS))
def test_jpeg_chroma_factors_match_pil(name, hw, progressive):
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    planes = jw.ycbcr(_smooth(rng, hw[0], hw[1], 3).astype(np.float64))
    script = jw.PROGRESSIVE if progressive else None
    _matches_pil(jw.encode_planes(planes, FACTORS[name], 75,
                                  script=script))


# -- PNG ---------------------------------------------------------------------

PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
              4: (8, 16), 6: (8, 16)}
PNG_KINDS = [(ct, d) for ct, depths in PNG_DEPTHS.items() for d in depths]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_samples(rng, ctype, depth, hw):
    c = CHANNELS[ctype]
    top = 1 << depth
    px = rng.integers(0, top, hw + (c,)).astype(
        np.uint16 if depth == 16 else np.uint8)
    if ctype == 0 and depth == 16:
        # a third of the samples below 300: both sides of the clip at 255
        flat = px[..., 0].reshape(-1)
        flat[::3] = rng.integers(0, 300, flat[::3].shape)
    return px[..., 0] if c == 1 else px


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (9, 9), (37, 53)])
@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("kind", PNG_KINDS,
                         ids=[f"type {c} depth {d}" for c, d in PNG_KINDS])
def test_png_matches_pil(kind, interlace, hw):
    """Every color type at every bit depth, plain and Adam7 (empty passes
    of small images carry no bytes), with every filter type."""
    ctype, depth = kind
    rng = np.random.default_rng(ctype * 100 + depth + 7 * hw[0])
    px = _png_samples(rng, ctype, depth, hw)
    palette = (rng.integers(0, 256, (min(1 << depth, 200), 3))
               if ctype == 3 else None)
    _matches_pil(encode_png(px, depth=depth, palette=palette,
                            interlace=interlace))


def _png_extra_cases():
    rng = np.random.default_rng(13)
    g16 = rng.integers(0, 1200, (7, 9)).astype(np.uint16)
    return {
        "tRNS gray 8": encode_png(rng.integers(0, 256, (5, 6), np.uint8),
                                  chunks=[(b"tRNS", b"\x00\x07")]),
        "tRNS RGB 8": encode_png(
            rng.integers(0, 256, (5, 6, 3), np.uint8),
            chunks=[(b"tRNS", b"\x00\x07\x00\x08\x00\x09")]),
        "tRNS gray 16 Adam7": encode_png(
            g16, depth=16, interlace=True, chunks=[(b"tRNS", b"\x01\x00")]),
        "tRNS gray 2": encode_png(rng.integers(0, 4, (6, 7), np.uint8),
                                  depth=2, chunks=[(b"tRNS", b"\x00\x01")]),
        "tRNS palette Adam7": encode_png(
            rng.integers(0, 8, (9, 10), np.uint8), depth=4,
            palette=rng.integers(0, 256, (8, 3)), interlace=True,
            chunks=[(b"tRNS", bytes([0, 128, 255]))]),
        "PIL I;16": _pil_bytes(Image.fromarray(g16), "PNG"),
        "PIL 1-bit": _pil_bytes(Image.fromarray(
            rng.integers(0, 2, (11, 13)).astype(bool)), "PNG"),
    }


PNG_EXTRA = _png_extra_cases()


@pytest.mark.parametrize("name", sorted(PNG_EXTRA))
def test_png_transparency_and_pil_files_match_pil(name):
    """tRNS is ignored by convert("RGB"); PIL's own 16-bit gray and 1-bit
    files read alike."""
    _matches_pil(PNG_EXTRA[name])


def test_png_sample_scaling_is_pils():
    """The values PIL's raw modes give, pinned: 16-bit gray ("I;16")
    clips at 255 rather than scaling (1000 -> 255, 200 -> 200); 16-bit
    color keeps the high byte (0x1234 -> 18, 0xABCD -> 171); 1-bit gray
    reads 0 or 255, 2-bit is multiplied by 85 and 4-bit by 17."""
    gray = np.array([[1000, 200, 255, 256, 0, 65535]], np.uint16)
    got = _matches_pil(encode_png(gray, depth=16))[..., 0]
    assert got.tolist() == [[255, 200, 255, 255, 0, 255]]
    rgb = np.array([[[0x1234, 0xABCD, 0x00FF]]], np.uint16)
    assert _matches_pil(encode_png(rgb, depth=16)).tolist() == [[[18, 171,
                                                                  0]]]
    for depth, scale in ((1, 255), (2, 85), (4, 17)):
        v = np.arange(1 << depth, dtype=np.uint8)[None]
        got = _matches_pil(encode_png(v, depth=depth))[..., 0]
        assert got.tolist() == [(np.arange(1 << depth) * scale).tolist()]


# -- GIF stills ----------------------------------------------------------------

def _gif_cases():
    rng = np.random.default_rng(14)
    pal = rng.integers(0, 256, (16, 3)).astype(np.uint8)

    def idx(h, w, n=16):
        return rng.integers(0, n, (h, w)).astype(np.uint8)
    frames = [Image.fromarray(_smooth(rng, 12, 15, 3)).quantize(32)
              for _ in range(3)]
    return {
        "one frame": encode_gif([{"indices": idx(9, 11)}], (11, 9),
                                global_palette=pal),
        "many frames": encode_gif(
            [{"indices": idx(8, 8)}, {"indices": idx(8, 8)},
             {"indices": idx(4, 4), "x": 2, "y": 2}], (8, 8),
            global_palette=pal),
        "first frame transparent index": encode_gif(
            [{"indices": idx(5, 6), "x": 2, "y": 1, "transparency": 3},
             {"indices": idx(9, 10)}], (10, 9), global_palette=pal),
        "first frame smaller than the screen": encode_gif(
            [{"indices": idx(4, 5), "x": 3, "y": 2}], (10, 8),
            global_palette=pal),
        "local palette only": encode_gif(
            [{"indices": idx(6, 7), "palette": pal[::-1]}], (7, 6)),
        "local over global palette": encode_gif(
            [{"indices": idx(6, 7), "palette": pal[::-1]},
             {"indices": idx(6, 7)}], (7, 6), global_palette=pal),
        "gray ramp palette": encode_gif(
            [{"indices": idx(6, 6, 4)}], (6, 6), global_palette=np.repeat(
                np.arange(4, dtype=np.uint8)[:, None], 3, 1)),
        "no palette": encode_gif([{"indices": idx(5, 5)}], (5, 5)),
        "interlaced": encode_gif([{"indices": idx(13, 7),
                                   "interlace": True}], (7, 13),
                                 global_palette=pal),
        "PIL one frame": _pil_bytes(frames[0], "GIF"),
        "PIL many frames, transparency": _pil_bytes(
            frames[0], "GIF", save_all=True, append_images=frames[1:],
            transparency=2, disposal=2),
    }


GIF_CASES = _gif_cases()


@pytest.mark.parametrize("name", sorted(GIF_CASES))
def test_gif_still_matches_pil(name):
    """A GIF given as an image reads as its first frame: the screen filled
    with the transparent index (else 0), the frame pasted in, its palette
    (or gray) looked up."""
    _matches_pil(GIF_CASES[name])


# -- refusals, malformed files, byte flips ------------------------------------

def _sos_patched(data: bytes, scan: int, ss=None, se=None, ah=None,
                 al=None) -> bytes:
    """`data` with scan number `scan`'s Ss, Se, Ah or Al replaced."""
    i = -1
    for _ in range(scan + 1):
        i = data.index(b"\xff\xda", i + 1)
    ns = data[i + 4]
    p = i + 5 + 2 * ns
    out = bytearray(data)
    out[p] = out[p] if ss is None else ss
    out[p + 1] = out[p + 1] if se is None else se
    a = out[p + 2]
    out[p + 2] = ((a >> 4 if ah is None else ah) << 4) | (
        a & 15 if al is None else al)
    return bytes(out)


def _malformed_progressions():
    rng = np.random.default_rng(15)
    base = _pil_bytes(Image.fromarray(_smooth(rng, 16, 24, 3)), "JPEG",
                      progressive=True)
    # PIL's script: scan 0 is the interleaved DC scan (Al 1), scan 1 luma
    # AC 1-5 (Al 2), scan 5 luma AC 1-63 refinement (Ah 2, Al 1)
    return {
        "Ss above Se": _sos_patched(base, 1, ss=5, se=2),
        "Se above 63": _sos_patched(base, 1, se=64),
        "a DC scan with Se 3": _sos_patched(base, 0, se=3),
        "an AC scan of three components": _sos_patched(base, 0, ss=1, se=5),
        "a refinement with Ah 2, Al 0": _sos_patched(base, 5, al=0),
        "Al 14": _sos_patched(base, 0, al=14),
    }


MALFORMED = _malformed_progressions()


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_progressions_raise_value_error(name):
    """The checks jdphuff.c's start_pass_phuff_decoder makes fatal
    (JERR_BAD_PROGRESSION) raise ValueError in the port; PIL refuses the
    same files."""
    data = MALFORMED[name]
    with pytest.raises(ValueError, match="invalid progressive parameters"):
        image_io.read_image(data)
    with pytest.raises(OSError):
        _pil_rgb(data)


def _still_refused():
    rng = np.random.default_rng(16)
    px = _smooth(rng, 16, 24, 3)
    cut = jw.encode_jpeg(px, 80, script=jw.PROGRESSIVE[:6])
    gif = encode_gif([{"indices": np.zeros((4, 4), np.uint8), "x": 6}],
                     (8, 8), global_palette=np.zeros((2, 3), np.uint8))
    rgb = Image.fromarray(px)
    tiff = encode_tiff(px, photometric=2)
    at = tiff.index(b"\x03\x01\x03\x00\x01\x00\x00\x00") + 8
    old_lzw = bytearray(tiff[:at] + b"\x05\x00" + tiff[at + 2:])
    old_lzw[8:10] = b"\x00\x01"   # the first bytes of old-style LZW data
    refused = {
        "progressive JPEG with incomplete refinement": cut,
        "GIF frames past the logical screen": gif,
        "TIFF with JPEG": _pil_bytes(rgb, "TIFF", compression="jpeg"),
        "TIFF with CCITT Group 3": _pil_bytes(rgb.convert("1"), "TIFF",
                                              compression="group3"),
        "TIFF with CCITT Group 4": _pil_bytes(rgb.convert("1"), "TIFF",
                                              compression="group4"),
        "TIFF in YCbCr": _pil_bytes(rgb.convert("YCbCr"), "TIFF"),
        "TIFF in CIELab": _pil_bytes(rgb.convert("LAB"), "TIFF"),
        "TIFF with floating-point samples": _pil_bytes(rgb.convert("F"),
                                                       "TIFF"),
        "TIFF with signed integer samples": _pil_bytes(rgb.convert("I"),
                                                       "TIFF"),
        "TIFF with 12-bit samples": encode_tiff(
            px[..., 0] * 16, photometric=1, bits=12),
        "TIFF with 32-bit samples": encode_tiff(
            px[..., 0], photometric=1, bits=32),
        "TIFF with the floating-point predictor": encode_tiff(
            px, photometric=2, compression=5, predictor=3),
        "TIFF with old-style": bytes(old_lzw),
        "uncompressed planar TIFF at 16 bits": encode_tiff(
            px.astype(np.uint16) * 257, photometric=2, bits=16, planar=True),
        "BigTIFF": _pil_bytes(rgb, "TIFF", big_tiff=True),
    }
    for name, tag in (("TIFF with LZMA", 34925), ("TIFF with ZSTD", 50000),
                      ("TIFF with WebP", 50001),
                      ("TIFF with old-style JPEG", 6),
                      ("TIFF with CCITT modified Huffman", 2)):
        refused[name] = tiff[:at] + tag.to_bytes(2, "little") + tiff[at + 2:]
    return refused


STILL_REFUSED = _still_refused()


@pytest.mark.parametrize("name", sorted(STILL_REFUSED))
def test_still_refused_variants_raise_naming_them(name):
    """A progressive file whose coefficients 1-9 stop short of Al 0
    (libjpeg-turbo would smooth its blocks), a GIF whose first frame
    reaches past its screen (PIL grows the canvas) and the TIFF variants
    outside baseline (other compressions, color spaces, sample formats and
    depths, the floating-point predictor, old-style LZW, 16-bit planar
    data PIL misreads, BigTIFF) are refused by name."""
    with pytest.raises(NotImplementedError, match=name):
        image_io.read_image(STILL_REFUSED[name])


def _sweep_files():
    rng = np.random.default_rng(17)
    px = _smooth(rng, 40, 56, 3)
    g16 = rng.integers(0, 65536, (23, 29)).astype(np.uint16)
    return {
        "progressive JPEG (PIL)": _pil_bytes(
            Image.fromarray(px), "JPEG", progressive=True,
            restart_marker_blocks=3),
        "progressive JPEG (mozjpeg-like split)": jw.encode_planes(
            jw.ycbcr(px.astype(np.float64)), [(2, 2), (1, 1), (1, 1)], 80,
            script=MOZJPEG_SPLIT),
        "Adam7 RGB PNG": encode_png(px, interlace=True),
        "16-bit RGBA PNG": encode_png(
            rng.integers(0, 65536, (21, 17, 4)).astype(np.uint16),
            depth=16),
        "16-bit gray Adam7 PNG": encode_png(g16, depth=16, interlace=True),
        "lossless WebP": _pil_bytes(Image.fromarray(px), "WEBP",
                                    lossless=True),
        "lossy WebP with alpha": _pil_bytes(Image.fromarray(np.dstack(
            [px, px[..., 1]])), "WEBP", quality=70),
        "LZW TIFF": _pil_bytes(Image.fromarray(px), "TIFF",
                               compression="tiff_lzw",
                               tiffinfo={317: 2, 274: 6, 278: 16}),
    }


SWEEP_FILES = _sweep_files()


@pytest.mark.parametrize("name", sorted(SWEEP_FILES))
def test_byte_flips_never_crash(name):
    """200 seeded single-byte corruptions of each file: every call returns
    an RGB array of the shape its (possibly corrupted) header gives, or
    raises ValueError or NotImplementedError; none takes the process
    down."""
    data = SWEEP_FILES[name]
    rng = np.random.default_rng(len(data))
    positions = rng.choice(len(data), size=min(200, len(data)),
                           replace=False)
    outcomes = {"decoded": 0, "ValueError": 0, "NotImplementedError": 0}
    for pos in positions:
        bad = bytearray(data)
        bad[pos] ^= int(rng.integers(1, 256))
        try:
            got = image_io.read_image(bytes(bad))
        except (ValueError, NotImplementedError) as e:
            outcomes[type(e).__name__] += 1
            continue
        outcomes["decoded"] += 1
        assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
        try:
            w, h = Image.open(io.BytesIO(bytes(bad))).size
        except Exception:  # noqa: BLE001 - PIL refuses the header
            continue
        assert got.shape[:2] == (h, w)
    assert outcomes["decoded"] + outcomes["ValueError"] + outcomes[
        "NotImplementedError"] == len(positions)


# -- fixtures and golden digests for the GPU host ------------------------------

def _digest(rgb: np.ndarray) -> dict:
    return {"shape": list(rgb.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(
                rgb).tobytes()).hexdigest()}


def fixture_files() -> dict:
    """name -> bytes of the fixtures (PIL's where PIL writes the format,
    tests/png_writer.py's Adam7 file), WebP and TIFF among them."""
    rng = np.random.default_rng(18)
    y, x = np.mgrid[0:480, 0:640]
    photo = np.stack([(x * 255 // 639), (y * 255 // 479),
                      ((x + y) * 255 // 1118)], -1).astype(np.uint8)
    photo = np.clip(photo.astype(int) + rng.integers(-3, 4, photo.shape),
                    0, 255).astype(np.uint8)
    small = photo[::6, ::6][:64, :80]
    gray16 = ((y[:60, :80] * 17 + x[:60, :80] * 5) % 1400).astype(np.uint16)
    gif_frames = [Image.fromarray(np.roll(small, 8 * k, axis=1)).quantize(
        64) for k in range(3)]
    return {
        "progressive_480x640.jpg": _pil_bytes(
            Image.fromarray(photo), "JPEG", quality=85, progressive=True),
        "cmyk.jpg": _pil_bytes(Image.fromarray(small).convert("CMYK"),
                               "JPEG", quality=90),
        "rgb_coded.jpg": _pil_bytes(Image.fromarray(small), "JPEG",
                                    quality=90, keep_rgb=True),
        "adam7_rgb.png": encode_png(photo[::4, ::4], interlace=True),
        "gray16.png": _pil_bytes(Image.fromarray(gray16), "PNG"),
        "frames.gif": _pil_bytes(gif_frames[0], "GIF", save_all=True,
                                 append_images=gif_frames[1:],
                                 transparency=5),
        **_webp_tiff_fixtures(photo),
    }


def _discs(rng, h: int, w: int, n: int) -> np.ndarray:
    """A gradient under n half-transparent discs."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // (w - 1), y * 255 // (h - 1),
                    (x + y) * 255 // (h + w - 2)], -1)
    for _ in range(n):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(h / 24, h / 3)
        m = (y - cy) ** 2 + (x - cx) ** 2 < r * r
        img[m] = (img[m] + rng.integers(0, 256, 3)) // 2
    return img


def _webp_tiff_fixtures(photo: np.ndarray) -> dict:
    """WebP and TIFF fixtures: a lossy 1920x1080 WebP, a lossless 480x640
    one (fine noise over its lower half), a lossy one with alpha, an
    animation and an LZW TIFF with predictor 2 and Orientation 6."""
    rng = np.random.default_rng(25)
    big = np.clip(_discs(rng, 1080, 1920, 12)
                  + rng.integers(-2, 3, (1080, 1920, 3)), 0, 255)
    still = _discs(rng, 480, 640, 8)
    still[240:] += rng.integers(-1, 2, (240, 640, 3))
    still = np.clip(still, 0, 255).astype(np.uint8)
    rgba = np.dstack([photo[::4, ::4], _discs(rng, 120, 160, 4)[..., 0]])
    frames = [Image.fromarray(_discs(rng, 96, 128, 5).astype(np.uint8))
              for _ in range(3)]
    return {
        "lossy_1920x1080.webp": _pil_bytes(Image.fromarray(big.astype(
            np.uint8)), "WEBP", quality=80),
        "lossless_480x640.webp": _pil_bytes(Image.fromarray(still), "WEBP",
                                            lossless=True),
        "alpha_lossy.webp": _pil_bytes(Image.fromarray(rgba.astype(
            np.uint8)), "WEBP", quality=75),
        "animated.webp": _pil_bytes(frames[0], "WEBP", save_all=True,
                                    append_images=frames[1:], duration=90,
                                    quality=70),
        "lzw_predictor_orientation.tiff": _pil_bytes(
            Image.fromarray(photo[::4, ::4]), "TIFF", compression="tiff_lzw",
            tiffinfo={317: 2, 274: 6}),
    }


def write_fixtures() -> None:
    os.makedirs(FIXTURES, exist_ok=True)
    golden = {}
    for name, data in sorted(fixture_files().items()):
        with open(os.path.join(FIXTURES, name), "wb") as f:
            f.write(data)
        golden[name] = _digest(_pil_rgb(data))
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=1, sort_keys=True)
        f.write("\n")


def test_fixtures_match_their_golden_digests():
    """Each fixture's PIL pixels still have the digest chip_smoke.py holds
    the GPU host's decode to, and the port gives the same pixels here;
    together they are well under 1 MB."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    names = sorted(n for n in os.listdir(FIXTURES) if n != "golden.json")
    assert names == sorted(golden)
    total = 0
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        total += len(data)
        assert _digest(_pil_rgb(data)) == golden[name], name
        assert _digest(image_io.read_image(data)) == golden[name], name
    assert total < 1 << 20


# -- against the JAX package ------------------------------------------------

FIXTURE_NAMES = sorted(n for n in os.listdir(FIXTURES) if n != "golden.json")


@pytest.mark.parametrize("aspect", [None, "pad"])
@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_process_image_matches_jax(name, aspect):
    """The port's process_image on each fixture's path and bytes gives the
    JAX package's tensors (PIL's decode, then the same resize), uint8 and
    float32."""
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    jcfg, tcfg = jcfglib.tiny_vision(), tcfglib.tiny_vision()
    for out_dtype in ("uint8", "float32"):
        want = jprep.process_image(path, jcfg, aspect_ratio=aspect,
                                   out_dtype=out_dtype)
        for src in (path, data):
            got = tprep.process_image(src, tcfg, aspect_ratio=aspect,
                                      out_dtype=out_dtype)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_frame_directory_matches_jax(tmp_path):
    """A frame directory of progressive JPEG (jpeg_writer's script and
    PIL's), Adam7 and 16-bit PNG, low-bit gray PNG, CMYK JPEG, a GIF
    still, lossy and lossless WebP and an LZW TIFF turned by its
    Orientation tag through both packages' process_video, as a directory
    and as a list of paths, with the reference's zero-frame padding at
    12."""
    rng = np.random.default_rng(19)
    writers = [
        lambda px: jw.encode_jpeg(px, 85, "4:2:0", script=jw.PROGRESSIVE),
        lambda px: _pil_bytes(Image.fromarray(px), "JPEG",
                              progressive=True),
        lambda px: encode_png(px, interlace=True),
        lambda px: encode_png(px.astype(np.uint16) * 257, depth=16),
        lambda px: encode_png(px[..., 0] >> 6, depth=2, interlace=True),
        lambda px: _pil_bytes(Image.fromarray(px).convert("CMYK"), "JPEG"),
        lambda px: _pil_bytes(Image.fromarray(px).quantize(64), "GIF"),
        lambda px: _pil_bytes(Image.fromarray(px), "WEBP", quality=80),
        lambda px: _pil_bytes(Image.fromarray(px), "WEBP", lossless=True),
        lambda px: encode_tiff(px, photometric=2, compression=5,
                               predictor=2, orientation=3),
    ]
    for i in range(10):
        data = writers[i % len(writers)](_smooth(rng, 60, 80, 3))
        (tmp_path / f"{i:02d}.img").write_bytes(data)
    jcfg, tcfg = jcfglib.tiny_vision(), tcfglib.tiny_vision()
    files = sorted(str(p) for p in tmp_path.iterdir())
    for num_frames in (8, 12):
        for aspect in (None, "pad"):
            want = jprep.process_video(str(tmp_path), jcfg,
                                       aspect_ratio=aspect,
                                       num_frames=num_frames,
                                       out_dtype="uint8")
            got = tprep.process_video(str(tmp_path), tcfg,
                                      aspect_ratio=aspect,
                                      num_frames=num_frames,
                                      out_dtype="uint8")
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tprep.process_video(files, tcfg, num_frames=num_frames,
                                out_dtype="uint8"),
            jprep.process_video(files, jcfg, num_frames=num_frames,
                                out_dtype="uint8"))


if __name__ == "__main__":
    write_fixtures()
    print(f"wrote {GOLDEN}")
