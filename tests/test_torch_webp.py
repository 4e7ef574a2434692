"""The port's WebP reader (videollama2_tpu_torch/media/webp.py and
csrc/webp_decode.cc) held bit for bit to PIL's
`Image.open(f).convert("RGB")`, which the JAX package reads with (libwebp's
WebPAnimDecoder, default options: fancy upsampling, no dithering):

  - lossy files PIL writes over qualities, `method` values, sizes from
    1x1 up, and alpha (VP8X + ALPH, alpha levels reduced or not);
  - lossless files over `method`, quality, `exact`, alpha and sizes, and
    palette images of 2 to 256 colors (color indexing at every bundling
    width); PIL's encoder uses all 14 predictor modes, cross-color,
    subtract-green, the color cache, backward references at short and
    plane distances and meta prefix codes across this matrix;
  - VP8 frames from tests/webp_writer.py, for what PIL's encoder never
    writes: the simple loop filter, sharpness, loop-filter deltas, up to
    eight token partitions, explicit segment maps, skip flags and
    coefficient-probability updates;
  - ALPH chunks raw and VP8L-coded under every filter, and bad ones, which
    fail as they fail in PIL;
  - the container: metadata chunks skipped, an animation's first frame
    (PIL's and a hand-built frame at an offset on a larger canvas), and
    malformed layouts the demuxer refuses.
"""

import io
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
import webp_writer as ww  # noqa: E402


def _pil_rgb(data: bytes) -> np.ndarray:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _webp(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "WEBP", **kw)
    return buf.getvalue()


def _photo(rng, h: int, w: int, channels: int = 3) -> np.ndarray:
    """Overlapping discs and mild noise: edges, flat areas and texture."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, channels), np.float64)
    for _ in range(10):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(1, max(h, w) / 2 + 2)
        m = (y - cy) ** 2 + (x - cx) ** 2 < r * r
        img[m] = 0.5 * img[m] + 0.5 * rng.uniform(0, 255, channels)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _matches_pil(data: bytes) -> np.ndarray:
    want = _pil_rgb(data)
    got = image_io.read_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


SIZES = [(1, 1), (2, 3), (17, 13), (64, 81), (120, 161)]
# PIL's lossless encoder at method 6, quality 100 takes seconds from
# about 100x100 on
LOSSLESS_SIZES = [(1, 1), (2, 3), (17, 13), (40, 57), (64, 81)]


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("quality", [5, 50, 90, 100])
def test_lossy_matches_pil(quality, method, alpha, hw):
    rng = np.random.default_rng(hash((quality, method, alpha, hw)) % 2**32)
    px = _photo(rng, *hw, 4 if alpha else 3)
    data = _webp(Image.fromarray(px), quality=quality, method=method)
    assert data[12:16] == (b"VP8X" if alpha else b"VP8 ")
    _matches_pil(data)


@pytest.mark.parametrize("alpha_quality", [0, 40, 100])
def test_lossy_alpha_levels_match_pil(alpha_quality):
    """alpha_quality below 100 quantizes the alpha levels (ALPH
    preprocessing 1), which a decoder without dithering leaves alone."""
    px = _photo(np.random.default_rng(alpha_quality), 90, 70, 4)
    _matches_pil(_webp(Image.fromarray(px), quality=75,
                       alpha_quality=alpha_quality))


@pytest.mark.parametrize("hw", LOSSLESS_SIZES)
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("method", [0, 3, 6])
@pytest.mark.parametrize("quality", [0, 60, 100])
def test_lossless_matches_pil(quality, method, exact, hw):
    """With alpha, so that `exact` keeps or drops the color of
    transparent pixels."""
    rng = np.random.default_rng(hash((quality, method, exact, hw)) % 2**32)
    px = _photo(rng, *hw, 4)
    px[..., 3] = np.where(rng.random(hw) < 0.3, 0, px[..., 3])
    data = _webp(Image.fromarray(px), lossless=True, quality=quality,
                 method=method, exact=exact)
    assert data[12:16] in (b"VP8L", b"VP8X")
    _matches_pil(data)


@pytest.mark.parametrize("noise", [2, 5])
@pytest.mark.parametrize("method", [3, 4, 6])
@pytest.mark.parametrize("hw", [(40, 57), (64, 81)])
def test_lossless_gradients_match_pil(hw, method, noise):
    """Gradients with little noise: where PIL's encoder picks the
    clamped-add-subtract predictors (modes 12 and 13)."""
    h, w = hw
    y, x = np.mgrid[0:h, 0:w]
    px = np.stack([x * 255 // (w - 1), y * 255 // (h - 1),
                   (x + y) * 255 // (h + w - 2), (x * y) % 256], -1)
    px = px + np.random.default_rng(1).integers(-noise, noise + 1, px.shape)
    _matches_pil(_webp(Image.fromarray(np.clip(px, 0, 255).astype(
        np.uint8)), lossless=True, method=method, exact=True))


@pytest.mark.parametrize("hw", [(7, 9), (33, 50)])
@pytest.mark.parametrize("colors", [2, 3, 4, 5, 16, 17, 200, 256])
def test_lossless_palettes_match_pil(colors, hw):
    """Color indexing with 8, 4, 2 and 1 pixels a byte (bundling) and
    without bundling."""
    rng = np.random.default_rng(colors)
    pal = rng.integers(0, 256, (colors, 3), dtype=np.uint8)
    idx = rng.integers(0, colors, hw)
    idx[0, :min(colors, hw[1])] = np.arange(min(colors, hw[1]))
    _matches_pil(_webp(Image.fromarray(pal[idx]), lossless=True))


WRITER_CASES = {
    "complex filter": dict(),
    "simple filter": dict(simple=True, level=30),
    "simple filter, sharpness 5": dict(simple=True, level=40, sharpness=5),
    "sharpness 3": dict(level=35, sharpness=3),
    "sharpness 7, level 63": dict(level=63, sharpness=7),
    "two partitions": dict(partitions_log2=1),
    "four partitions": dict(partitions_log2=2, level=50),
    "eight partitions": dict(partitions_log2=3, level=10),
    "loop-filter deltas": dict(ref_lf_delta=(5, 0, 0, 0),
                               mode_lf_delta=(-7, 0, 0, 0), level=25),
    "absolute segments": dict(segments=dict(
        absolute=True, quant=(5, 30, 60, 127), filter=(0, 20, 40, 63),
        map=(100, 150, 200))),
    "relative segments": dict(segments=dict(
        absolute=False, quant=(-5, 3, 10, 40), filter=(-20, 0, 10, 30),
        map=(128, 255, 60))),
    "segments without a map": dict(segments=dict(
        absolute=False, quant=(4, 3, 10, 40), filter=(-20, 0, 10, 30),
        map=None)),
    "skip flags": dict(skip_prob=100),
    "probability updates": dict(updates=0.2),
    "quantizer deltas": dict(q_deltas=(3, -4, 7, -2, 5), base_q=40),
    "no loop filter": dict(level=0),
    "large coefficients": dict(big=0.2, base_q=3),
    "all 16x16": dict(i4x4_share=0.0, level=20),
}


@pytest.mark.parametrize("hw", [(1, 1), (33, 47), (100, 70), (130, 17)])
@pytest.mark.parametrize("name", sorted(WRITER_CASES))
def test_vp8_writer_frames_match_pil(name, hw):
    h, w = hw
    payload = ww.encode_vp8(w, h, seed=len(name) + h,
                            **WRITER_CASES[name])
    _matches_pil(ww.riff(ww.chunk(b"VP8 ", payload)))


def _alpha_filtered(alpha: np.ndarray, method: int) -> np.ndarray:
    """libwebp's forward filters (filters.c), for a raw ALPH chunk."""
    a = alpha.astype(np.int64)
    out = a.copy()
    if method == 1:
        out[:, 1:] = a[:, 1:] - a[:, :-1]
        out[1:, 0] = a[1:, 0] - a[:-1, 0]
    elif method == 2:
        out[0, 1:] = a[0, 1:] - a[0, :-1]
        out[1:] = a[1:] - a[:-1]
    elif method == 3:
        out[0, 1:] = a[0, 1:] - a[0, :-1]
        for y in range(1, a.shape[0]):
            out[y, 0] = a[y, 0] - a[y - 1, 0]
            pred = np.clip(a[y, :-1] + a[y - 1, 1:] - a[y - 1, :-1], 0, 255)
            out[y, 1:] = a[y, 1:] - pred
    return (out % 256).astype(np.uint8)


def _alpha_file(alph: bytes, w=24, h=18, flags=0x10) -> bytes:
    vp8 = ww.encode_vp8(w, h, seed=7)
    return ww.riff(ww.vp8x(w, h, flags), ww.chunk(b"ALPH", alph),
                   ww.chunk(b"VP8 ", vp8))


def _lossless_alpha_stream(w: int, h: int) -> bytes:
    """A headerless VP8L stream: a lossless file's payload without its
    5-byte header (the same size, so the same bits follow)."""
    px = _photo(np.random.default_rng(3), h, w)
    data = _webp(Image.fromarray(px), lossless=True)
    assert data[12:16] == b"VP8L"
    size = int.from_bytes(data[16:20], "little")
    return data[20 + 5:20 + size]


@pytest.mark.parametrize("filt", [0, 1, 2, 3])
@pytest.mark.parametrize("method", [0, 1])
def test_alpha_chunks_decode(method, filt):
    """Raw (compression 0) and VP8L-coded (1) alpha under each filter
    decode, and are then dropped, as convert("RGB") drops them."""
    alpha = _photo(np.random.default_rng(filt), 18, 24, 1)[..., 0]
    body = (_alpha_filtered(alpha, filt).tobytes() if method == 0
            else _lossless_alpha_stream(24, 18))
    _matches_pil(_alpha_file(bytes([method | filt << 2]) + body))


BAD_ALPHA = {
    "reserved bits": bytes([0xC0]) + b"\0" * 432,
    "compression 2": bytes([0x02]) + b"\0" * 432,
    "preprocessing 2": bytes([0x20]) + b"\0" * 432,
    "raw alpha too short": bytes([0x00]) + b"\0" * 431,
    "header only": bytes([0x00]),
    "VP8L data cut short": bytes([0x01]) + _lossless_alpha_stream(24, 18)[:9],
}


@pytest.mark.parametrize("name", sorted(BAD_ALPHA))
def test_bad_alpha_chunks_fail_as_in_pil(name):
    data = _alpha_file(BAD_ALPHA[name])
    with pytest.raises(Exception):
        _pil_rgb(data)
    with pytest.raises(ValueError):
        image_io.read_image(data)


def test_alpha_without_the_vp8x_flag_is_ignored():
    """The demuxer drops an ALPH chunk where VP8X does not announce alpha,
    so even a bad one reads."""
    _matches_pil(_alpha_file(BAD_ALPHA["reserved bits"], flags=0))


@pytest.mark.parametrize("lossless", [False, True])
def test_metadata_chunks_are_skipped(lossless):
    px = _photo(np.random.default_rng(4), 40, 30)
    exif = Image.Exif()
    exif[0x0112] = 6   # an EXIF orientation PIL does not apply to WebP
    data = _webp(Image.fromarray(px), lossless=lossless, quality=80,
                 icc_profile=b"\0" * 133, exif=exif.tobytes(),
                 xmp=b"<x:xmpmeta/>")
    assert b"ICCP" in data and b"EXIF" in data and b"XMP " in data
    _matches_pil(data)


def test_unknown_chunks_are_skipped():
    vp8 = ww.encode_vp8(21, 11, seed=2)
    _matches_pil(ww.riff(ww.vp8x(21, 11, 0), ww.chunk(b"ZZZZ", b"abc"),
                         ww.chunk(b"VP8 ", vp8)))
    _matches_pil(ww.riff(ww.chunk(b"VP8 ", vp8), ww.chunk(b"ZZZZ", b"x")))


@pytest.mark.parametrize("lossless", [False, True])
def test_animation_reads_its_first_frame(lossless):
    rng = np.random.default_rng(6)
    frames = [Image.fromarray(_photo(rng, 48, 64)) for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=80, lossless=lossless, quality=70)
    data = buf.getvalue()
    assert b"ANMF" in data
    _matches_pil(data)


@pytest.mark.parametrize("kind", ["VP8L", "VP8+ALPH", "VP8"])
def test_hand_built_frame_at_an_offset(kind):
    """A first frame smaller than the canvas, at an offset: the canvas
    starts as transparent black, so zeros surround it; a second frame is
    checked, not drawn."""
    w, h = 30, 20
    if kind == "VP8L":
        src = _webp(Image.fromarray(_photo(np.random.default_rng(8), h, w)),
                    lossless=True)
        first = ww.image_chunks(src)
    else:
        first = [ww.chunk(b"VP8 ", ww.encode_vp8(w, h, seed=9))]
        if kind == "VP8+ALPH":
            first = [ww.chunk(b"ALPH", bytes([0x04]) + bytes(w * h))] + first
    second = [ww.chunk(b"VP8 ", ww.encode_vp8(8, 6, seed=10))]
    data = ww.riff(ww.vp8x(64, 48, 0x12),
                   ww.chunk(b"ANIM", bytes(6)),
                   ww.anmf(10, 14, w, h, *first),
                   ww.anmf(0, 0, 8, 6, *second))
    got = _matches_pil(data)
    assert got.shape == (48, 64, 3)
    assert not got[:14].any() and not got[:, :10].any()
    assert not got[34:].any() and not got[:, 40:].any()


def _malformed():
    vp8 = ww.chunk(b"VP8 ", ww.encode_vp8(16, 16, seed=11))
    alph = ww.chunk(b"ALPH", bytes([0]) + bytes(256))
    good = ww.riff(vp8)
    anim = [ww.chunk(b"ANIM", bytes(6)), ww.anmf(0, 0, 16, 16, vp8)]
    lossless = _webp(Image.new("RGB", (16, 16)), lossless=True)
    odd = lossless[20:20 + int.from_bytes(lossless[16:20], "little")]
    odd += b"\0" * (1 - len(odd) % 2)   # trailing data: an odd payload
    unpadded = b"VP8L" + len(odd).to_bytes(4, "little") + odd
    return {
        "odd chunk without its pad byte": b"RIFF" + (4 + len(
            unpadded)).to_bytes(4, "little") + b"WEBP" + unpadded,
        "truncated before the RIFF end": good[:-3],
        "canvas of another size": ww.riff(ww.vp8x(17, 16, 0), vp8),
        "ALPH after the image": ww.riff(ww.vp8x(16, 16, 0x10), vp8, alph),
        "VP8L after ALPH": ww.riff(ww.vp8x(16, 16, 0x10), alph, ww.chunk(
            b"VP8L", _webp(Image.new("RGB", (16, 16)), lossless=True)[20:])),
        "reserved VP8X flags": ww.riff(ww.vp8x(16, 16, 0x01), vp8),
        "a second VP8X": ww.riff(ww.vp8x(16, 16, 0), ww.vp8x(16, 16, 0),
                                 vp8),
        "ANMF before ANIM": ww.riff(ww.vp8x(16, 16, 0x02), anim[1]),
        "frame outside the canvas": ww.riff(ww.vp8x(20, 20, 0x02), anim[0],
                                            ww.anmf(8, 8, 16, 16, vp8)),
        "image outside ANMF in an animation": ww.riff(
            ww.vp8x(16, 16, 0x02), anim[0], vp8),
        "no image chunk": ww.riff(ww.vp8x(16, 16, 0),
                                  ww.chunk(b"ZZZZ", b"ab")),
        "chunk past the RIFF end": ww.riff(vp8, ww.chunk(b"ZZZZ", bytes(
            6))[:8 + 4]),
        "inter frame": ww.riff(ww.chunk(b"VP8 ", bytes([1]) + ww.encode_vp8(
            16, 16, seed=11)[1:])),
    }


MALFORMED = _malformed()


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_files_raise_value_error(name):
    data = MALFORMED[name]
    with pytest.raises(Exception):
        _pil_rgb(data)
    with pytest.raises(ValueError):
        image_io.read_image(data)
