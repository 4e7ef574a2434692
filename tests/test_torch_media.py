"""The port's media layer against the JAX package's (which reads with PIL,
imageio and its own build of the C++ decoder): frame sampling, the
still-image readers (bit-equal to PIL's `Image.open(f).convert("RGB")`),
the container decoder (the port's g++ build of the byte-identical
video_decoder.cc gives JAX's frames, I420 buffers and audio bit for bit on
AVIs from tests/avi_writer.py), the processors (bit-equal to JAX's PIL
pixels, uint8 and float32, on downscaled and upscaled sources), the
processor entries and wire of the public API,
the AV audio track's silence fallback and the named errors of a host
without the decoder."""

import io
import os
import sys
import warnings

import numpy as np
import pytest
from PIL import Image

from videollama2_tpu.core import config as jcfglib
from videollama2_tpu.media import preprocess as jprep
from videollama2_tpu.media import sampler as jsampler
from videollama2_tpu.media import video_reader as jvr
from videollama2_tpu.media import wire as jwire
from videollama2_tpu_torch.core import config as tcfglib
from videollama2_tpu_torch.inference import api as tapi
from videollama2_tpu_torch.media import _native
from videollama2_tpu_torch.media import audio as taudio
from videollama2_tpu_torch.media import image_io
from videollama2_tpu_torch.media import preprocess as tprep
from videollama2_tpu_torch.media import sampler as tsampler
from videollama2_tpu_torch.media import video_reader as tvr
from videollama2_tpu_torch.media import wire as twire

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from avi_writer import write_avi  # noqa: E402
from png_writer import encode_bmp, encode_png  # noqa: E402

# source frames (height, width) that the CLIP (336) and SigLIP (384)
# processors downscale: 4:3, 16:9 (two sizes) and portrait; and that they
# upscale (thumbnails): 4:3, a wide strip, portrait
DOWNSCALE_SOURCES = [(480, 640), (360, 640), (720, 1280), (640, 480)]
UPSCALE_SOURCES = [(240, 320), (90, 400), (150, 100)]


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _pil_bytes(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _smooth(rng, h, w, c):
    """A gradient with noise: the adaptive encoder picks every filter."""
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 3 + y * 2)[..., None] + np.arange(c) * 40
    return ((base + rng.integers(0, 8, (h, w, c))) % 256).astype(np.uint8)


# -- frame sampling ----------------------------------------------------------

def _outcome(fn, *args):
    """fn's result, or the type of what it raised (an empty range, e.g.
    fps sampling of zero frames, raises in both packages)."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - compared, not handled
        return type(e)


@pytest.mark.parametrize("num_frames", [None, 1, 8, 16, 32])
def test_sample_indices_match_jax(num_frames):
    rng = np.random.default_rng(num_frames or 0)
    for _ in range(60):
        total = int(rng.integers(1, 3000))
        fps = float(rng.choice([3.0, 24.0, 25.0, 29.97, 30.0, 60.0]))
        s = e = None
        if rng.random() < 0.6:
            s, e = (float(v) for v in rng.uniform(-2, total / fps + 2, 2))
        got = _outcome(tsampler.sample_indices, total, fps, num_frames, s, e)
        want = _outcome(jsampler.sample_indices, total, fps, num_frames, s,
                        e)
        if isinstance(want, type):
            assert got is want
        else:
            np.testing.assert_array_equal(got, want)
        assert tsampler.clip_frame_range(total, fps, s, e) == \
            jsampler.clip_frame_range(total, fps, s, e)


# -- still images -------------------------------------------------------------

def _still_cases():
    rng = np.random.default_rng(0)
    cases = {}
    for mode, c in (("RGB", 3), ("RGBA", 4), ("LA", 2)):
        cases[f"png {mode}"] = _pil_bytes(
            Image.fromarray(_smooth(rng, 37, 53, c), mode), "PNG")
    cases["png L"] = _pil_bytes(
        Image.fromarray(_smooth(rng, 29, 31, 1)[..., 0], "L"), "PNG")
    cases["png RGB noise"] = _pil_bytes(Image.fromarray(
        rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)), "PNG")
    for n in (2, 4, 16, 200):   # PIL writes 1-, 2-, 4- and 8-bit palettes
        img = Image.fromarray(rng.integers(0, n, (13, 17), dtype=np.uint8),
                              "P")
        img.putpalette([int(v) for v in rng.integers(0, 256, 3 * n)])
        cases[f"png P {n} colors"] = _pil_bytes(img, "PNG")
    img = Image.fromarray(rng.integers(0, 8, (9, 11), dtype=np.uint8), "P")
    img.putpalette([int(v) for v in rng.integers(0, 256, 24)])
    cases["png P transparency"] = _pil_bytes(img, "PNG", transparency=2)
    cases["png every filter RGB"] = encode_png(_smooth(rng, 23, 19, 3))
    cases["png every filter gray"] = encode_png(_smooth(rng, 23, 19, 1)[..., 0])
    cases["ppm"] = _pil_bytes(Image.fromarray(_smooth(rng, 7, 9, 3)), "PPM")
    cases["pgm"] = _pil_bytes(
        Image.fromarray(_smooth(rng, 7, 9, 1)[..., 0]), "PPM")
    cases["bmp 24"] = _pil_bytes(Image.fromarray(_smooth(rng, 7, 9, 3)),
                                 "BMP")
    cases["bmp 24 unpadded writer"] = encode_bmp(_smooth(rng, 5, 6, 3))
    cases["bmp 32"] = _pil_bytes(
        Image.fromarray(_smooth(rng, 7, 10, 4), "RGBA"), "BMP")
    # a top-down BMP: negative height, rows in reading order
    bmp = bytearray(cases["bmp 24"])
    h = int.from_bytes(bmp[22:26], "little", signed=True)
    stride = (9 * 3 + 3) // 4 * 4
    body = bytes(bmp[54:54 + h * stride])
    bmp[22:26] = (-h).to_bytes(4, "little", signed=True)
    bmp[54:54 + h * stride] = b"".join(
        body[r * stride:(r + 1) * stride] for r in reversed(range(h)))
    cases["bmp 24 top-down"] = bytes(bmp)
    return cases


STILL_CASES = _still_cases()


@pytest.mark.parametrize("name", sorted(STILL_CASES))
def test_still_reader_matches_pil(name, tmp_path):
    data = STILL_CASES[name]
    want = _pil_rgb(data)
    got = image_io.read_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    path = tmp_path / "img"
    path.write_bytes(data)
    np.testing.assert_array_equal(image_io.read_image(str(path)), want)


def test_png_writer_uses_every_filter():
    """The hand-written PNGs above carry all five filter types (PIL's
    encoder never writes Average), and PIL reads them as written."""
    import zlib
    px = _smooth(np.random.default_rng(3), 10, 7, 3)
    data = encode_png(px)
    np.testing.assert_array_equal(_pil_rgb(data), px)
    raw = zlib.decompress(data[41:-16])   # IDAT's body
    assert sorted({raw[y * (7 * 3 + 1)] for y in range(10)}) == [0, 1, 2, 3,
                                                                 4]


def _unsupported_cases():
    rng = np.random.default_rng(1)
    rgb = Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    return {
        "JPEG": _pil_bytes(rgb, "JPEG"),
        "GIF": _pil_bytes(rgb, "GIF"),
        "TIFF": _pil_bytes(rgb, "TIFF"),
        "bit depth 16": _pil_bytes(Image.fromarray(
            rng.integers(0, 65535, (4, 4)).astype(np.uint16)), "PNG"),
        "bits with compression": _pil_bytes(rgb.convert("P"), "BMP"),
    }


@pytest.mark.parametrize("name,data", sorted(_unsupported_cases().items()))
def test_unsupported_images_raise_naming_the_format(name, data):
    with pytest.raises(NotImplementedError, match=name.split()[0]):
        image_io.read_image(data)


def test_corrupt_png_is_refused():
    data = bytearray(STILL_CASES["png RGB"])
    data[40] ^= 0xFF   # inside IHDR's body or IDAT: the CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        image_io.read_image(bytes(data))


def test_frame_directory_decodes_in_time(tmp_path):
    """A 16-frame 480x640 PNG directory (every filter type) is read by the
    port's reader in well under 2 s on this host."""
    import time
    rng = np.random.default_rng(4)
    for i in range(16):
        (tmp_path / f"{i:03d}.png").write_bytes(
            encode_png(_smooth(rng, 480, 640, 3)))
    t0 = time.perf_counter()
    frames = tvr.read_video_frames(str(tmp_path), num_frames=16)
    assert time.perf_counter() - t0 < 2.0
    assert len(frames) == 16 and frames[0].shape == (480, 640, 3)


# -- the container decoder ---------------------------------------------------

@pytest.fixture(scope="module")
def avi(tmp_path_factory):
    """(path with audio, path without, frames, waveform)."""
    d = tmp_path_factory.mktemp("avi")
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (12, 48, 64, 3), dtype=np.uint8)
    audio = rng.uniform(-0.5, 0.5, 16000 * 2)
    with_audio, without = str(d / "a.avi"), str(d / "v.avi")
    write_avi(with_audio, frames, audio, fps=5)
    write_avi(without, frames, None, fps=5)
    return with_audio, without, frames, audio


def test_decoder_matches_jax(avi):
    path, _, frames, _ = avi
    t, j = tvr.VideoReader(path), jvr.VideoReader(path)
    assert (len(t), t.get_avg_fps(), t.width, t.height) == \
        (len(j), j.get_avg_fps(), j.width, j.height) == (12, 5.0, 64, 48)
    for idx in ([0, 1, 2], [11, 3, 3, 7, 0], list(range(12))):
        got = t.get_batch(idx)
        np.testing.assert_array_equal(got, j.get_batch(idx))
        np.testing.assert_array_equal(got, frames[idx])
        for size, crop in ((32, True), (32, False), (56, True)):
            np.testing.assert_array_equal(t.get_batch_i420(idx, size, crop),
                                          j.get_batch_i420(idx, size, crop))
    t.close()
    j.close()
    assert tvr.probe_video(path) == jvr.probe_video(path)
    for s, e in ((None, None), (0.5, 1.5), (2.0, 0.2)):
        for nf in (None, 4, 16):
            np.testing.assert_array_equal(
                np.stack(tvr.read_video_frames(path, nf, s, e)),
                np.stack(jvr.read_video_frames(path, nf, s, e)))


def test_decoder_audio_matches_jax(avi):
    path, silent, _, audio = avi
    for rate in (16000, 22050):
        got = tvr.decode_audio(path, rate)
        want = jvr.decode_audio(path, rate)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tvr.decode_audio(path)[:len(audio)],
                               audio[:len(tvr.decode_audio(path))],
                               atol=1 / 16000)
    np.testing.assert_array_equal(taudio.load_audio(path),
                                  jvr.decode_audio(path))
    assert tvr.has_audio(path) and not tvr.has_audio(silent)
    assert not tvr.has_audio(path + ".missing")
    with pytest.raises(OSError, match="no decodable audio"):
        tvr.decode_audio(silent)


def test_gif_raises_naming_gif(tmp_path):
    path = tmp_path / "clip.gif"
    frames = [Image.fromarray(np.full((8, 8, 3), i * 20, np.uint8))
              for i in range(3)]
    frames[0].save(str(path), save_all=True, append_images=frames[1:])
    for call in (lambda: tvr.read_video_frames(str(path), 4),
                 lambda: tvr.probe_video(str(path)),
                 lambda: tprep.process_video(str(path),
                                             tcfglib.tiny_vision())):
        with pytest.raises(NotImplementedError, match="GIF"):
            call()


def test_concurrent_first_builds(tmp_path, monkeypatch):
    """Processes (here threads) that build one helper at once into a fresh
    build root each write a temporary library and rename it into place:
    every one gets a complete library at the same hashed path."""
    import ctypes
    import threading
    monkeypatch.setattr(_native, "BUILD_ROOT", tmp_path / "build")
    paths, errors = [], []

    def build():
        try:
            paths.append(_native.build("png_unfilter.cc"))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors and len(set(paths)) == 1 and len(paths) == 4
    assert ctypes.CDLL(str(paths[0])).png_unfilter
    assert [p.name for p in paths[0].parent.iterdir()] == ["png_unfilter.so"]


@pytest.fixture()
def no_decoder(tmp_path, monkeypatch):
    """A host on which video_decoder.cc does not build: a compiler that
    fails as g++ does without libavcodec's headers, a fresh build root."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'video_decoder.cc:20:10: fatal error: "
                   "libavcodec/avcodec.h: No such file or directory' >&2\n"
                   "exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(_native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_native, "_loaded", {})
    monkeypatch.setattr(tvr, "_lib", None)


def test_missing_decoder_raises_a_named_error(avi, no_decoder):
    path, _, _, _ = avi
    cfg = tcfglib.tiny_vision()
    for call in (lambda: tvr.VideoReader(path),
                 lambda: tvr.decode_audio(path),
                 lambda: tvr.has_audio(path),
                 lambda: taudio.load_audio(path),
                 lambda: tprep.process_video(path, cfg),
                 lambda: tprep.process_video_i420(path, cfg)):
        with pytest.raises(RuntimeError, match="libavcodec") as e:
            call()
        assert "fatal error: libavcodec/avcodec.h" in str(e.value)
    assert not tvr.decoder_available()


# -- processors --------------------------------------------------------------

def _vision(variant):
    name = "videollama2_mistral" if variant == "clip" else "videollama2_qwen2"
    return jcfglib.preset(name).vision, tcfglib.preset(name).vision


def _hold_to_pil(got_u8, want_u8):
    """The resize is PIL's fixed-point resample, so the pixels are PIL's."""
    assert got_u8.dtype == np.uint8
    np.testing.assert_array_equal(got_u8, want_u8)


@pytest.mark.parametrize("variant", ["clip", "siglip"])
@pytest.mark.parametrize("aspect", [None, "pad"])
@pytest.mark.parametrize("hw", DOWNSCALE_SOURCES + UPSCALE_SOURCES)
def test_processors_match_jax_pil(variant, aspect, hw):
    jcfg, tcfg = _vision(variant)
    rng = np.random.default_rng(hw[0] + hw[1])
    frames = rng.integers(0, 256, (2,) + hw + (3,), dtype=np.uint8)
    want = jprep.preprocess_frames([Image.fromarray(f) for f in frames],
                                   jcfg, aspect, out_dtype="uint8")
    got = tprep.preprocess_frames(list(frames), tcfg, aspect,
                                  out_dtype="uint8")
    _hold_to_pil(got, want)
    want_f = jprep.preprocess_frames([Image.fromarray(f) for f in frames],
                                     jcfg, aspect)
    got_f = tprep.preprocess_frames(list(frames), tcfg, aspect)
    assert got_f.dtype == np.float32
    np.testing.assert_array_equal(got_f, want_f)
    mean = np.asarray(tcfg.image_mean, np.float32)
    std = np.asarray(tcfg.image_std, np.float32)
    np.testing.assert_array_equal(
        got_f, (got.astype(np.float32) / 255.0 - mean) / std)


@pytest.mark.parametrize("src,dst", [
    ((1, 5), (3, 7)), ((7, 9), (336, 432)), ((100, 37), (384, 384)),
    ((336, 500), (336, 336)), ((500, 336), (336, 336)), ((50, 50), (50, 50)),
    ((2160, 3840), (336, 597))])
def test_resize_matches_pil(src, dst):
    """csrc/resample.cc against PIL's Image.resize(BICUBIC) per frame: tiny,
    one axis only, none, and a 4K frame's 6.4x downscale (ksize 27)."""
    rng = np.random.default_rng(src[0] * 7 + dst[1])
    frames = rng.integers(0, 256, (3,) + src + (3,), dtype=np.uint8)
    got = tprep.resize_bicubic(frames, *dst)
    want = np.stack([np.asarray(Image.fromarray(f).resize(dst[::-1],
                                                          Image.BICUBIC))
                     for f in frames])
    np.testing.assert_array_equal(got, want)


def test_resize_refuses_an_empty_size():
    with pytest.raises(ValueError, match="cannot resize"):
        tprep.resize_bicubic(np.zeros((1, 4, 4, 3), np.uint8), 0, 4)


def test_processor_upscale_gap():
    """Sources smaller than image_size are upscaled, where an antialiased
    bicubic with other fixed-point rounding parts from PIL by up to 2
    levels on noise; the port's resample leaves no gap there either."""
    jcfg, tcfg = _vision("clip")
    frames = np.random.default_rng(9).integers(0, 256, (2, 240, 320, 3),
                                               dtype=np.uint8)
    want = jprep.preprocess_frames([Image.fromarray(f) for f in frames],
                                   jcfg, None, out_dtype="uint8")
    got = tprep.preprocess_frames(list(frames), tcfg, None,
                                  out_dtype="uint8")
    _hold_to_pil(got, want)


def test_pad_and_crop_are_exact():
    """expand2square and a resize to the same size are exact numpy: equal
    to PIL's expand2square, paste and crop."""
    rng = np.random.default_rng(2)
    for h, w in ((10, 6), (6, 10), (7, 7)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            tprep.expand2square(img, (1, 2, 3)),
            np.asarray(jprep.expand2square(Image.fromarray(img), (1, 2, 3))))
    jcfg, tcfg = jcfglib.tiny_vision(), tcfglib.tiny_vision()
    S = tcfg.image_size
    sq = rng.integers(0, 256, (3, S, S, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        tprep.preprocess_frames(list(sq), tcfg, None, "uint8"), sq)
    np.testing.assert_array_equal(
        tprep.preprocess_frames(list(sq), tcfg, None, "uint8"),
        jprep.preprocess_frames([Image.fromarray(f) for f in sq], jcfg,
                                None, "uint8"))


def test_photo_grid_matches_jax():
    rng = np.random.default_rng(0)
    for t in (1, 2, 3, 7, 9, 16):
        arr = rng.integers(0, 255, (t, 6, 5, 3), dtype=np.uint8)
        np.testing.assert_array_equal(tprep.create_photo_grid(arr),
                                      jprep.create_photo_grid(arr))
    arr = rng.integers(0, 255, (5, 4, 4, 3), dtype=np.uint8)
    for kw in (dict(rows=2), dict(cols=4)):
        np.testing.assert_array_equal(tprep.create_photo_grid(arr, **kw),
                                      jprep.create_photo_grid(arr, **kw))
    np.testing.assert_array_equal(tprep.create_photo_grid(list(arr)),
                                  jprep.create_photo_grid(list(arr)))


@pytest.mark.parametrize("fmt", ["png", "bmp"])
@pytest.mark.parametrize("num_frames", [4, 9])
def test_process_video_frame_directory_matches_jax(tmp_path, fmt,
                                                   num_frames):
    """A directory of 6 frames at 60x80 (PNG or BMP) through both
    packages' process_video, 9 frames asking for the reference's
    zero-frame padding (its pad frame is the last frame's transpose)."""
    jcfg, tcfg = jcfglib.tiny_vision(), tcfglib.tiny_vision()
    rng = np.random.default_rng(5)
    for i in range(6):
        px = _smooth(rng, 60, 80, 3)
        data = encode_png(px) if fmt == "png" else encode_bmp(px)
        (tmp_path / f"{i:02d}.{fmt}").write_bytes(data)
    for aspect in (None, "pad"):
        want = jprep.process_video(str(tmp_path), jcfg, aspect_ratio=aspect,
                                   num_frames=num_frames, out_dtype="uint8")
        got = tprep.process_video(str(tmp_path), tcfg, aspect_ratio=aspect,
                                  num_frames=num_frames, out_dtype="uint8")
        _hold_to_pil(got, want)
    files = sorted(str(p) for p in tmp_path.iterdir())
    _hold_to_pil(tprep.process_video(files, tcfg, num_frames=num_frames,
                                     out_dtype="uint8"),
                 jprep.process_video(files, jcfg, num_frames=num_frames,
                                     out_dtype="uint8"))
    got = tprep.process_video_i420(str(tmp_path), tcfg,
                                   num_frames=num_frames)
    np.testing.assert_array_equal(got, twire.rgb_to_i420(tprep.process_video(
        str(tmp_path), tcfg, aspect_ratio=None, num_frames=num_frames,
        out_dtype="uint8")))


@pytest.mark.parametrize("num_frames", [8, 16])
def test_process_video_container_matches_jax(avi, num_frames):
    """An AVI: RGB frames equal to JAX's; the I420
    route (C++ scale and crop in YUV, black I420 padding past the clip's
    12 frames) bit for bit."""
    path = avi[0]
    for variant in ("clip", "siglip"):
        jcfg = jcfglib.tiny_vision(variant)
        tcfg = tcfglib.tiny_vision(variant)
        _hold_to_pil(
            tprep.process_video(path, tcfg, num_frames=num_frames,
                                out_dtype="uint8"),
            jprep.process_video(path, jcfg, num_frames=num_frames,
                                out_dtype="uint8"))
        got = tprep.process_video_i420(path, tcfg, num_frames=num_frames)
        np.testing.assert_array_equal(
            got, jprep.process_video_i420(path, jcfg, num_frames=num_frames))
        assert got.shape == (num_frames, tcfg.image_size * 3 // 2,
                             tcfg.image_size)


def test_process_image_inputs(tmp_path):
    """Path, bytes and array inputs of process_image agree; gray and RGBA
    arrays convert as PIL's convert("RGB") does."""
    tcfg, jcfg = tcfglib.tiny_vision(), jcfglib.tiny_vision()
    rng = np.random.default_rng(6)
    px = _smooth(rng, 70, 50, 3)
    data = encode_png(px)
    path = tmp_path / "a.png"
    path.write_bytes(data)
    by_path = tprep.process_image(str(path), tcfg)
    np.testing.assert_array_equal(by_path, tprep.process_image(data, tcfg))
    np.testing.assert_array_equal(by_path, tprep.process_image(px, tcfg))
    np.testing.assert_array_equal(by_path,
                                  jprep.process_image(str(path), jcfg))
    for arr in (px[..., 0], np.concatenate([px, px[..., :1]], axis=-1)):
        np.testing.assert_array_equal(
            tprep.process_image(arr, tcfg, out_dtype="uint8"),
            tprep.process_image(np.asarray(Image.fromarray(arr).convert(
                "RGB")), tcfg, out_dtype="uint8"))


# -- the public API's processors ----------------------------------------------

@pytest.mark.parametrize("wire", ["rgb", "i420"])
def test_api_processors(avi, tmp_path, wire):
    """model_init's processor entries (JAX's: uint8 out; i420 wraps them,
    a container path taking the C++ YUV route)."""
    cfg = tcfglib.tiny_model()
    processor = tapi._processors(cfg, wire)
    assert set(processor) == {"image", "video"}
    S = cfg.vision.image_size
    img = tmp_path / "a.bmp"
    img.write_bytes(encode_bmp(_smooth(np.random.default_rng(8), 40, 64,
                                       3)))
    rgb_image = tprep.process_image(str(img), cfg.vision, aspect_ratio=None,
                                    out_dtype="uint8")
    rgb_video = tprep.process_video(avi[0], cfg.vision, aspect_ratio=None,
                                    num_frames=cfg.num_frames,
                                    out_dtype="uint8")
    if wire == "rgb":
        np.testing.assert_array_equal(processor["image"](str(img)),
                                      rgb_image)
        np.testing.assert_array_equal(processor["video"](avi[0]), rgb_video)
        assert rgb_video.shape == (cfg.num_frames, S, S, 3)
        return
    np.testing.assert_array_equal(processor["image"](str(img)),
                                  twire.rgb_to_i420(rgb_image))
    native = processor["video"](avi[0])
    np.testing.assert_array_equal(native, tprep.process_video_i420(
        avi[0], cfg.vision, num_frames=cfg.num_frames))
    np.testing.assert_array_equal(native, jprep.process_video_i420(
        avi[0], jcfglib.tiny_model().vision, num_frames=cfg.num_frames))
    # a keyword the native route does not take goes the RGB way
    np.testing.assert_array_equal(
        processor["video"](avi[0], aspect_ratio="pad"),
        twire.rgb_to_i420(tprep.process_video(
            avi[0], cfg.vision, aspect_ratio="pad",
            num_frames=cfg.num_frames, out_dtype="uint8")))
    assert jwire.rgb_to_i420(rgb_video).shape == native.shape


def test_av_audio_track_and_silence(avi):
    """_prep_av_audio: the container's own track as fbank features (JAX's
    bit for bit); silence with a warning only where the decoder ran and
    found no track."""
    from videollama2_tpu.inference import api as japi
    path, silent, _, _ = avi
    cfg = tcfglib.preset("videollama2_qwen2_av")
    feats = tapi._prep_av_audio(path, cfg)
    assert feats.shape == (1, cfg.audio.max_frames, 128)
    np.testing.assert_array_equal(feats, japi._prep_av_audio(
        path, jcfglib.preset("videollama2_qwen2_av")))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        silence = tapi._prep_av_audio(silent, cfg)
    assert not silence.any() and silence.shape == feats.shape
    assert any("no decodable audio track" in str(x.message) for x in w)


def test_av_audio_without_decoder_raises(avi, no_decoder):
    cfg = tcfglib.preset("videollama2_qwen2_av")
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # and no silence warning either
        with pytest.raises(RuntimeError, match="libavcodec"):
            tapi._prep_av_audio(avi[0], cfg)
