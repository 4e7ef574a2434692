"""The port's copies of the JAX package's host modules (core/config.py,
constants.py, media/wire.py) against the originals: every preset and tiny
config field by field, the derived token counts, the token constants and
the I420 pack/unpack on a seeded frame."""

import dataclasses

import numpy as np
import pytest

from videollama2_tpu import constants as jconst
from videollama2_tpu.core import config as jcfg
from videollama2_tpu.media import wire as jwire
from videollama2_tpu_torch import constants as tconst
from videollama2_tpu_torch.core import config as tcfg
from videollama2_tpu_torch.media import wire as twire

PRESETS = sorted(jcfg._PRESETS)


def test_same_presets():
    assert sorted(tcfg._PRESETS) == PRESETS


def _configs(name):
    if name.startswith("tiny:"):
        _, model_type, projector = name.split(":")
        return (jcfg.tiny_model(model_type, projector),
                tcfg.tiny_model(model_type, projector))
    return jcfg.preset(name), tcfg.preset(name)


@pytest.mark.parametrize("name", PRESETS + [
    "tiny:videollama2_mistral:stc_connector_v35",
    "tiny:videollama2_mistral:stc_connector",
    "tiny:videollama2_qwen2:stc_connector_v35"])
def test_config_fields_and_derived_counts(name):
    j, t = _configs(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for frames in (8, 16):
        assert (t.replace(num_frames=frames).tokens_per_video
                == j.replace(num_frames=frames).tokens_per_video)
    assert t.vision.seq_len == j.vision.seq_len
    assert t.vision.head_dim == j.vision.head_dim
    assert t.connector.conv_padding == j.connector.conv_padding
    assert t.llm.is_moe == j.llm.is_moe


@pytest.mark.parametrize("fn,kw", [
    ("tiny_llm", dict(model_type="mistral")),
    ("tiny_llm", dict(model_type="qwen2", vocab_size=300)),
    ("tiny_vision", dict(variant="clip")),
    ("tiny_vision", dict(variant="siglip")),
])
def test_tiny_parts(fn, kw):
    assert (dataclasses.asdict(getattr(tcfg, fn)(**kw))
            == dataclasses.asdict(getattr(jcfg, fn)(**kw)))


def test_connector_token_counts():
    for pt in ("stc_connector", "stc_connector_v35", "spatial_conv",
               "stp_connector", "spatial_pool", "identity", "mlp2x_gelu",
               "linear"):
        jc = jcfg.ConnectorConfig(projector_type=pt)
        tc = tcfg.ConnectorConfig(projector_type=pt)
        for t, hw in ((8, 24), (16, 24), (4, 27)):
            assert (tcfg.connector_output_tokens(tc, t, hw)
                    == jcfg.connector_output_tokens(jc, t, hw))
    assert tcfg.conv3d_out(24, 2, 2, 1) == jcfg.conv3d_out(24, 2, 2, 1)


def test_constants():
    for name in ("IGNORE_INDEX", "IMAGE_TOKEN_INDEX", "VIDEO_TOKEN_INDEX",
                 "AUDIO_TOKEN_INDEX", "MODAL_INDEX_MAP"):
        assert getattr(tconst, name) == getattr(jconst, name), name


def test_wire_pack_and_unpack():
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (2, 3, 56, 40, 3), dtype=np.uint8)
    for name in ("INV_R_CR", "INV_G_CB", "INV_G_CR", "INV_B_CB"):
        assert getattr(twire, name) == getattr(jwire, name)
    packed = twire.rgb_to_i420(rgb)
    np.testing.assert_array_equal(packed, jwire.rgb_to_i420(rgb))
    np.testing.assert_array_equal(twire.i420_to_rgb(packed),
                                  jwire.i420_to_rgb(packed))
