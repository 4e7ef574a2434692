"""End-to-end drive of the port's public API, as a user of the reference
calls it (reference quickstart README.md:300-337; the port of
scripts/e2e_smoke.py):

    model, processor, tokenizer = videollama2_tpu_torch.model_init(path)
    tensor = processor['video'](video_path)
    out = videollama2_tpu_torch.mm_infer(tensor, question, model, tokenizer,
                                         'video')

model_init gets no tokenizer: it reads the checkpoint directory's own
tokenizer files. The script writes a 12-frame GIF and a PNG with the
repository's plain writers (tests/gif_writer.py, tests/png_writer.py) and
asks about them as video, image and text, in a batch, and over the I420
wire; each answer must be the decode of its streamed tokens. It prints
`E2E OK` at the end.

  python scripts/e2e_smoke_torch.py --model-path CKPT [--device cuda]

CKPT is a VideoLLaMA2 checkpoint directory with its tokenizer files:
scripts/make_tiny_checkpoint.py writes one (it needs transformers), or
chip_smoke.py's checkpoint writer with tests/tokenizer_writer.py.
"""

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gif_writer import encode_rgb_gif  # noqa: E402
from png_writer import encode_png  # noqa: E402


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--bucket", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    return ap


def ask(api, media, question, model, tokenizer, modal, n):
    """mm_infer's answer, checked against the decode of its tokens."""
    tokens = []
    out = api.mm_infer(media, question, model, tokenizer, modal=modal,
                       max_new_tokens=n,
                       stream_cb=lambda b, toks: tokens.__setitem__(
                           slice(None), list(toks)))
    want = tokenizer.decode(tokens, skip_special_tokens=True).strip()
    assert out == want, (out, want)
    assert tokens, "no token generated"
    return out


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import videollama2_tpu_torch
    from videollama2_tpu_torch.inference import api
    from videollama2_tpu_torch.media import wire

    tmp = tempfile.mkdtemp(prefix="vllama2_e2e_torch_")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (12, 64, 48, 3), dtype=np.uint8)
    video_path = os.path.join(tmp, "clip.gif")
    with open(video_path, "wb") as f:
        f.write(encode_rgb_gif(frames))
    img_path = os.path.join(tmp, "img.png")
    with open(img_path, "wb") as f:
        f.write(encode_png(frames[0]))

    model, processor, tokenizer = videollama2_tpu_torch.model_init(
        args.model_path, dtype=getattr(torch, args.dtype),
        max_len=args.max_len, buckets=(args.bucket,), device=args.device)
    print("model_type:", model.model_type,
          "tokens_per_video:", model.config.tokens_per_video,
          "tokenizer:", type(tokenizer).__name__, len(tokenizer))

    tensor = processor["video"](video_path)
    assert tensor.dtype == np.uint8, tensor.dtype
    print("video tensor:", tensor.shape, tensor.dtype)
    n = args.max_new_tokens
    print("VIDEO ANSWER:", repr(ask(videollama2_tpu_torch, tensor,
                                    "What happens in the video ?", model,
                                    tokenizer, "video", n)))
    img = processor["image"](img_path)
    print("IMAGE ANSWER:", repr(ask(videollama2_tpu_torch, img,
                                    "Describe the image .", model,
                                    tokenizer, "image", n)))
    print("TEXT ANSWER:", repr(ask(videollama2_tpu_torch, None,
                                   "Say yes or no .", model, tokenizer,
                                   "text", max(n // 2, 1))))
    outs = api.mm_infer_batch(tensor, ["What happens ?",
                                       "Describe briefly ."],
                              model, tokenizer, modal="video",
                              max_new_tokens=max(n // 2, 1))
    assert len(outs) == 2 and all(isinstance(o, str) for o in outs)
    print("BATCH ANSWERS:", [repr(o) for o in outs])
    # the I420 wire (media/wire.py): packed planar frames in, unpacked on
    # the device
    packed = wire.rgb_to_i420(tensor)
    print("I420 ANSWER:", repr(ask(videollama2_tpu_torch, packed,
                                   "What happens in the video ?", model,
                                   tokenizer, "video", max(n // 2, 1))))
    print("E2E OK")


if __name__ == "__main__":
    main()
