"""Interactive CLI chat (port of videollama2_tpu/serve/cli.py).

Loads a checkpoint with its own tokenizer files (or a factory named by
`--tokenizer module:callable`, inference/api.load_tokenizer), optionally
attaches an image or a video, and
answers each turn through a prefix-cached ChatSession: the media is encoded
and the history prefilled once, and each later turn feeds only its new
tokens.
"""

from __future__ import annotations

import argparse


def main():
    from ..inference.api import add_model_flags

    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    add_model_flags(ap)
    ap.add_argument("--image-file", default=None)
    ap.add_argument("--video-file", default=None)
    ap.add_argument("--temperature", type=float, default=0.2)
    ap.add_argument("--do-sample", action="store_true")
    ap.add_argument("--max-new-tokens", type=int, default=512)
    ap.add_argument("--wire", default="i420", choices=("i420", "rgb"),
                    help="host->device frame wire (media/wire.py)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="prompt-lookup speculative decoding for greedy "
                         "turns (inference/speculative.py)")
    args = ap.parse_args()

    from ..inference.api import ChatSession, load_tokenizer, model_init

    model, processor, tokenizer = model_init(
        args.model_path, wire=args.wire, device=args.device,
        tokenizer=load_tokenizer(args.tokenizer, args.model_path))

    tensor, modal = None, "text"
    if args.video_file:
        tensor, modal = processor["video"](args.video_file), "video"
    elif args.image_file:
        tensor, modal = processor["image"](args.image_file), "image"

    chat = ChatSession(tensor, model, tokenizer, modal=modal,
                       do_sample=args.do_sample,
                       temperature=args.temperature,
                       max_new_tokens=args.max_new_tokens,
                       speculative_k=args.speculative)
    print("Type your message ('exit' to quit).")
    while True:
        try:
            text = input("USER: ")
        except EOFError:
            break
        if text.strip().lower() in ("exit", "quit"):
            break
        print(f"ASSISTANT: {chat.ask(text)}")


if __name__ == "__main__":
    main()
