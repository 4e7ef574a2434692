"""Multimodal tokenization: splice negative modal-token ids into text ids.

The port's own copy of videollama2_tpu/multimodal/tokenizer.py (parity:
reference videollama2/mm_utils.py:277-311), held equal to it by
tests/test_torch_config.py. It is duck-typed: any tokenizer object whose
`__call__(text, add_special_tokens=False)` returns something with
`.input_ids` will do, so the port needs no tokenizer library of its own.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from ..constants import DEFAULT_IMAGE_TOKEN, MODAL_INDEX_MAP


def tokenizer_multimodal_token(prompt: str, tokenizer,
                               multimodal_token: str = DEFAULT_IMAGE_TOKEN,
                               return_tensors: Optional[str] = None):
    """Tokenize text with a multimodal tag; the tag becomes its negative id.

    Matches mm_utils.py:277-302 exactly, including `add_special_tokens=False`
    on every chunk (BOS is expected to come from the chat template).
    """
    multimodal_token_index = MODAL_INDEX_MAP.get(multimodal_token, None)
    if multimodal_token_index is None:
        input_ids = tokenizer(prompt, add_special_tokens=False).input_ids
    else:
        prompt_chunks = [tokenizer(chunk, add_special_tokens=False).input_ids
                         for chunk in prompt.split(multimodal_token)]
        input_ids: List[int] = []
        for i in range(1, 2 * len(prompt_chunks)):
            if i % 2 == 1:
                input_ids.extend(prompt_chunks[i // 2])
            else:
                input_ids.append(multimodal_token_index)

    if return_tensors is not None:
        if return_tensors == "np":
            return np.asarray(input_ids, dtype=np.int64)
        raise ValueError(f"Unsupported tensor type: {return_tensors}")
    return input_ids


def tokenizer_multimodal_tokens(prompt: str, tokenizer,
                                multimodal_tokens) -> List[int]:
    """Multi-tag variant for joint AV prompts: each tag in
    `multimodal_tokens` becomes its negative id, in prompt order."""
    pattern = "(" + "|".join(re.escape(t) for t in multimodal_tokens) + ")"
    input_ids: List[int] = []
    for part in re.split(pattern, prompt):
        if part in MODAL_INDEX_MAP and part in multimodal_tokens:
            input_ids.append(MODAL_INDEX_MAP[part])
        elif part:
            input_ids.extend(
                tokenizer(part, add_special_tokens=False).input_ids)
    return input_ids


def get_model_name_from_path(model_path: str) -> str:
    """Parity: mm_utils.py:305-311."""
    model_path = model_path.strip("/")
    model_paths = model_path.split("/")
    if model_paths[-1].startswith("checkpoint-"):
        return model_paths[-2] + "_" + model_paths[-1]
    return model_paths[-1]
