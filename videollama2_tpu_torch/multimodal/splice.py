"""Static-shape multimodal token splice (port of
videollama2_tpu/multimodal/splice.py).

`plan_batch` (host, numpy) lays out each spliced sequence: for every
position either a text token id or the per-sample index of a visual token,
right-padded to a bucket. It is a copy of the JAX package's numpy planner,
which cannot be imported without jax; tests hold the two equal.
`compose_embeds` (device, torch) gathers the visual embeddings into place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..constants import IGNORE_INDEX, MODAL_INDEX_MAP

_MODAL_IDS = tuple(MODAL_INDEX_MAP.values())


@dataclass
class SplicePlan:
    """Static splice layout for one batch (all arrays [B, S] unless noted)."""
    text_ids: np.ndarray    # token id to embed at position (0 where visual)
    is_visual: np.ndarray   # bool: position holds a visual embedding
    vis_index: np.ndarray   # per-sample index into that sample's vis tokens
    labels: Optional[np.ndarray]  # IGNORE_INDEX-masked supervision targets
    valid_len: np.ndarray   # [B] true sequence lengths
    positions: np.ndarray   # [B, S] RoPE positions (= arange, pad included)

    @property
    def seq_len(self) -> int:
        return self.text_ids.shape[1]


def _count_for(tokens_per_modal, tok: int) -> int:
    if isinstance(tokens_per_modal, dict):
        return tokens_per_modal[tok]
    return tokens_per_modal


def spliced_length(input_ids: Sequence[int], tokens_per_modal) -> int:
    """tokens_per_modal: int, or {modal_id: count} for mixed prompts."""
    n = len(input_ids)
    for t in input_ids:
        if t in _MODAL_IDS:
            n += _count_for(tokens_per_modal, t) - 1
    return n


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if length <= b:
            return b
    raise ValueError(f"sequence length {length} exceeds largest bucket "
                     f"{max(buckets)}")


def plan_batch(batch_input_ids: List[Sequence[int]], tokens_per_modal,
               seq_len: int,
               batch_labels: Optional[List[Sequence[int]]] = None,
               truncate: bool = True) -> SplicePlan:
    """Lay out spliced sequences for a batch, right-padded to seq_len.

    Each modal tag (negative id) expands in place to its tokens; the n-th
    tag of a sample uses rows [offset, offset + count) of that sample's
    visual token stack.
    """
    B = len(batch_input_ids)
    text_ids = np.zeros((B, seq_len), dtype=np.int32)
    is_visual = np.zeros((B, seq_len), dtype=bool)
    vis_index = np.zeros((B, seq_len), dtype=np.int32)
    labels_out = (np.full((B, seq_len), IGNORE_INDEX, dtype=np.int32)
                  if batch_labels is not None else None)
    valid_len = np.zeros((B,), dtype=np.int32)

    for b, ids in enumerate(batch_input_ids):
        lab = batch_labels[b] if batch_labels is not None else None
        pos = 0
        offset = 0  # running offset into this sample's modal-token stack
        for j, tok in enumerate(ids):
            if tok in _MODAL_IDS:
                count = _count_for(tokens_per_modal, tok)
                n = count
                if pos + n > seq_len:
                    if not truncate:
                        raise ValueError("spliced sequence exceeds bucket")
                    n = max(0, seq_len - pos)
                is_visual[b, pos:pos + n] = True
                vis_index[b, pos:pos + n] = offset + np.arange(n)
                pos += n
                offset += count
            else:
                if pos >= seq_len:
                    if not truncate:
                        raise ValueError("spliced sequence exceeds bucket")
                    break
                text_ids[b, pos] = tok
                if labels_out is not None:
                    labels_out[b, pos] = lab[j]
                pos += 1
        valid_len[b] = pos

    positions = np.broadcast_to(np.arange(seq_len, dtype=np.int32),
                                (B, seq_len)).copy()
    return SplicePlan(text_ids=text_ids, is_visual=is_visual,
                      vis_index=vis_index, labels=labels_out,
                      valid_len=valid_len, positions=positions)


def compose_embeds(text_emb: torch.Tensor, vis_tokens: torch.Tensor,
                   is_visual: torch.Tensor,
                   vis_index: torch.Tensor) -> torch.Tensor:
    """text_emb [B, S, D] + per-sample visual tokens [B, N, D] -> [B, S, D]
    with position s taking vis_tokens[b, vis_index[b, s]] where is_visual."""
    idx = vis_index.long()[..., None].expand(-1, -1, vis_tokens.shape[-1])
    vis_emb = torch.gather(vis_tokens.to(text_emb.dtype), 1, idx)
    return torch.where(is_visual[..., None], vis_emb, text_emb)
