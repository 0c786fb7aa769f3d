"""MM-NIAH-long (128k-1M) teacher-forced evaluation, port of
``v2pe_tpu/evalkit/mm_niah_long.py``.

No generation: one packed teacher-forced forward; the prediction is the
logits argmax at the answer token slots. Sequence parallelism comes from the
ambient ShardingContext (ring attention over the ``seq`` axis,
``parallel/context.py``), and the host pre-arranges the zigzag layout
exactly like training batches."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from v2pe_tpu_torch.core.config import VLMConfig
from v2pe_tpu_torch.data.packing import zigzag_permutation


def build_teacher_forced_inputs(
    full_ids: np.ndarray,          # (S,) prompt + gold answer tokens
    answer_span: Tuple[int, int],  # [start, end) indices of answer tokens
    rope_pos_ids: np.ndarray,      # (S,) float32
    *,
    seq_shards: int = 1,
    pad_multiple: int = 256,
):
    """Pad to a static multiple and (optionally) zigzag-permute; returns the
    batch arrays + the inverse permutation to un-shuffle logits."""
    S = len(full_ids)
    S_pad = -(-S // pad_multiple) * pad_multiple
    if seq_shards > 1:
        S_pad = -(-S_pad // (2 * seq_shards)) * (2 * seq_shards)

    ids = np.zeros((S_pad,), np.int64)
    ids[:S] = full_ids
    pos = np.ones((S_pad,), np.float32)
    pos[:S] = rope_pos_ids
    seg = np.zeros((S_pad,), np.int32)
    seg[:S] = 1
    token_positions = np.arange(S_pad, dtype=np.int32)

    perm = np.arange(S_pad)
    if seq_shards > 1:
        perm = zigzag_permutation(S_pad, seq_shards)
        ids, pos, seg = ids[perm], pos[perm], seg[perm]
        token_positions = token_positions[perm]
    inv = np.argsort(perm)

    return {
        "input_ids": ids[None].astype(np.int32),
        "rope_pos_ids": pos[None],
        "segment_ids": seg[None],
        "token_positions": token_positions[None],
        "inverse_perm": inv,
        "answer_span": answer_span,
        "orig_len": S,
    }


def extract_answer_prediction(
    logits: np.ndarray,           # (1, S_pad, V) possibly permuted layout
    inputs: dict,
) -> np.ndarray:
    """Undo the zigzag layout and read argmax at the slots *preceding* each
    answer token (teacher-forced next-token prediction)."""
    inv = inputs["inverse_perm"]
    start, end = inputs["answer_span"]
    logits = logits[0][inv]  # back to global order
    pred = logits[start - 1:end - 1].argmax(-1)
    return pred


def teacher_forced_eval(
    model, cfg: VLMConfig, inputs: dict, pixel_values, image_flags,
    img_context_token_id: int, vit_gather_idx: Optional[np.ndarray] = None,
):
    """The predictions at the answer slots of one teacher-forced forward on
    the model's device."""
    import torch

    from v2pe_tpu_torch.models import internvl_chat

    device = next(model.parameters()).device
    t = lambda a: torch.as_tensor(np.asarray(a)).to(device)
    with torch.inference_mode():
        logits = internvl_chat.forward(
            model, cfg,
            input_ids=t(inputs["input_ids"]).long(),
            pixel_values=t(pixel_values),
            image_flags=t(image_flags),
            rope_pos_ids=t(inputs["rope_pos_ids"]),
            img_context_token_id=img_context_token_id,
            segment_ids=t(inputs["segment_ids"]),
            token_positions=t(inputs["token_positions"]),
            vit_gather_idx=None if vit_gather_idx is None
            else t(vit_gather_idx),
        ).logits
        # read the answer slots on the device: only the predictions cross
        # to the host, not the (S, V) logits
        inv = t(inputs["inverse_perm"])
        start, end = inputs["answer_span"]
        pred = logits[0][inv[start - 1:end - 1]].argmax(-1).cpu().numpy()
    return pred
