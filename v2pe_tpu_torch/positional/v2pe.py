"""V2PE variable-increment position ids (the core algorithm).

Pure host-side (numpy) code that is a function of
``(input_ids, attention_mask, num_tiles, stride, version)``, matching the
reference's two near-identical implementations bit-for-bit:

* train:      ``internvl/train/internvl_chat_finetune.py:555-625``
  (``LazySupervisedDataset.get_rope_pos_id``)
* inference:  ``internvl/model/internvl_chat/modeling_internvl_chat.py:637-709``
  (module-level ``get_rope_pos_id``)

Semantics: walk ``input_ids`` between ``<img>``/``</img>`` token pairs.

* Text spans (incl. the ``<img>`` token itself and the ``</img>`` token):
  integer positions, ``cumsum(attention_mask) - 1 + (last + 1)``; padded
  slots (mask==0) are forced to position 1.
* Visual spans (the ``num_image_token * num_tile`` ``<IMG_CONTEXT>`` tokens
  following ``<img>``): fractional increments ``small_stride = stride /
  num_image_token``, i.e. position ``last + k*small_stride`` for
  k = 1..num_image_token*num_tile; afterwards the integer cursor advances to
  ``ceil`` of the final fractional position.
* ``v2pe_rnd`` samples the stride per image from {1,2,4,8,16,32,64,128,256}.
* ``default`` yields plain integer positions (equal to the cumsum ids).

Result dtype float32 for v2pe versions (int positions cast for 'default' the
reference returns int64 values in a float-safe python list; we return float32
throughout and an int64 array for 'default').
"""

from __future__ import annotations

import math
import random as _random
from typing import Optional, Sequence

import numpy as np

V2PE_RND_STRIDES = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _arange_f32(start: int, count: int, step: float) -> np.ndarray:
    """float32 arange matching torch.arange(start, start+step*(count+1), step)[1:].

    torch computes float32 arange values with a double accumulator
    (start + i*step in float64, cast to float32), so we do the same.
    """
    i = np.arange(1, count + 1, dtype=np.float64)
    return (np.float64(start) + i * np.float64(step)).astype(np.float32)


def build_v2pe_pos_ids(
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    num_tiles: Sequence[int],
    *,
    img_start_id: int,
    img_end_id: int,
    num_image_token: int = 256,
    version: str = "v2pe_fix",
    stride: Optional[int] = None,
    rng: Optional[_random.Random] = None,
) -> np.ndarray:
    """Build the per-token float32 position-id vector for one sequence.

    Args:
      input_ids: int array (S,).
      attention_mask: int/bool array (S,); 0 marks padding.
      num_tiles: number of 448x448 tiles per image, in order of appearance
        (including the thumbnail tile if present).
      img_start_id / img_end_id: token ids of '<img>' / '</img>'.
      num_image_token: visual tokens per tile (256 for InternVL2).
      version: 'v2pe_fix' | 'v2pe_rnd' | 'default'.
      stride: integer stride for 'v2pe_fix' (1..256).
      rng: random.Random used by 'v2pe_rnd' (defaults to the global one,
        matching the reference's `random.choice`).

    Returns:
      float32 (S,) array ('default' returns int64).
    """
    input_ids = np.asarray(input_ids)
    attention_mask = np.asarray(attention_mask).astype(np.int64)
    assert input_ids.ndim == 1 and attention_mask.shape == input_ids.shape

    img_start_idxs = np.where(input_ids == img_start_id)[0]
    img_end_idxs = np.where(input_ids == img_end_id)[0]
    assert len(img_start_idxs) == len(num_tiles), (
        f"{len(img_start_idxs)} <img> tokens but {len(num_tiles)} num_tiles"
    )

    parts = []
    last = -1  # last_record_pos_id
    start_index = 0

    for i in range(len(img_start_idxs)):
        num_tile = int(num_tiles[i])
        span_mask = attention_mask[start_index : img_start_idxs[i] + 1]
        pre = np.cumsum(span_mask) - 1 + (last + 1)
        pre = np.where(span_mask == 0, 1, pre)
        parts.append(pre.astype(np.float32))
        last = int(pre[-1])

        if version in ("v2pe_fix", "v2pe_rnd"):
            if version == "v2pe_fix":
                assert stride is not None, "v2pe_fix requires a stride"
                s = stride
            else:
                s = (rng or _random).choice(list(V2PE_RND_STRIDES))
            small_stride = s / num_image_token
            vis = _arange_f32(last, num_image_token * num_tile, small_stride)
            parts.append(vis)
            last = int(math.ceil(np.float32(vis[-1])))
        elif version == "default":
            vis = np.arange(
                last + 1, last + num_tile * num_image_token + 1, dtype=np.int64
            ).astype(np.float32)
            parts.append(vis)
            last = last + num_tile * num_image_token
        else:
            raise NotImplementedError(f"rope_pos_id_version {version!r}")

        start_index = int(img_start_idxs[i]) + num_tile * num_image_token + 1
        assert input_ids[start_index] == img_end_id, (
            "image tokens are truncated or <img>/<IMG_CONTEXT>/</img> structure "
            f"is broken at index {start_index}"
        )
        assert start_index == img_end_idxs[i]

    span_mask = attention_mask[start_index:]
    tail = np.cumsum(span_mask) - 1 + (last + 1)
    tail = np.where(span_mask == 0, 1, tail)
    parts.append(tail.astype(np.float32))

    pos = np.concatenate(parts).astype(np.float32)
    assert pos.shape == input_ids.shape
    if version == "default":
        return pos.astype(np.int64)
    return pos


def advance_pos_id(last_pos: float, num_new_tokens: int) -> np.ndarray:
    """Decode-time position advance: generated text continues at integer
    stride from the (possibly fractional) prompt maximum.

    Reference: ``InternLM2ForCausalLM.prepare_inputs_for_generation``,
    ``modeling_internlm2.py:2000-2002`` (next pos = pos[:, -1] + #new tokens).
    """
    return np.float32(last_pos) + np.arange(1, num_new_tokens + 1, dtype=np.float32)
