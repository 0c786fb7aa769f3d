"""Static-shape sample packing with segment ids + device batch assembly.

Replaces the reference's variable-size buffer machinery (``PackedDataset``,
``internvl/train/dataset_packed.py:40-545``, and ``packed_collate_fn``
:551-634 which smuggles cu_seqlens through attention_mask) with a static-shape
design: every packed row is exactly ``max_tokens`` long (padding = segment
0), every batch carries exactly ``max_tiles`` ViT tiles (padding tiles have
image_flags=0), and the collated batch is the static-shape contract of
train/train_step.py. Capabilities preserved:

* weighted multi-dataset sampling (dataset_packed.py:457-459);
* greedy first-fit packing bounded by max_tokens and max_tiles
  (find_buffer/update_buffer :204-244) — samples are never split across
  rows (the reference's split_buffer cuts only at image boundaries; we keep
  whole samples and rely on the length budget instead);
* per-token loss weights len2weight(num_effective_tokens)
  (internvl_chat_finetune.py:1059-1085; collate zeroing at labels==-100,
  dataset_packed.py:622);
* resumable iterator state (load_state_dict/worker-state parity,
  dataset_packed.py:143-153, 392-398);
* pre-shifted targets and host-computed vit gather indices so the device
  code is shard-layout independent (zigzag ring layouts included).
"""

from __future__ import annotations

import math
import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from v2pe_tpu_torch.data.constants import IGNORE_TOKEN_ID


def len2weight(num_effective_tokens: int, loss_reduction: str) -> float:
    """internvl_chat_finetune.py:1059-1085."""
    if num_effective_tokens == 0:
        return 0.0
    if loss_reduction == "token":
        return 1.0
    if loss_reduction == "sample":
        return 1.0 / num_effective_tokens
    if loss_reduction == "square":
        return 1.0 / (num_effective_tokens ** 0.5)
    raise NotImplementedError(loss_reduction)


class PackedSampleIterator:
    """Greedy packer: pulls samples from weighted datasets into rows of at
    most ``max_tokens`` tokens and ``max_tiles_per_row`` tiles."""

    def __init__(
        self,
        datasets: Dict[str, object],   # name -> SupervisedDataset
        *,
        max_tokens: int = 8192,
        max_tiles_per_row: int = 16,
        loss_reduction: str = "token",
        weights: Optional[Dict[str, float]] = None,
        seed: int = 0,
        img_context_token_id: Optional[int] = None,
    ):
        assert datasets, "need at least one dataset"
        self.datasets = datasets
        self.names = sorted(datasets.keys())
        if weights is None:
            weights = {n: float(len(datasets[n])) for n in self.names}
        total = sum(weights[n] for n in self.names)
        self.probs = [weights[n] / total for n in self.names]
        self.max_tokens = max_tokens
        self.max_tiles_per_row = max_tiles_per_row
        self.loss_reduction = loss_reduction
        self.rng = random.Random(seed)
        self.cursors = {n: 0 for n in self.names}
        self.epochs = {n: 0 for n in self.names}
        self.img_context_token_id = img_context_token_id
        # the sample that didn't fit the previous row: (name, idx) reference
        # so iterator state is fully serializable for data resume
        self._pushback_ref: Optional[tuple] = None

    # -------------------------------------------------------------- state
    def state_dict(self) -> dict:
        return {
            "cursors": dict(self.cursors),
            "epochs": dict(self.epochs),
            "rng_state": self.rng.getstate(),
            "pushback_ref": self._pushback_ref,
        }

    def load_state_dict(self, state: dict):
        self.cursors.update(state["cursors"])
        self.epochs.update(state["epochs"])
        rng_state = state["rng_state"]
        if isinstance(rng_state, list):  # json round trip
            rng_state = tuple(
                tuple(x) if isinstance(x, list) else x for x in rng_state)
        self.rng.setstate(rng_state)
        pb = state.get("pushback_ref")
        self._pushback_ref = tuple(pb) if pb is not None else None

    # ------------------------------------------------------------- pulling
    def _next_ref(self) -> tuple:
        name = self.rng.choices(self.names, weights=self.probs)[0]
        ds = self.datasets[name]
        idx = self.cursors[name]
        if idx >= len(ds):
            self.cursors[name] = 0
            self.epochs[name] += 1
            idx = 0
        self.cursors[name] = idx + 1
        return (name, idx)

    def _fetch(self, ref: tuple):
        name, idx = ref
        return self.datasets[name][idx]

    def pack_row(self) -> List[dict]:
        """One packed row: list of samples fitting the budgets."""
        row, tokens, tiles = [], 0, 0
        while True:
            if self._pushback_ref is not None:
                ref, self._pushback_ref = self._pushback_ref, None
            else:
                ref = self._next_ref()
            s = self._fetch(ref)
            n_tok = len(s["input_ids"])
            n_tile = s["pixel_values"].shape[0]
            if n_tok > self.max_tokens or n_tile > self.max_tiles_per_row:
                continue  # oversize sample: skip (budget too small for it)
            if row and (tokens + n_tok > self.max_tokens or
                        tiles + n_tile > self.max_tiles_per_row):
                self._pushback_ref = ref
                break
            row.append(s)
            tokens += n_tok
            tiles += n_tile
            if tokens >= self.max_tokens or tiles >= self.max_tiles_per_row:
                break
        return row

    def __iter__(self) -> Iterator[List[dict]]:
        while True:
            yield self.pack_row()


def zigzag_permutation(S: int, world: int) -> np.ndarray:
    idx = np.arange(S).reshape(2 * world, -1)
    out = []
    for r in range(world):
        out.append(idx[r])
        out.append(idx[2 * world - 1 - r])
    return np.concatenate(out)


def collate_rows(
    rows: List[List[dict]],
    *,
    max_tokens: int,
    max_tiles: int,
    img_context_token_id: int,
    num_image_token: int,
    loss_reduction: str = "token",
    seq_shards: int = 1,
    pixel_dtype=np.float32,
) -> Dict[str, np.ndarray]:
    """Assemble B packed rows into the static train-step batch contract.

    ``max_tiles`` is the whole-batch tile budget; missing tiles are padded
    with blank pixels + image_flags=0 (parity: pad_buffer
    dataset_packed.py:376-390 / concat across samples in
    concat_pad_data_collator pad_data_collator.py:51-117)."""
    B = len(rows)
    input_ids = np.zeros((B, max_tokens), np.int64)
    rope_pos = np.ones((B, max_tokens), np.float32)  # pad pos = 1 (reference)
    seg = np.zeros((B, max_tokens), np.int32)
    labels = np.full((B, max_tokens), IGNORE_TOKEN_ID, np.int64)
    loss_weight = np.zeros((B, max_tokens), np.float32)
    gather_idx = np.full((B, max_tokens), -1, np.int32)

    tiles = []
    tile_cursor = 0
    img_size = rows[0][0]["pixel_values"].shape[-1] if rows and rows[0] \
        else 448

    for b, row in enumerate(rows):
        cursor = 0
        for si, s in enumerate(row):
            n = len(s["input_ids"])
            sl = slice(cursor, cursor + n)
            input_ids[b, sl] = s["input_ids"]
            rope_pos[b, sl] = s["pos_ids"]
            seg[b, sl] = si + 1
            labels[b, sl] = s["labels"]
            n_eff = int((s["labels"] != IGNORE_TOKEN_ID).sum())
            loss_weight[b, sl] = len2weight(n_eff, loss_reduction)

            ctx = np.where(s["input_ids"] == img_context_token_id)[0]
            real = s["image_flags"].sum()
            if len(ctx):
                gather_idx[b, ctx + cursor] = (
                    np.arange(len(ctx)) + tile_cursor * num_image_token)
            tiles.append((s["pixel_values"], s["image_flags"]))
            tile_cursor += s["pixel_values"].shape[0]
            cursor += n

    # zero weights at ignored labels (dataset_packed.py:622)
    loss_weight[labels == IGNORE_TOKEN_ID] = 0.0

    # targets: pre-shifted next-token labels, never crossing segments
    targets = np.full((B, max_tokens), IGNORE_TOKEN_ID, np.int64)
    targets[:, :-1] = labels[:, 1:]
    same_seg = np.zeros((B, max_tokens), bool)
    same_seg[:, :-1] = (seg[:, :-1] == seg[:, 1:]) & (seg[:, :-1] != 0)
    targets[~same_seg] = IGNORE_TOKEN_ID
    tweight = np.zeros((B, max_tokens), np.float32)
    tweight[:, :-1] = loss_weight[:, 1:]
    tweight[targets == IGNORE_TOKEN_ID] = 0.0

    token_positions = np.broadcast_to(
        np.arange(max_tokens, dtype=np.int32), (B, max_tokens)).copy()

    if seq_shards > 1:
        perm = zigzag_permutation(max_tokens, seq_shards)
        for arr in (input_ids, rope_pos, seg, targets, tweight, gather_idx,
                    token_positions):
            arr[:] = arr[:, perm]

    # tile stack, padded to max_tiles
    if tiles:
        pixel = np.concatenate([t[0] for t in tiles]).astype(pixel_dtype)
        flags = np.concatenate([t[1] for t in tiles]).astype(np.int32)
    else:
        pixel = np.zeros((0, 3, img_size, img_size), pixel_dtype)
        flags = np.zeros((0,), np.int32)
    assert pixel.shape[0] <= max_tiles, (
        f"{pixel.shape[0]} tiles exceed the batch budget {max_tiles}")
    pad = max_tiles - pixel.shape[0]
    if pad:
        pixel = np.concatenate(
            [pixel, np.zeros((pad,) + pixel.shape[1:], pixel_dtype)])
        flags = np.concatenate([flags, np.zeros((pad,), np.int32)])

    stats = {
        "num_samples": sum(len(r) for r in rows),
        "num_padding_tokens": int((seg == 0).sum()),
        "num_padding_tiles": pad,
    }
    return {
        "input_ids": input_ids.astype(np.int32),
        "rope_pos_ids": rope_pos,
        "token_positions": token_positions,
        "segment_ids": seg,
        "targets": targets.astype(np.int32),
        "loss_weight": tweight,
        "pixel_values": pixel,
        "image_flags": flags,
        "vit_gather_idx": gather_idx,
        "statistics": stats,
    }
