"""Supervised multimodal datasets (host side).

Behavior parity with ``LazySupervisedDataset``
(``internvl/train/internvl_chat_finetune.py:322-953``) redesigned host-side:

* jsonl-backed lazy loading with the same meta-file format
  (``{ds_name: {root, annotation, data_augment, repeat_time,
  [max_dynamic_patch]}}``, consumed like build_datasets :956-1056);
* item routing: single-image / multi-image (per-image tile budget
  ``max_dynamic_patch // num_image`` when dynamic_max_patch, :627-714) /
  video (Frame{i} prompt rewrite, :771-773) / pure text (blank 448 tile with
  image_flags=0, :815-860);
* ``repeat_time`` over/under-sampling (:412-416), rank sharding
  (lines[rank::world] equivalent via contiguous slices :397-438),
  retry-with-random-resample on corrupt samples (max 10, :874-917);
* V2PE position ids attached per item (float32).

Unlike the reference there is no CUDA/N CCL coupling: every sample is pure
numpy, ready for static-shape packing (data/packing.py)."""

from __future__ import annotations

import io
import json
import logging
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from v2pe_tpu_torch.data.constants import IGNORE_TOKEN_ID
from v2pe_tpu_torch.data.preprocess import get_preprocess_function
from v2pe_tpu_torch.data.tiling import dynamic_preprocess
from v2pe_tpu_torch.data.transforms import build_transform
from v2pe_tpu_torch.positional import build_v2pe_pos_ids

logger = logging.getLogger(__name__)


def load_image(path: str):
    from PIL import Image

    from v2pe_tpu_torch.data import object_store

    if object_store.is_remote(path):
        img = Image.open(object_store.open_blob(path))
    else:
        img = Image.open(path)
    img.load()
    return img.convert("RGB")


def read_video_frames(path: str, num_frames: int, sample: str = "rand",
                      rng: Optional[random.Random] = None) -> List:
    """Frame extraction without decord (absent on this image): cv2 for video
    files, imageio for GIFs. Parity with get_frame_indices/read_frames_*
    (dataset.py:35-197): 'rand' samples one frame per equal interval,
    'middle' takes interval midpoints, 'fpsX.Y' samples sequentially at X.Y
    frames/sec of wall time (dataset.py:61-71; the real stream fps comes
    from the container), truncated at num_frames."""
    from PIL import Image

    from v2pe_tpu_torch.data import object_store

    src = path
    path = object_store.localize(path)  # cv2/imageio need a real file
    try:
        rng = rng or random
        ext = os.path.splitext(path)[1].lower()
        if ext == ".gif":
            import imageio

            gif = imageio.get_reader(path)
            vlen = gif.get_length()
            # the reference's GIF reader passes no input_fps
            # (dataset.py:189); fps mode therefore treats GIFs as 1 fps
            idx_list = list(_frame_indices(vlen, num_frames, sample, rng))
            needed = set(idx_list)
            got = {}
            for i, frame in enumerate(gif):
                if i in needed:
                    got[i] = Image.fromarray(frame[..., :3]).convert("RGB")
            # assemble in sampled order, PRESERVING duplicates (fps mode
            # repeats indices when the output rate exceeds the stream fps)
            return [got[i] for i in idx_list if i in got]
        import cv2

        cap = cv2.VideoCapture(path)
        vlen = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        input_fps = float(cap.get(cv2.CAP_PROP_FPS)) or 1.0
        idx_list = list(_frame_indices(vlen, num_frames, sample, rng,
                                       input_fps=input_fps))
        needed = set(idx_list)
        got = {}
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if i in needed:
                got[i] = Image.fromarray(frame[:, :, ::-1])
            i += 1
        cap.release()
        # sampled order with duplicates kept (fps mode repeats frames to
        # hold the requested output rate on low-fps inputs, dataset.py:61-71)
        return [got[i] for i in idx_list if i in got]
    finally:
        if path != src:
            # localize() downloaded a remote blob to a temp file — clean it
            # up, or a long eval over gs://-hosted videos fills the disk
            try:
                os.unlink(path)
            except OSError:
                pass


def _frame_indices(vlen: int, num_frames: int, sample: str, rng,
                   input_fps: float = 1.0) -> List[int]:
    if sample.startswith("fps"):
        # sequential sampling at output_fps frames per second of wall time,
        # midpoints of 1/output_fps-second clips (dataset.py:61-71);
        # num_frames acts as the reference's max_num_frames truncation
        output_fps = float(sample[3:])
        duration = float(vlen) / input_fps
        delta = 1.0 / output_fps
        seconds = np.arange(delta / 2, duration + delta / 2, delta)
        idxs = np.around(seconds * input_fps).astype(int)
        idxs = [int(e) for e in idxs if e < vlen]
        if num_frames > 0 and len(idxs) > num_frames:
            idxs = idxs[:num_frames]
        return idxs
    num_frames = min(num_frames, max(vlen, 1))
    intervals = np.linspace(0, vlen, num_frames + 1).astype(int)
    ranges = [(intervals[i], max(intervals[i] + 1, intervals[i + 1]))
              for i in range(num_frames)]
    if sample == "rand":
        return [rng.randrange(lo, hi) for lo, hi in ranges]
    return [(lo + hi) // 2 for lo, hi in ranges]


class SupervisedDataset:
    """One jsonl dataset. __getitem__ returns a packing-ready sample dict:
    input_ids/labels (int64 1-D), pos_ids (float32 1-D), pixel_values
    (n_tiles, 3, S, S) float32, image_flags (n_tiles,), num_tiles list."""

    def __init__(
        self,
        meta: dict,
        tokenizer,
        *,
        ds_name: str = "dataset",
        template_name: str = "internlm2-chat",
        num_image_token: int = 256,
        image_size: int = 448,
        is_train: bool = True,
        pad2square: bool = False,
        normalize_type: str = "imagenet",
        dynamic_image_size: bool = True,
        use_thumbnail: bool = True,
        min_dynamic_patch: int = 1,
        max_dynamic_patch: int = 12,
        dynamic_max_patch: bool = False,
        min_num_frame: int = 8,
        max_num_frame: int = 32,
        sampling_method: str = "rand",
        rope_pos_id_version: str = "v2pe_fix",
        rope_pos_id_stride: Optional[int] = 64,
        data_rank: int = 0,
        data_world_size: int = 1,
        repeat_time: float = 1.0,
        max_retries: int = 10,
        seed: int = 42,
        img_start_id: Optional[int] = None,
        img_end_id: Optional[int] = None,
    ):
        self.meta = meta
        self.tokenizer = tokenizer
        self.ds_name = ds_name
        self.template_name = template_name
        self.num_image_token = num_image_token
        self.image_size = image_size
        self.is_train = is_train
        self.dynamic_image_size = dynamic_image_size
        self.use_thumbnail = use_thumbnail
        self.min_dynamic_patch = min_dynamic_patch
        self.max_dynamic_patch = int(meta.get("max_dynamic_patch",
                                              max_dynamic_patch))
        self.dynamic_max_patch = dynamic_max_patch
        self.min_num_frame = min_num_frame
        self.max_num_frame = max_num_frame
        self.sampling_method = sampling_method
        self.rope_pos_id_version = rope_pos_id_version
        self.rope_pos_id_stride = rope_pos_id_stride
        self.max_retries = max_retries
        self.rng = random.Random(seed + data_rank)

        self.root = meta.get("root", "") or ""
        if self.root and not self.root.endswith("/"):
            self.root += "/"
        self._augment = is_train and bool(meta.get("data_augment", False))
        self.transform = build_transform(
            is_train=self._augment,
            input_size=image_size, pad2square=pad2square,
            normalize_type=normalize_type, rng=self.rng)
        # the native C++ tile path matches PIL bit-for-bit but skips jpeg
        # augmentation / pad2square / non-imagenet norms
        self._native_ok = False
        if not self._augment and not pad2square \
                and normalize_type == "imagenet":
            try:
                from v2pe_tpu_torch import native

                self._native_ok = native.available()
            except Exception:
                self._native_ok = False

        ann = meta["annotation"]
        with open(ann) as f:
            lines = f.readlines()
        # repeat_time over/under-sampling (:412-416)
        if repeat_time < 1:
            lines = self.rng.sample(lines, int(len(lines) * repeat_time))
        elif repeat_time > 1:
            whole = int(repeat_time)
            frac = repeat_time - whole
            lines = lines * whole + self.rng.sample(
                lines, int(len(lines) * frac))
        # rank sharding: contiguous slices like the cached split (:397-438)
        if data_world_size > 1:
            per = len(lines) // data_world_size
            start = per * data_rank
            end = per * (data_rank + 1) if data_rank < data_world_size - 1 \
                else len(lines)
            lines = lines[start:end]
        self.lines = lines

        self.img_start_id = (img_start_id if img_start_id is not None
                             else tokenizer.convert_tokens_to_ids("<img>"))
        self.img_end_id = (img_end_id if img_end_id is not None
                           else tokenizer.convert_tokens_to_ids("</img>"))

    def __len__(self):
        return len(self.lines)

    # ------------------------------------------------------------------
    def _encode(self, data_item: dict, pixel_values: np.ndarray,
                num_tiles: List[int], text_only: bool = False):
        n_img = len(num_tiles) if not text_only else 1
        token_list = [self.num_image_token * nt for nt in num_tiles] or \
            [self.num_image_token]
        # template → masking routine (internvl_chat_finetune.py:520-527)
        preprocess_fn = get_preprocess_function(self.template_name)
        ret = preprocess_fn(
            self.template_name, [data_item["conversations"]],
            self.tokenizer, token_list,
            text_only=text_only, ds_name=self.ds_name, num_image=n_img)
        ids = ret["input_ids"][0]
        labels = ret["labels"][0]
        mask = ret["attention_mask"][0]

        if text_only:
            pos_ids = np.cumsum(mask) - 1.0
            pos_ids = pos_ids.astype(np.float32)
        else:
            version = self.rope_pos_id_version
            pos_ids = build_v2pe_pos_ids(
                ids, mask, num_tiles,
                img_start_id=self.img_start_id, img_end_id=self.img_end_id,
                num_image_token=self.num_image_token,
                version=version, stride=self.rope_pos_id_stride,
                rng=self.rng)
            if version == "default":
                pos_ids = pos_ids.astype(np.float32)

        return {
            "input_ids": ids,
            "labels": labels,
            "pos_ids": pos_ids,
            "pixel_values": pixel_values,
            "num_tiles": list(num_tiles),
            "image_flags": np.ones((pixel_values.shape[0],), np.int64)
            if not text_only else np.zeros((pixel_values.shape[0],), np.int64),
        }

    def _tile_and_transform(self, images: List, max_patch: int):
        # native C++ fast path (bit-identical to the PIL pipeline) when no
        # train-time jpeg augmentation is active
        if self._native_ok and self.dynamic_image_size:
            from v2pe_tpu_torch.data.constants import IMAGENET_MEAN, IMAGENET_STD
            from v2pe_tpu_torch.data.tiling import plan_tiles

            pixels, num_tiles = [], []
            for img in images:
                arr = np.asarray(img.convert("RGB"))
                gw, gh, n, _ = plan_tiles(
                    arr.shape[1], arr.shape[0],
                    min_num=self.min_dynamic_patch, max_num=max_patch,
                    image_size=self.image_size,
                    use_thumbnail=self.use_thumbnail)
                from v2pe_tpu_torch import native

                pixels.append(native.tile_resize_normalize(
                    arr, gw, gh, self.image_size, self.use_thumbnail,
                    IMAGENET_MEAN, IMAGENET_STD))
                num_tiles.append(n)
            return np.concatenate(pixels), num_tiles

        tiles, num_tiles = [], []
        for img in images:
            if self.dynamic_image_size:
                t = dynamic_preprocess(
                    img, min_num=self.min_dynamic_patch, max_num=max_patch,
                    image_size=self.image_size,
                    use_thumbnail=self.use_thumbnail)
            else:
                t = [img]
            tiles.extend(t)
            num_tiles.append(len(t))
        pixel = np.stack([self.transform(t) for t in tiles])
        return pixel, num_tiles

    def multi_modal_get_item(self, item: dict):
        conv0 = item["conversations"][0]["value"]
        if "<image>" not in conv0:
            item["conversations"][0]["value"] = "<image>\n" + conv0
        img = load_image(self.root + item["image"])
        pixel, num_tiles = self._tile_and_transform([img],
                                                    self.max_dynamic_patch)
        return self._encode(item, pixel, num_tiles)

    def multi_modal_multi_image_get_item(self, item: dict):
        images = [load_image(self.root + p) for p in item["image"]]
        max_patch = self.max_dynamic_patch
        if self.dynamic_max_patch and len(images) > 1:
            max_patch = max(1, self.max_dynamic_patch // len(images))
        pixel, num_tiles = self._tile_and_transform(images, max_patch)
        return self._encode(item, pixel, num_tiles)

    def video_get_item(self, item: dict):
        n_frames = self.rng.randint(self.min_num_frame, self.max_num_frame)
        frames = read_video_frames(self.root + item["video"], n_frames,
                                   self.sampling_method, self.rng)
        # Frame{i}: <image> prompt rewrite (:771-773)
        special = "".join(f"Frame{i + 1}: <image>\n"
                          for i in range(len(frames)))
        conv0 = item["conversations"][0]
        conv0["value"] = conv0["value"].replace("<video>\n", special)
        pixel, num_tiles = self._tile_and_transform(frames, 1)
        return self._encode(item, pixel, num_tiles)

    def pure_text_get_item(self, item: dict):
        # blank tile with image_flags=0 so the ViT still sees one tile
        # (keeps shapes static; parity with :815-860)
        blank = np.zeros((1, 3, self.image_size, self.image_size), np.float32)
        return self._encode(item, blank, [1], text_only=True)

    def get(self, idx: int):
        item = json.loads(self.lines[idx])
        if "image" in item and item["image"]:
            if isinstance(item["image"], (list, tuple)):
                return self.multi_modal_multi_image_get_item(item)
            return self.multi_modal_get_item(item)
        if "video" in item and item["video"]:
            return self.video_get_item(item)
        return self.pure_text_get_item(item)

    def __getitem__(self, idx: int):
        for attempt in range(self.max_retries):
            try:
                return self.get(idx)
            except Exception as e:  # retry with random resample (:874-917)
                logger.warning("sample %d of %s failed (%s); resampling",
                               idx, self.ds_name, e)
                idx = self.rng.randrange(len(self))
        raise RuntimeError(
            f"{self.ds_name}: {self.max_retries} consecutive bad samples")


def build_datasets(meta_path: str, tokenizer, **kwargs
                   ) -> Dict[str, SupervisedDataset]:
    """Meta-file format parity (shell/data/*.json; build_datasets
    :956-1056)."""
    with open(meta_path) as f:
        metas = json.load(f)
    out = {}
    for name, meta in metas.items():
        out[name] = SupervisedDataset(
            meta, tokenizer, ds_name=name,
            repeat_time=float(meta.get("repeat_time", 1.0)), **kwargs)
    return out
