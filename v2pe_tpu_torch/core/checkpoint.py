"""Checkpoint and resume (port of ``v2pe_tpu/core/checkpoint.py``), with
torch state dicts in place of orbax.

The layout is JAX's: ``<dir>/step_%08d/`` holds ``params.pt`` (the model's
state dict; for a LoRA run the adapters' alone, ``models/lora.py``),
``opt_state.pt`` (the optimizer state), ``data_state_p{rank}.pkl``
(each process's packed-data iterator state), ``config.json``, and
``meta.json``, the commit marker, written last. :func:`list_checkpoints`
lists only committed steps; ``save_total_limit`` keeps the newest ones.

Under a process group every rank calls save and restore. A model placed on
a mesh (``parallel/mesh.py``) is gathered whole, its optimizer moments too,
so the files hold the state dicts of the unsharded model; rank 0 writes
them once, every rank writes its own data state, and rank 0 commits after
all have. A restore reads the whole state dicts on every rank and keeps
each rank's shards, so a run saved on a mesh resumes on the same mesh (or
on any other, or on one device).
"""

from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import threading
from typing import Optional

import torch
from torch import nn


def _cpu(obj):
    """A copy of a nest of dicts / lists / tensors with every tensor on the
    CPU (the snapshot an asynchronous write works from). An offloaded
    optimizer's host moments are copied as they stand: its step returns
    only once its copies back to the host have landed
    (``train/adam8bit.py:Stager.run``)."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _like(obj, template):
    """``obj`` with each tensor moved to the device and dtype of the tensor
    at the same place in ``template`` (when there is one), and pinned where
    that tensor is (an offloaded optimizer's host moments)."""
    if torch.is_tensor(obj) and torch.is_tensor(template):
        out = obj.to(device=template.device, dtype=template.dtype)
        return out.pin_memory() if template.is_pinned() and \
            not out.is_pinned() else out
    if isinstance(obj, dict) and isinstance(template, dict):
        return {k: _like(v, template.get(k)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and isinstance(template, (list, tuple)):
        return type(obj)(_like(v, t) for v, t in zip(obj, template))
    return obj


def _state(params):
    if isinstance(params, nn.Module):
        placement = getattr(params, "placement", None)
        return placement.full_state_dict(params) if placement \
            else params.state_dict()
    return params


def _opt_state(params, opt_state):
    """The optimizer state with every moment whole (a placed model's
    shards gathered)."""
    placement = getattr(params, "placement", None)
    return placement.gather_state(params, opt_state) if placement \
        else opt_state


def _rank_world():
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def _start(path: str, data_state, cfg) -> None:
    """Rank 0 clears an uncommitted leftover and writes the config; then
    every rank writes its data state. Returns once all have."""
    rank, _ = _rank_world()
    if rank == 0:
        if os.path.isdir(path) and \
                not os.path.exists(os.path.join(path, "meta.json")):
            shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path, exist_ok=True)
        if cfg is not None:
            with open(os.path.join(path, "config.json"), "w") as f:
                f.write(cfg.to_json())
    _barrier()
    if data_state is not None:
        with open(os.path.join(path, f"data_state_p{rank}.pkl"), "wb") as f:
            pickle.dump(data_state, f)
    _barrier()


def _commit(path: str, step: int, ckpt_dir: str,
            save_total_limit: Optional[int]) -> None:
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, "num_processes": _rank_world()[1]}, f)
    if save_total_limit:
        for s in list_checkpoints(ckpt_dir)[:-save_total_limit]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)


def _write(path: str, params_sd, opt_state) -> None:
    torch.save(params_sd, os.path.join(path, "params.pt"))
    torch.save(opt_state, os.path.join(path, "opt_state.pt"))


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state,
                    data_state: Optional[dict] = None,
                    save_total_limit: Optional[int] = None,
                    cfg=None) -> str:
    """Write step ``step`` and commit it. ``params``: a model or its state
    dict. Under a process group every rank calls it."""
    path = _step_dir(ckpt_dir, step)
    params_sd, opt = _cpu(_state(params)), _cpu(_opt_state(params,
                                                            opt_state))
    _start(path, data_state, cfg)
    if _rank_world()[0] == 0:
        _write(path, params_sd, opt)
        _commit(path, step, ckpt_dir, save_total_limit)
    _barrier()
    return path


class AsyncSaver:
    """Checkpoint writer for the training loop: ``save`` returns once CPU
    copies of the parameters and optimizer state exist (so the next step
    may update them), and a background thread writes the files. The commit
    marker ``meta.json`` and the pruning wait for :meth:`finalize`, which
    joins the write; the next ``save`` and :meth:`close` call it, so a
    crash mid-write never leaves a resumable-looking step. Under a process
    group every rank calls ``save``; rank 0 writes and commits."""

    def __init__(self):
        self._pending = None
        self._error: Optional[BaseException] = None

    def save(self, ckpt_dir: str, step: int, params, opt_state,
             data_state: Optional[dict] = None,
             save_total_limit: Optional[int] = None, cfg=None) -> str:
        self.finalize()
        path = _step_dir(ckpt_dir, step)
        params_sd = _cpu(_state(params))
        opt = _cpu(_opt_state(params, opt_state))
        _start(path, data_state, cfg)
        if _rank_world()[0] != 0:
            return path

        def write():
            try:
                _write(path, params_sd, opt)
            except BaseException as e:  # re-raised by finalize
                self._error = e

        thread = threading.Thread(target=write, daemon=True)
        thread.start()
        self._pending = dict(path=path, step=step, ckpt_dir=ckpt_dir,
                             limit=save_total_limit, thread=thread)
        return path

    def finalize(self) -> Optional[str]:
        """Wait for the write in flight (if any), then commit and prune.
        Returns the committed path."""
        if self._pending is None:
            return None
        p, self._pending = self._pending, None
        p["thread"].join()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write to {p['path']} failed") \
                from err
        _commit(p["path"], p["step"], p["ckpt_dir"], p["limit"])
        return p["path"]

    def close(self) -> None:
        self.finalize()


def list_checkpoints(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    steps = list_checkpoints(ckpt_dir)
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{steps[-1]:08d}")


def restore_checkpoint(path: str, model: nn.Module, opt_state_template):
    """Load a committed step into ``model`` (in place, on its device and in
    its dtype); the optimizer state comes back on the devices and dtypes of
    ``opt_state_template``. A placed model takes its shards of the whole
    state dicts, and each rank its own data state. Returns (model,
    opt_state, step, data_state)."""
    path = os.path.abspath(path)
    sd = torch.load(os.path.join(path, "params.pt"), map_location="cpu")
    opt_state = torch.load(os.path.join(path, "opt_state.pt"),
                           map_location="cpu")
    placement = getattr(model, "placement", None)
    if placement is not None:
        placement.load_full_state_dict(model, sd)
        opt_state = placement.shard_state(model, opt_state)
    else:
        model.load_state_dict(sd)
    opt_state = _like(opt_state, opt_state_template)
    with open(os.path.join(path, "meta.json")) as f:
        step = json.load(f)["step"]
    data_state = None
    ds_path = os.path.join(path, f"data_state_p{_rank_world()[0]}.pkl")
    if os.path.exists(ds_path):
        with open(ds_path, "rb") as f:
            data_state = pickle.load(f)
    return model, opt_state, step, data_state
