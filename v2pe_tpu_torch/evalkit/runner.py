"""Generic benchmark runner.

The shared skeleton of every reference eval script (SURVEY.md §2.8): shard
questions across workers (``lines[rank::world]``), per-sample inference,
per-rank jsonl outputs with **resume via answered-id skip sets**
(eval_mm_niah_long.py:180-186), an error guard with early stop after N
consecutive failures (the OOM counter analogue, :204-224), and a rank-0
merge + scorer step."""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Iterable, List, Optional

logger = logging.getLogger(__name__)


def shard_items(items: List, rank: int, world: int) -> List:
    return items[rank::world]


def load_answered_ids(out_path: str, id_key: str = "id") -> set:
    done = set()
    if os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)[id_key])
                except Exception:
                    continue
    return done


def run_shard(
    items: Iterable[dict],
    infer_fn: Callable[[dict], dict],
    out_path: str,
    *,
    id_key: str = "id",
    rank: int = 0,
    world: int = 1,
    max_consecutive_failures: int = 20,
    resume: bool = True,
    workers: int = 1,
) -> int:
    """Run ``infer_fn`` over this worker's shard, appending jsonl results.

    infer_fn(item) -> result dict (must include id_key). Returns the number
    of newly answered items.

    ``workers > 1`` runs infer_fn from a thread pool — pair it with an
    engine-backed model (``serve.engine.EngineChat``) so concurrent chat
    calls batch into one continuous decode program. Results append in
    completion order (the rank-0 merge de-dups by id, order-agnostic);
    the failure early-stop counts a consecutive-failure streak across
    completion order."""
    items = shard_items(list(items), rank, world)
    done = load_answered_ids(out_path, id_key) if resume else set()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    todo = [it for it in items if it[id_key] not in done]

    n_new, fails = 0, 0
    with open(out_path, "a") as f:

        def _write(result):
            f.write(json.dumps(result, ensure_ascii=False) + "\n")
            f.flush()

        if workers <= 1:
            for item in todo:
                try:
                    result = infer_fn(item)
                    fails = 0
                except Exception as e:
                    fails += 1
                    logger.warning("sample %s failed: %s (%d consecutive)",
                                   item.get(id_key), e, fails)
                    if fails >= max_consecutive_failures:
                        logger.error(
                            "early stop after %d consecutive failures",
                            fails)
                        break
                    continue
                _write(result)
                n_new += 1
            return n_new

        from concurrent.futures import (FIRST_COMPLETED, ThreadPoolExecutor,
                                        wait as futures_wait)

        # bounded in-flight set, refilled as futures complete — a wave
        # barrier here would drain the engine's batch to a shrinking tail
        # at every boundary, wasting exactly the throughput workers buy
        stop = False
        with ThreadPoolExecutor(max_workers=workers) as pool:
            pending = iter(todo)
            inflight = {}

            def refill():
                while len(inflight) < workers:
                    try:
                        item = next(pending)
                    except StopIteration:
                        return
                    inflight[pool.submit(infer_fn, item)] = item

            refill()
            while inflight and not stop:
                done, _ = futures_wait(list(inflight),
                                       return_when=FIRST_COMPLETED)
                for fut in done:
                    item = inflight.pop(fut)
                    try:
                        result = fut.result()
                        fails = 0
                    except Exception as e:
                        fails += 1
                        logger.warning(
                            "sample %s failed: %s (%d consecutive)",
                            item.get(id_key), e, fails)
                        if fails >= max_consecutive_failures:
                            logger.error("early stop after %d consecutive "
                                         "failures", fails)
                            stop = True
                            break
                        continue
                    _write(result)
                    n_new += 1
                if not stop:
                    refill()
    return n_new


def merge_shards(shard_paths: List[str], merged_path: str,
                 id_key: str = "id") -> List[dict]:
    """Rank-0 merge with de-dup (the reference cats per-rank jsonls)."""
    seen, out = set(), []
    for p in shard_paths:
        if not os.path.exists(p):
            continue
        with open(p) as f:
            for line in f:
                try:
                    d = json.loads(line)
                except Exception:
                    continue
                if d[id_key] in seen:
                    continue
                seen.add(d[id_key])
                out.append(d)
    with open(merged_path, "w") as f:
        for d in out:
            f.write(json.dumps(d, ensure_ascii=False) + "\n")
    return out
