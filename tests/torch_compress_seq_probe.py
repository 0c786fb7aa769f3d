"""What the JAX package's compress-seq step does under a ``seq`` mesh.

Runs JAX's compress train step (fuse 'add', 4 chunks, the model of
``test_compress_train_step_sharded_matches_single`` in
``tests/test_compress_seq.py``) in one process on 8 forced CPU devices, on the natural batch and on the
zigzag-permuted one that the trainer collates for ``seq`` = 2
(``collate_rows(seq_shards=2)``, ``make_synthetic_batch(seq_shards=2)``),
unsharded and under ``MeshConfig(seq=2)``, at learning rate 0; prints each
run's loss and grad norm:

    python -m tests.torch_compress_seq_probe

Under ``seq`` = 2 JAX gives its one-device step on whatever array it is
handed (GSPMD does not split the chunks): on the zigzag batch that is a
step over other chunks than on the natural one, so the trainer's ``seq``
run is not the ``seq`` = 1 step of the same samples; the loss agrees only
because random weights put it at ln(vocab). Not a tier-1 test (about a
minute of XLA compiles).
"""

from __future__ import annotations

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from v2pe_tpu.core.config import (LLMConfig, MeshConfig, VLMConfig,  # noqa
                                  VisionConfig)
from v2pe_tpu.models.compress_seq import init_compress_params  # noqa: E402
from v2pe_tpu.models.params import init_vlm_params  # noqa: E402
from v2pe_tpu.parallel.mesh import make_mesh  # noqa: E402
from v2pe_tpu.train.optimizer import TrainConfig, build_optimizer  # noqa
from v2pe_tpu.train.synth import IMG_CONTEXT_ID, make_synthetic_batch  # noqa
from v2pe_tpu.train.train_step import make_train_step, shard_params  # noqa

CFG = VLMConfig(
    vision=VisionConfig(hidden_size=32, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=2,
                        image_size=112, patch_size=14),
    llm=LLMConfig(vocab_size=92553, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2),
    compress_seq=True, fuse_method="add", chunk_num=4)


def step(mesh_cfg=None, seq_shards=1) -> dict:
    params = init_vlm_params(jax.random.PRNGKey(0), CFG)
    params["compress"] = init_compress_params(params["llm"], cfg=CFG.llm)
    tx = build_optimizer(TrainConfig(learning_rate=0.0, warmup_steps=0,
                                     total_steps=10), params)
    batch = make_synthetic_batch(CFG, 2, 256, tiles_per_row=1,
                                 seq_shards=seq_shards)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = make_mesh(mesh_cfg) if mesh_cfg else None
    if mesh is not None:
        params = shard_params(params, mesh)
    fn = make_train_step(CFG, tx, mesh, IMG_CONTEXT_ID, attn_impl="jnp",
                         remat=False, donate=False)
    _, _, m = fn(params, tx.init(params), batch)
    return {k: float(v) for k, v in m.items()}


def main():
    for name, mesh, shards in (
            ("one device, natural batch", None, 1),
            ("one device, zigzag batch", None, 2),
            ("seq=2, zigzag batch (the trainer's)", MeshConfig(seq=2), 2),
            ("seq=2, natural batch", MeshConfig(seq=2), 1)):
        print(f"{name}: {step(mesh, shards)}", flush=True)


if __name__ == "__main__":
    main()
