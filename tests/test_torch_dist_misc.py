"""The port's bootstrap and what runs beside the train step across
processes (gloo on the CPU): launcher detection against the JAX package's,
Ulysses over ``all_to_all``, a checkpoint saved and resumed at
``fsdp = 2``, and what a mesh refuses."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.parallel import bootstrap as jboot
from v2pe_tpu.train import synth as jsynth
from v2pe_tpu_torch.core import config as tconfig
from v2pe_tpu_torch.parallel import bootstrap as tboot
from v2pe_tpu_torch.parallel import context as tctx

from .test_torch_dist_mesh import TC, global_batches, tiny_cfg
from .torch_dist import Run, np_tree
from .torch_parity import port_config

# ------------------------------------------------------------ the bootstrap

LAUNCHERS = {
    "env": {"V2PE_NUM_PROCESSES": "4", "V2PE_PROCESS_ID": "2",
            "V2PE_COORDINATOR": "10.0.0.1:1234"},
    "slurm": {"SLURM_PROCID": "3", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
              "SLURM_STEP_NODELIST": "gpu[07-09,12],login"},
    "mpi": {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "2",
            "OMPI_COMM_WORLD_LOCAL_RANK": "1"},
    "torchrun": {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
                 "MASTER_ADDR": "node0", "MASTER_PORT": "29500"},
    "none": {},
}
WATCHED = {k for env in LAUNCHERS.values() for k in env} | {
    "SLURM_NODELIST", "LOCAL_RANK", "TPU_WORKER_HOSTNAMES",
    "MEGASCALE_COORDINATOR_ADDRESS"}


@pytest.mark.parametrize("launcher", list(LAUNCHERS))
def test_detect_env_reads_each_launcher_as_jax_does(monkeypatch, launcher):
    """The JAX package's order and fields for env / SLURM / OpenMPI /
    none; torchrun's own variables where JAX autodetects a TPU pod."""
    for k in WATCHED:
        monkeypatch.delenv(k, raising=False)
    for k, v in LAUNCHERS[launcher].items():
        monkeypatch.setenv(k, v)
    got = tboot.detect_env(coordinator_port=8476)
    assert got.launcher == launcher
    if launcher == "torchrun":
        assert (got.process_id, got.num_processes, got.coordinator,
                got.local_rank) == (5, 8, "node0:29500", 1)
        return
    want = jboot.detect_env(coordinator_port=8476)
    assert (got.launcher, got.process_id, got.num_processes,
            got.coordinator) == (want.launcher, want.process_id,
                                 want.num_processes, want.coordinator)
    assert got.local_rank == {"env": 2, "slurm": 1, "mpi": 1,
                              "none": 0}[launcher]
    if launcher == "slurm":
        assert got.coordinator == "gpu07:8476"


@pytest.mark.parametrize("nodelist", ["node[3-5,9],other", "single",
                                      "a1,b2", "gpu[12]"])
def test_first_slurm_node_as_jax(nodelist):
    assert tboot._first_slurm_node(nodelist) == \
        jboot._first_slurm_node(nodelist)


def test_one_process_without_a_group_starts_none(monkeypatch):
    for k in WATCHED:
        monkeypatch.delenv(k, raising=False)
    env = tboot.initialize_distributed(device="cpu")
    assert env.launcher == "none" and tboot.world_size() == 1
    assert tboot._init_url("h:1") == "tcp://h:1"
    assert tboot._init_url("file:///x/store") == "file:///x/store"


def test_rows_of_global_batch_undo_jax_concatenation():
    """Coordinate i of 2 gets rows i, its tiles, and gather indices into
    its own tile stack; the (B, S) keys of its seq shard follow."""
    cfg = tiny_cfg()
    (b,) = global_batches(cfg, n=1)
    halves = [tboot.rows_of_global_batch(b, i, 2, cfg.num_image_token)
              for i in range(2)]
    for i, h in enumerate(halves):
        np.testing.assert_array_equal(h["input_ids"], b["input_ids"][i:i + 1])
        np.testing.assert_array_equal(h["pixel_values"],
                                      b["pixel_values"][i:i + 1])
        idx = h["vit_gather_idx"]
        assert idx.max() == cfg.num_image_token - 1 and idx.min() == -1
    with pytest.raises(ValueError, match="sharding contract"):
        tboot.rows_of_global_batch(dict(b, extra=b["input_ids"]), 0, 2, 4)


# -------------------------------------------------- refused in one process


def test_a_mesh_above_one_never_runs_as_one_process():
    """Without a process group only the seq axis may exceed 1 (its shards
    on the one card); every other mesh raises, and so does pipe."""
    for axes in (dict(data=2), dict(fsdp=2), dict(tensor=2),
                 dict(fsdp=2, seq=2), dict(pipe=2)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            tctx.ShardingContext.from_mesh(tconfig.MeshConfig(**axes))
    ctx = tctx.ShardingContext.from_mesh(tconfig.MeshConfig(seq=4))
    assert (ctx.seq_shards, ctx.mesh, ctx.size("seq"), ctx.dp_size) == \
        (4, None, 1, 1)


# ------------------------------------------- across processes (one spawn)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worker runs, started together: two processes (Ulysses, the
    refusals, a save and resume at fsdp 2), and four (the ring across them,
    two steps on data = 4 with DropPath at rate 0.1 from the trainer's
    generator on 4-row batches)."""
    cfg = tiny_cfg()
    tree = np_tree(jax_init(jax.random.PRNGKey(0), cfg))
    spec = dict(cfg=port_config(cfg).to_json(), tree=tree,
                img_context_id=jsynth.IMG_CONTEXT_ID)
    root = tmp_path_factory.mktemp("dist_misc")
    two = Run(dict(spec, batches=global_batches(cfg),
                   tasks=[dict(kind="ulysses"), dict(kind="refusals"),
                          dict(kind="resume", mesh=dict(fsdp=2), tc=TC,
                               dir=str(root / "ckpt"))]), 2, root)
    batches = [_stack(global_batches(cfg, n=2, seed=2 * i))
               for i in range(2)]
    four = Run(dict(spec, batches=batches, tasks=[
        dict(kind="ring"), dict(kind="train", mesh=dict(data=4), tc=TC,
                                drop_path_rate=0.1),
        dict(kind="drop_path", mesh=dict(data=4))]),
        4, tmp_path_factory.mktemp("four_ranks"))
    return dict(two=two, four=(four, cfg, tree, batches))


@pytest.fixture(scope="module")
def worker_run(runs):
    return runs["two"]


@pytest.fixture(scope="module")
def four_ranks(runs):
    return runs["four"]


def _stack(parts):
    """Global batches one after the other: the rows of both, their tiles,
    the second's gather indices past the first's tiles."""
    out = {}
    n_vit = parts[0]["pixel_values"].shape[0] * 4  # 4 image tokens a tile
    for k in parts[0]:
        vs = [p[k] for p in parts]
        if k == "vit_gather_idx":
            vs = [vs[0], np.where(vs[1] >= 0, vs[1] + n_vit, vs[1])]
        out[k] = np.concatenate(vs, axis=0)
    return out


def test_scan_ring_across_four_processes_equals_the_one_card_ring(
        four_ranks):
    """Each hop's chunk by P2P, the (dk, dv) accumulators round the ring in
    the backward: the same flash calls in the same order as the one-card
    ring, so the same outputs and gradients."""
    errors = four_ranks[0].result()[0]["errors"]
    assert max(errors) <= 1e-6, errors


def test_train_steps_on_data4_with_drop_path_equal_one_process(four_ranks):
    """Two steps on data = 4 (one row a rank, unequal weights) with
    DropPath from the trainer's generator equal the port's steps in one
    process on the combined batch (JAX draws other masks)."""
    import dataclasses

    import torch

    from v2pe_tpu_torch.models.params import from_jax_params
    from v2pe_tpu_torch.train import optimizer as topt
    from v2pe_tpu_torch.train import train_step as tstep
    from v2pe_tpu_torch.train.trainer import _dp_generator

    run, cfg, tree, batches = four_ranks
    pc = port_config(cfg)
    pc = dataclasses.replace(pc, vision=dataclasses.replace(
        pc.vision, drop_path_rate=0.1))

    def one_process(drop_path: bool):  # noqa: FBT001
        model = from_jax_params(tree, pc)
        opt = topt.build_optimizer(topt.TrainConfig(**TC), model, pc)
        state = opt.init()
        step = tstep.make_train_step(
            pc, opt, img_context_token_id=jsynth.IMG_CONTEXT_ID,
            remat="full")
        out = [step(model, state, {k: torch.from_numpy(v)
                                   for k, v in b.items()},
                    _dp_generator(0, i, "cpu") if drop_path else None)
               for i, b in enumerate(batches)]
        return out, {n: p.detach().numpy()
                     for n, p in model.named_parameters()}

    want, want_params = one_process(True)
    got = run.result()[1]
    np.testing.assert_allclose(got["loss"], [float(w[0]) for w in want],
                               rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], [float(w[1]) for w in want],
                               rtol=1e-5)
    for n, p in want_params.items():
        np.testing.assert_allclose(got["params"][n], p, rtol=0, atol=2e-5,
                                   err_msg=n)


def test_drop_path_rows_of_the_global_batch_under_data4(four_ranks):
    """Each rank draws the global batch's DropPath masks from the step's
    generator and keeps its own tiles' rows: the ViT features of the four
    ranks' tiles, gathered, are those of one process on all the tiles with
    the same generator, and not those without DropPath."""
    import dataclasses

    import torch

    from v2pe_tpu_torch.models.internvl_chat import extract_feature
    from v2pe_tpu_torch.models.params import from_jax_params
    from v2pe_tpu_torch.train.trainer import _dp_generator

    run, cfg, tree, batches = four_ranks
    pc = port_config(cfg)
    pc = dataclasses.replace(pc, vision=dataclasses.replace(
        pc.vision, drop_path_rate=0.1))
    model = from_jax_params(tree, pc)
    pixels = torch.from_numpy(batches[0]["pixel_values"])
    with torch.no_grad():
        want = extract_feature(model, pc, pixels,
                               drop_path_generator=_dp_generator(0, 0, "cpu"))
        plain = extract_feature(model, pc, pixels)
    got = run.result()[2]["features"]
    # the residual stream dwarfs the branches of a random tiny ViT: a mask
    # moves the features by ~1e-5, so the limit is far below that
    near = np.abs(got - want.numpy()).max()
    off = np.abs(got - plain.numpy()).max()
    assert near <= 5e-7 and off >= 5e-6, (near, off)


def test_ulysses_all_to_all_across_two_processes_equals_one(worker_run):
    """Each rank's output rows and its shards' gradients equal the world-1
    form on the whole tensors (the same flash calls, so exactly)."""
    errors = worker_run.result()[0]["errors"]
    assert max(errors) <= 1e-6, errors


def test_what_a_mesh_of_processes_refuses(worker_run):
    """A mesh that does not match the world and compress-seq over seq or
    under pipe raise ``NotImplementedError`` naming their ROADMAP entry;
    seq with pipe raises JAX's ``ValueError``. The pipe axis and the fused
    ring across ranks are taken."""
    got = worker_run.result()[1]
    for what in ("mismatched world", "compress-seq under pipe",
                 "compress-seq over seq"):
        assert got[what] is not None, what
        assert got[what][0] == "NotImplementedError", (what, got[what])
    assert got["pipe with seq"][0] == "ValueError"
    assert "seq must be 1" in got["pipe with seq"][1]
    assert "Known faults inside the reference" in \
        got["compress-seq under pipe"][1]
    assert "Queue 1 item 6.4" in got["compress-seq over seq"][1]
    assert got["accepted"] == {
        "pipe": (2, 2, got["accepted"]["pipe"][2],
                 ("pipe", "data", "fsdp", "seq", "tensor")),
        "fused ring across ranks": ("fused", 2)}


def test_save_and_resume_at_fsdp2_continues_as_an_unbroken_run(worker_run):
    """Rank 0 writes the whole state dicts once, each rank its data state;
    a fresh placed model restored from them takes the next step to the
    unbroken run's loss."""
    got = worker_run.result()[2]
    assert got["resumed"] == got["unbroken"]
    assert got["step"] == 1 and got["data_state"] == {"rank": 0}
    assert got["files"] == ["data_state_p0.pkl", "data_state_p1.pkl",
                            "meta.json", "opt_state.pt", "params.pt"]
    assert got["params"]["llm.output.weight"].shape == (92553, 64)
