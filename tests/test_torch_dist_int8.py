"""int8 Adam over sharded leaves, across processes (gloo on the CPU),
against JAX's int8 Adam in one process.

At these widths the 256-value blocks of JAX's flat leaves cross rows and
shards almost everywhere (D 32; the 92,553-entry vocab, which 256 does
not divide), so the cut blocks meet across ranks; the FFN width of 1024
leaves ``w1`` / ``w3`` rows of whole blocks on every rank at fsdp 2 and at
fsdp 2 x tensor 2, so those update alone. Two spawns: fsdp 2 (2 processes)
and fsdp 2 x tensor 2 (4), each first fed JAX's own gradients, then taking
train steps, and the second a save and resume.

Tolerances. Fed the same gradients, the shards' state gathered equals
the port's one-device state bit for bit (codes and scales), and the
parameters JAX's within 1e-6. Against JAX's state: scales within the few
fp32 ulps of ``tests/test_torch_train.py`` (XLA fuses the moment update
into an FMA); a code whose value sat on a rounding tie may then land one
step away, which the port's one-device chain shows at these widths too
(about 1 value in 10^6 after three steps), so codes are held within 1 and
at most 1 in 10^5 of them off. Train steps as in
``tests/test_torch_dist_mesh.py`` (loss and grad norm 1e-5 relative,
parameters 2e-5); their gradients are sums in another order, so codes on
a tie move more often: the port's one-device step lands 230 of these
12.5 M codes one step from JAX's, so at most 5 in 10^5 may be.
"""

from __future__ import annotations

import jax
import numpy as np
import optax
import pytest

from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.train import optimizer as jopt
from v2pe_tpu.train import synth as jsynth
from v2pe_tpu.train import train_step as jstep
from v2pe_tpu_torch.models.params import _jax_state_dict

from .test_torch_dist_mesh import TC, check_against_jax, global_batches, \
    tiny_cfg
from .test_torch_train import _opt_state_moments
from .torch_dist import Run, np_tree
from .torch_parity import port_config

MESHES = {"fsdp2": dict(fsdp=2), "fsdp2_tensor2": dict(fsdp=2, tensor=2)}
INT8 = dict(TC, use_8bit_optimizer=True)
# fed gradients: small enough that the clip stays off (so that two sums of
# squares in other orders cannot move a rounding boundary), a warmup step
OPT_TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              use_8bit_optimizer=True)
OPT_STEPS = 3


def cfg_int8():
    return tiny_cfg(hidden_size=32, intermediate_size=1024)


def jax_int8_state(state, keys):
    """JAX's int8 moments as the port's ``moments`` dict: key -> codes
    (flat, JAX order) and scales."""
    mu, nu = _opt_state_moments(state)
    out = {}
    for key in keys:
        node_m, node_v = mu, nu
        for k in key.split("/"):
            node_m, node_v = node_m[k], node_v[k]
        out[key] = {f"{t}_{f}": np.asarray(getattr(q, f)).reshape(-1)
                    if f == "code" else np.asarray(q.scale)
                    for t, q in (("m", node_m), ("v", node_v))
                    for f in ("code", "scale")}
    return out


def check_moments(got, want, scale_tol=None, code_frac=1e-5):
    """int8 states against JAX's: scales within a few ulps (or, for
    gradients summed in another order, ``scale_tol`` of the leaf's largest
    scale), codes within 1 at rounding ties (at most ``code_frac`` of
    them)."""
    assert set(got) == set(want)
    off = total = 0
    for key, mom in got.items():
        for tag in ("m", "v"):
            d = np.abs(mom[f"{tag}_code"].astype(np.int32)
                       - want[key][f"{tag}_code"].astype(np.int32))
            assert d.max(initial=0) <= 1, (key, tag, d.max())
            off += int((d > 0).sum())
            total += d.size
            w = want[key][f"{tag}_scale"]
            np.testing.assert_allclose(
                mom[f"{tag}_scale"], w, rtol=scale_tol or 5e-7,
                atol=scale_tol * np.abs(w).max() if scale_tol else 0,
                err_msg=f"{key} {tag} scales")
    assert off <= code_frac * total, (off, total)


def port_fed(cfg, tree, grads):
    """The port's int8 chain on one device, fed the same gradients."""
    import torch

    from v2pe_tpu_torch.models.params import from_jax_params
    from v2pe_tpu_torch.train import optimizer as topt

    model = from_jax_params(tree, port_config(cfg))
    opt = topt.build_optimizer(topt.TrainConfig(**OPT_TC), model,
                               port_config(cfg))
    state = opt.init()
    for g in grads:
        opt.step({n: torch.from_numpy(np.array(v)) for n, v in
                  _jax_state_dict(g, port_config(cfg)).items()}, state)
    return ({n: p.detach().numpy() for n, p in model.named_parameters()},
            {k: {t: v.numpy() for t, v in mom.items()}
             for k, mom in state["moments"].items()})


def jax_fed(cfg, tree, grads):
    """JAX's int8 chain on the given gradients: parameters (port layout)
    and the state."""
    tx = jopt.build_optimizer(jopt.TrainConfig(**OPT_TC), tree)
    state, params = tx.init(tree), tree
    update = jax.jit(tx.update)
    for g in grads:
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
    return _jax_state_dict(np_tree(params), port_config(cfg)), state


def jax_steps(cfg, tree, batches):
    """JAX's int8 train steps on the combined batches: losses, grad norms,
    parameters (port layout) and the state."""
    tx = jopt.build_optimizer(jopt.TrainConfig(**INT8), tree)
    state = tx.init(tree)
    fn = jstep.make_train_step(cfg, tx, None, jsynth.IMG_CONTEXT_ID,
                               attn_impl="jnp", remat=True, donate=False)
    params, losses, norms = tree, [], []
    for b in batches:
        params, state, m = fn(params, state, {k: jax.numpy.asarray(v)
                                              for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return (losses, norms, _jax_state_dict(np_tree(params),
                                           port_config(cfg))), state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns started, then JAX's references computed meanwhile."""
    cfg = cfg_int8()
    tree = np_tree(jax_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-5
                                     ).astype(np.float32), tree)
             for _ in range(OPT_STEPS)]
    batches = global_batches(cfg)
    spec = dict(cfg=port_config(cfg).to_json(), tree=tree, batches=batches,
                img_context_id=jsynth.IMG_CONTEXT_ID,
                grads=[_jax_state_dict(g, port_config(cfg)) for g in grads])
    started = {}
    for key, mesh in MESHES.items():
        tasks = [dict(kind="int8_opt", mesh=mesh, tc=OPT_TC),
                 dict(kind="train", mesh=mesh, tc=INT8)]
        root = tmp_path_factory.mktemp(f"int8_{key}")
        if key == "fsdp2_tensor2":
            tasks.append(dict(kind="resume", mesh=mesh, tc=INT8,
                              dir=str(root / "ckpt"), compare=True))
        started[key] = Run(dict(spec, tasks=tasks),
                           int(np.prod(list(mesh.values()))), root)
    fed = jax_fed(cfg, tree, grads) + port_fed(cfg, tree, grads)
    steps = jax_steps(cfg, tree, batches)
    return started, fed, steps


@pytest.mark.parametrize("mesh", list(MESHES))
def test_int8_adam_on_shards_fed_jax_gradients_equals_jax(runs, mesh):
    """Three steps of the sharded int8 chain on JAX's gradients: codes,
    scales and parameters equal to the port's one-device chain bit for
    bit, and so to JAX's as far as that is (parameters within 2e-5: a code
    one step away moves its value's update); each rank holds about its
    share of the state, not a replica."""
    started, (want_params, jstate, one_params, one_moments), _ = runs
    got = started[mesh].result()[0]
    assert set(got["moments"]) == set(one_moments)
    for key, mom in got["moments"].items():
        for t, v in mom.items():
            np.testing.assert_array_equal(v, one_moments[key][t],
                                          err_msg=f"{key} {t}")
    check_moments(got["moments"], jax_int8_state(jstate, got["moments"]))
    for n, p in got["params"].items():
        np.testing.assert_array_equal(p, one_params[n], err_msg=n)
        np.testing.assert_allclose(p, want_params[n], rtol=0, atol=2e-5,
                                   err_msg=n)
    whole = sum(v.nbytes for mom in got["moments"].values()
                for v in mom.values())
    ranks = int(np.prod(list(MESHES[mesh].values())))
    # fsdp x tensor shares: the leaves whole on every tensor rank are
    # halved by fsdp alone, the cut blocks are held by each of their ranks
    share = 1 / MESHES[mesh]["fsdp"]
    for b in got["state_bytes"]:
        assert b < 1.1 * share * whole, (b, whole)
    assert sum(got["state_bytes"]) >= whole
    assert len(got["state_bytes"]) == ranks


@pytest.mark.parametrize("mesh", list(MESHES))
def test_int8_train_steps_on_shards_match_jax(runs, mesh):
    """Two train steps with int8 Adam on the mesh equal JAX's two
    single-process steps on the combined batch, codes and scales too
    (scales within 1e-5 of the leaf's largest: the gradients are sums in
    another order, as the parameters' 2e-5 allows)."""
    started, _, (want, jstate) = runs
    got = started[mesh].result()[1]
    check_against_jax(got, want)
    check_moments(got["moments"], jax_int8_state(jstate, got["moments"]),
                  scale_tol=1e-5, code_frac=5e-5)


def test_int8_save_and_resume_on_shards_equals_the_unbroken_run(runs):
    """Rank 0 writes one device's int8 state; a fresh placed model and
    optimizer restored from it take step 2 to the unbroken run's loss,
    parameters, codes and scales."""
    started = runs[0]
    got = started["fsdp2_tensor2"].result()[2]
    assert got["resumed"] == got["unbroken"] and got["step"] == 1
    for n, p in got["params"].items():
        np.testing.assert_array_equal(p, got["unbroken_params"][n],
                                      err_msg=n)
    for key, mom in got["resumed_moments"].items():
        for t, v in mom.items():
            np.testing.assert_array_equal(v, got["unbroken_moments"][key][t],
                                          err_msg=f"{key} {t}")
