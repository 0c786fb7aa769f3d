"""The output check fails a run whose timed path is broken underneath, and
the control (the reference in float8) reads far worse than the program.

Each fault drives a whole serving run at a tiny size on the CPU, the
look for a card skipped, with the port broken where the fault lives, and
judges it by the limits of the real cell."""

import json
import os

import pytest
import torch

from portbench.drivers import serve
from portbench.run import judge
from tiny import tiny_cell

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 7


def _limits(cell):
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        return json.load(f)


def _judged(config, mix, cell):
    run = serve.run(tiny_cell(config, mix), SEED, 3.0, False, device="cpu",
                    log=lambda m: None)
    checks = dict(run["checks"], failed=float(run["failed"]))
    return judge(checks, _limits(cell))[0], checks


CELLS = [("internvl2-2b", "mmdoc", "serve.2b.mmdoc"),
         ("internvl2_5-8b", "docqa", "serve.8b.docqa")]


@pytest.mark.parametrize("config,mix,cell", CELLS)
def test_sound_run_is_correct(config, mix, cell):
    ok, checks = _judged(config, mix, cell)
    assert ok, checks


@pytest.mark.parametrize("config,mix,cell", CELLS)
def test_token_altered_where_produced(monkeypatch, config, mix, cell):
    """The engine emits the id after the one it sampled."""
    from v2pe_tpu_torch.serve import engine

    def wrong(logits, gc, generator):
        return (logits.argmax(-1) + 1) % logits.shape[-1]

    monkeypatch.setattr(engine, "_sample", wrong)
    ok, checks = _judged(config, mix, cell)
    assert not ok, checks


@pytest.mark.parametrize("config,mix,cell", CELLS)
def test_state_left_unchanged(monkeypatch, config, mix, cell):
    """A prompt chunk's K/V never reaches the pool: the next chunk and
    every decode step attend a pool the prefill left as it was."""
    from v2pe_tpu_torch.infer import paged_kv

    monkeypatch.setattr(paged_kv, "scatter_layers",
                        lambda cache, layers, k, v, slots: None)
    ok, checks = _judged(config, mix, cell)
    assert not ok, checks


@pytest.mark.parametrize("config,mix,cell", CELLS)
def test_positions_altered(monkeypatch, config, mix, cell):
    """Plain integer positions where V2PE's are due."""
    import numpy as np

    from v2pe_tpu_torch.infer import chat

    monkeypatch.setattr(chat, "build_v2pe_pos_ids",
                        lambda ids, mask, *a, **kw: np.arange(
                            len(ids), dtype=np.float32))
    ok, checks = _judged(config, mix, cell)
    assert not ok, checks


def test_control_reads_far_worse_than_the_program():
    """At a size the CPU holds: the float8 control's first-token error is
    several times the bfloat16 program's (on the card, at the cells' own
    sizes, it fails their limits: test_control_fails_on_the_card)."""
    run = serve.run(tiny_cell(), SEED, 3.0, False, device="cpu",
                    control=True, log=lambda m: None)
    c = run["checks"]
    assert c["control_first_err"] > 4 * c["first_err"], c


@pytest.mark.card
@pytest.mark.parametrize("cell", ["serve.2b.mmdoc", "serve.8b.docqa"])
def test_control_fails_on_the_card(card, cell):
    from portbench.lib import spec

    c = spec.resolve(spec.load_benchmark(), cell)
    run = serve.run(c, 2 ** 31 + 1, 12.0, False, device=card, control=True,
                    log=lambda m: None)
    checks = run["checks"]
    control = {"gap": checks["control_gap"],
               "first_err": checks["control_first_err"]}
    limits = {k: v for k, v in c["limits"].items() if k in control}
    assert not judge(control, limits)[0], control
    assert judge(dict(checks, failed=0.0), c["limits"])[0], checks
    torch.cuda.empty_cache()


def test_nothing_to_compare_is_not_correct():
    """A run whose sample is empty compared nothing: not correct."""
    import numpy as np

    cell = tiny_cell()
    checks = serve.compare(cell, SEED, [], np.zeros((1, 3, 8, 8),
                                                    np.float32), "cpu")
    checks["failed"] = 0.0
    assert checks["unchecked"] == 1.0
    assert not judge(checks, _limits("serve.2b.mmdoc"))[0]
