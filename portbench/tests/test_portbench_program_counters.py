"""The metrics that read the engine's own spans and counters (its
``stats`` over the window, ``run["stats"]``) against sums by hand, and, on
the card, a program span against the device trace's clock."""

import pytest

from portbench.lib import spec

# the engine's counters over a made-up window
STATS = {"admissions": 8, "queue_wait_ns": 12_000_000_000,
         "admit_ns": 3_200_000_000, "step_ns": 40_000_000_000,
         "digest_ns": 10_000_000_000, "decode_steps": 640,
         "decode_launch_ns": 3_840_000_000, "prefill_tokens": 30_000,
         "prefill_pad_tokens": 10_000}
# each metric, its value over STATS, and the counter whose zero leaves it
# out
CASES = [("queue_wait_ms.serve", 1500.0, "admissions"),
         ("admit_ms.serve", 400.0, "admissions"),
         ("digest_pct.serve", 25.0, "step_ns"),
         ("decode_launch_ms.serve", 6.0, "decode_steps"),
         ("prefill_pad_pct.serve", 25.0, None)]


def _read(name, stats):
    return spec.load_module("metrics", name).read({"stats": stats})


@pytest.mark.parametrize("name,want,_", CASES)
def test_reads_the_engines_counters(name, want, _):
    assert _read(name, STATS) == pytest.approx(want)


@pytest.mark.parametrize("name,_,denominator", CASES)
def test_nothing_to_divide_by_gives_none(name, _, denominator):
    stats = dict(STATS)
    if denominator is None:
        stats.update(prefill_tokens=0, prefill_pad_tokens=0)
    else:
        stats[denominator] = 0
    assert _read(name, stats) is None


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_a_program_without_the_counters_gives_none(name):
    """The engine before its spans kept two counters: the metrics find
    nothing to read, and do not raise."""
    assert _read(name, {"prefill_chunks": 12, "prefix_hit_pages": 3}) is None


def test_the_metrics_are_per_layer_entries_of_the_benchmark():
    bench = spec.load_benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name, _, _ in CASES:
        m = per_layer[name]
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}
    assert per_layer["queue_wait_ms.serve"]["workloads"] == ["serve.2b.mmdoc"]


@pytest.mark.card
def test_a_span_encloses_its_kernel_on_the_device_trace(card):
    """A program span around a kernel on a synchronised stream holds the
    kernel's CUPTI interval: the spans and the device trace share one
    clock. Prints the margins on either side."""
    import torch

    from portbench.lib.trace import DeviceTrace
    from v2pe_tpu_torch.utils.profiling import SpanRecorder

    x = torch.randn(8192, 8192, device=card, dtype=torch.bfloat16)
    (x @ x).sum().item()
    rec = SpanRecorder({})
    rec.record()
    trace = DeviceTrace(card)
    trace.start()
    with rec.span("matmul"):
        y = x @ x
        torch.cuda.synchronize()
    trace.stop()
    del y
    ((_, t0, t1, _, _),) = rec.drain()
    events = trace.events()
    name, k0, k1 = max(events, key=lambda e: e[2] - e[1])
    print(f"span {(t1 - t0) / 1e3:.1f} us around {name[:40]} "
          f"{(k1 - k0) / 1e3:.1f} us: the kernel starts "
          f"{(k0 - t0) / 1e3:.1f} us after the span and ends "
          f"{(t1 - k1) / 1e3:.1f} us before its end")
    assert t0 <= k0 < k1 <= t1
