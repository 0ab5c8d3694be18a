"""The readers of the ring's per-card spans and counters
(``benchmark/ring_spans.py``, ``metrics/ring_*.py``): each on a made-up
run of four cards, ``None`` where the ring never ran or the program has no
spans, and a traced CPU run of the ring cell that reports every one."""

import pytest

from benchmark import catalog, run

from conftest import SEED, SMALL_N

RING = "uniform2d_5m.ring_leapfrog"
READERS = ["ring_self_ms", "ring_tile_ms", "ring_imbalance_pct",
           "ring_bytes_per_call"]


@pytest.fixture(autouse=True)
def spans_off():
    from nbody_tpu_torch.utils import profiling
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _snap(outside, profiled=None, counters=None):
    every = dict(outside)
    for k, (s, c) in (profiled or {}).items():
        s0, c0 = every.get(k, (0.0, 0))
        every[k] = (s0 + s, c0 + c)
    return {"all": every, "outside": outside, "counters": counters or {}}


def _record(name, start, end, force_calls=2):
    rec = run.RunRecord(RING, {}, {}, {}, 4, 100, 2, steps=force_calls,
                        force_calls=force_calls)
    rec.snapshots[name] = [start, end]
    return rec


def _four_cards(calls=2):
    """Two unprofiled force calls on four cards: each card's self block
    0.6 s a call, tiles 1.6 s on cards 0-1 and 0.8 s on cards 2-3 (the
    even-P half step), 2.75e8 bytes a call."""
    spans = {"sim.force": (4.8 * calls, calls)}
    for r in range(4):
        spans[f"ring.self/{r}"] = (0.6 * calls, calls)
        spans[f"ring.tile/{r}"] = ((1.6 if r < 2 else 0.8) * calls,
                                   (2 if r < 2 else 1) * calls)
    # The profiled call is left out: its times are inflated.
    profiled = {"sim.force": (9.0, 1), "ring.self/0": (5.0, 1),
                "ring.tile/0": (5.0, 2)}
    return (_snap({}, counters={"ring.bytes": 11}),
            _snap(spans, profiled,
                  counters={"ring.bytes": 11 + 275_000_000 * (calls + 1)}))


@pytest.mark.parametrize("name, want", [
    ("ring_self_ms", 600.0), ("ring_tile_ms", 1600.0),
    ("ring_imbalance_pct", 100.0 * (2200 - 1400) / 2200)])
def test_ring_span_readers_on_four_cards(name, want):
    start, end = _four_cards()
    got = catalog.reader("metrics", name).read(_record(name, start, end))
    assert got == pytest.approx(want)


def test_ring_bytes_per_call_reads_the_counter_over_the_calls():
    start, end = _four_cards()
    rec = _record("ring_bytes_per_call", start, end, force_calls=3)
    assert catalog.reader("metrics", "ring_bytes_per_call").read(rec) == \
        275_000_000


def test_ring_readers_take_every_call_where_all_were_profiled():
    start = _snap({})
    end = _snap({}, {"sim.force": (5.0, 1), "ring.self/0": (1.0, 1),
                     "ring.self/1": (0.5, 1), "ring.tile/0": (2.0, 1)})
    read = {n: catalog.reader("metrics", n).read(_record(n, start, end))
            for n in READERS[:3]}
    assert read == pytest.approx({"ring_self_ms": 1000.0,
                                  "ring_tile_ms": 2000.0,
                                  "ring_imbalance_pct": 100.0 * 2.5 / 3.0})


@pytest.mark.parametrize("name", READERS)
def test_ring_readers_read_none_where_the_ring_never_ran(name):
    """A BVH or brute window: force calls, no ring span, no ring bytes."""
    start = _snap({})
    end = _snap({"sim.force": (3.0, 2), "bvh.build": (0.1, 2)})
    mod = catalog.reader("metrics", name)
    assert mod.read(_record(name, start, end)) is None
    rec = _record(name, start, end)
    rec.snapshots[name][1] = None  # a missing snapshot
    assert mod.read(rec) is None


@pytest.mark.parametrize("name", READERS)
def test_without_spans_in_the_program_nothing_is_read(name, monkeypatch):
    from nbody_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "enable_spans")
    mod = catalog.reader("metrics", name)
    rec = _record(name, None, None)
    rec.snapshots[name] = [mod.snapshot(), mod.snapshot()]
    assert rec.snapshots[name] == [None, None]
    assert mod.read(rec) is None


def test_traced_ring_run_reports_every_ring_metric():
    """Four shards of the one CPU: the spans are per shard, and no byte
    leaves a card."""
    res = run.run_cell(RING, SEED, 0.2, True, device_type="cpu", n=SMALL_N)
    assert res["correct"], res["checks"]
    metrics = {k: v["value"] for k, v in res["metrics"].items()}
    for name in READERS + ["integrator_ms", "force_calls_per_step"]:
        assert name in metrics, name
    assert metrics["force_calls_per_step"] == 1.0
    assert metrics["ring_bytes_per_call"] == 0
    assert 0 <= metrics["ring_imbalance_pct"] < 100
    assert metrics["ring_self_ms"] + metrics["ring_tile_ms"] <= \
        metrics["force_call_ms"] * 1.05
    assert res["metrics"]["ring_bytes_per_call"]["unit"] == "bytes"


def test_untraced_ring_run_leaves_spans_off():
    from nbody_tpu_torch.utils import profiling
    res = run.run_cell(RING, SEED, 0.1, False, device_type="cpu", n=SMALL_N)
    assert not set(READERS) & set(res["metrics"])
    assert not profiling.spans_enabled()
    assert profiling.counter_totals() == {}
