"""``ring_imbalance_pct``: 100 · (max − min) / max over the cards of their
``ring.self/<r>`` plus ``ring.tile/<r>`` span time a force call: the share
of the busiest card's ring work that the least busy card sits out."""

from benchmark import ring_spans, spans

snapshot = spans.snapshot


def read(run):
    key = "ring_imbalance_pct"
    own = ring_spans.ms_per_call(run, key, "self")
    tiles = ring_spans.ms_per_call(run, key, "tile")
    work = [own[r] + tiles.get(r, 0.0) for r in own]
    if not work or max(work) <= 0:
        return None
    return 100.0 * (max(work) - min(work)) / max(work)
