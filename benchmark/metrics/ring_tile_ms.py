"""``ring_tile_ms``: device time of the busiest card's ``ring.tile/<r>``
spans (the two-output tiles it evaluates, K3 on fp32 cards, in
``parallel/ring.py``) a force call. At even P the shards that skip the
half step evaluate one tile fewer."""

from benchmark import ring_spans, spans

snapshot = spans.snapshot


def read(run):
    per_card = ring_spans.ms_per_call(run, "ring_tile_ms", "tile")
    return max(per_card.values()) if per_card else None
