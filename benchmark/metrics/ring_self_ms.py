"""``ring_self_ms``: device time of the busiest card's ``ring.self/<r>``
span (its self-block engine call, K2 on fp32 cards, in
``parallel/ring.py``) a force call."""

from benchmark import ring_spans, spans

snapshot = spans.snapshot


def read(run):
    per_card = ring_spans.ms_per_call(run, "ring_self_ms", "self")
    return max(per_card.values()) if per_card else None
