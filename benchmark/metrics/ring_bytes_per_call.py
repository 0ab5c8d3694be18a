"""``ring_bytes_per_call``: the program's counter ``ring.bytes`` (the bytes
that leave their card in ``parallel/ring.py``: the scatter from the bodies'
card, every rotation and the gather) over the window's force calls. None
where the ring never ran in the window (no ``ring.self/<r>`` span)."""

from benchmark import ring_spans, spans

snapshot = spans.snapshot


def read(run):
    key = "ring_bytes_per_call"
    grew = spans.counted(run, key, "ring.bytes")
    if grew is None or not run.force_calls \
            or not ring_spans.shards(run, key):
        return None
    return grew / run.force_calls
