"""The ring's per-card spans (``nbody_tpu_torch.parallel.ring``), for the
``ring_*`` readers.

The ring opens ``ring.self/<r>`` and ``ring.tile/<r>`` for shard r on that
shard's own card, so each is timed on the stream of the card that ran it.
Times are read as :mod:`benchmark.spans` reads every span: over the
window's unprofiled force calls (``sim.force``), over all of them where
every call was profiled. A program whose ring has no spans, or a cell that
never runs the ring, gives an empty reading, and the reader ``None``.
"""

from __future__ import annotations

from typing import Dict

from benchmark import spans


def shards(run, key: str) -> list:
    """The shards whose ``ring.self/<r>`` span ran in the window."""
    w = spans.window(run, key)
    if w is None:
        return []
    names = [n for n in w[1]["all"] if n.startswith("ring.self/")]
    return sorted(int(n.rsplit("/", 1)[1]) for n in names
                  if spans.ran(run, key, n))


def ms_per_call(run, key: str, kind: str) -> Dict[int, float]:
    """{shard: milliseconds of its ``ring.<kind>/<shard>`` spans a force
    call}; 0 for a shard that ran the ring without that span."""
    out = {}
    for r in shards(run, key):
        got = spans.per(run, key, f"ring.{kind}/{r}", "sim.force")
        if got is not None:
            out[r] = 1e3 * got[0] / got[1]
    return out
