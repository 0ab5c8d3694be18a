"""Benchmark harness: method registry, timing, CSV reporting."""
