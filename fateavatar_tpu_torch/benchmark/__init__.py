"""Benchmark harnesses (port of ``fateavatar_tpu/benchmark``)."""
