"""Benchmarks of the port: throughput rows (``throughput``), estimator
quality against SNR (``quality``), the mesh-shape sweep (``scaling``), and
the ports of the JAX package's measurement scripts (``stream``,
``latency``, ``raw_stream``, ``raw_quality``, ``stages``, ``detect``,
``mmse_solve``, ``raw_anatomy``; ``common`` holds what they share)."""
