"""Benchmarks of the port: throughput rows (``throughput``) and estimator
quality against SNR (``quality``)."""
