"""Datasets: the shipped parity capture."""
