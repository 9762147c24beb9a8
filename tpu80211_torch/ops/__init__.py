"""Numpy builders of the chain's constant matrices (no imports at package
level, so importing one builder pulls in nothing else)."""
