"""Timing, quality metrics and numeric guards."""
