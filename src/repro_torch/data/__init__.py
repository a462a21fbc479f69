"""Deterministic synthetic token pipeline."""
