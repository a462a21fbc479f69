"""Sharded, atomic, resumable checkpoints."""
