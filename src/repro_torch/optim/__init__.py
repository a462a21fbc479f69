"""Optimizers, schedules and gradient compression for QAT training."""
