"""Scheduler helpers used by the encoder."""
