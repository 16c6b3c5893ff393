"""Checkpoint artifacts and inference functions."""
