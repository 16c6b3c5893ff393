"""Evaluation-side IO and visualization."""
