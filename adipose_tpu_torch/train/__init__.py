"""Checkpoint artifacts, losses' selection, the optimizer and the U-Net trainer."""
