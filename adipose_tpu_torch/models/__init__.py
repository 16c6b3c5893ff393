"""Models: the dilated U-Net and its Flax weight converter."""
