"""One-off experiments of the port, each run as ``python -m adipose_tpu_torch.scripts.<name>``."""
