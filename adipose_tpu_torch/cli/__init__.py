"""Command-line entry point (``adipose-torch``)."""
