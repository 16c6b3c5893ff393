"""Benchmark of ``adipose_tpu_torch`` on one NVIDIA H100.

``python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix or per-layer metric is a file of
its own, found by the name ``BENCHMARK.json`` gives it:

  configs/<config>.json     the model's sizes and source
  traffic/<traffic>.json    the request or step mix, and the entry that runs it
  entries/<entry>.py        builds and drives the port's entry
  metrics/<metric>.py       reads one per-layer metric from a traced run
  reference/                plain PyTorch models, augment, loss and optimizer
  work/                     operations and bytes from shapes, and the peaks

Nothing here imports JAX or the JAX package; ``reference/`` imports nothing
of the port either.
"""
