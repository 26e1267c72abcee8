"""The benchmark of the port (``pwasm_tpu_torch``): served ``pafreport``
jobs and ``--many2many`` jobs on one H100.  ``run.py`` runs one cell of
``BENCHMARK.json``; ``control.py`` runs one with a correctness control in the program's
place."""
