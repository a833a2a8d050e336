"""The benchmark of ``voicefixer_tpu_torch`` on one or more CUDA cards.

``python3 bench_cuda/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything a cell
needs is found by name: its configuration in ``configs/``, the model
family the configuration names in ``families/``, its traffic mix in
``traffic/``, each metric's reader in ``metrics/``. The yardstick (the
generator, the readers, the frozen work counts, the plain reference and
the comparison that decides ``correct``) lives here and imports nothing
of the program except through ``program.py`` and ``entries/``.
"""
