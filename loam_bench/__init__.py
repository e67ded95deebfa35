"""The benchmark of ``loam_velodyne_torch`` on one H100 (``BENCHMARK.json``).

``python3 -m loam_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (``run.py``). The cells, their
configurations (``configs/``), traffic mixes (``traffic/``), checks
(``workloads/``) and per-layer metrics (``metrics/``) are found by the
names in ``BENCHMARK.json`` (``spec.py``), and so are the ways of driving
the system (``entries/``); ``oracle.py`` is the plain reference that
``check.py`` holds the timed path to. The CPU tests are in
``tests/`` (``python3 -m pytest loam_bench/tests``); the control of the
check runs on the card (``python3 -m loam_bench.control``).
"""
