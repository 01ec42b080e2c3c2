"""The port's benchmark: ``python3 bench_port/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` (see ``run.py``); cells in
``BENCHMARK.json``."""
