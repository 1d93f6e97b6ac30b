"""The port's benchmark: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``run.py``); ``BENCHMARK.json`` at the
checkout's root describes its cells and metrics."""
