"""The benchmark of the PyTorch/CUDA port (``more4d_tpu_torch``) on one
NVIDIA H100: ``python h100_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, the cells listed in ``BENCHMARK.json``.

The yardstick lives here and nowhere in the program: the generator of
weights and inputs (``inputs.py``), the frozen FLOP and byte counts and
the table of kernel kinds (``yardstick/``), the reduction of a profiler
trace to metrics (``yardstick/trace.py``, ``metrics/``), and the plain
fp32 reference that decides ``correct`` (``reference/``). From the
program the benchmark takes only the system under test.
"""
