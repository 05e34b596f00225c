"""The benchmark of the PyTorch/CUDA port (`ceph_tpu_torch`).

One run is one cell of `BENCHMARK.json`, a configuration under a traffic
mix:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, mix, operation or metric
sits in a file of its own (`configs/`, `traffic/`, `ops/`, `metrics/`),
found by the name `BENCHMARK.json` gives it.  Nothing here imports JAX
or the JAX package `ceph_tpu`.
"""
