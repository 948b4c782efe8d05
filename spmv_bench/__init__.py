"""The benchmark of spmv_openmp_cuda_tpu_torch, the PyTorch and CUDA port,
on an NVIDIA H100.

`python3 -m spmv_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json`. Configurations, traffic
mixes and metrics are files found by name (`spec.py`); the generators, the
float64 reference, the roofline arithmetic and the check that decides
`correct` live here, apart from the program they measure.
"""
