"""The benchmark of the PyTorch and CUDA port (`captra_tpu_torch`) on one
NVIDIA card; `python3 port_bench/run.py --help`."""
