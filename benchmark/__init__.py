"""The benchmark of the PyTorch and CUDA port (`invertavatar_torch`): one
harness (`run.py`) driven by the data files beside it."""
