"""Data parallelism over `torch.distributed`: the data mesh (`mesh.py`) and
process-group set-up, replica checks and rank spawning (`multihost.py`)."""
