"""Hand-written CUDA kernels for Hopper, each beside its plain torch
version (`ref.py`) and its wrapper (`ops.py`)."""
