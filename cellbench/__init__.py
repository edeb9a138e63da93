"""The PyTorch and CUDA port's benchmark (``python cellbench/run.py``)."""
