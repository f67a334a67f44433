"""Measurement scripts for the port's CUDA kernels, run on the card as
``python -m tdr_torch.tools.<name>``."""
