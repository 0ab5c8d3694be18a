"""Demos of the PyTorch port, each run as
``python -m nbody_tpu_torch.examples.<name>``."""
