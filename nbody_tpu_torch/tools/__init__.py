"""Measurement tools of the PyTorch port."""
