"""Subpackage of the PyTorch port (see openmvs_tpu_torch)."""
