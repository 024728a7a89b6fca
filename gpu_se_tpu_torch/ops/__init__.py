"""Resample kernels (``csrc/``), their wrappers and plain versions."""
