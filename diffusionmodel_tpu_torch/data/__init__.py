"""Datasets of the port (numpy-only copies of ``diffusionmodel_tpu/data``
modules: importing anything from the JAX package pulls in jax)."""
