"""Kernels and host-side planning of the port."""
