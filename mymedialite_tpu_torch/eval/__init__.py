"""Evaluation protocols of the port."""
