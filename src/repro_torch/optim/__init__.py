"""Optimizers of the LM training path."""
