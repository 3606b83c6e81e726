"""Data pipelines of the LM training path."""
