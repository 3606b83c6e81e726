"""Process-level runtime of the LM training path: restarts and stragglers."""
