"""Entry points above the engine: the parameter sweep."""
