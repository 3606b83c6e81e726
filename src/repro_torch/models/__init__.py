"""The LM substrate's models (port of `repro.models`): configs, layers, attention, MoE, Mamba2."""
