"""Simulation core of the port: neuron dynamics, synapses, octree, descent."""
