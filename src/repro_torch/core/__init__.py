"""Core TNN library: coding, compaction, engine policy, neuron bank,
layers and networks, as plain functions on torch tensors."""
