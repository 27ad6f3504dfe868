"""Core TNN library: coding, compaction, engine policy, neuron bank,
columns, layers and networks, STDP learning and the silicon cost model, as
plain functions on torch tensors."""
