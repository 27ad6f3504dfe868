"""PyTorch + CUDA port of the Catwalk TNN reproduction.

Mirrors ``src/repro/`` module for module (same relative paths, same public
names) and runs the TNN volley-serving path on an NVIDIA GPU: spike coding
(:mod:`repro_torch.core.coding`), spike compaction, the engine policy, the
SRM0-RNL neuron bank with its hand-written CUDA kernels
(:mod:`repro_torch.kernels.rnl_neuron`), columns, layers, networks, STDP
learning and the slot engine (:mod:`repro_torch.serve.tnn_engine`), which
can learn while it serves.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on CPU tensors the kernels' plain PyTorch versions run instead.
"""
