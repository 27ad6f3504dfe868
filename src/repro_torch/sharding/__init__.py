"""Sharding rules of the TNN stack over a ``("data", "column")`` device
mesh, and the helpers that cut a whole tensor into a rank's block and
gather the blocks back."""
