"""Roofline terms of a step on one rank (:mod:`.analysis`) from the
operations it dispatches (:mod:`.op_cost`)."""
