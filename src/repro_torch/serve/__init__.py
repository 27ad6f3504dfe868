"""Slot-based serving: the generic slot pool and the TNN volley engine."""
