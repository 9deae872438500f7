"""Measurement tools that run on a GPU (see each module's docstring)."""
