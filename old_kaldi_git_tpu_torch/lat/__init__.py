"""Lattices: rebuild, determinization, LM rescoring (host code)."""
