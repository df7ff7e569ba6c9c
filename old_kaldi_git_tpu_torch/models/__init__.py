"""Acoustic models of the port (TDNN / TDNN-F inference)."""
