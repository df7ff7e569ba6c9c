"""Decoding-graph arrays, the graph compiler and the searches of the port:
token-sparse, dense and top-K beam decoding, and forced alignment."""
