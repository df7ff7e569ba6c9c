"""Decoding-graph arrays and the token-sparse beam search of the port."""
