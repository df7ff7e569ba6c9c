"""N-gram language models: ARPA reading and estimation (host code)."""
