"""Online decoding: the streaming feature pipeline, the streaming token-sparse decoder, endpointing."""
