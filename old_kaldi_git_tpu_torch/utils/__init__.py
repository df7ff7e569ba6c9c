"""Host-side helpers of the port (logging, options, batching, WER)."""
