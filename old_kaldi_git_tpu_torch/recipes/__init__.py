"""End-to-end recipes of the port."""
