"""Diagonal-covariance GMM acoustic models (decode side)."""
