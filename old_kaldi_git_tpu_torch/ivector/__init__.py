"""iVector extraction (decode side): diagonal-UBM extractors, online iVectors."""
