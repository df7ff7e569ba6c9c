"""Feature transforms estimated from GMM statistics: LDA, MLLT and fMLLR."""
