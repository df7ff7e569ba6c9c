"""HMM topology and transition model: the read side a GMM decode needs."""
