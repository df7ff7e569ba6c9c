"""HMM topology, transition model and H-transducer: what a GMM decode and
the training-graph compiler need."""
