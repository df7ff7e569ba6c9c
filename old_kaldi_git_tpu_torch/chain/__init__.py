"""Chain (LF-MMI) training: counterpart of old_kaldi_git_tpu/chain/.

Phone LM (`phone_lm`), the 1-state chain topology (`topology`), the
denominator graph (`den_graph`), alignment-derived supervision
(`supervision`) and the objective (`loss`).  The forward recursions are
PyTorch code and their gradient comes from autograd, as the JAX package
takes jax.grad of its scans.  `e2e.py` holds the flat-start (generic
graph) numerators and `semisup.py` the lattice numerators of
semi-supervised training.
"""
