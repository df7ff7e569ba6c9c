"""Command-line tools of the port (counterpart of old_kaldi_git_tpu/bin/):
the JAX package's tools under the same names, options and exit codes, run
through the port's library on the card.

    python -m old_kaldi_git_tpu_torch.bin <tool> [options] <args...>

Run with no arguments, or with --help, for the tool list.  Tools that make
tensors take --device=cuda|cpu (cuda by default; it raises without a card);
the host tools (FSTs, lattices on archives, tables, WER) take none.  Files
are the JAX package's formats: archives and scripts, OKTFST01 and OpenFst
FSTs, .mdl files and lattices.
"""
