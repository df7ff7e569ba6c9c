"""Random FST generation, host Python (counterpart of
old_kaldi_git_tpu/fst/rand.py; reference src/fstext/rand-fst.h RandFst):
the generator behind the `fstrand` tool and the equivalence tests.  It draws
from Python's `random.Random` in the JAX package's order, so one seed gives
the same FST in both packages."""

from __future__ import annotations

import random

from old_kaldi_git_tpu_torch.fst.vector_fst import Arc, VectorFst


def rand_fst(rng: random.Random, num_states: int = 6, num_arcs: int = 10,
             num_ilabels: int = 3, num_olabels: int = 3, eps_prob: float = 0.2,
             acyclic: bool = False, functional_ish: bool = False) -> VectorFst:
    """A connected random transducer; `acyclic` draws forward arcs only;
    `functional_ish` makes it an identity transduction (determinizable)."""
    fst = VectorFst()
    for _ in range(num_states):
        fst.add_state()
    fst.set_start(0)
    for _ in range(num_arcs):
        s = rng.randrange(num_states)
        if acyclic:
            if s + 1 >= num_states:
                continue
            ns = rng.randrange(s + 1, num_states)
        else:
            ns = rng.randrange(num_states)
        il = 0 if rng.random() < eps_prob else rng.randint(1, num_ilabels)
        if functional_ish:
            ol = il
        else:
            ol = 0 if rng.random() < eps_prob else rng.randint(1, num_olabels)
        fst.add_arc(s, Arc(il, ol, round(rng.uniform(0, 2), 3), ns))
    for _ in range(2):
        fst.set_final(rng.randrange(num_states), round(rng.uniform(0, 1), 3))
    fst.connect()
    return fst
