"""The lattice functions of sequence training in the port against the JAX
package on the CPU: lattice_state_times, lattice_prune,
lattice_arc_posteriors, lattice_total_logprob and
rescore_lattice_acoustics.

The lattices come from one fixed decode of the yes/no toy (the port's
decode_batch lattice mode on loglikes synthesised from known phone
sequences, as tests/test_torch_dense_lattice.py makes them), copied arc for
arc into the JAX package's Lattice.  One of them gets an epsilon arc
spliced into its best chain (as lat.lattice._emit writes multi-word output
labels) and a branch far outside any beam, which pruning must remove.
Structure is held exactly, floats within 1e-9 (both packages run the same
float64 loops in the same order)."""

import copy

import numpy as np
import pytest

import tests.torch_threads  # noqa: F401
import old_kaldi_git_tpu.lat.lattice as jlat
import old_kaldi_git_tpu.lat.rescore as jrescore
import old_kaldi_git_tpu_torch.decoder.viterbi as tvit
import old_kaldi_git_tpu_torch.lat.lattice as tlat
import old_kaldi_git_tpu_torch.lat.rescore as trescore
from old_kaldi_git_tpu_torch import convert
from tests.test_online import _toy_decode_system
from tests.test_torch_chain import port_graph
from tests.test_torch_dense_lattice import SEQUENCES, _batch

TOL = 1e-9
DECODE = dict(beam=30.0, max_active=200, acoustic_scale=1.0)


def splice(lat, mod):
    """An epsilon arc (graph cost 1.25) after the first arc of the start
    state, and a branch from the start state at graph cost 1e4 to a final
    state of its own."""
    arc = lat.arcs[lat.start][0]
    mid = lat.add_state(time=lat.state_time[lat.start] + 1)
    dst = arc.nextstate
    arc.nextstate = mid
    lat.arcs[mid].append(mod.LatticeArc(0, 0, 1.25, 0.0, dst))
    far = lat.add_state(time=0)
    lat.arcs[lat.start].append(mod.LatticeArc(arc.ilabel, 0, 1e4, 3.0, far))
    lat.finals[far] = (0.0, 0.0)


def to_jax(lat):
    out = jlat.Lattice()
    for s in range(lat.num_states):
        out.add_state(lat.state_time[s])
    out.start = lat.start
    out.finals = list(lat.finals)
    out.arcs = [[jlat.LatticeArc(a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost,
                                 a.nextstate) for a in lst] for lst in lat.arcs]
    return out


def arcs_of(lat):
    return ([[(a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost, a.nextstate)
              for a in lst] for lst in lat.arcs], list(lat.finals), list(lat.state_time),
            lat.start)


@pytest.fixture(scope="module")
def toy():
    """(JAX tm, port tm, [(port lattice, JAX lattice, loglikes)]) of the
    four toy utterances, the first spliced."""
    lang, _topo, cd, jtm, jg = _toy_decode_system()
    ll, nf = _batch(lang, jtm, cd, SEQUENCES)
    tg = port_graph(jg)
    res = tvit.decode_batch(tg, ll, nf, tvit.ViterbiOptions(**DECODE), want_lattice=True,
                            device="cpu")
    out = []
    for b, r in enumerate(res):
        lat = tlat.lattice_from_decode(tg, ll[b, : nf[b]], r.frame_states, r.frame_costs,
                                       1.0, lattice_beam=8.0)
        if b == 0:
            splice(lat, tlat)
        out.append((lat, to_jax(lat), ll[b, : nf[b]]))
    return jtm, convert.transition_model_from_pickle(jtm), out


def test_the_toy_lattices_hold_what_the_tests_need(toy):
    _, _, lats = toy
    assert len(lats) == len(SEQUENCES)
    assert any(a.ilabel == 0 for lst in lats[0][0].arcs for a in lst)
    assert all(lat.num_arcs > lat.num_states // 2 for lat, _, _ in lats)


def test_lattice_state_times(toy):
    for tl, jl, _ in toy[2]:
        tl, jl = copy.deepcopy(tl), copy.deepcopy(jl)
        tl.state_time = [-1] * tl.num_states
        jl.state_time = [-1] * jl.num_states
        assert tlat.lattice_state_times(tl) == jlat.lattice_state_times(jl)
        assert tl.state_time == jl.state_time


@pytest.mark.parametrize("beam,scales", [(8.0, (1.0, 1.0)), (2.0, (1.0, 0.1)),
                                         (0.5, (0.5, 1.0))])
def test_lattice_prune(toy, beam, scales):
    for i, (tl, jl, _) in enumerate(toy[2]):
        tp = tlat.lattice_prune(tl, beam, *scales)
        jp = jlat.lattice_prune(jl, beam, *scales)
        assert arcs_of(tp) == arcs_of(jp)
        assert tp.num_arcs <= tl.num_arcs
        if i == 0:  # the far branch is gone
            assert all(a.graph_cost < 1e3 for lst in tp.arcs for a in lst)


@pytest.mark.parametrize("scales", [(1.0, 1.0), (1.0, 0.1), (0.7, 0.3)])
def test_lattice_arc_posteriors_and_total(toy, scales):
    for tl, jl, _ in toy[2]:
        tp = tlat.lattice_arc_posteriors(tl, *scales)
        jp = jlat.lattice_arc_posteriors(jl, *scales)
        assert [len(r) for r in tp] == [len(r) for r in jp]
        np.testing.assert_allclose(np.concatenate(tp), np.concatenate(jp), rtol=0, atol=TOL)
        tt = tlat.lattice_total_logprob(tl, *scales)
        assert tt == pytest.approx(jlat.lattice_total_logprob(jl, *scales), abs=TOL)
        assert np.isfinite(tt)


def test_rescore_lattice_acoustics(toy):
    jtm, ttm, lats = toy
    rng = np.random.default_rng(5)
    for tl, jl, ll in lats:
        tl, jl = copy.deepcopy(tl), copy.deepcopy(jl)
        new = (ll + rng.normal(size=ll.shape)).astype(np.float32)
        trescore.rescore_lattice_acoustics(tl, new, ttm.tid_to_pdf)
        jrescore.rescore_lattice_acoustics(jl, new, jtm.tid_to_pdf)
        assert arcs_of(tl) == arcs_of(jl)
        post_t = tlat.lattice_arc_posteriors(tl, 1.0, 1.0)
        post_j = jlat.lattice_arc_posteriors(jl, 1.0, 1.0)
        np.testing.assert_allclose(np.concatenate(post_t), np.concatenate(post_j),
                                   rtol=0, atol=TOL)
