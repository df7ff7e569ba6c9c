"""The native lattice determinization in the port (lat/native.py, a build
of cpp/lattice.cc) against its plain version and the JAX package on the
CPU.

determinize_lattice_pruned runs the native library by default; its
Python route (`algorithm="python"`) runs determinize_lattice on the same
float32 weights with the native library's rounding, so the two are equal,
states, arcs, tid strings and weights, and equal to the JAX package's
determinize_lattice_pruned (which loads its committed build of the same
source).  The library builds from the checkout into build/, and a build
that fails raises: no fallback."""

import tests.torch_threads  # noqa: F401
import os

import numpy as np
import pytest

import old_kaldi_git_tpu.lat.determinize as jdet
import old_kaldi_git_tpu.lat.native as jnative
import old_kaldi_git_tpu_torch.lat.determinize as tdet
import old_kaldi_git_tpu_torch.lat.lattice as tlat
import old_kaldi_git_tpu_torch.lat.native as tnative
from old_kaldi_git_tpu_torch.fst import native as fst_native
from old_kaldi_git_tpu_torch.utils.log import KaldiError
from tests.test_determinize import random_lattice
from tests.torch_lattice_toy import clat_tuple, to_jax, yesno_lattices

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_lattice(jl):
    out = tlat.Lattice()
    for s in range(jl.num_states):
        out.add_state(jl.state_time[s])
    out.start = jl.start
    out.finals = list(jl.finals)
    out.arcs = [[tlat.LatticeArc(a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost,
                                 a.nextstate) for a in lst] for lst in jl.arcs]
    return out


@pytest.fixture(scope="module")
def toy():
    return yesno_lattices()


def test_the_jax_package_runs_its_native_library():
    assert jnative.available()  # so its default is the same C++


def test_library_builds_from_the_checkout_into_build(tmp_path, monkeypatch):
    path = tnative.build()
    assert os.path.dirname(path) == os.path.join(REPO, "build")
    assert os.path.basename(path).startswith("libokt_lattice-") and os.path.exists(path)
    tnative._load()
    # another source, another name; a source that does not compile raises
    bad = tmp_path / "lattice.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    assert fst_native.shared_library_path(str(bad), "libokt_lattice", str(tmp_path)) != path
    with pytest.raises(KaldiError, match="failed"):
        tnative.build()


def test_a_failed_build_fails_the_determinization(tmp_path, monkeypatch, toy):
    bad = tmp_path / "lattice.cc"
    bad.write_text("int broken(\n")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(KaldiError):
        tdet.determinize_lattice_pruned(toy.port[0], 8.0)
    with pytest.raises(ValueError):
        tdet.determinize_lattice_pruned(toy.port[0], 8.0, algorithm="jax")


@pytest.mark.parametrize("beam", [np.inf, 2.0, 0.5])
def test_random_lattices_native_python_and_jax_equal(beam):
    rng = np.random.default_rng(11)
    checked = 0
    for _ in range(40):
        jl = random_lattice(rng, num_states=12, num_arcs=30)
        want = jdet.determinize_lattice_pruned(jl, beam)
        native = tdet.determinize_lattice_pruned(port_lattice(jl), beam)
        python = tdet.determinize_lattice_pruned(port_lattice(jl), beam, algorithm="python")
        assert clat_tuple(native) == clat_tuple(python) == clat_tuple(want)
        checked += native.num_states > 0
    assert checked >= 30


@pytest.mark.parametrize("beam,scales", [(8.0, (1.0, 1.0)), (10.0, (1.0, 0.1)),
                                         (3.0, (0.5, 0.7))])
def test_toy_decode_lattices_native_python_and_jax_equal(toy, beam, scales):
    lm, ac = scales
    for tl, jl in zip(toy.port, toy.jax):
        want = jdet.determinize_lattice_pruned(jl, beam, acoustic_scale=ac, lm_scale=lm)
        for algorithm in ("native", "python"):
            got = tdet.determinize_lattice_pruned(tl, beam, acoustic_scale=ac, lm_scale=lm,
                                                  algorithm=algorithm)
            assert clat_tuple(got) == clat_tuple(want)
        words, tids, cost = got.best_path(lm, ac)
        best = tlat.lattice_best_path(tl, lm, ac)
        assert (words, tids) == (best[0], best[1])
        assert cost == pytest.approx(best[2], rel=1e-6)


def test_weights_cross_the_boundary_as_float32(toy):
    """On weights that float32 cannot hold, the Python route rounds them as
    the ctypes boundary does: still equal to the native result, and within
    float32 of the float64 algorithm."""
    tl = toy.port[3]
    native = tdet.determinize_lattice_pruned(tl, 6.0, acoustic_scale=0.1)
    python = tdet.determinize_lattice_pruned(tl, 6.0, acoustic_scale=0.1, algorithm="python")
    assert clat_tuple(native) == clat_tuple(python)
    scaled = [0.1 * a.acoustic_cost for lst in tl.arcs for a in lst]
    assert any(x != float(np.float32(x)) for x in scaled)
    # at lm_scale 1 the graph costs come back as the boundary's float32 values
    for lst in python.arcs:
        for a in lst:
            assert a.graph_cost == float(np.float32(a.graph_cost))
    exact = tdet.determinize_lattice(to_scaled(tl, 0.1), 6.0)
    e = exact.best_path(1.0, 1.0)
    n = native.best_path(1.0, 0.1)
    assert e[:2] == n[:2] and e[2] == pytest.approx(n[2], rel=1e-6)


def to_scaled(lat, ac):
    out = tlat.Lattice()
    for s in range(lat.num_states):
        out.add_state(lat.state_time[s])
        if lat.is_final(s):
            out.finals[s] = (lat.finals[s][0], ac * lat.finals[s][1])
    out.start = lat.start
    for s in range(lat.num_states):
        out.arcs[s] = [tlat.LatticeArc(a.ilabel, a.olabel, a.graph_cost, ac * a.acoustic_cost,
                                       a.nextstate) for a in lat.arcs[s]]
    return out


def test_blow_up_raises_in_both_routes_and_the_wrapper_retries(toy):
    tl = toy.port[3]
    with pytest.raises(KaldiError, match="blow-up"):
        tnative.determinize_lattice_native(tl, np.inf, max_states=3)
    with pytest.raises(KaldiError, match="max_states"):
        tdet.determinize_lattice(tl, np.inf, max_states=3)
    # the wrapper tightens the beam and gives up after `retries`
    for algorithm in ("native", "python"):
        with pytest.raises(KaldiError):
            tdet.determinize_lattice_pruned(tl, 8.0, max_states=2, retries=2,
                                            algorithm=algorithm)
    got = tdet.determinize_lattice_pruned(tl, 8.0, acoustic_scale=0.1, max_states=40)
    want = jdet.determinize_lattice_pruned(to_jax(tl), 8.0, acoustic_scale=0.1, max_states=40)
    assert clat_tuple(got) == clat_tuple(want) and got.num_states <= 40


def test_empty_and_pathless_lattices():
    for algorithm in ("native", "python"):
        assert tdet.determinize_lattice_pruned(tlat.Lattice(), algorithm=algorithm
                                               ).num_states == 0
        lat = tlat.Lattice()
        a, b = lat.add_state(0), lat.add_state(1)
        lat.arcs[a].append(tlat.LatticeArc(1, 2, 0.5, 0.5, b))  # no final state
        assert tdet.determinize_lattice_pruned(lat, algorithm=algorithm).num_states == 0
