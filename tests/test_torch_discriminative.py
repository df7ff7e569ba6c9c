"""nnet3 discriminative training (MMI, sMBR, MPFE) in the port against the
JAX package on the CPU.

- forward_backward_mpe_variants for mpfe, smbr and with silence phones, on
  the JAX package's two-path toy lattices (tests/test_discriminative.py:
  tid = phone, pdf = tid − 1) and on yesno decode lattices with a real
  transition model (tests/test_torch_lattice_post.py): the signed
  posteriors and the expected accuracy within 1e-9;
- discriminative_grad for the three criteria: zero sum on every frame, and
  the gradient and objective equal to the JAX package's within 1e-9 from
  the same loglikes and lattice;
- one epoch of train_discriminative on the two-path toy, from the JAX
  package's initial network carried over: every parameter within 1e-4, and
  compute_discriminative_objf within 1e-5;
- the JAX test's training run on the port (4 epochs, smbr and mmi): the
  objective rises by more than 1e-3."""

import copy
import dataclasses

import numpy as np
import pytest

import tests.torch_threads  # noqa: F401
import old_kaldi_git_tpu.lat.discriminative as jdisc
import old_kaldi_git_tpu.models.am_nnet as jam
import old_kaldi_git_tpu.models.discriminative as jmd
import old_kaldi_git_tpu.models.tdnn as jtdnn
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.lat import discriminative as tdisc
from old_kaldi_git_tpu_torch.lat import lattice as tlat
from old_kaldi_git_tpu_torch.models import discriminative as tmd
from tests.test_discriminative import _FakeTm, _two_path_lattice
from tests.test_torch_lattice_post import toy  # noqa: F401  (a fixture)

TOL = 1e-9


def two_path_port(cost_a=0.0, cost_b=0.0, frames=2):
    """tests/test_discriminative.py's two-path lattice, in the port."""
    return to_port(_two_path_lattice(cost_a, cost_b, frames))


def to_port(lat):
    out = tlat.Lattice()
    for s in range(lat.num_states):
        out.add_state(lat.state_time[s])
    out.start = lat.start
    out.finals = list(lat.finals)
    out.arcs = [[tlat.LatticeArc(a.ilabel, a.olabel, a.graph_cost, a.acoustic_cost,
                                 a.nextstate) for a in lst] for lst in lat.arcs]
    return out


def same_post(t, j):
    (tp, ta), (jp, ja) = t, j
    assert ta == pytest.approx(ja, abs=TOL)
    assert [[tid for tid, _ in f] for f in tp] == [[tid for tid, _ in f] for f in jp]
    np.testing.assert_allclose([w for f in tp for _, w in f], [w for f in jp for _, w in f],
                               rtol=0, atol=TOL)


CASES = [dict(criterion="mpfe"), dict(criterion="smbr"),
         dict(criterion="mpfe", silence_phones=[1])]


@pytest.mark.parametrize("kw", CASES)
def test_mpe_variants_on_the_two_path_toy(kw):
    for costs, ref in (((0.0, 0.0), [1, 1]), ((0.0, 2.0), [1, 1]), ((1.5, 0.3), [2, 1, 2])):
        frames = len(ref)
        tl, jl = two_path_port(*costs, frames), _two_path_lattice(*costs, frames)
        same_post(tdisc.forward_backward_mpe_variants(tl, _FakeTm(), ref, ac_scale=1.0, **kw),
                  jdisc.forward_backward_mpe_variants(jl, _FakeTm(), ref, ac_scale=1.0, **kw))


@pytest.mark.parametrize("kw", CASES)
def test_mpe_variants_on_yesno_lattices(toy, kw):  # noqa: F811
    jtm, ttm, lats = toy
    sil = {"silence_phones": [1]} if "silence_phones" in kw else {}
    for tl, jl, _ in lats[1:]:
        ref = tlat.lattice_best_path(tl, 1.0, 1.0)[1]
        ref = ref[:-2] + [ref[0], ref[0]]  # two frames wrong
        t = tdisc.forward_backward_mpe_variants(copy.deepcopy(tl), ttm, ref,
                                                criterion=kw["criterion"], **sil)
        j = jdisc.forward_backward_mpe_variants(copy.deepcopy(jl), jtm, ref,
                                                criterion=kw["criterion"], **sil)
        same_post(t, j)
        for frame in t[0]:
            assert sum(w for _, w in frame) == pytest.approx(0.0, abs=1e-9)


@pytest.mark.parametrize("criterion", ["mmi", "smbr", "mpfe"])
def test_discriminative_grad(toy, criterion):  # noqa: F811
    jtm, ttm, lats = toy
    rng = np.random.default_rng(2)
    for tl, jl, ll in lats[1:]:
        ref = tlat.lattice_best_path(tl, 1.0, 1.0)[1]
        x = (ll + rng.normal(size=ll.shape)).astype(np.float32)
        tg, to = tmd.discriminative_grad(ttm, x, ref, copy.deepcopy(tl), criterion=criterion)
        jg, jo = jmd.discriminative_grad(jtm, x, ref, copy.deepcopy(jl), criterion=criterion)
        np.testing.assert_allclose(tg, jg, rtol=0, atol=TOL)
        assert to == pytest.approx(jo, abs=TOL)
        np.testing.assert_allclose(tg.sum(axis=1), 0.0, atol=1e-9)
    T = 4
    for crit in ("mmi", "smbr", "mpfe"):
        g, objf = tmd.discriminative_grad(_FakeTm(), rng.normal(size=(T, 2)), [1] * T,
                                          two_path_port(frames=T), criterion=crit)
        np.testing.assert_allclose(g.sum(axis=1), 0.0, atol=1e-9)
        assert np.isfinite(objf)


def toy_data():
    rng = np.random.default_rng(1)
    T = 12
    feats = {f"u{u}": rng.normal(size=(T, 6)).astype(np.float32) + 0.5 for u in range(8)}
    alis = {k: np.full(T, 1, np.int32) for k in feats}
    return feats, alis


def nets():
    """The JAX test's network (TDNN 6 → 16 → 2 with log priors) in both."""
    cfg = jtdnn.TdnnConfig(6, 2, (jtdnn.TdnnLayerSpec("tdnn", 16, (-1, 0, 1)),))
    j = jam.AmNnet.init(cfg, seed=0)
    j.log_priors = np.log(np.full(2, 0.5, np.float32))
    t = convert.am_nnet_from_jax(dataclasses.asdict(cfg), j.variables, j.log_priors,
                                 device="cpu")
    return j, t


@pytest.mark.parametrize("crit", ["smbr", "mmi"])
def test_one_epoch_in_lockstep(crit):
    feats, alis = toy_data()
    j, t = nets()
    jlats = {k: _two_path_lattice(frames=12) for k in feats}
    tlats = {k: two_path_port(frames=12) for k in feats}
    kw = dict(criterion=crit, num_epochs=1, minibatch_size=3, learning_rate=0.05,
              acoustic_scale=1.0)
    t2 = tmd.train_discriminative(t, feats, alis, tlats, _FakeTm(),
                                  tmd.DiscriminativeOptions(**kw))
    j2 = jmd.train_discriminative(j, feats, alis, jlats, _FakeTm(),
                                  jmd.DiscriminativeOptions(**kw))
    want = convert.torch_params_from_flax(j2.variables["params"])
    for k, p in t2.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0, atol=1e-4, err_msg=k)
    assert tmd.compute_discriminative_objf(
        t2, feats, alis, tlats, _FakeTm(), tmd.DiscriminativeOptions(**kw)) == pytest.approx(
        jmd.compute_discriminative_objf(j2, feats, alis, jlats, _FakeTm(),
                                        jmd.DiscriminativeOptions(**kw)), abs=1e-5)
    # the input model is left as it was
    want0 = convert.torch_params_from_flax(j.variables["params"])
    for k, p in t.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want0[k])


@pytest.mark.parametrize("crit", ["smbr", "mmi"])
def test_training_raises_the_objective_on_the_port(crit):
    feats, alis = toy_data()
    _, am = nets()
    lats = {k: two_path_port(frames=12) for k in feats}
    opts = tmd.DiscriminativeOptions(criterion=crit, num_epochs=4, minibatch_size=4,
                                     learning_rate=0.05, acoustic_scale=1.0)
    before = tmd.compute_discriminative_objf(am, feats, alis, lats, _FakeTm(), opts)
    hist = []
    am2 = tmd.train_discriminative(am, feats, alis, lats, _FakeTm(), opts, history=hist)
    after = tmd.compute_discriminative_objf(am2, feats, alis, lats, _FakeTm(), opts)
    assert after > before + 1e-3, (crit, before, after)
    assert len(hist) == 4
    ll = am2.loglikes_batch(feats["u0"][None])[0].numpy()
    assert (ll[:, 0] > ll[:, 1]).mean() > 0.8
