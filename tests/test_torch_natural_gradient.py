"""The port's natural-gradient optimizers against the JAX package's, on the CPU.

The preconditioner: a flax kernel G is [din, dout], the port's weight is Gᵀ
[dout, din]; the JAX package computes P_in G P_out, the port P_out Gᵀ P_in,
so the port's result on Gᵀ must be the transpose of the JAX result on G
(and its factors F_in [din, din], F_out [dout, dout] the JAX ones), over
updates that recompute the inverses and updates that reuse them: within
1e-5 relative (float32).  The activation statistics (input rows with a
ones column, output-derivative rows, strided to max_rows) and the
activation transform on an affine with a bias and one without: within
1e-5.  Training, a TDNN-F of 3 layers, 64 wide with a 16-dim bottleneck,
carried from the JAX package's initial parameters: 3 `ng-sgd` CE steps in
lockstep within 1e-5 (loss relative, parameters absolute), one
`ng-sgd-act` CE step and one `ng-sgd-act` chain step (yesno's biphone chain
objects) within 1e-4."""

import tests.torch_threads  # noqa: F401
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import old_kaldi_git_tpu.models.am_nnet as jam
import old_kaldi_git_tpu.models.natural_gradient as jng
import old_kaldi_git_tpu.models.tdnn as jtdnn
import old_kaldi_git_tpu.models.train as jtrain
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.models import natural_gradient as tng
from old_kaldi_git_tpu_torch.models import train as ttrain
from yesno_chain import yesno_chain_objects

D, P = 13, 40
CONFIG = dict(input_dim=D, num_outputs=P, hidden_dim=64, bottleneck_dim=16, num_layers=3)


def close(got, want, rel=None, atol=None):
    want = np.asarray(want)
    tol = atol if atol is not None else rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


def corpus(seed, n_utts=10, T=(70, 200)):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(P, D)) * 2
    feats, labels = {}, {}
    for u in range(n_utts):
        n = int(rng.integers(*T))
        lab = np.repeat(rng.integers(0, P, size=n // 5 + 1), 5)[:n].astype(np.int32)
        feats[f"u{u:02d}"] = (means[lab] + rng.normal(size=(n, D))).astype(np.float32)
        labels[f"u{u:02d}"] = lab
    return feats, labels


def carried(seed):
    j = jam.AmNnet.init(jtdnn.make_tdnnf(**CONFIG), seed=seed)
    t = convert.am_nnet_from_jax(dataclasses.asdict(j.config), j.variables, j.log_priors,
                                 device="cpu")
    return j, t


def test_preconditioner_on_the_transposed_layout():
    """Six updates of one [din=24, dout=10] kernel, update_period 4: the
    inverses are recomputed at updates 0 and 4 and reused between."""
    rng = np.random.default_rng(0)
    jtx = jng.scale_by_natural_gradient()
    kernel = jnp.zeros((24, 10), jnp.float32)
    jstate = jtx.init({"k": kernel})
    t = tng.NaturalGradient()
    tstate = t.init({"k.weight": torch.zeros(10, 24)})
    for _ in range(6):
        g = rng.normal(size=(24, 10)).astype(np.float32) * rng.uniform(0.1, 3.0, size=(1, 10))
        jout, jstate = jtx.update({"k": jnp.asarray(g)}, jstate)
        tout, tstate = t.update({"k.weight": torch.from_numpy(g.T.copy())}, tstate)
        close(tout["k.weight"].numpy().T, jout["k"], rel=1e-5)
        st, jst = tstate["factors"]["k.weight"], jstate.factors["k"]
        for a, b in ((st.f_in, jst.f_in), (st.f_out, jst.f_out), (st.p_in, jst.p_in),
                     (st.p_out, jst.p_out)):
            close(a.numpy(), b, rel=1e-5)
    assert tstate["step"] == int(jstate.step) == 6


def test_vectors_pass_through_the_gradient_transform():
    t = tng.NaturalGradient()
    params = {"a.weight": torch.zeros(3, 4), "a.bias": torch.zeros(3)}
    state = t.init(params)
    assert sorted(state["factors"]) == ["a.weight"]
    g = {"a.weight": torch.ones(3, 4), "a.bias": torch.arange(3.0)}
    out, _ = t.update(g, state)
    assert torch.equal(out["a.bias"], g["a.bias"])


def test_activation_fisher_statistics():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 50, 7)).astype(np.float32)
    g = rng.normal(size=(3, 50, 5)).astype(np.float32)
    for max_rows in (2048, 40):
        want = jng.activation_fisher_stats({"aff_in": (jnp.asarray(x),)},
                                           {"aff_out": jnp.asarray(g)}, max_rows)["aff"]
        got = tng.activation_fisher_stats({"aff": torch.from_numpy(x)},
                                          {"aff": torch.from_numpy(g)}, max_rows)["aff"]
        close(got["f_in"].numpy(), want["f_in"], rel=1e-5)
        close(got["f_out"].numpy(), want["f_out"], rel=1e-5)


def test_activation_transform_with_and_without_bias():
    rng = np.random.default_rng(2)
    jtx = jng.scale_by_natural_gradient_activations()
    jp = {"aff": {"kernel": jnp.zeros((6, 4)), "bias": jnp.zeros(4)},
          "lin": {"kernel": jnp.zeros((4, 3))}}
    jstate = jtx.init(jp)
    t = tng.NaturalGradientActivations()
    tp = {"aff.weight": torch.zeros(4, 6), "aff.bias": torch.zeros(4),
          "lin.weight": torch.zeros(3, 4)}
    tstate = t.init(tp)
    for _ in range(5):
        xa, ga = rng.normal(size=(40, 6)), rng.normal(size=(40, 4))
        xl, gl = rng.normal(size=(40, 4)), rng.normal(size=(40, 3))
        f = lambda a: np.asarray(a, np.float32)  # noqa: E731
        jstats = jng.activation_fisher_stats(
            {"aff_in": (jnp.asarray(f(xa)),), "lin_in": (jnp.asarray(f(xl)),)},
            {"aff_out": jnp.asarray(f(ga)), "lin_out": jnp.asarray(f(gl))})
        tstats = tng.activation_fisher_stats(
            {"aff": torch.from_numpy(f(xa)), "lin": torch.from_numpy(f(xl))},
            {"aff": torch.from_numpy(f(ga)), "lin": torch.from_numpy(f(gl))})
        gk, gb, gl2 = f(rng.normal(size=(6, 4))), f(rng.normal(size=4)), f(rng.normal(size=(4, 3)))
        jout, jstate = jtx.update(
            {"aff": {"kernel": jnp.asarray(gk), "bias": jnp.asarray(gb)},
             "lin": {"kernel": jnp.asarray(gl2)}}, jstate, ng_stats=jstats)
        tout, tstate = t.update({"aff.weight": torch.from_numpy(gk.T.copy()),
                                 "aff.bias": torch.from_numpy(gb),
                                 "lin.weight": torch.from_numpy(gl2.T.copy())},
                                tstate, ng_stats=tstats)
        close(tout["aff.weight"].numpy().T, jout["aff"]["kernel"], rel=1e-5)
        close(tout["aff.bias"].numpy(), jout["aff"]["bias"], rel=1e-5)
        close(tout["lin.weight"].numpy().T, jout["lin"]["kernel"], rel=1e-5)
    # without statistics the updates and the state pass through
    same, st2 = t.update({"lin.weight": torch.ones(3, 4)}, tstate)
    assert st2 is tstate and torch.equal(same["lin.weight"], torch.ones(3, 4))


def lockstep(optimizer, steps, rel, atol, ng_activation=False):
    j, t = carried(11)
    feats, labels = corpus(12)
    kw = dict(chunk_width=50, minibatch_size=6, optimizer=optimizer)
    jopt = jtrain.make_optimizer(jtrain.NnetTrainOptions(**kw), 20)
    topt = ttrain.make_optimizer(ttrain.NnetTrainOptions(**kw), 20)
    jstep = jtrain.make_ce_train_step(jtdnn.TdnnModel(j.config), jopt,
                                      ng_activation=ng_activation)
    t.model.train()
    tstep = ttrain.make_ce_train_step(t.model, topt, ng_activation=ng_activation)
    jstate = jtrain.TrainState(j.variables["params"], j.variables["batch_stats"],
                               jopt.init(j.variables["params"]), 0)
    tstate = ttrain.TrainState(topt.init(dict(t.model.named_parameters())), 0)
    batches = list(ttrain._chunk_batches(feats, labels, 50, 6, np.random.default_rng(13)))
    for bf, bl, bm in batches[:steps]:
        jstate, jm = jstep(jstate, bf, bl, bm)
        tstate, tm = tstep(tstate, bf, bl, bm)
        close(float(tm["loss"]), float(jm["loss"]), rel=rel)
    want = convert.torch_params_from_flax(jstate.params)
    for k, p in t.model.named_parameters():
        close(p.detach().numpy(), want[k], atol=atol)
    return tstep


def test_three_ng_sgd_ce_steps_in_lockstep():
    lockstep("ng-sgd", 3, rel=1e-5, atol=1e-5)


def test_one_ng_sgd_act_ce_step():
    step = lockstep("ng-sgd-act", 1, rel=1e-4, atol=1e-4, ng_activation=True)
    # the collector kept nothing past the step, and its hooks come off
    assert step.collector.inputs == {} and step.collector.grads == {}
    step.collector.remove()


@pytest.fixture(scope="module")
def yes_chain():
    return yesno_chain_objects()


def test_one_ng_sgd_act_chain_step(yes_chain):
    import old_kaldi_git_tpu.chain.loss as jloss
    import old_kaldi_git_tpu.recipes.chain as jchain
    from old_kaldi_git_tpu_torch.chain import loss as tloss
    from old_kaldi_git_tpu_torch.recipes import chain as tchain

    jcd, _, jden = yes_chain["jobj"]
    _, _, tden = yes_chain["tobj"]
    config = jtdnn.make_tdnnf(39, jcd.num_pdfs, 48, 12, 4, subsampled_stride=3,
                              num_full_rate_layers=2)
    j = jam.AmNnet.init(config, seed=3)
    t = convert.am_nnet_from_jax(dataclasses.asdict(config), j.variables, None, device="cpu")
    jopt = jtrain.make_optimizer(jtrain.NnetTrainOptions(optimizer="ng-sgd-act"), 10)
    topt = ttrain.make_optimizer(ttrain.NnetTrainOptions(optimizer="ng-sgd-act"), 10)
    jstep = jchain.make_chain_step(jtdnn.TdnnModel(config), jden, jopt,
                                   jloss.ChainLossOptions(), 3, ng_activation=True)
    t.model.train()
    tstep = tchain.make_chain_step(t.model, tden, topt, tloss.ChainLossOptions(), 3,
                                   ng_activation=True)
    jstate = jtrain.TrainState(j.variables["params"], j.variables["batch_stats"],
                               jopt.init(j.variables["params"]), 0)
    jstate, jl, jm = jstep(jstate, *yes_chain["args"])
    tstate, tl, tm = tstep(ttrain.TrainState(topt.init(dict(t.model.named_parameters())), 0),
                           *yes_chain["args"])
    close(float(tl), float(jl), rel=1e-4)
    want = convert.torch_params_from_flax(jstate.params)
    for k, p in t.model.named_parameters():
        close(p.detach().numpy(), want[k], atol=1e-4)
    assert tstate.step == 1 and tstate.opt_state["ng"]["step"] == 1
