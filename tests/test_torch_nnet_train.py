"""The port's CE training against the JAX package's, on the CPU.

A TDNN-F of 3 layers, 64 wide with a 16-dim bottleneck, 40 pdfs, 13-dim
input; the port starts from the JAX package's initial parameters and
batch-norm statistics (convert.am_nnet_from_jax), the inputs are made from a
seed with numpy.  Tolerances, float32 in both packages with sums in other
orders:

- train-mode batch-norm outputs and running statistics after two updates,
  the CE loss and its gradients, the priors: within 1e-5 relative to the
  largest value of each (a few float32 ulps on outputs of order 1-10);
  `average_models`: within 1e-6;
- one optimizer update from the same gradients (Adam, the learning-rate
  schedule, name factors, max-change clipping in play) and the
  orthonormal constraint: within 1e-6 absolute (updates and weights of
  order 1e-3 and 1);
- 5 CE steps in lockstep on the same chunks, plain and with backstitch:
  the losses within 1e-4 relative, every parameter within 1e-4 absolute
  (ROADMAP's bar for training parity);
- the halved-LR retry and the abort on a non-finite objective as the JAX
  package's tests hold them (tests/test_models.py);
- save/load: exact.
`-m slow`: train_tdnn on yesno to WER 0, as tests/test_models.py's e2e."""

import tests.torch_threads  # noqa: F401
import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import old_kaldi_git_tpu.models.am_nnet as jam
import old_kaldi_git_tpu.models.tdnn as jtdnn
import old_kaldi_git_tpu.models.train as jtrain
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.models import tdnn as ttdnn
from old_kaldi_git_tpu_torch.models import train as ttrain
from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet
from old_kaldi_git_tpu_torch.utils.log import KaldiError

D, P = 13, 40
CONFIG = dict(input_dim=D, num_outputs=P, hidden_dim=64, bottleneck_dim=16, num_layers=3)


def close(got, want, rel=None, atol=None):
    want = np.asarray(want)
    tol = atol if atol is not None else rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol)


def jax_am(seed=0):
    return jam.AmNnet.init(jtdnn.make_tdnnf(**CONFIG), seed=seed)


def carry(j):
    return convert.am_nnet_from_jax(dataclasses.asdict(j.config), j.variables,
                                    j.log_priors, device="cpu")


def same_params(tmodel, jparams, atol):
    want = convert.torch_params_from_flax(jparams)
    got = {k: v.detach().numpy() for k, v in tmodel.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], atol=atol)


def same_stats(tmodel, jstats, rel):
    for name, module in tmodel.named_children():
        if hasattr(module, "mean"):
            close(module.mean.numpy(), jstats[name]["batchnorm"]["mean"], rel=rel)
            close(module.var.numpy(), jstats[name]["batchnorm"]["var"], rel=rel)


def corpus(seed, n_utts=10, T=(70, 200)):
    """Utterances of frames near 40 class means, labelled by class."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(P, D)) * 2
    feats, labels = {}, {}
    for u in range(n_utts):
        n = int(rng.integers(*T))
        lab = np.repeat(rng.integers(0, P, size=n // 5 + 1), 5)[:n].astype(np.int32)
        feats[f"u{u:02d}"] = (means[lab] + rng.normal(size=(n, D))).astype(np.float32)
        labels[f"u{u:02d}"] = lab
    return feats, labels


def test_train_mode_batchnorm_and_running_statistics():
    j = jax_am()
    t = carry(j)
    model = jtdnn.TdnnModel(j.config)
    variables = dict(j.variables)
    t.model.train()
    rng = np.random.default_rng(1)
    for _ in range(2):  # two updates of the running statistics
        x = rng.normal(size=(3, 25, D)).astype(np.float32) * 2
        want, mutated = model.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
        got = t.model(torch.from_numpy(x))
        close(got.detach().numpy(), want, rel=1e-5)
    same_stats(t.model, variables["batch_stats"], rel=1e-5)
    t.model.eval()


def jax_ce_loss(model, params, batch_stats, x, y, m):
    """The JAX package's CE loss_fn (models/train.py make_ce_train_step)."""
    logits, _ = model.apply({"params": params, "batch_stats": batch_stats}, x, train=True,
                            mutable=["batch_stats"])
    logp = jax.nn.log_softmax(logits, axis=-1)
    ll = jnp.take_along_axis(logp, y[..., None], axis=-1)[..., 0]
    return -(ll * m).sum() / jnp.maximum(m.sum(), 1.0)


def test_ce_loss_and_gradients_on_fixed_parameters():
    j = jax_am(2)
    t = carry(j)
    feats, labels = corpus(3)
    bf, bl, bm = next(ttrain._chunk_batches(feats, labels, 60, 6, np.random.default_rng(0)))
    model = jtdnn.TdnnModel(j.config)
    loss, grads = jax.value_and_grad(jax_ce_loss, argnums=1)(
        model, j.variables["params"], j.variables["batch_stats"], jnp.asarray(bf),
        jnp.asarray(bl), jnp.asarray(bm))
    t.model.train()
    tloss, metrics = ttrain.ce_loss(t.model, torch.from_numpy(bf),
                                    torch.from_numpy(bl).long(), torch.from_numpy(bm))
    tloss.backward()
    close(float(tloss.detach()), float(loss), rel=1e-5)
    want = convert.torch_params_from_flax(grads)
    for k, p in t.model.named_parameters():
        close(p.grad.numpy(), want[k], rel=1e-4)
    assert 0.0 <= float(metrics["acc"]) <= 1.0


def test_one_optimizer_update_against_optax():
    """Two updates from fixed gradients, large enough that max-change
    clips per component and globally, with learning-rate factors."""
    j = jax_am(4)
    params = j.variables["params"]
    rng = np.random.default_rng(5)
    opts = jtrain.NnetTrainOptions(l2_regularize=1e-3, max_change_per_component=0.05,
                                   max_param_change=0.06)
    factors = {"tdnnf*": 0.5, "output": 2.0}
    jopt = jtrain.make_optimizer(opts, 10, lr_factors=factors)
    topt = ttrain.make_optimizer(ttrain.NnetTrainOptions(**dataclasses.asdict(opts)), 10,
                                 lr_factors=factors)
    tparams = {k: torch.from_numpy(v) for k, v in convert.torch_params_from_flax(params).items()}
    jstate, tstate = jopt.init(params), topt.init(tparams)
    for _ in range(2):
        g = jax.tree.map(lambda p: (rng.normal(size=p.shape) * 30).astype(np.float32), params)
        ju, jstate = jopt.update(g, jstate, params)
        tg = {k: torch.from_numpy(v) for k, v in convert.torch_params_from_flax(g).items()}
        tu, tstate = topt.update(tg, tstate, tparams)
        want = convert.torch_params_from_flax(ju)
        for k in want:
            close(tu[k].numpy(), want[k], atol=1e-6)
    assert tstate["count"] == 2
    # the clip was in play: the global norm sits at its bound
    norm = np.sqrt(sum(float((v.double() ** 2).sum()) for v in tu.values()))
    assert abs(norm - 0.06) < 1e-6
    # the carried Adam state is the JAX package's
    carried = convert.optimizer_state_from_jax(jstate)
    assert carried["count"] == 2
    for k in tstate["mu"]:
        close(tstate["mu"][k].numpy(), carried["mu"][k].numpy(), atol=1e-6)


def test_unported_optimizer_raises():
    """An optimizer neither package has raises as the JAX package's does
    (the natural-gradient ones are ported: tests/test_torch_natural_gradient.py)."""
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttrain.make_optimizer(ttrain.NnetTrainOptions(optimizer="rmsprop"), 10)
    with pytest.raises(ValueError, match="unknown optimizer"):
        jtrain.make_optimizer(jtrain.NnetTrainOptions(optimizer="rmsprop"), 10)


@pytest.mark.parametrize("backstitch", [0.0, 0.3])
def test_five_ce_steps_in_lockstep(backstitch):
    j = jax_am(6)
    t = carry(j)
    feats, labels = corpus(7)
    kw = dict(chunk_width=50, minibatch_size=6, backstitch_scale=backstitch,
              backstitch_interval=2)
    jopts = jtrain.NnetTrainOptions(**kw)
    topts = ttrain.NnetTrainOptions(**kw)
    jopt, topt = jtrain.make_optimizer(jopts, 20), ttrain.make_optimizer(topts, 20)
    jstep = jtrain.make_ce_train_step(jtdnn.TdnnModel(j.config), jopt,
                                      backstitch_scale=backstitch, backstitch_interval=2)
    t.model.train()
    tstep = ttrain.make_ce_train_step(t.model, topt, backstitch, 2)
    jstate = jtrain.TrainState(j.variables["params"], j.variables["batch_stats"],
                               jopt.init(j.variables["params"]), 0)
    tstate = ttrain.TrainState(topt.init(dict(t.model.named_parameters())), 0)
    jb = list(jtrain._chunk_batches(feats, labels, 50, 6, np.random.default_rng(8)))
    tb = list(ttrain._chunk_batches(feats, labels, 50, 6, np.random.default_rng(8)))
    assert len(jb) == len(tb) >= 5
    for (jf, jl, jm), (tf, tl, tm) in zip(jb[:5], tb[:5]):
        for a, b in ((jf, tf), (jl, tl), (jm, tm)):
            np.testing.assert_array_equal(a, b)
        jstate, jm_ = jstep(jstate, jf, jl, jm)
        tstate, tm_ = tstep(tstate, tf, tl, tm)
        close(float(tm_["loss"]), float(jm_["loss"]), rel=1e-4)
    assert tstate.step == int(jstate.step) == 5
    same_params(t.model, jstate.params, atol=1e-4)
    same_stats(t.model, jstate.batch_stats, rel=1e-4)


def test_constrain_orthonormal_in_both_orientations():
    rng = np.random.default_rng(9)
    for shape in ((16, 64), (64, 16)):
        w = rng.normal(size=shape).astype(np.float32) * 0.3
        close(ttdnn.constrain_orthonormal(torch.from_numpy(w)).numpy(),
              jtdnn.constrain_orthonormal(jnp.asarray(w)), atol=1e-6)
    # on a model: the tdnnf `linear` kernels, in flax's orientation
    j = jax_am(10)
    t = carry(j)
    ttdnn.apply_orthonormal_constraints(t.model)
    same_params(t.model, jtdnn.apply_orthonormal_constraints(j.variables["params"]),
                atol=1e-6)


def separable(seed, n_utts=6):
    """tests/test_models.py's _separable_data."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(6, 8)) * 3
    feats, labels = {}, {}
    for u in range(n_utts):
        lab = np.repeat(rng.integers(0, 6, size=12), 5).astype(np.int32)
        feats[f"u{u}"] = (means[lab] + 0.3 * rng.normal(size=(60, 8))).astype(np.float32)
        labels[f"u{u}"] = lab
    return feats, labels


def test_divergence_recovery_halves_the_learning_rate():
    feats, labels = separable(2)
    am = AmNnet.init(ttdnn.make_tdnn(8, 6, hidden_dim=32, num_layers=2), device="cpu")
    opts = ttrain.NnetTrainOptions(num_epochs=4, minibatch_size=4, chunk_width=30,
                                   initial_lr=3e3, final_lr=3e3, optimizer="sgd",
                                   max_param_change=1e6, max_change_per_component=1e6,
                                   max_lr_retries=20)
    warnings = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warnings.append(record.getMessage())
    ttrain.log.addHandler(handler)
    try:
        trained = ttrain.train_ce(am, feats, labels, opts)
    finally:
        ttrain.log.removeHandler(handler)
    assert any("retrying with LR scale" in w for w in warnings)
    assert torch.isfinite(trained.logits(feats["u0"][None])).all()


def test_nonfinite_objective_aborts():
    feats, labels = separable(3, n_utts=2)
    feats["u0"][:] = np.nan
    am = AmNnet.init(ttdnn.make_tdnn(8, 6, hidden_dim=16, num_layers=1), device="cpu")
    opts = ttrain.NnetTrainOptions(num_epochs=2, minibatch_size=2, chunk_width=30,
                                   max_lr_retries=1)
    with pytest.raises(KaldiError, match="non-finite"):
        ttrain.train_ce(am, feats, labels, opts)


def test_priors_from_posteriors():
    j = jax_am(11)
    t = carry(j)
    x = np.random.default_rng(12).normal(size=(4, 30, D)).astype(np.float32)
    nf = np.array([30, 22, 9, 17], np.int32)
    j.set_priors_from_posteriors(x, nf)
    t.set_priors_from_posteriors(x, nf)
    close(t.log_priors.numpy(), j.log_priors, rel=1e-5)


def test_average_models():
    """Parameters, batch-norm statistics and priors averaged with weights,
    as the JAX package's average_models: within 1e-6 of the largest."""
    js = [jax_am(seed) for seed in (15, 16)]
    rng = np.random.default_rng(17)
    for j in js:
        j.log_priors = np.log(rng.dirichlet(np.ones(P))).astype(np.float32)
    want = jtrain.average_models(js, [0.3, 0.9])
    got = ttrain.average_models([carry(j) for j in js], [0.3, 0.9])
    same_params(got.model, want.variables["params"], atol=1e-6)
    same_stats(got.model, want.variables["batch_stats"], rel=1e-6)
    close(got.log_priors.numpy(), want.log_priors, rel=1e-6)


def test_save_and_load(tmp_path):
    t = carry(jax_am(13))
    t.set_priors_from_posteriors(np.ones((1, 5, D), np.float32))
    t.ivector_dim = 3
    path = str(tmp_path / "final.am")
    t.save(path)
    back = AmNnet.load(path, device="cpu")
    assert back.config == t.config and back.ivector_dim == 3
    x = np.random.default_rng(14).normal(size=(2, 12, D)).astype(np.float32)
    np.testing.assert_array_equal(back.loglikes_batch(x).numpy(), t.loglikes_batch(x).numpy())
    for (k, a), (k2, b) in zip(t.model.state_dict().items(), back.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b)


def test_training_entry_points_default_to_the_gpu_and_raise_without_one():
    """train_tdnn and train_chain run on the card unless the caller names the
    CPU; without a card they raise before any work."""
    if torch.cuda.is_available():
        return
    from old_kaldi_git_tpu_torch.recipes.chain import train_chain
    from old_kaldi_git_tpu_torch.recipes.nnet3 import train_tdnn

    feats, labels = separable(4, n_utts=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_tdnn(None, feats, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_chain(None, feats, {}, None)


@pytest.mark.slow
def test_train_tdnn_on_yesno_to_wer_0():
    """tests/test_models.py::test_tdnn_e2e_yesno through the port on the CPU."""
    from old_kaldi_git_tpu_torch.decoder.graph import mkgraph_csr
    from old_kaldi_git_tpu_torch.fst.lang import make_unigram_grammar_fst
    from old_kaldi_git_tpu_torch.recipes.decode import score_hyps
    from old_kaldi_git_tpu_torch.recipes.mono import MonoTrainOptions, train_mono
    from old_kaldi_git_tpu_torch.recipes.nnet3 import decode_tdnn, train_tdnn
    from old_kaldi_git_tpu_torch.recipes.yesno import compute_feats, make_corpus, make_lang
    from old_kaldi_git_tpu_torch.tree.context_dep import monophone_context_dependency

    train_waves, train_text, test_waves, test_text = make_corpus(24, 8)
    train_feats = compute_feats(train_waves, "cpu")
    test_feats = compute_feats(test_waves, "cpu")
    lang = make_lang()
    gmm, ali = train_mono(train_feats, train_text, lang, MonoTrainOptions(
        num_iters=10, totgauss=60, realign_iters=(1, 2, 3, 4, 5, 6, 8)), device="cpu")
    am = train_tdnn(gmm, train_feats, ali, hidden_dim=64, num_layers=3,
                    opts=ttrain.NnetTrainOptions(num_epochs=20, minibatch_size=8,
                                                 chunk_width=50, initial_lr=5e-3,
                                                 final_lr=5e-4), device="cpu")
    g = make_unigram_grammar_fst(list(train_text.values()), lang.words)
    phones = lang.real_phone_ids
    topo = gmm.tm.topo
    cd = monophone_context_dependency(phones, {p: topo.num_pdf_classes(p) for p in phones})
    csr = mkgraph_csr(lang, g, cd, gmm.tm)
    stats = score_hyps(test_text, decode_tdnn(am, csr, lang, test_feats, beam=20.0))
    assert stats.wer == 0.0, stats.report()
