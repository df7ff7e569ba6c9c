"""The LSTMP layer (models/recurrent.py) and the RNNLM (lm/rnnlm.py) in the
port against the JAX package on the CPU.

flax's parameters carried over (convert.torch_params_from_flax,
convert.rnnlm_from_jax): LstmpLayer within 1e-5 of flax's (the gate order
i, f, g, o, the forget bias +1 at run time, the cell clip, the bias-free
projection), with and without a non-recurrent part, reversed, and carried
across chunks; RnnLm.logprobs_batch within 1e-4 of the JAX package's;
5 train_rnnlm steps (one epoch of 160 sentences, batch 32, the same
permutation) within 1e-4; rescore_nbest_rnnlm's rankings equal; a pickle
the JAX package saved read back.  Sentences are drawn from a numpy seed."""

import tests.torch_threads  # noqa: F401
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import old_kaldi_git_tpu.lm.rnnlm as jrnn
import old_kaldi_git_tpu.models.recurrent as jrec
import old_kaldi_git_tpu_torch.lm.rnnlm as trnn
import old_kaldi_git_tpu_torch.models.recurrent as trec
from old_kaldi_git_tpu_torch import convert

TOL_LAYER = 1e-5
TOL_LM = 1e-4


def _sentences(n, num_words=50, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(w) for w in rng.integers(1, num_words + 1, rng.integers(1, 10))]
            for _ in range(n)]


def _jax_init(vocab, opts, T):
    """The JAX package's initial parameters, as its train_rnnlm draws them."""
    m = jrnn.RnnLmModule(vocab, opts.embed_dim, opts.cell_dim, opts.recurrent_dim)
    p = m.init(jax.random.PRNGKey(opts.seed), jnp.zeros((1, T), jnp.int32))["params"]
    return jax.tree.map(np.asarray, p)


def _layer_pair(D, C, R, N=0, reverse=False, seed=0, clip=50.0):
    jl = jrec.LstmpLayer(C, R, N, cell_clip=clip, reverse=reverse)
    x = np.random.default_rng(seed).normal(size=(3, 11, D)).astype(np.float32) * 2.0
    params = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    tl = trec.LstmpLayer(D, C, R, N, cell_clip=clip, reverse=reverse)
    tl.load_state_dict({k: torch.from_numpy(v)
                        for k, v in convert.torch_params_from_flax(params).items()})
    return jl, params, tl, x


@pytest.mark.parametrize("N,reverse", [(0, False), (8, False), (0, True)])
def test_lstmp_layer_equals_flax(N, reverse):
    jl, params, tl, x = _layer_pair(12, 16, 6, N, reverse)
    want = np.asarray(jl.apply({"params": params}, jnp.asarray(x)))
    got = tl(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (3, 11, 6 + N)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_LAYER)


def test_lstmp_carry_across_chunks_and_the_cell_clip():
    jl, params, tl, x = _layer_pair(12, 16, 6, 4, seed=1, clip=1.5)
    x = x * 40.0  # drives the cell to its clip
    jy, (jc, jr) = jl.apply({"params": params}, jnp.asarray(x[:, :5]), return_carry=True)
    jy2 = jl.apply({"params": params}, jnp.asarray(x[:, 5:]), initial_carry=(jc, jr))
    ty, carry = tl(torch.from_numpy(x[:, :5]), return_carry=True)
    ty2 = tl(torch.from_numpy(x[:, 5:]), initial_carry=carry)
    np.testing.assert_allclose(carry[0].detach().numpy(), np.asarray(jc), atol=TOL_LAYER)
    np.testing.assert_allclose(torch.cat([ty, ty2], 1).detach().numpy(),
                               np.concatenate([jy, jy2], 1), atol=TOL_LAYER)
    whole = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(torch.cat([ty, ty2], 1).detach().numpy(), whole, atol=1e-6)
    assert float(carry[0].detach().abs().max()) == pytest.approx(1.5)
    with pytest.raises(ValueError):
        trec.LstmpLayer(12, 16, 6, reverse=True)(torch.from_numpy(x), return_carry=True)


@pytest.fixture(scope="module")
def lockstep():
    seqs = _sentences(160)
    opts = dict(num_epochs=1, batch_size=32, learning_rate=3e-3, seed=0)
    jopts, topts = jrnn.RnnLmOptions(**opts), trnn.RnnLmOptions(**opts)
    vocab = 50 + 3
    p0 = _jax_init(vocab, jopts, max(len(s) for s in seqs) + 1)
    init = convert.rnnlm_from_jax(p0, topts, vocab, "cpu")
    history = []
    return dict(seqs=seqs, p0=p0, init=init, jopts=jopts, topts=topts, vocab=vocab,
                jlm=jrnn.train_rnnlm(seqs, 50, jopts),
                tlm=trnn.train_rnnlm(seqs, 50, topts, device="cpu", init=init,
                                     history=history),
                history=history)


def test_logprobs_batch_with_carried_weights(lockstep):
    seqs = lockstep["seqs"][:40] + [[7], [3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3]]
    want = jrnn.RnnLm(lockstep["p0"], lockstep["jopts"], lockstep["vocab"]).logprobs_batch(seqs)
    got = lockstep["init"].logprobs_batch(seqs)
    assert got.dtype == np.float64 and got.shape == (len(seqs),)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_LM)
    assert lockstep["init"].score([7]) == pytest.approx(-float(want[-2]), abs=TOL_LM)
    assert lockstep["init"].logprobs_batch([]).shape == (0,)


def test_five_train_steps_in_lockstep(lockstep):
    jlm, tlm = lockstep["jlm"], lockstep["tlm"]
    hist = lockstep["history"]
    assert len(hist) == 1 and len(hist[0]["losses"]) == 5 == len(hist[0]["step_seconds"])
    assert hist[0]["perplexity"] == pytest.approx(np.exp(np.mean(hist[0]["losses"])))
    got = trnn.flax_params(tlm.model)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jlm.params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_LM)
    seqs = lockstep["seqs"][:50]
    np.testing.assert_allclose(tlm.logprobs_batch(seqs), jlm.logprobs_batch(seqs), rtol=0,
                               atol=TOL_LM)
    # the parameters moved: 5 Adam steps of 3e-3
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(got), jax.tree.leaves(lockstep["p0"])))
    assert moved > 5e-3


def test_rescore_nbest_rnnlm_ranks_as_the_jax_package(lockstep):
    rng = np.random.default_rng(3)
    nbest = [(s, float(c)) for s, c in zip(_sentences(10, seed=3), rng.uniform(10, 12, 10))]
    old = lambda w: 0.3 * len(w)  # noqa: E731
    got = trnn.rescore_nbest_rnnlm(nbest, lockstep["tlm"], old, 0.8)
    want = jrnn.rescore_nbest_rnnlm(nbest, lockstep["jlm"], old, 0.8)
    assert [w for w, _ in got] == [w for w, _ in want]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want], atol=TOL_LM)
    assert trnn.rescore_nbest_rnnlm([], lockstep["tlm"], old) == []


def test_save_and_load(lockstep, tmp_path):
    jpath, tpath = tmp_path / "j.pkl", tmp_path / "t.pkl"
    jrnn.save_rnnlm(lockstep["jlm"], str(jpath))
    seqs = lockstep["seqs"][:20]
    from_jax = trnn.load_rnnlm(str(jpath), device="cpu")
    assert from_jax.opts == lockstep["topts"] and from_jax.vocab == lockstep["vocab"]
    np.testing.assert_allclose(from_jax.logprobs_batch(seqs),
                               lockstep["jlm"].logprobs_batch(seqs), atol=TOL_LM)
    trnn.save_rnnlm(lockstep["tlm"], str(tpath))
    back = trnn.load_rnnlm(str(tpath), device="cpu")
    np.testing.assert_array_equal(back.logprobs_batch(seqs), lockstep["tlm"].logprobs_batch(seqs))
    with open(tpath, "rb") as f:  # the JAX package's layout: its flax tree
        d = pickle.load(f)
    assert d["kind"] == "rnnlm" and set(d["params"]) == {"embed", "lstm", "softmax"}
    assert d["params"]["softmax"]["kernel"].shape == (32, lockstep["vocab"])


def test_a_model_of_its_own_learns_the_pattern():
    """The JAX package's test: word 1 is always followed by word 2."""
    rng = np.random.default_rng(0)
    seqs = []
    for _ in range(200):
        s = []
        for _ in range(rng.integers(2, 6)):
            s.append(2 if s and s[-1] == 1 else int(rng.integers(1, 5)))
        seqs.append(s)
    lm = trnn.train_rnnlm(seqs, num_words=4, opts=trnn.RnnLmOptions(num_epochs=15),
                          device="cpu")
    assert lm.logprobs_batch([[1, 2, 3]])[0] > lm.logprobs_batch([[1, 4, 3]])[0] + 1.0
    resc = trnn.rescore_nbest_rnnlm([([1, 4, 3], 10.0), ([1, 2, 3], 10.5)], lm, lambda w: 0.0)
    assert resc[0][0] == [1, 2, 3]
    # its initial draw has flax's scales: lecun normal kernels, zero biases
    fresh = trnn.make_rnnlm(4, trnn.RnnLmOptions(), device="cpu").model
    w = fresh.lstm.cell.gates.weight.detach()
    assert abs(float(w.std()) * w.shape[1] ** 0.5 - 1.0) < 0.1
    assert float(fresh.softmax.bias.detach().abs().max()) == 0.0
    if not torch.cuda.is_available():  # the entry points run on the card unless told
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trnn.make_rnnlm(4)
