"""The port's stage-gated system build, on the CPU.

`utils/pipeline.py`: stages run in number order, a stage below `--stage`
or with all its artifacts present is skipped, a stage with no artifacts
always runs, per-stage logs.  `lm/ngram.py`'s pruning, ARPA writer and
perplexity against the JAX package's: the same ARPA text, the same
perplexity.  `save_csr` / `load_csr` round trips, folded and split-eps.
`build_system --stage 9` on a workdir holding the committed stage 1-8
artifacts, at options small enough for the CPU (the first 100 training
utterances and their alignments, an 8-Gaussian UBM, 4-dim iVectors,
2-layer 32-wide models, one epoch, a chain tree of about 40 leaves on a
first-order phone LM):
it writes final.ie, final_ivec.am and chain_ivec.mdl, skips them on a
second run, they load through load_system / load_chain_system, and the
chain+iVec model, whose tree is not chain.mdl's, is refused on
chain_hclg.npz.  The entry point parses --workdir, --stage and
--device."""

import tests.torch_threads  # noqa: F401
import dataclasses
import os

import numpy as np
import pytest

import old_kaldi_git_tpu.lm.ngram as jngram
from old_kaldi_git_tpu_torch.lm import ngram as tngram
from old_kaldi_git_tpu_torch.recipes import minilib
from old_kaldi_git_tpu_torch.utils.log import KaldiError
from old_kaldi_git_tpu_torch.utils.pipeline import Pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "exp", "minilib")
STAGES_1_TO_8 = ("arpa.txt.gz", "mono.mdl", "mono_ali.pkl", "tri.mdl", "tri_ali.pkl",
                 "tree.pkl", "final.am", "hclg.npz", "chain.mdl", "chain_hclg.npz")


def test_pipeline_skips_by_stage_and_by_artifact(tmp_path):
    ran = []
    pipe = Pipeline(str(tmp_path), stage=2, log_to_files=False)
    for n, produces in ((3, "c.txt"), (1, "a.txt"), (2, ("b.txt", "b2.txt")), (4, ())):
        @pipe.stage(n, f"s{n}", produces=produces)
        def _(ctx, n=n, produces=produces):
            ran.append(n)
            for p in ([produces] if isinstance(produces, str) else produces):
                open(ctx.path(p), "w").close()
    (tmp_path / "b.txt").touch()  # one of stage 2's two artifacts
    pipe.run()
    assert ran == [2, 3, 4]
    ran.clear()
    pipe.run()  # every artifact present now: only the stage without any runs
    assert ran == [4]


def test_pipeline_stage_logs(tmp_path):
    pipe = Pipeline(str(tmp_path))

    @pipe.stage(5, "say hello", produces="out/hello.txt")
    def _(ctx):
        print("hello from the stage")
        with open(ctx.path("out", "hello.txt"), "w") as f:
            f.write("hi")

    pipe.run()
    text = (tmp_path / "log" / "5.say_hello.log").read_text()
    assert "hello from the stage" in text and "# done in" in text


def test_lm_pruning_arpa_and_perplexity(tmp_path):
    rng = np.random.default_rng(0)
    vocab = [f"w{i}" for i in range(30)]
    sents = [[vocab[j] for j in rng.integers(0, 30, size=rng.integers(3, 9))]
             for _ in range(400)]
    held = sents[:40]
    jlm = jngram.prune_ngram_lm(jngram.estimate_ngram_lm(sents, 3, cutoffs=(0, 0, 1)), 1e-4)
    tlm = tngram.prune_ngram_lm(tngram.estimate_ngram_lm(sents, 3, cutoffs=(0, 0, 1)), 1e-4)
    jngram.write_arpa(jlm, str(tmp_path / "j.arpa"))
    tngram.write_arpa(tlm, str(tmp_path / "t.arpa"))
    assert (tmp_path / "j.arpa").read_text() == (tmp_path / "t.arpa").read_text()
    assert len(tlm.ngrams) < len(tngram.estimate_ngram_lm(sents, 3, cutoffs=(0, 0, 1)).ngrams)
    assert tngram.perplexity(tlm, held) == jngram.perplexity(jlm, held)


@pytest.mark.parametrize("name", ["hclg.npz", "chain_hclg.npz"])
def test_save_csr_round_trip(name, tmp_path):
    from old_kaldi_git_tpu_torch.recipes.chain import ChainModel
    from old_kaldi_git_tpu_torch import convert

    if name == "hclg.npz":
        tid_to_pdf = convert.tid_to_pdf_from_transition_model(
            convert.load_pickle(os.path.join(WORKDIR, "tree.pkl"))[1])
    else:
        tid_to_pdf = ChainModel.load(os.path.join(WORKDIR, "chain.mdl"),
                                     device="cpu").tid_to_pdf
    a = minilib.load_csr(os.path.join(WORKDIR, name), tid_to_pdf)
    out = str(tmp_path / name)
    minilib.save_csr(out, a, omit_pdf=True)
    with np.load(os.path.join(WORKDIR, name)) as want, np.load(out) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


SMALL = minilib.MinilibOptions(ivector_ubm_gauss=8, ivector_dim=4, hidden_dim=32,
                               bottleneck_dim=8, num_layers=2, num_epochs=1, chain_epochs=1,
                               tree_leaves=40)
FIRST = 100  # training utterances of the stage 9 build


def test_build_system_from_stage_9(tmp_path, monkeypatch):
    # a first-order phone LM and minibatches of 100 keep stage 11's den graph
    # to seconds on the CPU; so do the first 100 training utterances and
    # their alignments in tri_ali.pkl for stages 9-11
    full = minilib.chain_train_options
    monkeypatch.setattr(minilib, "chain_train_options", lambda o: dataclasses.replace(
        full(o), phone_lm_order=1, minibatch_size=100))
    waves, text = minilib.training_set(SMALL)
    keys = sorted(waves)[:FIRST]
    monkeypatch.setattr(minilib, "training_set", lambda o: (
        {k: waves[k] for k in keys}, {k: text[k] for k in keys}))
    tri_system = minilib._tri_system

    def first_utterances(workdir):
        tri, ali = tri_system(workdir)
        return tri, {k: ali[k] for k in keys}

    monkeypatch.setattr(minilib, "_tri_system", first_utterances)
    wd = str(tmp_path / "sys")
    os.makedirs(wd)
    for name in STAGES_1_TO_8:
        os.symlink(os.path.join(WORKDIR, name), os.path.join(wd, name))
    minilib.build_system(wd, SMALL, stage=9, device="cpu")
    made = ("final.ie", "final_ivec.am", "chain_ivec.mdl")
    assert all(os.path.exists(os.path.join(wd, n)) for n in made)
    stamps = [os.path.getmtime(os.path.join(wd, n)) for n in made]

    def refuse(*a, **k):
        raise AssertionError("a stage whose artifacts exist ran again")

    for fn in ("train_ivector_system", "train_am_ivec_system", "train_chain_ivec_system",
               "train_am_system", "train_mono_system", "train_tri_system", "train_chain"):
        monkeypatch.setattr(minilib, fn, refuse)
    minilib.build_system(wd, SMALL, stage=2, device="cpu")
    assert stamps == [os.path.getmtime(os.path.join(wd, n)) for n in made]
    monkeypatch.undo()

    system = minilib.load_system(wd, device="cpu")
    am, ext = minilib.ivector_models(system)
    assert (am.ivector_dim, ext.ivector_dim, am.config.input_dim) == (4, 4, 43)
    with pytest.raises(KaldiError, match="cannot decode on that graph"):
        minilib.load_chain_system(wd, use_ivectors=True, device="cpu")
    from old_kaldi_git_tpu_torch.recipes.chain import ChainModel

    civ = ChainModel.load(os.path.join(wd, "chain_ivec.mdl"), device="cpu")
    assert civ.ctx_dep.num_pdfs < 50 and civ.am.ivector_dim == 4
    own = minilib.ChainSystem(system.words, system.csr, civ)
    assert minilib.on_graph_of(own, civ, ext).model is civ
    committed = minilib.load_chain_system(wd, device="cpu")
    with pytest.raises(KaldiError, match="cannot decode on that graph"):
        minilib.on_graph_of(committed, civ, ext)


def test_entry_point_arguments(monkeypatch):
    seen = {}
    monkeypatch.setattr(minilib, "build_system",
                        lambda wd, opts, stage, device: seen.update(
                            wd=wd, stage=stage, device=device))
    minilib.main(["--workdir", "/x/y", "--stage", "9", "--device", "cpu"])
    assert seen == {"wd": "/x/y", "stage": 9, "device": "cpu"}
    minilib.main(["--workdir", "d"])
    assert seen == {"wd": "d", "stage": 0, "device": None}
