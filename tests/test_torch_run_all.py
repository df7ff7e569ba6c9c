"""The port's run_all (the five BASELINE configs as one stage-gated
pipeline) on the CPU.

Tier 1 runs stages 0-40 (data, mono, tri1, LDA+MLLT, the fMLLR decode):
tri2b and tri2b+fmllr at WER <= 2.0 as tests/test_run_all.py gates them,
the artifacts read by the JAX package (the `.mdl`, the tree, the `ivec`
archive, the feature archive), and a second run that skips every stage and
leaves RESULTS as it was.  `-m slow` runs every stage, with
tests/test_run_all.py's gates (about 30 s)."""

import tests.torch_threads  # noqa: F401
import os
import time

import numpy as np
import pytest

from old_kaldi_git_tpu_torch.recipes import run_all

TRAINERS = ("train_mono", "train_deltas", "train_lda_mllt", "train_tdnn", "train_chain",
            "decode_dataset", "train_ubm")


def _results(work):
    wers, rtf = {}, None
    for ln in open(os.path.join(work, "RESULTS")).read().splitlines():
        if ln.startswith("%WER"):
            wers[ln.split("[")[1].rstrip("]")] = float(ln.split()[1])
        elif ln.startswith("RTF"):
            rtf = float(ln.split()[1])
    return wers, rtf


def _run(work, last=None):
    pipe = run_all.build_pipeline(work, device="cpu")
    if last is not None:
        pipe._stages[:] = [s for s in pipe._stages if s[0] <= last]
    return pipe.run()


def _refuse_reruns(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a stage whose artifacts exist ran again")

    for fn in TRAINERS:
        monkeypatch.setattr(run_all, fn, refuse)


def test_stages_0_to_40_then_resume(tmp_path, monkeypatch):
    work = str(tmp_path / "exp")
    ctx = _run(work, last=40)
    assert sorted(ctx.stage_seconds) == [0, 10, 20, 30, 40]
    wers, _ = _results(work)
    assert set(wers) == {"tri2b", "tri2b+fmllr"}
    assert all(w <= 2.0 for w in wers.values()), wers
    logs = os.listdir(os.path.join(work, "log"))
    assert any("train_lda+mllt" in n for n in logs)

    # the artifacts read in the JAX package
    from old_kaldi_git_tpu.gmm.diag_gmm import AmGmmModel as JModel
    from old_kaldi_git_tpu.tree.context_dep import ContextDependency as JCtx
    from old_kaldi_git_tpu.utils.table import read_table as jread

    model = JModel.load(os.path.join(work, "tri2b/final.mdl"))
    with open(os.path.join(work, "tri2b/tree"), "rb") as f:
        tree = JCtx.read(f)
    assert model.am.num_pdfs == tree.num_pdfs and model.am.dim == 20
    ali = jread(f"ark:{os.path.join(work, 'tri2b/ali.ark')}", "ivec")
    feats = jread(f"ark:{os.path.join(work, 'data/static_train.ark')}", "mat")
    assert len(ali) == run_all.NUM_TRAIN and sorted(ali) == sorted(feats)
    assert all(len(ali[k]) == len(feats[k]) for k in ali)
    assert np.load(os.path.join(work, "tri2b/transform.npy")).shape == (20, 91)

    before = open(os.path.join(work, "RESULTS")).read()
    _refuse_reruns(monkeypatch)
    t0 = time.time()
    ctx = _run(work, last=40)
    assert time.time() - t0 < 5.0 and ctx.stage_seconds == {}
    assert open(os.path.join(work, "RESULTS")).read() == before


def test_entry_point_arguments(monkeypatch, capsys, tmp_path):
    seen = {}

    def fake(wd, stage, device):
        seen.update(wd=wd, stage=stage, device=device)
        os.makedirs(wd, exist_ok=True)
        with open(os.path.join(wd, "RESULTS"), "w") as f:
            f.write("%WER 0.00 [x]\n")

    monkeypatch.setattr(run_all, "run_all", fake)
    wd = str(tmp_path / "w")
    run_all.main(["--workdir", wd, "--stage", "30", "--device", "cpu"])
    assert seen == {"wd": wd, "stage": 30, "device": "cpu"}
    assert "%WER 0.00 [x]" in capsys.readouterr().out
    run_all.main(["--workdir", wd])
    assert seen["stage"] == 0 and seen["device"] is None


@pytest.mark.slow
def test_every_stage_then_resume(tmp_path, monkeypatch):
    work = str(tmp_path / "exp")
    run_all.run_all(work, device="cpu")
    print(open(os.path.join(work, "RESULTS")).read())
    wers, rtf = _results(work)
    # tests/test_run_all.py's gates
    for name in ("tri2b", "tri2b+fmllr", "nnet3-tdnn", "nnet3-tdnn-ivector", "chain",
                 "tri2b-lattice-1best", "tri2b+bigram-rescore"):
        gate = 5.0 if name.startswith("nnet3-tdnn") else 2.0
        assert wers[name] <= gate, (name, wers[name])
    assert rtf is not None and rtf > 0
    before = open(os.path.join(work, "RESULTS")).read()
    _refuse_reruns(monkeypatch)
    t0 = time.time()
    run_all.run_all(work, device="cpu")
    assert time.time() - t0 < 30.0
    assert open(os.path.join(work, "RESULTS")).read() == before
