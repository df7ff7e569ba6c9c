"""yesno's chain objects in both packages, for the port's tests (not a test
module): a short monophone training of the port on its CPU features, its
model read by both packages, a left-biphone chain tree, transition model
and den graph built by each, and a batch of 6 utterances' supervision."""

import os
import tempfile

import numpy as np


def yesno_chain_objects():
    from old_kaldi_git_tpu.fst.lang import Lang as JLang, Lexicon as JLexicon
    import old_kaldi_git_tpu.gmm.diag_gmm as jgmm
    import old_kaldi_git_tpu.recipes.chain as jchain
    from old_kaldi_git_tpu_torch.chain import supervision as tsup
    from old_kaldi_git_tpu_torch.recipes import chain as tchain, yesno
    from old_kaldi_git_tpu_torch.recipes.mono import MonoTrainOptions, train_mono

    waves, text, _, _ = yesno.make_corpus(24, 8)
    feats = yesno.compute_feats(waves, "cpu")
    lang = yesno.make_lang()
    gmm, ali = train_mono(feats, text, lang, MonoTrainOptions(
        num_iters=4, totgauss=40, realign_iters=(1, 2)), device="cpu")
    with tempfile.TemporaryDirectory() as d:
        gmm.save(os.path.join(d, "mono.mdl"))
        jgm = jgmm.AmGmmModel.load(os.path.join(d, "mono.mdl"))
    jlang = JLang(JLexicon.from_dict({w: " ".join(p) for w, p in yesno.WORD_PRONS.items()}),
                  silence_phone="SIL", sil_prob=0.5)
    kw = dict(phone_lm_order=3, tree_context_width=2, tree_max_leaves=12, tree_thresh=10.0)
    jobj = jchain.build_chain_objects(jgm, ali, jlang, jchain.ChainTrainOptions(**kw), feats)
    tobj = tchain.build_chain_objects(gmm, ali, lang, tchain.ChainTrainOptions(**kw), feats)
    keys = sorted(ali)[:6]
    sups = [tsup.alignment_to_supervision(ali[k], gmm.tm, tobj[0], 3, 5, 5, den=tobj[2])
            for k in keys]
    pdf_seq, allowed, nf, sl, adv = tsup.pad_supervisions(sups)
    xent = np.stack([tsup.chain_xent_labels(ali[k], gmm.tm, tobj[0], 3, allowed.shape[1])
                     for k in keys])
    T = allowed.shape[1] * 3
    bf = np.zeros((len(keys), T, 39), np.float32)
    for i, k in enumerate(keys):
        bf[i, : min(T, len(feats[k]))] = feats[k][:T]
    return dict(feats=feats, ali=ali, gmm=gmm, jgmm=jgm, jobj=jobj, tobj=tobj,
                args=(bf, pdf_seq, allowed, nf, sl, adv, xent))
