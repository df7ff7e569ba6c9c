"""The nnet3 serving tools of the port's CLI against the JAX package's, on the
CPU (tools in-process, the port's with --device=cpu).

The shared system of tests/torch_cli_system.py: the committed final.am
(TDNN-F) bundled with tri.mdl's transition model by both packages'
nnet3-am-init, on the HCLG of the port's mkgraph.  The port reads the JAX
package's model files (pickles) and writes its own (torch.save), which the
JAX package cannot read: models cross one way, so each port output model is
held to the JAX tool's through what it computes.  Loglikes within 1e-4,
words equal, lattices by tests/test_torch_cli_decode.py's rule, the TCP
servers' partial and final lines equal."""

import tests.torch_threads  # noqa: F401
import os
import socket
import threading
import time

import numpy as np
import pytest

from old_kaldi_git_tpu_torch.utils.table import read_table
from tests.torch_cli_system import jax_tool, lattices_equal, port_tool, run, system

XCONFIG = """
input name=input dim=39
relu-batchnorm-layer name=tdnn1 dim=48 input=Append(-2,-1,0,1,2)
relu-batchnorm-layer name=tdnn2 dim=48 input=Append(-1,0,1)
output-layer name=output dim=30
"""


@pytest.fixture(scope="module")
def s():
    return system()


def _loglikes(fn, s, model, name, *opts):
    p = s["p"]
    assert fn("nnet3-compute", *opts, model, f"ark:{p('feats.ark')}",
              f"ark:{p(name)}") == 0
    return read_table(f"ark:{p(name)}", "mat")


def test_nnet3_compute_equals_the_jax_tool(s):
    for opts in ([], ["--use-priors=false"]):
        j = _loglikes(jax_tool, s, s["final_am"], "j_ll.ark", *opts)
        t = _loglikes(port_tool, s, s["final_am"], "t_ll.ark", *opts)
        assert sorted(j) == sorted(t) == sorted(s["feats"])
        for k in t:
            assert t[k].shape == j[k].shape and t[k].shape[0] == len(s["feats"][k])
            np.testing.assert_allclose(t[k], j[k], atol=1e-4)


def test_nnet3_info_prints_as_the_jax_tool(s, capsys):
    j = run(capsys, jax_tool, "nnet3-info", s["final_am"])
    t = run(capsys, port_tool, "nnet3-info", s["final_am"])
    assert j == t and t[0] == 0 and "num-parameters:" in t[1]


def test_nnet3_copy_scale_edits_and_priors_equal_the_jax_tool(s):
    from old_kaldi_git_tpu_torch.utils import io_funcs as iof

    p = s["p"]
    counts = np.arange(1, 2001, dtype=np.float32)
    with open(p("counts.vec"), "wb") as f:
        iof.init_kaldi_output_stream(f, True)
        iof.write_vector(f, counts)
    opts = ["--scale=0.5", "--edits=set-learning-rate-factor name=* learning-rate-factor=0.5",
            f"--prior-counts-vec={p('counts.vec')}"]
    assert jax_tool("nnet3-copy", *opts, s["final_am"], p("j_copy.raw")) == 0
    assert port_tool("nnet3-copy", *opts, s["final_am"], p("t_copy.raw")) == 0
    j = _loglikes(port_tool, s, p("j_copy.raw"), "jc_ll.ark")
    t = _loglikes(port_tool, s, p("t_copy.raw"), "tc_ll.ark")
    for k in t:
        np.testing.assert_allclose(t[k], j[k], atol=1e-4)
    base = _loglikes(port_tool, s, s["final_am"], "b_ll.ark")
    assert max(np.abs(t[k] - base[k]).max() for k in t) > 1.0


def test_nnet3_average_and_init_equal_the_jax_tool(s, capsys):
    p = s["p"]
    assert jax_tool("nnet3-copy", "--scale=0.5", s["final_am"], p("half.raw")) == 0
    assert jax_tool("nnet3-average", s["final_am"], p("half.raw"), p("j_avg.raw")) == 0
    assert port_tool("nnet3-average", s["final_am"], p("half.raw"), p("t_avg.raw")) == 0
    j = _loglikes(port_tool, s, p("j_avg.raw"), "ja_ll.ark")
    t = _loglikes(port_tool, s, p("t_avg.raw"), "ta_ll.ark")
    for k in t:
        np.testing.assert_allclose(t[k], j[k], atol=1e-4)
    # nnet3-init: the same network (its weights come from each package's own
    # generator), as nnet3-info prints it
    with open(p("nnet.xconfig"), "w") as f:
        f.write(XCONFIG)
    assert jax_tool("nnet3-init", "--srand=3", p("nnet.xconfig"), p("j0.raw")) == 0
    assert port_tool("nnet3-init", "--srand=3", p("nnet.xconfig"), p("t0.raw")) == 0
    info = [run(capsys, port_tool, "nnet3-info", p(m)) for m in ("j0.raw", "t0.raw")]
    assert info[0] == info[1] and "layer 1: tdnn dim=48" in info[1][1]


@pytest.fixture(scope="module")
def latgen(s):
    p = s["p"]
    wt = f"--word-symbol-table={p('lang', 'words.txt')}"
    for name, fn, mdl in (("jax", jax_tool, "final_jax.mdl"),
                          ("port", port_tool, "final.mdl"),
                          ("port_jaxmdl", port_tool, "final_jax.mdl")):
        assert fn("nnet3-latgen-faster", "--lattice-beam=6", wt, p(mdl), s["hclg"],
                  f"ark:{p('feats.ark')}", f"ark:{p(name + '_nlat.ark')}",
                  f"ark,t:{p(name + '_nwords.txt')}") == 0
    return s


def test_nnet3_latgen_faster_equals_the_jax_tool(latgen):
    p = latgen["p"]
    words = {n: read_table(f"ark:{p(n + '_nwords.txt')}", "text")
             for n in ("jax", "port", "port_jaxmdl")}
    assert words["jax"] == words["port"] == words["port_jaxmdl"]
    assert words["port"] == {k: " ".join(v) for k, v in latgen["text"].items()}
    j = read_table(f"ark:{p('jax_nlat.ark')}", "lat")
    t = read_table(f"ark:{p('port_nlat.ark')}", "lat")
    assert sorted(j) == sorted(t) == sorted(latgen["text"])
    for k in t:
        lattices_equal(j[k], t[k], atol=1e-4)


def _segment(s, seconds: float = 1.2) -> str:
    """An archive of one utterance's first seconds (extract-segments)."""
    p = s["p"]
    with open(p("segments2"), "w") as f:
        f.write(f"seg2 test_0002 0.0 {seconds}\n")
    assert port_tool("extract-segments", f"scp:{p('wav.scp')}", p("segments2"),
                     f"ark:{p('seg2.ark')}") == 0
    return p("seg2.ark")


def test_online2_wav_nnet3_latgen_faster_equals_the_jax_tool(s, capsys):
    p = s["p"]
    seg = _segment(s)
    wt = f"--word-symbol-table={p('lang', 'words.txt')}"
    got = {}
    for name, fn, mdl in (("jax", jax_tool, "final_jax.mdl"), ("port", port_tool, "final.mdl")):
        rc, out = run(capsys, fn, "online2-wav-nnet3-latgen-faster", "--samp-freq=8000",
                      "--chunk-seconds=0.6", wt,
                      p(mdl), s["hclg"], f"ark:{seg}", f"ark,t:{p(name + '_o2.txt')}")
        assert rc == 0
        got[name] = (read_table(f"ark:{p(name + '_o2.txt')}", "text"),
                     [ln.split("): ", 1)[1] for ln in out.splitlines() if "): " in ln])
    assert got["jax"] == got["port"] and got["port"][1][0]


def serve_and_send(fn, argv, port_file: str, pcm: bytes, samp_freq: float) -> str:
    """Run a TCP server tool in a thread (one connection), stream `pcm` to
    it in 0.25 s pieces, and return everything it answered."""
    if os.path.exists(port_file):
        os.remove(port_file)
    rcs = []
    th = threading.Thread(target=lambda: rcs.append(fn(*argv)), daemon=True)
    th.start()
    for _ in range(1200):
        if os.path.exists(port_file) and open(port_file).read().strip():
            break
        time.sleep(0.05)
    port = int(open(port_file).read())
    received = b""
    with socket.create_connection(("127.0.0.1", port), timeout=300) as c:
        step = int(0.25 * samp_freq) * 2
        for i in range(0, len(pcm), step):
            c.sendall(pcm[i: i + step])
        c.shutdown(socket.SHUT_WR)
        while True:
            data = c.recv(4096)
            if not data:
                break
            received += data
    th.join(timeout=300)
    assert rcs == [0]
    return received.decode()


def test_online2_tcp_server_answers_as_the_jax_server(s):
    from old_kaldi_git_tpu_torch.utils.table import read_table as rt

    p = s["p"]
    wave = rt(f"ark:{_segment(s)}", "wav")["seg2"]
    pcm = np.clip(wave.data[0], -32768, 32767).astype("<i2").tobytes()
    texts = {}
    for name, fn, mdl in (("jax", jax_tool, "final_jax.mdl"), ("port", port_tool, "final.mdl")):
        texts[name] = serve_and_send(
            fn, ["online2-tcp-nnet3-decode-faster", "--port-num=0",
                 f"--port-file={p(name + '.port')}", "--num-connections=1",
                 "--samp-freq=8000", "--chunk-length-secs=0.3",
                 f"--word-symbol-table={p('lang', 'words.txt')}",
                 p(mdl), s["hclg"]], p(name + ".port"), pcm, 8000.0)
    assert texts["jax"] == texts["port"]
    assert texts["port"].count("\r") >= 3 and texts["port"].endswith("\n")
    final = texts["port"].split("\r")[-1].strip()
    assert final and set(final.split()) <= set(s["words"].symbols())


def test_port_reads_the_jax_packages_bundle_and_raw_model(s):
    """Model files cross from the JAX package to the port: its AmNnetModel
    pickle (nnet3-am-init) and raw AmNnet pickle give the port's own
    bundle's loglikes."""
    from old_kaldi_git_tpu_torch.models.am_nnet import AmNnet, AmNnetModel

    p = s["p"]
    a = AmNnetModel.load(p("final_jax.mdl"), device="cpu")
    b = AmNnetModel.load(p("final.mdl"), device="cpu")
    c = AmNnet.load(s["final_am"], device="cpu")
    x = np.asarray(s["feats"]["test_0000"])[None]
    la, lb, lc = (m.loglikes_batch(x).numpy() for m in (a.am, b.am, c))
    assert np.array_equal(la, lb) and np.array_equal(lb, lc)
    assert np.array_equal(a.tm.tid_to_pdf_array(), b.tm.tid_to_pdf_array())
