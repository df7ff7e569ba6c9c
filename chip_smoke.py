#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--noisy] [--profile-frames N]

Builds the CUDA kernels from the sources in this checkout, holds each against
its plain PyTorch version on the card, then drives the port's main path once
through its entry points: the committed exp/minilib system (20k words, 1M-state
HCLG, TDNN-F) decodes its 256-utterance held-out set, synthesised from a seed,
at max_active=1024, batch=128, beam=14, acoustic_scale=1.0, with the host-clock
seconds of each stage.  Then the GMM serving path: the committed triphone
tri.mdl, read by the port's own reader, decodes the same 256 utterances as
one padded batch through recipes/decode.decode_dataset at DecodeOptions()
(beam 16, max_active 7000, acoustic_scale 0.1): loglikes through the GMM
kernel, the top-K dense-alpha search.  --noisy also decodes the set re-synthesised at noise
amplitude 400 (the reference's second operating point) and lists the
utterances with errors.  --profile-frames N puts the first N frames of one
chunk's search under torch.profiler and reports the device-busy share (summed
kernel time over the wall time the same window takes without the profiler,
whose own cost is large) and the kernels that take most of it.

Each phase prints one JSON line.  Any failure — no CUDA device, a kernel that
does not build, launch or agree, a phase out of bounds — ends the run with a
non-zero exit code and without the final line; nothing carries on on the CPU.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

H100_FP32_FLOPS = 67e12       # fp32 outside the tensor cores, published peak
H100_HBM_BYTES_PER_S = 3.35e12  # published peak

BEAM, MAX_ACTIVE, BATCH, ACOUSTIC_SCALE = 14.0, 1024, 128, 1.0
MAX_WER_PERCENT = 1.0  # the reference decodes this set at 0.07 %
GMM_MAX_ERRORS = 2  # 0.07 % of 2,868 words; the JAX package makes 0 with tri.mdl
GMM_TOL = (2e-3, 2e-3)  # |kernel - plain| <= atol + rtol·|plain| (tests/test_ops.py)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, reps: int = 30, warm: int = 3, plug=None) -> float:
    """Mean device time of fn() over `reps` back-to-back launches, by CUDA
    events.  `plug`, a square matrix, is multiplied by itself first: while the
    card works on that long product the host queues all the launches, so the
    events see the device's time and not the host's launch rate.  Inputs stay
    in L2 between launches, as they do for the callers on the main path,
    which have just produced them."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if plug is not None:
        torch.mm(plug, plug)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_gather(torch, gather, plain, shapes, seed: int = 0):
    """K1 against its plain version: exact, out-of-range indices included."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    for b, p, e in shapes:
        table = torch.randn((b, p), device="cuda", generator=gen)
        idx = torch.randint(-3, p + 3, (b, e), device="cuda", generator=gen,
                            dtype=torch.int32)
        out = gather(table, idx)
        torch.cuda.synchronize()
        ref = plain(table, idx)
        if out.shape != ref.shape or not torch.equal(out, ref):
            raise RuntimeError(f"gather kernel disagrees at shape {(b, p, e)}")
        worst = max(worst, float((out - ref).abs().max()))
    return worst


def check_mfcc(torch, fused, reference, cases, tol: float):
    """K2 against its plain version at speech-like amplitudes, atol `tol`
    (fp32 sums in another order at log-mel magnitudes ~20)."""
    worst = 0.0
    for frames, weights in cases:
        out = fused(frames, weights)
        torch.cuda.synchronize()
        ref = reference(frames, weights)
        if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"mfcc kernel output bad at {tuple(frames.shape)}")
        err = float((out - ref).abs().max())
        if err > tol:
            raise RuntimeError(
                f"mfcc kernel off by {err} (> {tol}) at {tuple(frames.shape)}")
        worst = max(worst, err)
    return worst


def check_refusals(torch, gather, fused, weights) -> int:
    """On CUDA tensors the wrappers refuse what their kernels cannot read,
    before any launch.  Returns the number of refusals seen."""
    cases = [
        ("contiguous", lambda: gather(
            torch.zeros((4, 10), device="cuda")[:, ::2],
            torch.zeros((4, 6), dtype=torch.int32, device="cuda")[:, ::2])),
        # a 100 ms window at 16 kHz pads to W = 2048: one tile of frames
        # no longer fits a block's shared memory
        ("shared memory", lambda: fused(
            torch.zeros((4, 2048), device="cuda"),
            (torch.zeros((2048, 1024), device="cuda"),
             torch.zeros((2048, 1024), device="cuda"),
             torch.zeros((1024, weights[2].shape[1]), device="cuda"), weights[3]))),
    ]
    before = gather.launches, fused.launches
    for word, call in cases:
        try:
            call()
        except ValueError as e:
            if word not in str(e):
                raise
        else:
            raise RuntimeError(f"a wrapper did not refuse: {word}")
    if (gather.launches, fused.launches) != before:
        raise RuntimeError("a refused call was counted as a launch")
    return len(cases)


def check_gmm(torch, kernel, plain, cases):
    """K3 against its plain version: returns (worst |Δ|, worst |Δ| over its
    allowance atol + rtol·|plain|); raises above the allowance."""
    atol, rtol = GMM_TOL
    worst = worst_share = 0.0
    for feats, weights in cases:
        out = kernel(feats, weights)
        torch.cuda.synchronize()
        ref = plain(feats, weights)
        if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"gmm kernel output bad at {tuple(feats.shape)}")
        err = (out - ref).abs()
        share = float((err / (atol + rtol * ref.abs())).max())
        worst, worst_share = max(worst, float(err.max())), max(worst_share, share)
        if share > 1.0:
            raise RuntimeError(f"gmm kernel off by {float(err.max())} at "
                               f"{tuple(feats.shape)} ({share:.3f} of its allowance)")
        del out, ref, err
    return worst, worst_share


def check_gmm_refusals(torch, kernel, feats, weights) -> int:
    """The K3 wrapper refuses a strided, a float64 and a host-side input
    before any launch."""
    cases = [
        (ValueError, lambda: kernel(feats.t().contiguous().t(), weights)),
        (TypeError, lambda: kernel(feats.double(), weights)),
        (ValueError, lambda: kernel(feats.cpu(), weights)),
    ]
    before = kernel.launches
    for exc, call in cases:
        try:
            call()
        except exc:
            pass
        else:
            raise RuntimeError(f"the gmm wrapper did not refuse ({exc.__name__})")
    if kernel.launches != before:
        raise RuntimeError("a refused gmm call was counted as a launch")
    return len(cases)


def random_gmm(np, convert, dev, num_pdfs: int, dim: int, seed: int):
    """A random GMM with an odd pdf count and 1-150 Gaussians a pdf."""
    rng = np.random.default_rng(seed)
    pdfs = []
    for i in range(num_pdfs):
        m = 150 if i == 7 else int(rng.integers(1, 151))
        w = rng.random(m) + 0.1
        pdfs.append((w / w.sum(), rng.normal(size=(m, dim)) * 2,
                     0.3 + rng.random((m, dim))))
    return convert.am_diag_gmm_from_jax(pdfs, device=dev)


def search_profile(torch, decode, loglikes, nf, frames: int) -> dict:
    """Device-busy share of the first `frames` frames of one chunk's search."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    ll = loglikes[:, :frames].contiguous()
    nf = np.minimum(nf, frames)

    def window() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(ll, nf)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    window()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_s = window()
    unprofiled_s = window()
    # device-side rows only (kernels, memcpy, memset): the host-side ops carry
    # their kernels' time a second time
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    return {"frames": frames, "window_seconds_profiled": profiled_s,
            "window_seconds_unprofiled": unprofiled_s,
            "device_busy_seconds": busy_s if rows else "not measured",
            "device_busy_share_of_unprofiled_window":
                busy_s / unprofiled_s if rows else "not measured",
            "device_launches": sum(r[1] for r in rows),
            "top_kernels_us_count_name": [[round(r[0], 1), r[1], r[2][:90]]
                                          for r in rows[:12]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--noisy", action="store_true",
                    help="also decode the set re-synthesised at noise 400")
    ap.add_argument("--profile-frames", type=int, default=0,
                    help="frames of one chunk's search under torch.profiler")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    os.chdir(os.path.dirname(os.path.abspath(__file__)))

    import numpy as np

    from old_kaldi_git_tpu_torch import convert
    from old_kaldi_git_tpu_torch.decoder.csr import build_tile_graph
    from old_kaldi_git_tpu_torch.decoder.viterbi import (
        ViterbiOptions, _token_budget, decode_batch_tokens)
    from old_kaldi_git_tpu_torch.device import card_name_and_power_limit
    from old_kaldi_git_tpu_torch.feat import MfccOptions, extract_frames
    from old_kaldi_git_tpu_torch.feat.window import num_frames
    from old_kaldi_git_tpu_torch.ops import _build
    from old_kaldi_git_tpu_torch.ops.gather_kernel import (
        batched_table_gather, batched_table_gather_plain)
    from old_kaldi_git_tpu_torch.ops.gmm_kernel import gmm_loglikes, gmm_loglikes_plain
    from old_kaldi_git_tpu_torch.ops.mfcc_kernel import (
        fused_mfcc_from_frames, fused_mfcc_reference, make_mfcc_weights)
    from old_kaldi_git_tpu_torch.recipes import decode, minilib
    from old_kaldi_git_tpu_torch.utils.batching import pad_feature_batch
    from old_kaldi_git_tpu_torch.utils.edit_distance import compute_wer, edit_distance

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_name_and_power_limit()

    # ---- phase 1: device, build --------------------------------------------
    _build.build()
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kernel_build_seconds": round(_build.build_seconds, 2),
          "ptxas": {k: [l for l in v.splitlines() if "registers" in l or "spill" in l]
                    for k, v in _build.build_logs().items()}})

    # ---- the system (needed for the main path's kernel shapes) --------------
    t0 = time.perf_counter()
    system = minilib.load_system("exp/minilib", device=dev)
    load_s = time.perf_counter() - t0
    tg = build_tile_graph(system.csr)
    K = max(4, min(MAX_ACTIVE, system.csr.num_states))
    E = _token_budget(system.csr, K, tg.md) * tg.md
    P = system.am.config.num_outputs

    # ---- phase 2: each kernel against its plain version ----------------------
    # K1 at the main path's shape, at two ragged ones, and with a table row
    # beyond a block's shared memory (the kernel then reads device memory)
    k1_err = check_gather(torch, batched_table_gather, batched_table_gather_plain,
                          [(BATCH, P, E), (3, 50, 7), (9, 129, 1031),
                           (2, 70000, 333)])
    gen = torch.Generator(device="cuda").manual_seed(1)
    table = torch.randn((BATCH, P), device="cuda", generator=gen)
    idx = torch.randint(0, P, (BATCH, E), device="cuda", generator=gen,
                        dtype=torch.int32)
    idx64 = idx.long()
    plug = torch.randn((8192, 8192), device="cuda", generator=gen)
    k1_ms = time_ms(torch, lambda: batched_table_gather(table, idx), plug=plug)
    k1_plain_ms = time_ms(torch, lambda: batched_table_gather_plain(table, idx),
                          plug=plug)
    k1_lib_ms = time_ms(torch, lambda: torch.gather(table, 1, idx64), plug=plug)
    k1_host_ms = time_ms(torch, lambda: batched_table_gather(table, idx))
    k1_bytes = 4 * BATCH * (2 * E + P)
    k1_bound_ms = 1e3 * k1_bytes / H100_HBM_BYTES_PER_S

    # K2 at the frame count of the first 128-utterance front-end chunk
    # (W = 256), on that chunk's real frames, and at W = 512 with a ragged N
    opts8 = MfccOptions()
    opts8.frame_opts.samp_freq = minilib.SAMP_FREQ
    opts8.frame_opts.dither = 0.0
    keys = sorted(system.test_waves)[:minilib.FEAT_CHUNK]
    mlen = max(system.test_waves[k].shape[0] for k in keys)
    batch = np.zeros((len(keys), mlen), np.float32)
    for i, k in enumerate(keys):
        batch[i, : system.test_waves[k].shape[0]] = system.test_waves[k]
    frames8, _ = extract_frames(torch.from_numpy(batch).to(dev), opts8.frame_opts)
    frames8 = frames8.reshape(-1, frames8.shape[-1]).contiguous()
    if frames8.shape[0] != len(keys) * num_frames(mlen, opts8.frame_opts):
        raise RuntimeError("front-end chunk has an unexpected frame count")
    w8 = make_mfcc_weights(opts8, device=dev)
    opts16 = MfccOptions()
    opts16.frame_opts.dither = 0.0
    w16 = make_mfcc_weights(opts16, device=dev)
    frames16 = 1000.0 * torch.randn((1237, 512), device="cuda", generator=gen)
    k2_err = check_mfcc(torch, fused_mfcc_from_frames, fused_mfcc_reference,
                        [(frames8, w8), (frames16, w16), (frames8[:45], w8)],
                        tol=1e-3)
    refusals = check_refusals(torch, batched_table_gather,
                              fused_mfcc_from_frames, w16)
    n, w = frames8.shape
    f, nb, c = w8[0].shape[1], w8[2].shape[1], w8[3].shape[1]
    k2_ms = time_ms(torch, lambda: fused_mfcc_from_frames(frames8, w8), reps=10,
                    plug=plug)
    k2_plain_ms = time_ms(torch, lambda: fused_mfcc_reference(frames8, w8), reps=10,
                          plug=plug)
    del plug
    k2_flops = 2 * n * w * f * 2 + 2 * n * f * nb + 2 * n * nb * c
    k2_bytes = 4 * (n * w + n * c)
    k2_ops_ms = 1e3 * k2_flops / H100_FP32_FLOPS
    k2_bytes_ms = 1e3 * k2_bytes / H100_HBM_BYTES_PER_S
    emit({"phase": "kernels", "card": card,
          "gather": {"shape": [BATCH, P, E], "exact": k1_err == 0.0, "kernel_ms": k1_ms,
                     "plain_ms": k1_plain_ms, "library_ms": k1_lib_ms,
                     "bound_ms": k1_bound_ms, "bytes": k1_bytes,
                     "ms_per_call_host_bound": k1_host_ms},
          "mfcc": {"shape": [n, w], "max_abs_err": k2_err, "kernel_ms": k2_ms,
                   "plain_ms": k2_plain_ms, "library_ms": None,
                   "bound_ms": max(k2_ops_ms, k2_bytes_ms), "flops": k2_flops,
                   "bytes": k2_bytes},
          "timing": "mean of back-to-back launches, inputs resident in L2",
          "refusals": refusals,
          "check_launches": {"gather": batched_table_gather.launches,
                             "mfcc": fused_mfcc_from_frames.launches}})

    # ---- phase 3: the acoustic model on one chunk ----------------------------
    feats = minilib.compute_feats(
        {k: system.test_waves[k] for k in keys}, device=dev)
    _, padded, nf = pad_feature_batch(feats)
    tb = -(-padded.shape[1] // 128) * 128
    padded = np.pad(padded, ((0, 0), (0, tb - padded.shape[1]), (0, 0)))
    x = torch.from_numpy(padded).to(dev)
    loglikes = system.am.loglikes_batch(x)
    torch.cuda.synchronize()
    if tuple(loglikes.shape) != (BATCH, tb, P) or not bool(torch.isfinite(loglikes).all()):
        raise RuntimeError(f"acoustic model output bad: {tuple(loglikes.shape)}")
    am_ms = time_ms(torch, lambda: system.am.loglikes_batch(x), reps=3, warm=1)
    emit({"phase": "am", "card": card, "shape": list(loglikes.shape),
          "finite": True, "ms": am_ms, "load_system_seconds": round(load_s, 2)})
    del loglikes

    # ---- phase 4: the main path, with the launch counts set to 0 just before -
    batched_table_gather.launches = 0
    fused_mfcc_from_frames.launches = 0
    gmm_loglikes.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stages = {}
    wer, audio_s = minilib.decode_and_score(
        system, beam=BEAM, max_active=MAX_ACTIVE,
        acoustic_scale=ACOUSTIC_SCALE, batch=BATCH, timings=stages)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    k1_launches = batched_table_gather.launches
    k2_launches = fused_mfcc_from_frames.launches
    k3_tdnn_launches = gmm_loglikes.launches
    emit({"phase": "decode", "card": card, "utterances": len(system.test_waves),
          "max_active": MAX_ACTIVE, "batch": BATCH, "beam": BEAM,
          "acoustic_scale": ACOUSTIC_SCALE, "wer_percent": wer,
          "audio_seconds": audio_s, "wall_seconds": wall_s,
          "audio_seconds_per_second": audio_s / wall_s, **stages,
          "search_ms_per_frame":
              1e3 * stages["search_seconds"] / stages["search_frames"],
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
          "gather_launches": k1_launches, "mfcc_launches": k2_launches})
    if not (k1_launches > 0 and k2_launches > 0):
        raise RuntimeError("the main path did not go through both kernels: "
                           f"gather {k1_launches}, mfcc {k2_launches}")
    if not (wer <= MAX_WER_PERCENT):
        raise RuntimeError(f"WER {wer:.2f}% exceeds {MAX_WER_PERCENT}%")

    # ---- phase 5: K3 against its plain version ------------------------------
    # at the GMM path's shape (the 256 held-out utterances' real features,
    # padded into one batch as decode_dataset pads them, against tri.mdl), on
    # a random model with an odd pdf count and 1-150 Gaussians, and at N = 45.
    # It runs after the TDNN decode: its GBs of tensors and the 2,000-pdf
    # model would otherwise be in the process while the TDNN path is timed.
    gmm_model = convert.load_am_gmm_model("exp/minilib/tri.mdl", device=dev)
    gw = gmm_model.am.weights()
    _, gpad, _ = pad_feature_batch(minilib.compute_feats(system.test_waves, device=dev))
    gx = torch.from_numpy(gpad.reshape(-1, gpad.shape[-1])).to(dev)
    rnd = random_gmm(np, convert, dev, 999, gx.shape[1], seed=3)
    rx = 3.0 * torch.randn((4099, gx.shape[1]), device="cuda", generator=gen)
    k3_err, k3_share = check_gmm(
        torch, gmm_loglikes, gmm_loglikes_plain,
        [(gx, gw), (rx, rnd.weights()), (gx[:45].contiguous(), gw)])
    k3_refusals = check_gmm_refusals(torch, gmm_loglikes, gx[:64].contiguous(), gw)
    plug = torch.randn((8192, 8192), device="cuda", generator=gen)
    k3_ms = time_ms(torch, lambda: gmm_loglikes(gx, gw), reps=10, plug=plug)
    k3_plain_ms = time_ms(torch, lambda: gmm_loglikes_plain(gx, gw), reps=2,
                          warm=1, plug=plug)
    n3, d3 = gx.shape
    k3_flops = 2 * n3 * gw.num_gauss * (2 * d3 + 1)
    k3_bytes = 4 * (n3 * d3 + n3 * gw.num_pdfs + gw.rows.numel() + gw.offsets.numel())
    k3_ops_ms = 1e3 * k3_flops / H100_FP32_FLOPS
    k3_bytes_ms = 1e3 * k3_bytes / H100_HBM_BYTES_PER_S
    emit({"phase": "gmm_kernel", "card": card,
          "shape": {"frames": n3, "dim": d3, "pdfs": gw.num_pdfs,
                    "gaussians": gw.num_gauss, "padded_mixtures": gw.max_mix},
          "max_abs_err": k3_err, "worst_share_of_tolerance": k3_share,
          "tolerance": f"{GMM_TOL[0]} + {GMM_TOL[1]}*|plain|",
          "kernel_ms": k3_ms, "plain_ms": k3_plain_ms,
          "plain_timing": f"chunked plain version over all {n3} frames",
          "library_ms": None, "bound_ms": max(k3_ops_ms, k3_bytes_ms),
          "bound_by": "operations" if k3_ops_ms >= k3_bytes_ms else "bytes",
          "flops": k3_flops, "bytes": k3_bytes, "refusals": k3_refusals,
          "check_launches": gmm_loglikes.launches})
    del plug, rnd, rx, gx, gpad
    torch.cuda.empty_cache()

    # ---- phase 6: the GMM path, with the launch counts set to 0 just before --
    if not np.array_equal(gmm_model.tm.tid_to_pdf_array()[system.csr.tid], system.csr.pdf):
        raise RuntimeError("tri.mdl's tid -> pdf map is not the graph's")
    batched_table_gather.launches = 0
    fused_mfcc_from_frames.launches = 0
    gmm_loglikes.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gmm_feats = minilib.compute_feats(system.test_waves, device=dev)
    torch.cuda.synchronize()
    gstages = {"features_seconds": time.perf_counter() - t0}
    failed = []
    ghyps = decode.decode_dataset(gmm_model, system.csr, system.words, gmm_feats,
                                  decode.DecodeOptions(), timings=gstages,
                                  failed=failed)
    gstats = decode.score_hyps(system.test_text, ghyps)
    torch.cuda.synchronize()
    gwall_s = time.perf_counter() - t0
    gframes = max(f.shape[0] for f in gmm_feats.values())
    g_launches = {"gather": batched_table_gather.launches,
                  "mfcc": fused_mfcc_from_frames.launches,
                  "gmm": gmm_loglikes.launches}
    dopts = decode.DecodeOptions()
    emit({"phase": "decode_gmm", "card": card, "model": "exp/minilib/tri.mdl",
          "utterances": len(gmm_feats), "frames_padded": gframes,
          "frames": sum(f.shape[0] for f in gmm_feats.values()),
          "beam": dopts.beam, "max_active": dopts.max_active,
          "acoustic_scale": dopts.acoustic_scale,
          "wer_percent": gstats.wer, "errors": gstats.errors,
          "words": gstats.ref_len, "failed_utterances": len(failed),
          "audio_seconds": audio_s, "wall_seconds": gwall_s, **gstages,
          "search_ms_per_frame": 1e3 * gstages["search_seconds"] / gframes,
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated(),
          "launches": g_launches})
    if not (g_launches["gmm"] > 0 and g_launches["mfcc"] > 0):
        raise RuntimeError(f"the GMM path did not go through its kernels: {g_launches}")
    if failed:
        raise RuntimeError(f"{len(failed)} utterances failed to decode: {failed[:8]}")
    if gstats.errors > GMM_MAX_ERRORS:
        raise RuntimeError(f"GMM WER {gstats.wer:.3f}% ({gstats.errors} errors) "
                           f"exceeds {GMM_MAX_ERRORS} errors")
    del gmm_feats
    torch.cuda.empty_cache()

    emit({"kernels": [
        {"name": "batched_table_gather", "route": "cuda",
         "source": "old_kaldi_git_tpu_torch/ops/csrc/gather.cu",
         "replaces": "old_kaldi_git_tpu/ops/gather_kernel.py:57",
         "launches": k1_launches + g_launches["gather"],
         "launches_by_path": {"decode": k1_launches, "decode_gmm": g_launches["gather"]},
         "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms, "bound_by": "bytes",
         "library_ms": k1_lib_ms},
        {"name": "fused_mfcc_from_frames", "route": "cuda",
         "source": "old_kaldi_git_tpu_torch/ops/csrc/mfcc.cu",
         "replaces": "old_kaldi_git_tpu/ops/mfcc_kernel.py:73",
         "launches": k2_launches + g_launches["mfcc"],
         "launches_by_path": {"decode": k2_launches, "decode_gmm": g_launches["mfcc"]},
         "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": max(k2_ops_ms, k2_bytes_ms),
         "bound_by": "operations" if k2_ops_ms >= k2_bytes_ms else "bytes",
         "library_ms": None},
        {"name": "gmm_loglikes", "route": "cuda",
         "source": "old_kaldi_git_tpu_torch/ops/csrc/gmm.cu",
         "replaces": "old_kaldi_git_tpu/ops/gmm_kernel.py:125",
         "launches": k3_tdnn_launches + g_launches["gmm"],
         "launches_by_path": {"decode": k3_tdnn_launches,
                              "decode_gmm": g_launches["gmm"]},
         "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": max(k3_ops_ms, k3_bytes_ms),
         "bound_by": "operations" if k3_ops_ms >= k3_bytes_ms else "bytes",
         "library_ms": None},
    ]})
    if args.noisy:
        waves, text = minilib.make_test_set(minilib.MinilibOptions(),
                                            noise=minilib.NOISE_EVAL)
        hyps = minilib.decode_test_set(system, waves, BEAM, MAX_ACTIVE,
                                       ACOUSTIC_SCALE, BATCH)
        stats = compute_wer({k: list(v) for k, v in text.items()}, hyps)
        errs = {k: edit_distance(text[k], hyps[k]).errors for k in sorted(text)}
        emit({"phase": "decode_noisy", "card": card, "noise": minilib.NOISE_EVAL,
              "wer_percent": stats.wer, "errors": stats.errors,
              "ref_words": stats.ref_len,
              "errors_by_utterance": {k: e for k, e in errs.items() if e}})

    # last, because the profiler stays attached to the process and slows
    # every later launch
    if args.profile_frames > 0:
        vopts = ViterbiOptions(beam=BEAM, max_active=MAX_ACTIVE,
                               acoustic_scale=ACOUSTIC_SCALE)
        emit({"phase": "search_profile", "card": card, **search_profile(
            torch, lambda ll, nf: decode_batch_tokens(system.csr, ll, nf, vopts),
            system.am.loglikes_batch(x), nf, args.profile_frames)})

    emit({"phase": "total", "card": card,
          "seconds": round(time.perf_counter() - t_start, 1)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
