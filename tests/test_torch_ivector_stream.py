"""OnlineIvectorExtractor in the port, on the CPU (split from
tests/test_torch_ivector.py, whose small JAX-trained extractor these tests
use): for any chunking of the input and any stats scale and count cap, the
concatenated outputs equal extract_online_ivectors over the whole stream,
exactly, also for float64 input."""

import tests.torch_threads  # noqa: F401
import numpy as np
import pytest

import old_kaldi_git_tpu_torch.ivector.extractor as tiv
from tests.test_torch_ivector import small, SCALE_COUNT


@pytest.mark.parametrize("chunks", [[63], [1] * 63, [10, 10, 10, 10, 10, 13],
                                    [7, 16, 3, 25, 12]])
@pytest.mark.parametrize("scale_count", SCALE_COUNT)
def test_online_extractor_chunking_invariance(small, chunks, scale_count):
    """For any chunking the streaming extractor's outputs concatenate to
    extract_online_ivectors over the whole utterance, exactly."""
    _je, te = small
    stats_scale, max_count = scale_count
    x = np.random.default_rng(1).normal(size=(63, 5)).astype(np.float32)
    batch = tiv.extract_online_ivectors(te, x, 10, stats_scale, max_count).numpy()
    st = tiv.OnlineIvectorExtractor(te, period=10, stats_scale=stats_scale,
                                    max_count=max_count)
    outs, lo = [], 0
    for n in chunks:
        outs.append(st.accept(x[lo: lo + n]))
        lo += n
    outs.append(st.input_finished())
    np.testing.assert_array_equal(np.concatenate(outs), batch)
    assert st.input_finished().shape == (0, 3)


def test_online_extractor_float64_input(small):
    _je, te = small
    x = np.random.default_rng(2).normal(size=(40, 5))
    st = tiv.OnlineIvectorExtractor(te, period=10)
    got = np.concatenate([st.accept(x[:17]), st.accept(x[17:]), st.input_finished()])
    np.testing.assert_array_equal(got, tiv.extract_online_ivectors(te, x, 10).numpy())
