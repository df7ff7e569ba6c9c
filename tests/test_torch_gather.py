"""Port gather (plain version, the one a CPU tensor takes) vs the JAX Pallas
kernel in interpret mode and vs numpy: exact equality, since values are only
copied."""

import tests.torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from old_kaldi_git_tpu.ops.gather_kernel import batched_table_gather as jax_gather
from old_kaldi_git_tpu_torch.ops.gather_kernel import (
    batched_table_gather,
    batched_table_gather_plain,
)


def _inputs(seed, b, p, e, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(b, p)).astype(np.float32)
    idx = rng.integers(lo, p if hi is None else hi, size=(b, e)).astype(np.int32)
    return tab, idx


@pytest.mark.parametrize("b,p,e", [(4, 2000, 1300), (3, 50, 7), (9, 129, 257),
                                   (1, 1, 5), (8, 2048, 512)])
def test_matches_pallas_interpret_and_numpy(b, p, e):
    tab, idx = _inputs(b * 1000 + e, b, p, e)
    out = batched_table_gather(torch.from_numpy(tab), torch.from_numpy(idx)).numpy()
    assert out.dtype == np.float32 and out.shape == (b, e)
    assert np.array_equal(out, np.take_along_axis(tab, idx, axis=1))
    ref = np.asarray(jax_gather(jnp.asarray(tab), jnp.asarray(idx), interpret=True))
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("b,p,e", [(3, 40, 5), (5, 300, 77)])
def test_out_of_range_indices_clamp(b, p, e):
    tab, idx = _inputs(7, b, p, e, lo=-50, hi=p + 50)
    idx[0, :5] = [-5, 0, p - 1, p, 1000]
    out = batched_table_gather(torch.from_numpy(tab), torch.from_numpy(idx)).numpy()
    want = np.take_along_axis(tab, np.clip(idx, 0, p - 1), axis=1)
    assert np.array_equal(out, want)
    ref = np.asarray(jax_gather(jnp.asarray(tab), jnp.asarray(idx), interpret=True))
    assert np.array_equal(out, ref)


def test_repeated_and_boundary_indices():
    tab = np.arange(12, dtype=np.float32).reshape(2, 6) * 1.5
    idx = np.array([[0, 0, 5, 5, 3], [5, 4, 0, 1, 1]], np.int32)
    out = batched_table_gather_plain(torch.from_numpy(tab), torch.from_numpy(idx))
    assert np.array_equal(out.numpy(), np.take_along_axis(tab, idx, axis=1))


def test_wrapper_refuses_wrong_types_and_shapes():
    tab = torch.zeros((2, 4))
    with pytest.raises(TypeError):
        batched_table_gather(tab, torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(TypeError):
        batched_table_gather(tab.double(), torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        batched_table_gather(tab, torch.zeros((3, 3), dtype=torch.int32))


def test_cpu_call_does_not_count_as_a_launch():
    before = batched_table_gather.launches
    batched_table_gather(torch.zeros((2, 4)), torch.zeros((2, 3), dtype=torch.int32))
    assert batched_table_gather.launches == before


@pytest.mark.parametrize("b,T,p,e,t", [(4, 7, 2000, 1300, 3), (3, 5, 129, 257, 1),
                                       (9, 2, 50, 7, 1), (2, 3, 1, 5, 2)])
def test_row_strided_table_equals_the_contiguous_gather(b, T, p, e, t):
    """The decoder passes loglikes[:, t] of a [B, T, P] tensor in place."""
    rng = np.random.default_rng(b * 100 + t)
    ll = torch.from_numpy(rng.normal(size=(b, T, p)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-2, p + 2, size=(b, e)).astype(np.int32))
    frame = ll[:, t]
    assert frame.stride() == (T * p, 1) and (b == 1 or not frame.is_contiguous())
    out = batched_table_gather(frame, idx)
    assert torch.equal(out, batched_table_gather(frame.contiguous(), idx))
    ref = np.asarray(jax_gather(jnp.asarray(frame.contiguous().numpy()),
                                jnp.asarray(idx.numpy()), interpret=True))
    assert np.array_equal(out.numpy(), ref)
