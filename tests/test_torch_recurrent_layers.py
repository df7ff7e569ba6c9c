"""The port's recurrent, attention and conv layers against the JAX
package's flax modules on the CPU, weights carried across by name
(convert.torch_params_from_flax).  Inputs and weights from numpy seeds;
widths small (cell 16, T <= 40).  Tolerance: outputs within 1e-5 of the
largest |output| (float32 products of <= 50 terms in another order, and
for the recurrences up to 40 steps of them); chunks run with the carried
(c, r) state equal the whole sequence within 1e-6 (the same arithmetic
frame by frame).  The conv layer in train mode: outputs and the updated
running statistics within 1e-5 relative."""

import tests.torch_threads  # noqa: F401
from collections.abc import Mapping

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import old_kaldi_git_tpu.models.recurrent as jrec
import old_kaldi_git_tpu.models.tdnn as jtdnn
from old_kaldi_git_tpu_torch import convert
from old_kaldi_git_tpu_torch.models import recurrent as trec
from old_kaldi_git_tpu_torch.models import tdnn as ttdnn


def _flax(module, x, seed=0, scale=0.5):
    """A flax module's variables, every parameter drawn from numpy (biases
    non-zero too) into the tree flax's init makes (jax.eval_shape)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.default_rng(seed + 100)

    def fill(tree):
        return {k: fill(v) if isinstance(v, Mapping) else
                (0.5 + rng.random(v.shape)).astype(np.float32) if k == "var" else
                (rng.normal(size=v.shape) * scale).astype(np.float32)
                for k, v in tree.items()}
    return fill(shapes)


def _carry(layer, variables):
    named = convert.torch_params_from_flax(variables["params"])
    for k in ("mean", "var"):
        if "batch_stats" in variables:
            named[k] = variables["batch_stats"]["batchnorm"][k]
    layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in named.items()})
    return layer


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_gru_layer_and_its_carried_chunks():
    x = _x((2, 37, 6))
    jl = jrec.GruLayer(cell_dim=16, recurrent_dim=8, nonrecurrent_dim=4)
    v = _flax(jl, x)
    tl = _carry(trec.GruLayer(6, 16, 8, 4), v)
    want = jl.apply(v, jnp.asarray(x))
    got = tl(torch.from_numpy(x))
    _close(got, want)
    y1, c1 = tl(torch.from_numpy(x[:, :9]), return_carry=True)
    y2 = tl(torch.from_numpy(x[:, 9:]), initial_carry=c1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).detach().numpy(),
                               got.detach().numpy(), atol=1e-6, rtol=0)
    _, jc = jl.apply(v, jnp.asarray(x[:, :9]), return_carry=True)
    for a, b in zip(c1, jc):
        _close(a, b)


def test_lstmp_layer_carried_chunks():
    x = _x((2, 40, 6), seed=2)
    jl = jrec.LstmpLayer(cell_dim=16, recurrent_dim=4, nonrecurrent_dim=3)
    v = _flax(jl, x)
    tl = _carry(trec.LstmpLayer(6, 16, 4, 3), v)
    whole = tl(torch.from_numpy(x))
    _close(whole, jl.apply(v, jnp.asarray(x)))
    pieces, carry = [], None
    for lo, hi in ((0, 7), (7, 32), (32, 40)):
        y, carry = tl(torch.from_numpy(x[:, lo:hi]), initial_carry=carry, return_carry=True)
        pieces.append(y)
    np.testing.assert_allclose(torch.cat(pieces, 1).detach().numpy(),
                               whole.detach().numpy(), atol=1e-6, rtol=0)


def test_blstmp_layer():
    x = _x((2, 33, 6), seed=3)
    jl = jrec.BlstmpLayer(cell_dim=16, recurrent_dim=4, nonrecurrent_dim=4)
    v = _flax(jl, x)
    assert sorted(v["params"]) == ["backward", "forward"]
    tl = _carry(trec.BlstmpLayer(6, 16, 4, 4), v)
    _close(tl(torch.from_numpy(x)), jl.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("output_context", [True, False])
@pytest.mark.parametrize("time_stride", [1, 2])
def test_restricted_attention(output_context, time_stride):
    x = _x((2, 23, 10), seed=4)
    kw = dict(num_heads=3, key_dim=5, value_dim=4, num_left_inputs=3,
              num_right_inputs=2, time_stride=time_stride, output_context=output_context)
    jl = jrec.RestrictedAttentionLayer(**kw)
    v = _flax(jl, x)
    tl = _carry(trec.RestrictedAttentionLayer(10, **kw), v)
    got = tl(torch.from_numpy(x))
    assert got.shape[-1] == tl.output_dim == 3 * 4 + (3 * 6 if output_context else 0)
    _close(got, jl.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("height_subsample", [1, 2])
def test_time_height_conv(height_subsample):
    H, C = 7, 3
    x = _x((2, 19, H * C), seed=5)
    kw = dict(time_offsets=(-1, 0, 2), height_offsets=(-2, 0, 1),
              height_subsample=height_subsample)
    jl = jtdnn.TimeHeightConvLayer(num_filters=5, height_in=H, **kw)
    v = _flax(jl, x)
    tl = _carry(ttdnn.TimeHeightConvLayer(H * C, 5, H, **kw), v).eval()
    got = tl(torch.from_numpy(x))
    assert got.shape[-1] == tl.output_dim == -(-H // height_subsample) * 5
    _close(got, jl.apply(v, jnp.asarray(x)))
    # train mode: the batch's statistics, and the running update
    want, mutated = jl.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tl.train()
    _close(tl(torch.from_numpy(x)), want)
    for k in ("mean", "var"):
        _close(getattr(tl, k), mutated["batch_stats"]["batchnorm"][k])
