"""Holding a port's fp32 parameter gradients to the JAX package's, for the
trainers' parity tests: both packages' fp32 rounding errors, measured
against the port's float64 gradient, set the absolute tolerance."""
import numpy as np
import pytest
import torch

import jax

from nunif_tpu.models.io import flatten_params

from nunif_tpu_torch.models.flax_params import _to_flax_layout, flax_keys

import torch_iw3_helpers as h


def loss_and_grads(model, fn, dtype=torch.float32):
    """(loss, {flax key: gradient}) of fn(model, dtype) on the CPU, the
    model and fn's inputs in ``dtype``."""
    model.to(dtype).requires_grad_(True).zero_grad(set_to_none=True)
    loss = fn(model, dtype)
    loss.backward()
    keys = flax_keys(model)
    grads = {keys[n]: _to_flax_layout(n, p.grad.double().numpy()) for n, p in
             model.named_parameters() if p.grad is not None}
    model.float().requires_grad_(False)
    return float(loss.detach()), grads


def jax_loss_and_grads(flat, fn):
    v, g = jax.jit(jax.value_and_grad(fn))(h.jparams(flat))
    return float(v), {k: np.asarray(a) for k, a in flatten_params(g).items()}


def hold(model, fn, want, own_max=1e-3):
    """The port's fp32 loss and gradients against JAX's (``want``): the
    loss within 1e-4 relative; each gradient element within rtol 1e-4 and
    an atol of 1e-6 x the largest gradient magnitude plus the largest
    errors of both packages' fp32 gradients of that tensor, each measured
    against the port's float64 gradient (a sum that cancels, such as a
    bias or a first convolution's kernel ahead of a GroupNorm, loses
    digits in any fp32 order).  The port's own error may be at most 10x
    JAX's (or 1e-5 x the largest gradient; measured up to 4.8x, on
    GroupNorm biases), and JAX's at most ``own_max`` x the largest
    gradient.  A parameter the port's forward does not read (no gradient)
    must have JAX's gradient 0.

    The port's fp32 gradients are taken with oneDNN off: on this CPU
    oneDNN's convolution weight gradient errs by ~5e-3 of the float64
    gradient (cliqa's ``res1/conv1``), ~10^4 times JAX's error there;
    PyTorch's own CPU convolution errs by 2e-7.  The card runs cuDNN."""
    with torch.backends.mkldnn.flags(enabled=False):
        loss, grads = loss_and_grads(model, fn)
    _l64, g64 = loss_and_grads(model, fn, torch.float64)
    assert set(g64) == set(grads)
    jloss, jgrads = want
    assert loss == pytest.approx(jloss, rel=1e-4)
    assert set(grads) <= set(jgrads)
    for k in set(jgrads) - set(grads):
        assert not np.any(jgrads[k]), k
    top = max(float(np.abs(g).max()) for g in jgrads.values())
    assert top > 0
    for k, w in ((k, jgrads[k]) for k in grads):
        own = float(np.abs(w - g64[k]).max())
        ours = float(np.abs(grads[k] - g64[k]).max())
        np.testing.assert_allclose(grads[k], w, rtol=1e-4,
                                   atol=1e-6 * top + own + ours, err_msg=k)
        # the reference is the same function, and the port rounds about as
        # JAX does
        assert own <= own_max * top and ours <= max(10 * own, 1e-5 * top), (k, own, ours)
