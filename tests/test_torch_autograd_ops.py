"""The backward of the six custom-op kernels (K1, K2, K4, K5, K6, K7) of
nunif_tpu_torch against ``jax.grad`` of the JAX package's plain paths, on
the CPU.

Each op's backward is its twin's vector-Jacobian product
(``ops/_build.register_twin_vjp``).  The JAX package has no backward for
its Pallas kernels: its modules train only through their plain paths,
which is what it runs on the CPU.  So the references are those paths:
the norm-free Swin block (K1; K5 is the port's window path of the same
block, ``NUNIF_TPU_SWIN_IMG=0``), the im2col stem conv (K2) and
``ShiftedWindowAttention(fused=False)`` on windows (K4) and on the image
(K6), and the JAX ``sdpa`` off the TPU (K7: its ``_xla_sdpa``).  Weights and inputs are drawn with numpy and carried across; the
relative-position tables at std 1 (the init's 0.02 would hide a dropped
bias), an upstream gradient drawn the same way.

Tolerance: fp32 on both sides, the same function summed in another order:
gradients within 1e-4 relative and 1e-5 of the largest element (measured
<= 2e-6 relative).
"""
import torch_threads  # noqa: F401  (one xdist worker's share of the cores)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nunif_tpu.models import unflatten_params
from nunif_tpu.modules import attention as jattn
from nunif_tpu.ops import sdpa as jsdpa
from nunif_tpu.ops.conv3x3 import stem_conv3x3 as jax_stem_conv3x3
from nunif_tpu.waifu2x.models.swin_unet import Im2ColConv3x3 as JaxIm2Col

from nunif_tpu_torch.models import from_flax
from nunif_tpu_torch.models.flax_params import _to_flax_layout, flax_keys
from nunif_tpu_torch.modules import attention as tattn
from nunif_tpu_torch.ops import _build
from nunif_tpu_torch.ops import sdpa as k7
from nunif_tpu_torch.ops import conv3x3 as k2
from nunif_tpu_torch.waifu2x.models.swin_unet import Im2ColConv3x3

C, HEADS, WS = 32, 2, 6


def _flat(module, rng):
    """Seeded flax-layout params for a port module: kernels lecun-scaled,
    biases N(0, 0.1), bias tables N(0, 1)."""
    out = {}
    for key, ref in _shapes(module).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            a = rng.standard_normal(ref) / np.sqrt(np.prod(ref[:-1]))
        elif leaf == "relative_position_bias_table":
            a = rng.standard_normal(ref)
        else:
            a = rng.normal(0, 0.1, ref)
        out[key] = a.astype(np.float32)
    return out


def _shapes(module):
    keys = flax_keys(module)
    return {keys[n]: tuple(_to_flax_layout(n, p.detach().numpy()).shape)
            for n, p in module.named_parameters()}


def _port_grads(module, fn, inputs, g):
    """(output, [input grads], {flax path: param grad}, autograd node names)
    of sum(fn(*inputs) * g) through the port, ``module`` holding the
    parameters."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    module.zero_grad(set_to_none=True)
    out = fn(*leaves)
    (out * torch.from_numpy(g)).sum().backward()
    keys = flax_keys(module)
    params = {keys[n]: _to_flax_layout(n, p.grad.numpy())
              for n, p in module.named_parameters()}
    return out, [a.grad.numpy() for a in leaves], params, _graph_names(out)


def _graph_names(t):
    """Names of the autograd nodes behind t."""
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__ if not hasattr(node, "name")
                  else node.name())
        todo.extend(f for f, _ in node.next_functions)
    return names


def _jax_grads(apply, flat, inputs, g):
    params = unflatten_params({k: jnp.asarray(v) for k, v in flat.items()})

    def f(p, *xs):
        return jnp.sum(apply(p, *xs) * jnp.asarray(g))
    grads = jax.jit(jax.grad(f, argnums=tuple(range(len(inputs) + 1))))(
        params, *[jnp.asarray(a) for a in inputs])
    flat_g = {"/".join(k.key for k in path): np.asarray(v) for path, v in
              jax.tree_util.tree_flatten_with_path(grads[0])[0]}
    return [np.asarray(v) for v in grads[1:]], flat_g


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def _check(port, jax_ref, op_name):
    _out, gx, gp, names = port
    jx, jp = jax_ref
    # went through the op (its registered backward)
    assert f"GeneratedBackwardFor_nunif_tpu_torch_{op_name}_default" \
        "Backward" in names, names
    assert len(gx) == len(jx) and set(gp) == set(jp)
    for a, b in zip(gx, jx):
        _close(a, b)
    for k in jp:
        _close(gp[k], jp[k])


@pytest.mark.parametrize("window_path", [False, True])
@pytest.mark.parametrize("shift,skip", [(0, True), (3, False)])
def test_swin_block_vjp_matches_jax_grad(monkeypatch, window_path, shift, skip):
    """K1 (and K5 on the window path): the norm-free block's gradients
    with respect to x, the skip and every parameter."""
    if window_path:
        monkeypatch.setenv("NUNIF_TPU_SWIN_IMG", "0")
    rng = np.random.default_rng(1 + shift)
    blk = tattn.SwinTransformerBlock(C, HEADS, WS, shift_size=shift)
    flat = _flat(blk, rng)
    from_flax(blk, flat)
    x = rng.normal(0, 0.5, (2, 12, 18, C)).astype(np.float32)
    inputs = [x] + ([rng.normal(0, 0.5, x.shape).astype(np.float32)]
                    if skip else [])
    g = rng.standard_normal(x.shape).astype(np.float32)
    jblk = jattn.SwinTransformerBlock(C, HEADS, WS, shift_size=shift)

    def apply(p, x, *sk):
        return jblk.apply({"params": p}, x, skip=sk[0] if sk else None)

    def port(x, *sk):
        return blk(x, skip=sk[0] if sk else None)
    op = "fused_swin_block" if window_path else "fused_swin_block_image"
    _check(_port_grads(blk, port, inputs, g),
           _jax_grads(apply, flat, inputs, g), op)


def test_stem_conv_vjp_matches_jax_grad():
    """K2: the stem conv (crop, leaky-ReLU) against the JAX im2col path."""
    rng = np.random.default_rng(3)
    conv = Im2ColConv3x3(16, 32, crop=2, lrelu_slope=0.1)
    flat = _flat(conv, rng)
    from_flax(conv, flat)
    x = rng.normal(0, 0.5, (2, 14, 20, 16)).astype(np.float32)
    g = rng.standard_normal((2, 8, 14, 32)).astype(np.float32)
    jconv = JaxIm2Col(32, crop=2, lrelu_slope=0.1)
    _check(_port_grads(conv, conv, [x], g),
           _jax_grads(lambda p, x: jconv.apply({"params": p}, x), flat, [x], g),
           "stem_conv3x3")


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("image", [False, True])
def test_window_attention_vjp_matches_jax_grad(image, shift):
    """K4 (windows) and K6 (image form) inside ShiftedWindowAttention
    against the JAX module's plain path (``fused=False``)."""
    rng = np.random.default_rng(5 + shift)
    attn = tattn.ShiftedWindowAttention(C, HEADS, WS, shift_size=shift)
    flat = _flat(attn, rng)
    from_flax(attn, flat)
    jmod = jattn.ShiftedWindowAttention(C, HEADS, WS, shift_size=shift,
                                        fused=False)
    b, nh, nw = 2, 2, 3
    if image:
        x = rng.normal(0, 1, (b, nh * WS, nw * WS, C)).astype(np.float32)
        apply = lambda p, x: jmod.apply({"params": p}, x)  # noqa: E731
        port, op = attn, "fused_window_attention_image"
    else:
        x = rng.normal(0, 1, (b * nh * nw, WS * WS, C)).astype(np.float32)
        apply = lambda p, x: jmod.apply({"params": p}, x, windows=(b, nh, nw))  # noqa: E731
        port = lambda x: attn(x, windows=(b, nh, nw))  # noqa: E731
        op = "fused_window_attention"
    g = rng.standard_normal(x.shape).astype(np.float32)
    _check(_port_grads(attn, port, [x], g), _jax_grads(apply, flat, [x], g), op)


def test_pallas_grad_diverges_from_jax():
    """Reverse mode through the JAX package's Pallas kernel raises (no
    ``custom_vjp``), so its trainer cannot train swin_unet on a TPU, where
    its modules pick the kernels; the port's op returns the gradients of
    its twin (ROADMAP queue 3)."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 0.5, (1, 22, 20, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 16, 32)) / 12).astype(np.float32)
    b = rng.normal(0, 0.1, (32,)).astype(np.float32)
    kw = dict(crop=2, lrelu_slope=0.1)

    def f(x):
        return jnp.sum(jax_stem_conv3x3(x, jnp.asarray(w), jnp.asarray(b),
                                        interpret=True, **kw))
    assert float(f(jnp.asarray(x))) == pytest.approx(float(jnp.sum(
        JaxIm2Col(32, **kw).apply({"params": {"kernel": w, "bias": b}},
                                  jnp.asarray(x)))), rel=1e-5)
    with pytest.raises(Exception):
        jax.grad(f)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    k2.stem_conv3x3(xt, torch.from_numpy(w), torch.from_numpy(b), **kw).sum().backward()
    want = jax.grad(lambda x: jnp.sum(JaxIm2Col(32, **kw).apply(
        {"params": {"kernel": w, "bias": b}}, x)))(jnp.asarray(x))
    _close(xt.grad.numpy(), np.asarray(want))


def test_ops_keep_no_graph_without_grad():
    """Inference (frozen weights, or no_grad) builds no graph through the
    ops; the packed list and ints get no gradient."""
    blk = tattn.SwinTransformerBlock(C, HEADS, WS, shift_size=3)
    x = torch.randn(1, 12, 12, C)
    with torch.no_grad():
        assert blk(x).grad_fn is None
    blk.requires_grad_(False)
    assert blk(x).grad_fn is None
    assert blk(x.requires_grad_(True)).grad_fn is not None


def test_refuse_grad_guard():
    """K3's launch has no backward: on the card its wrapper calls
    ``refuse_grad``, which raises while autograd records an input that
    needs a gradient and lets frozen inputs and no_grad through.  K7 is a
    custom op with the twin's VJP: its output carries a ``grad_fn``."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("warp_x_bounded", x, torch.zeros(2))
    _build.refuse_grad("warp_x_bounded", x.detach(), None)
    with torch.no_grad():
        _build.refuse_grad("warp_x_bounded", x, x)
    q = torch.randn(1, 2, 5, 64, requires_grad=True)
    out = k7.sdpa(q, q.detach(), q.detach())
    assert "nunif_tpu_torch_sdpa" in type(out.grad_fn).__name__
    with torch.no_grad():
        assert k7.sdpa(q, q, q).grad_fn is None


def _qkv_views(rng, b=2, n=19, m=19, heads=3, d=64):
    """q, k, v as the DINOv2 trunk passes them: strided (B, H, N, d) views
    of a (B, N, 3, H, d) projection (k and v of m tokens)."""
    qkv = rng.standard_normal((b, max(n, m), 3, heads, d)).astype(np.float32)
    return qkv, lambda t: [t[:, :n, 0].permute(0, 2, 1, 3), t[:, :m, 1].permute(0, 2, 1, 3),
                          t[:, :m, 2].permute(0, 2, 1, 3)]


@pytest.mark.parametrize("nm", [(19, 19), (7, 12)])
def test_sdpa_vjp_matches_jax_grad(nm):
    """K7's op: its backward (the twin's VJP) equals plain autograd through
    ``sdpa_plain`` exactly and ``jax.grad`` of the JAX ``sdpa`` (its plain
    path off the TPU) within the file's tolerance, on strided views."""
    rng = np.random.default_rng(12)
    n, m = nm
    qkv, views = _qkv_views(rng, n=n, m=m)
    g = rng.standard_normal((2, 3, n, 64)).astype(np.float32)
    scale = 0.11
    t = torch.from_numpy(qkv).requires_grad_(True)
    out = k7.sdpa(*views(t), scale=scale)
    (out * torch.from_numpy(g)).sum().backward()
    got = t.grad.clone()
    t.grad = None
    (k7.sdpa_plain(*views(t), scale=scale) * torch.from_numpy(g)).sum().backward()
    assert torch.equal(got, t.grad)
    assert out.stride() == (n * 3 * 64, 64, 3 * 64, 1)   # (B, N, H, d) memory

    def f(a):
        q, kk, v = (a[:, :n, 0].transpose(0, 2, 1, 3), a[:, :m, 1].transpose(0, 2, 1, 3),
                    a[:, :m, 2].transpose(0, 2, 1, 3))
        return jnp.sum(jsdpa.sdpa(q, kk, v, scale=scale) * g)
    want = jax.grad(f)(jnp.asarray(qkv))
    _close(got.numpy(), np.asarray(want))
