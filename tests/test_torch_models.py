"""DispNet-lite and SegNet-lite (``dynslam_tpu_torch/models/``) against
the JAX package's Flax modules on the same parameters (drawn with Flax's
initialisers by the port and carried to Flax's layout by
``convert.state_dict_to_flax``), at an odd size (75x101: the strided
convs pad (1, 1)) and an even one (64x96: (0, 1)).

Tolerances: the forward outputs to 1e-5 absolute (measured 1.9e-6 on
DispNet's 0-32 px output: cuDNN-free CPU convolutions and XLA's sum in
another order); the loss of each of 3 Adam steps to rel 1e-4; the
parameters after 3 steps to 2 * lr * 3 at most (Adam turns a gradient
near 0 into a step of ~lr whose sign is the gradient's, so a sign flip
costs up to 2 lr a step) and the median |difference| to lr / 100
(measured 1e-6 at lr 1e-3). bf16: the port's bf16 forward within 0.05
px of Flax's bf16 forward (measured 0.011) and of the float32 one.

``resize_bilinear`` against ``jax.image.resize(..., "bilinear",
antialias=False)`` at the decoders' shapes (1242x375, 64x96, 75x101) and
one downsample, on inputs and cotangents in [0, 1): the forward to 1e-6
absolute (measured 8.6e-7 at 38x51 -> 75x101, <= 4.2e-7 elsewhere), the
gradient to 1e-6 of its largest value (up to ~4: an input feeds ~2
outputs along each axis at a 2x upsampling; measured 1.9e-6 of 4.0 at
38x51 -> 75x101, <= 9.5e-7 elsewhere). The gaps are XLA's: its CPU code
rounds most sample centres ``(o + 0.5) * in / out - 0.5`` once (a fused
multiply-add, as the port's weights do) but a few of them twice, and a
centre one float32 ulp away moves its two weights by that ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dynslam_tpu.models import dispnet as jd
from dynslam_tpu.models import segnet as js
from dynslam_tpu_torch import convert
from dynslam_tpu_torch.models import dispnet as td
from dynslam_tpu_torch.models import segnet as ts
from dynslam_tpu_torch.models import layers
from dynslam_tpu_torch.models.layers import same_pads
from torch_threads import threads

torch_threads = threads(1)

SIZES = [(75, 101), (64, 96)]
FWD_ATOL = 1e-5
LOSS_RTOL = 1e-4
LR, STEPS = 1e-3, 3
BF16_ATOL = 0.05
RESIZE_FWD_ATOL, RESIZE_GRAD_RTOL = 1e-6, 1e-6

#: (batch, channels, (H, W) in, (H, W) out): the decoders' resizes at
#: 1242x375 (SegNet-lite's widths, DispNet-lite's first level), at 64x96
#: and 75x101 (all four levels), and one downsample
RESIZES = [
    (1, 3, (24, 78), (47, 156)), (1, 3, (47, 156), (94, 311)),
    (1, 3, (94, 311), (188, 621)), (1, 2, (188, 621), (375, 1242)),
    (2, 4, (4, 6), (8, 12)), (2, 4, (8, 12), (16, 24)),
    (2, 4, (16, 24), (32, 48)), (2, 4, (32, 48), (64, 96)),
    (2, 4, (5, 7), (10, 13)), (2, 4, (10, 13), (19, 26)),
    (2, 4, (19, 26), (38, 51)), (2, 4, (38, 51), (75, 101)),
    (2, 4, (94, 311), (47, 156)),
]
RESIZE_IDS = [f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for _, _, a, b in RESIZES]


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


class _Case:
    """One model at one size: the Flax module and params, the port's
    module with them, and a batch as numpy (NHWC) and tensors (NCHW)."""

    def __init__(self, kind: str, h: int, w: int):
        rng = np.random.default_rng(h * w)
        self.kind = kind
        if kind == "dispnet":
            self.jm = jd.create_model(max_disparity=32.0)
            self.tm = td.DispNetLite(max_disparity=32.0)
            l, r = (rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32)
                    for _ in range(2))
            valid = rng.random((2, h, w)) < np.array([0.3, 0.8])[:, None,
                                                                 None]
            self.jbatch = dict(left=l, right=r, valid=valid,
                               disparity=rng.uniform(0, 32, (2, h, w))
                               .astype(np.float32))
            self.tbatch = dict(left=_nchw(l), right=_nchw(r),
                               disparity=torch.from_numpy(
                                   self.jbatch["disparity"]),
                               valid=torch.from_numpy(valid))
            self.jinputs, self.tinputs = (l, r), (_nchw(l), _nchw(r))
        else:
            self.jm = js.create_model()
            self.tm = ts.SegNetLite()
            rgb = rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32)
            mask = np.zeros((2, h, w), bool)
            mask[:, h // 3: h // 2, w // 4: w // 2] = True
            self.jbatch = dict(rgb=rgb, mask=mask)
            self.tbatch = dict(rgb=_nchw(rgb), mask=torch.from_numpy(mask))
            self.jinputs, self.tinputs = (rgb,), (_nchw(rgb),)
        # Flax's initialisers drawn by the port (a Flax init compiles the
        # whole model), carried to Flax's layout
        self.tmod.init_params(self.tm, torch.Generator().manual_seed(h))
        self.jp = jax.tree_util.tree_map(jnp.asarray, convert.state_dict_to_flax(
            self.tm.state_dict()))
        self.apply = jax.jit(self.jm.apply)

    @property
    def jmod(self):
        return jd if self.kind == "dispnet" else js

    @property
    def tmod(self):
        return td if self.kind == "dispnet" else ts

    def jloss(self, params):
        if self.kind == "dispnet":
            b = self.jbatch
            return jd.disparity_loss(self.jm, params, b["left"], b["right"],
                                     b["disparity"], b["valid"])
        return js.seg_loss(self.jm, params, self.jbatch["rgb"],
                           self.jbatch["mask"])

    def tloss(self):
        if self.kind == "dispnet":
            b = self.tbatch
            return td.disparity_loss(self.tm, b["left"], b["right"],
                                     b["disparity"], b["valid"])
        return ts.seg_loss(self.tm, self.tbatch["rgb"], self.tbatch["mask"])


CASES = [(k, h, w) for k in ("dispnet", "segnet") for h, w in SIZES]
IDS = [f"{k}-{h}x{w}" for k, h, w in CASES]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    return _Case(*request.param)


def test_same_padding_is_xla_rule():
    """(0, 1) at stride 2 on even sizes, (1, 1) on odd ones and at
    stride 1, as ``lax.padtype_to_pads`` gives for ``SAME``."""
    from jax import lax

    for n in (1, 2, 5, 8, 75, 101, 188, 375):
        for s in (1, 2):
            assert same_pads(n, 3, s) == tuple(
                lax.padtype_to_pads((n,), (3,), (s,), "SAME")[0]), (n, s)


def test_forward(case):
    want = np.asarray(case.apply(case.jp, *case.jinputs))
    with torch.no_grad():
        got = case.tm(*case.tinputs).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)


def test_loss(case):
    with torch.no_grad():
        got = float(case.tloss())
    want = float(jax.jit(case.jloss)(case.jp))
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_train_steps_match_optax(case):
    opt = optax.adam(LR)
    jstep = jax.jit(case.jmod.make_train_step(case.jm, opt))
    jbatch = {k: jnp.asarray(v) for k, v in case.jbatch.items()}
    tm = case.tmod.DispNetLite(max_disparity=32.0) \
        if case.kind == "dispnet" else ts.SegNetLite()
    tm.load_state_dict(case.tm.state_dict())
    tstep = case.tmod.make_train_step(
        tm, torch.optim.Adam(tm.parameters(), lr=LR))
    params, state = case.jp, opt.init(case.jp)
    for i in range(STEPS):
        params, state, jl = jstep(params, state, jbatch)
        tl = tstep(case.tbatch)
        assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL), i
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                             params))
    diff = np.concatenate([(v.detach() - want[k]).abs().numpy().ravel()
                           for k, v in tm.state_dict().items()])
    assert diff.max() <= 2 * LR * STEPS, diff.max()
    assert np.median(diff) <= LR / 100, np.median(diff)
    # the steps moved the parameters
    moved = np.concatenate([(v.detach() - case.tm.state_dict()[k]).abs()
                            .numpy().ravel()
                            for k, v in tm.state_dict().items()])
    assert np.median(moved) > LR / 2


def test_bf16_forward():
    """bf16 convolutions and resizes, the sigmoid in float32, as Flax's
    ``dtype=bfloat16`` (at the odd size)."""
    c = _Case("dispnet", *SIZES[0])
    jm = jd.create_model(max_disparity=32.0, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(jm.apply)(c.jp, *c.jinputs))
    tm = td.DispNetLite(max_disparity=32.0, dtype=torch.bfloat16)
    tm.load_state_dict(c.tm.state_dict())
    with torch.no_grad():
        got = tm(*c.tinputs)
        f32 = c.tm(*c.tinputs).numpy()
    assert got.dtype == torch.float32
    got = got.numpy()
    assert np.abs(got - want).max() <= BF16_ATOL
    assert np.abs(got - f32).max() <= BF16_ATOL
    assert np.abs(got - f32).max() > 0  # it did compute in bf16


@pytest.mark.parametrize("kind", ["dispnet", "segnet"])
def test_conversion_round_trip(kind):
    """Flax's own init (its shapes, by ``jax.eval_shape``) has the port
    module's parameters under the same names and shapes; Flax ->
    state_dict -> Flax and back are exact."""
    c = _Case(kind, 32, 48)
    shapes = jax.eval_shape(c.jm.init, jax.random.PRNGKey(0),
                            *c.jinputs)["params"]
    flax = jax.tree_util.tree_map(np.asarray, c.jp)

    def layout(tree):
        return {n: {k: tuple(v.shape) for k, v in p.items()}
                for n, p in tree.items()}

    assert layout(shapes) == layout(flax["params"])
    back = convert.state_dict_to_flax(convert.flax_to_state_dict(flax))
    assert set(back["params"]) == set(flax["params"])
    for name, p in flax["params"].items():
        for k in p:
            np.testing.assert_array_equal(back["params"][name][k], p[k])
    sd = convert.flax_to_state_dict(back)
    for k, v in c.tm.state_dict().items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("kind", ["dispnet", "segnet"])
def test_init_params_is_flax_initialiser(kind):
    """lecun_normal kernels (truncated at 2 sigma, variance 1 / fan_in)
    and zero biases, as Flax's defaults."""
    mod = td if kind == "dispnet" else ts
    m = mod.init_params(mod.create_model(), torch.Generator().manual_seed(0))
    for conv in m.convs:
        w = conv.weight.detach()
        fan_in = w[0].numel()
        std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert float(w.abs().max()) <= 2 * std + 1e-7
        if w.numel() > 5000:
            assert float(w.std()) == pytest.approx(np.sqrt(1 / fan_in),
                                                   rel=0.05)
        assert not conv.bias.detach().any()


def _jax_resize(x: np.ndarray, size):
    """``jax.image.resize`` of NCHW ``x`` (NHWC inside, as the Flax models
    call it) and its VJP."""
    b, c = x.shape[:2]

    def fn(v):
        return jax.image.resize(v, (b, *size, c), "bilinear",
                                antialias=False)

    out, vjp = jax.vjp(fn, jnp.asarray(x.transpose(0, 2, 3, 1)))
    return (np.asarray(out).transpose(0, 3, 1, 2),
            lambda g: np.asarray(vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))[0]
                                 ).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("b,c,src,dst", RESIZES, ids=RESIZE_IDS)
def test_resize_matches_jax(b, c, src, dst):
    """Forward and gradient of ``resize_bilinear`` against JAX's."""
    rng = np.random.default_rng(src[0] * 1000 + dst[1])
    x = rng.random((b, c, *src), dtype=np.float32)
    g = rng.random((b, c, *dst), dtype=np.float32)
    want, vjp = _jax_resize(x, dst)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = layers.resize_bilinear(xt, dst)
    (grad,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    got, gwant = got.detach().numpy(), vjp(g)
    assert got.shape == want.shape and got.dtype == np.float32
    fwd_gap = float(np.abs(got - want).max())
    grad_gap = float(np.abs(grad.numpy() - gwant).max())
    grad_bound = RESIZE_GRAD_RTOL * float(np.abs(gwant).max())
    assert fwd_gap <= RESIZE_FWD_ATOL and grad_gap <= grad_bound, (
        f"forward max |d| {fwd_gap} (bound {RESIZE_FWD_ATOL}), gradient "
        f"{grad_gap} (bound {grad_bound})")


@pytest.mark.parametrize("b,c,src,dst", RESIZES, ids=RESIZE_IDS)
def test_resize_contracts_in_einsums_order(b, c, src, dst):
    """``width_first`` is the order of JAX's two contractions (its first
    ``dot_general`` makes the width axis ``dst[1]`` long or the height
    axis ``dst[0]``)."""
    x = jax.ShapeDtypeStruct((b, *src, c), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda v: jax.image.resize(
        v, (b, *dst, c), "bilinear", antialias=False))(x)
    dots = [e for e in jaxpr.eqns[0].params["jaxpr"].eqns
            if e.primitive.name == "dot_general"]
    first = dots[0].outvars[0].aval.shape
    assert first[0] in (dst[0], dst[1]) and dst[0] != dst[1]
    assert layers.width_first(*src, *dst) == (first[0] == dst[1]), first


def test_resize_weights_are_shared_and_frozen():
    """One weight matrix per (in, out, dtype, device), made once; the
    resize leaves it as it was and takes no gradient into it."""
    x = torch.rand(1, 2, 5, 7, requires_grad=True)
    layers.resize_bilinear(x, (10, 13)).sum().backward()
    w = layers._weights(7, 13, torch.float32, torch.device("cpu"))
    assert w is layers._weights(7, 13, torch.float32, torch.device("cpu"))
    assert not w.requires_grad and w.grad is None
    np.testing.assert_array_equal(w.numpy(), layers._triangle_weights(7, 13))
    assert w.shape == (13, 7)
    np.testing.assert_allclose(w.sum(1).numpy(), 1.0, rtol=1e-6)
