"""Activation maximization's steps in the port against the JAX Engine on
the CPU, with the seam off and on (the helpers, sizes and hazards are
tests/test_torch_fi_am.py's; this file holds the two runs that compile
the JAX step of the 3-scale generator under VGG16, so that each file stays
near 45 s on one core)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_fi_am import (AM_NET, AM_SIZE, F32_TOL, _extractor64, _hold,  # noqa: E402
                              _jax_points, _small, _z, jam, tam, vgg_weights)

__all__ = ["vgg_weights"]  # the checkpoint fixture, shared


def _am(vgg_weights, seam: bool):
    """(jax spec, port spec, f64 loss) of activation maximization at VGG16
    conv3_1 map 2 (an 8x8 map, so the recipe's window of 20 wraps to all
    of it) under the trajectories' generator."""
    kw = dict(backbone="vgg16_caffe", layer="conv3_1", map_idx=2, weights_path=vgg_weights,
              imsize=AM_SIZE)
    j = _small(jam.task(**kw), AM_NET, AM_SIZE)
    t = _small(tam.task(**kw, device="cpu"), AM_NET, AM_SIZE)
    t.model.up_conv = seam
    extract = _extractor64("vgg16_caffe", ("conv3_1",), vgg_weights, AM_SIZE)

    def ref_loss(out):
        return -torch.sum(extract(out[:, :AM_SIZE, :AM_SIZE])["conv3_1"][:1, :, :, 2]) * 5.0

    return j, t, ref_loss


def test_activation_maximization_steps_match_jax_engine(vgg_weights):
    """5 JAX Engine steps of activation maximization, f32, the seam off on
    both sides; held at each step's params as feature inversion's are (the
    losses of free runs part by 30 % within 3 steps), to F32_TOL
    (readings: render 8.0e-6, loss 3.1e-6 relative, gradients 7.0e-3 of
    the largest from JAX where JAX is 7.0e-3 from f64, and 6.6e-4 from
    f64)."""
    j, t, ref_loss = _am(vgg_weights, seam=False)
    z = _z(AM_SIZE)
    _hold(t, _jax_points(j, z, seam=False), z, ref_loss, F32_TOL)


def test_activation_maximization_steps_match_jax_with_the_seam_on(vgg_weights):
    """The same with the seam on in both packages (the port's plain seam at
    LR 4 and 8, C = F = 128; the JAX package's seam there), both rounding
    the seam's operands: the render within 5e-3, the loss within 1e-2
    relative, the gradients with tests/test_torch_skip.py's seam-on 5e-2
    of the largest as tol['grad'] (readings: render 3.1e-3 from f64 and
    3.0e-3 from JAX, which is 1.5e-3 from f64; loss 6.3e-3 from f64 at
    step 4; gradients 0.13 from f64 where JAX is 7.3e-2 from it)."""
    j, t, ref_loss = _am(vgg_weights, seam=True)
    z = _z(AM_SIZE)
    _hold(t, _jax_points(j, z, seam=True), z, ref_loss, dict(out=5e-3, loss=1e-2, grad=5e-2))
