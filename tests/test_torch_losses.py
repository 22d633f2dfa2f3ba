"""The port's census loss, S2 photometric augmentation and StepLR against
the JAX package's on the same numpy-seeded inputs.

Tolerance rtol 1e-6 (atol 1e-6 for values near 0): the same float32
formulas on the CPU in both packages, with reductions that may sum in a
different order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from popcorn_tpu.data.normalize import photometric_s2_traced as j_photometric
from popcorn_tpu.losses.losses import get_loss as j_get_loss
from popcorn_tpu.train.state import step_lr as j_step_lr
from popcorn_tpu_torch.data.normalize import photometric_s2_traced
from popcorn_tpu_torch.losses.losses import get_loss
from popcorn_tpu_torch.train.state import step_lr

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)
LOSSES = ("l1_loss", "log_l1_loss", "mse_loss", "log_mse_loss", "mr2", "mape", "mCorrelation")


@pytest.mark.parametrize("b", [1, 7])
@pytest.mark.parametrize("name", LOSSES)
def test_get_loss_matches_jax(name, b):
    rng = np.random.default_rng(b * 10 + LOSSES.index(name))
    pred = rng.uniform(0, 1000, b).astype(np.float32)
    gt = rng.uniform(0, 1000, b).astype(np.float32)
    sam = np.float32(0.37)
    kw = dict(loss=(name, "log_l1_loss"), lam=(0.5, 1.0), scale_regularization=0.01, tag="weak")
    ref_loss, ref_aux = j_get_loss(jnp.asarray(pred), jnp.asarray(gt),
                                   scale_abs_mean=jnp.asarray(sam), **kw)
    loss, aux = get_loss(torch.from_numpy(pred), torch.from_numpy(gt),
                         scale_abs_mean=torch.tensor(sam), **kw)
    assert aux.keys() == ref_aux.keys()
    for k in ref_aux:
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)


def test_get_loss_without_scale_matches_jax():
    rng = np.random.default_rng(3)
    pred, gt = rng.uniform(0, 50, (2, 4)).astype(np.float32)
    ref_loss, ref_aux = j_get_loss(jnp.asarray(pred), jnp.asarray(gt))
    loss, aux = get_loss(torch.from_numpy(pred), torch.from_numpy(gt))
    assert aux.keys() == ref_aux.keys() and "Population/scale" not in aux
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("draw", [(0, 1, 0, 1), (1, 0.8, 0, 1), (0, 1, 1, 1.3), (1, 1.2, 1, 0.7)])
def test_photometric_matches_jax(channels, draw):
    rng = np.random.default_rng(channels)
    s2 = rng.uniform(0, 12000, (2, 9, 11, channels)).astype(np.float32)
    params = np.asarray(draw, np.float32)
    ref = j_photometric(jnp.asarray(s2), jnp.asarray(params))
    got = photometric_s2_traced(torch.from_numpy(s2), torch.from_numpy(params))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("epoch,expect", [(0, 1e-4), (4, 1e-4), (5, 0.75e-4), (10, 0.5625e-4)])
def test_step_lr(epoch, expect):
    """The cases of tests/test_train_e2e.py::test_lr_schedule."""
    assert abs(step_lr(1e-4, epoch, 5, 0.75) - expect) < 1e-12
    assert step_lr(1e-4, epoch, 5, 0.75) == j_step_lr(1e-4, epoch, 5, 0.75)
