"""Card checks of the motion-compensated registration and the stacked
fusion's families (``infer/registration.py``, ``train/stacking.py``):
given CUDA inputs they stay on the card (no fallback to the CPU), and agree
with the same call on the CPU. Plain torch on both devices; this file
imports no JAX, so it runs on the card's machine (``--noconftest``).

Tolerances: control fields after 20 Adam steps a stage within 1e-4 of the
largest entry (as ``test_torch_registration.py`` holds the port to JAX on a
well-conditioned pair); syntheses and the motion transfer within 1e-5
(values in [0, 1]; gathers and small products summed in another order).
"""

import numpy as np
import pytest
import torch

from mri_interpolation_tpu_torch.infer import registration as R
from mri_interpolation_tpu_torch.models import make_warp_inr
from mri_interpolation_tpu_torch.train import stacking as stk

SMALL = dict(ctrl_sizes=(4, 8), pyramid=(2, 1), steps=20)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: checks the registration on the card")
    return torch.device("cuda")


def _moving(t_full=5, shape=(20, 24)):
    axes = [np.linspace(0.0, 1.0, s, dtype=np.float32) for s in shape]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    frames = [np.exp(-np.sum((grid - np.asarray([0.3 + 0.05 * t, 0.45], np.float32)) ** 2, -1) / 0.0288)
              for t in range(t_full)]
    return np.stack(frames, axis=-1).astype(np.float32)


@pytest.mark.gpu
def test_pair_registration_stays_on_the_card(cuda_device):
    even = _moving()
    a, b = even[..., 1], even[..., 2]
    ctrl = R.register_pair(a, b, device=cuda_device, **SMALL)
    ref = R.register_pair(a, b, device="cpu", **SMALL)
    assert ctrl.device.type == "cuda"
    np.testing.assert_allclose(ctrl.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-4 * float(ref.abs().max()))
    mid = R.synthesize_frame(a, b, ctrl, device=cuda_device)
    assert mid.device.type == "cuda"
    np.testing.assert_allclose(mid.cpu().numpy(), R.synthesize_frame(a, b, ctrl.cpu(), device="cpu").numpy(),
                               rtol=0, atol=1e-5)
    up = R.motion_compensated_upsample(even, 9, device=cuda_device, **SMALL)
    np.testing.assert_array_equal(up[..., ::2], even)


@pytest.mark.gpu
def test_group_registration_and_transfer_on_the_card(cuda_device):
    even = _moving()
    ctrl = R.register_group_temporal(even, device=cuda_device, **SMALL)
    ref = R.register_group_temporal(even, device="cpu", **SMALL)
    assert ctrl.device.type == "cuda"
    np.testing.assert_allclose(ctrl.cpu().numpy(), ref.numpy(), rtol=0, atol=1e-4 * float(ref.abs().max()))
    knots = [0.0, 0.25, 0.5, 0.75, 1.0]
    got = R.group_synthesize_at(even, knots, [0.1, 0.6], ctrl=ctrl, appearance="cubic", device=cuda_device)
    want = R.group_synthesize_at(even, knots, [0.1, 0.6], ctrl=ctrl.cpu(), appearance="cubic", device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    kw = dict(n_levels=2, n_features_per_level=2, log2_hashmap_size=10, base_resolution=(4, 4),
              finest_resolution=(20, 24), dim_hidden=8, warp_hidden=16, residual_scale=0.05, seed=3)
    cpu_model, card_model = make_warp_inr(3, device="cpu", **kw), make_warp_inr(3, device=cuda_device, **kw)
    with torch.no_grad():
        for m in (cpu_model, card_model):
            for head in (m.warp, m.residual):
                head[-1].w.copy_(torch.linspace(-1, 1, head[-1].w.numel()).reshape(head[-1].w.shape))
    args = (even, knots, [0.1, 0.4, 0.9])
    got = R.motion_transfer_at(*args, card_model.warp_field, appearance="cubic",
                               residual_field=card_model.residual_field, residual_scale=0.05, device=cuda_device)
    want = R.motion_transfer_at(*args, cpu_model.warp_field, appearance="cubic",
                                residual_field=cpu_model.residual_field, residual_scale=0.05, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_stacking_families_on_the_card(cuda_device):
    frames = _moving()
    t_keep = np.asarray([0.0, 0.25, 0.5, 1.0])
    args = (frames[..., [0, 1, 2, 4]], t_keep, np.asarray([0.75]))
    for make in (lambda d: stk._registration_family(device=d, **SMALL), lambda d: stk._cubic_family(),
                 lambda d: stk._linear_family()):
        np.testing.assert_allclose(make(cuda_device)(*args), make("cpu")(*args), rtol=0, atol=1e-3)
