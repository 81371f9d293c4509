"""The port's CUDA kernels against their plain versions on the card.

These tests need a CUDA device and skip without one.  They import neither
jax nor the JAX package, so they also run where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from zkfranchise_tpu_torch.ops import ec, ec_affine, ec_lm, lm, msm_lm
from zkfranchise_tpu_torch.ops.cuda import lm_kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pool(kind, rng, n=16):
    mul = ec.g1_mul if kind == "g1" else ec.g2_mul
    return [mul(int(k)) for k in rng.integers(1, 1 << 40, size=n)]


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_mul(dev, field):
    fs = lm.FR if field == "fr" else lm.FQ
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.integers(0, 1 << 13, size=(3, 5, 21, 130),
                                     dtype=np.int32), device=dev)
    a[..., 19:, :] = 0
    b = a[0, :, :, :1]                               # lane-broadcast column
    K.reset_launches()
    got = K.mont_mul(a, b, fs)
    assert K.LAUNCHES["mont_mul"] == 1
    assert torch.equal(got, K.mont_mul_ref(a, b, fs))
    assert torch.equal(K.mont_mul(a, a.flip(-1), fs),
                       K.mont_mul_ref(a, a.flip(-1), fs))


@pytest.mark.parametrize("kind", ["g1", "g2"])
def test_ec_kernels(dev, kind):
    rng = np.random.default_rng(2)
    table = ec_lm.g1_table if kind == "g1" else ec_lm.g2_table
    proj = torch.as_tensor(table(_pool(kind, rng)).T, device=dev)
    p = K.padd_ref(proj[None], proj.flip(-1)[None], kind)
    q = K.padd_ref(proj[None].roll(3, -1), proj[None], kind)
    q[..., 1:2] = msm_lm._neg_plane(p[..., 1:2], kind)      # P + (-P)
    q[..., 2] = p[..., 2]                                   # doubling
    p[..., 3:4] = ec_lm.identity_plane(kind, (1,), 1, dev)  # O + Q
    assert torch.equal(K.padd(p, q, kind), K.padd_ref(p, q, kind))
    x = torch.cat([p, q], -1)
    for width in (x.shape[-1], 2):                          # down to h = 1
        assert torch.equal(K.fold_padd(x[..., :width].contiguous(), kind),
                           K.fold_padd_ref(x[..., :width], kind))
    pts = _pool(kind, rng)
    pts[1] = None
    a = torch.as_tensor(ec_affine.affine_table(pts, kind).T[None],
                        device=dev)
    a = torch.cat([a, a.flip(-1)], -1)
    assert torch.equal(K.fold_padd_aa(a, kind), K.fold_padd_aa_ref(a, kind))
