"""Quaternion and spatial algebra: vnl_tpu_torch.math against vnl_tpu.math
(mirrors tests/test_math.py) on the same seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu import math as jmath
from vnl_tpu.math import spatial as jspatial
from vnl_tpu_torch import math as tmath


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _vecs(rng, n=64, d=3):
    return rng.normal(size=(n, d)).astype(np.float32)


CASES = {
    "quat_mul": (lambda r: (_quats(r), _quats(r)), 1e-6),
    "quat_conj": (lambda r: (_quats(r),), 1e-7),
    "quat_inv": (lambda r: (_quats(r),), 1e-6),
    "quat_rotate": (lambda r: (_quats(r), _vecs(r)), 1e-5),
    "quat_rotate_inv": (lambda r: (_quats(r), _vecs(r)), 1e-5),
    "quat_to_mat": (lambda r: (_quats(r),), 1e-6),
    "mat_to_quat": (lambda r: (np.asarray(jmath.quat_to_mat(
        jnp.asarray(_quats(r)))),), 1e-5),
    "axis_angle_to_quat": (lambda r: (
        _vecs(r) / np.linalg.norm(_vecs(r), axis=-1, keepdims=True),
        r.uniform(-3, 3, 64).astype(np.float32)), 1e-6),
    "quat_to_axis_angle": (lambda r: (_quats(r),), 2e-5),
    "quat_diff": (lambda r: (_quats(r), _quats(r)), 1e-6),
    "quat_integrate": (lambda r: (_quats(r), _vecs(r), 0.013), 1e-6),
    "euler_to_quat": (lambda r: (r.uniform(-1.5, 1.5, (16, 3)).astype(
        np.float32),), 1e-6),
    "bounded_quat_dist": (lambda r: (_quats(r), _quats(r)), 2e-4),
    "normalize": (lambda r: (_vecs(r, d=4),), 1e-6),
    "skew": (lambda r: (_vecs(r),), 0.0),
    "motion_cross": (lambda r: (_vecs(r, d=6), _vecs(r, d=6)), 1e-5),
    "force_cross": (lambda r: (_vecs(r, d=6), _vecs(r, d=6)), 1e-5),
    "transform_motion": (lambda r: (_vecs(r, d=6), _vecs(r)), 1e-5),
    "transform_force": (lambda r: (_vecs(r, d=6), _vecs(r)), 1e-5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    make, tol = CASES[name]
    args = make(np.random.default_rng(0))
    jfn = getattr(jmath, name, None) or getattr(jspatial, name)
    want = np.asarray(jfn(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    got = getattr(tmath, name)(
        *[torch.as_tensor(a.copy()) if isinstance(a, np.ndarray) else a
          for a in args]).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_inertia_at_point_matches_jax():
    rng = np.random.default_rng(1)
    mass = rng.uniform(0.1, 2.0, 16).astype(np.float32)
    inertia = rng.uniform(0.01, 0.1, (16, 3)).astype(np.float32)
    rot = np.asarray(jmath.quat_to_mat(jnp.asarray(_quats(rng, 16))))
    com, point = _vecs(rng, 16), _vecs(rng, 16)
    args = (mass, inertia, rot, com, point)
    want = np.asarray(jmath.inertia_at_point(*map(jnp.asarray, args)))
    got = tmath.inertia_at_point(*map(torch.tensor, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_spatial_inertia_against_pointmass():
    """Point mass m at com c about the origin (tests/test_math.py)."""
    c = torch.tensor([0.3, -0.2, 0.5])
    I6 = tmath.inertia_at_point(torch.tensor(2.0), torch.zeros(3),
                                torch.eye(3), c, torch.zeros(3)).numpy()
    c = c.numpy()
    np.testing.assert_allclose(
        I6[:3, :3], 2.0 * (np.dot(c, c) * np.eye(3) - np.outer(c, c)),
        atol=1e-6)
    np.testing.assert_allclose(I6[3:, 3:], 2.0 * np.eye(3), atol=1e-6)
