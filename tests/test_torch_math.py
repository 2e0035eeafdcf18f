"""Parity of `garden_tpu_torch.core.math3d` and `systems.camera` with the
JAX package on random inputs made with numpy from a seed.

Tolerance: 1e-5 absolute and relative. Both sides compute in float32; the
JAX einsums and the matrix inverse sum in another order than PyTorch's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garden_tpu.core import math3d as jm
from garden_tpu.systems import camera as jcam
from garden_tpu_torch.core import math3d as tm
from garden_tpu_torch.systems import camera as tcam

RNG = np.random.default_rng(0)
N = 64


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


V3 = RNG.normal(size=(N, 3)).astype(np.float32)
W3 = RNG.normal(size=(N, 3)).astype(np.float32)
Q = _unit(RNG.normal(size=(N, 4)))
Q2 = _unit(RNG.normal(size=(N, 4)))
M4 = (RNG.normal(size=(4, 4)) + 3 * np.eye(4)).astype(np.float32)
MN = (RNG.normal(size=(N, 4, 4)) + 3 * np.eye(4)).astype(np.float32)
SCALE = RNG.uniform(0.5, 2.0, (N, 3)).astype(np.float32)
RGB = RNG.uniform(0.0, 4.0, (N, 3)).astype(np.float32)
LO = RNG.uniform(-1, 0, (N, 3)).astype(np.float32)
HI = LO + RNG.uniform(0.1, 2, (N, 3)).astype(np.float32)
VIEW = np.asarray(jm.look_at(jnp.array([3.0, 4.0, 9.0]), jnp.zeros(3),
                             jnp.array([0.0, 1.0, 0.0])))
PROJ = np.asarray(jm.perspective_reverse_z(1.0, 16 / 9, 0.1))
VP = (PROJ @ VIEW).astype(np.float32)

CASES = {
    "dot": lambda m: m.dot(V3, W3),
    "length": lambda m: m.length(V3),
    "normalize": lambda m: m.normalize(V3),
    "cross": lambda m: m.cross(V3, W3),
    "reflect": lambda m: m.reflect(V3, _unit(W3)),
    "quat_mul": lambda m: m.quat_mul(Q, Q2),
    "quat_normalize": lambda m: m.quat_normalize(Q * 3.0),
    "quat_rotate": lambda m: m.quat_rotate(Q, V3),
    "quat_to_mat3": lambda m: m.quat_to_mat3(Q),
    "quat_integrate": lambda m: m.quat_integrate(Q, V3, 1.0 / 60.0),
    "compose_trs": lambda m: m.compose_trs(V3, Q, SCALE),
    "apply_mat4": lambda m: m.apply_mat4(M4, V3),
    "apply_mat4_dir": lambda m: m.apply_mat4(M4, V3, 0.0),
    "apply_mat4_batched": lambda m: m.apply_mat4(MN, V3),
    "apply_mat4_h": lambda m: m.apply_mat4_h(M4, V3),
    "apply_mat4_h_batched": lambda m: m.apply_mat4_h(MN, V3),
    "matmul": lambda m: m.matmul(MN, MN),
    "mat4_inverse": lambda m: m.mat4_inverse(MN),
    "look_at": lambda m: m.look_at(V3 * 5.0, W3, np.tile([0.0, 1.0, 0.0], (N, 1))
                                   .astype(np.float32)),
    "aabb_transform": lambda m: m.aabb_transform(LO, HI, V3, Q),
    "frustum_planes": lambda m: m.frustum_planes(VP),
    "aabb_outside_frustum": lambda m: m.aabb_outside_frustum(
        m.frustum_planes(VP), LO * 20.0, HI * 20.0 + 5.0),
    "linear_to_srgb": lambda m: m.linear_to_srgb(RGB - 0.5),
    "luminance": lambda m: m.luminance(RGB),
}


def _as(mod, x):
    if mod is tm:
        return torch.as_tensor(x) if isinstance(x, np.ndarray) else x
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


class _Wrap:
    """Call the module's function with every numpy argument converted."""

    def __init__(self, mod):
        self.mod = mod

    def __getattr__(self, name):
        fn = getattr(self.mod, name)
        return lambda *a: fn(*[_as(self.mod, x) for x in a])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_math_matches(name):
    j = _np(CASES[name](_Wrap(jm)))
    t = _np(CASES[name](_Wrap(tm)))
    assert j.shape == t.shape and j.dtype == t.dtype
    if j.dtype == bool:
        np.testing.assert_array_equal(j, t)
        return
    np.testing.assert_allclose(j, t, rtol=1e-5, atol=1e-5)


def test_perspective_matches():
    t = tm.perspective_reverse_z(1.0, 16 / 9, 0.1, device="cpu")
    np.testing.assert_array_equal(PROJ, t.numpy())


def test_common_constants_match():
    eye = np.array([0.0, 7.0, 12.0], np.float32)
    light = np.array([0.4, -0.7, -0.5], np.float32)
    view = np.asarray(jm.look_at(jnp.asarray(eye), jnp.zeros(3),
                                 jnp.array([0.0, 1.0, 0.0])))
    j = jcam.common_constants(jnp.asarray(eye), jnp.asarray(view),
                              jnp.asarray(PROJ), jnp.asarray(light),
                              (256, 128), 0.0, 1.0 / 60.0)
    t = tcam.common_constants(torch.as_tensor(eye), torch.as_tensor(view),
                              torch.as_tensor(PROJ), torch.as_tensor(light),
                              (256, 128), 0.0, 1.0 / 60.0)
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_allclose(np.asarray(j[k]), t[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
