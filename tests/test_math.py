"""Math conventions: TRS compose, projections, quaternions."""

import numpy as np

from trident.mathx import (
    compose_trs, decompose_trs, look_at, normal_matrix,
    perspective_rh_zo, ortho_rh_zo,
    quat_from_euler_deg, quat_mul, quat_slerp, quat_to_mat3, quat_identity,
)
from trident.mathx.transforms import euler_deg_to_mat3


def test_compose_identity():
    m = compose_trs([0, 0, 0], [0, 0, 0], [1, 1, 1])
    np.testing.assert_allclose(m, np.eye(4), atol=1e-6)


def test_compose_translation_rotation_order():
    # T*R*S: translation must be unaffected by rotation
    m = compose_trs([1, 2, 3], [0, 90, 0], [1, 1, 1])
    np.testing.assert_allclose(m[:3, 3], [1, 2, 3], atol=1e-6)
    # rotating (0,0,-1) by yaw +90° about Y gives (-1,0,0)
    p = m @ np.array([0, 0, -1, 1.0])
    np.testing.assert_allclose(p[:3], [1 - 1, 2, 3], atol=1e-5)


def test_compose_scale_then_rotate():
    m = compose_trs([0, 0, 0], [0, 0, 90], [2, 3, 1])
    # x axis scaled by 2 then rotated 90° about z → (0,2,0)
    p = m @ np.array([1, 0, 0, 1.0])
    np.testing.assert_allclose(p[:3], [0, 2, 0], atol=1e-5)


def test_decompose_roundtrip():
    t = np.array([1.5, -2.0, 3.0], np.float32)
    r = np.array([20.0, -40.0, 75.0], np.float32)
    s = np.array([2.0, 0.5, 1.5], np.float32)
    m = compose_trs(t, r, s)
    t2, r2, s2 = decompose_trs(m)
    np.testing.assert_allclose(t2, t, atol=1e-5)
    np.testing.assert_allclose(s2, s, atol=1e-5)
    m2 = compose_trs(t2, r2, s2)
    np.testing.assert_allclose(m2, m, atol=1e-4)


def test_perspective_rh_zo_depth_range():
    p = np.asarray(perspective_rh_zo(45.0, 16 / 9, 0.1, 100.0, flip_y=False))
    # near plane point (0,0,-near) → ndc z = 0
    near = p @ np.array([0, 0, -0.1, 1.0])
    assert abs(near[2] / near[3]) < 1e-6
    # far plane → ndc z = 1
    far = p @ np.array([0, 0, -100.0, 1.0])
    np.testing.assert_allclose(far[2] / far[3], 1.0, atol=1e-5)


def test_perspective_y_flip():
    p = np.asarray(perspective_rh_zo(90.0, 1.0, 0.1, 100.0))
    # world-up point must land at NEGATIVE ndc y (top of screen, y-down)
    up = p @ np.array([0, 1, -1, 1.0])
    assert up[1] / up[3] < 0


def test_look_at_forward():
    v = np.asarray(look_at([0, 0, 5], [0, 0, 0], [0, 1, 0]))
    # looking down -z: origin maps to (0,0,-5) in view space
    p = v @ np.array([0, 0, 0, 1.0])
    np.testing.assert_allclose(p[:3], [0, 0, -5], atol=1e-6)


def test_normal_matrix_nonuniform_scale():
    m = compose_trs([0, 0, 0], [0, 0, 0], [2, 1, 1])
    nm = np.asarray(normal_matrix(m))
    n = nm @ np.array([1, 0, 0], np.float32)
    n /= np.linalg.norm(n)
    np.testing.assert_allclose(n, [1, 0, 0], atol=1e-6)
    # a 45° slope normal under x-scale should tilt correctly
    slope = np.array([1, 1, 0], np.float32) / np.sqrt(2)
    out = nm @ slope
    out /= np.linalg.norm(out)
    expected = np.array([0.5, 1, 0])
    expected /= np.linalg.norm(expected)
    np.testing.assert_allclose(out, expected, atol=1e-6)


def test_quat_euler_matches_matrix():
    e = np.array([30.0, -45.0, 60.0], np.float32)
    q = quat_from_euler_deg(e)
    np.testing.assert_allclose(
        np.asarray(quat_to_mat3(q)), np.asarray(euler_deg_to_mat3(e)), atol=1e-5)


def test_quat_slerp_endpoints():
    a = quat_identity()
    b = quat_from_euler_deg(np.array([0.0, 90.0, 0.0], np.float32))
    np.testing.assert_allclose(np.asarray(quat_slerp(a, b, 0.0)), a, atol=1e-5)
    s1 = np.asarray(quat_slerp(a, b, 1.0))
    assert min(np.abs(s1 - np.asarray(b)).max(), np.abs(s1 + np.asarray(b)).max()) < 1e-5
    # halfway = 45° rotation
    half = quat_slerp(a, b, 0.5)
    expected = quat_from_euler_deg(np.array([0.0, 45.0, 0.0], np.float32))
    np.testing.assert_allclose(np.asarray(half), np.asarray(expected), atol=1e-5)


def test_quat_mul_composition():
    qa = quat_from_euler_deg(np.array([25.0, 0.0, 0.0], np.float32))
    qb = quat_from_euler_deg(np.array([0.0, 40.0, 0.0], np.float32))
    m = np.asarray(quat_to_mat3(quat_mul(qa, qb)))
    ma = np.asarray(quat_to_mat3(qa)) @ np.asarray(quat_to_mat3(qb))
    np.testing.assert_allclose(m, ma, atol=1e-5)
