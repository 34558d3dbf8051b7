"""Batched clip sampling: all instances of a (skeleton, clip) in ONE jit.

The per-entity path (anim/player.py) walks entities in host Python with
numpy poses — parity-correct, but a scene with hundreds of skinned
entities serializes on the host while the chip waits (reference cost
model: ECS/Components/AnimationSystem.cpp:120-165 is a per-entity loop
too, but each iteration there is microseconds of C++).

This module bakes a clip's keyframe tracks into PADDED device tables once
(keyframe counts vary per bone; XLA needs static shapes) and evaluates all
N instance times in one call:

  times (N,) → track sample (N,B) lerp/slerp → local TRS matrices →
  hierarchy walk (lax.scan over topo order) → × inverse bind →
  (N,B,4,4) palettes.

AnimationSystem groups playing entities by (skeleton, clip) and uses this
path for every group; the state-machine path stays per-entity (its
transition logic is host-side by design). Parity with the per-entity
sampler is tested in tests/test_anim_batch.py.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from trident.anim.data import AnimationClip, Skeleton
from trident.anim.pose import Pose
from trident.mathx.quat import quat_normalize, quat_slerp, quat_to_mat3

_FAR = 1e30  # finite "+inf" pad keeps (t - t_lo) / (pad - t_lo) == 0 exact


def _pad_track(times: np.ndarray, values: np.ndarray, default: np.ndarray,
               kp: int) -> Tuple[np.ndarray, np.ndarray]:
    """(K,)/(K,C) → (kp,)/(kp,C): empty tracks become a constant `default`
    track; the tail pads with _FAR times + repeated last value so sampling
    at t ≥ last key lands exactly on the last real value."""
    k = len(times)
    c = values.shape[-1] if values.ndim > 1 else default.shape[-1]
    t_out = np.full(kp, _FAR, np.float32)
    v_out = np.zeros((kp, c), np.float32)
    if k == 0:
        t_out[0] = 0.0
        v_out[:] = default
    else:
        t_out[:k] = times
        v_out[:k] = values
        v_out[k:] = values[-1]
    return t_out, v_out


class BatchedClipSampler:
    """Bakes one (clip, skeleton) into padded device tables; evaluates all
    instance times in one jitted call. Build once per pair (cached by
    AnimationSystem); evaluation recompiles only when the instance-count
    bucket changes."""

    def __init__(self, clip: AnimationClip, skeleton: Skeleton) -> None:
        self.clip = clip
        self.skeleton = skeleton
        b = len(skeleton)
        bind = Pose.bind(skeleton)
        chans = clip.channel_for(skeleton)

        def kp_for(attr_times) -> int:
            m = max((len(attr_times(ch)) for ch in chans.values()),
                    default=1)
            return max(m, 2)  # ≥2 so the sampling window always exists

        kp_p = kp_for(lambda ch: ch.position_times)
        kp_r = kp_for(lambda ch: ch.rotation_times)
        kp_s = kp_for(lambda ch: ch.scale_times)

        pt = np.zeros((b, kp_p), np.float32)
        pv = np.zeros((b, kp_p, 3), np.float32)
        rt = np.zeros((b, kp_r), np.float32)
        rv = np.zeros((b, kp_r, 4), np.float32)
        st = np.zeros((b, kp_s), np.float32)
        sv = np.zeros((b, kp_s, 3), np.float32)
        for i in range(b):
            ch = chans.get(i)
            e = np.zeros(0, np.float32)
            pt[i], pv[i] = _pad_track(
                ch.position_times if ch else e, ch.positions if ch else e,
                bind.position[i], kp_p)
            rt[i], rv[i] = _pad_track(
                ch.rotation_times if ch else e, ch.rotations if ch else e,
                bind.rotation[i], kp_r)
            st[i], sv[i] = _pad_track(
                ch.scale_times if ch else e, ch.scales if ch else e,
                bind.scale[i], kp_s)

        topo = skeleton.topo_order()
        parents = [skeleton.bones[i].parent for i in topo]
        # palettes are consumed host-side (bone_matrices → draw params), so
        # the sampler runs on the CPU backend when one exists: a per-frame
        # device round-trip would cost more than it saves
        try:
            self._device = jax.devices("cpu")[0]
        except Exception:
            self._device = None
        tables = dict(
            pt=jnp.asarray(pt), pv=jnp.asarray(pv),
            rt=jnp.asarray(rt), rv=jnp.asarray(rv),
            st=jnp.asarray(st), sv=jnp.asarray(sv),
            topo=jnp.asarray(np.asarray(topo, np.int32)),
            parent=jnp.asarray(np.asarray(parents, np.int32)),
            inv_bind=jnp.asarray(np.stack(
                [bone.inverse_bind for bone in skeleton.bones])),
        )
        if self._device is not None:
            tables = jax.device_put(tables, self._device)
        self._tables = tables

    def __call__(self, times: np.ndarray) -> np.ndarray:
        """times: (N,) seconds, already wrapped to the clip duration
        (loop/clamp policy is per-entity host state) → (N,B,4,4) f32."""
        times = np.asarray(times, np.float32)
        # bucket N to powers of two so adding an instance doesn't retrace
        n = len(times)
        npad = max(1, 1 << (n - 1).bit_length())
        t_in = np.zeros(npad, np.float32)
        t_in[:n] = times
        # _sample_palettes_jit is MODULE-level: samplers with equal table/
        # bucket shapes (or an LRU-evicted sampler rebuilt later) share one
        # compiled executable instead of re-tracing per instance
        if self._device is not None:
            with jax.default_device(self._device):
                out = _sample_palettes_jit(self._tables, jnp.asarray(t_in))
        else:
            out = _sample_palettes_jit(self._tables, jnp.asarray(t_in))
        return np.asarray(out)[:n]


def _track(times_tab: jnp.ndarray, vals_tab: jnp.ndarray, t: jnp.ndarray):
    """times_tab (B,K), vals_tab (B,K,C), t (N,) → (v_lo, v_hi, f): the
    (N,B,C) bracketing values and the (N,B) lerp fraction (rotations need
    the raw pair for slerp, so the lerp itself happens at the caller)."""
    # hi: first key strictly after t, clamped into the padded window
    hi = jnp.clip(
        jax.vmap(lambda tt: jnp.searchsorted(tt, t, side="right"))(times_tab),
        1, times_tab.shape[1] - 1)                       # (B,N)
    hi = hi.T                                            # (N,B)
    lo = hi - 1
    bix = jnp.arange(times_tab.shape[0])[None, :]
    t_lo = times_tab[bix, lo]
    t_hi = times_tab[bix, hi]
    span = jnp.maximum(t_hi - t_lo, 1e-9)
    f = jnp.clip((t[:, None] - t_lo) / span, 0.0, 1.0)   # (N,B)
    v_lo = vals_tab[bix, lo]                             # (N,B,C)
    v_hi = vals_tab[bix, hi]
    return v_lo, v_hi, f


def _sample_palettes(tables: Dict[str, jnp.ndarray],
                     times: jnp.ndarray) -> jnp.ndarray:
    """(N,) wrapped times → (N,B,4,4) skinning palettes."""
    p_lo, p_hi, pf = _track(tables["pt"], tables["pv"], times)
    pos = p_lo + (p_hi - p_lo) * pf[..., None]
    s_lo, s_hi, sf = _track(tables["st"], tables["sv"], times)
    scl = s_lo + (s_hi - s_lo) * sf[..., None]
    r_lo, r_hi, rf = _track(tables["rt"], tables["rv"], times)
    rot = quat_slerp(r_lo, r_hi, rf)

    # local TRS matrices (N,B,4,4)
    n, b = pos.shape[:2]
    rot3 = quat_to_mat3(quat_normalize(rot))             # (N,B,3,3)
    local = jnp.zeros((n, b, 4, 4), jnp.float32)
    local = local.at[..., :3, :3].set(rot3 * scl[..., None, :])
    local = local.at[..., :3, 3].set(pos)
    local = local.at[..., 3, 3].set(1.0)

    # hierarchy walk local→global: scan over the topo order, gathering the
    # parent's already-written global matrix each step (parent < 0 = root)
    def step(global_m, idx_parent):
        idx, parent = idx_parent
        li = local[:, idx]                               # (N,4,4)
        gp = jnp.where(parent < 0,
                       jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32),
                                        li.shape),
                       global_m[:, jnp.maximum(parent, 0)])
        gi = jnp.matmul(gp, li, precision=jax.lax.Precision.HIGHEST)
        return global_m.at[:, idx].set(gi), None

    global_m = jnp.zeros_like(local)
    global_m, _ = jax.lax.scan(step, global_m,
                               (tables["topo"], tables["parent"]))
    return jnp.matmul(global_m, tables["inv_bind"][None],
                      precision=jax.lax.Precision.HIGHEST)


_sample_palettes_jit = jax.jit(_sample_palettes)
