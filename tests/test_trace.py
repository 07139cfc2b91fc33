import jax.numpy as jnp
import numpy as np
import pytest

from stereo_dso_g2o_tpu.config import PATTERN, default_settings
from stereo_dso_g2o_tpu.io import synthetic
from stereo_dso_g2o_tpu.ops import trace as trace_ops
from stereo_dso_g2o_tpu.ops.pyramid import build_pyramid

SET = default_settings()


def _setup(seed=0, w=256, h=128, b=0.15):
    scene = synthetic.default_scene(seed)
    K = synthetic.default_K(w, h)
    left, right, idepth = synthetic.render_stereo_pair(scene, K, w, h, b)
    dIpL, _ = build_pyramid(jnp.asarray(left), 4)
    dIpR, _ = build_pyramid(jnp.asarray(right), 4)
    return K, left, right, idepth, dIpL, dIpR, b


def _grid_points(w, h, margin=20, step=9):
    ys, xs = np.mgrid[margin : h - margin : step, margin : w - margin : step]
    return xs.ravel().astype(np.float32), ys.ravel().astype(np.float32)


def test_trace_stereo_recovers_disparity():
    K, left, right, idepth, dIpL, dIpR, b = _setup()
    w, h = left.shape[1], left.shape[0]
    us, vs = _grid_points(w, h)
    n = len(us)

    color, weights, gradH, eth = trace_ops.extract_point_data(
        dIpL[0], jnp.asarray(us), jnp.asarray(vs), SET
    )
    res, idepth_stereo = trace_ops.trace_stereo(
        jnp.asarray(us),
        jnp.asarray(vs),
        jnp.zeros(n, jnp.float32),
        jnp.full(n, jnp.nan, jnp.float32),
        color,
        weights,
        gradH,
        eth,
        jnp.full(n, 10000.0, jnp.float32),
        jnp.full(n, trace_ops.IPS_UNINITIALIZED, jnp.int32),
        jnp.asarray(K, dtype=jnp.float32),
        jnp.float32(b),
        dIpR[0],
        mode_right=True,
        settings=SET,
    )
    st = np.asarray(res.status)
    good = st == trace_ops.IPS_GOOD
    # most grid points on a textured plane should match
    assert good.mean() > 0.5, f"only {good.mean():.2%} good"

    gt = idepth[vs.astype(int), us.astype(int)]
    est = np.asarray(idepth_stereo)
    err = np.abs(est[good] - gt[good])
    # idepth error bound: errorInPixel pixels of disparity -> err/bf
    bf = K[0, 0] * b
    bound = np.asarray(res.pixel_interval)[good] / bf + 2e-3
    frac_in_bound = (err < bound).mean()
    assert np.median(err) < 0.01, np.median(err)
    assert frac_in_bound > 0.9, frac_in_bound

    # interval must bracket the estimate
    lo = np.asarray(res.idepth_min)[good]
    hi = np.asarray(res.idepth_max)[good]
    assert (lo <= hi).all()


def test_trace_oob_status():
    """Points whose epipolar projection leaves the image go OOB."""
    K, left, right, idepth, dIpL, dIpR, b = _setup()
    us = jnp.asarray([5.0])  # too close to the border (uMin > 4 fails after shift)
    vs = jnp.asarray([5.0])
    color, weights, gradH, eth = trace_ops.extract_point_data(dIpL[0], us, vs, SET)
    res, _ = trace_ops.trace_stereo(
        us, vs, jnp.zeros(1), jnp.full(1, jnp.nan), color, weights, gradH, eth,
        jnp.full(1, 10000.0), jnp.full(1, trace_ops.IPS_UNINITIALIZED, jnp.int32),
        jnp.asarray(K, dtype=jnp.float32), jnp.float32(b), dIpR[0],
        mode_right=True, settings=SET,
    )
    # tracing right with positive disparity moves left: u=5 - disp < 4 at the
    # far end of the search, so either OOB or (rarely) OUTLIER — never GOOD
    # with a wildly wrong idepth. Accept OOB as the expected dominant outcome.
    assert int(res.status[0]) in (trace_ops.IPS_OOB, trace_ops.IPS_OUTLIER)


def test_trace_frozen_oob_stays_oob():
    K, left, right, idepth, dIpL, dIpR, b = _setup()
    us = jnp.asarray([100.0])
    vs = jnp.asarray([60.0])
    color, weights, gradH, eth = trace_ops.extract_point_data(dIpL[0], us, vs, SET)
    res, _ = trace_ops.trace_stereo(
        us, vs, jnp.zeros(1), jnp.full(1, jnp.nan), color, weights, gradH, eth,
        jnp.full(1, 10000.0), jnp.full(1, trace_ops.IPS_OOB, jnp.int32),
        jnp.asarray(K, dtype=jnp.float32), jnp.float32(b), dIpR[0],
        mode_right=True, settings=SET,
    )
    assert int(res.status[0]) == trace_ops.IPS_OOB


def test_trace_temporal_identity():
    """Tracing a frame against itself with identity motion: the epipolar
    segment collapses; with a tight interval the trace reports SKIPPED."""
    K, left, right, idepth, dIpL, dIpR, b = _setup()
    w, h = left.shape[1], left.shape[0]
    us, vs = _grid_points(w, h, margin=30, step=17)
    n = len(us)
    gt = idepth[vs.astype(int), us.astype(int)]
    color, weights, gradH, eth = trace_ops.extract_point_data(
        dIpL[0], jnp.asarray(us), jnp.asarray(vs), SET
    )
    KRKi = jnp.eye(3, dtype=jnp.float32)  # identity motion: K R K^-1 = I
    Kt = jnp.zeros(3, dtype=jnp.float32)
    res = trace_ops.trace(
        jnp.asarray(us), jnp.asarray(vs),
        jnp.asarray(gt * 0.95), jnp.asarray(gt * 1.05),
        color, weights, gradH, eth,
        jnp.full(n, 10000.0, jnp.float32),
        jnp.full(n, trace_ops.IPS_UNINITIALIZED, jnp.int32),
        KRKi, Kt, jnp.asarray([1.0, 0.0], dtype=jnp.float32), dIpL[0],
        settings=SET,
    )
    st = np.asarray(res.status)
    assert (st == trace_ops.IPS_SKIPPED).mean() > 0.95, st


def test_trace_temporal_translation():
    """Temporal trace under a known forward+lateral motion recovers idepth."""
    scene = synthetic.default_scene(5)
    w, h, b = 256, 128, 0.15
    K = synthetic.default_K(w, h)
    left0, _, idepth0 = synthetic.render_stereo_pair(scene, K, w, h, b)
    T = np.eye(4)
    T[:3, 3] = [0.15, 0.05, 0.1]  # host -> target camera motion
    left1, _ = synthetic.render(scene, K, w, h, T)

    dIp0, _ = build_pyramid(jnp.asarray(left0), 4)
    dIp1, _ = build_pyramid(jnp.asarray(left1), 4)

    us, vs = _grid_points(w, h, margin=25, step=11)
    n = len(us)
    gt = idepth0[vs.astype(int), us.astype(int)]

    color, weights, gradH, eth = trace_ops.extract_point_data(
        dIp0[0], jnp.asarray(us), jnp.asarray(vs), SET
    )
    Kj = jnp.asarray(K, dtype=jnp.float32)
    R = jnp.asarray(T[:3, :3], dtype=jnp.float32)
    t = jnp.asarray(T[:3, 3], dtype=jnp.float32)
    KRKi = Kj @ R @ jnp.linalg.inv(Kj)
    Kt = Kj @ t
    res = trace_ops.trace(
        jnp.asarray(us), jnp.asarray(vs),
        jnp.zeros(n, jnp.float32), jnp.full(n, jnp.nan, jnp.float32),
        color, weights, gradH, eth,
        jnp.full(n, 10000.0, jnp.float32),
        jnp.full(n, trace_ops.IPS_UNINITIALIZED, jnp.int32),
        KRKi, Kt, jnp.asarray([1.0, 0.0], dtype=jnp.float32), dIp1[0],
        settings=SET,
    )
    st = np.asarray(res.status)
    good = st == trace_ops.IPS_GOOD
    assert good.mean() > 0.4, good.mean()
    lo = np.asarray(res.idepth_min)[good]
    hi = np.asarray(res.idepth_max)[good]
    mid = 0.5 * (lo + hi)
    err = np.abs(mid - gt[good]) / gt[good]
    assert np.median(err) < 0.05, np.median(err)


def test_trace_compaction_overflow_keeps_rows():
    """When live rows exceed trace_cap, overflow rows must keep their state
    (no corruption) while in-budget rows trace normally."""
    import dataclasses as _dc

    from stereo_dso_g2o_tpu.frontend import immature as IMM

    scene = synthetic.default_scene(5)
    w, h = 192, 96
    K = synthetic.default_K(w, h)
    left0, _, idepth0 = synthetic.render_stereo_pair(scene, K, w, h, 0.2)
    T = np.eye(4)
    T[:3, 3] = [0.1, 0.02, 0.05]
    left1, _ = synthetic.render(scene, K, w, h, T)
    dIp0, _ = build_pyramid(jnp.asarray(left0), 3)
    dIp1, _ = build_pyramid(jnp.asarray(left1), 3)

    F, C = 2, 64
    imm = IMM.empty(F, C)
    us, vs = _grid_points(w, h, margin=20, step=6)
    assert len(us) >= F * C
    us, vs = us[: F * C], vs[: F * C]
    for f in range(F):
        seg = slice(f * C, (f + 1) * C)
        color, weights, gradH, eth = trace_ops.extract_point_data(
            dIp0[0], jnp.asarray(us[seg]), jnp.asarray(vs[seg]), SET
        )
        imm = imm.replace(
            valid=imm.valid.at[f].set(True),
            u=imm.u.at[f].set(jnp.asarray(us[seg])),
            v=imm.v.at[f].set(jnp.asarray(vs[seg])),
            color=imm.color.at[f].set(color),
            weights=imm.weights.at[f].set(weights),
            gradH=imm.gradH.at[f].set(gradH),
            energy_th=imm.energy_th.at[f].set(eth),
        )
    Kj = jnp.asarray(K, jnp.float32)
    KRKi = Kj @ jnp.asarray(T[:3, :3], jnp.float32) @ jnp.linalg.inv(Kj)
    Kt = Kj @ jnp.asarray(T[:3, 3], jnp.float32)
    KRKi_f = jnp.broadcast_to(KRKi, (F, 3, 3))
    Kt_f = jnp.broadcast_to(Kt, (F, 3))
    aff = jnp.broadcast_to(jnp.asarray([1.0, 0.0], jnp.float32), (F, 2))
    hv = jnp.ones((F,), bool)

    full = IMM.trace_on_frame(imm, KRKi_f, Kt_f, aff, dIp1[0], hv, SET)
    tight = _dc.replace(SET, trace_cap=96)  # < 128 live rows
    part = IMM.trace_on_frame(imm, KRKi_f, Kt_f, aff, dIp1[0], hv, tight)

    st_full = np.asarray(full.status).reshape(-1)
    st_part = np.asarray(part.status).reshape(-1)
    # first 96 live rows must match the untruncated result exactly
    assert (st_part[:96] == st_full[:96]).all()
    # overflow rows must be untouched (still UNINITIALIZED, intervals intact)
    assert (st_part[96:] == trace_ops.IPS_UNINITIALIZED).all()
    assert np.isnan(np.asarray(part.idepth_max).reshape(-1)[96:]).all()


# ---------------------------------------------------------------------------
# float64 NumPy reference of the discrete search + GN refinement


def _bilin64(img, x, y):
    """Bilinear sample with the engine's clamp (ops/interp.py), float64."""
    H, W = img.shape[:2]
    x = min(max(x, 0.0), W - 1.001)
    y = min(max(y, 0.0), H - 1.001)
    ix, iy = int(np.floor(x)), int(np.floor(y))
    fx, fy = x - ix, y - iy
    return ((1 - fx) * (1 - fy) * img[iy, ix] + fx * (1 - fy) * img[iy, ix + 1]
            + (1 - fx) * fy * img[iy + 1, ix] + fx * fy * img[iy + 1, ix + 1])


def _huber_energy(r, th):
    hw = 1.0 if abs(r) < th else th / abs(r)
    return hw, hw * r * r * (2.0 - hw)


def _ref_search_gn(dI, ptx, pty, dx, dy, num_steps, pat, color, weights,
                   aff, s):
    """One point's discrete epipolar search (Huber pattern energy, argmin,
    second best outside the test radius) and its 1-dof GN refinement
    (ImmaturePoint.cpp:610-769), as a plain loop in float64.

    Returns (best_u, best_v, best_energy, quality)."""
    a, b = aff
    energies = []
    for k in range(num_steps):
        e = 0.0
        for p in range(8):
            hit = _bilin64(dI[..., 0], ptx + k * dx + pat[p, 0],
                           pty + k * dy + pat[p, 1])
            e += _huber_energy(hit - (a * color[p] + b), s.huber_th)[1]
        energies.append(e)
    best = int(np.argmin(energies))
    outside = [e for k, e in enumerate(energies)
               if abs(k - best) > s.min_trace_test_radius]
    quality = min(outside, default=np.inf) / max(energies[best], 1e-20)

    bu, bv = ptx + best * dx, pty + best * dy
    u_bak, v_bak, step_back, best_e = bu, bv, 0.0, 1e5
    for _ in range(s.trace_gn_iterations):
        Hgn, bgn, energy = 1.0, 0.0, 0.0
        for p in range(8):
            hit = _bilin64(dI, bu + pat[p, 0], bv + pat[p, 1])
            r = hit[0] - (a * color[p] + b)
            d = dx * hit[1] + dy * hit[2]
            hw, e = _huber_energy(r, s.huber_th)
            Hgn += hw * d * d
            bgn += hw * r * d
            energy += weights[p] ** 2 * e
        if energy > best_e:  # worse: halve the step, retreat from backup
            step_back *= 0.5
            bu, bv = u_bak + step_back * dx, v_bak + step_back * dy
        else:  # better: clamped GN step from here
            step = float(np.clip(-bgn / Hgn, -0.5, 0.5))
            step = step if np.isfinite(step) else 0.0
            u_bak, v_bak = bu, bv
            bu, bv = bu + step * dx, bv + step * dy
            step_back, best_e = step, energy
        if abs(step_back) < s.trace_gn_threshold:
            break
    return bu, bv, best_e, quality


def _ref_segment(mode, u, v, Kt, w, h, s):
    """Search start, unit step and step count of a fresh point (interval
    [0, inf)) with identity KRKi (temporal) or a rectified pair (stereo)."""
    mps = (w + h) * s.max_pix_search
    if mode == "temporal":
        ud = (u + Kt[0] * 0.01) / (1.0 + Kt[2] * 0.01)
        vd = (v + Kt[1] * 0.01) / (1.0 + Kt[2] * 0.01)
        n = np.hypot(ud - u, vd - v)
        dx, dy = (ud - u) / n, (vd - v) / n
    else:
        dx, dy = (-1.0 if mode == "stereo_lr" else 1.0), 0.0
    S = min(s.trace_max_steps, int(np.ceil(mps / s.trace_stepsize)) + 3)
    num_steps = min(int(1.9999 + mps / s.trace_stepsize), S - 1)
    shift = u * 1000.0 - np.floor(u * 1000.0)
    return u - shift * dx, v - shift * dy, dx, dy, num_steps


@pytest.mark.parametrize("mode", ["temporal", "stereo_lr", "stereo_rl"])
def test_trace_matches_float64_reference(mode):
    """The XLA trace (search + GN) against a float64 NumPy loop on fresh
    points whose whole search stays inside the image. Coordinates are
    quarter pixels, so u*1000 is exact in f32 and both sides start the
    search at the same sub-pixel shift."""
    scene = synthetic.default_scene(5)
    w, h, b = 256, 128, 0.15
    K = synthetic.default_K(w, h)
    left0, right0, _ = synthetic.render_stereo_pair(scene, K, w, h, b)
    T = np.eye(4)
    T[:3, 3] = [0.15, 0.05, 0.1]
    left1, _ = synthetic.render(scene, K, w, h, T)

    def dI(img):
        return build_pyramid(jnp.asarray(img, jnp.float32), 1)[0][0]

    host, target = {
        "temporal": (left0, left1),
        "stereo_lr": (left0, right0),
        "stereo_rl": (right0, left0),
    }[mode]
    dI_h, dI_t = dI(host), dI(target)
    ys, xs = np.mgrid[24 : h - 24 : 5, 24 : w - 24 : 5]
    us = (xs.ravel() + 0.25 * (np.arange(xs.size) % 4)).astype(np.float32)
    vs = (ys.ravel() + 0.25 * (np.arange(ys.size) % 3)).astype(np.float32)
    n = us.size
    color, weights, gradH, eth = trace_ops.extract_point_data(
        dI_h, jnp.asarray(us), jnp.asarray(vs), SET
    )
    args = (
        jnp.asarray(us), jnp.asarray(vs),
        jnp.zeros(n, jnp.float32), jnp.full(n, jnp.nan, jnp.float32),
        color, weights, gradH, eth,
        jnp.full(n, 10000.0, jnp.float32),
        jnp.full(n, trace_ops.IPS_UNINITIALIZED, jnp.int32),
    )
    Kj = jnp.asarray(K, jnp.float32)
    Kt = np.asarray(Kj @ jnp.asarray(T[:3, 3], jnp.float32), np.float64)
    if mode == "temporal":
        res = trace_ops.trace(
            *args, jnp.eye(3, dtype=jnp.float32), jnp.asarray(Kt, jnp.float32),
            jnp.asarray([1.0, 0.0], jnp.float32), dI_t, settings=SET,
        )
    else:
        res, _ = trace_ops.trace_stereo(
            *args, Kj, jnp.float32(b), dI_t,
            mode_right=mode == "stereo_lr", settings=SET,
        )

    dI64 = np.asarray(dI_t, np.float64)
    color64 = np.asarray(color, np.float64)
    weights64 = np.asarray(weights, np.float64)
    good = np.flatnonzero(np.asarray(res.status) == trace_ops.IPS_GOOD)
    assert good.size > 0.3 * n, (good.size, n)
    last_uv = np.asarray(res.last_uv, np.float64)
    best_e = np.asarray(res.best_energy, np.float64)
    quality = np.asarray(res.quality, np.float64)
    agree = []
    for i in good:
        ptx, pty, dx, dy, ns = _ref_segment(mode, float(us[i]), float(vs[i]),
                                            Kt, w, h, SET)
        bu, bv, be, q = _ref_search_gn(
            dI64, ptx, pty, dx, dy, ns, PATTERN.astype(np.float64),
            color64[i], weights64[i], (1.0, 0.0), SET,
        )
        agree.append(
            abs(last_uv[i, 0] - bu) < 1e-3 and abs(last_uv[i, 1] - bv) < 1e-3
            and abs(best_e[i] - be) <= 1e-3 * max(be, 1.0)
            and (q == quality[i] or abs(q - quality[i]) <= 1e-3 * q)
        )
    # a discrete argmin may flip on a near-tie between f32 and f64 sums
    assert np.mean(agree) >= 0.98, np.mean(agree)


def test_insert_activated_writes_each_slot_once():
    """Accepted immature points land in free point slots, slot 0 included,
    and no other slot changes: every scatter index is unique (the GPU keeps
    an unspecified writer among duplicates)."""
    from stereo_dso_g2o_tpu.backend import window as W
    from stereo_dso_g2o_tpu.frontend import immature as IMM

    F, C, NP = 2, 8, 16
    win = W.empty_window(F, NP, [100.0, 100.0, 50.0, 30.0])
    # slots 1..5 hold active points; 0 and 6.. are free
    win = win.replace(pt_status=win.pt_status.at[1:6].set(W.PT_ACTIVE),
                      pt_u=win.pt_u.at[1:6].set(7.0))
    imm = IMM.empty(F, C)
    imm = imm.replace(
        valid=imm.valid.at[:, :3].set(True),
        u=jnp.broadcast_to(jnp.arange(C, dtype=jnp.float32) + 10.0, (F, C)),
    )
    accepted = jnp.zeros((F, C), bool).at[0, 1].set(True).at[1, 2].set(True)
    act = IMM.ActivationResult(
        idepth=jnp.full((F, C), 0.5, jnp.float32),
        accepted=accepted,
        dropped=jnp.zeros((F, C), bool),
        res_good=jnp.ones((F, C, F), bool),
    )
    win2, imm2, n = IMM.insert_activated(win, imm, act, max_insert=4)
    assert int(n) == 2
    st = np.asarray(win2.pt_status)
    assert st[0] == W.PT_ACTIVE and st[6] == W.PT_ACTIVE
    np.testing.assert_array_equal(np.asarray(win2.pt_u)[[0, 6]], [11.0, 12.0])
    np.testing.assert_array_equal(np.asarray(win2.pt_host)[[0, 6]], [0, 1])
    np.testing.assert_array_equal(st[7:], W.PT_INACTIVE)
    np.testing.assert_array_equal(np.asarray(win2.pt_u)[1:6], 7.0)
    valid = np.asarray(imm2.valid)
    assert not valid[0, 1] and not valid[1, 2]
    assert valid[0, 0] and valid[1, 0] and valid[0, 2]
