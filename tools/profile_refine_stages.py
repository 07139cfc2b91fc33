"""Cost of the three per-frame epipolar traces and the non-KF refinement.

At the bench operating point (1216x352, trace_cap 5120), on a steady-state
window (frame 30 of the bench's corridor sequence 0):

- standalone jits of the three traces the non-KF frame runs: the temporal
  trace over the compact pool, then stereo L->R and R->L over the GOOD
  half-pool (immature.trace_on_nonkey);
- cumulative prefixes of immature.trace_on_nonkey (keep in sync):
  compact | temporal trace | project+extract(new) | stereo L->R |
  extract(right)+stereo R->L | reproject+scatter;
- the whole non-KF frame program (graph_system.frame_track), so the traces'
  share of the non-KF frame is their sum over it.

Every time is the host clock around N_REPS dispatches of one jitted
program, each ended by block_until_ready.

Run: python tools/profile_refine_stages.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_REPS = 5


def main():
    import jax
    import jax.numpy as jnp

    from stereo_dso_g2o_tpu.runtime import compile_cache

    jax.config.update("jax_default_matmul_precision", "highest")
    compile_cache.enable()

    import bench
    from stereo_dso_g2o_tpu.frontend import immature as IMM
    from stereo_dso_g2o_tpu.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu.frontend.graph_system import GraphSystem, _rigid_inv
    from stereo_dso_g2o_tpu.models.camera import make_calib
    from stereo_dso_g2o_tpu.ops import trace as trace_ops
    from stereo_dso_g2o_tpu.ops.pyramid import build_pyramid

    from stereo_dso_g2o_tpu.frontend.graph_system import frame_track

    settings = bench.bench_settings()
    K, lefts, rights, _ = bench.render_sequence(0, 32)
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], bench.BASE,
                       bench.W_, bench.H_, n_levels=6)

    fs = FullSystem(calib, settings)
    for i in range(bench.BOOT):
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs = GraphSystem.from_full_system(fs)
    for i in range(bench.BOOT, 30):
        gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs.flush()
    state = gs.state
    s = settings
    win = state.win
    imm = state.imm
    n_live = int(np.asarray(jax.device_get(jnp.sum(imm.valid))))

    # per-host transforms exactly as frame_step._nonkey_refine builds them
    dI_new0, _ = build_pyramid(jnp.asarray(lefts[30]).astype(jnp.float32), 1)
    dI_new = dI_new0[0]
    dI_right = build_pyramid(
        jnp.asarray(rights[30]).astype(jnp.float32), 1
    )[0][0]
    Km = calib.K(0)
    Ki = calib.Ki(0)
    w2c = np.asarray(jax.device_get(win.w2c()))
    T_new = w2c[int(jax.device_get(state.ref_slot))]  # approx: new ~ ref
    T_hn = jnp.einsum("ij,fjk->fik", jnp.asarray(T_new),
                      jnp.linalg.inv(jnp.asarray(w2c)))
    R_hn = T_hn[:, :3, :3]
    t_hn = T_hn[:, :3, 3]
    KRKi = jnp.einsum("ij,fjk,kl->fil", Km, R_hn, Ki)
    Kt = jnp.einsum("ij,fj->fi", Km, t_hn)
    aff_ht = jnp.zeros((win.F, 2)).at[:, 0].set(1.0)
    host_valid = win.frame_valid
    baseline = calib.baseline
    Hd, Wd = dI_new.shape[:2]

    def prefix(upto):
        def run(imm, dI_new, dI_right):
            flat, sel = IMM._compact_live(imm, host_valid, s)
            host = flat["host"]
            if upto == 1:
                return flat["u"], sel
            traced = trace_ops.trace_batch(
                flat["u"], flat["v"], flat["idepth_min"], flat["idepth_max"],
                flat["color"], flat["weights"], flat["gradH"],
                flat["energy_th"], flat["quality"], flat["status"],
                KRKi[host], Kt[host], aff_ht[host], dI_new,
                settings=s,
            )
            if upto == 2:
                return traced
            good = flat["sel_ok"] & (traced.status == trace_ops.IPS_GOOD)
            u2 = jnp.clip(traced.last_uv[:, 0], 8.0, Wd - 9.0)
            v2 = jnp.clip(traced.last_uv[:, 1], 8.0, Hd - 9.0)
            ones = jnp.ones_like(u2)
            P = jnp.stack([flat["u"], flat["v"], ones], -1)
            ptp_min = (
                jnp.einsum("nij,nj->ni", KRKi[host],
                           P / traced.idepth_min[:, None]) + Kt[host]
            )
            id_min_proj = 1.0 / ptp_min[:, 2]
            ptp_max = (
                jnp.einsum("nij,nj->ni", KRKi[host],
                           P / traced.idepth_max[:, None]) + Kt[host]
            )
            id_max_proj = 1.0 / ptp_max[:, 2]
            color2, weights2, gradH2, eth2 = trace_ops.extract_point_data(
                dI_new, u2, v2, s
            )
            if upto == 3:
                return color2, id_min_proj, id_max_proj
            n = u2.shape[0]
            fresh_q = jnp.full((n,), 10000.0)
            fresh_st = jnp.full((n,), trace_ops.IPS_UNINITIALIZED, jnp.int32)
            res_lr, idepth_stereo = trace_ops.trace_stereo(
                u2, v2, id_min_proj, id_max_proj, color2, weights2, gradH2,
                eth2, fresh_q, fresh_st, Km, baseline, dI_right,
                mode_right=True, settings=s,
            )
            if upto == 4:
                return res_lr
            u3 = jnp.clip(res_lr.last_uv[:, 0], 8.0, Wd - 9.0)
            v3 = jnp.clip(res_lr.last_uv[:, 1], 8.0, Hd - 9.0)
            color3, weights3, gradH3, eth3 = trace_ops.extract_point_data(
                dI_right, u3, v3, s
            )
            res_rl, _ = trace_ops.trace_stereo(
                u3, v3, id_min_proj, id_max_proj, color3, weights3, gradH3,
                eth3, jnp.full((n,), 10000.0),
                jnp.full((n,), trace_ops.IPS_UNINITIALIZED, jnp.int32),
                Km, baseline, dI_new, mode_right=False, settings=s,
            )
            if upto == 5:
                return res_rl
            return IMM.trace_on_nonkey(
                imm, KRKi, Kt, R_hn, t_hn, aff_ht, dI_new, dI_right, Km,
                baseline, host_valid, settings=s,
            )

        return jax.jit(run)

    names = [
        (1, "compact"),
        (2, "temporal_trace"),
        (3, "project_extract_new"),
        (4, "stereo_lr"),
        (5, "extract_stereo_rl"),
        (6, "full_refine"),
    ]
    # status mix of the live rows: OOB rows no-op inside trace_batch but
    # still occupy kernel lanes — a large OOB fraction would argue for
    # excluding them from the compact pool
    st_live = np.asarray(jax.device_get(imm.status))[
        np.asarray(jax.device_get(imm.valid & host_valid[:, None]))
    ]
    hist = {
        name: int((st_live == code).sum())
        for name, code in [
            ("good", trace_ops.IPS_GOOD), ("oob", trace_ops.IPS_OOB),
            ("outlier", trace_ops.IPS_OUTLIER),
            ("skipped", trace_ops.IPS_SKIPPED),
            ("badcond", trace_ops.IPS_BADCONDITION),
            ("uninit", trace_ops.IPS_UNINITIALIZED),
        ]
    }
    def timed(fn, *args):
        jax.block_until_ready(fn(*args))  # compile + warm
        t0 = time.perf_counter()
        for _ in range(N_REPS):
            jax.block_until_ready(fn(*args))
        return (time.perf_counter() - t0) / N_REPS * 1e3

    dev = jax.devices()[0]
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "n_live_immature": n_live, "trace_cap": s.trace_cap,
           "status_hist": hist}

    # ---- the three traces as standalone jits, on the inputs the
    # refinement builds for them (GOOD half-pool for the stereo pair) ----
    flat, _ = jax.jit(lambda im: IMM._compact_live(im, host_valid, s))(imm)
    host = flat["host"]
    t_args = (flat["u"], flat["v"], flat["idepth_min"], flat["idepth_max"],
              flat["color"], flat["weights"], flat["gradH"],
              flat["energy_th"], flat["quality"], flat["status"],
              KRKi[host], Kt[host], aff_ht[host], dI_new)
    temporal = jax.jit(lambda *a: trace_ops.trace_batch(*a, settings=s))
    traced = temporal(*t_args)
    NS = max(min(s.trace_cap, s.trace_cap // 2), 1)
    gidx = jnp.nonzero(traced.status == trace_ops.IPS_GOOD, size=NS,
                       fill_value=0)[0]
    u2 = jnp.clip(traced.last_uv[gidx, 0], 8.0, Wd - 9.0)
    v2 = jnp.clip(traced.last_uv[gidx, 1], 8.0, Hd - 9.0)
    c2, w2, g2, e2 = trace_ops.extract_point_data(dI_new, u2, v2, s)
    fresh = (jnp.zeros((NS,), jnp.float32), jnp.full((NS,), jnp.nan),
             c2, w2, g2, e2, jnp.full((NS,), 10000.0),
             jnp.full((NS,), trace_ops.IPS_UNINITIALIZED, jnp.int32))

    def stereo(mode_right):
        return jax.jit(lambda *a: trace_ops.trace_stereo(
            *a, mode_right=mode_right, settings=s))

    S_steps = int(np.ceil((Wd + Hd) * s.max_pix_search)) + 3
    trace_ms = {
        "trace_temporal": timed(temporal, *t_args),
        "trace_stereo_lr": timed(stereo(True), u2, v2, *fresh, Km, baseline,
                                 dI_right),
        "trace_stereo_rl": timed(stereo(False), u2, v2, *fresh, Km, baseline,
                                 dI_new),
    }
    out.update({f"{k}_ms": round(v, 4) for k, v in trace_ms.items()})
    out["trace_lanes"] = {"temporal": int(flat["u"].shape[0]), "stereo": NS,
                          "steps": S_steps}

    # ---- the whole non-KF frame program ----
    i_frame = 30
    frame_ms = timed(
        lambda st, l, r: frame_track(
            st, l, r, calib.c, calib.baseline, jnp.float32(1.0),
            settings=s, n_levels=calib.n_levels, n_tries=5,
            w0=calib.w[0], h0=calib.h[0],
        ),
        state, jnp.asarray(lefts[i_frame]), jnp.asarray(rights[i_frame]),
    )
    out["nonkf_frame_ms"] = round(frame_ms, 4)
    out["traces_share_of_nonkf_frame"] = round(
        sum(trace_ms.values()) / frame_ms, 4
    )
    print(json.dumps(out), flush=True)

    cums = {}
    for upto, name in names:
        cums[name] = timed(prefix(upto), imm, dI_new, dI_right)
        print(json.dumps({"progress": name, "cum_ms": round(cums[name], 4)}),
              flush=True)
    prev = 0.0
    for upto, name in names:
        out[f"stage_{name}_ms"] = round(cums[name] - prev, 4)
        prev = cums[name]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
