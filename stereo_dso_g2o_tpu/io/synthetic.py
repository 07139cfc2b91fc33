"""Synthetic stereo scene renderer (host-side, numpy).

The reference repo ships no tests and validates end-to-end on KITTI only
(SURVEY.md par. 4). We build the test pyramid the survey prescribes instead:
golden-value component tests against small synthetic scenes with exact
ground-truth depth and pose. This module renders textured 3-D planes through a
pinhole stereo rig — for a plane, the image-to-image mapping under any camera
motion is an exact homography, so rendered pairs have analytically known
disparity/idepth and zero photometric residual at the true pose.

Conventions match the engine: world-to-camera pose T_cw maps world points to
camera points X_c = R X_w + t; the right camera sits at +baseline along the
left camera's x-axis (so a left-image point at inverse depth id appears in the
right image at u_r = u_l - fx*baseline*id, cf. ImmaturePoint::traceStereo
Kt = K*(-baseline,0,0), ImmaturePoint.cpp:104-117).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


def smooth_texture(rng: np.random.Generator, size: int = 512, octaves: int = 5) -> np.ndarray:
    """Multi-octave smooth random texture in [20, 235] (float32, square)."""
    tex = np.zeros((size, size), dtype=np.float64)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        n = max(2, size >> (octaves - 1 - o))
        grid = rng.standard_normal((n, n))
        # bilinear upsample to full size
        yi = np.linspace(0, n - 1, size)
        xi = np.linspace(0, n - 1, size)
        y0 = np.floor(yi).astype(int)
        x0 = np.floor(xi).astype(int)
        y1 = np.minimum(y0 + 1, n - 1)
        x1 = np.minimum(x0 + 1, n - 1)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        up = (
            grid[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + grid[np.ix_(y0, x1)] * (1 - fy) * fx
            + grid[np.ix_(y1, x0)] * fy * (1 - fx)
            + grid[np.ix_(y1, x1)] * fy * fx
        )
        tex += amp * up
        total += amp
        amp *= 0.6
    tex /= total
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-12)
    return (20.0 + 215.0 * tex).astype(np.float32)


def _sample_tex(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear sample with wraparound (texture tiles infinitely)."""
    H, W = tex.shape
    u = np.mod(u, W)
    v = np.mod(v, H)
    x0 = np.floor(u).astype(int)
    y0 = np.floor(v).astype(int)
    fx = np.clip(u - x0, 0.0, 1.0)
    fy = np.clip(v - y0, 0.0, 1.0)
    # float mod of huge inputs can round to exactly W/H; re-wrap the integer
    x0 = np.mod(x0, W)
    y0 = np.mod(y0, H)
    x1 = (x0 + 1) % W
    y1 = (y0 + 1) % H
    return (
        tex[y0, x0] * (1 - fy) * (1 - fx)
        + tex[y0, x1] * (1 - fy) * fx
        + tex[y1, x0] * fy * (1 - fx)
        + tex[y1, x1] * fy * fx
    ).astype(np.float32)


@dataclasses.dataclass
class PlaneScene:
    """A textured plane n . X = dist in world coordinates."""

    normal: np.ndarray  # (3,) unit
    dist: float
    tex: np.ndarray  # (S, S) float32
    tex_scale: float = 20.0  # texels per world unit (~1 texel/pixel at 5m)
    e1: np.ndarray = None  # plane basis
    e2: np.ndarray = None

    def __post_init__(self):
        n = self.normal / np.linalg.norm(self.normal)
        self.normal = n
        a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        e1 = np.cross(n, a)
        self.e1 = e1 / np.linalg.norm(e1)
        self.e2 = np.cross(n, self.e1)


def default_scene(seed: int = 0) -> PlaneScene:
    """A plane tilted relative to the camera, ~5m away along +z."""
    rng = np.random.default_rng(seed)
    return PlaneScene(
        normal=np.array([0.15, -0.1, -1.0]),
        dist=-5.0,
        tex=smooth_texture(rng),
    )


@dataclasses.dataclass
class Rect:
    """A finite textured rectangle: points X with n.X = dist and
    |(X - origin).e1| <= ext1, |(X - origin).e2| <= ext2."""

    normal: np.ndarray  # (3,) plane normal (unit after init)
    dist: float  # plane offset: n . X = dist
    origin: np.ndarray  # (3,) rectangle center (must satisfy n.origin = dist)
    ext1: float  # half-extent along e1
    ext2: float  # half-extent along e2
    tex: np.ndarray  # (S, S) float32
    tex_scale: float = 20.0
    e1: np.ndarray = None
    e2: np.ndarray = None

    def __post_init__(self):
        n = self.normal / np.linalg.norm(self.normal)
        self.normal = n
        a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        e1 = np.cross(n, a)
        self.e1 = e1 / np.linalg.norm(e1)
        self.e2 = np.cross(n, self.e1)


@dataclasses.dataclass
class MultiScene:
    """A set of finite rectangles + an optional infinite backdrop plane.

    Ray-cast rendering (nearest hit per pixel) produces occlusion boundaries
    and depth discontinuities with exact ground-truth inverse depth — the
    adversarial structure a single plane cannot provide (depth edges are
    where direct SLAM breaks: ImmaturePoint trace ambiguity, BA outliers).
    """

    rects: List[Rect]
    backdrop: Optional[PlaneScene] = None


def box_scene(
    seed: int = 0,
    n_boxes: int = 6,
    depth_range: Tuple[float, float] = (8.0, 40.0),
    lateral: float = 12.0,
    ground: bool = True,
    backdrop_dist: float = 60.0,
) -> MultiScene:
    """A KITTI-flavoured street block: frontal box faces at staggered depths,
    side facades, a ground plane, and a far backdrop. All primitives textured
    independently (no cross-boundary texture continuity to help matching)."""
    rng = np.random.default_rng(seed)
    rects: List[Rect] = []
    zs = np.sort(rng.uniform(depth_range[0], depth_range[1], n_boxes))
    for i, z in enumerate(zs):
        # frontal face (normal -z) at depth z, offset laterally; kept off the
        # exact optical axis so forward motion reveals occluded background
        cx = rng.uniform(-lateral, lateral)
        cy = rng.uniform(-1.0, 1.5)
        half_w = rng.uniform(1.0, 3.5)
        half_h = rng.uniform(1.0, 2.5)
        rects.append(
            Rect(
                normal=np.array([rng.uniform(-0.15, 0.15), rng.uniform(-0.1, 0.1), -1.0]),
                dist=-z,
                origin=np.array([cx, cy, z]),
                ext1=half_w,
                ext2=half_h,
                tex=smooth_texture(rng, 256),
                tex_scale=rng.uniform(15.0, 40.0),
            )
        )
    # two side facades (normals +-x), like building walls along the street
    for sgn in (-1.0, 1.0):
        x = sgn * (lateral + 2.0)
        rects.append(
            Rect(
                normal=np.array([-sgn, 0.0, 0.0]),
                dist=-abs(x),  # n.X = -sgn*x on the wall
                origin=np.array([x, 0.0, depth_range[1] * 0.5]),
                ext1=depth_range[1],
                ext2=4.0,
                tex=smooth_texture(rng, 256),
                tex_scale=rng.uniform(10.0, 25.0),
            )
        )
    if ground:
        rects.append(
            Rect(
                normal=np.array([0.0, -1.0, 0.0]),
                dist=-1.65,  # camera height above ground, KITTI-like
                origin=np.array([0.0, 1.65, depth_range[1] * 0.5]),
                ext1=depth_range[1] * 1.5,
                ext2=lateral + 4.0,
                tex=smooth_texture(rng, 256),
                tex_scale=rng.uniform(8.0, 20.0),
            )
        )
    backdrop = PlaneScene(
        normal=np.array([0.02, -0.02, -1.0]),
        dist=-backdrop_dist,
        tex=smooth_texture(rng, 256),
        tex_scale=5.0,
    )
    return MultiScene(rects=rects, backdrop=backdrop)


def corridor_scene(
    seed: int = 0,
    length: float = 80.0,
    box_spacing: float = 9.0,
    lateral: float = 12.0,
    ground: bool = True,
    backdrop_margin: float = 30.0,
    clearance: float = 2.5,
) -> MultiScene:
    """A street corridor that stays populated along a FORWARD TRAJECTORY of
    up to `length` meters: box faces staggered every ~box_spacing meters over
    the whole corridor, side facades and ground running its full length, and
    a backdrop beyond the end. Use for multi-hundred-frame sequences where
    `box_scene`'s fixed depth band would be driven through (the camera must
    always see structure 5-40 m ahead).

    Boxes keep `clearance` meters of lateral margin off the z-axis so the
    camera never drives INTO a face: synthetic textures have no detail under
    extreme close-up magnification, so a face filling the screen at <1 m
    renders nearly gradient-free and starves the pixel selector (observed:
    selection yield 1800 -> 0 -> 1800 over 10 frames)."""
    rng = np.random.default_rng(seed)
    rects: List[Rect] = []
    z = 6.0
    while z < length + backdrop_margin * 0.5:
        half_w = rng.uniform(1.0, 3.5)
        half_h = rng.uniform(1.0, 2.5)
        side = rng.choice([-1.0, 1.0])
        cx = side * rng.uniform(clearance + half_w, max(lateral, clearance + half_w + 0.5))
        cy = rng.uniform(-1.0, 1.5)
        # Rect requires n.origin = dist; compute dist from the sampled normal
        nrm = np.array([rng.uniform(-0.15, 0.15), rng.uniform(-0.1, 0.1), -1.0])
        nrm = nrm / np.linalg.norm(nrm)
        origin = np.array([cx, cy, z])
        rects.append(
            Rect(
                normal=nrm,
                dist=float(nrm @ origin),
                origin=origin,
                ext1=half_w,
                ext2=half_h,
                tex=smooth_texture(rng, 256),
                tex_scale=rng.uniform(15.0, 40.0),
            )
        )
        z += rng.uniform(0.7, 1.3) * box_spacing
    full = length + backdrop_margin
    # side facades along the whole corridor
    for sgn in (-1.0, 1.0):
        x = sgn * (lateral + 2.0)
        rects.append(
            Rect(
                normal=np.array([-sgn, 0.0, 0.0]),
                dist=-abs(x),
                origin=np.array([x, 0.0, full * 0.5]),
                ext1=full * 0.6,
                ext2=4.0,
                tex=smooth_texture(rng, 512),
                tex_scale=rng.uniform(10.0, 25.0),
            )
        )
    if ground:
        rects.append(
            Rect(
                normal=np.array([0.0, -1.0, 0.0]),
                dist=-1.65,
                origin=np.array([0.0, 1.65, full * 0.5]),
                ext1=full * 0.7,
                ext2=lateral + 4.0,
                tex=smooth_texture(rng, 512),
                tex_scale=rng.uniform(8.0, 20.0),
            )
        )
    backdrop = PlaneScene(
        normal=np.array([0.02, -0.02, -1.0]),
        dist=-(length + backdrop_margin),
        tex=smooth_texture(rng, 256),
        tex_scale=5.0,
    )
    return MultiScene(rects=rects, backdrop=backdrop)


def render_multi(
    scene: MultiScene, K: np.ndarray, w: int, h: int, T_cw: np.ndarray,
    supersample: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast the rectangle set. Returns (image, idepth) with exact GT.

    `supersample` > 1 area-integrates each pixel over an NxN subpixel grid
    (like a real sensor). Point-sampled high-frequency texture aliases
    differently from every viewpoint, which acts as several gray levels of
    view-dependent photometric noise and directly biases direct tracking —
    measured as ~5 gray levels of irreducible tracking RMSE at 1 sample."""
    if supersample > 1:
        n = supersample
        acc = None
        idepth0 = None
        for a in range(n):
            for b in range(n):
                off = np.array(
                    [(b + 0.5) / n - 0.5, (a + 0.5) / n - 0.5, 0.0]
                )
                Ks = K.copy()
                Ks[:2, 2] = K[:2, 2] - off[:2]
                im, idep = render_multi(scene, Ks, w, h, T_cw, supersample=1)
                acc = im if acc is None else acc + im
                if a == b == (n - 1) // 2:
                    idepth0 = idep  # center-ish sample for exact GT depth
        return (acc / (n * n)).astype(np.float32), idepth0

    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    C = -R.T @ t
    Kinv = np.linalg.inv(K)
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    d_c = np.stack([us, vs, np.ones_like(us)], axis=-1) @ Kinv.T  # (h, w, 3)
    d_w = d_c @ R

    best_s = np.full((h, w), np.inf)
    img = np.zeros((h, w), np.float32)

    def consider(s, hit_img, mask):
        nonlocal best_s, img
        closer = mask & np.isfinite(s) & (s > 0.1) & (s < best_s)
        best_s = np.where(closer, s, best_s)
        img = np.where(closer, hit_img, img)

    if scene.backdrop is not None:
        b = scene.backdrop
        denom = d_w @ b.normal
        s = (b.dist - C @ b.normal) / np.where(np.abs(denom) < 1e-12, np.nan, denom)
        X_w = C[None, None, :] + s[..., None] * d_w
        u_t = (X_w @ b.e1) * b.tex_scale
        v_t = (X_w @ b.e2) * b.tex_scale
        hit = _sample_tex(b.tex, np.nan_to_num(u_t), np.nan_to_num(v_t))
        consider(s, hit, np.ones((h, w), bool))

    for r in scene.rects:
        denom = d_w @ r.normal
        s = (r.dist - C @ r.normal) / np.where(np.abs(denom) < 1e-12, np.nan, denom)
        X_w = C[None, None, :] + s[..., None] * d_w
        rel = X_w - r.origin[None, None, :]
        a1 = rel @ r.e1
        a2 = rel @ r.e2
        inside = (np.abs(a1) <= r.ext1) & (np.abs(a2) <= r.ext2)
        u_t = a1 * r.tex_scale
        v_t = a2 * r.tex_scale
        hit = _sample_tex(r.tex, np.nan_to_num(u_t), np.nan_to_num(v_t))
        consider(s, hit, inside)

    valid = np.isfinite(best_s)
    # depth along camera z equals s because d_c z-component is 1
    idepth = np.where(valid, 1.0 / np.where(valid, best_s, 1.0), 0.0).astype(np.float32)
    img = np.where(valid, img, 0.0).astype(np.float32)
    return img, idepth


# ---------------------------------------------------------------------------
# Fast JAX raycaster — same scene model as render_multi, but packed into
# arrays and executed as ONE jitted program (vmap over supersample offsets,
# rect intersections batched, argmin winner, single texture gather). The
# numpy path above stays as the independent reference implementation; the
# fast path is equivalence-tested against it (tests/test_synthetic.py).
# This exists because host-numpy rendering at KITTI res measured ~10 s per
# stereo pair, which made bench.py's cold start exceed the driver budget
# (VERDICT r3 item 1).
# ---------------------------------------------------------------------------


def _pack_scene(scene: MultiScene):
    """Pack a MultiScene into dense arrays for the JAX raycaster.

    The backdrop plane becomes one more "rect" with infinite extents. Textures
    of different sizes share one (R, Smax, Smax) buffer; per-rect tex_size
    keeps the tiling modulus exact (textures tile by their OWN size)."""
    prims = []
    for r in scene.rects:
        prims.append((r.normal, r.dist, r.origin, r.e1, r.e2, r.ext1, r.ext2,
                      r.tex, r.tex_scale))
    if scene.backdrop is not None:
        b = scene.backdrop
        # any point on the plane serves as origin for texture coords: the
        # numpy path uses u=(X.e1)*scale directly, i.e. origin = 0 projected;
        # keep EXACT parity by using origin=0 and inf extents
        prims.append((b.normal, b.dist, np.zeros(3), b.e1, b.e2,
                      np.inf, np.inf, b.tex, b.tex_scale))
    R = len(prims)
    smax = max(p[7].shape[0] for p in prims)
    pack = {
        "normal": np.zeros((R, 3), np.float32),
        "dist": np.zeros((R,), np.float32),
        "origin": np.zeros((R, 3), np.float32),
        "e1": np.zeros((R, 3), np.float32),
        "e2": np.zeros((R, 3), np.float32),
        "ext1": np.zeros((R,), np.float32),
        "ext2": np.zeros((R,), np.float32),
        "tex": np.zeros((R, smax, smax), np.float32),
        "tex_size": np.zeros((R,), np.int32),
        "tex_scale": np.zeros((R,), np.float32),
    }
    for i, (n, d, o, e1, e2, x1, x2, tex, ts) in enumerate(prims):
        s = tex.shape[0]
        pack["normal"][i] = n
        pack["dist"][i] = d
        pack["origin"][i] = o
        pack["e1"][i] = e1
        pack["e2"][i] = e2
        pack["ext1"][i] = x1
        pack["ext2"][i] = x2
        pack["tex"][i, :s, :s] = tex
        pack["tex_size"][i] = s
        pack["tex_scale"][i] = ts
    return pack


def _raycast_jax(pack, Kinv_ss, R_cw, t_cw, w, h, center_idx):
    """Traced core: returns (img (h,w) supersample-averaged, idepth (h,w)).

    Kinv_ss: (S2, 3, 3) inverse intrinsics, one per subpixel offset.
    Mirrors render_multi exactly: strict nearest hit with s > 0.1, texture
    tiling by per-rect size, bilinear wrap sampling; idepth from the
    center-ish supersample (index center_idx)."""
    import jax.numpy as jnp

    BIG = jnp.float32(1e30)
    C = -R_cw.T @ t_cw  # camera center in world
    us = jnp.arange(w, dtype=jnp.float32)
    vs = jnp.arange(h, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(us, vs)  # (h, w)
    p = jnp.stack([uu, vv, jnp.ones_like(uu)], axis=-1)  # (h, w, 3)
    # (S2, h, w, 3): rays in camera frame per supersample offset, then world
    d_c = jnp.einsum("hwk,skj->shwj", p, jnp.transpose(Kinv_ss, (0, 2, 1)))
    d_w = jnp.einsum("shwk,kj->shwj", d_c, R_cw)  # d_c @ R

    nrm = pack["normal"]  # (R, 3)
    # s-candidate per rect: (R, S2, h, w)
    denom = jnp.einsum("shwk,rk->rshw", d_w, nrm)
    num = (pack["dist"] - nrm @ C)[:, None, None, None]
    safe = jnp.abs(denom) >= 1e-12
    s_all = jnp.where(safe, num / jnp.where(safe, denom, 1.0), BIG)
    # inside test needs a1, a2 — compute from X = C + s*d_w per rect
    X = C[None, None, None, None, :] + s_all[..., None] * d_w[None]  # (R,S2,h,w,3)
    rel = X - pack["origin"][:, None, None, None, :]
    a1 = jnp.einsum("rshwk,rk->rshw", rel, pack["e1"])
    a2 = jnp.einsum("rshwk,rk->rshw", rel, pack["e2"])
    inside = (jnp.abs(a1) <= pack["ext1"][:, None, None, None]) & (
        jnp.abs(a2) <= pack["ext2"][:, None, None, None]
    )
    valid = inside & (s_all > 0.1) & (s_all < BIG)
    s_eff = jnp.where(valid, s_all, BIG)
    widx = jnp.argmin(s_eff, axis=0)  # (S2, h, w)
    s_win = jnp.take_along_axis(s_eff, widx[None], axis=0)[0]
    a1w = jnp.take_along_axis(a1, widx[None], axis=0)[0]
    a2w = jnp.take_along_axis(a2, widx[None], axis=0)[0]
    hit = s_win < BIG

    # texture sample: per-pixel winning rect, tiled bilinear wrap
    ts_scale = pack["tex_scale"][widx]  # (S2, h, w)
    tsize = pack["tex_size"][widx].astype(jnp.float32)
    ut = jnp.where(hit, a1w * ts_scale, 0.0)
    vt = jnp.where(hit, a2w * ts_scale, 0.0)
    ut = jnp.mod(ut, tsize)
    vt = jnp.mod(vt, tsize)
    x0f = jnp.floor(ut)
    y0f = jnp.floor(vt)
    fx = jnp.clip(ut - x0f, 0.0, 1.0)
    fy = jnp.clip(vt - y0f, 0.0, 1.0)
    tsize_i = pack["tex_size"][widx]
    x0 = jnp.mod(x0f.astype(jnp.int32), tsize_i)
    y0 = jnp.mod(y0f.astype(jnp.int32), tsize_i)
    x1 = jnp.mod(x0 + 1, tsize_i)
    y1 = jnp.mod(y0 + 1, tsize_i)
    tex = pack["tex"]  # (R, S, S)
    v00 = tex[widx, y0, x0]
    v01 = tex[widx, y0, x1]
    v10 = tex[widx, y1, x0]
    v11 = tex[widx, y1, x1]
    val = (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )
    img_ss = jnp.where(hit, val, 0.0)  # (S2, h, w)
    img = jnp.mean(img_ss, axis=0)
    idepth = jnp.where(hit[center_idx], 1.0 / s_win[center_idx], 0.0)
    return img.astype(jnp.float32), idepth.astype(jnp.float32)


_FAST_CACHE: dict = {}


def _get_fast_renderer(w: int, h: int, supersample: int):
    """Jitted (pack, Kinv_ss, poses (B,4,4)) -> (imgs (B,h,w), ideps (B,h,w));
    vmapped over a pose batch so a whole chunk renders in one dispatch."""
    key = (w, h, supersample)
    if key in _FAST_CACHE:
        return _FAST_CACHE[key]
    import functools

    import jax
    import jax.numpy as jnp

    n = supersample
    center_idx = ((n - 1) // 2) * n + (n - 1) // 2 if n > 1 else 0

    @functools.partial(jax.jit, static_argnames=())
    def run(pack, Kinv_ss, poses):
        def one(T):
            return _raycast_jax(pack, Kinv_ss, T[:3, :3], T[:3, 3], w, h,
                                center_idx)

        return jax.vmap(one)(poses.astype(jnp.float32))

    _FAST_CACHE[key] = run
    return run


def _supersample_kinvs(K: np.ndarray, supersample: int) -> np.ndarray:
    """Inverse intrinsics for the NxN subpixel offsets (same grid as
    render_multi's recursion: principal point shifted by -off)."""
    n = supersample
    kinvs = []
    if n <= 1:
        kinvs.append(np.linalg.inv(K))
    else:
        for a in range(n):
            for b in range(n):
                off = np.array([(b + 0.5) / n - 0.5, (a + 0.5) / n - 0.5])
                Ks = K.copy()
                Ks[:2, 2] = K[:2, 2] - off
                kinvs.append(np.linalg.inv(Ks))
    return np.stack(kinvs).astype(np.float32)


def _get_fast_seq_renderer(w: int, h: int, supersample: int):
    """Jitted (pack, Kinv_ss, poses (B,4,4), expos (B,)) -> uint8 (B,h,w):
    renders, applies exposure, clips and casts ON DEVICE so only ~h*w bytes
    per image cross the host link (8x less than the float32 img+idepth)."""
    key = ("seq", w, h, supersample)
    if key in _FAST_CACHE:
        return _FAST_CACHE[key]
    import jax
    import jax.numpy as jnp

    n = supersample
    center_idx = ((n - 1) // 2) * n + (n - 1) // 2 if n > 1 else 0

    @jax.jit
    def run(pack, Kinv_ss, poses, expos):
        def one(T):
            img, _ = _raycast_jax(pack, Kinv_ss, T[:3, :3], T[:3, 3], w, h,
                                  center_idx)
            return img

        imgs = jax.vmap(one)(poses.astype(jnp.float32))
        imgs = imgs * expos[:, None, None]
        return jnp.clip(imgs, 0.0, 255.0).astype(jnp.uint8)

    _FAST_CACHE[key] = run
    return run


def _device_pack(scene: MultiScene):
    """Scene pack as device arrays, cached on the scene object (the texture
    pack is ~15 MB — re-uploading it per chunk dominated transfer time)."""
    cached = getattr(scene, "_jax_pack", None)
    if cached is not None:
        return cached
    import jax.numpy as jnp

    pack = {k: jnp.asarray(v) for k, v in _pack_scene(scene).items()}
    object.__setattr__(scene, "_jax_pack", pack)
    return pack


def render_multi_fast(
    scene: MultiScene, K: np.ndarray, w: int, h: int, T_cw: np.ndarray,
    supersample: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """JAX drop-in for render_multi (one pose). Same outputs."""
    imgs, ideps = render_multi_batch(scene, K, w, h,
                                     np.asarray(T_cw)[None], supersample)
    return imgs[0], ideps[0]


def render_multi_batch(
    scene: MultiScene, K: np.ndarray, w: int, h: int, poses: np.ndarray,
    supersample: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render a batch of poses (B,4,4) in one jitted dispatch.

    Returns (imgs (B,h,w) float32, idepths (B,h,w) float32)."""
    import jax.numpy as jnp

    pack = _device_pack(scene)
    kinvs = jnp.asarray(_supersample_kinvs(K, supersample))
    run = _get_fast_renderer(w, h, supersample)
    imgs, ideps = run(pack, kinvs, jnp.asarray(poses, jnp.float32))
    return np.asarray(imgs), np.asarray(ideps)


def render_stereo_sequence_fast(
    scene: MultiScene,
    K: np.ndarray,
    w: int,
    h: int,
    baseline: float,
    poses_cw: List[np.ndarray],
    exposures: Optional[np.ndarray] = None,
    supersample: int = 2,
    chunk: int = 8,
):
    """Render a whole stereo sequence on-device in pose chunks.

    Returns (lefts (N,h,w) uint8, rights (N,h,w) uint8). Exposure is applied
    on device before the uint8 clip (photometric variation for ab
    estimation). Ground-truth idepth, when needed, comes from
    render_multi_batch on the chosen poses."""
    import jax.numpy as jnp

    N = len(poses_cw)
    expo = np.ones(N) if exposures is None else np.asarray(exposures)
    all_poses = np.empty((2 * N, 4, 4), np.float64)
    all_expo = np.empty((2 * N,), np.float32)
    for f, T in enumerate(poses_cw):
        all_poses[2 * f] = np.asarray(T)
        all_poses[2 * f + 1] = stereo_pose(np.asarray(T), baseline)
        all_expo[2 * f] = all_expo[2 * f + 1] = expo[f]
    pack = _device_pack(scene)
    kinvs = jnp.asarray(_supersample_kinvs(K, supersample))
    run = _get_fast_seq_renderer(w, h, supersample)
    imgs = np.empty((2 * N, h, w), np.uint8)
    step = 2 * chunk
    for i in range(0, 2 * N, step):
        j = min(i + step, 2 * N)
        batch = all_poses[i:j]
        ebatch = all_expo[i:j]
        if batch.shape[0] < step:  # pad to keep ONE compiled shape
            pad = step - batch.shape[0]
            batch = np.concatenate([batch, np.repeat(batch[-1:], pad, 0)], 0)
            ebatch = np.concatenate([ebatch, np.repeat(ebatch[-1:], pad, 0)])
        out = run(pack, kinvs, jnp.asarray(batch, jnp.float32),
                  jnp.asarray(ebatch))
        imgs[i:j] = np.asarray(out)[: j - i]
    return imgs[0::2], imgs[1::2]


def render_multi_stereo_pair(
    scene: MultiScene, K: np.ndarray, w: int, h: int, baseline: float,
    T_cw: Optional[np.ndarray] = None, exposure: float = 1.0,
):
    """Returns (left, right, idepth_left); exposure scales both images
    (photometric variation — the reference's ab-affine estimation target)."""
    if T_cw is None:
        T_cw = np.eye(4)
    left, idepth = render_multi(scene, K, w, h, T_cw)
    right, _ = render_multi(scene, K, w, h, stereo_pose(T_cw, baseline))
    if exposure != 1.0:
        left = np.clip(left * exposure, 0.0, 255.0)
        right = np.clip(right * exposure, 0.0, 255.0)
    return left, right, idepth


def forward_trajectory(
    n: int,
    step: float = 0.35,
    yaw_amp: float = 0.15,
    yaw_period: float = 60.0,
    y_bob: float = 0.01,
    seed: int = 1,
) -> List[np.ndarray]:
    """KITTI-like forward trajectory with sinusoidal yaw (gentle curves) and
    small vertical bobbing. Returns world-to-camera poses T_cw."""
    rng = np.random.default_rng(seed)
    poses = []
    pos = np.zeros(3)
    yaw = 0.0
    for i in range(n):
        yaw = yaw_amp * np.sin(2 * np.pi * i / yaw_period)
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        fwd = R_wc @ np.array([0.0, 0.0, 1.0])
        if i > 0:
            pos = pos + step * fwd
        pos_i = pos + np.array([0.0, y_bob * np.sin(0.9 * i), 0.0])
        T_wc = np.eye(4)
        T_wc[:3, :3] = R_wc
        T_wc[:3, 3] = pos_i
        T_cw = np.linalg.inv(T_wc)
        poses.append(T_cw)
    return poses


def render(
    scene: PlaneScene, K: np.ndarray, w: int, h: int, T_cw: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    # camera center in world: C = -R^T t ; ray dir world: R^T K^{-1} p
    C = -R.T @ t
    Kinv = np.linalg.inv(K)
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    d_c = np.stack([us, vs, np.ones_like(us)], axis=-1) @ Kinv.T  # (h, w, 3)
    d_w = d_c @ R  # == (R^T @ d_c^T)^T
    n = scene.normal
    denom = d_w @ n
    s = (scene.dist - C @ n) / np.where(np.abs(denom) < 1e-12, np.nan, denom)
    X_w = C[None, None, :] + s[..., None] * d_w
    # depth along camera z equals s because d_c z-component is 1
    valid = np.isfinite(s) & (s > 0.1)
    idepth = np.where(valid, 1.0 / np.where(valid, s, 1.0), 0.0).astype(np.float32)
    u_t = (X_w @ scene.e1) * scene.tex_scale
    v_t = (X_w @ scene.e2) * scene.tex_scale
    img = _sample_tex(scene.tex, np.nan_to_num(u_t), np.nan_to_num(v_t))
    img = np.where(valid, img, 0.0).astype(np.float32)
    return img, idepth


def stereo_pose(T_cw_left: np.ndarray, baseline: float) -> np.ndarray:
    """World-to-cam pose of the right camera given the left camera's.

    X_r = X_l - (b, 0, 0):  T_rw = Shift(-b) @ T_lw.
    """
    S = np.eye(4)
    S[0, 3] = -baseline
    return S @ T_cw_left


def render_stereo_pair(
    scene: PlaneScene, K: np.ndarray, w: int, h: int, baseline: float,
    T_cw: Optional[np.ndarray] = None,
):
    """Returns (left, right, idepth_left)."""
    if T_cw is None:
        T_cw = np.eye(4)
    left, idepth = render(scene, K, w, h, T_cw)
    right, _ = render(scene, K, w, h, stereo_pose(T_cw, baseline))
    return left, right, idepth


def render_sequence(
    scene: PlaneScene,
    K: np.ndarray,
    w: int,
    h: int,
    baseline: float,
    poses_cw: List[np.ndarray],
):
    """Render a stereo sequence. Returns list of (left, right, idepth_left)."""
    return [render_stereo_pair(scene, K, w, h, baseline, T) for T in poses_cw]


def default_K(w: int, h: int, fov_deg: float = 60.0) -> np.ndarray:
    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    K = np.array([[f, 0, (w - 1) / 2.0], [0, f, (h - 1) / 2.0], [0, 0, 1.0]])
    return K
