"""Raster preview: a jnp z-buffer rasterizer with the reference viewport's
exact shading semantics.

The JAX equivalent of the wgpu pipelines + WESL shaders (survey C22/C23,
``src/views/viewport/viewport_render.rs`` + ``src/shaders/*.wesl``):

- scene tessellation: spheres → 16×32 UV mesh, meshes → their triangles,
  plus the adaptive log-spaced ground grid (``get_grid``,
  viewport_render.rs:472-504); vertex budget 40K (viewport_render.rs:428).
- objects pass: MVP transform; normal FAKED as ``normalize(world_position)``
  (the reference's centered-model assumption, objects.wesl:29); lighting
  with hard-coded light at (1,-5,5), ambient 0.1, specular 0.5, shininess 32
  (objects.wesl:40-71).
- sky pass: vertical gradient top (0.2,0.2,0.2) → bottom (0.13,0.1,0.1)
  modulated by camera direction (sky.wesl:29-47).
- outline/post pass: split screen — bottom half color, top half depth^0.4
  (outline.wesl:27-45).

Depth convention is wgpu's [0,1]; world-position varyings interpolate
perspective-correct, depth linearly in screen space (GPU behaviour).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from path_tracer.models.camera import Camera
from path_tracer.models.geometry import sphere_to_triangles
from path_tracer.models.scene import SceneDescriptor

SKY_TOP = np.array([0.2, 0.2, 0.2], np.float32)
SKY_BOTTOM = np.array([0.13, 0.1, 0.1], np.float32)
LIGHT_POSITION = np.array([1.0, -5.0, 5.0], np.float32)
LIGHT_COLOR = np.array([1.0, 1.0, 1.0], np.float32)
AMBIENT_STRENGTH = 0.1
SPECULAR_STRENGTH = 0.5
SHININESS = 32.0
VERTEX_BUDGET = 1024 * 40
GRID_LINES = 5
GRID_COLOR = np.array([0.5, 0.5, 0.5], np.float32)


def grid_triangles(camera: Camera) -> tuple[np.ndarray, np.ndarray]:
    """Adaptive ground grid (viewport_render.rs:472-504): 2*(2*5+1) lines of
    2 triangles each, log-scaled spacing, width 0.02*zoom."""
    zoom = float(np.linalg.norm(camera.position)) / 5.0
    spacing = float(10 ** int(np.floor(np.log10(zoom * 1.2 + 1.0))))
    half_w = 0.02 * zoom / 2.0
    extent = GRID_LINES * spacing

    tris = []
    for axis in (np.array([1.0, 0, 0]), np.array([0.0, 0, 1])):
        other = np.cross(np.array([0.0, 1.0, 0.0]), axis)
        for i in range(-GRID_LINES, GRID_LINES + 1):
            off = i * spacing
            p1 = axis * (off - half_w) - other * extent
            p2 = axis * (off + half_w) - other * extent
            p3 = p1 + other * extent * 2.0
            p4 = p2 + other * extent * 2.0
            tris.append(np.stack([p1, p2, p4]))
            tris.append(np.stack([p1, p4, p3]))
    t = np.asarray(tris, np.float32)
    return t, np.tile(GRID_COLOR, (len(t), 1))


def tessellate_scene(scene: SceneDescriptor) -> tuple[np.ndarray, np.ndarray]:
    """Triangles [T,3,3] + flat colors [T,3]; grid first, then objects
    (get_verts, viewport_render.rs:439-459), truncated to the vertex budget."""
    tris, colors = [], []
    g_t, g_c = grid_triangles(scene.camera)
    tris.append(g_t)
    colors.append(g_c)
    for obj in scene.objects:
        t = (
            sphere_to_triangles(obj.radius)
            if obj.is_sphere
            else obj.mesh.triangles
        )
        t = t + obj.position[None, None, :]
        tris.append(t.astype(np.float32))
        colors.append(np.tile(obj.material.color, (len(t), 1)))
    t = np.concatenate(tris)
    c = np.concatenate(colors).astype(np.float32)
    max_tris = VERTEX_BUDGET // 3
    return t[:max_tris], c[:max_tris]


@partial(jax.jit, static_argnames=("width", "height", "chunk"))
def _raster_core(tri_v, tri_color, view_proj, cam_dir, width, height, chunk=256):
    H, W = height, width

    # project: world -> clip -> NDC -> screen
    v = tri_v.reshape(-1, 3)
    clip = v @ view_proj[:3, :3].T + view_proj[:3, 3][None, :]
    wcl = v @ view_proj[3, :3].T + view_proj[3, 3]
    clip = clip.reshape(-1, 3, 3)
    wcl = wcl.reshape(-1, 3)
    ok_w = jnp.all(wcl > 1e-6, axis=1)  # crude near-plane reject
    ndc = clip / wcl[:, :, None]
    sx = (ndc[:, :, 0] + 1.0) * 0.5 * W
    sy = (1.0 - ndc[:, :, 1]) * 0.5 * H
    sz = ndc[:, :, 2]
    inv_w = 1.0 / wcl

    px = jnp.arange(W, dtype=jnp.float32) + 0.5
    py = jnp.arange(H, dtype=jnp.float32) + 0.5
    PX = px[None, :].repeat(H, axis=0).reshape(-1)  # [HW]
    PY = py[:, None].repeat(W, axis=1).reshape(-1)

    T = tri_v.shape[0]
    n_chunks = (T + chunk - 1) // chunk
    Tpad = n_chunks * chunk
    pad = Tpad - T

    def padz(x):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    sx_, sy_, sz_ = padz(sx), padz(sy), padz(sz)
    invw_ = padz(inv_w)
    okw_ = jnp.pad(ok_w, (0, pad))
    tv_ = padz(tri_v)
    tc_ = padz(tri_color)

    zbuf0 = jnp.full((H * W,), 1.0, jnp.float32)
    wp0 = jnp.zeros((H * W, 3), jnp.float32)
    col0 = jnp.zeros((H * W, 3), jnp.float32)
    hit0 = jnp.zeros((H * W,), bool)

    def body(c, carry):
        zbuf, wp, col, hit = carry
        sl = slice(None)
        idx = c * chunk
        ax = jax.lax.dynamic_slice_in_dim(sx_, idx, chunk)
        ay = jax.lax.dynamic_slice_in_dim(sy_, idx, chunk)
        az = jax.lax.dynamic_slice_in_dim(sz_, idx, chunk)
        aw = jax.lax.dynamic_slice_in_dim(invw_, idx, chunk)
        aok = jax.lax.dynamic_slice_in_dim(okw_, idx, chunk)
        av = jax.lax.dynamic_slice_in_dim(tv_, idx, chunk)
        ac = jax.lax.dynamic_slice_in_dim(tc_, idx, chunk)

        # edge functions: e_k(p) for each pixel x tri   [HW, chunk]
        x0, x1, x2 = ax[:, 0][None], ax[:, 1][None], ax[:, 2][None]
        y0, y1, y2 = ay[:, 0][None], ay[:, 1][None], ay[:, 2][None]
        P_x, P_y = PX[:, None], PY[:, None]
        e0 = (x1 - x0) * (P_y - y0) - (y1 - y0) * (P_x - x0)
        e1 = (x2 - x1) * (P_y - y1) - (y2 - y1) * (P_x - x1)
        e2 = (x0 - x2) * (P_y - y2) - (y0 - y2) * (P_x - x2)
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | (
            (e0 <= 0) & (e1 <= 0) & (e2 <= 0)
        )
        inside &= (jnp.abs(area) > 1e-12) & aok[None, :]
        inv_area = 1.0 / jnp.where(jnp.abs(area) > 1e-12, area, 1.0)
        b0 = e1 * inv_area  # weight of vertex 0
        b1 = e2 * inv_area
        b2 = e0 * inv_area

        z = b0 * az[:, 0][None] + b1 * az[:, 1][None] + b2 * az[:, 2][None]
        inside &= (z >= 0.0) & (z <= 1.0)
        z = jnp.where(inside, z, 2.0)

        zmin = jnp.min(z, axis=1)
        win = jnp.argmin(z, axis=1)
        better = zmin < zbuf

        # perspective-correct world position of the winning triangle
        bw0 = jnp.take_along_axis(b0, win[:, None], 1)[:, 0]
        bw1 = jnp.take_along_axis(b1, win[:, None], 1)[:, 0]
        bw2 = jnp.take_along_axis(b2, win[:, None], 1)[:, 0]
        vwin = av[win]  # [HW,3,3]
        iw = aw[win]  # [HW,3]
        pw = bw0 * iw[:, 0] + bw1 * iw[:, 1] + bw2 * iw[:, 2]
        wpos = (
            vwin[:, 0] * (bw0 * iw[:, 0])[:, None]
            + vwin[:, 1] * (bw1 * iw[:, 1])[:, None]
            + vwin[:, 2] * (bw2 * iw[:, 2])[:, None]
        ) / jnp.maximum(pw, 1e-20)[:, None]
        cwin = ac[win]

        zbuf = jnp.where(better, zmin, zbuf)
        wp = jnp.where(better[:, None], wpos, wp)
        col = jnp.where(better[:, None], cwin, col)
        hit = hit | better
        return (zbuf, wp, col, hit)

    zbuf, wp, col, hit = jax.lax.fori_loop(
        0, n_chunks, body, (zbuf0, wp0, col0, hit0)
    )

    # --- objects.wesl fragment shading ---
    normal = wp * jax.lax.rsqrt(
        jnp.maximum(jnp.sum(wp * wp, axis=1, keepdims=True), 1e-20)
    )
    lp = jnp.asarray(LIGHT_POSITION)
    ld = lp[None, :] - wp
    ld = ld * jax.lax.rsqrt(jnp.maximum(jnp.sum(ld * ld, axis=1, keepdims=True), 1e-20))
    diff = jnp.maximum(jnp.sum(normal * ld, axis=1), 0.0)
    view_dir = -wp * jax.lax.rsqrt(
        jnp.maximum(jnp.sum(wp * wp, axis=1, keepdims=True), 1e-20)
    )
    refl = -ld - normal * (2.0 * jnp.sum(normal * -ld, axis=1, keepdims=True))
    spec = jnp.power(
        jnp.maximum(jnp.sum(view_dir * refl, axis=1), 0.0), SHININESS
    )
    lit = (
        AMBIENT_STRENGTH
        + diff[:, None] * jnp.asarray(LIGHT_COLOR)[None, :]
        + SPECULAR_STRENGTH * spec[:, None]
    )
    shaded = lit * col

    # --- sky.wesl background ---
    uv_y = (PY / H)[:, None]
    sky = jnp.asarray(SKY_TOP)[None, :] * (1 - uv_y) + jnp.asarray(SKY_BOTTOM)[
        None, :
    ] * uv_y
    cam_factor = cam_dir[1] * 0.2  # dot(normalize(dir), +Y) * 0.2
    sky = sky * (1.0 + cam_factor * 0.5)

    color = jnp.where(hit[:, None], shaded, sky).reshape(H, W, 3)
    depth = jnp.where(hit, zbuf, 1.0).reshape(H, W)

    # --- outline.wesl split-screen post pass ---
    depth_vis = jnp.power(depth, 0.4)[:, :, None].repeat(3, axis=2)
    top_half = (jnp.arange(H) < H // 2)[:, None, None]
    composite = jnp.where(top_half, depth_vis, color)
    return color, depth, composite


def clip_near_plane(
    tri_v: np.ndarray, tri_color: np.ndarray, camera: Camera, eps: float = 2e-3
) -> tuple[np.ndarray, np.ndarray]:
    """Sutherland–Hodgman clip of triangles against the camera's near plane
    (the GPU clips in clip space; the jnp rasterizer rejects whole triangles
    with any vertex behind the camera, which would cull the walls of a box
    the camera sits inside)."""
    n = camera.direction.astype(np.float64)
    p0 = camera.position.astype(np.float64) + n * eps
    out_v, out_c = [], []
    for tri, col in zip(tri_v.astype(np.float64), tri_color):
        dist = (tri - p0) @ n
        inside = dist > 0
        if inside.all():
            out_v.append(tri)
            out_c.append(col)
            continue
        if not inside.any():
            continue
        poly = []
        for i in range(3):
            j = (i + 1) % 3
            if inside[i]:
                poly.append(tri[i])
            if inside[i] != inside[j]:
                t = dist[i] / (dist[i] - dist[j])
                poly.append(tri[i] + (tri[j] - tri[i]) * t)
        for k in range(1, len(poly) - 1):
            out_v.append(np.stack([poly[0], poly[k], poly[k + 1]]))
            out_c.append(col)
    if not out_v:
        return np.zeros((0, 3, 3), np.float32), np.zeros((0, 3), np.float32)
    return np.stack(out_v).astype(np.float32), np.stack(out_c).astype(np.float32)


def render_preview(
    scene: SceneDescriptor, width: int = 300, height: int = 200
) -> dict[str, np.ndarray]:
    """Rasterize the scene. Returns {'color','depth','composite'} arrays
    ([H,W,3], [H,W], [H,W,3]); 'composite' is the split-screen debug view."""
    tri_v, tri_color = tessellate_scene(scene)
    tri_v, tri_color = clip_near_plane(tri_v, tri_color, scene.camera)
    vp = scene.camera.view_projection(width / height)
    dirn = scene.camera.direction / np.linalg.norm(scene.camera.direction)
    color, depth, composite = _raster_core(
        jnp.asarray(tri_v),
        jnp.asarray(tri_color),
        jnp.asarray(vp),
        jnp.asarray(dirn),
        width,
        height,
    )
    return {
        "color": np.asarray(color),
        "depth": np.asarray(depth),
        "composite": np.asarray(composite),
    }
