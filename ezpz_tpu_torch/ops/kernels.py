"""Per-constraint-type residual kernels on torch tensors.

The PyTorch counterpart of ``ezpz_tpu/ops/kernels.py``. Each kernel is a
pure function ``fn(v, p) -> (res, deg)`` where

* ``v`` is an indexable of ``nv`` tensors (or a tensor whose first axis
  holds the ``nv`` variables) of one common shape,
* ``p`` is an indexable of ``np`` parameter tensors of that shape (or
  broadcastable scalars),
* ``res`` is the ``(dim, *shape)`` stacked residual rows, and
* ``deg`` is a bool tensor of ``shape``: the configuration is degenerate
  (the reference emits a warning and zeroes the Jacobian row).

Every operation is elementwise, so one call evaluates a whole batch of
sketches, and ``torch.func.jvp`` of a kernel gives the Jacobian columns
the fused fleet solver uses. The arithmetic follows the JAX kernels
operation for operation (same order, same constants) so that f32 results
are comparable bit for bit with the hand-written CUDA kernel in
``csrc/fused_fleet.cu``, which mirrors this file.

Degenerate handling is the JAX package's: where the reference zeroes the
residual on degeneracy it is 0 here; where the residual stays live but the
Jacobian row is emptied, ``_guard`` keeps the raw value with a detached
(zero) tangent. Denominators are sanitized before use (``_safe_sqrt``), so
no NaN enters a tangent.

``point_arc_coincident`` classifies the arc span with the atan2-free
``ccw_angle_less``, as the JAX fused kernel does
(``PALLAS_SAFE_FN``); the two differ from the atan2 form only at angles of
exactly 0 or pi.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

EPSILON = 1e-4  # ezpz/src/lib.rs:43
_EPS2 = EPSILON * EPSILON


def _guard(deg, raw, smooth):
    """Residual value = raw (reference value) when degenerate, with a zero
    tangent; the smooth branch is exact elsewhere."""
    if isinstance(raw, torch.Tensor):
        raw = raw.detach()
    return torch.where(deg, raw, smooth)


def _safe_sqrt(q, deg):
    """sqrt with a sanitized argument under the degenerate branch (so the
    tangent is NaN-free)."""
    return torch.sqrt(torch.where(deg, 1.0, q))


def _cross(ax, ay, bx, by):
    return ax * by - ay * bx


def _false_like(t):
    return torch.zeros_like(t, dtype=torch.bool)


# ---------------------------------------------------------------------------
# Kernels. Variable orders match ezpz_tpu.ops.kernels and the lowering in
# ezpz_tpu_torch.constraints.


def k_line_tangent_circle(v, p):
    """vars [p0x p0y p1x p1y cx cy r]; params [side_sign] (+1 Left, -1 Right)."""
    p0x, p0y, p1x, p1y, cx, cy, r = v[:7]
    side = p[0]
    ux, uy = p1x - p0x, p1y - p0y
    q = ux * ux + uy * uy
    deg = q <= _EPS2
    mag = _safe_sqrt(q, deg)
    vx, vy = cx - p0x, cy - p0y
    cen_dist = side * _cross(ux, uy, vx, vy) / mag
    res = _guard(deg, 0.0, cen_dist - torch.abs(r))
    return torch.stack([res]), deg


def k_circle_tangent_circle(v, p):
    """vars [ax ay ar bx by br]; params [interior] (1 Interior, 0 Exterior)."""
    ax, ay, ar, bx, by, br = v[:6]
    interior = p[0]
    dx, dy = ax - bx, ay - by
    q = dx * dx + dy * dy
    deg = q <= _EPS2
    dist_smooth = _safe_sqrt(q, deg)
    dist_raw = torch.sqrt(q)
    ra, rb = torch.abs(ar), torch.abs(br)
    r_int = torch.abs(ra - rb)
    r_ext = ra + rb
    base = torch.where(interior > 0.5, r_int, r_ext)
    res = _guard(deg, base - dist_raw, base - dist_smooth)
    return torch.stack([res]), deg


def k_distance(v, p):
    """vars [p0x p0y p1x p1y]; params [d]. Residual |p0-p1| - d."""
    x0, y0, x1, y1 = v[:4]
    dx, dy = x0 - x1, y0 - y1
    q = dx * dx + dy * dy
    deg = q < _EPS2
    res = _guard(deg, torch.sqrt(q) - p[0], _safe_sqrt(q, deg) - p[0])
    return torch.stack([res]), deg


def k_distance_var(v, p):
    """vars [px py qx qy d]; no params. Residual |p-q| - d."""
    px, py, qx, qy, d = v[:5]
    dx, dy = px - qx, py - qy
    q = dx * dx + dy * dy
    deg = q < _EPS2
    res = _guard(deg, torch.sqrt(q) - d, _safe_sqrt(q, deg) - d)
    return torch.stack([res]), deg


def k_vertical_distance(v, p):
    """vars [p0y p1y]; params [d]. Residual y0 - y1 - d."""
    return torch.stack([v[0] - v[1] - p[0]]), _false_like(v[0])


def k_horizontal_distance(v, p):
    """vars [p0x p1x]; params [d]. Residual x0 - x1 - d."""
    return torch.stack([v[0] - v[1] - p[0]]), _false_like(v[0])


def k_vertical(v, p):
    """vars [p0x p1x]. Residual x0 - x1."""
    return torch.stack([v[0] - v[1]]), _false_like(v[0])


def k_horizontal(v, p):
    """vars [p0y p1y]. Residual y0 - y1."""
    return torch.stack([v[0] - v[1]]), _false_like(v[0])


def k_fixed(v, p):
    """vars [x]; params [expected]. Residual x - expected."""
    return torch.stack([v[0] - p[0]]), _false_like(v[0])


def k_scalar_equal(v, p):
    """vars [x y]. Residual x - y."""
    return torch.stack([v[0] - v[1]]), _false_like(v[0])


def k_lines_at_angle(v, p):
    """vars [x0 y0 x1 y1 x2 y2 x3 y3]; params [sin cos] of the target angle.
    Residual cross(u, R^-1 v) / ((|u|+|v|)/2)."""
    x0, y0, x1, y1, x2, y2, x3, y3 = v[:8]
    s, c = p[0], p[1]
    ux, uy = x1 - x0, y1 - y0
    vx, vy = x3 - x2, y3 - y2
    qu = ux * ux + uy * uy
    qv = vx * vx + vy * vy
    deg = (qu <= _EPS2) | (qv <= _EPS2)
    lu = _safe_sqrt(qu, deg)
    lv = _safe_sqrt(qv, deg)
    rvx = c * vx + s * vy
    rvy = -s * vx + c * vy
    res = _cross(ux, uy, rvx, rvy) / ((lu + lv) * 0.5)
    res = _guard(deg, 0.0, res)
    return torch.stack([res]), deg


def k_points_coincident(v, p):
    """vars [p0x p0y p1x p1y]. Residuals [x0-x1, y0-y1]."""
    return torch.stack([v[0] - v[2], v[1] - v[3]]), _false_like(v[0])


def k_circle_radius(v, p):
    """vars [r]; params [expected]. Residual r - expected."""
    return torch.stack([v[0] - p[0]]), _false_like(v[0])


def k_lines_equal_length(v, p):
    """vars [x0 y0 x1 y1 x2 y2 x3 y3]. Residual |l0| - |l1|."""
    x0, y0, x1, y1, x2, y2, x3, y3 = v[:8]
    a, b = x0 - x1, y0 - y1
    c, d = x2 - x3, y2 - y3
    q0 = a * a + b * b
    q1 = c * c + d * d
    deg = (q0 < _EPS2) | (q1 < _EPS2)
    raw = torch.sqrt(q0) - torch.sqrt(q1)
    smooth = _safe_sqrt(q0, deg) - _safe_sqrt(q1, deg)
    res = _guard(deg, raw, smooth)
    return torch.stack([res]), deg


def k_arc(v, p):
    """vars [sx sy ex ey cx cy]. Residual |s-c| - |e-c|."""
    sx, sy, ex, ey, cx, cy = v[:6]
    a, b = sx - cx, sy - cy
    c, d = ex - cx, ey - cy
    q0 = a * a + b * b
    q1 = c * c + d * d
    deg = (q0 <= _EPS2) | (q1 <= _EPS2)
    raw = torch.sqrt(q0) - torch.sqrt(q1)
    smooth = _safe_sqrt(q0, deg) - _safe_sqrt(q1, deg)
    res = _guard(deg, raw, smooth)
    return torch.stack([res]), deg


def k_midpoint(v, p):
    """vars [px py qx qy ax ay] (line p-q, midpoint a)."""
    px, py, qx, qy, ax, ay = v[:6]
    return (torch.stack([ax - px / 2.0 - qx / 2.0, ay - py / 2.0 - qy / 2.0]),
            _false_like(px))


def k_point_line_distance(v, p):
    """vars [px py p0x p0y p1x p1y]; params [d]. Signed point-line
    distance minus d; degenerate (residual zeroed) for a ~zero-length line."""
    px, py, p0x, p0y, p1x, p1y = v[:6]
    a = p0y - p1y
    b = p1x - p0x
    c = p0x * p1y - p1x * p0y
    q = a * a + b * b
    deg = q < _EPS2
    denom = _safe_sqrt(q, deg)
    res = (a * px + b * py + c) / denom - p[0]
    res = _guard(deg, 0.0, res)
    return torch.stack([res]), deg


def k_vertical_point_line_distance(v, p):
    """vars [ax ay px py qx qy]; params [d].
    Residual ay - py - (qy-py)/(qx-px) * (ax-px) - d."""
    ax, ay, px, py, qx, qy = v[:6]
    dx, dy = qx - px, qy - py
    deg = (torch.abs(dx) <= EPSILON) | ((dx * dx + dy * dy) <= _EPS2)
    dx_s = torch.where(deg, 1.0, dx)
    res = ay - py - dy / dx_s * (ax - px) - p[0]
    res = _guard(deg, 0.0, res)
    return torch.stack([res]), deg


def k_horizontal_point_line_distance(v, p):
    """vars [ax ay px py qx qy]; params [d].
    Residual ax - px - (qx-px)/(qy-py) * (ay-py) - d."""
    ax, ay, px, py, qx, qy = v[:6]
    dx, dy = qx - px, qy - py
    deg = (torch.abs(dy) <= EPSILON) | ((dx * dx + dy * dy) <= _EPS2)
    dy_s = torch.where(deg, 1.0, dy)
    res = ax - px - dx / dy_s * (ay - py) - p[0]
    res = _guard(deg, 0.0, res)
    return torch.stack([res]), deg


def k_symmetric(v, p):
    """vars [px py qx qy ax ay bx by] (mirror line p-q; points a, b).
    Degenerate when |q-p|^4 < EPSILON; the raw value divides by the
    zero-guarded |q-p|^2, as the JAX kernel does."""
    px, py, qx, qy, ax, ay, bx, by = v[:8]
    dx, dy = qx - px, qy - py
    r = dx * dx + dy * dy
    deg = (r * r) < EPSILON
    r_s = torch.where(deg, 1.0, r)
    sx, sy = ax - px, ay - py
    dot = sx * dx + sy * dy
    refx = 2.0 * dx * dot / r_s - sx
    refy = 2.0 * dy * dot / r_s - sy
    r_z = torch.where(r == 0.0, 1.0, r)
    raw_refx = 2.0 * dx * dot / r_z - sx
    raw_refy = 2.0 * dy * dot / r_z - sy
    r0 = _guard(deg, raw_refx - bx + px, refx - bx + px)
    r1 = _guard(deg, raw_refy - by + py, refy - by + py)
    return torch.stack([r0, r1]), deg


def ccw_angle_less(sx, sy, px, py, ex, ey):
    """atan2-free ``angle_ccw(s->p) < angle_ccw(s->e)``: half-plane split by
    the sign of cross(s, x), then an in-half cross(p, e) orientation test.
    Differs from the atan2 comparison only when an angle is exactly 0 or
    pi."""
    c_p = _cross(sx, sy, px, py)
    c_e = _cross(sx, sy, ex, ey)
    d_p = sx * px + sy * py
    d_e = sx * ex + sy * ey
    h_p = (c_p > 0.0) | ((c_p == 0.0) & (d_p > 0.0))
    h_e = (c_e > 0.0) | ((c_e == 0.0) & (d_e > 0.0))
    in_half = _cross(px, py, ex, ey) > 0.0
    same = h_p == h_e
    return (same & in_half) | (~same & h_p)


def k_point_arc_coincident(v, p):
    """vars [cx cy sx sy ex ey px py]. Piecewise: interior points pull
    radially to the circle, outside points to the nearest endpoint."""
    cx, cy, sx, sy, ex, ey, px, py = v[:8]
    sxr, syr = sx - cx, sy - cy
    exr, eyr = ex - cx, ey - cy
    pxr, pyr = px - cx, py - cy
    qs = sxr * sxr + syr * syr
    qe = exr * exr + eyr * eyr
    qp = pxr * pxr + pyr * pyr
    deg = (qs < _EPS2) | (qe < _EPS2) | (qp < _EPS2)
    r = _safe_sqrt(qs, deg)
    r_e = _safe_sqrt(qe, deg)
    r_p = _safe_sqrt(qp, deg)
    scale_e = r / r_e
    epx, epy = exr * scale_e, eyr * scale_e
    interior = ccw_angle_less(sxr, syr, pxr, pyr, epx, epy)
    ex_, ey_ = epx - pxr, epy - pyr
    sx_, sy_ = sxr - pxr, syr - pyr
    d_end2 = ex_ * ex_ + ey_ * ey_
    d_start2 = sx_ * sx_ + sy_ * sy_
    nearest_end = d_end2 < d_start2
    k = r / r_p - 1.0
    r0 = torch.where(interior, pxr * k, torch.where(nearest_end, ex_, sx_))
    r1 = torch.where(interior, pyr * k, torch.where(nearest_end, ey_, sy_))
    r0 = _guard(deg, 0.0, r0)
    r1 = _guard(deg, 0.0, r1)
    return torch.stack([r0, r1]), deg


def k_arc_length(v, p):
    """vars [cx cy ax ay bx by]; params [d].
    Residual (b - c) - R(d/|a-c|) (a - c), two rows."""
    cx, cy, ax, ay, bx, by = v[:6]
    d = p[0]
    ux, uy = ax - cx, ay - cy
    r2 = ux * ux + uy * uy
    deg = r2 <= _EPS2
    r = _safe_sqrt(r2, deg)
    alpha = d / r
    sa, ca = torch.sin(alpha), torch.cos(alpha)
    rux = ca * ux - sa * uy
    ruy = sa * ux + ca * uy
    r0 = _guard(deg, 0.0, (bx - cx) - rux)
    r1 = _guard(deg, 0.0, (by - cy) - ruy)
    return torch.stack([r0, r1]), deg


def k_points_at_angle(v, p):
    """vars [p0x p0y p1x p1y p2x p2y]; params [sin cos].
    Residual (|u| v - |v| R u) / ((|u|+|v|)/2), u = p1-p0, v = p2-p0."""
    x0, y0, x1, y1, x2, y2 = v[:6]
    s, c = p[0], p[1]
    ux, uy = x1 - x0, y1 - y0
    vx, vy = x2 - x0, y2 - y0
    qu = ux * ux + uy * uy
    qv = vx * vx + vy * vy
    deg = (qu <= _EPS2) | (qv <= _EPS2)
    lu = _safe_sqrt(qu, deg)
    lv = _safe_sqrt(qv, deg)
    rux = c * ux - s * uy
    ruy = s * ux + c * uy
    inv_scale = torch.reciprocal((lu + lv) * 0.5)
    r0 = _guard(deg, 0.0, (vx * lu - rux * lv) * inv_scale)
    r1 = _guard(deg, 0.0, (vy * lu - ruy * lv) * inv_scale)
    return torch.stack([r0, r1]), deg


# ---------------------------------------------------------------------------
# Registry


@dataclass(frozen=True)
class KernelSpec:
    name: str
    nvars: int
    nparams: int
    dim: int
    fn: Callable
    # False for kernels whose degenerate flag is constant False.
    can_degenerate: bool = True


KERNELS: Dict[str, KernelSpec] = {
    spec.name: spec
    for spec in [
        KernelSpec("line_tangent_circle", 7, 1, 1, k_line_tangent_circle),
        KernelSpec("circle_tangent_circle", 6, 1, 1, k_circle_tangent_circle),
        KernelSpec("distance", 4, 1, 1, k_distance),
        KernelSpec("distance_var", 5, 0, 1, k_distance_var),
        KernelSpec("vertical_distance", 2, 1, 1, k_vertical_distance, can_degenerate=False),
        KernelSpec("horizontal_distance", 2, 1, 1, k_horizontal_distance, can_degenerate=False),
        KernelSpec("vertical", 2, 0, 1, k_vertical, can_degenerate=False),
        KernelSpec("horizontal", 2, 0, 1, k_horizontal, can_degenerate=False),
        KernelSpec("lines_at_angle", 8, 2, 1, k_lines_at_angle),
        KernelSpec("fixed", 1, 1, 1, k_fixed, can_degenerate=False),
        KernelSpec("scalar_equal", 2, 0, 1, k_scalar_equal, can_degenerate=False),
        KernelSpec("points_coincident", 4, 0, 2, k_points_coincident, can_degenerate=False),
        KernelSpec("circle_radius", 1, 1, 1, k_circle_radius, can_degenerate=False),
        KernelSpec("lines_equal_length", 8, 0, 1, k_lines_equal_length),
        KernelSpec("arc", 6, 0, 1, k_arc),
        KernelSpec("midpoint", 6, 0, 2, k_midpoint, can_degenerate=False),
        KernelSpec("point_line_distance", 6, 1, 1, k_point_line_distance),
        KernelSpec("vertical_point_line_distance", 6, 1, 1, k_vertical_point_line_distance),
        KernelSpec("horizontal_point_line_distance", 6, 1, 1, k_horizontal_point_line_distance),
        KernelSpec("symmetric", 8, 0, 2, k_symmetric),
        KernelSpec("point_arc_coincident", 8, 0, 2, k_point_arc_coincident),
        KernelSpec("arc_length", 6, 1, 2, k_arc_length),
        KernelSpec("points_at_angle", 6, 2, 2, k_points_at_angle),
    ]
}

# Kind ids shared with the CUDA kernel's switch (csrc/fused_fleet.cu):
# the registry's order.
KIND_ID: Dict[str, int] = {name: i for i, name in enumerate(KERNELS)}
