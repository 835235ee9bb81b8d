"""BEV rotated-rectangle IoU and greedy rotated NMS on tensors
(counterpart of `lidar_snow_sim_tpu/ops/rotated_iou.py`).

The intersection area of two rotated rectangles is the boundary integral

    area(A∩B) = 1/2 ∮_{∂(A∩B)} (x dy - y dx),

summed over A's edges clipped to B and B's edges clipped to A (one
Liang–Barsky clip each, pure min/max arithmetic in the other box's frame).
A clipped piece that lies on the other box's boundary carries half weight,
so coincident edges merge (same direction) or cancel (opposite direction).
Each pair is re-centred at the two boxes' midpoint so the cross products
stay well-conditioned in float32. The parallel threshold (1e-4 m), the
boundary margin `_BOUND_EPS` and the re-centring are the JAX package's
exactly: IoU values near an NMS threshold are decisions.

Every intermediate of a pair is an (N, M) plane, so the IoU matrix is
computed `block_rows` rows at a time (default: `IOU_BLOCK` pairs a block,
512 rows at 4,096 candidates) to bound the planes eager torch keeps alive.
Elementwise arithmetic does not depend on the block, so any block size
gives the same matrix bit for bit.

`nms_rotated` solves the greedy recurrence by fixpoint sweeps over whole
vectors, as the JAX package's while_loop does; the convergence test reads
one flag on the host a sweep, and the number of sweeps is returned.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
_BOUND_EPS = 1e-5   # pcdet's check_in_box2d half-extent margin
IOU_BLOCK = 1 << 21  # pairs a block of the IoU matrix (8 MiB a float32 plane)


def box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) [x, y, dx, dy, heading] -> (..., 4, 2) corners (CCW).

    Heading is the rotation of the dx axis about +z (OpenPCDet convention:
    box[6] rotates the box's dx/length axis from +x towards +y).
    """
    x, y, dx, dy, h = (boxes[..., i] for i in range(5))
    c, s = torch.cos(h), torch.sin(h)
    lx = 0.5 * dx
    ly = 0.5 * dy
    # CCW in the box frame: (+,+), (-,+), (-,-), (+,-)
    ox = torch.stack([lx, -lx, -lx, lx], dim=-1)
    oy = torch.stack([ly, ly, -ly, -ly], dim=-1)
    cx = x[..., None] + ox * c[..., None] - oy * s[..., None]
    cy = y[..., None] + ox * s[..., None] + oy * c[..., None]
    return torch.stack([cx, cy], dim=-1)


def _corner_xy(x, y, c, s, lx, ly):
    """One rectangle corner from centre, cos/sin(heading), local offsets."""
    return x + lx * c - ly * s, y + lx * s + ly * c


def _clip_contrib(p0x, p0y, p1x, p1y, rx, ry, rc, rs, hx, hy):
    """Boundary-integral contribution of edge (p0 -> p1) clipped to rect.

    rect: centre (rx, ry), cos/sin(heading) (rc, rs), half extents (hx, hy).
    Returns (cross(g0, g1)/2 of the clipped sub-segment, on_boundary flag).
    """
    # segment endpoints in the rect's local frame
    t0x, t0y = p0x - rx, p0y - ry
    q0x = t0x * rc + t0y * rs
    q0y = -t0x * rs + t0y * rc
    t1x, t1y = p1x - rx, p1y - ry
    q1x = t1x * rc + t1y * rs
    q1y = -t1x * rs + t1y * rc

    t0 = torch.zeros_like(p0x)
    t1 = torch.ones_like(p0x)
    on_boundary = torch.zeros_like(p0x, dtype=torch.bool)
    for o, d, hh in ((q0x, q1x - q0x, hx), (q0y, q1y - q0y, hy)):
        # the parallel threshold must exceed the f32 rotate/unrotate
        # round-trip noise on the corners (~1e-6 m at 10 m coordinates),
        # else coincident edges of identical boxes miss the half weight
        par = torch.abs(d) < 1e-4
        denom = torch.where(par, 1.0, d)
        ta = (-hh - _BOUND_EPS - o) / denom
        tb = (hh + _BOUND_EPS - o) / denom
        tlo = torch.minimum(ta, tb)
        thi = torch.maximum(ta, tb)
        omid = o + 0.5 * d
        inside_par = torch.abs(omid) <= hh + _BOUND_EPS
        tlo = torch.where(par, torch.where(inside_par, 0.0, 1.0), tlo)
        thi = torch.where(par, torch.where(inside_par, 1.0, 0.0), thi)
        t0 = torch.maximum(t0, tlo)
        t1 = torch.minimum(t1, thi)
        on_boundary = on_boundary | (
            par & (torch.abs(omid) >= hh - _BOUND_EPS))
    t1 = torch.maximum(t1, t0)          # empty clip -> zero-length segment

    ex, ey = p1x - p0x, p1y - p0y
    g0x, g0y = p0x + t0 * ex, p0y + t0 * ey
    g1x, g1y = p0x + t1 * ex, p0y + t1 * ey
    return 0.5 * (g0x * g1y - g1x * g0y), on_boundary


def _edges_contrib(box_a, box_b):
    """Sum of clipped-edge contributions of A's 4 edges against rect B
    (5-tuples of broadcastable tensors (x, y, dx, dy, h))."""
    ax, ay, adx, ady, ah = box_a
    bx, by, bdx, bdy, bh = box_b
    ac, as_ = torch.cos(ah), torch.sin(ah)
    bc, bs = torch.cos(bh), torch.sin(bh)
    lx, ly = 0.5 * adx, 0.5 * ady
    # CCW corners: (+,+), (-,+), (-,-), (+,-)
    corners = [
        _corner_xy(ax, ay, ac, as_, lx, ly),
        _corner_xy(ax, ay, ac, as_, -lx, ly),
        _corner_xy(ax, ay, ac, as_, -lx, -ly),
        _corner_xy(ax, ay, ac, as_, lx, -ly),
    ]
    total = None
    for i in range(4):
        p0x, p0y = corners[i]
        p1x, p1y = corners[(i + 1) % 4]
        contrib, on_b = _clip_contrib(
            p0x, p0y, p1x, p1y, bx, by, bc, bs, 0.5 * bdx, 0.5 * bdy
        )
        # boundary-coincident traversals carry half weight: same-direction
        # coincident pieces merge to one full contribution, opposite
        # directions (exterior touching) cancel
        term = torch.where(on_b, 0.5, 1.0) * contrib
        total = term if total is None else total + term
    return total


def _pair_intersection_area(box_a, box_b):
    """Intersection area of BEV rectangles (5-tuples of broadcastables)."""
    # re-centre the pair so the cross products are O(extent), not
    # O(scene range)
    midx = 0.5 * (box_a[0] + box_b[0])
    midy = 0.5 * (box_a[1] + box_b[1])
    a = (box_a[0] - midx, box_a[1] - midy) + tuple(box_a[2:])
    b = (box_b[0] - midx, box_b[1] - midy) + tuple(box_b[2:])
    area = _edges_contrib(a, b) + _edges_contrib(b, a)
    return torch.clamp_min(area, 0.0)


def _as_bev5(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 5) [x, y, dx, dy, heading] view of 5- or 7-DoF boxes."""
    if boxes.shape[-1] >= 7:
        return boxes[..., [0, 1, 3, 4, 6]]
    return boxes[..., :5]


def _blocks(n_rows: int, n_cols: int, block_rows):
    """Row slices of an (n_rows, n_cols) pair matrix, IOU_BLOCK pairs each
    unless `block_rows` is given."""
    rows = block_rows or max(1, IOU_BLOCK // max(n_cols, 1))
    return [slice(i, min(i + rows, n_rows)) for i in range(0, n_rows, rows)]


def _overlap_rows(a5, b5):
    """(n, M) intersection areas of the rows a5 (n, 5) against b5 (M, 5)."""
    a = tuple(a5[:, i, None] for i in range(5))
    b = tuple(b5[None, :, i] for i in range(5))
    return _pair_intersection_area(a, b)


def boxes_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor, *,
                      block_rows: int | None = None) -> torch.Tensor:
    """Pairwise BEV intersection AREA (not IoU) — pcdet boxes_overlap_bev.
    boxes (N, 5+) and (M, 5+) -> (N, M) float32."""
    a5, b5 = _as_bev5(boxes_a), _as_bev5(boxes_b)
    out = torch.empty(a5.shape[0], b5.shape[0], dtype=a5.dtype,
                      device=a5.device)
    for rows in _blocks(a5.shape[0], b5.shape[0], block_rows):
        out[rows] = _overlap_rows(a5[rows], b5)
    return out


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor, *,
                  block_rows: int | None = None) -> torch.Tensor:
    """Pairwise BEV rotated IoU matrix.

    boxes_a: (N, 5+) [x, y, dx, dy, heading, ...]; boxes_b: (M, 5+). 7-DoF
    boxes (x, y, z, dx, dy, dz, heading) are projected as pcdet's
    boxes_iou_bev projects them. Returns (N, M) float32, computed
    `block_rows` rows at a time (see the module docstring).
    """
    a5, b5 = _as_bev5(boxes_a), _as_bev5(boxes_b)
    area_b = (b5[:, 2] * b5[:, 3])[None, :]
    out = torch.empty(a5.shape[0], b5.shape[0], dtype=a5.dtype,
                      device=a5.device)
    for rows in _blocks(a5.shape[0], b5.shape[0], block_rows):
        ra = a5[rows]
        inter = _overlap_rows(ra, b5)
        area_a = (ra[:, 2] * ra[:, 3])[:, None]
        out[rows] = inter / torch.clamp_min(area_a + area_b - inter, _EPS)
    return out


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor, *,
                block_rows: int | None = None) -> torch.Tensor:
    """Pairwise 3D IoU of 7-DoF boxes (pcdet boxes_iou3d_gpu semantics:
    BEV rotated footprint overlap x z-extent overlap)."""
    inter_bev = boxes_overlap_bev(boxes_a, boxes_b, block_rows=block_rows)
    # halving is exact, so no device rounds it differently
    za0 = (boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None]
    za1 = (boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None]
    zb0 = (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :]
    zb1 = (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :]
    dz = torch.clamp_min(torch.minimum(za1, zb1) - torch.maximum(za0, zb0),
                         0.0)
    inter = inter_bev * dz
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter / torch.clamp_min(vol_a + vol_b - inter, _EPS)


def nms_rotated(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    *,
    iou_threshold: float,
    post_max: int,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Greedy rotated NMS over fixed-shape inputs.

    boxes: (N, 5+), scores: (N,), valid: (N,) bool, N >= post_max.
    Returns (keep_idx (post_max,) int32 into the INPUT order with -1
    padding, keep_count 0-dim int32 tensor, sweeps): pcdet `nms_gpu`
    semantics — candidates in descending score order (a stable sort, ties
    in input order), a box suppressed if its BEV IoU with any earlier KEPT
    box exceeds iou_threshold. The recurrence

        keep <- valid & not(any_{j<i} keep[j] & over[j, i])

    is iterated from keep = valid until it stops changing (at most N
    sweeps); each sweep extends the prefix on which the iterate equals the
    greedy solution. The suppression matrix is built IOU_BLOCK pairs at a
    time. The test for a change is one host read a sweep;
    `sweeps` is the number of sweeps run (the JAX package's loop count).
    """
    n = boxes.shape[0]
    dev = boxes.device
    neg = torch.where(valid, scores, -torch.inf)
    order = torch.argsort(-neg, stable=True)      # descending, invalid last
    sboxes = boxes[order]
    svalid = valid[order]

    # over[j, i]: j suppresses i (strictly earlier rank only)
    ar = torch.arange(n, device=dev)
    over = torch.empty(n, n, dtype=torch.bool, device=dev)
    for rows in _blocks(n, n, None):
        iou = boxes_iou_bev(sboxes[rows], sboxes, block_rows=n)
        over[rows] = (iou > iou_threshold) & (ar[rows, None] < ar[None, :])

    kept, prev = svalid, torch.zeros_like(svalid)
    sweeps = 0
    while sweeps < n and not torch.equal(kept, prev):
        suppressed = torch.any(kept[:, None] & over, dim=0)
        kept, prev = svalid & ~suppressed, kept
        sweeps += 1
    keep_count = torch.clamp_max(kept.sum(), post_max).to(torch.int32)

    # compact kept ranks (ascending rank == descending score) to post_max
    rank = torch.where(kept, ar, n)
    sel = torch.argsort(rank, stable=True)[:post_max]
    keep_idx = torch.where(
        torch.arange(post_max, device=dev) < keep_count, order[sel], -1
    ).to(torch.int32)
    return keep_idx, keep_count, sweeps
